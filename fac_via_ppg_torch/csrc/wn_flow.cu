// One whole WaveGlow WN coupling net per launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fac_via_ppg_tpu/ops/wn_flow_pallas.py::
// wn_flow_pallas (_wn_flow_kernel).  For audio (B, n_half, T) and the
// stacked cond projection (B, T, L*2C):
//
//   x = start(audio)                                  (f32 acc, rounded)
//   for l in 0..L-1, d = 2^l:
//     acts = gate([x(t-d) | x(t) | x(t+d)] @ W_in[l] + b_in[l] + cond_l)
//     rs   = acts @ W_rs[l] + b_rs[l]                  (f32 acc)
//     x   += rs[:, :C]       (not in the last layer; the add in x's type)
//     skip += rs[:, C:]      (the sum kept in x's type, as on the TPU)
//   out = end(skip)  -> (B, 2*n_half, T)
//
// x reads zero outside [0, T) in every layer: the conv's zero padding.
//
// Bound on the H100: at the vocoder's serving shape (B = 8, T = 10240,
// C = 256, L = 8, n_half = 4, bf16) one net does 8.26 MFLOP per time row,
// 677 GFLOP in all (0.685 ms at 989 TFLOP/s), against ~0.68 GB that must
// move (the cond read dominates; 0.20 ms at 3.35 TB/s): bound by
// tensor-core operations.
//
// Shared by both forms.  The TPU kernel kept each tile's whole residual
// window (tile plus a 255-sample receptive-field halo on each side) in
// VMEM; on Hopper that window alone is larger than a block's 227 KB of
// shared memory.  So this is one persistent cooperative launch: every block
// owns a fixed set of (batch, 64-row) tiles for the whole call.  x lives in
// two (B, T, C) ping-pong buffers in device memory: layer l reads buffer
// l % 2 (taps cross tiles) and writes the other, and a grid-wide barrier
// separates the layers.  Each tile's skip sum lives in a (B, T, C) buffer
// that only its own block touches, so it needs no barrier, and the same
// block applies the end conv after the last layer.  Buffers written by
// other blocks are read through L2 only.  At the serving shape the three
// bf16 buffers take 42 MB each, 126 MB against a 50 MB L2, so their
// traffic goes to device memory: per layer x is read about twice (taps and
// residual) and written once and skip read and written once, ~0.25 GB, ~75
// us at 3.35 TB/s, ~0.6 ms per launch, under the GEMMs' time.
//
// f32 (wn_flow_f32), and bf16 at widths other than 256 (wn_flow_bf16_tile,
// C % 128 == 0): the tile code of wn_tile.cuh (CUDA-core FMAs in f32, wmma
// in bf16; one staged K tile, a f32 staging tile for the gate).
//
// bf16 (wn_flow_bf16), built for C = 256: one block of two warpgroups per
// SM.  Per tile and layer both GEMMs run on wgmma (m64n128k16, f32
// accumulators in registers, operands in shared memory):
//   - GEMM 1: warpgroup w owns all 64 rows and 256 of the 512 columns:
//     tanh columns w*128.. and the sigmoid columns C + w*128.. that pair
//     with them.  The host lays W_in's columns out in that order
//     (ops/wn_flow.py::weight_image), so each K step's x slice (64 x KC) is
//     loaded once for all 2C columns, and the tanh and sigmoid sums of one
//     column sit in the same thread: the gate (+ b_in + cond, in f32) is
//     applied in registers, with no f32 staging tile.  The gate output
//     (64 x C bf16) goes to shared memory in wgmma's 128 B-swizzled K-major
//     layout, as GEMM 2's A operand.
//   - GEMM 2: warpgroup 0 computes the residual columns, warpgroup 1 the
//     skip columns; the last layer's skip-only projection is split between
//     them.  The epilogue rounds rs + b_rs into shared memory, and all
//     threads then update x' and skip 16 B at a time, every old value
//     loaded before any store.
//   - One ring of S stages of KC-deep K steps feeds both GEMMs (3C/KC steps
//     of x slice + W_in slice, then C/KC of W_rs slices), filled with
//     cp.async 16 B a thread, and runs on across the gate, the epilogue and
//     the next tile.  x rows outside [0, T) are zero-filled.  The weight
//     images are pre-swizzled by the host, so their copies are contiguous.
//     One wgmma group stays in flight while the next step's copies are
//     issued.  The tile's cond rows ride along with one ring step into a
//     tile buffer that later holds the gate output, then the rounded rs.
// Rounding follows the TPU kernel: x after the start conv, the gate output
// and the residual and skip adds in bf16, biases in f32, the cond add in
// f32 before the gate, tanh and the sigmoid in full f32 precision.
// Ceiling of this design: every tile and layer streams ~1 MB of bf16
// weights (W_in 768 x 512, W_rs 256 x 512) from L2 into its SM, ~58 FLOP
// a byte; at the tensor cores' rate that would need ~17 TB/s of L2,
// several times what L2 gives: 10.2 GB a launch at the serving shape, ~2 ms
// at an assumed 5 TB/s of L2, against the 0.68 ms bound, even with all
// else hidden.  Sharing each weight tile between the SMs of a cluster (TMA
// multicast) is the step past it.

#include <cooperative_groups.h>

#include "wn_tile.cuh"

namespace {

namespace cg = cooperative_groups;

template <typename T> struct FlowArgs {
  const T* audio;                    // (B, n_half, T)
  const T* cond;                     // (B, T, L*2C), unit channel stride
  long long cond_sb, cond_st;        // its batch and time strides
  const T* w_start;                  // (n_half, C)
  const float* b_start;              // (C)
  const T* w_in;                     // f32: (L, 3C, 2C) tap-stacked; bf16: its image
  const float* b_in;                 // (L, 2C)
  const T* w_rs;                     // f32: (L, C, 2C), last layer's skip in [C, 2C); bf16: image
  const float* b_rs;                 // (L, 2C)
  const T* w_end;                    // (C, 2*n_half)
  const float* b_end;                // (2*n_half)
  T* x0;                             // (B, T, C) residual ping
  T* x1;                             // (B, T, C) residual pong
  T* skip;                           // (B, T, C) skip sum
  T* out;                            // (B, 2*n_half, T)
  int B, t_len, C, L, n_half;
};

// start conv over the block's tiles: x0 = round(audio^T @ w_start + b_start)
template <typename T>
__device__ void start_conv(const FlowArgs<T>& a, int n_t, int n_tiles) {
  const int C = a.C;
  const size_t plane = static_cast<size_t>(a.t_len) * C;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / n_t, t0 = (tile % n_t) * TT;
    const T* ab = a.audio + static_cast<size_t>(b) * a.n_half * a.t_len;
    for (int e = threadIdx.x; e < TT * C; e += THREADS) {
      const int r = e / C, c = e % C, t = t0 + r;
      if (t >= a.t_len) continue;
      float acc = 0.f;
      for (int j = 0; j < a.n_half; ++j)
        acc = fmaf(to_f(ab[static_cast<size_t>(j) * a.t_len + t]), to_f(a.w_start[j * C + c]),
                   acc);
      a.x0[b * plane + static_cast<size_t>(t) * C + c] = from_f<T>(acc + a.b_start[c]);
    }
  }
}

// end conv over the block's own tiles, each tile's skip staged in shared
// memory at `stage` (TT rows of row stride ld)
template <typename T>
__device__ void end_conv(const FlowArgs<T>& a, int n_t, int n_tiles, T* stage, int ld) {
  const int C = a.C, n_out = 2 * a.n_half;
  const size_t plane = static_cast<size_t>(a.t_len) * C;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / n_t, t0 = (tile % n_t) * TT;
    const T* sk = a.skip + b * plane;
    for (int e = threadIdx.x; e < TT * C; e += THREADS) {
      const int r = e / C, c = e % C, t = t0 + r;
      stage[r * ld + c] = from_f<T>(t < a.t_len ? ld_l2(sk + static_cast<size_t>(t) * C + c) : 0.f);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n_out * TT; e += THREADS) {
      const int o = e / TT, r = e % TT, t = t0 + r;
      if (t >= a.t_len) continue;
      float acc = 0.f;
      for (int c = 0; c < C; ++c)
        acc = fmaf(to_f(stage[r * ld + c]), to_f(a.w_end[c * n_out + o]), acc);
      a.out[(static_cast<size_t>(b) * n_out + o) * a.t_len + t] = from_f<T>(acc + a.b_end[o]);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) wn_flow_tile_kernel(const FlowArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> s(smem, a.C);
  cg::grid_group grid = cg::this_grid();
  const int C = a.C, n_t = (a.t_len + TT - 1) / TT, n_tiles = a.B * n_t;
  const size_t plane = static_cast<size_t>(a.t_len) * C;

  start_conv(a, n_t, n_tiles);
  grid.sync();

  for (int l = 0; l < a.L; ++l) {
    const T* xin = (l & 1) ? a.x1 : a.x0;
    T* xout = (l & 1) ? a.x0 : a.x1;
    const bool last = l == a.L - 1;
    const T* w_in = a.w_in + static_cast<size_t>(l) * 3 * C * 2 * C;
    const float* b_in = a.b_in + static_cast<size_t>(l) * 2 * C;
    const T* w_rs = a.w_rs + static_cast<size_t>(l) * C * 2 * C;
    const float* b_rs = a.b_rs + static_cast<size_t>(l) * 2 * C;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int b = tile / n_t, t0 = (tile % n_t) * TT;
      const T* xb = xin + b * plane;
      T* xo = xout + b * plane;
      T* sk = a.skip + b * plane;
      gate_tile<true>(s, xb, a.t_len, C, t0, 1 << l, w_in, b_in,
                      a.cond + b * a.cond_sb + static_cast<size_t>(l) * 2 * C, a.cond_st);
      rs_tile(s, C, w_rs, 2 * C, b_rs, last ? C : 0, 2 * C, [&](int r, int col, float z) {
        const int t = t0 + r;
        if (t >= a.t_len) return;
        const T v = from_f<T>(z);
        if (col < C) {
          const size_t i = static_cast<size_t>(t) * C + col;
          xo[i] = from_f<T>(ld_l2(xb + i) + to_f(v));
        } else {
          const size_t i = static_cast<size_t>(t) * C + col - C;
          sk[i] = l == 0 ? v : from_f<T>(ld_l2(sk + i) + to_f(v));
        }
      });
    }
    if (!last) grid.sync();
  }

  end_conv(a, n_t, n_tiles, s.acts, s.ldact);
}

// ---------------------------------------------------------------------------
// bf16: wgmma on a full-width 64-row tile, fed by a cp.async ring

using bf16 = __nv_bfloat16;

// its own names: wn_tile.cuh's tile constants (KC, ...) stay the f32 form's
namespace wg {

constexpr int WC = 256;                  // the channels C the bf16 kernel is built for
constexpr int KC = 32;                   // depth of one ring step
constexpr int S = 4;                     // ring stages
// Loads run AHEAD steps ahead of the wgmma; the stage they refill was read
// two steps back, since one wgmma group stays in flight.
constexpr int AHEAD = S - 2;
constexpr int ROW = 2 * KC;              // bytes of one K-major row of a step (64 B swizzle)
constexpr int IMG_N = 2 * WC;            // rows (output columns) of one weight-image step
constexpr int A_BYTES = TT * ROW;        // x slice (64 x KC)
constexpr int B_BYTES = IMG_N * ROW;     // weight slice (2C x KC)
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int STEPS1 = 3 * WC / KC, STEPS2 = WC / KC, STEPS = STEPS1 + STEPS2;
constexpr uint64_t SW128 = 1, SW64 = 2;  // descriptor swizzle modes
// The tile buffer after the ring holds, in turn, the tile's cond (64 x 2C,
// row stride TILE_LD) from its ring step COND_STEP to the gate, the gate
// output (64 x C, 128 B-swizzled K-major) until GEMM 2 ends, and the
// rounded rs (64 x 2C, row stride TILE_LD) in the epilogue.  COND_STEP is
// issued AHEAD steps earlier: after the previous tile's epilogue.
constexpr int TILE_LD = 2 * WC + 8;      // padded: no bank conflicts in the gate
constexpr int TILE_BYTES = TT * TILE_LD * 2;
constexpr int RING_SMEM = S * STAGE + 1024;  // + slack for 1 KB alignment
constexpr int FLOW_SMEM = RING_SMEM + TILE_BYTES;
constexpr int COND_STEP = AHEAD;
static_assert(STAGE % 1024 == 0 && A_BYTES % 1024 == 0, "swizzle atoms need 1 KB alignment");
static_assert(TT * WC * 2 <= TILE_BYTES, "the gate output fits the tile buffer");
static_assert(COND_STEP < STEPS1, "cond lands before the gate");

// A swizzled K-major tile's byte offset for the unswizzled offset `off`
// (rows of R bytes, tile base 1 KB aligned): the 16 B chunk index is
// XORed with address bits 7.. (128 B rows: row % 8; 64 B: (row / 2) % 4).
template <int R> __device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (R / 16 - 1)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 B global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The oldest ring step in flight has landed, and every thread's copies are
// visible to wgmma (async proxy), as are earlier ordinary shared stores.
__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD - 1) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// wgmma shared-memory matrix descriptor: start address >> 4, LBO 1 (unused
// by swizzled K-major layouts), SBO (bytes between 8-row groups) >> 4, swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16) @ B (16 x 128), both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// One K step of one warpgroup: acc[0] += A (64 x KC at a_addr) @ B rows at
// b0 (128 x KC), and acc[1] likewise from b1 if `two`.  Returns with this
// step's wgmma group in flight and the previous one complete (its stage may
// be refilled after the next barrier); wgmma_wait() before reading acc.
__device__ __forceinline__ void mma_step(float (&acc)[2][64], uint32_t a_addr, uint32_t a_sbo,
                                         uint64_t a_layout, uint32_t b0, uint32_t b1,
                                         bool two) {
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    const uint64_t da = gmma_desc(a_addr + kk * 32, a_sbo, a_layout);
    wgmma_m64n128k16(acc[0], da, gmma_desc(b0 + kk * 32, 8 * ROW, SW64));
    if (two) wgmma_m64n128k16(acc[1], da, gmma_desc(b1 + kk * 32, 8 * ROW, SW64));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  fence_acc(acc[0]);
  fence_acc(acc[1]);
}

// Every wgmma of this warpgroup has completed: acc may be read.
__device__ __forceinline__ void wgmma_wait(float (&acc)[2][64]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc[0]);
  fence_acc(acc[1]);
}

// Issues this thread's copies of ring step s of a tile (rows t0.. of one
// batch row) into `stage`.  s < STEPS1: GEMM 1's x slice (taps of xb (T, C)
// at dilation d, zero outside [0, T)) and W_in image slice; step COND_STEP
// also stages the tile's cond rows (condb, row stride cond_st; zero past T)
// at cond_s, unless condb is null.  After that a W_rs image slice (the last
// layer's: rows C.. only).
__device__ __forceinline__ void issue_step(uint32_t stage, int s, const bf16* xb, int t_len,
                                           int t0, int d, const bf16* w_in_img,
                                           const bf16* w_rs_img, bool last, const bf16* condb,
                                           long long cond_st, uint32_t cond_s) {
  const bf16* w;
  int v0 = 0;
  if (s < STEPS1) {
    static_assert(TT * KC / 8 == THREADS, "one x chunk per thread");
    const int k0 = s * KC, tap = k0 / WC, c0 = k0 - tap * WC;
    const int r = threadIdx.x / (KC / 8), c = threadIdx.x % (KC / 8);
    const int t = t0 + r + (tap - 1) * d;
    const bool ok = t >= 0 && t < t_len;
    cp_async16(stage + swz<ROW>(r * ROW + c * 16),
               xb + (ok ? static_cast<size_t>(t) * WC + c0 + c * 8 : 0), ok);
    w = w_in_img + static_cast<size_t>(s) * IMG_N * KC;
    if (s == COND_STEP && condb != nullptr) {
#pragma unroll 4
      for (int v = threadIdx.x; v < TT * (2 * WC / 8); v += THREADS) {
        const int cr = v / (2 * WC / 8), cc = v % (2 * WC / 8), ct = t0 + cr;
        cp_async16(cond_s + cr * TILE_LD * 2 + cc * 16,
                   condb + (ct < t_len ? ct * cond_st + cc * 8 : 0), ct < t_len);
      }
    }
  } else {
    w = w_rs_img + static_cast<size_t>(s - STEPS1) * IMG_N * KC;
    if (last) v0 = B_BYTES / 32;
  }
  const uint32_t bs = stage + A_BYTES;
#pragma unroll 4
  for (int v = v0 + threadIdx.x; v < B_BYTES / 16; v += THREADS)
    cp_async16(bs + v * 16, w + v * 8, true);
}

// GEMM 1 of one tile: ring steps g.. (issue(i) issues ring step i);
// warpgroup w's acc[0] gets the tanh columns w*128.., acc[1] the sigmoid
// columns C + w*128.. (image rows w*256..).
template <typename Issue>
__device__ __forceinline__ void gemm1(float (&acc)[2][64], uint32_t ring, int& g, Issue issue) {
  const int w = threadIdx.x / 128;
  for (int s = 0; s < STEPS1; ++s, ++g) {
    ring_wait();
    issue(g + AHEAD);
    const uint32_t st = ring + (g % S) * STAGE, bs = st + A_BYTES;
    mma_step(acc, st, 8 * ROW, SW64, bs + (w * 256) * ROW, bs + (w * 256 + 128) * ROW, true);
  }
}

// This thread's accumulator element i of its warpgroup's 64 x 128 product:
// row (warp % 4) * 16 + lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) +
// 2 * (lane % 4) + i % 2; elements i, i + 1 (i even) are adjacent columns.
__device__ __forceinline__ int acc_row(int i) {
  const int wt = threadIdx.x % 128;
  return (wt / 32) * 16 + (wt % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

__device__ __forceinline__ float lo_f(unsigned int u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(unsigned int u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ unsigned int bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned int*>(&v);
}
// tanh(zt) * sigmoid(zs) in full f32 precision, as wn_tile.cuh's gate
__device__ __forceinline__ float gate(float zt, float zs) {
  return tanhf(zt) * (1.f / (1.f + expf(-zs)));
}

__device__ __forceinline__ float ldg_bf16(const bf16* p) {
  return __uint_as_float(static_cast<unsigned int>(
                             __ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

// start conv, 8 channels x 8 rows a thread: x0 = round(audio^T @ w_start + b_start)
__device__ void start_conv_bf16(const FlowArgs<bf16>& a, int n_t, int n_tiles) {
  const int c8 = (threadIdx.x % 32) * 8, r0 = threadIdx.x / 32;
  const size_t plane = static_cast<size_t>(a.t_len) * WC;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / n_t, t0 = (tile % n_t) * TT;
    const bf16* ab = a.audio + static_cast<size_t>(b) * a.n_half * a.t_len;
    float acc[8][8] = {};
    for (int j = 0; j < a.n_half; ++j) {
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(a.w_start + j * WC + c8));
      const unsigned int wu[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = t0 + r0 + 8 * i;
        const float av = t < a.t_len ? ldg_bf16(ab + static_cast<size_t>(j) * a.t_len + t) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][2 * q] = fmaf(av, lo_f(wu[q]), acc[i][2 * q]);
          acc[i][2 * q + 1] = fmaf(av, hi_f(wu[q]), acc[i][2 * q + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = t0 + r0 + 8 * i;
      if (t >= a.t_len) continue;
      uint4 o;
      unsigned int* ou = reinterpret_cast<unsigned int*>(&o);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ou[q] = bf16x2_bits(acc[i][2 * q] + a.b_start[c8 + 2 * q],
                            acc[i][2 * q + 1] + a.b_start[c8 + 2 * q + 1]);
      *reinterpret_cast<uint4*>(a.x0 + b * plane + static_cast<size_t>(t) * WC + c8) = o;
    }
  }
}

// end conv over the block's own tiles: a warp takes 8 rows, a lane 8 of
// their channels, and the partial sums meet in a warp reduction
__device__ void end_conv_bf16(const FlowArgs<bf16>& a, int n_t, int n_tiles) {
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 8, n_out = 2 * a.n_half;
  const size_t plane = static_cast<size_t>(a.t_len) * WC;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / n_t, t0 = (tile % n_t) * TT;
    unsigned int sv[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = t0 + r0 + i;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < a.t_len)
        v = __ldcg(reinterpret_cast<const uint4*>(a.skip + b * plane +
                                                  static_cast<size_t>(t) * WC + lane * 8));
      sv[i][0] = v.x;
      sv[i][1] = v.y;
      sv[i][2] = v.z;
      sv[i][3] = v.w;
    }
    for (int o = 0; o < n_out; ++o) {
      float wv[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) wv[q] = ldg_bf16(a.w_end + (lane * 8 + q) * n_out + o);
      float mine = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float part = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          part = fmaf(lo_f(sv[i][q]), wv[2 * q], part);
          part = fmaf(hi_f(sv[i][q]), wv[2 * q + 1], part);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == i) mine = part;
      }
      const int t = t0 + r0 + lane;
      if (lane < 8 && t < a.t_len)
        a.out[(static_cast<size_t>(b) * n_out + o) * a.t_len + t] =
            __float2bfloat16(mine + a.b_end[o]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) wn_flow_bf16_kernel(const FlowArgs<bf16> a) {
  extern __shared__ __align__(1024) unsigned char dsmem[];
  const uint32_t raw = smem_u32(dsmem), ring = (raw + 1023) & ~1023u;
  const uint32_t tile_s = ring + S * STAGE;
  unsigned char* const tile_p = dsmem + (tile_s - raw);
  cg::grid_group grid = cg::this_grid();
  const int n_t = (a.t_len + TT - 1) / TT, n_tiles = a.B * n_t;
  const size_t plane = static_cast<size_t>(a.t_len) * WC;
  const int n_mine = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int steps = n_mine * STEPS;
  const int w = threadIdx.x / 128;

  start_conv_bf16(a, n_t, n_tiles);
  grid.sync();

  float acc[2][64];
  for (int l = 0; l < a.L; ++l) {
    const bf16* xin = (l & 1) ? a.x1 : a.x0;
    bf16* xout = (l & 1) ? a.x0 : a.x1;
    const bool last = l == a.L - 1;
    const int d = 1 << l;
    const bf16* w_in = a.w_in + static_cast<size_t>(l) * STEPS1 * IMG_N * KC;
    const bf16* w_rs = a.w_rs + static_cast<size_t>(l) * STEPS2 * IMG_N * KC;
    const float* b_in = a.b_in + static_cast<size_t>(l) * 2 * WC;
    const float* b_rs = a.b_rs + static_cast<size_t>(l) * 2 * WC;
    auto issue = [&](int g) {
      if (g < steps) {
        const int tile = blockIdx.x + (g / STEPS) * gridDim.x, b = tile / n_t;
        issue_step(ring + (g % S) * STAGE, g % STEPS, xin + b * plane, a.t_len,
                   (tile % n_t) * TT, d, w_in, w_rs, last,
                   a.cond + b * a.cond_sb + static_cast<size_t>(l) * 2 * WC, a.cond_st, tile_s);
      }
      cp_async_commit();
    };
    for (int g = 0; g < AHEAD; ++g) issue(g);

    int g = 0;
    for (int i = 0; i < n_mine; ++i) {
      const int tile = blockIdx.x + i * gridDim.x, b = tile / n_t, t0 = (tile % n_t) * TT;
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[0][e] = acc[1][e] = 0.f;
      gemm1(acc, ring, g, issue);
      wgmma_wait(acc);

      // the gate, in registers: z = acc + b_in + cond (f32) -> acts (bf16),
      // written over cond once every thread has read its own
      unsigned int acts[32];
#pragma unroll
      for (int e = 0; e < 64; e += 2) {
        const int r = acc_row(e), k = w * 128 + acc_col(e);
        const unsigned char* cr = tile_p + (r * TILE_LD + k) * 2;
        const unsigned int ct = *reinterpret_cast<const unsigned int*>(cr);
        const unsigned int cs = *reinterpret_cast<const unsigned int*>(cr + 2 * WC);
        const float zt0 = acc[0][e] + b_in[k] + lo_f(ct);
        const float zt1 = acc[0][e + 1] + b_in[k + 1] + hi_f(ct);
        const float zs0 = acc[1][e] + b_in[WC + k] + lo_f(cs);
        const float zs1 = acc[1][e + 1] + b_in[WC + k + 1] + hi_f(cs);
        acts[e / 2] = bf16x2_bits(gate(zt0, zs0), gate(zt1, zs1));
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 64; e += 2) {
        const int r = acc_row(e), k = w * 128 + acc_col(e);
        *reinterpret_cast<unsigned int*>(tile_p + (k / 64) * 8192 +
                                         swz<128>(r * 128 + (k % 64) * 2)) = acts[e / 2];
      }

      // GEMM 2: warpgroup w's image rows w*256.. (0: residual, 1: skip
      // columns), or in the last layer the skip rows C + w*128..
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[0][e] = acc[1][e] = 0.f;
      const int row0 = last ? WC + w * 128 : w * 256;
      for (int s = 0; s < STEPS2; ++s, ++g) {
        ring_wait();
        issue(g + AHEAD);
        const uint32_t bs = ring + (g % S) * STAGE + A_BYTES, k = s * KC;
        mma_step(acc, tile_s + (k / 64) * 8192 + (k % 64) * 2, 1024, SW128, bs + row0 * ROW,
                 bs + (row0 + 128) * ROW, !last);
      }

      wgmma_wait(acc);
      // epilogue: rs = round(acc + b_rs) into the tile buffer once both
      // warpgroups' GEMM 2 is done with acts, then 16 B a thread:
      // x' = round(x + rs) in the residual columns, skip = rs (layer 0) or
      // round(skip + rs)
      __syncthreads();
      unsigned char* const rs_p = tile_p;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (p == 1 && last) break;
#pragma unroll
        for (int e = 0; e < 64; e += 2) {
          const int n = row0 + p * 128 + acc_col(e);
          *reinterpret_cast<unsigned int*>(rs_p + (acc_row(e) * TILE_LD + n) * 2) =
              bf16x2_bits(acc[p][e] + b_rs[n], acc[p][e + 1] + b_rs[n + 1]);
        }
      }
      __syncthreads();
      // rs columns [2C - ncol, 2C), 8 a chunk, 2^sh chunks a row
      const int sh = last ? 5 : 6, n_lo = last ? WC : 0, chunks = TT << sh;
      constexpr int Q = TT * 2 * WC / 8 / THREADS;
      uint4 old[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int v = q * THREADS + threadIdx.x, r = v >> sh;
        const int n = n_lo + ((v & ((1 << sh) - 1)) << 3), t = t0 + r;
        old[q] = make_uint4(0u, 0u, 0u, 0u);
        if (v < chunks && t < a.t_len && (n < WC || l > 0))
          old[q] = __ldcg(reinterpret_cast<const uint4*>(
              (n < WC ? xin : a.skip) + b * plane + static_cast<size_t>(t) * WC + n % WC));
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int v = q * THREADS + threadIdx.x, r = v >> sh;
        const int n = n_lo + ((v & ((1 << sh) - 1)) << 3), t = t0 + r;
        if (v >= chunks || t >= a.t_len) continue;
        uint4 o = *reinterpret_cast<const uint4*>(rs_p + (r * TILE_LD + n) * 2);
        if (n < WC || l > 0) {
          unsigned int* ou = reinterpret_cast<unsigned int*>(&o);
          const unsigned int* pu = reinterpret_cast<const unsigned int*>(&old[q]);
#pragma unroll
          for (int h = 0; h < 4; ++h)
            ou[h] = bf16x2_bits(lo_f(pu[h]) + lo_f(ou[h]), hi_f(pu[h]) + hi_f(ou[h]));
        }
        *reinterpret_cast<uint4*>((n < WC ? xout : a.skip) + b * plane +
                                  static_cast<size_t>(t) * WC + n % WC) = o;
      }
    }
    if (!last) grid.sync();
  }

  // the end conv reads skip rows that other threads of the block wrote
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  end_conv_bf16(a, n_t, n_tiles);
}

// One tile's GEMM 1 alone, through the same ring and wgmma path: x (T, C)
// of one batch row, taps at dilation d of rows t0.., one layer's W_in image
// -> out (64, 2C) f32 raw sums in W_in's column order.  For card tests of
// the image, swizzle and descriptor layout.
__global__ void __launch_bounds__(THREADS, 1)
    gemm1_tile_kernel(const bf16* x, int t_len, int t0, int d, const bf16* w_in_img,
                      float* out) {
  extern __shared__ __align__(1024) unsigned char dsmem[];
  const uint32_t raw = smem_u32(dsmem), ring = (raw + 1023) & ~1023u;
  auto issue = [&](int g) {
    if (g < STEPS1)
      issue_step(ring + (g % S) * STAGE, g, x, t_len, t0, d, w_in_img, nullptr, false,
                 nullptr, 0, 0);
    cp_async_commit();
  };
  for (int g = 0; g < AHEAD; ++g) issue(g);
  float acc[2][64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[0][e] = acc[1][e] = 0.f;
  int g = 0;
  gemm1(acc, ring, g, issue);
  wgmma_wait(acc);
  const int w = threadIdx.x / 128;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int e = 0; e < 64; ++e)
      out[acc_row(e) * 2 * WC + p * WC + w * 128 + acc_col(e)] = acc[p][e];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace wg

// Cooperative launch of `kernel` on as many blocks as fit at once (every
// block must be resident for the grid barrier), at most one per tile.
template <typename Args>
int launch(void (*kernel)(Args), const Args& args, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int n_tiles = args.B * ((args.t_len + TT - 1) / TT);
  const int blocks = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  Args a = args;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                    dim3(THREADS), params, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
FlowArgs<T> flow_args(const void* audio, const void* cond, long long cond_sb, long long cond_st,
                      const void* w_start, const void* b_start, const void* w_in,
                      const void* b_in, const void* w_rs, const void* b_rs, const void* w_end,
                      const void* b_end, void* x0, void* x1, void* skip, void* out, int B,
                      int t_len, int C, int L, int n_half) {
  FlowArgs<T> a;
  a.audio = static_cast<const T*>(audio);
  a.cond = static_cast<const T*>(cond);
  a.cond_sb = cond_sb;
  a.cond_st = cond_st;
  a.w_start = static_cast<const T*>(w_start);
  a.b_start = static_cast<const float*>(b_start);
  a.w_in = static_cast<const T*>(w_in);
  a.b_in = static_cast<const float*>(b_in);
  a.w_rs = static_cast<const T*>(w_rs);
  a.b_rs = static_cast<const float*>(b_rs);
  a.w_end = static_cast<const T*>(w_end);
  a.b_end = static_cast<const float*>(b_end);
  a.x0 = static_cast<T*>(x0);
  a.x1 = static_cast<T*>(x1);
  a.skip = static_cast<T*>(skip);
  a.out = static_cast<T*>(out);
  a.B = B;
  a.t_len = t_len;
  a.C = C;
  a.L = L;
  a.n_half = n_half;
  return a;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns the first CUDA error
// of the launch (0 on success).  audio (B, n_half, T), x0, x1, skip
// (B, T, C) and out (B, 2*n_half, T) contiguous; cond (B, T, L*2C) with unit
// channel stride and the given batch / time strides; biases f32, shapes as
// in FlowArgs.
//
// f32 (wn_flow_f32) and bf16 at any width (wn_flow_bf16_tile), on
// wn_tile.cuh's tile: weights row-major as in FlowArgs; C % 128 == 0.
#define WN_FLOW_TILE_ENTRY(NAME, TYPE)                                                       \
  extern "C" int NAME(const void* audio, const void* cond, long long cond_sb,               \
                      long long cond_st, const void* w_start, const void* b_start,          \
                      const void* w_in, const void* b_in, const void* w_rs,                 \
                      const void* b_rs, const void* w_end, const void* b_end, void* x0,     \
                      void* x1, void* skip, void* out, int B, int t_len, int C, int L,      \
                      int n_half, void* stream) {                                           \
    const FlowArgs<TYPE> a =                                                                \
        flow_args<TYPE>(audio, cond, cond_sb, cond_st, w_start, b_start, w_in, b_in, w_rs,  \
                        b_rs, w_end, b_end, x0, x1, skip, out, B, t_len, C, L, n_half);     \
    return launch(wn_flow_tile_kernel<TYPE>, a, smem_bytes<TYPE>(C), stream);               \
  }

WN_FLOW_TILE_ENTRY(wn_flow_f32, float)
WN_FLOW_TILE_ENTRY(wn_flow_bf16_tile, __nv_bfloat16)

// bf16 on the wgmma tile: C == 256; w_in_img (L, 3C/32, 2C, 32) and w_rs_img (L, C/32, 2C, 32)
// are ops/wn_flow.py::weight_image's; cond 16-byte aligned with strides a
// multiple of 8.
extern "C" int wn_flow_bf16(const void* audio, const void* cond, long long cond_sb,
                            long long cond_st, const void* w_start, const void* b_start,
                            const void* w_in_img, const void* b_in, const void* w_rs_img,
                            const void* b_rs, const void* w_end, const void* b_end, void* x0,
                            void* x1, void* skip, void* out, int B, int t_len, int C, int L,
                            int n_half, void* stream) {
  if (C != wg::WC || (cond_sb | cond_st) % 8 || reinterpret_cast<uintptr_t>(cond) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlowArgs<bf16> a =
      flow_args<bf16>(audio, cond, cond_sb, cond_st, w_start, b_start, w_in_img, b_in,
                      w_rs_img, b_rs, w_end, b_end, x0, x1, skip, out, B, t_len, C, L, n_half);
  return launch(wg::wn_flow_bf16_kernel, a, wg::FLOW_SMEM, stream);
}

// The bf16 kernel's blocks per SM and dynamic shared memory.
extern "C" int wn_flow_bf16_occupancy(int* blocks_per_sm, int* smem) {
  *smem = wg::FLOW_SMEM;
  cudaError_t err = cudaFuncSetAttribute(wg::wn_flow_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, wg::wn_flow_bf16_kernel, THREADS, *smem));
}

// One tile's GEMM 1 (see gemm1_tile_kernel): x (T, 256) bf16, w_in_img one
// layer's (3C/32, 2C, 32) image, out (64, 512) f32.
extern "C" int wn_flow_bf16_gemm1_tile(const void* x, int t_len, int t0, int d,
                                       const void* w_in_img, void* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(wg::gemm1_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, wg::RING_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  wg::gemm1_tile_kernel<<<1, THREADS, wg::RING_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), t_len, t0, d, static_cast<const bf16*>(w_in_img),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
