// The bf16 wgmma tile of the WN kernels at C = 256, for Hopper (sm_90a):
// shared by the layer kernel (wn_layer.cu, one layer per launch) and the
// whole-net flow kernel (wn_flow.cu, all layers of a net per launch).
//
// One block of two warpgroups computes one WN layer for a tile of TT = 64
// time rows of one batch row, channels-last, in `layer_tile`:
//
//   z    = [x(t-d) | x(t) | x(t+d)] @ W_in (3C, 2C) + b_in + cond   (f32 acc)
//   acts = tanh(z[:, :C]) * sigmoid(z[:, C:])                   (bf16)
//   rs   = acts @ W_rs (C, 2C) + b_rs                 (f32 acc, rounded to bf16)
//
// and hands rs to the caller's epilogue policy, 16 B a thread.  Both GEMMs
// run on wgmma (m64n128k16, f32 accumulators in registers, operands in
// shared memory):
//   - GEMM 1: warpgroup w owns all 64 rows and 256 of the 512 columns:
//     tanh columns w*128.. and the sigmoid columns C + w*128.. that pair
//     with them.  The host lays W_in's columns out in that order
//     (ops/wn_image.py::weight_image), so each K step's x slice (64 x KC)
//     is loaded once for all 2C columns, and the tanh and sigmoid sums of
//     one column sit in the same thread: the gate (+ b_in + cond, in f32)
//     is applied in registers, with no f32 staging tile.  The gate output
//     (64 x C bf16) goes to shared memory in wgmma's 128 B-swizzled K-major
//     layout, as GEMM 2's A operand.
//   - GEMM 2: warpgroup 0 computes the residual columns, warpgroup 1 the
//     skip columns; a last layer's skip-only projection (image rows C..,
//     zero residual columns) is split between them.  round(rs + b_rs)
//     goes to shared memory, and all threads then apply the epilogue 16 B
//     at a time, every old value loaded before any store.
//   - A ring of KC-deep K steps feeds both GEMMs (3C/KC steps of x slice +
//     W_in slice, then C/KC of W_rs slices) and runs on across the gate,
//     the epilogue and the next tile; it also lands the tile's cond rows
//     in a tile buffer that later holds the gate output, then the rounded
//     rs.  x rows outside [0, T) read zero: the conv's zero padding.  The
//     weight images are pre-swizzled by the host, so their copies are
//     contiguous.  layer_tile takes the ring as a policy (`ring`: acquire
//     a step's slices, release them, the block's barrier): CopyRing here,
//     the layer kernel's and gemm1_tile_kernel's, S stages of x slice +
//     weight slice filled with cp.async 16 B a thread, one wgmma group in
//     flight while the next step's copies are issued, the cond rows riding
//     along with ring step COND_STEP; wn_flow.cu's ClusterRing, whose
//     stages a producer warpgroup fills by TMA and multicast.
// Rounding follows the TPU kernels: f32 accumulation, the biases and the
// cond added in f32 before the gate, tanh and the sigmoid in full f32
// precision (tanhf, 1 / (1 + expf(-x))), the gate output and rs rounded to
// bf16.  The arithmetic does not depend on the ring: the same K steps go
// into the same accumulators in the same order.  With CopyRing a block
// takes BLOCK_SMEM (~210 KB) of shared memory: 1 block per SM.
// Ceiling of CopyRing (the layer kernel): every tile streams ~1 MB of bf16
// weights (W_in 768 x 512, W_rs 256 x 512) from L2 into its SM, ~58 FLOP a
// byte, through 16 B copies of every thread, two steps ahead; the flow
// kernel's ClusterRing, its TMA producer and its cluster multicast took
// that kernel from ~40 to ~31 us a tile and layer on an H100 (wn_flow.cu
// says what bounds it next).  The layer kernel does not use them yet.

#pragma once

#include "hopper.cuh"
#include "wn_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

// its own names: wn_tile.cuh's tile constants (KC, ...) stay the old tile's
namespace wg {

constexpr int WC = 256;                  // the channels C the tile is built for
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
constexpr int BLOCK_SMEM = RING_SMEM + TILE_BYTES;  // a kernel's dynamic shared memory
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
// b0 (128 x KC), and acc[1] likewise from b1 if `two`.  Returns with at most
// kPending wgmma groups in flight: with 1 (the cp.async ring), this step's,
// the previous one complete (its stage may be refilled after the next
// barrier); with 0 (the flow kernel's ring), this step's complete too, so
// its stage goes back to the producer at once.  wgmma_wait() before
// reading acc.
template <int kPending>
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
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
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

// The ring policy of the layer kernel and gemm1_tile_kernel (layer_tile and
// gemm1 take it as `ring`): every thread copies its share of each step with
// cp.async (issue(g) issues ring step g and commits it as one group),
// acquire(g) waits for step g (ring_wait), issues step g + AHEAD and gives
// the step's weight slice; its x slice shares the stage.  The block's
// barrier is __syncthreads.  The cond rows land with step COND_STEP, and
// GEMM 2's first ring_wait fences the gate output for wgmma, so the other
// hooks do nothing here.  One wgmma group stays in flight across steps
// (kPending).
template <typename Issue> struct CopyRing {
  static constexpr int kPending = 1;
  uint32_t base;  // stage 0, 1 KB aligned
  Issue& issue;
  __device__ __forceinline__ uint32_t acquire(int g) {
    ring_wait();
    issue(g + AHEAD);
    return base + (g % S) * STAGE + A_BYTES;
  }
  // GEMM 1's x slice of ring step g (its s-th step of the tile)
  __device__ __forceinline__ uint32_t x_slice(int g, int) const {
    return base + (g % S) * STAGE;
  }
  __device__ __forceinline__ void step_done(int) {}
  __device__ __forceinline__ void x_done(int) {}
  __device__ __forceinline__ void sync() { __syncthreads(); }
  __device__ __forceinline__ void cond_ready() {}
  __device__ __forceinline__ void acts_ready() {}
  __device__ __forceinline__ void tile_done() {}
};

// GEMM 1 of one tile: ring steps g..; warpgroup w's acc[0] gets the tanh
// columns w*128.., acc[1] the sigmoid columns C + w*128.. (image rows
// w*256..).  ring.step_done(g) and ring.x_done(s) follow mma_step.
template <typename Ring>
__device__ __forceinline__ void gemm1(float (&acc)[2][64], Ring& ring, int& g) {
  const int w = threadIdx.x / 128;
  for (int s = 0; s < STEPS1; ++s, ++g) {
    const uint32_t bs = ring.acquire(g), st = ring.x_slice(g, s);
    mma_step<Ring::kPending>(acc, st, 8 * ROW, SW64, bs + (w * 256) * ROW,
                             bs + (w * 256 + 128) * ROW, true);
    ring.step_done(g);
    ring.x_done(s);
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

// One tile of one WN layer: rows t0.. of the batch row whose first row has
// index row0 (= b * T), ring steps g.. of the ring policy `ring` (CopyRing
// here, wn_flow.cu's ClusterRing), which also lands the tile's cond rows in
// the tile buffer at tile_s / tile_p.  Only the first 256 threads (the two
// warpgroups) run it; ring.sync() is their barrier.  b_in (2C) and
// b_rs hold the biases (f32 or bf16), b_rs that of rs column n at n - rs_b0.
// The epilogue policy `epi` takes the rounded rs 16 B (8 columns) at a
// time: chunk n of row `row` (index row0 + t) is written to epi.dst(row,
// n), where epi.adds(n) as round(old + rs) with the old value at
// epi.src(row, n), else as rs.  Rows past T are not written.  In the last
// layer only the skip columns [C, 2C) are computed and handed on.
template <typename Epi, typename BiasT, typename Ring>
__device__ __forceinline__ void layer_tile(float (&acc)[2][64], uint32_t tile_s,
                                           unsigned char* tile_p, int& g, Ring& ring,
                                           const BiasT* b_in, const BiasT* b_rs, int rs_b0,
                                           bool last, int t0, int t_len, size_t row0,
                                           const Epi& epi) {
  const int w = threadIdx.x / 128;
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[0][e] = acc[1][e] = 0.f;
  gemm1(acc, ring, g);
  wgmma_wait(acc);
  ring.cond_ready();

  // the gate, in registers: z = acc + b_in + cond (f32) -> acts (bf16),
  // written over cond once every thread has read its own
  unsigned int acts[32];
#pragma unroll
  for (int e = 0; e < 64; e += 2) {
    const int r = acc_row(e), k = w * 128 + acc_col(e);
    const unsigned char* cr = tile_p + (r * TILE_LD + k) * 2;
    const unsigned int ct = *reinterpret_cast<const unsigned int*>(cr);
    const unsigned int cs = *reinterpret_cast<const unsigned int*>(cr + 2 * WC);
    const float zt0 = acc[0][e] + to_f(b_in[k]) + lo_f(ct);
    const float zt1 = acc[0][e + 1] + to_f(b_in[k + 1]) + hi_f(ct);
    const float zs0 = acc[1][e] + to_f(b_in[WC + k]) + lo_f(cs);
    const float zs1 = acc[1][e + 1] + to_f(b_in[WC + k + 1]) + hi_f(cs);
    acts[e / 2] = bf16x2_bits(gate(zt0, zs0), gate(zt1, zs1));
  }
  ring.sync();
#pragma unroll
  for (int e = 0; e < 64; e += 2) {
    const int r = acc_row(e), k = w * 128 + acc_col(e);
    *reinterpret_cast<unsigned int*>(tile_p + (k / 64) * 8192 +
                                     swz<128>(r * 128 + (k % 64) * 2)) = acts[e / 2];
  }
  ring.acts_ready();

  // GEMM 2: warpgroup w's image rows w*256.. (0: residual, 1: skip
  // columns), or in the last layer the skip rows C + w*128..
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[0][e] = acc[1][e] = 0.f;
  const int col0 = last ? WC + w * 128 : w * 256;
  for (int s = 0; s < STEPS2; ++s, ++g) {
    const uint32_t bs = ring.acquire(g), k = s * KC;
    mma_step<Ring::kPending>(acc, tile_s + (k / 64) * 8192 + (k % 64) * 2, 1024, SW128,
                             bs + col0 * ROW, bs + (col0 + 128) * ROW, !last);
    ring.step_done(g);
  }

  wgmma_wait(acc);
  // epilogue: rs = round(acc + b_rs) into the tile buffer once both
  // warpgroups' GEMM 2 is done with acts, then 16 B a thread
  ring.sync();
  unsigned char* const rs_p = tile_p;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (p == 1 && last) break;
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
      const int n = col0 + p * 128 + acc_col(e);
      *reinterpret_cast<unsigned int*>(rs_p + (acc_row(e) * TILE_LD + n) * 2) =
          bf16x2_bits(acc[p][e] + to_f(b_rs[n - rs_b0]), acc[p][e + 1] + to_f(b_rs[n + 1 - rs_b0]));
    }
  }
  ring.sync();
  // rs columns [2C - ncol, 2C), 8 a chunk, 2^sh chunks a row
  const int sh = last ? 5 : 6, n_lo = last ? WC : 0, chunks = TT << sh;
  constexpr int Q = TT * 2 * WC / 8 / THREADS;
  uint4 old[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int v = q * THREADS + threadIdx.x, r = v >> sh;
    const int n = n_lo + ((v & ((1 << sh) - 1)) << 3), t = t0 + r;
    old[q] = make_uint4(0u, 0u, 0u, 0u);
    if (v < chunks && t < t_len && epi.adds(n))
      old[q] = __ldcg(reinterpret_cast<const uint4*>(epi.src(row0 + t, n)));
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int v = q * THREADS + threadIdx.x, r = v >> sh;
    const int n = n_lo + ((v & ((1 << sh) - 1)) << 3), t = t0 + r;
    if (v >= chunks || t >= t_len) continue;
    uint4 o = *reinterpret_cast<const uint4*>(rs_p + (r * TILE_LD + n) * 2);
    if (epi.adds(n)) {
      unsigned int* ou = reinterpret_cast<unsigned int*>(&o);
      const unsigned int* pu = reinterpret_cast<const unsigned int*>(&old[q]);
#pragma unroll
      for (int h = 0; h < 4; ++h)
        ou[h] = bf16x2_bits(lo_f(pu[h]) + lo_f(ou[h]), hi_f(pu[h]) + hi_f(ou[h]));
    }
    *reinterpret_cast<uint4*>(epi.dst(row0 + t, n)) = o;
  }
  ring.tile_done();
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
  CopyRing<decltype(issue)> cr{ring, issue};
  float acc[2][64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[0][e] = acc[1][e] = 0.f;
  int g = 0;
  gemm1(acc, cr, g);
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

}  // namespace
