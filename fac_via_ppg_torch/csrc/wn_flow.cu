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
// f32 at C = 256 (wn_flow_f32), the synthesis CLI's int8 path (12
// launches a batch): each tile and layer on the f32 SIMT tile of
// wn_simt.cuh (shared with the layer kernel): one pass over all 2C
// columns, 128 f32 accumulators a thread, the gate in registers, fed by a
// 2-stage ring (weights by cp.async, x read through L2 into registers and
// stored K-major) that runs on across the block's tiles of a layer; the
// last layer is a template parameter.  Its epilogue here: x' = x +
// rs[:, :C] into the other ping-pong buffer, skip = rs[:, C:] in layer 0,
// else skip + rs[:, C:], 16 B a thread.  At the CLI's shape (B = 8,
// T = 20000, n_half = 4) a net does 1.32 TFLOP, 19.7 ms at 67 TFLOP/s
// f32, against ~2.7 GB that must move (0.8 ms at 3.35 TB/s): the FMA rate
// bounds it; every tile and layer streams ~2.1 MB of f32 weights from L2.
// On an H100 it runs at ~57 % of that bound, held as the layer kernel is
// (wn_simt.cuh).
//
// f32 and bf16 at widths other than 256 (wn_flow_f32_tile,
// wn_flow_bf16_tile; C % 128 == 0): the tile code of wn_tile.cuh
// (CUDA-core FMAs in f32, wmma in bf16; one staged K tile, a f32 staging
// tile for the gate).
//
// bf16 (wn_flow_bf16), built for C = 256: one block of three warpgroups
// per SM, the blocks in clusters of two (one TPC), runs each tile and
// layer on the wgmma tile of wn_wgmma.cuh (shared with the layer kernel,
// which feeds it from its own cp.async ring): both GEMMs on wgmma
// m64n128k16, the gate in registers.  Here a producer warpgroup feeds it
// through mbarrier rings (ClusterRing, below): each K step's 32 KB slice of
// the host's weight image is read from L2 once for the cluster, each
// block multicasting its half into both blocks' stages (16 KB a step a
// block from L2), and the x slices come by TMA from a (B, T, C) map.  The
// two blocks of a cluster walk their own tiles in lock-step (a block whose
// tile runs past the last one runs it masked).  The last layer is a
// template parameter.  Its epilogue here: x' = round(x + rs[:, :C]) into
// the other ping-pong buffer, skip = rs[:, C:] in layer 0, else
// round(skip + rs[:, C:]).  The start and end convs are 16 B vectors.
// Rounding follows the TPU kernel: x after the start conv, the gate output
// and the residual and skip adds in bf16, biases in f32, the cond add in
// f32 before the gate, tanh and the sigmoid in full f32 precision.  The
// arithmetic is the layer kernel's, step for step, so the output is bit
// for bit that of the kernel fed by the cp.async ring.
// What bounds it now: not the L2's weight stream (the same rings with each
// block reading its whole slice run as fast), but that the gate and the
// epilogue, about 14 us of a tile and layer's ~31 at the serving shape on
// an H100, leave the tensor cores idle (two warps a scheduler cannot hide
// the gate's latency, and a second tile in flight does not fit the
// registers), and that a block takes in 32 KB a step with three steps in
// flight, so GEMM 1 waits ~5 us a tile for its stages.

#include <cooperative_groups.h>

#include "wn_simt.cuh"

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
// bf16 at C = 256: the wgmma tile of wn_wgmma.cuh

namespace wg {

// layer_tile's epilogue here: residual columns x' = round(x + rs) into the
// other ping-pong buffer; skip columns skip = rs in layer 0 (sum false),
// else round(skip + rs).  Rows are (b * T + t), C bf16 wide.
struct FlowEpi {
  const bf16* x;
  bf16* x_out;
  bf16* skip;
  bool sum;
  __device__ bool adds(int n) const { return n < WC || sum; }
  __device__ const bf16* src(size_t row, int n) const {
    return n < WC ? x + row * WC + n : skip + row * WC + n - WC;
  }
  __device__ bf16* dst(size_t row, int n) const {
    return n < WC ? x_out + row * WC + n : skip + row * WC + n - WC;
  }
};

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

// The flow kernel's rings (ClusterRing, below).  The blocks run in clusters
// of CLUSTER (one TPC), and each K step's weight slice is read from L2 once
// for the cluster: each block copies its 1/CLUSTER of the slice into every
// block's stage with one multicast bulk copy.  A block is three
// warpgroups: the two consumer warpgroups of layer_tile (threads 0-255), then
// a producer warpgroup (256-383) in which one thread of warp 8 issues the
// weight slices and one thread of warp 9 the x slices by TMA (zero-filled
// outside [0, T): the conv's padding) and, once a tile, the tile's cond
// rows, one bulk copy a row.  The weights run through S stages, each with
// a full barrier (the local producer's arrival and the whole slice's
// bytes, half of which the peer block sends) and an empty barrier (one
// arrival from each consumer warpgroup of both blocks, once the wgmma that
// read the stage has completed), so no producer overwrites a stage before
// both blocks are done with it.  The x slices, which come from device
// memory, run SX steps ahead through their own stages (x_full: the bytes;
// x_empty: the block's two consumer warpgroups), so that their latency
// hides behind more steps than the weights' stages hold.  The tile buffer
// has a cond_full barrier (the cond bytes) and a tile_free barrier (every
// consumer thread, after the epilogue).
constexpr int CLUSTER = 2;
constexpr int FLOW_THREADS = THREADS + 128;
constexpr int SX = 8;                         // x stages
constexpr int COND_ROW = 2 * WC * 2;          // bytes of one tile row of cond
// the x producer issues a tile's cond with this GEMM 1 step of the tile: by
// then the block has released the tile's x step COND_AT - SX, so the
// previous tile's epilogue is done with the tile buffer and the tile_free
// wait does not stall
constexpr int COND_AT = SX;
constexpr int X_RING = S * B_BYTES;           // the x stages' offset from the weight stages'
constexpr int TILE_AT = X_RING + SX * A_BYTES;  // the tile buffer's
constexpr int BARS_AT = TILE_AT + TILE_BYTES;   // the barriers'
// full[S], empty[S], x_full[SX], x_empty[SX], cond_full, tile_free
constexpr int FLOW_SMEM = 1024 + BARS_AT + 8 * (2 * S + 2 * SX + 2);
// registers a thread: 168 at launch (65,536 / 384, rounded down to 8); the
// producer warpgroup gives most of its own to the consumers
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
static_assert(128 * PRODUCER_REGS + THREADS * CONSUMER_REGS <= FLOW_THREADS * 168,
              "the register split fits what the block was given");
static_assert(COND_AT < STEPS1, "cond lands before the gate");
static_assert(FLOW_SMEM <= 232448, "fits a block's shared memory");
static_assert(TILE_AT % 1024 == 0 && B_BYTES % 1024 == 0, "swizzle atoms need 1 KB alignment");

// the 256 consumer threads (named barrier 1; grid.sync uses barrier 0)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// layer_tile's ring policy in the flow kernel (see above).  g is the block's
// ring step over the whole launch, the same count as its weight producer's;
// tiles counts the tiles done, for the x stages (STEPS1 a tile, as the x
// producer counts them) and the tile buffer's barriers.  A step's stages go
// back to their producers as soon as its wgmma has completed (kPending 0).
struct ClusterRing {
  static constexpr int kPending = 0;
  uint32_t w_base, x_base, full, empty, empty_peer, x_full, x_empty, cond_full, tile_free;
  int tiles;
  __device__ __forceinline__ uint32_t acquire(int g) {
    mbar_wait(full + 8 * (g % S), (g / S) & 1);
    return w_base + (g % S) * B_BYTES;
  }
  __device__ __forceinline__ uint32_t x_slice(int, int s) {
    const int k = tiles * STEPS1 + s;
    mbar_wait(x_full + 8 * (k % SX), (k / SX) & 1);
    return x_base + (k % SX) * A_BYTES;
  }
  // after mma_step(g): step g's wgmma has completed
  __device__ __forceinline__ void step_done(int g) {
    if (threadIdx.x % 128 == 0) {
      mbar_arrive(empty + 8 * (g % S));
      mbar_arrive_cluster(empty_peer + 8 * (g % S));
    }
  }
  __device__ __forceinline__ void x_done(int s) {
    if (threadIdx.x % 128 == 0) mbar_arrive(x_empty + 8 * ((tiles * STEPS1 + s) % SX));
  }
  __device__ __forceinline__ void sync() { consumers_sync(); }
  __device__ __forceinline__ void cond_ready() { mbar_wait(cond_full, tiles & 1); }
  // the gate output, written by the threads, is read by wgmma (async proxy)
  __device__ __forceinline__ void acts_ready() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();
  }
  // the next tile's cond may be copied over the tile buffer
  __device__ __forceinline__ void tile_done() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(tile_free);
    ++tiles;
  }
};

// The buffers and barriers of a block, shared by its producers and consumers.
struct FlowSmem {
  uint32_t w_ring, x_ring, tile_s, full, empty, x_full, x_empty, cond_full, tile_free;
  unsigned char* tile_p;
  __device__ explicit FlowSmem(unsigned char* dsmem) {
    const uint32_t raw = smem_u32(dsmem);
    w_ring = (raw + 1023) & ~1023u;
    x_ring = w_ring + X_RING;
    tile_s = w_ring + TILE_AT;
    tile_p = dsmem + (tile_s - raw);
    full = w_ring + BARS_AT;
    empty = full + 8 * S;
    x_full = empty + 8 * S;
    x_empty = x_full + 8 * SX;
    cond_full = x_empty + 8 * SX;
    tile_free = cond_full + 8;
  }
};

// The ping-pong x buffers as TMA maps: x[l % 2] is layer l's input.
struct XMaps {
  CUtensorMap x[2];
};

// The block's tiles of a layer: tile i is blockIdx.x + i * gridDim.x, for i
// < n_iter, the count of the cluster's first block; a tile past the last
// (its peer's odd one) is masked: nothing is loaded for it or written.
struct Tiles {
  int n_t, n_tiles, n_iter;
  __device__ Tiles(const FlowArgs<bf16>& a) {
    n_t = (a.t_len + TT - 1) / TT;
    n_tiles = a.B * n_t;
    n_iter = (n_tiles - static_cast<int>(blockIdx.x & ~(CLUSTER - 1)) + gridDim.x - 1) /
             gridDim.x;
  }
};

// The weight producer's layer l: every ring step of the block's tiles, in
// the consumers' order (the masked tile's too: the peer's stages need this
// block's part); g runs on over the launch.
template <bool kLast>
__device__ __forceinline__ void produce_weights(const FlowArgs<bf16>& a, int l,
                                                const FlowSmem& sm, const Tiles& tl,
                                                uint32_t rank, int& g) {
  const char* w_in = reinterpret_cast<const char*>(a.w_in) + static_cast<size_t>(l) * STEPS1 * B_BYTES;
  const char* w_rs = reinterpret_cast<const char*>(a.w_rs) + static_cast<size_t>(l) * STEPS2 * B_BYTES;
  for (int i = 0; i < tl.n_iter; ++i) {
    for (int s = 0; s < STEPS; ++s, ++g) {
      const uint32_t full = sm.full + 8 * (g % S);
      mbar_wait(sm.empty + 8 * (g % S), ((g / S) & 1) ^ 1);
      // the slice (the last layer's GEMM 2: image rows C.. only), 1/CLUSTER
      // of it from each block of the cluster
      const uint32_t w0 = kLast && s >= STEPS1 ? B_BYTES / 2 : 0;
      const uint32_t part = (B_BYTES - w0) / CLUSTER;
      mbar_expect_tx(full, B_BYTES - w0);
      const char* w = s < STEPS1 ? w_in + s * B_BYTES : w_rs + (s - STEPS1) * B_BYTES;
      bulk_multicast(sm.w_ring + (g % S) * B_BYTES + w0 + rank * part, w + w0 + rank * part,
                     part, full, (1u << CLUSTER) - 1);
    }
  }
}

// The x producer's layer l: GEMM 1's x slices of the block's tiles and each
// tile's cond rows; k (x steps) and j (tiles) run on over the launch.
__device__ __forceinline__ void produce_x(const FlowArgs<bf16>& a, const CUtensorMap* xmap, int l,
                                          const FlowSmem& sm, const Tiles& tl, int& k, int& j) {
  const int d = 1 << l;
  const bf16* cond = a.cond + static_cast<size_t>(l) * 2 * WC;
  for (int i = 0; i < tl.n_iter; ++i, ++j) {
    const int tile = blockIdx.x + i * gridDim.x;
    const bool valid = tile < tl.n_tiles;
    const int b = valid ? tile / tl.n_t : 0, t0 = (tile % tl.n_t) * TT;
    for (int s = 0; s < STEPS1; ++s, ++k) {
      const uint32_t full = sm.x_full + 8 * (k % SX);
      mbar_wait(sm.x_empty + 8 * (k % SX), ((k / SX) & 1) ^ 1);
      mbar_expect_tx(full, valid ? A_BYTES : 0);
      if (valid) {
        const int k0 = s * KC, tap = k0 / WC;
        tma_load_3d(sm.x_ring + (k % SX) * A_BYTES, xmap, full, k0 - tap * WC, t0 + (tap - 1) * d,
                    b);
      }
      if (s == COND_AT) {
        mbar_wait(sm.tile_free, (j & 1) ^ 1);
        const int rows = valid ? min(TT, a.t_len - t0) : 0;
        mbar_expect_tx(sm.cond_full, rows * COND_ROW);
        const bf16* cb = cond + b * a.cond_sb + static_cast<long long>(t0) * a.cond_st;
        for (int r = 0; r < rows; ++r)
          bulk_load(sm.tile_s + r * TILE_LD * 2, cb + r * a.cond_st, COND_ROW, sm.cond_full);
      }
    }
  }
}

// The consumers' layer l over the block's tiles.
template <bool kLast>
__device__ __forceinline__ void consume_layer(const FlowArgs<bf16>& a, int l, const FlowSmem& sm,
                                              const Tiles& tl, ClusterRing& ring,
                                              float (&acc)[2][64], int& g) {
  const bf16* xin = (l & 1) ? a.x1 : a.x0;
  bf16* xout = (l & 1) ? a.x0 : a.x1;
  const float* b_in = a.b_in + static_cast<size_t>(l) * 2 * WC;
  const float* b_rs = a.b_rs + static_cast<size_t>(l) * 2 * WC;
  const FlowEpi epi{xin, xout, a.skip, l > 0};
  for (int i = 0; i < tl.n_iter; ++i) {
    const int tile = blockIdx.x + i * gridDim.x;
    const bool valid = tile < tl.n_tiles;
    const int b = valid ? tile / tl.n_t : 0, t0 = valid ? (tile % tl.n_t) * TT : a.t_len;
    layer_tile(acc, sm.tile_s, sm.tile_p, g, ring, b_in, b_rs, 0, kLast, t0, a.t_len,
               static_cast<size_t>(b) * a.t_len, epi);
  }
}

__global__ void __launch_bounds__(FLOW_THREADS, 1)
    wn_flow_bf16_kernel(const __grid_constant__ XMaps maps, const FlowArgs<bf16> a) {
  extern __shared__ __align__(1024) unsigned char dsmem[];
  const FlowSmem sm(dsmem);
  const Tiles tl(a);
  const uint32_t rank = cluster_rank();
  cg::grid_group grid = cg::this_grid();
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(sm.full + 8 * i, 1);
      mbar_init(sm.empty + 8 * i, 2 * CLUSTER);
    }
    for (int i = 0; i < SX; ++i) {
      mbar_init(sm.x_full + 8 * i, 1);
      mbar_init(sm.x_empty + 8 * i, 2);
    }
    mbar_init(sm.cond_full, 1);
    mbar_init(sm.tile_free, THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the peer's barriers are set up before anything reaches them
  cluster_sync();

  int g = 0;
  if (threadIdx.x >= THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    int k = 0, j = 0;
    grid.sync();
    for (int l = 0; l < a.L; ++l) {
      if (threadIdx.x == THREADS) {
        if (l == a.L - 1)
          produce_weights<true>(a, l, sm, tl, rank, g);
        else
          produce_weights<false>(a, l, sm, tl, rank, g);
      } else if (threadIdx.x == THREADS + 32) {
        // x was written by other blocks' threads before the grid barrier
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        produce_x(a, &maps.x[l & 1], l, sm, tl, k, j);
      }
      __syncwarp();
      if (l + 1 < a.L) grid.sync();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    ClusterRing ring{sm.w_ring,  sm.x_ring, sm.full,      sm.empty,
                     peer_addr(sm.empty, rank ^ 1), sm.x_full, sm.x_empty,
                     sm.cond_full, sm.tile_free, 0};
    start_conv_bf16(a, tl.n_t, tl.n_tiles);
    // x, written here, is read by the next layer's TMA (async proxy)
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    grid.sync();
    float acc[2][64];
    for (int l = 0; l + 1 < a.L; ++l) {
      consume_layer<false>(a, l, sm, tl, ring, acc, g);
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      grid.sync();
    }
    consume_layer<true>(a, a.L - 1, sm, tl, ring, acc, g);
  }
  // no block exits while its peer may still copy into its shared memory or
  // arrive on its barriers; the end conv reads skip rows that other threads
  // of the block wrote
  cluster_sync();
  if (threadIdx.x < THREADS) end_conv_bf16(a, tl.n_t, tl.n_tiles);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32 at C = 256: the SIMT tile of wn_simt.cuh

namespace simt {

// layer_tile's epilogue here: residual columns x' = x + rs into the other
// ping-pong buffer; skip columns skip = rs in layer 0 (sum false), else
// skip + rs.  Old values are read through L2 (other blocks wrote x).
struct FlowEpi {
  const float* x;
  float* x_out;
  float* skip;
  bool sum;
  __device__ bool adds(int n) const { return n < WC || sum; }
  __device__ float4 old(size_t row, int n) const {
    return __ldcg(reinterpret_cast<const float4*>(n < WC ? x + row * WC + n
                                                         : skip + row * WC + n - WC));
  }
  __device__ float* dst(size_t row, int n) const {
    return n < WC ? x_out + row * WC + n : skip + row * WC + n - WC;
  }
};

// Layer l of the net over the block's tiles, on a ring started afresh.
template <bool kLast>
__device__ __forceinline__ void flow_layer(const FlowArgs<float>& a, int l, float (&acc)[2][8][8],
                                           float* ring, float* acts, int n_t, int n_mine) {
  const float* xin = (l & 1) ? a.x1 : a.x0;
  float* xout = (l & 1) ? a.x0 : a.x1;
  const float* w_in = a.w_in + static_cast<size_t>(l) * 3 * WC * NW;
  // the last layer's skip-only projection sits in columns [C, 2C)
  const float* w_rs = a.w_rs + static_cast<size_t>(l) * WC * NW + (kLast ? WC : 0);
  Feed<kLast> feed{ring, xin, w_in, w_rs, NW, n_mine * STEPS, n_t, a.t_len, 0, 1 << l};
  feed.start();
  const FlowEpi epi{xin, xout, a.skip, l > 0};
  int g = 0;
  for (int i = 0; i < n_mine; ++i) {
    const int tile = blockIdx.x + i * gridDim.x, b = tile / n_t;
    layer_tile<kLast>(acc, ring, acts, g, feed, a.b_in + static_cast<size_t>(l) * NW,
                      a.cond + b * a.cond_sb + static_cast<size_t>(l) * NW, a.cond_st,
                      a.b_rs + static_cast<size_t>(l) * NW, 0, (tile % n_t) * TT, a.t_len,
                      static_cast<size_t>(b) * a.t_len, epi);
  }
}

__global__ void __launch_bounds__(THREADS, 1) wn_flow_f32_kernel(const FlowArgs<float> a) {
  extern __shared__ __align__(16) float smem_f[];
  float* const ring = smem_f;
  float* const acts = smem_f + S * STAGE;
  cg::grid_group grid = cg::this_grid();
  const int n_t = (a.t_len + TT - 1) / TT, n_tiles = a.B * n_t;
  const int n_mine = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  start_conv(a, n_t, n_tiles);
  grid.sync();
  float acc[2][8][8];
  for (int l = 0; l + 1 < a.L; ++l) {
    flow_layer<false>(a, l, acc, ring, acts, n_t, n_mine);
    grid.sync();
  }
  flow_layer<true>(a, a.L - 1, acc, ring, acts, n_t, n_mine);

  // the end conv stages skip rows (64 x C) in acts, which GEMM 2 read last
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  end_conv(a, n_t, n_tiles, acts, WC);
}

}  // namespace simt

// Cooperative launch of `kernel` on as many blocks as fit at once (every
// block must be resident for the grid barrier), at most one per tile.
template <typename Args>
int launch(void (*kernel)(Args), const Args& args, size_t smem, void* stream) {
  int blocks = 0;
  const int err =
      persistent_grid(kernel, smem, args.B * ((args.t_len + TT - 1) / TT), &blocks);
  if (err != 0) return err;
  Args a = args;
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                    dim3(blocks), dim3(THREADS), params, smem,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
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

namespace wg {

// The bf16 kernel's launch: `clusters` clusters of CLUSTER blocks, and
// cooperative, for its grid barrier: the runtime refuses a grid that the
// card cannot hold at once.
void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attrs, int clusters) {
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = CLUSTER;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg->gridDim = dim3(clusters * CLUSTER);
  cfg->blockDim = dim3(FLOW_THREADS);
  cfg->dynamicSmemBytes = FLOW_SMEM;
  cfg->attrs = attrs;
  cfg->numAttrs = 2;
}

// The kernel's clusters the current card holds at once (one a TPC: 66 on an
// H100 SXM), queried once per device.
int active_clusters(int* active) {
  static int cached[64] = {};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && cached[dev] > 0) {
    *active = cached[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wn_flow_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FLOW_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[2];
  launch_config(&cfg, attrs, sms / CLUSTER);
  err = cudaOccupancyMaxActiveClusters(active, wn_flow_bf16_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*active < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (dev < 64) cached[dev] = *active;
  return 0;
}

}  // namespace wg

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns the first CUDA error
// of the launch (0 on success).  audio (B, n_half, T), x0, x1, skip
// (B, T, C) and out (B, 2*n_half, T) contiguous; cond (B, T, L*2C) with unit
// channel stride and the given batch / time strides; biases f32, shapes as
// in FlowArgs.
//
// f32 (wn_flow_f32_tile) and bf16 (wn_flow_bf16_tile) at any width, on
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

WN_FLOW_TILE_ENTRY(wn_flow_f32_tile, float)
WN_FLOW_TILE_ENTRY(wn_flow_bf16_tile, __nv_bfloat16)

// bf16 on the wgmma tile: C == 256; w_in_img (L, 3C/32, 2C, 32) and w_rs_img (L, C/32, 2C, 32)
// are ops/wn_image.py::weight_image's; cond 16-byte aligned with strides a
// multiple of 8.
extern "C" int wn_flow_bf16(const void* audio, const void* cond, long long cond_sb,
                            long long cond_st, const void* w_start, const void* b_start,
                            const void* w_in_img, const void* b_in, const void* w_rs_img,
                            const void* b_rs, const void* w_end, const void* b_end, void* x0,
                            void* x1, void* skip, void* out, int B, int t_len, int C, int L,
                            int n_half, void* stream) {
  if (C != wg::WC || L < 1 || (cond_sb | cond_st) % 8 || reinterpret_cast<uintptr_t>(cond) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlowArgs<bf16> a =
      flow_args<bf16>(audio, cond, cond_sb, cond_st, w_start, b_start, w_in_img, b_in,
                      w_rs_img, b_rs, w_end, b_end, x0, x1, skip, out, B, t_len, C, L, n_half);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  wg::XMaps maps;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(wg::WC), static_cast<cuuint64_t>(t_len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {wg::WC * 2ull, static_cast<cuuint64_t>(t_len) * wg::WC * 2};
  const cuuint32_t box[3] = {wg::KC, TT, 1}, elem[3] = {1, 1, 1};
  for (int i = 0; i < 2; ++i) {
    const CUresult r = encode(&maps.x[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, i ? x1 : x0, dims,
                              strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  }
  int active = 0;
  const int err = wg::active_clusters(&active);
  if (err != 0) return err;
  const int pairs = (B * ((t_len + TT - 1) / TT) + wg::CLUSTER - 1) / wg::CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[2];
  wg::launch_config(&cfg, attrs, pairs < active ? pairs : active);
  cfg.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, wg::wn_flow_bf16_kernel, maps, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernel's blocks per SM and dynamic shared memory.
extern "C" int wn_flow_bf16_occupancy(int* per_sm, int* smem) {
  *smem = wg::FLOW_SMEM;
  cudaError_t err = cudaFuncSetAttribute(wg::wn_flow_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, wg::wn_flow_bf16_kernel,
                                                        wg::FLOW_THREADS, *smem);
  return static_cast<int>(err);
}

// The bf16 kernel's cluster size and the clusters of its launch that the
// card holds at once.
extern "C" int wn_flow_bf16_clusters(int* size, int* active) {
  *size = wg::CLUSTER;
  return wg::active_clusters(active);
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

// f32 on the SIMT tile: C == 256, L >= 1; weights row-major as in
// FlowArgs; cond 16-byte aligned with strides a multiple of 4.
extern "C" int wn_flow_f32(const void* audio, const void* cond, long long cond_sb,
                           long long cond_st, const void* w_start, const void* b_start,
                           const void* w_in, const void* b_in, const void* w_rs,
                           const void* b_rs, const void* w_end, const void* b_end, void* x0,
                           void* x1, void* skip, void* out, int B, int t_len, int C, int L,
                           int n_half, void* stream) {
  if (C != simt::WC || L < 1 || (cond_sb | cond_st) % 4 ||
      reinterpret_cast<uintptr_t>(cond) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlowArgs<float> a =
      flow_args<float>(audio, cond, cond_sb, cond_st, w_start, b_start, w_in, b_in, w_rs, b_rs,
                       w_end, b_end, x0, x1, skip, out, B, t_len, C, L, n_half);
  return launch(simt::wn_flow_f32_kernel, a, simt::BLOCK_SMEM, stream);
}

// The f32 kernel's blocks per SM and dynamic shared memory.
extern "C" int wn_flow_f32_occupancy(int* per_sm, int* smem) {
  *smem = simt::BLOCK_SMEM;
  return blocks_per_sm(simt::wn_flow_f32_kernel, *smem, per_sm);
}

// One tile's GEMM 1 of the f32 SIMT tile (see simt::gemm1_tile_kernel): x
// (T, 256) f32, w_in (3C, 2C) one layer's, out (64, 512) f32.
extern "C" int wn_flow_f32_gemm1_tile(const void* x, int t_len, int t0, int d,
                                      const void* w_in, void* out, void* stream) {
  constexpr int smem = simt::S * simt::STAGE * 4;
  cudaError_t err = cudaFuncSetAttribute(simt::gemm1_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  simt::gemm1_tile_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), t_len, t0, d, static_cast<const float*>(w_in),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
