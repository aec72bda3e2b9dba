// The f32 SIMT tile of the WN kernels at C = 256, for Hopper (sm_90a):
// shared by the layer kernel (wn_layer.cu, one layer per launch) and the
// whole-net flow kernel (wn_flow.cu, all layers of a net per launch).
//
// One block of 8 warps computes one WN layer for a tile of TT = 64 time
// rows of one batch row, channels-last, in `layer_tile`:
//
//   z    = [x(t-d) | x(t) | x(t+d)] @ W_in (3C, 2C) + b_in + cond
//   acts = tanh(z[:, :C]) * sigmoid(z[:, C:])
//   rs   = acts @ W_rs (C, 2C) + b_rs
//
// all in f32 on the CUDA cores (FMA, no TF32, no tensor cores), and hands
// rs to the caller's epilogue policy 16 B at a time.
//
// Bound: each row needs 2 * (3C * 2C + C * 2C) = 1 MFLOP against ~5 KB of
// its own traffic, so at 67 TFLOP/s f32 the FMA rate bounds it.  The
// design keeps the FMA pipes fed:
//   - One pass, the gate in registers.  Thread (rg, cg) owns rows
//     8rg .. 8rg + 7 and, in GEMM 1, the tanh columns cg*4 + {0..3} and
//     128 + cg*4 + {0..3} with the sigmoid columns C + those that pair
//     with them: 128 f32 accumulators.  So all 2C columns are computed in
//     one pass over K (x is read once per tile), and the tanh and sigmoid
//     sums of a column sit in one thread: the gate runs in registers and
//     writes acts (C x 64 f32, K-major) to shared memory, GEMM 2's A
//     operand.  GEMM 2 uses the same ownership over the residual | skip
//     columns.
//   - The accumulators start at b_in + cond (and at b_rs in GEMM 2), read
//     as float4s before the first K step: only the order of the f32
//     additions differs from the plain version.
//   - 16-byte operand loads that broadcast, and few registers for them:
//     both A operands are K-major, so a thread's 8 rows of one K value are
//     two 16-byte loads (8 registers, not 32 for a row-major 8 x 4 block);
//     its 16 B values are four more.  A warp holds 4 row groups x 8 column
//     groups, so the 8 threads of a quarter warp read one A address and
//     128 contiguous bytes of a B row.  6 LDS.128 per 128 FMAs.
//   - A ring of S = 2 stages of KC = 32-deep K steps (73 KB each): GEMM
//     1's steps hold an x slice (KC x 64, taps outside [0, T) zero: the
//     conv's zero padding) and a W_in slice (KC x 2C), GEMM 2's a W_rs
//     slice.  Weights come by cp.async 16 B a thread; the x slice 16 B a
//     thread through registers one step ahead, stored transposed.  The
//     ring runs on from GEMM 1 into GEMM 2 and into the block's next tile,
//     one step (~8 us) ahead of the FMAs: the latency is hidden by the
//     ring and by the 128 independent accumulators, not by occupancy (one
//     block per SM).  One barrier a step: 32 a tile.
//   - The last layer (skip-only W_rs) is a template parameter: its GEMM 2
//     computes and loads only the skip columns.
// Ceiling: every tile streams ~2.1 MB of f32 weights (W_in 1.57 MB, W_rs
// 0.52 MB) from L2 into its SM, 32 FLOP per weight byte: at the FMA rate
// all SMs together need ~2.1 TB/s of L2.  On an H100 (700 W) the layer at
// B = 8, T = 20000 runs at 62 % of the FMA bound, streaming ~1.3 TB/s of
// weights, with the SM clock at its 1980 MHz maximum.  L2 does not hold
// it: the K loop's unroll alone, at the same L2 traffic, moved the time by
// 15 %.  The instruction stream around 128 live accumulators does (~250
// registers a thread, so ptxas has little room to run loads ahead).

#pragma once

#include "wn_wgmma.cuh"

namespace {

// its own names: wn_tile.cuh's and wn_wgmma.cuh's tile constants stay theirs
namespace simt {

constexpr int WC = 256;                  // the channels C the tile is built for
constexpr int KC = 32;                   // depth of one ring step
constexpr int S = 2;                     // ring stages
constexpr int AHEAD = S - 1;             // steps in flight ahead of the FMAs
constexpr int NW = 2 * WC;               // columns of one weight slice
constexpr int A_LD = TT + 4;             // row stride of a K-major A operand (floats)
constexpr int A_FLOATS = KC * A_LD;      // x slice, K-major (KC x 64)
constexpr int B_FLOATS = KC * NW;        // weight slice (KC x 2C)
constexpr int STAGE = A_FLOATS + B_FLOATS;  // floats of one stage
constexpr int STEPS1 = 3 * WC / KC, STEPS2 = WC / KC, STEPS = STEPS1 + STEPS2;
// a kernel's dynamic shared memory: the ring, then acts (C x 64, K-major)
constexpr int BLOCK_SMEM = (S * STAGE + WC * A_LD) * 4;
constexpr int XC = TT * KC / 4 / THREADS;  // x chunks (16 B) a thread and step
static_assert(XC * THREADS * 4 == TT * KC, "whole x chunks per thread");
static_assert(B_FLOATS / 4 % THREADS == 0, "whole weight chunks per thread");

// This thread's first row (rows r0 + i, i < 8) and first column (cg * 4).
__device__ __forceinline__ int row0() {
  return ((threadIdx.x / 128) * 4 + (threadIdx.x % 32) / 8) * 8;
}
__device__ __forceinline__ int col4() {
  return (((threadIdx.x / 32) % 4) * 8 + threadIdx.x % 8) * 4;
}

// Column of accumulator acc[h][i][4p + e]: half h (0: tanh / residual, 1:
// sigmoid / skip), p the 128-column group, e the lane of a float4.
__device__ __forceinline__ int acc_col(int h, int p) { return h * WC + p * 128 + col4(); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ void put4(float* acc, float4 v) {
  acc[0] = v.x;
  acc[1] = v.y;
  acc[2] = v.z;
  acc[3] = v.w;
}
__device__ __forceinline__ float4 get4(const float* acc) {
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// The oldest ring step in flight has landed, every thread's copies and
// stores are visible, and every thread is done with the step before (whose
// stage the caller refills next).
__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD - 1) : "memory");
  __syncthreads();
}

// The producer side of one block's ring.  Ring step g belongs to the
// block's tile g / STEPS (tile index blockIdx.x + (g / STEPS) * gridDim.x,
// batch row tile / n_t, first row t_first + (tile % n_t) * TT) and is step
// s = g % STEPS of it.  s < STEPS1: GEMM 1's x slice (taps of x (B, T, C)
// at dilation d, zero outside [0, T)) and W_in (3C, 2C) slice; after that
// a W_rs slice, rows of w_rs at row stride ldw, all 2C columns or with
// kLast only the skip columns (w_rs then points at the first skip column)
// into the stage's columns [C, 2C).  Weights go by cp.async, 16 B a
// thread.  The x slice, 16 B a thread, is read through L2 into registers
// one step ahead (x_next) and stored K-major, so that GEMM 1 reads 8 rows
// of one K value as two 16-byte loads.
template <bool kLast> struct Feed {
  float* ring;
  const float* x;
  const float* w_in;
  const float* w_rs;
  int ldw, steps, n_t, t_len, t_first, d;
  float4 x_next[XC];

  // Reads into x_next this thread's x chunks of ring step g (zero outside
  // [0, T), and for steps past the block's or of GEMM 2): chunk q is row
  // v / (KC / 4), columns 4 (v % (KC / 4)).., v = threadIdx.x + q * THREADS.
  __device__ void fetch_x(int g) {
    const bool any = g < steps && g % STEPS < STEPS1;
    const int tile = blockIdx.x + (g / STEPS) * gridDim.x, b = tile / n_t;
    const int k0 = (g % STEPS) * KC, tap = k0 / WC, c0 = k0 - tap * WC;
#pragma unroll
    for (int q = 0; q < XC; ++q) {
      const int v = threadIdx.x + q * THREADS, r = v / (KC / 4), c = v % (KC / 4);
      const int t = t_first + (tile % n_t) * TT + r + (tap - 1) * d;
      x_next[q] = any && t >= 0 && t < t_len
                      ? __ldcg(reinterpret_cast<const float4*>(
                            x + (static_cast<size_t>(b) * t_len + t) * WC + c0 + c * 4))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // Starts the ring: steps 0 .. AHEAD - 1.
  __device__ void start() {
    fetch_x(0);
    for (int g = 0; g < AHEAD; ++g) (*this)(g);
  }

  // Issues ring step g into its stage (one commit group, empty past the
  // block's steps) and reads the x slice of step g + 1.
  __device__ void operator()(int g) {
    if (g < steps) {
      float* const st = ring + (g % S) * STAGE;
      float* const bs = st + A_FLOATS;
      const int s = g % STEPS;
      if (s < STEPS1) {
#pragma unroll
        for (int q = 0; q < XC; ++q) {
          const int v = threadIdx.x + q * THREADS, r = v / (KC / 4), c = (v % (KC / 4)) * 4;
          st[(c + 0) * A_LD + r] = x_next[q].x;
          st[(c + 1) * A_LD + r] = x_next[q].y;
          st[(c + 2) * A_LD + r] = x_next[q].z;
          st[(c + 3) * A_LD + r] = x_next[q].w;
        }
        const float* w = w_in + static_cast<size_t>(s) * KC * NW;
#pragma unroll
        for (int v = threadIdx.x; v < B_FLOATS / 4; v += THREADS)
          wg::cp_async16(smem_u32(bs + v * 4), w + v * 4, true);
      } else {
        const float* w = w_rs + static_cast<size_t>(s - STEPS1) * KC * ldw;
        constexpr int CPR = (kLast ? WC : NW) / 4;   // chunks of one row
#pragma unroll
        for (int v = threadIdx.x; v < KC * CPR; v += THREADS) {
          const int kk = v / CPR, ch = (v % CPR) * 4;
          wg::cp_async16(smem_u32(bs + kk * NW + (kLast ? WC : 0) + ch),
                         w + static_cast<size_t>(kk) * ldw + ch, true);
        }
      }
    }
    wg::cp_async_commit();
    fetch_x(g + 1);
  }
};

// acc += A @ B over KC values of K: A K-major at a (row stride A_LD, this
// thread's 8 rows contiguous), B (KC x 2C at b, row stride NW); kSkip:
// only the columns [C, 2C) (acc[1]).
template <bool kSkip>
__device__ __forceinline__ void fma_step(float (&acc)[2][8][8], const float* a, const float* b) {
  const int r0 = row0(), c4 = col4();
  // unrolled by 8, not fully: the full unroll let ptxas hoist loads until
  // both kernels ran ~15 % slower (chip_smoke.py --time-f32 on the H100,
  // at KC = 16 and 4 stages: unroll 16, 4, 8 gave the layer 4.72, 4.20,
  // 4.02 ms; KC = 32 and 2 stages, half the barriers, then 3.92 ms)
#pragma unroll 8
  for (int k = 0; k < KC; ++k) {
    float av[8], bv[2][8];
    put4(&av[0], ld4(a + k * A_LD + r0));
    put4(&av[4], ld4(a + k * A_LD + r0 + 4));
#pragma unroll
    for (int h = kSkip ? 1 : 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 2; ++p) put4(&bv[h][4 * p], ld4(b + k * NW + c4 + h * WC + p * 128));
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = kSkip ? 1 : 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[h][i][j] = fmaf(av[i], bv[h][j], acc[h][i][j]);
  }
}

// GEMM 1 of one tile on the ring: steps g.. (feed(i) issues ring step i).
template <typename FeedT>
__device__ __forceinline__ void gemm1(float (&acc)[2][8][8], const float* ring, int& g,
                                      FeedT& feed) {
  for (int s = 0; s < STEPS1; ++s, ++g) {
    ring_wait();
    feed(g + AHEAD);
    const float* st = ring + (g % S) * STAGE;
    fma_step<false>(acc, st, st + A_FLOATS);
  }
}

// One tile of one WN layer: rows t0.. of the batch row whose first row has
// index row_b (= b * T), ring steps g.. (feed(i) issues ring step i).
// condb: the batch row's cond (row stride cond_st, unit channel stride,
// 16-byte aligned rows); b_in (2C); b_rs[n - rs_b0] the bias of rs column
// n.  The epilogue policy `epi` takes rs 4 columns at a time: chunk n of
// row `row` (index row_b + t) is written to epi.dst(row, n) as old + rs
// where epi.adds(n), the old value from epi.old(row, n), else as rs.  Rows
// past T are neither read nor written.  kLast: only the skip columns
// [C, 2C) of rs are computed and handed on.
template <bool kLast, typename Epi, typename FeedT>
__device__ __forceinline__ void layer_tile(float (&acc)[2][8][8], const float* ring, float* acts,
                                           int& g, FeedT& feed, const float* b_in,
                                           const float* condb, long long cond_st,
                                           const float* b_rs, int rs_b0, int t0, int t_len,
                                           size_t row_b, const Epi& epi) {
  const int r0 = row0();
  // GEMM 1's accumulators start at b_in + cond (rows past T: b_in)
  float4 bias[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < 2; ++p)
      bias[h][p] = __ldg(reinterpret_cast<const float4*>(b_in + acc_col(h, p)));
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + r0 + i;
    const float* cr = condb + static_cast<size_t>(t < t_len ? t : 0) * cond_st;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float4 v = bias[h][p];
        if (t < t_len) v = add4(v, __ldg(reinterpret_cast<const float4*>(cr + acc_col(h, p))));
        put4(&acc[h][i][4 * p], v);
      }
  }
  gemm1(acc, ring, g, feed);

  // the gate, in registers, into acts K-major (GEMM 2 of the previous tile
  // has long finished reading it: a ring step's barrier lies between)
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = wg::gate(acc[0][i][4 * p + e], acc[1][i][4 * p + e]);
      float* dst = acts + (acc_col(0, p) + e) * A_LD + r0;
      *reinterpret_cast<float4*>(dst) = get4(&a[0]);
      *reinterpret_cast<float4*>(dst + 4) = get4(&a[4]);
    }

  // GEMM 2, its accumulators started at b_rs; acts is read after the next
  // ring step's barrier
#pragma unroll
  for (int h = kLast ? 1 : 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float4 b = __ldg(reinterpret_cast<const float4*>(b_rs + acc_col(h, p) - rs_b0));
#pragma unroll
      for (int i = 0; i < 8; ++i) put4(&acc[h][i][4 * p], b);
    }
  for (int s = 0; s < STEPS2; ++s, ++g) {
    ring_wait();
    feed(g + AHEAD);
    fma_step<kLast>(acc, acts + s * KC * A_LD, ring + (g % S) * STAGE + A_FLOATS);
  }

  // epilogue, a row at a time: every old value of the row loaded, then stored
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + r0 + i;
    if (t >= t_len) continue;
    const size_t row = row_b + t;
    float4 old[2][2];
#pragma unroll
    for (int h = kLast ? 1 : 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int n = acc_col(h, p);
        old[h][p] = epi.adds(n) ? epi.old(row, n) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int h = kLast ? 1 : 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int n = acc_col(h, p);
        float4 v = get4(&acc[h][i][4 * p]);
        if (epi.adds(n)) v = add4(old[h][p], v);
        *reinterpret_cast<float4*>(epi.dst(row, n)) = v;
      }
  }
}

// One tile's GEMM 1 alone, through the same ring and FMA path: x (T, C) of
// one batch row, taps at dilation d of rows t0.., W_in (3C, 2C) -> out
// (64, 2C) f32 raw sums.  For card tests of the ring and the ownership.
__global__ void __launch_bounds__(THREADS, 1)
    gemm1_tile_kernel(const float* x, int t_len, int t0, int d, const float* w_in, float* out) {
  extern __shared__ __align__(16) float ring[];
  Feed<false> feed{ring, x, w_in, nullptr, 0, STEPS1, 1, t_len, t0, d};
  feed.start();
  float acc[2][8][8] = {};
  int g = 0;
  gemm1(acc, ring, g, feed);
  const int r0 = row0();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        *reinterpret_cast<float4*>(out + (r0 + i) * NW + acc_col(h, p)) =
            get4(&acc[h][i][4 * p]);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace simt

}  // namespace
