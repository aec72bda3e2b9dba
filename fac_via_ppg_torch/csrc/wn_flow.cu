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
// Design.  The TPU kernel kept each tile's whole residual window (tile plus
// a 255-sample receptive-field halo on each side) in VMEM; on Hopper that
// window alone is larger than a block's 227 KB of shared memory.  So this is
// one persistent cooperative launch: every block owns a fixed set of
// (batch, 64-row) tiles for the whole call.  x lives in two (B, T, C)
// ping-pong buffers in device memory (L2-resident at the serving shape):
// layer l reads buffer l % 2 (taps cross tiles) and writes the other, and a
// grid-wide barrier separates the layers.  Each tile's skip sum lives in a
// (B, T, C) buffer that only its own block touches, so it needs no barrier,
// and the same block applies the end conv after the last layer.  Per layer
// and tile the (TT, 2C) pre-activation and the gate output stay on the SM
// (wn_tile.cuh).  Buffers written by other blocks are read through L2 only.
// The last layer's skip-only projection computes and writes only the skip
// columns.  Simple first: no TMA, no wgmma, no pipelining.

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
  const T* w_in;                     // (L, 3C, 2C) tap-stacked
  const float* b_in;                 // (L, 2C)
  const T* w_rs;                     // (L, C, 2C); last layer: skip in [C, 2C)
  const float* b_rs;                 // (L, 2C)
  const T* w_end;                    // (C, 2*n_half)
  const float* b_end;                // (2*n_half)
  T* x0;                             // (B, T, C) residual ping
  T* x1;                             // (B, T, C) residual pong
  T* skip;                           // (B, T, C) skip sum
  T* out;                            // (B, 2*n_half, T)
  int B, t_len, C, L, n_half;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) wn_flow_kernel(const FlowArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> s(smem, a.C);
  cg::grid_group grid = cg::this_grid();
  const int C = a.C, n_t = (a.t_len + TT - 1) / TT, n_tiles = a.B * n_t;
  const size_t plane = static_cast<size_t>(a.t_len) * C;

  // start conv: x0 = round(audio^T @ w_start + b_start)
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

  // end conv over the block's own tiles: skip staged in shared memory (acts)
  const int n_out = 2 * a.n_half;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / n_t, t0 = (tile % n_t) * TT;
    const T* sk = a.skip + b * plane;
    for (int e = threadIdx.x; e < TT * C; e += THREADS) {
      const int r = e / C, c = e % C, t = t0 + r;
      s.acts[r * s.ldact + c] =
          from_f<T>(t < a.t_len ? ld_l2(sk + static_cast<size_t>(t) * C + c) : 0.f);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n_out * TT; e += THREADS) {
      const int o = e / TT, r = e % TT, t = t0 + r;
      if (t >= a.t_len) continue;
      float acc = 0.f;
      for (int c = 0; c < C; ++c)
        acc = fmaf(to_f(s.acts[r * s.ldact + c]), to_f(a.w_end[c * n_out + o]), acc);
      a.out[(static_cast<size_t>(b) * n_out + o) * a.t_len + t] = from_f<T>(acc + a.b_end[o]);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const FlowArgs<T>& args, void* stream) {
  const size_t smem = smem_bytes<T>(args.C);
  cudaError_t err = cudaFuncSetAttribute(
      wn_flow_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wn_flow_kernel<T>, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // every block must be resident at once for the grid barrier
  const int n_tiles = args.B * ((args.t_len + TT - 1) / TT);
  const int blocks = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  FlowArgs<T> a = args;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&wn_flow_kernel<T>),
                                    dim3(blocks), dim3(THREADS), params, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* audio, const void* cond, long long cond_sb, long long cond_st,
        const void* w_start, const void* b_start, const void* w_in, const void* b_in,
        const void* w_rs, const void* b_rs, const void* w_end, const void* b_end, void* x0,
        void* x1, void* skip, void* out, int B, int t_len, int C, int L, int n_half,
        void* stream) {
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
  return launch<T>(a, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes).  audio (B, n_half, T), x0, x1,
// skip (B, T, C) and out (B, 2*n_half, T) contiguous; cond (B, T, L*2C) with
// unit channel stride and the given batch / time strides; weights row-major
// in the working type, biases f32, shapes as in FlowArgs; C % 128 == 0.
// Returns the first CUDA error of the launch (0 on success).
#define WN_FLOW_ENTRY(NAME, TYPE)                                                            \
  extern "C" int NAME(const void* audio, const void* cond, long long cond_sb,               \
                      long long cond_st, const void* w_start, const void* b_start,          \
                      const void* w_in, const void* b_in, const void* w_rs,                 \
                      const void* b_rs, const void* w_end, const void* b_end, void* x0,     \
                      void* x1, void* skip, void* out, int B, int t_len, int C, int L,      \
                      int n_half, void* stream) {                                           \
    return run<TYPE>(audio, cond, cond_sb, cond_st, w_start, b_start, w_in, b_in, w_rs,     \
                     b_rs, w_end, b_end, x0, x1, skip, out, B, t_len, C, L, n_half,         \
                     stream);                                                               \
  }

WN_FLOW_ENTRY(wn_flow_f32, float)
WN_FLOW_ENTRY(wn_flow_bf16, __nv_bfloat16)
