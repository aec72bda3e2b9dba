// One WaveGlow WN layer, channels-last, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fac_via_ppg_tpu/ops/wn_pallas.py::
// wn_layer_pallas (_wn_layer_kernel).  Per (batch, time tile of TT rows):
//
//   z    = [x(t-d) | x(t) | x(t+d)] @ W_in (3C, 2C) + b_in + cond   (f32 acc)
//   acts = tanh(z[:, :C]) * sigmoid(z[:, C:])          (rounded to x's type)
//   rs   = acts @ W_rs (C, R) + b_rs                               (f32 acc)
//   audio = x + rs[:, :C], skip = rs[:, C:]        (R = 2C)
//   last layer: skip = rs (R = C), audio is not written (the caller keeps x)
//
// Taps read x rows t + (j-1)d directly from device memory and read zero
// outside [0, T): this is the conv's zero padding, so the caller pads
// nothing and re-masks nothing between layers, and every dilation runs here.
//
// Bound on the H100: at the serving shapes (C = 256, bf16) the layer does
// 2*(3C*2C + C*2C) = 1 MFLOP per time row against (C + 2C + 2C) * 2 B =
// 2.5 KB moved, ~410 FLOP/byte, above the card's ~295 FLOP/byte ridge: it
// is bound by tensor-core operations.  Design (wn_tile.cuh): the (TT, 2C)
// pre-activation and the (TT, C) gate output never leave the SM; GEMM 2's
// epilogue adds the residual and writes skip.  Simple first, fast later.

#include "wn_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
wn_layer_kernel(const T* __restrict__ x, const T* __restrict__ cond, long long cond_sb,
                long long cond_st, const T* __restrict__ w_in, const T* __restrict__ b_in,
                const T* __restrict__ w_rs, const T* __restrict__ b_rs, T* __restrict__ audio,
                T* __restrict__ skip, int t_len, int C, int R, int d, int last) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> s(smem, C);
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  gate_tile<false>(s, x + static_cast<size_t>(b) * t_len * C, t_len, C, t0, d, w_in, b_in,
                   cond + static_cast<size_t>(b) * cond_sb, cond_st);
  rs_tile(s, C, w_rs, R, b_rs, 0, R, [&](int r, int col, float z) {
    const int t = t0 + r;
    if (t >= t_len) return;
    const T v = from_f<T>(z);
    const size_t row = static_cast<size_t>(b) * t_len + t;
    if (last)
      skip[row * C + col] = v;
    else if (col < C)
      audio[row * C + col] = from_f<T>(to_f(x[row * C + col]) + to_f(v));
    else
      skip[row * C + col - C] = v;
  });
}

template <typename T>
int launch(const void* x, const void* cond, long long cond_sb, long long cond_st,
           const void* w_in, const void* b_in, const void* w_rs, const void* b_rs,
           void* audio, void* skip, int B, int t_len, int C, int R, int d, int last,
           void* stream) {
  const size_t smem = smem_bytes<T>(C);
  cudaError_t err = cudaFuncSetAttribute(
      wn_layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + TT - 1) / TT, B);
  wn_layer_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(cond), cond_sb, cond_st,
      static_cast<const T*>(w_in), static_cast<const T*>(b_in), static_cast<const T*>(w_rs),
      static_cast<const T*>(b_rs), static_cast<T*>(audio), static_cast<T*>(skip), t_len, C,
      R, d, last);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Shapes: x, audio, skip (B, T, C)
// contiguous; cond (B, T, 2C) with unit channel stride and the given batch /
// time strides; w_in (3C, 2C), w_rs (C, R) row-major; C % 128 == 0.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int wn_layer_f32(const void* x, const void* cond, long long cond_sb,
                            long long cond_st, const void* w_in, const void* b_in,
                            const void* w_rs, const void* b_rs, void* audio, void* skip,
                            int B, int t_len, int C, int R, int d, int last, void* stream) {
  return launch<float>(x, cond, cond_sb, cond_st, w_in, b_in, w_rs, b_rs, audio, skip, B,
                       t_len, C, R, d, last, stream);
}

extern "C" int wn_layer_bf16(const void* x, const void* cond, long long cond_sb,
                             long long cond_st, const void* w_in, const void* b_in,
                             const void* w_rs, const void* b_rs, void* audio, void* skip,
                             int B, int t_len, int C, int R, int d, int last, void* stream) {
  return launch<__nv_bfloat16>(x, cond, cond_sb, cond_st, w_in, b_in, w_rs, b_rs, audio,
                               skip, B, t_len, C, R, d, last, stream);
}
