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
// is bound by tensor-core operations.  Design: the (TT, 2C) pre-activation
// and the (TT, C) gate output never leave the SM.  GEMM 1 walks the output
// in chunks of 64 tanh + 64 sigmoid columns so the gate is applied straight
// from a f32 staging tile; the gate output stays in shared memory as the A
// operand of GEMM 2, whose epilogue adds the residual and writes skip.
// bf16 runs on the tensor cores (wmma 16x16x16, f32 accumulate); f32 runs
// on the CUDA cores in full f32 (no TF32), so it matches the plain version
// to f32 rounding.  Tiles are staged through shared memory without
// pipelining: simple first, fast later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int TT = 64;         // time rows per block
constexpr int NC = 128;        // output columns per chunk
constexpr int HALF = NC / 2;   // GEMM 1 chunk: HALF tanh + HALF sigmoid columns
constexpr int KC = 32;         // depth of one staged K tile
constexpr int THREADS = 256;   // 8 warps

// Row padding (elements) of the shared tiles: keeps wmma's ldm a multiple
// of 16 bytes and every fragment pointer 32-byte aligned, and staggers banks.
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int v = 4; };
template <> struct Pad<__nv_bfloat16> { static constexpr int v = 8; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A (TT x NC) f32 accumulator over staged tiles A (TT x KC) @ B (KC x NC).
template <typename T> struct Acc;

// f32: CUDA-core FMAs, each thread owns 4 rows x 8 strided columns.
template <> struct Acc<float> {
  float v[4][8];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) v[i][j] = 0.f;
  }
  __device__ void mma(const float* a, int lda, const float* b, int ldb) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = b[k * ldb + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = fmaf(av[i], bv[j], v[i][j]);
    }
  }
  __device__ void store(float* z, int ldz) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) z[(ty * 4 + i) * ldz + tx + 16 * j] = v[i][j];
  }
};

// bf16: tensor cores.  Warp w owns rows 16*(w%4).. and columns 64*(w/4)..
template <> struct Acc<__nv_bfloat16> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[4];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(f[j], 0.f);
  }
  __device__ void mma(const __nv_bfloat16* a, int lda, const __nv_bfloat16* b, int ldb) {
    const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;
#pragma unroll
    for (int k = 0; k < KC; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, a + wm * 16 * lda + k, lda);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, b + k * ldb + wn * 64 + j * 16, ldb);
        wmma::mma_sync(f[j], fa, fb, f[j]);
      }
    }
  }
  __device__ void store(float* z, int ldz) const {
    const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(z + wm * 16 * ldz + wn * 64 + j * 16, f[j], ldz,
                              wmma::mem_row_major);
  }
};

// As[r][kk] = x[b, t0 + r + shift, c0 + kk]; zero outside [0, T).
template <typename T>
__device__ void load_x_tile(T* as, int lda, const T* xb, int t_len, int C, int t0,
                            int c0, int shift) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr int VPR = KC / EPV;
  for (int v = threadIdx.x; v < TT * VPR; v += THREADS) {
    const int r = v / VPR, cv = (v % VPR) * EPV, t = t0 + r + shift;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < t_len)
      val = *reinterpret_cast<const uint4*>(xb + static_cast<size_t>(t) * C + c0 + cv);
    *reinterpret_cast<uint4*>(as + r * lda + cv) = val;
  }
}

// Bs[kk][nn] = w[k0 + kk][nn < HALF ? lo + nn : hi + nn - HALF]
template <typename T>
__device__ void load_w_tile(T* bs, int ldb, const T* w, int ldw, int k0, int lo, int hi) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr int VPR = NC / EPV;
  for (int v = threadIdx.x; v < KC * VPR; v += THREADS) {
    const int kk = v / VPR, nn = (v % VPR) * EPV;
    const int col = nn < HALF ? lo + nn : hi + nn - HALF;
    *reinterpret_cast<uint4*>(bs + kk * ldb + nn) =
        *reinterpret_cast<const uint4*>(w + static_cast<size_t>(k0 + kk) * ldw + col);
  }
}

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }

template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int C) {
  return round128(sizeof(T) * TT * (KC + Pad<T>::v)) +
         round128(sizeof(T) * KC * (NC + Pad<T>::v)) +
         round128(sizeof(float) * TT * (NC + 4)) +
         round128(sizeof(T) * TT * (C + Pad<T>::v));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wn_layer_kernel(const T* __restrict__ x, const T* __restrict__ cond, long long cond_sb,
                long long cond_st, const T* __restrict__ w_in, const T* __restrict__ b_in,
                const T* __restrict__ w_rs, const T* __restrict__ b_rs, T* __restrict__ audio,
                T* __restrict__ skip, int t_len, int C, int R, int d, int last) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = Pad<T>::v;
  const int lda = KC + P, ldb = NC + P, ldz = NC + 4, ldact = C + P;
  T* as = reinterpret_cast<T*>(smem);
  T* bs = reinterpret_cast<T*>(smem + round128(sizeof(T) * TT * lda));
  float* zs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(bs) +
                                       round128(sizeof(T) * KC * ldb));
  T* acts = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(zs) +
                                 round128(sizeof(float) * TT * ldz));

  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const T* xb = x + static_cast<size_t>(b) * t_len * C;
  const T* condb = cond + static_cast<size_t>(b) * cond_sb;

  // GEMM 1 (K = 3C) and the gate, 64 gate columns at a time.
  for (int j0 = 0; j0 < C; j0 += HALF) {
    Acc<T> acc;
    acc.zero();
    for (int k0 = 0; k0 < 3 * C; k0 += KC) {
      const int tap = k0 / C;
      load_x_tile(as, lda, xb, t_len, C, t0, k0 - tap * C, (tap - 1) * d);
      load_w_tile(bs, ldb, w_in, 2 * C, k0, j0, C + j0);
      __syncthreads();
      acc.mma(as, lda, bs, ldb);
      __syncthreads();
    }
    acc.store(zs, ldz);
    __syncthreads();
    for (int e = threadIdx.x; e < TT * HALF; e += THREADS) {
      const int r = e / HALF, cc = e % HALF, col = j0 + cc, t = t0 + r;
      float a = 0.f;
      if (t < t_len) {
        const T* cr = condb + static_cast<size_t>(t) * cond_st;
        const float zt = zs[r * ldz + cc] + to_f(b_in[col]) + to_f(cr[col]);
        const float zg = zs[r * ldz + HALF + cc] + to_f(b_in[C + col]) + to_f(cr[C + col]);
        a = tanhf(zt) * (1.f / (1.f + expf(-zg)));
      }
      acts[r * ldact + col] = from_f<T>(a);
    }
    __syncthreads();
  }

  // GEMM 2 (K = C) with the residual / skip epilogue, 128 columns at a time.
  for (int n0 = 0; n0 < R; n0 += NC) {
    Acc<T> acc;
    acc.zero();
    for (int k0 = 0; k0 < C; k0 += KC) {
      load_w_tile(bs, ldb, w_rs, R, k0, n0, n0 + HALF);
      __syncthreads();
      acc.mma(acts + k0, ldact, bs, ldb);
      __syncthreads();
    }
    acc.store(zs, ldz);
    __syncthreads();
    for (int e = threadIdx.x; e < TT * NC; e += THREADS) {
      const int r = e / NC, cc = e % NC, col = n0 + cc, t = t0 + r;
      if (t < t_len) {
        const T v = from_f<T>(zs[r * ldz + cc] + to_f(b_rs[col]));
        const size_t row = static_cast<size_t>(b) * t_len + t;
        if (last)
          skip[row * C + col] = v;
        else if (col < C)
          audio[row * C + col] = from_f<T>(to_f(x[row * C + col]) + to_f(v));
        else
          skip[row * C + col - C] = v;
      }
    }
    __syncthreads();
  }
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
