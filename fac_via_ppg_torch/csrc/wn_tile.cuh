// Tile machinery shared by the WN kernels (wn_layer.cu, wn_flow.cu): at
// C = 256 bf16 runs wn_wgmma.cuh's tile and f32 wn_simt.cuh's; this tile
// runs both types at the other widths (C % 128 == 0).  Its host helpers
// (blocks_per_sm, persistent_grid) and the constants TT and THREADS serve
// all three.
//
// One block of THREADS threads computes one WN layer for a tile of TT time
// rows, channels-last:
//
//   gate_tile: acts = tanh(z[:, :C]) * sigmoid(z[:, C:]),
//              z = [x(t-d) | x(t) | x(t+d)] @ W_in (3C, 2C) + b_in + cond
//   rs_tile:   rs = acts @ W_rs + b_rs, handed to an epilogue per element
//
// Both GEMMs accumulate in f32.  bf16 runs on the tensor cores (wmma
// 16x16x16); f32 on the CUDA cores in full f32 (no TF32).  GEMM 1 walks the
// output in chunks of HALF tanh + HALF sigmoid columns, so the gate is
// applied straight from a f32 staging tile; the gate output, rounded to the
// working type, stays in shared memory as the A operand of GEMM 2.  Taps
// read x rows t + (j-1)d from device memory and read zero outside [0, T):
// that is the conv's zero padding.  Tiles are staged through shared memory
// without pipelining.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int TT = 64;         // time rows per tile
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

// Loads through L2 only (ld.global.cg), for buffers that other blocks of the
// same launch wrote: the SM's L1 is not coherent with their stores.
__device__ __forceinline__ float ld_l2(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_l2(const __nv_bfloat16* p) {
  const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(u) << 16);
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
// kL2: read through L2 only (see ld_l2).
template <bool kL2, typename T>
__device__ void load_x_tile(T* as, int lda, const T* xb, int t_len, int C, int t0,
                            int c0, int shift) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr int VPR = KC / EPV;
  for (int v = threadIdx.x; v < TT * VPR; v += THREADS) {
    const int r = v / VPR, cv = (v % VPR) * EPV, t = t0 + r + shift;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < t_len) {
      const uint4* src = reinterpret_cast<const uint4*>(xb + static_cast<size_t>(t) * C + c0 + cv);
      val = kL2 ? __ldcg(src) : *src;
    }
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

// Sets `kernel`'s dynamic shared memory to `smem` bytes; *per_sm gets how
// many of its blocks of THREADS threads fit on one SM.  Returns the first
// CUDA error (0 on success).
template <typename Kernel> int blocks_per_sm(Kernel kernel, size_t smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, THREADS, smem);
  return static_cast<int>(err);
}

// A persistent grid for `kernel`: *blocks gets as many blocks as are
// resident on the card at once, at most n_tiles.  Returns the first CUDA
// error (0 on success).
template <typename Kernel> int persistent_grid(Kernel kernel, size_t smem, int n_tiles, int* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  const int err = blocks_per_sm(kernel, smem, &per_sm);
  if (err != 0) return err;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  return 0;
}

template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int C) {
  return round128(sizeof(T) * TT * (KC + Pad<T>::v)) +
         round128(sizeof(T) * KC * (NC + Pad<T>::v)) +
         round128(sizeof(float) * TT * (NC + 4)) +
         round128(sizeof(T) * TT * (C + Pad<T>::v));
}

// The block's dynamic shared memory (smem_bytes<T>(C) bytes), carved up.
template <typename T> struct Smem {
  T* as;       // (TT, KC) A tile of GEMM 1
  T* bs;       // (KC, NC) B tile of both GEMMs
  float* zs;   // (TT, NC) f32 staging of a finished chunk
  T* acts;     // (TT, C) gate output, the A operand of GEMM 2
  int lda, ldb, ldz, ldact;
  __device__ Smem(unsigned char* p, int C)
      : lda(KC + Pad<T>::v), ldb(NC + Pad<T>::v), ldz(NC + 4), ldact(C + Pad<T>::v) {
    as = reinterpret_cast<T*>(p);
    p += round128(sizeof(T) * TT * lda);
    bs = reinterpret_cast<T*>(p);
    p += round128(sizeof(T) * KC * ldb);
    zs = reinterpret_cast<float*>(p);
    p += round128(sizeof(float) * TT * ldz);
    acts = reinterpret_cast<T*>(p);
  }
};

// GEMM 1 and the gate for the tile of rows [t0, t0 + TT) of one batch row:
// xb (T, C) its x, condb its cond rows at stride cond_st (unit channel
// stride), w_in (3C, 2C) tap-stacked.  Rows past T get acts 0.
template <bool kL2, typename T, typename BiasT>
__device__ void gate_tile(const Smem<T>& s, const T* xb, int t_len, int C, int t0, int d,
                          const T* w_in, const BiasT* b_in, const T* condb,
                          long long cond_st) {
  for (int j0 = 0; j0 < C; j0 += HALF) {
    Acc<T> acc;
    acc.zero();
    for (int k0 = 0; k0 < 3 * C; k0 += KC) {
      const int tap = k0 / C;
      load_x_tile<kL2>(s.as, s.lda, xb, t_len, C, t0, k0 - tap * C, (tap - 1) * d);
      load_w_tile(s.bs, s.ldb, w_in, 2 * C, k0, j0, C + j0);
      __syncthreads();
      acc.mma(s.as, s.lda, s.bs, s.ldb);
      __syncthreads();
    }
    acc.store(s.zs, s.ldz);
    __syncthreads();
    for (int e = threadIdx.x; e < TT * HALF; e += THREADS) {
      const int r = e / HALF, cc = e % HALF, col = j0 + cc, t = t0 + r;
      float a = 0.f;
      if (t < t_len) {
        const T* cr = condb + static_cast<size_t>(t) * cond_st;
        const float zt = s.zs[r * s.ldz + cc] + to_f(b_in[col]) + to_f(cr[col]);
        const float zg = s.zs[r * s.ldz + HALF + cc] + to_f(b_in[C + col]) + to_f(cr[C + col]);
        a = tanhf(zt) * (1.f / (1.f + expf(-zg)));
      }
      s.acts[r * s.ldact + col] = from_f<T>(a);
    }
    __syncthreads();
  }
}

// GEMM 2 over columns [n_begin, n_end) of w_rs (C rows, row stride ldw), NC
// columns at a time: epi(r, col, v) gets v = (acts @ w_rs)[r, col] +
// b_rs[col] in f32 for every row r of the tile.
template <typename T, typename BiasT, typename Epi>
__device__ void rs_tile(const Smem<T>& s, int C, const T* w_rs, int ldw, const BiasT* b_rs,
                        int n_begin, int n_end, Epi epi) {
  for (int n0 = n_begin; n0 < n_end; n0 += NC) {
    Acc<T> acc;
    acc.zero();
    for (int k0 = 0; k0 < C; k0 += KC) {
      load_w_tile(s.bs, s.ldb, w_rs, ldw, k0, n0, n0 + HALF);
      __syncthreads();
      acc.mma(s.acts + k0, s.ldact, s.bs, s.ldb);
      __syncthreads();
    }
    acc.store(s.zs, s.ldz);
    __syncthreads();
    for (int e = threadIdx.x; e < TT * NC; e += THREADS) {
      const int r = e / NC, cc = e % NC, col = n0 + cc;
      epi(r, col, s.zs[r * s.ldz + cc] + to_f(b_rs[col]));
    }
    __syncthreads();
  }
}

}  // namespace
