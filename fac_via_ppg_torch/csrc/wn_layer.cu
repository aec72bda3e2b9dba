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
// Bound on the H100: at the fused serving shape (B = 4, T = 10000, C = 256,
// bf16) the layer does 2*(3C*2C + C*2C) = 1 MFLOP per time row, 41.9 GFLOP
// (0.0424 ms at 989 TFLOP/s), against (C + 2C + C + C) * 2 B = 2.5 KB per
// row that must move, 0.10 GB (0.031 ms at 3.35 TB/s): bound by tensor-core
// operations.
//
// bf16 at C = 256 (wn_layer_bf16), the served path: the wgmma tile of
// wn_wgmma.cuh, shared with the flow kernel.  One persistent block of two
// warpgroups per SM walks the tiles blockIdx.x + i * gridDim.x; both GEMMs
// of a tile run on wgmma m64n128k16 with f32 accumulators in registers, fed
// by one cp.async ring (over the host's pre-swizzled weight image,
// ops/wn_image.py) that runs on across the tiles, and the gate is applied
// in registers.  The epilogue writes audio = round(x + round(rs[:, :C] +
// b_rs)) and skip = round(rs[:, C:] + b_rs) 16 B a thread; in the last
// layer only skip.  What holds it: every tile streams ~1 MB of weights
// (W_in and W_rs) from L2 into its SM, ~0.63 GB a launch at the serving
// shape, against 0.10 GB of its own traffic.
//
// f32 at C = 256 (wn_layer_f32), the synthesis CLI's default path (96
// launches a dense batch): the f32 SIMT tile of wn_simt.cuh, shared with
// the flow kernel.  At the CLI's shape (B = 8, T = 20000) the layer does
// 168 GFLOP (2.50 ms at 67 TFLOP/s f32) against 0.82 GB (0.25 ms at 3.35
// TB/s): the FMA rate bounds it.  One persistent block of 8 warps per SM
// walks the tiles; each tile runs both GEMMs in one pass over all 2C
// columns, 128 f32 accumulators a thread, fed by a 2-stage ring (weights
// by cp.async, x through registers into K-major slices) that runs on
// across the tiles, the gate in registers, and writes audio and skip 16 B
// a thread; the last layer is a template parameter.  Every tile streams
// ~2.1 MB of f32 weights from L2 (5.2 GB a launch at the CLI's shape); on
// an H100 it runs at ~62 % of the FMA bound, held by the instruction
// stream around its accumulators, not by L2 (wn_simt.cuh).
//
// f32 at other widths (wn_layer_f32_tile) and bf16 at other widths
// (wn_layer_bf16_tile), C % 128 == 0: the tile code of wn_tile.cuh, one
// block per (batch, 64-row) tile.

#include "wn_simt.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
wn_layer_tile_kernel(const T* __restrict__ x, const T* __restrict__ cond, long long cond_sb,
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
int launch_tile(const void* x, const void* cond, long long cond_sb, long long cond_st,
                const void* w_in, const void* b_in, const void* w_rs, const void* b_rs,
                void* audio, void* skip, int B, int t_len, int C, int R, int d, int last,
                void* stream) {
  const size_t smem = smem_bytes<T>(C);
  cudaError_t err = cudaFuncSetAttribute(wn_layer_tile_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + TT - 1) / TT, B);
  wn_layer_tile_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(cond), cond_sb, cond_st,
      static_cast<const T*>(w_in), static_cast<const T*>(b_in), static_cast<const T*>(w_rs),
      static_cast<const T*>(b_rs), static_cast<T*>(audio), static_cast<T*>(skip), t_len, C,
      R, d, last);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 at C = 256: the wgmma tile of wn_wgmma.cuh

namespace wg {

struct LayerArgs {
  const bf16* x;                     // (B, T, C)
  const bf16* cond;                  // (B, T, 2C), unit channel stride
  long long cond_sb, cond_st;        // its batch and time strides
  const bf16* in_img;                // (3C/KC, 2C, KC): weight_image of W_in
  const bf16* b_in;                  // (2C)
  const bf16* rs_img;                // (C/KC, 2C, KC): of W_rs, last layer's skip in [C, 2C)
  const bf16* b_rs;                  // (2C), or (C) in the last layer
  bf16* audio;                       // (B, T, C), not written in the last layer
  bf16* skip;                        // (B, T, C)
  int B, t_len, d;
};

// layer_tile's epilogue here: residual columns audio = round(x + rs), skip
// columns skip = rs.  Rows are (b * T + t), C bf16 wide.
struct LayerEpi {
  const bf16* x;
  bf16* audio;
  bf16* skip;
  __device__ bool adds(int n) const { return n < WC; }
  __device__ const bf16* src(size_t row, int n) const { return x + row * WC + n; }
  __device__ bf16* dst(size_t row, int n) const {
    return n < WC ? audio + row * WC + n : skip + row * WC + n - WC;
  }
};

// kLast: the last layer (skip-only W_rs); a template parameter, so that
// each form drops the other's branches in GEMM 2 and the epilogue
template <bool kLast>
__global__ void __launch_bounds__(THREADS, 1) wn_layer_bf16_kernel(const LayerArgs a) {
  extern __shared__ __align__(1024) unsigned char dsmem[];
  const uint32_t raw = smem_u32(dsmem), ring = (raw + 1023) & ~1023u;
  const uint32_t tile_s = ring + S * STAGE;
  unsigned char* const tile_p = dsmem + (tile_s - raw);
  const int n_t = (a.t_len + TT - 1) / TT, n_tiles = a.B * n_t;
  const size_t plane = static_cast<size_t>(a.t_len) * WC;
  const int n_mine = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int steps = n_mine * STEPS;

  auto issue = [&](int g) {
    if (g < steps) {
      const int tile = blockIdx.x + (g / STEPS) * gridDim.x, b = tile / n_t;
      issue_step(ring + (g % S) * STAGE, g % STEPS, a.x + b * plane, a.t_len, (tile % n_t) * TT,
                 a.d, a.in_img, a.rs_img, kLast, a.cond + b * a.cond_sb, a.cond_st, tile_s);
    }
    cp_async_commit();
  };
  for (int g = 0; g < AHEAD; ++g) issue(g);

  const LayerEpi epi{a.x, a.audio, a.skip};
  CopyRing<decltype(issue)> cr{ring, issue};
  float acc[2][64];
  int g = 0;
  for (int i = 0; i < n_mine; ++i) {
    const int tile = blockIdx.x + i * gridDim.x, b = tile / n_t;
    layer_tile(acc, tile_s, tile_p, g, cr, a.b_in, a.b_rs, kLast ? WC : 0, kLast,
               (tile % n_t) * TT, a.t_len, static_cast<size_t>(b) * a.t_len, epi);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32 at C = 256: the SIMT tile of wn_simt.cuh

namespace simt {

struct LayerArgs {
  const float* x;                    // (B, T, C)
  const float* cond;                 // (B, T, 2C), unit channel stride
  long long cond_sb, cond_st;        // its batch and time strides
  const float* w_in;                 // (3C, 2C) tap-stacked
  const float* b_in;                 // (2C)
  const float* w_rs;                 // (C, 2C), or (C, C) in the last layer
  const float* b_rs;                 // (2C), or (C) in the last layer
  float* audio;                      // (B, T, C), not written in the last layer
  float* skip;                       // (B, T, C)
  int B, t_len, d;
};

// layer_tile's epilogue here: residual columns audio = x + rs, skip
// columns skip = rs.  Rows are (b * T + t), C floats wide.
struct LayerEpi {
  const float* x;
  float* audio;
  float* skip;
  __device__ bool adds(int n) const { return n < WC; }
  __device__ float4 old(size_t row, int n) const {
    return __ldg(reinterpret_cast<const float4*>(x + row * WC + n));
  }
  __device__ float* dst(size_t row, int n) const {
    return n < WC ? audio + row * WC + n : skip + row * WC + n - WC;
  }
};

// kLast: the last layer (skip-only W_rs (C, C))
template <bool kLast>
__global__ void __launch_bounds__(THREADS, 1) wn_layer_f32_kernel(const LayerArgs a) {
  extern __shared__ __align__(16) float smem_f[];
  float* const ring = smem_f;
  float* const acts = smem_f + S * STAGE;
  const int n_t = (a.t_len + TT - 1) / TT, n_tiles = a.B * n_t;
  const int n_mine = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  Feed<kLast> feed{ring, a.x, a.w_in, a.w_rs, kLast ? WC : NW, n_mine * STEPS, n_t, a.t_len,
                   0, a.d};
  feed.start();

  const LayerEpi epi{a.x, a.audio, a.skip};
  float acc[2][8][8];
  int g = 0;
  for (int i = 0; i < n_mine; ++i) {
    const int tile = blockIdx.x + i * gridDim.x, b = tile / n_t;
    layer_tile<kLast>(acc, ring, acts, g, feed, a.b_in, a.cond + b * a.cond_sb, a.cond_st,
                      a.b_rs, kLast ? WC : 0, (tile % n_t) * TT, a.t_len,
                      static_cast<size_t>(b) * a.t_len, epi);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace simt

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns the first CUDA error
// of the launch (0 on success).  Shapes: x, audio, skip (B, T, C)
// contiguous; cond (B, T, 2C) with unit channel stride and the given batch /
// time strides; biases in x's type, b_in (2C), b_rs (R); R = C in the last
// layer, else 2C.
//
// f32 (wn_layer_f32_tile) and bf16 (wn_layer_bf16_tile) at any width, on
// wn_tile.cuh's tile: w_in (3C, 2C), w_rs (C, R) row-major; C % 128 == 0.
#define WN_LAYER_TILE_ENTRY(NAME, TYPE)                                                     \
  extern "C" int NAME(const void* x, const void* cond, long long cond_sb, long long cond_st, \
                      const void* w_in, const void* b_in, const void* w_rs, const void* b_rs, \
                      void* audio, void* skip, int B, int t_len, int C, int R, int d,       \
                      int last, void* stream) {                                             \
    return launch_tile<TYPE>(x, cond, cond_sb, cond_st, w_in, b_in, w_rs, b_rs, audio, skip, \
                             B, t_len, C, R, d, last, stream);                              \
  }

WN_LAYER_TILE_ENTRY(wn_layer_f32_tile, float)
WN_LAYER_TILE_ENTRY(wn_layer_bf16_tile, __nv_bfloat16)

// bf16 on the wgmma tile: C == 256; in_img (3C/32, 2C, 32) and rs_img
// (C/32, 2C, 32) are ops/wn_image.py::weight_image's for one layer (the
// last layer's (C, C) W_rs in the skip columns [C, 2C)); cond 16-byte
// aligned with strides a multiple of 8.  A persistent (not cooperative)
// launch of as many blocks as are resident at once, at most one per
// tile; each block walks its tiles.
extern "C" int wn_layer_bf16(const void* x, const void* cond, long long cond_sb,
                             long long cond_st, const void* in_img, const void* b_in,
                             const void* rs_img, const void* b_rs, void* audio, void* skip,
                             int B, int t_len, int C, int R, int d, int last, void* stream) {
  if (C != wg::WC || R != (last ? C : 2 * C) || (cond_sb | cond_st) % 8 ||
      reinterpret_cast<uintptr_t>(cond) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(wg::LayerArgs) =
      last ? wg::wn_layer_bf16_kernel<true> : wg::wn_layer_bf16_kernel<false>;
  int blocks = 0;
  const int err = persistent_grid(kernel, wg::BLOCK_SMEM, B * ((t_len + TT - 1) / TT), &blocks);
  if (err != 0) return err;
  wg::LayerArgs a;
  a.x = static_cast<const bf16*>(x);
  a.cond = static_cast<const bf16*>(cond);
  a.cond_sb = cond_sb;
  a.cond_st = cond_st;
  a.in_img = static_cast<const bf16*>(in_img);
  a.b_in = static_cast<const bf16*>(b_in);
  a.rs_img = static_cast<const bf16*>(rs_img);
  a.b_rs = static_cast<const bf16*>(b_rs);
  a.audio = static_cast<bf16*>(audio);
  a.skip = static_cast<bf16*>(skip);
  a.B = B;
  a.t_len = t_len;
  a.d = d;
  kernel<<<blocks, THREADS, wg::BLOCK_SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 wgmma kernel's blocks per SM and dynamic shared memory (its
// form for the layers before the last).
extern "C" int wn_layer_bf16_occupancy(int* per_sm, int* smem) {
  *smem = wg::BLOCK_SMEM;
  return blocks_per_sm(wg::wn_layer_bf16_kernel<false>, *smem, per_sm);
}

// f32 on the SIMT tile: C == 256; w_in (3C, 2C), w_rs (C, R) row-major;
// cond 16-byte aligned with strides a multiple of 4.  A persistent (not
// cooperative) launch of as many blocks as are resident at once, at most
// one per tile; each block walks its tiles.
extern "C" int wn_layer_f32(const void* x, const void* cond, long long cond_sb,
                            long long cond_st, const void* w_in, const void* b_in,
                            const void* w_rs, const void* b_rs, void* audio, void* skip, int B,
                            int t_len, int C, int R, int d, int last, void* stream) {
  if (C != simt::WC || R != (last ? C : 2 * C) || (cond_sb | cond_st) % 4 ||
      reinterpret_cast<uintptr_t>(cond) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(simt::LayerArgs) =
      last ? simt::wn_layer_f32_kernel<true> : simt::wn_layer_f32_kernel<false>;
  int blocks = 0;
  const int err =
      persistent_grid(kernel, simt::BLOCK_SMEM, B * ((t_len + TT - 1) / TT), &blocks);
  if (err != 0) return err;
  simt::LayerArgs a;
  a.x = static_cast<const float*>(x);
  a.cond = static_cast<const float*>(cond);
  a.cond_sb = cond_sb;
  a.cond_st = cond_st;
  a.w_in = static_cast<const float*>(w_in);
  a.b_in = static_cast<const float*>(b_in);
  a.w_rs = static_cast<const float*>(w_rs);
  a.b_rs = static_cast<const float*>(b_rs);
  a.audio = static_cast<float*>(audio);
  a.skip = static_cast<float*>(skip);
  a.B = B;
  a.t_len = t_len;
  a.d = d;
  kernel<<<blocks, THREADS, simt::BLOCK_SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The f32 SIMT kernel's blocks per SM and dynamic shared memory (its form
// for the layers before the last).
extern "C" int wn_layer_f32_occupancy(int* per_sm, int* smem) {
  *smem = simt::BLOCK_SMEM;
  return blocks_per_sm(simt::wn_layer_f32_kernel<false>, *smem, per_sm);
}
