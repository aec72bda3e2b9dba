// The vocoder's int8 cond projection as one kernel for Hopper (sm_90a):
//
//   out[m, n] = round_to_out( ((float(sum_k codes[m, k] * wq[n, k]) * s[m]) * w_scale[n]) + bias[n] )
//
// codes (M, K) int8, the grouped spect's per-column (or per-tensor) codes,
// channels-last: M = B*G rows, K = n_mel*n_group; wq (N, K) int8, the
// stacked cond weights of a flow's L layers (N = L*2C, or a rank's rows
// under tensor parallelism) with per-row scales w_scale and an f32 bias;
// s[m * s_stride] the row's scale (s_stride 0: one per tensor).  out
// (M, N) bf16 or f32, channels-last: the (B, G, L*2C) cond the WN flow
// kernel reads.
//
// It replaces no TPU kernel.  The JAX package computes this product with
// XLA (fac_via_ppg_tpu/models/waveglow.py:451, `_cond_all`: an int32
// einsum, then the f32 dequant), and the port ran it as torch._int_mm
// (sm80's WMMA kernel) followed by four f32 passes over (M, N) (the
// int32 -> f32 copy, the two scale products, the bias add) and the cast:
// an int32 and an f32 intermediate of M*N*4 bytes each in device memory.
// Here the int32 sums stay in registers and only the rounded output is
// written.
//
// The arithmetic is the old chain's, bit for bit: the exact int32 sum,
// converted to f32 round-to-nearest, then two products and an add, each
// rounded on its own (__fmul_rn / __fadd_rn: never contracted into an
// FMA), then one round-to-nearest-even to the output type.
//
// What bounds it on an H100: at the vocoder's mean batch (M = 307,200,
// K = 640, N = 4096) 2*M*K*N = 1.61 TOP, 0.81 ms at 1,979 TOP/s of int8,
// against a bf16 store of M*N*2 = 2.5 GB, 0.75 ms at 3.35 TB/s; the codes
// (0.2 GB) and weights (2.6 MB) are small.  About 640 operations per
// output byte against the card's ~590: as much store-bound as
// compute-bound, so one tile's stores have to overlap the next tile's
// products.  The design:
//   - Persistent blocks, one per SM: 3 warpgroups, a producer (one thread
//     issuing TMA loads) and two consumers.  A block owns one 256-column
//     band of N for its whole life: the consumers copy the band's weights
//     (256 x K, 160 KB at K = 640), its scales and its bias into shared
//     memory once, and they stay there.  Only the codes stream, 64 rows x
//     128 B a ring step (7 stages, TMA, full / empty mbarriers).
//   - Raster: block b takes band b % n_bands and row tiles b / n_bands,
//     + n_blocks / n_bands, ...: the blocks of all bands walk the rows
//     together, so a 64-row tile of codes is read from device memory once
//     and from L2 by the other bands.
//   - Each consumer warpgroup computes a whole 64 x 256 tile on wgmma
//     m64n256k32 (s8 x s8 -> s32, operands in 128 B-swizzled K-major
//     shared memory, 128 int32 sums a thread), then its epilogue.  The two
//     alternate (ping-pong): an mbarrier pair hands the tensor cores from
//     one warpgroup's mainloop to the other's, so one tile's epilogue runs
//     under the other tile's products.
//   - Epilogue: the dequant in registers, stored straight from them, 16 B
//     a thread, with no staging, fence or barrier.  For that the band's
//     weight rows sit in shared memory permuted within each 32-row group
//     (row 8u + 2q + e holds weight row 8q + 2u + e), so that the
//     accumulator columns a thread of quad lane q holds in a group are 8
//     adjacent output columns, 32g + 8q ..: a warp's store writes 8 rows x
//     64 contiguous bytes.  TMA zero-fills the ragged last row tile's
//     loads and its rows past M are not stored: nothing is padded.
// Takes K % 16 == 0 (TMA's row pitch), K <= 640 (the resident weight band
// in shared memory), N % 8 == 0 (16-byte stores of 8 columns); any M.
//
// Built by nvcc for sm_90a at first use (ops/cuda_lib.py); the CUDA driver's
// cuTensorMapEncodeTiled is reached through the runtime's driver entry
// point, so nothing links the driver library.  ops/cond_int8.py holds the
// wrapper and the plain version.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;               // rows of one warpgroup's tile (wgmma's M)
constexpr int BN = 256;              // columns of a tile: one band, one wgmma N
constexpr int BK = 128;              // K bytes of a ring step and a weight block (one 128 B swizzle row)
constexpr int S = 7;                 // ring stages
constexpr int MAX_KB = 5;            // K <= MAX_KB * BK
constexpr int THREADS = 384;         // producer warpgroup + 2 consumer warpgroups
constexpr int A_STAGE = BM * BK;     // 8 KB of codes a ring step
constexpr int B_BLOCK = BN * BK;     // 32 KB of the band's weights per 128 K
constexpr int RING_BYTES = S * A_STAGE;
constexpr int WB_BYTES = 2 * BN * 4;       // the band's w_scale, then its bias (f32)
constexpr int BAR_BYTES = 8 * (2 * S + 2);  // full[S], empty[S], order[2]
constexpr uint64_t SW128 = 1;        // wgmma descriptor: 128 B swizzle

// dynamic shared memory of a launch with kb weight blocks (+ 1 KB alignment slack)
constexpr int smem_bytes(int kb) { return 1024 + RING_BYTES + kb * B_BLOCK + WB_BYTES + BAR_BYTES; }
static_assert(smem_bytes(MAX_KB) <= 232448, "fits a block's shared memory");

// the 256 consumer threads (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128 B-swizzled K-major operand:
// start >> 4, LBO 1 (unused), SBO 1024 B (8 rows of 128 B) >> 4
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (SW128 << 62);
}

__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 256, s32) += A (64 x 32 s8) @ B (32 x 256 s8), both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// the weight row of band row a, within its 32-row group: rows 8u + 2q + e
// and 8q + 2u + e trade places
__device__ __forceinline__ int band_row(int a) {
  return (a & ~31) | (((a >> 1) & 3) << 3) | (((a >> 3) & 3) << 1) | (a & 1);
}

// 8 adjacent output values, 16 B aligned
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
    cond_int8_kernel(__grid_constant__ const CUtensorMap map_a, const int8_t* __restrict__ wq,
                     const float* __restrict__ s, long long s_stride,
                     const float* __restrict__ w_scale, const float* __restrict__ bias,
                     OutT* __restrict__ out, int M, int N, int K, int kb_n) {
  extern __shared__ __align__(1024) unsigned char dsmem[];
  unsigned char* const base = dsmem + ((1024 - (smem_u32(dsmem) & 1023)) & 1023);
  const uint32_t ring = smem_u32(base), band_w = ring + RING_BYTES;
  float* const band_s = reinterpret_cast<float*>(base + RING_BYTES + kb_n * B_BLOCK);
  float* const band_b = band_s + BN;
  const uint32_t full = smem_u32(band_b + BN), empty = full + 8 * S,
                 order = empty + 8 * S;   // order + 8*c: consumer c's turn on the tensor cores

  const int n_bands = (N + BN - 1) / BN, m_tiles = (M + BM - 1) / BM;
  const int band = blockIdx.x % n_bands, lane0 = blockIdx.x / n_bands,
            lanes = gridDim.x / n_bands;
  const int n0 = band * BN;
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 1);
    }
    mbar_init(order, 1);
    mbar_init(order + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: the codes of every row tile of the block, through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (wt == 0) {
      int it = 0;
      for (int mt = lane0; mt < m_tiles; mt += lanes)
        for (int kb = 0; kb < kb_n; ++kb, ++it) {
          const int st = it % S;
          mbar_wait(empty + 8 * st, ((it / S) & 1) ^ 1);
          mbar_expect_tx(full + 8 * st, A_STAGE);
          tma_load_2d(ring + st * A_STAGE, &map_a, full + 8 * st, kb * BK, mt * BM);
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // the band, once: its weight rows permuted (band_row) into 128 B-swizzled
    // K-major blocks, zero past N and K; its scales and bias
    const int ct = threadIdx.x - 128;
    for (int v = ct; v < kb_n * BN * 8; v += 256) {
      const int kb = v / (BN * 8), a = (v / 8) % BN, ch = v % 8;
      const int n = n0 + band_row(a), k = kb * BK + ch * 16;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (n < N && k < K)
        x = __ldg(reinterpret_cast<const uint4*>(wq + static_cast<size_t>(n) * K + k));
      const uint32_t dst = band_w + kb * B_BLOCK + a * 128 + ((ch ^ (a & 7)) << 4);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(x.x), "r"(x.y),
                   "r"(x.z), "r"(x.w)
                   : "memory");
    }
    band_s[ct] = n0 + ct < N ? w_scale[n0 + ct] : 0.f;
    band_b[ct] = n0 + ct < N ? bias[n0 + ct] : 0.f;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    consumers_sync();

    // consumer c: the block's row tiles j = c, c + 2, ...
    const int c = wg - 1, q = wt % 4;
    const int r_lo = (wt / 32) * 16 + (wt % 32) / 4;  // this thread's rows r_lo, r_lo + 8 of a tile
    int acc[128];
    int t = 0;
    for (int j = c;; j += 2, ++t) {
      const int mt = lane0 + j * lanes;
      if (mt >= m_tiles) break;
      // the rows' scales, read now so that the loads land under the mainloop
      const long long row0 = static_cast<long long>(mt) * BM + r_lo;
      const float s0 = row0 < M ? __ldg(s + row0 * s_stride) : 0.f;
      const float s1 = row0 + 8 < M ? __ldg(s + (row0 + 8) * s_stride) : 0.f;
      // mainloop, in turn with the other consumer
      mbar_wait(order + 8 * c, (t & 1) ^ (c == 0 ? 1 : 0));
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0;
      int it = j * kb_n;
      for (int kb = 0; kb < kb_n; ++kb, ++it) {
        const int st = it % S;
        mbar_wait(full + 8 * st, (it / S) & 1);
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_m64n256k32(acc, gmma_desc(ring + st * A_STAGE + kk * 32),
                           gmma_desc(band_w + kb * B_BLOCK + kk * 32));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (kb > 0) {
          // the previous step's products are done: its stage goes back to the producer
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          fence_acc(acc);
          if (wt == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (wt == 0) {
        mbar_arrive(empty + 8 * ((it - 1) % S));
        mbar_arrive(order + 8 * (c ^ 1));
      }

      // epilogue: acc[4*j + 2*h + e] is row r_lo + 8h, band row 8j + 2q + e,
      // i.e. output column n0 + 32g + 8q + 2u + e for j = 4g + u.  First
      // every sum to f32 times its row's scale, in place (128 independent
      // chains, so the conversions stream), then per 8 columns * w_scale +
      // bias, rounded and stored.
#pragma unroll
      for (int i = 0; i < 128; ++i)
        acc[i] = __float_as_int(__fmul_rn(__int2float_rn(acc[i]), i & 2 ? s1 : s0));
#pragma unroll
      for (int g = 0; g < BN / 32; ++g) {
        if (n0 + 32 * g + 8 * q >= N) continue;
        const float4* const w4 = reinterpret_cast<const float4*>(band_s + 32 * g + 8 * q);
        const float4* const b4 = reinterpret_cast<const float4*>(band_b + 32 * g + 8 * q);
        const float4 wa = w4[0], wc = w4[1], ba = b4[0], bc = b4[1];
        const float w[8] = {wa.x, wa.y, wa.z, wa.w, wc.x, wc.y, wc.z, wc.w};
        const float b[8] = {ba.x, ba.y, ba.z, ba.w, bc.x, bc.y, bc.z, bc.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = row0 + 8 * h;
          if (row >= M) continue;
          float v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            v[k] = __fadd_rn(
                __fmul_rn(__int_as_float(acc[4 * (4 * g + k / 2) + 2 * h + (k & 1)]), w[k]),
                b[k]);
          store8(out + row * N + n0 + 32 * g + 8 * q, v);
        }
      }
    }
  }
}

template <typename OutT>
int launch(const void* codes, const void* wq, const float* s, long long s_stride,
           const float* w_scale, const float* bias, void* out, int M, int N, int K,
           cudaStream_t stream) {
  if (M <= 0 || K <= 0 || K % 16 || K > MAX_KB * BK || N <= 0 || N % 8)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const int kb_n = (K + BK - 1) / BK;
  CUtensorMap map_a;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {BK, BM}, elem[2] = {1, 1};
  const CUresult r = encode(
      &map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(codes), dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cond_int8_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(MAX_KB));
  if (err != cudaSuccess) return err;
  const int n_bands = (N + BN - 1) / BN, m_tiles = (M + BM - 1) / BM;
  int lanes = sms / n_bands;
  if (lanes < 1) lanes = 1;
  if (lanes > m_tiles) lanes = m_tiles;
  cond_int8_kernel<OutT><<<n_bands * lanes, THREADS, smem_bytes(kb_n), stream>>>(
      map_a, static_cast<const int8_t*>(wq), s, s_stride, w_scale, bias, static_cast<OutT*>(out),
      M, N, K, kb_n);
  return cudaGetLastError();
}

}  // namespace

// codes (M, K) int8, wq (N, K) int8, s (row scales at stride s_stride, 0
// for one scale), w_scale / bias (N,) f32 -> out (M, N) bf16, or f32 if
// out_f32; every array contiguous and 16 B aligned.  Returns a CUDA error
// code, or 10000 + a CUresult if a tensor map cannot be encoded.
extern "C" int cond_int8(const void* codes, const void* wq, const float* s, long long s_stride,
                         const float* w_scale, const float* bias, void* out, int M, int N, int K,
                         int out_f32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch<float>(codes, wq, s, s_stride, w_scale, bias, out, M, N, K, st)
                 : launch<bf16>(codes, wq, s, s_stride, w_scale, bias, out, M, N, K, st);
}

// (blocks per SM, dynamic shared memory bytes) of the bf16 kernel at K = 640
extern "C" int cond_int8_occupancy(int* per_sm, int* smem) {
  *smem = smem_bytes(MAX_KB);
  cudaError_t err = cudaFuncSetAttribute(
      cond_int8_kernel<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, cond_int8_kernel<bf16>, THREADS,
                                                       *smem);
}
