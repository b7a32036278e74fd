// Pieces of the port's weight-streaming kernels (the GEMM, matmul.cu,
// and the fused AG+GEMM, ag_gemm.cu): element conversions, mbarriers,
// 2D and 3D TMA copies that complete on an mbarrier, 16-byte cp.async copies,
// and the tensor maps the TMA unit reads.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace stream {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// N consecutive T from shared memory into floats, in one load where the
// bytes make one.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float* f) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(t[j]);
  } else if constexpr (N * sizeof(T) == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(t[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(p[j]);
  }
}

// ---- mbarriers and bulk copies (PTX)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(b)),
               "r"(count)
               : "memory");
}
// after every mbar_init of a block, before any other thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(b))
               : "memory");
}
// Hands a ring stage back to its producer once this warp has read it:
// every lane orders its generic-proxy reads of the stage before the
// async-proxy (TMA) writes that refill it (fence.proxy.async; without
// it a refill on the H100 overwrote A rows a warp was still reading,
// once a consumer's arithmetic was scheduled past its arrive), then
// lane 0 arrives on the stage's `empty` barrier for the warp.
__device__ __forceinline__ void release_stage(uint64_t* empty) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(empty);
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(b)),
      "r"(parity)
      : "memory");
}
// One TMA copy of the box at element x (inner dimension), row y of a
// tensor map into shared memory; completes on `bar` (out-of-bounds parts
// are zeros, and count towards the box's bytes).
__device__ __forceinline__ void tma_load_2d(void* smem, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(smem)),
      "l"(map), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}
// The same for a 3D tensor map: element x, row y of matrix z.
__device__ __forceinline__ void tma_load_3d(void* smem, const CUtensorMap* map,
                                            int x, int y, int z,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(smem)),
      "l"(map), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}
// 16-byte copy global -> shared (0 source bytes: the 16 bytes are zeroed)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
// `b` counts one more pending arrival now and receives it when this
// thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(b))
               : "memory");
}
// the consumer warps' own barrier (id 1; the producer warp keeps
// streaming): `threads` is the consumers' thread count
template <int THREADS>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// ---- tensor maps (host)
// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A tensor map of `rank` (2 or 3) dims over float32 (dtype 0) or
// bfloat16 (dtype 1): dims innermost first, strides in bytes of dims 1..,
// boxes of `box` elements. Returns a cudaError_t (0 = encoded).
inline int encode_tiled(CUtensorMap* map, const void* p, int dtype, int rank,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      (cuuint32_t)rank, const_cast<void*>(p), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A row-major (rows x cols) matrix with `ld` elements between rows, as a
// 2D tensor map with (box_rows x box_cols) boxes.
inline int encode_2d(CUtensorMap* map, const void* p, int dtype,
                     long long rows, long long cols, long long ld,
                     int box_cols, int box_rows,
                     CUtensorMapSwizzle swizzle) {
  const cuuint64_t esz = dtype == 0 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * esz};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return encode_tiled(map, p, dtype, 2, dims, strides, box, swizzle);
}

// `mats` such matrices one after another (rows * ld elements apart), as
// a 3D tensor map whose boxes are (box_rows x box_cols) of one matrix:
// a box never reaches into the next matrix (its rows past `rows` are
// zeros, as past the end of a 2D map).
inline int encode_3d(CUtensorMap* map, const void* p, int dtype,
                     long long mats, long long rows, long long cols,
                     long long ld, int box_cols, int box_rows,
                     CUtensorMapSwizzle swizzle) {
  const cuuint64_t esz = dtype == 0 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * esz,
                                 (cuuint64_t)(rows * ld) * esz};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  return encode_tiled(map, p, dtype, 3, dims, strides, box, swizzle);
}

}  // namespace stream
