// GEMM for Hopper (sm_90a): C = A @ B with an fp32 accumulator.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul.py
// (`_mm_kernel` / `matmul`): (bm,bk)x(bk,bn) VMEM tiles with an fp32
// accumulator carried across the sequential K grid axis. On the GPU the
// K axis becomes a loop inside each block, and the shapes need not
// divide the tiles: ragged M, N and K edges are masked here, because
// decode runs it with M = batch.
//
// Layouts (row-major, contiguous): A (M, K); B (K, N) -- the JAX weight
// layout, N contiguous -- or, with trans_b, B given as (N, K) (the
// unembed's (vocab, d) table, read transposed without a copy); C (M, N).
// Types: bf16 x bf16 -> bf16 and f32 x f32 -> f32.
//
// What bounds it on the H100: decode has M <= batch, so every weight
// byte is used for only M multiply-adds -- far below the ~295 flop/byte
// ridge. The floor is the weight stream, (K*N*sizeof(B) + M*K + M*N) /
// 3.35 TB/s. Two kernels, both reading B exactly once per 16 rows of M
// (a block owns a column strip of C and loops over M tiles itself):
//
//  * mm_stream, the decode path (B in (K, N) layout, N and K multiples
//    of 16 bytes, 16-byte aligned operands): a block owns 32 columns and
//    streams its (K, 32) strip of B through a 3-stage cp.async ring of
//    8 KB tiles, so two tiles of loads are always in flight. Its 8 warps
//    each own 4 columns; the 32 lanes of a warp split the K rows of a
//    tile and keep (M_tile x 4) partial sums in registers, reduced by
//    warp shuffles at the end: every weight element is converted once
//    and used for exactly M_tile multiply-adds (M_tile is the batch
//    rounded up to a power of two, at most 16).
//  * mm_kernel, the general path (trans_b, or shapes/pointers the
//    16-byte copies cannot take): (32, 64) tiles of B through shared
//    memory with the next tile prefetched into registers.
//
// Still later work: split-K for the narrow projections (wk/wv, N = 1024,
// give mm_stream only 32 blocks for 132 SMs), a transposed streaming
// path for the fp32 unembed, and TMA/wgmma tiles for prefill-sized M.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 16;            // rows of C per M tile
constexpr int BN = 64;            // columns of C a block owns
constexpr int BK = 32;            // depth of one K slice
constexpr int NT = 256;           // threads: 16 rows x 16 column groups of 4
constexpr int BN_PAD = BN + 4;    // keeps float4 rows aligned, spreads banks
constexpr int B_PER_T = BK * BN / NT;   // 8 B elements per thread per slice
constexpr int A_PER_T = BM * BK / NT;   // 2 A elements per thread per slice

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

template <typename T, bool TRANS_B>
__device__ __forceinline__ void load_b(const T* __restrict__ B, int k0,
                                       int n0, int K, int N, float* regs) {
#pragma unroll
  for (int i = 0; i < B_PER_T; ++i) {
    const int idx = threadIdx.x + i * NT;
    int r, c;                    // r: k within the slice, c: n within BN
    if (TRANS_B) {               // (N, K): consecutive threads walk k
      r = idx % BK;
      c = idx / BK;
    } else {                     // (K, N): consecutive threads walk n
      r = idx / BN;
      c = idx % BN;
    }
    const int k = k0 + r, n = n0 + c;
    float v = 0.f;
    if (k < K && n < N)
      v = to_f(TRANS_B ? B[(size_t)n * K + k] : B[(size_t)k * N + n]);
    regs[i] = v;
  }
}

template <bool TRANS_B>
__device__ __forceinline__ void store_b(float (*Bs)[BN_PAD],
                                        const float* regs) {
#pragma unroll
  for (int i = 0; i < B_PER_T; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = TRANS_B ? idx % BK : idx / BN;
    const int c = TRANS_B ? idx / BK : idx % BN;
    Bs[r][c] = regs[i];
  }
}

template <typename T, bool TRANS_B>
__global__ void __launch_bounds__(NT)
mm_kernel(const T* __restrict__ A, const T* __restrict__ B,
          T* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float Bs[BK][BN_PAD];
  __shared__ float As[BM][BK + 1];

  const int n0 = blockIdx.x * BN;
  const int tm = threadIdx.x / 16;         // row of the M tile
  const int tn = threadIdx.x % 16;         // group of 4 columns
  const int nk = (K + BK - 1) / BK;

  for (int m0 = 0; m0 < M; m0 += BM) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float breg[B_PER_T];
    load_b<T, TRANS_B>(B, 0, n0, K, N, breg);
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * BK;
      __syncthreads();                     // previous slice fully consumed
      store_b<TRANS_B>(Bs, breg);
#pragma unroll
      for (int i = 0; i < A_PER_T; ++i) {
        const int idx = threadIdx.x + i * NT;
        const int r = idx / BK, c = idx % BK;
        const int m = m0 + r, k = k0 + c;
        As[r][c] = (m < M && k < K) ? to_f(A[(size_t)m * K + k]) : 0.f;
      }
      __syncthreads();
      if (kt + 1 < nk)                     // next slice's loads in flight
        load_b<T, TRANS_B>(B, k0 + BK, n0, K, N, breg);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float a = As[tm][kk];
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tn * 4]);
        acc[0] = fmaf(a, b.x, acc[0]);
        acc[1] = fmaf(a, b.y, acc[1]);
        acc[2] = fmaf(a, b.z, acc[2]);
        acc[3] = fmaf(a, b.w, acc[3]);
      }
    }
    const int m = m0 + tm;
    if (m < M) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tn * 4 + j;
        if (n < N) C[(size_t)m * N + n] = from_f<T>(acc[j]);
      }
    }
  }
}

// ----------------------------------------------------- mm_stream
constexpr int SN = 32;            // columns of C a block owns
constexpr int SSTAGES = 3;        // cp.async ring depth
constexpr int SMAX = 16;          // rows of C per M tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = lo.x; f[1] = lo.y; f[2] = hi.x; f[3] = hi.y;
}

template <typename T>
struct Stream {
  static constexpr int VEC = 16 / sizeof(T);                // per 16 B copy
  static constexpr int BK = 8192 / (SN * (int)sizeof(T));   // 8 KB B tile
  static constexpr int BROW = SN + VEC;   // +16 B per row spreads banks
  static constexpr int KPL = BK / 32;     // K rows per lane per tile
};

template <typename T, int MT>
__device__ __forceinline__ void stream_issue(
    const T* __restrict__ A, const T* __restrict__ B, int M, int N, int K,
    int m0, int n0, int kt, T (*Bs)[Stream<T>::BROW], T (*As)[Stream<T>::BK]) {
  using S = Stream<T>;
  const int k0 = kt * S::BK;
  constexpr int BCPR = SN / S::VEC;         // 16 B copies per B row
  for (int c = threadIdx.x; c < S::BK * BCPR; c += NT) {
    const int r = c / BCPR, n = n0 + (c % BCPR) * S::VEC, k = k0 + r;
    const bool ok = k < K && n < N;
    cp_async16(&Bs[r][(c % BCPR) * S::VEC], ok ? B + (size_t)k * N + n : B,
               ok);
  }
  constexpr int ACPR = S::BK / S::VEC;      // 16 B copies per A row
  for (int c = threadIdx.x; c < MT * ACPR; c += NT) {
    const int r = c / ACPR, k = k0 + (c % ACPR) * S::VEC, m = m0 + r;
    const bool ok = m < M && k < K;
    cp_async16(&As[r][(c % ACPR) * S::VEC], ok ? A + (size_t)m * K + k : A,
               ok);
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(NT)
mm_stream(const T* __restrict__ A, const T* __restrict__ B,
          T* __restrict__ C, int M, int N, int K) {
  using S = Stream<T>;
  __shared__ __align__(16) T Bs[SSTAGES][S::BK][S::BROW];
  __shared__ __align__(16) T As[SSTAGES][MT][S::BK];
  const int n0 = blockIdx.x * SN;
  const int lane = threadIdx.x % 32;        // which K rows of a tile
  const int cg = threadIdx.x / 32;          // columns n0 + 4cg .. 4cg+3
  const int nk = (K + S::BK - 1) / S::BK;

  for (int m0 = 0; m0 < M; m0 += MT) {
    float acc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
#pragma unroll
    for (int s = 0; s < SSTAGES - 1; ++s) {
      if (s < nk) stream_issue<T, MT>(A, B, M, N, K, m0, n0, s, Bs[s], As[s]);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<SSTAGES - 2>();         // tile kt has landed
      __syncthreads();                      // ...for every thread; and
      const int nt = kt + SSTAGES - 1;      // tile kt-1's stage is free
      if (nt < nk)
        stream_issue<T, MT>(A, B, M, N, K, m0, n0, nt, Bs[nt % SSTAGES],
                            As[nt % SSTAGES]);
      cp_async_commit();
      const int st = kt % SSTAGES;
#pragma unroll
      for (int i = 0; i < S::KPL; ++i) {
        const int kk = lane + 32 * i;
        float b[4];
        load4(&Bs[st][kk][cg * 4], b);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float a = to_f(As[st][m][kk]);
          acc[m][0] = fmaf(a, b[0], acc[m][0]);
          acc[m][1] = fmaf(a, b[1], acc[m][1]);
          acc[m][2] = fmaf(a, b[2], acc[m][2]);
          acc[m][3] = fmaf(a, b[3], acc[m][3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();                        // stages free for the next M tile
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[m][j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        const int n = n0 + cg * 4 + j;
        if (lane == ((m * 4 + j) & 31) && m0 + m < M && n < N)
          C[(size_t)(m0 + m) * N + n] = from_f<T>(v);
      }
    }
  }
}

template <typename T, int MT>
void launch_stream(const T* A, const T* B, T* C, int M, int N, int K,
                   cudaStream_t stream) {
  mm_stream<T, MT><<<(N + SN - 1) / SN, NT, 0, stream>>>(A, B, C, M, N, K);
}

template <typename T>
bool stream_ok(const void* a, const void* b, int N, int K, int trans_b) {
  constexpr int VEC = Stream<T>::VEC;
  return !trans_b && N % VEC == 0 && K % VEC == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <typename T>
void launch(const void* a, const void* b, void* c, int M, int N, int K,
            int trans_b, cudaStream_t stream) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  T* C = static_cast<T*>(c);
  if (stream_ok<T>(a, b, N, K, trans_b)) {
    if (M <= 1)
      launch_stream<T, 1>(A, B, C, M, N, K, stream);
    else if (M <= 2)
      launch_stream<T, 2>(A, B, C, M, N, K, stream);
    else if (M <= 4)
      launch_stream<T, 4>(A, B, C, M, N, K, stream);
    else if (M <= 8)
      launch_stream<T, 8>(A, B, C, M, N, K, stream);
    else
      launch_stream<T, SMAX>(A, B, C, M, N, K, stream);
    return;
  }
  const dim3 grid((N + BN - 1) / BN);
  if (trans_b)
    mm_kernel<T, true><<<grid, NT, 0, stream>>>(A, B, C, M, N, K);
  else
    mm_kernel<T, false><<<grid, NT, 0, stream>>>(A, B, C, M, N, K);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched). Launches on `stream`; never synchronises and
// allocates nothing.
extern "C" int mm_launch(const void* a, const void* b, void* c, int M,
                         int N, int K, int trans_b, int dtype,
                         void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(a, b, c, M, N, K, trans_b, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(a, b, c, M, N, K, trans_b, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
