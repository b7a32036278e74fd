// Fused all-gather + GEMM for Hopper (sm_90a), the paper's §4.1 push
// model: C = concat_K(A_0, ..., A_{W-1}) @ B on every rank, where rank r
// holds A_r (M, K/W) and a replica of B (K, N).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ag_gemm.py
// (`_ag_gemm_kernel` / `ag_gemm_fused`), which forwards each shard around
// a ring of neighbour-to-neighbour remote DMAs (ICI is a torus) into a
// per-source VMEM inbox and multiplies the shard of ring step t while
// the next one is in flight. NVLink connects every card to every other
// (hopper guide §1), so this kernel follows the paper's direct push
// instead (Algorithm 2's Inbox_d(r)):
//   * the first PUSHERS blocks of rank r copy A_r into slot r of every
//     other rank's inbox and publish one flag per (pusher, receiver)
//     (symm.cuh: epoch flags, double-buffered inboxes);
//   * every block owns 32-column strips of C (persistent over the
//     strips) and walks the sources starting at its own shard,
//     s = (r - t) mod W, so compute starts at once on local data; before
//     the first use of a source it waits on that source's PUSHERS flags,
//     then accumulates A_s @ B[s*k:(s+1)*k, strip] in fp32 registers.
//     The gathered A never exists in device memory outside the inbox.
// One cooperative launch per device spans its local ranks, so pushers
// and consumers are co-resident (no deadlock with virtual ranks).
// It takes any M, N and K/W: ragged edges are masked (16-byte cp.async
// copies when N and K/W are multiples of 16 bytes, masked scalar loads
// otherwise). The Pallas wrapper's refusal of N without a divisor >= 16
// is a TPU tiling rule and does not apply.
//
// What bounds it on the H100: at decode M (the batch) every B byte is
// used for M multiply-adds, far below the ~295 flop/byte ridge, so the
// floor is B's bytes (K * N * sizeof(T)) over 3.35 TB/s plus the shards
// pushed (W * M * K/W * sizeof(T) per rank). The strip loop is the
// streaming skinny-M GEMM (csrc/matmul.cu mm_stream): a 3-stage cp.async
// ring of 8 KB B tiles per block, lanes split K, a warp-shuffle
// reduction at the end. With W virtual ranks on one card every rank
// reads B: W times the bytes, partly served from the 50 MB L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

#include "symm.cuh"

namespace {

constexpr int NT = 256;           // threads: 8 warps x 4 columns = 32
constexpr int SN = 32;            // columns of C in a strip
constexpr int SSTAGES = 3;        // cp.async ring depth
constexpr int PUSHERS = 4;        // blocks per rank that push the shard

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
  return __float2bfloat16(x);
}
// loads that bypass L1: inbox bytes are written by other SMs or cards
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ld_cg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

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
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);                // per 16 B copy
  static constexpr int BK = 8192 / (SN * (int)sizeof(T));   // 8 KB B tile
  static constexpr int BROW = SN + VEC;   // +16 B per row spreads banks
  static constexpr int KPL = BK / 32;     // K rows per lane per tile
};

// Stage tile kt of one source: A_s (M x kr, row-major) rows m0.., and
// B_s (kr x N, row-major: the source's row block of B) columns n0..
template <typename T, int MT, bool VEC>
__device__ __forceinline__ void issue(const T* __restrict__ A,
                                      const T* __restrict__ B, int M, int N,
                                      int kr, int m0, int n0, int kt,
                                      T (*Bs)[Tile<T>::BROW],
                                      T (*As)[Tile<T>::BK]) {
  using S = Tile<T>;
  const int k0 = kt * S::BK;
  if constexpr (VEC) {
    constexpr int BCPR = SN / S::VEC;       // 16 B copies per B row
    for (int c = threadIdx.x; c < S::BK * BCPR; c += NT) {
      const int r = c / BCPR, n = n0 + (c % BCPR) * S::VEC, k = k0 + r;
      const bool ok = k < kr && n < N;
      cp_async16(&Bs[r][(c % BCPR) * S::VEC],
                 ok ? B + (size_t)k * N + n : B, ok);
    }
    constexpr int ACPR = S::BK / S::VEC;    // 16 B copies per A row
    for (int c = threadIdx.x; c < MT * ACPR; c += NT) {
      const int r = c / ACPR, k = k0 + (c % ACPR) * S::VEC, m = m0 + r;
      const bool ok = m < M && k < kr;
      cp_async16(&As[r][(c % ACPR) * S::VEC],
                 ok ? A + (size_t)m * kr + k : A, ok);
    }
  } else {
    for (int c = threadIdx.x; c < S::BK * SN; c += NT) {
      const int r = c / SN, n = n0 + c % SN, k = k0 + r;
      Bs[r][c % SN] = (k < kr && n < N) ? B[(size_t)k * N + n]
                                        : from_f<T>(0.f);
    }
    for (int c = threadIdx.x; c < MT * S::BK; c += NT) {
      const int r = c / S::BK, k = k0 + c % S::BK, m = m0 + r;
      As[r][c % S::BK] = (m < M && k < kr) ? ld_cg(A + (size_t)m * kr + k)
                                           : from_f<T>(0.f);
    }
  }
}

// Cooperative grid (blocks per rank, n_local), NT threads.
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(NT)
ag_gemm_kernel(symm::Ptrs Ap, symm::Ptrs Bp, symm::Ptrs Cp, symm::Ranks R,
               symm::Peers P, int M, int N, int k) {
  using S = Tile<T>;
  __shared__ __align__(16) T Bs[SSTAGES][S::BK][S::BROW];
  __shared__ __align__(16) T As[SSTAGES][MT][S::BK];
  const int lr = blockIdx.y, rank = R.r[lr], W = P.W;
  const T* a_own = static_cast<const T*>(Ap.p[lr]);
  const T* B = static_cast<const T*>(Bp.p[lr]);
  T* C = static_cast<T*>(const_cast<void*>(Cp.p[lr]));

  // ---- push this rank's shard into slot `rank` of every other inbox
  if (blockIdx.x < PUSHERS) {
    const size_t n = (size_t)M * k;
    if constexpr (VEC) {                   // n is a multiple of VEC
      const size_t nv = n / S::VEC;
      const size_t per = (nv + PUSHERS - 1) / PUSHERS;
      const size_t lo = blockIdx.x * per, hi = lo + per < nv ? lo + per : nv;
      const uint4* src = reinterpret_cast<const uint4*>(a_own);
      for (int dst = 0; dst < W; ++dst) {
        if (dst == rank) continue;
        uint4* d = reinterpret_cast<uint4*>(P.slot(dst, rank));
        for (size_t i = lo + threadIdx.x; i < hi; i += NT) d[i] = src[i];
      }
    } else {
      const size_t per = (n + PUSHERS - 1) / PUSHERS;
      const size_t lo = blockIdx.x * per, hi = lo + per < n ? lo + per : n;
      for (int dst = 0; dst < W; ++dst) {
        if (dst == rank) continue;
        T* d = reinterpret_cast<T*>(P.slot(dst, rank));
        for (size_t i = lo + threadIdx.x; i < hi; i += NT) d[i] = a_own[i];
      }
    }
    symm::publish(P, rank, blockIdx.x);
  }

  // ---- C strips: sources from our own shard on, each waited on once
  const int lane = threadIdx.x % 32;        // which K rows of a tile
  const int cg = threadIdx.x / 32;          // columns n0 + 4cg .. 4cg+3
  const int nk = (k + S::BK - 1) / S::BK;
  const int n_strips = (N + SN - 1) / SN;
  unsigned ready = 1u << rank;              // sources whose flags are seen
  for (int strip = blockIdx.x; strip < n_strips; strip += gridDim.x) {
    const int n0 = strip * SN;
    for (int m0 = 0; m0 < M; m0 += MT) {
      float acc[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
      for (int t = 0; t < W; ++t) {
        const int s = (rank - t + W) % W;
        if (!((ready >> s) & 1u)) {
          if (threadIdx.x < PUSHERS) symm::wait(P, rank, s, threadIdx.x);
          __threadfence();
          __syncthreads();
          ready |= 1u << s;
        }
        const T* A = s == rank ? a_own
                               : reinterpret_cast<const T*>(P.slot(rank, s));
        const T* Bsrc = B + (size_t)s * k * N;
#pragma unroll
        for (int st = 0; st < SSTAGES - 1; ++st) {
          if (st < nk)
            issue<T, MT, VEC>(A, Bsrc, M, N, k, m0, n0, st, Bs[st], As[st]);
          cp_async_commit();
        }
        for (int kt = 0; kt < nk; ++kt) {
          cp_async_wait<SSTAGES - 2>();     // tile kt has landed
          __syncthreads();                  // ...for every thread; and
          const int nt = kt + SSTAGES - 1;  // tile kt-1's stage is free
          if (nt < nk)
            issue<T, MT, VEC>(A, Bsrc, M, N, k, m0, n0, nt,
                              Bs[nt % SSTAGES], As[nt % SSTAGES]);
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
        __syncthreads();                    // stages free for the next source
      }
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
}

template <typename T, int MT, bool VEC>
int launch(const symm::Ptrs& A, const symm::Ptrs& B, const symm::Ptrs& C,
           const symm::Ranks& R, int n_local, const symm::Peers& P, int M,
           int N, int k, cudaStream_t stream) {
  const void* fn = (const void*)ag_gemm_kernel<T, MT, VEC>;
  int cap = 0;
  const int e = symm::coop_capacity(fn, NT, 0, &cap);
  if (e != 0) return e;
  const int per_rank = cap / n_local;
  if (per_rank < PUSHERS) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int n_strips = (N + SN - 1) / SN;
  const int grid_x = std::max(PUSHERS, std::min(n_strips, per_rank));
  symm::Ptrs a = A, b = B, c = C;
  symm::Ranks r = R;
  symm::Peers p = P;
  int m = M, n = N, kk = k;
  void* args[] = {(void*)&a, (void*)&b, (void*)&c, (void*)&r,
                  (void*)&p, (void*)&m, (void*)&n, (void*)&kk};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(grid_x, n_local),
                                          dim3(NT), args, 0, stream);
}

template <typename T, bool VEC>
int by_m(const symm::Ptrs& A, const symm::Ptrs& B, const symm::Ptrs& C,
         const symm::Ranks& R, int n_local, const symm::Peers& P, int M,
         int N, int k, cudaStream_t s) {
  if (M <= 1) return launch<T, 1, VEC>(A, B, C, R, n_local, P, M, N, k, s);
  if (M <= 2) return launch<T, 2, VEC>(A, B, C, R, n_local, P, M, N, k, s);
  if (M <= 4) return launch<T, 4, VEC>(A, B, C, R, n_local, P, M, N, k, s);
  if (M <= 8) return launch<T, 8, VEC>(A, B, C, R, n_local, P, M, N, k, s);
  return launch<T, 16, VEC>(A, B, C, R, n_local, P, M, N, k, s);
}

template <typename T>
int by_vec(const symm::Ptrs& A, const symm::Ptrs& B, const symm::Ptrs& C,
           const symm::Ranks& R, int n_local, const symm::Peers& P, int M,
           int N, int k, cudaStream_t s) {
  constexpr int VEC = Tile<T>::VEC;
  bool vec = N % VEC == 0 && k % VEC == 0 && P.slot_bytes % 16 == 0;
  for (int i = 0; i < n_local; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(A.p[i]) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(B.p[i]) % 16 == 0;
  return vec ? by_m<T, true>(A, B, C, R, n_local, P, M, N, k, s)
             : by_m<T, false>(A, B, C, R, n_local, P, M, N, k, s);
}

}  // namespace

// One cooperative launch on one device for its n_local ranks (ids
// ranks[]) of a W-rank mesh. Per local rank: a (M, k) its K shard, b
// (W * k, N) the replicated B, c (M, N) its output; all contiguous
// row-major, one dtype (0 = float32, 1 = bfloat16). The symmetric-buffer
// arguments as in fd_paged_launch (csrc/flash_decode_paged.cu); a slot
// holds M * k elements. Returns the launch's cudaError_t (0 = launched).
extern "C" int ag_gemm_launch(const void* const* a, const void* const* b,
                              void* const* c, const int* ranks, int n_local,
                              int M, int N, int k, int dtype,
                              const void* inbox_tab, const void* flag_tab,
                              int W, int n_chunk, unsigned epoch,
                              long long slot_bytes, long long half,
                              void* stream) {
  if (M <= 0 || N <= 0 || k <= 0 || n_local <= 0 ||
      n_local > symm::MAX_RANKS || W < n_local || W > 32 ||
      n_chunk < PUSHERS)
    return (int)cudaErrorInvalidValue;
  symm::Ptrs A, B, C;
  symm::Ranks R;
  for (int i = 0; i < n_local; ++i) {
    A.p[i] = a[i];
    B.p[i] = b[i];
    C.p[i] = c[i];
    R.r[i] = ranks[i];
  }
  const symm::Peers P = symm::make_peers(inbox_tab, flag_tab, W, n_chunk,
                                         epoch, slot_bytes, half);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_vec<float>(A, B, C, R, n_local, P, M, N, k, s);
  if (dtype == 1)
    return by_vec<__nv_bfloat16>(A, B, C, R, n_local, P, M, N, k, s);
  return (int)cudaErrorInvalidValue;
}
