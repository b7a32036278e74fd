// Fused all-gather + GEMM for Hopper (sm_90a), the paper's §4.1 push
// model: C = concat_K(A_0, ..., A_{W-1}) @ B on every rank, where rank r
// holds A_r (M, K/W) and a replica of B (K, N).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ag_gemm.py
// (`_ag_gemm_kernel` / `ag_gemm_fused`), which forwards each shard around
// a ring of neighbour-to-neighbour remote DMAs (ICI is a torus) into a
// per-source VMEM inbox and multiplies the shard of ring step t while
// the next one is in flight. NVLink connects every card to every other
// (hopper guide §1), so this kernel pushes directly instead (Algorithm
// 2's Inbox_d(r)), once per card:
//   * The gathered A is the same matrix for every rank, so a card needs
//     each shard once. Shards of ranks on this card are read in place;
//     the first PUSHERS blocks copy every local shard into slot `rank`
//     of the inbox of the first rank of every OTHER card and publish one
//     flag per (source, pusher) there (symm.cuh: epoch flags in device
//     memory, double-buffered inboxes). With every rank on one card
//     nothing is pushed.
//   * One product per card: when the card's ranks pass one B tensor (the
//     replicated weight), B is streamed once and each C tile is stored
//     into every local rank's output; ranks with distinct B tensors each
//     get their own product.
//
// What bounds it on the H100: at decode M (the batch) every B byte is
// used for M multiply-adds, far below the ~295 flop/byte ridge, so the
// floor is B's bytes (K * N * sizeof(T)) over 3.35 TB/s plus the shards
// pushed. The design is a B stream that keeps the card's HBM busy:
//   * A persistent cooperative grid of (product, 256-byte column strip,
//     K chunk) items over what the card holds at once; K is split into
//     chunks when strips are fewer than the blocks (N = 4096 in bf16 has
//     32 strips), so every SM streams (kernels/ag_gemm.py
//     `ag_gemm_plan`).
//   * A warp-specialised pipeline: one producer warp keeps a ring of
//     STAGES 16 KB B tiles in flight per block, each one 2D TMA copy
//     (cp.async.bulk.tensor, a tensor map of B) completing on an
//     mbarrier; A tiles follow as cp.async copies tracked by the same
//     barrier. The eight consumer warps multiply each tile by the
//     M x BK A tile in fp32 registers (a warp per row residue, a lane per
//     4 or 2 columns) and fold their sums through shared memory.
//   * The sources are summed in rank order 0..W-1 on every rank, yet the
//     overlap stays: B's tiles do not depend on A_s, so the producer
//     issues them before A_s's flags are seen; only the small A tile
//     waits for them.
//   * Deterministic sums: warps fold in warp order, and the last chunk
//     of a strip to finish sums the strip's partials in chunk order (a
//     per-strip arrival counter). The order depends only on the shapes
//     and the card's capacity, so outputs are bit-identical on every
//     rank and every card of one model.
//   * The epoch (symm.cuh) is taken at entry only when a source or a card
//     is elsewhere; with every rank on this card the producer takes it
//     after its last copy, off the critical path.
// It takes any M, N and K/W: with N and K/W multiples of 16 bytes and
// 16-byte aligned operands B and A move by TMA and 16-byte copies
// (VEC), otherwise as masked scalar loads. No wgmma: at M <= 8 the
// tensor cores would idle on a memory-bound stream.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "stream.cuh"
#include "symm.cuh"

namespace {

using stream::cp_async16;
using stream::cp_async_arrive;
using stream::from_f;
using stream::load_f;
using stream::mbar_arrive;
using stream::mbar_arrive_tx;
using stream::mbar_init;
using stream::mbar_wait;
using stream::tma_load_2d;
using stream::to_f;

constexpr int NCW = 8;                // consumer warps
constexpr int NT = 32 * (NCW + 1);    // + one producer warp
constexpr int BK = 64;                // B rows per stage (16 KB tiles)
constexpr int STAGES = 4;             // ring depth: 64 KB of B in flight
constexpr int PUSHERS = 4;            // blocks that push the shards

// loads that bypass L1: inbox bytes are written by other SMs or cards
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ld_cg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

template <typename T>
struct Tile {
  static constexpr int BN = 256 / (int)sizeof(T);   // 256-byte B rows
  static constexpr int CPL = BN / 32;               // columns per lane
  static constexpr int VEC = 16 / (int)sizeof(T);   // per 16-byte copy
};

// the consumer warps' own barrier (the producer warp keeps streaming)
__device__ __forceinline__ void consumers_sync() {
  stream::consumers_sync<NCW * 32>();
}

// B's tensor maps, one per product (VEC path), in the kernel's parameter
// space (__grid_constant__), where the TMA unit reads them.
struct alignas(64) Maps {
  CUtensorMap m[symm::MAX_RANKS];
};

struct Args {
  symm::Ptrs A, B, C;
  symm::Ranks R;
  int n_local;
  int n_prod;             // 1: the local ranks share B; else n_local
  int M, N, k, W;
  int n_kc;               // K chunks per strip
  unsigned leaders;       // bit mask: the first rank of every card
  float* work;            // (n_prod, n_strips, n_kc, M, BN) fp32 partials
  unsigned* cnt;          // (n_prod, n_strips) counters, left at 0
};

template <typename T, int MT>
struct Smem {
  static constexpr int BN = Tile<T>::BN;
  uint64_t* full;         // [STAGES]
  uint64_t* empty;        // [STAGES]
  T* bs;                  // [STAGES][BK][BN]
  T* as;                  // [STAGES][MT][BK]
  float* red;             // [NCW][MT][BN]: each consumer warp's sums
  void** tab;             // [64] the peers' inbox and flag bases
  int* misc;              // [4]

  static constexpr size_t bytes() {
    return 256 + sizeof(T) * STAGES * BK * BN + sizeof(T) * STAGES * MT * BK +
           sizeof(float) * NCW * MT * BN + sizeof(void*) * 64 + 16;
  }
  __device__ Smem(unsigned char* p) {
    full = reinterpret_cast<uint64_t*>(p);
    empty = full + STAGES;
    bs = reinterpret_cast<T*>(p + 256);
    as = bs + STAGES * BK * BN;
    red = reinterpret_cast<float*>(as + STAGES * MT * BK);
    tab = reinterpret_cast<void**>(red + NCW * MT * BN);
    misc = reinterpret_cast<int*>(tab + 64);
  }
};

// The persistent grid's work (kernels/ag_gemm.py ag_gemm_plan): item
// i = (product, 256-byte column strip, K chunk), chunk fastest; chunk kc
// of a strip is its K tiles [kc * tiles / n_kc, (kc + 1) * tiles / n_kc).
// Block b walks items b, b + gridDim.x, ...; for_each calls fn(prod,
// strip, kc, t0, t1) for each.
struct Items {
  int n_strips, tiles, n_kc, n_prod;
  template <class F>
  __device__ void for_each(F fn) const {
    for (int i = blockIdx.x; i < n_prod * n_strips * n_kc; i += gridDim.x) {
      const int kc = i % n_kc;
      fn(i / (n_strips * n_kc), i / n_kc % n_strips, kc,
         (int)((long long)kc * tiles / n_kc),
         (int)((long long)(kc + 1) * tiles / n_kc));
    }
  }
};

template <typename T, int MT, bool VEC>
__device__ void producer(const Maps& maps, const Args& a,
                         const Smem<T, MT>& S, const symm::Peers& P,
                         unsigned ready) {
  using Tl = Tile<T>;
  constexpr int BN = Tl::BN;
  const int lane = threadIdx.x % 32;
  const int n_strips = (a.N + BN - 1) / BN, nk = (a.k + BK - 1) / BK;
  const int tiles = a.W * nk;
  const int me = a.R.r[0];              // this card's inbox
  if constexpr (VEC) {                  // fetch the B maps' descriptors
    if (lane < a.n_prod)
      stream::prefetch_map(&maps.m[lane]);
  }
  // lane s holds source s's A: in place, or in this card's inbox
  const T* src_a = nullptr;
  if (lane < a.W) {
    int lr = -1;
    for (int i = 0; i < a.n_local; ++i)
      if (a.R.r[i] == lane) lr = i;
    src_a = lr >= 0 ? static_cast<const T*>(a.A.p[lr])
                    : reinterpret_cast<const T*>(P.slot(me, lane));
  }
  int cnt = 0;
  // B of global tile gt (source gt / nk) for columns n0.. into `slot`
  // (rows past the source's k belong to the next source or are zeros:
  // the consumers stop at the source's last row)
  auto issue_b = [&](int prod, int gt, int n0, int ncol, int slot) {
    const int s = gt / nk, kt = gt % nk;
    const int nrow = min(BK, a.k - kt * BK);
    const int row = s * a.k + kt * BK;
    T* dst = S.bs + (size_t)slot * BK * BN;
    if constexpr (VEC) {
      if (lane == 0) {
        mbar_arrive_tx(&S.full[slot], (unsigned)(BK * BN * sizeof(T)));
        tma_load_2d(dst, &maps.m[prod], n0, row, &S.full[slot]);
      }
    } else {
      const T* src = static_cast<const T*>(a.B.p[prod]) +
                     (size_t)row * a.N + n0;
      for (int i = lane; i < BK * BN; i += 32) {
        const int r = i / BN, c = i % BN;
        dst[i] = (r < nrow && c < ncol) ? src[(size_t)r * a.N + c]
                                        : from_f<T>(0.f);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&S.full[slot]);
    }
  };
  // A rows m0.. of global tile gt into `slot`; waits for a remote
  // source's flags first
  auto issue_a = [&](int gt, int m0, int slot) {
    const int s = gt / nk, kt = gt % nk, k0 = kt * BK;
    if (!((ready >> s) & 1u)) {
      if (lane < PUSHERS) symm::wait(P, me, s, lane);
      __syncwarp();
      __threadfence();
      ready |= 1u << s;
    }
    const T* A = reinterpret_cast<const T*>(__shfl_sync(
        0xffffffffu, reinterpret_cast<unsigned long long>(src_a), s));
    T* dst = S.as + (size_t)slot * MT * BK;
    if constexpr (VEC) {
      constexpr int CPR = BK / Tl::VEC;          // 16-byte copies per row
      for (int i = lane; i < MT * CPR; i += 32) {
        const int m = i / CPR, kk = (i % CPR) * Tl::VEC;
        const bool ok = m0 + m < a.M && k0 + kk < a.k;
        cp_async16(dst + m * BK + kk,
                   ok ? A + (size_t)(m0 + m) * a.k + k0 + kk : A, ok);
      }
      // the stage's barrier also waits for these copies
      cp_async_arrive(&S.full[slot]);
    } else {
      for (int i = lane; i < MT * BK; i += 32) {
        const int m = i / BK, kk = i % BK;
        dst[i] = (m0 + m < a.M && k0 + kk < a.k)
                     ? ld_cg(A + (size_t)(m0 + m) * a.k + k0 + kk)
                     : from_f<T>(0.f);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&S.full[slot]);
  };

  const Items items{n_strips, tiles, a.n_kc, a.n_prod};
  items.for_each([&](int prod, int strip, int, int g0, int g1) {
    const int n0 = strip * BN, ncol = min(BN, a.N - n0);
    for (int m0 = 0; m0 < a.M; m0 += MT) {
      const int c0 = cnt;
      int an = g0;                       // next tile that needs its A
      for (int gb = g0; gb < g1; ++gb) {
        const int slot = cnt % STAGES;
        mbar_wait(&S.empty[slot], ((cnt / STAGES) & 1) ^ 1);
        issue_b(prod, gb, n0, ncol, slot);
        ++cnt;
        // A tiles follow as their sources become ready; B runs ahead,
        // but never wraps onto a slot whose A is still missing
        while (an <= gb) {
          const bool wait_needed = !((ready >> (an / nk)) & 1u);
          if (wait_needed && gb - an + 1 < STAGES && gb + 1 < g1) break;
          issue_a(an, m0, (c0 + an - g0) % STAGES);
          ++an;
        }
      }
      for (; an < g1; ++an) issue_a(an, m0, (c0 + an - g0) % STAGES);
    }
  });
}

template <typename T, int MT, bool VEC>
__device__ void consumer(const Args& a, const Smem<T, MT>& S) {
  using Tl = Tile<T>;
  constexpr int BN = Tl::BN, CPL = Tl::CPL;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_strips = (a.N + BN - 1) / BN, nk = (a.k + BK - 1) / BK;
  const int tiles = a.W * nk;
  int cnt = 0;
  const Items items{n_strips, tiles, a.n_kc, a.n_prod};
  items.for_each([&](int prod, int strip, int kc, int g0, int g1) {
    const int n0 = strip * BN, ncol = min(BN, a.N - n0);
    // the outputs this product writes: every local rank's, or its own
    const int t_lo = a.n_prod == 1 ? 0 : prod;
    const int t_hi = a.n_prod == 1 ? a.n_local : prod + 1;
    // with one chunk a strip is written at once; otherwise this chunk
    // leaves its partial (n_kc of them a strip)
    const bool whole = a.n_kc == 1;
    float* part = a.work + (((size_t)prod * n_strips + strip) * a.n_kc) *
                               a.M * BN;
    for (int m0 = 0; m0 < a.M; m0 += MT) {
      float acc[MT][CPL];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) acc[m][cc] = 0.f;
      for (int gt = g0; gt < g1; ++gt) {
        const int slot = cnt % STAGES;
        mbar_wait(&S.full[slot], (cnt / STAGES) & 1);
        const int nrow = min(BK, a.k - (gt % nk) * BK);
        const T* bs = S.bs + (size_t)slot * BK * BN + lane * CPL;
        const T* as = S.as + (size_t)slot * MT * BK;
        for (int kk = warp; kk < nrow; kk += NCW) {
          float b[CPL];
          load_f<T, CPL>(bs + kk * BN, b);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float av = to_f(as[m * BK + kk]);
#pragma unroll
            for (int cc = 0; cc < CPL; ++cc)
              acc[m][cc] = fmaf(av, b[cc], acc[m][cc]);
          }
        }
        stream::release_stage(&S.empty[slot]);
        ++cnt;
      }
      // every warp leaves its sums; then each element is summed over
      // the warps in warp order
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc)
          S.red[((size_t)warp * MT + m) * BN + lane * CPL + cc] = acc[m][cc];
      consumers_sync();
      for (int e = tid; e < MT * BN; e += NCW * 32) {
        const int m = e / BN, n = e % BN;
        if (m0 + m >= a.M || n >= ncol) continue;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < NCW; ++w) v += S.red[(size_t)w * MT * BN + e];
        if (whole) {
          const T o = from_f<T>(v);
          const size_t at = (size_t)(m0 + m) * a.N + n0 + n;
          for (int t = t_lo; t < t_hi; ++t)
            static_cast<T*>(const_cast<void*>(a.C.p[t]))[at] = o;
        } else {
          part[((size_t)kc * a.M + m0 + m) * BN + n] = v;
        }
      }
      consumers_sync();                // red is free for the next tile
    }
    if (whole) return;
    // the last of the strip's chunks to finish sums their partials in
    // chunk order
    if (tid == 0) {                    // the block's partial, then the count
      unsigned* ct = a.cnt + (size_t)prod * n_strips + strip;
      __threadfence();
      const unsigned old = atomicAdd(ct, 1u);
      const bool last = old == (unsigned)a.n_kc - 1u;
      if (last) {
        *ct = 0u;
        __threadfence();
      }
      S.misc[0] = last;
    }
    consumers_sync();
    if (S.misc[0]) {
      for (int e = tid; e < a.M * ncol; e += NCW * 32) {
        const int m = e / ncol, n = e % ncol;
        float v = 0.f;
#pragma unroll 8
        for (int c = 0; c < a.n_kc; ++c)
          v += __ldcg(part + ((size_t)c * a.M + m) * BN + n);
        const T o = from_f<T>(v);
        const size_t at = (size_t)m * a.N + n0 + n;
        for (int t = t_lo; t < t_hi; ++t)
          static_cast<T*>(const_cast<void*>(a.C.p[t]))[at] = o;
      }
    }
    consumers_sync();                  // misc is free for the next piece
  });
}

// Cooperative grid (at most what the card holds at once), NT threads.
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(NT)
ag_gemm_kernel(const __grid_constant__ Maps maps, Args a, symm::Peers P0) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<T, MT> S(smem_raw);
  symm::Peers P = P0;
  const int tid = threadIdx.x;
  unsigned local = 0;                  // bit mask of this card's ranks
  for (int i = 0; i < a.n_local; ++i) local |= 1u << a.R.r[i];
  // the epoch matters only when a source or a card is elsewhere; with
  // every rank here the producer takes it at the end, off the critical
  // path (the word still advances once per launch)
  const unsigned all = a.W == 32 ? 0xffffffffu : (1u << a.W) - 1u;
  const bool comm = (all & ~local) != 0u;
  if (tid == 0) {
    if (comm) S.misc[1] = (int)symm::take_epoch(P.state);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&S.full[i], 2);        // B issued + A stored
      mbar_init(&S.empty[i], NCW);     // one arrival per consumer warp
    }
    stream::mbar_init_fence();
  }
  if (comm) symm::cache_tables(P, S.tab);
  __syncthreads();
  if (comm) P.epoch = (unsigned)S.misc[1];

  // ---- push this card's shards into every other card's first rank
  const unsigned remote = a.leaders & ~local;
  if (remote) {
    const size_t n = (size_t)a.M * a.k;
    for (int c = blockIdx.x; c < PUSHERS; c += gridDim.x) {
      for (int lr = 0; lr < a.n_local; ++lr) {
        const int rank = a.R.r[lr];
        const T* src = static_cast<const T*>(a.A.p[lr]);
        for (int dst = 0; dst < a.W; ++dst) {
          if (!((remote >> dst) & 1u)) continue;
          T* d = reinterpret_cast<T*>(P.slot(dst, rank));
          if constexpr (VEC) {           // n is a multiple of VEC
            const size_t nv = n / Tile<T>::VEC;
            const size_t per = (nv + PUSHERS - 1) / PUSHERS;
            const size_t lo = c * per, hi = lo + per < nv ? lo + per : nv;
            const uint4* s4 = reinterpret_cast<const uint4*>(src);
            uint4* d4 = reinterpret_cast<uint4*>(d);
            for (size_t i = lo + tid; i < hi; i += NT) d4[i] = s4[i];
          } else {
            const size_t per = (n + PUSHERS - 1) / PUSHERS;
            const size_t lo = c * per, hi = lo + per < n ? lo + per : n;
            for (size_t i = lo + tid; i < hi; i += NT) d[i] = src[i];
          }
        }
        symm::publish(P, rank, c, remote);
      }
    }
  }

  if (tid / 32 == NCW) {
    producer<T, MT, VEC>(maps, a, S, P, local);
    if (!comm && tid % 32 == 0) symm::take_epoch(P.state);
  } else {
    consumer<T, MT, VEC>(a, S);
  }
}

template <typename T, int MT, bool VEC>
const void* kernel_fn() {
  return (const void*)ag_gemm_kernel<T, MT, VEC>;
}

template <typename T, int MT, bool VEC>
int set_smem() {
  static bool done = false;           // per instantiation
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel_fn<T, MT, VEC>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<T, MT>::bytes());
  done = e == cudaSuccess;
  return (int)e;
}

template <typename T, int MT, bool VEC>
int launch(const Maps& maps, const Args& a, int grid, const symm::Peers& P,
           cudaStream_t stream) {
  const int e = set_smem<T, MT, VEC>();
  if (e != 0) return e;
  Maps mv = maps;
  Args av = a;
  symm::Peers pv = P;
  void* args[] = {(void*)&mv, (void*)&av, (void*)&pv};
  return (int)cudaLaunchCooperativeKernel(kernel_fn<T, MT, VEC>(),
                                          dim3(grid), dim3(NT), args,
                                          Smem<T, MT>::bytes(), stream);
}

template <typename T, int MT, bool VEC>
int occupancy(int* out) {
  const int e = set_smem<T, MT, VEC>();
  if (e != 0) return e;
  return symm::blocks_per_sm(kernel_fn<T, MT, VEC>(), NT,
                             Smem<T, MT>::bytes(), out);
}

// MT, the rows of an A tile: the smallest of 1, 2, 4, 8 that holds M
// (M > 8 loops over tiles of 8, streaming B once per tile).
#define AG_BY_MT(FN, T, VEC, ...)                          \
  (M <= 1   ? FN<T, 1, VEC>(__VA_ARGS__)                  \
   : M <= 2 ? FN<T, 2, VEC>(__VA_ARGS__)                  \
   : M <= 4 ? FN<T, 4, VEC>(__VA_ARGS__)                  \
            : FN<T, 8, VEC>(__VA_ARGS__))

template <typename T>
int dispatch(int M, bool vec, const Maps* maps, const Args* a, int grid,
             const symm::Peers* P, cudaStream_t s, int* occ) {
  if (occ != nullptr)
    return vec ? AG_BY_MT(occupancy, T, true, occ)
               : AG_BY_MT(occupancy, T, false, occ);
  return vec ? AG_BY_MT(launch, T, true, *maps, *a, grid, *P, s)
             : AG_BY_MT(launch, T, false, *maps, *a, grid, *P, s);
}

// B (rows x N, row-major) as a 2D tensor map with (BK x 256-byte) boxes.
int encode_b(CUtensorMap* map, const void* b, int rows, int N, int dtype) {
  return stream::encode_2d(map, b, dtype, rows, N, N, dtype == 0 ? 64 : 128,
                           BK, CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace

// Blocks of the kernel for M rows, dtype (0 = float32, 1 = bfloat16) and
// copy path (vec: 16-byte copies) that fit on one SM of the current
// device (kernels/ag_gemm.py sizes the cooperative grid with it).
extern "C" int ag_gemm_blocks_per_sm(int M, int dtype, int vec, int* out) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(M, vec != 0, nullptr, nullptr, 0, nullptr,
                           nullptr, out);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(M, vec != 0, nullptr, nullptr, 0,
                                   nullptr, nullptr, out);
  return (int)cudaErrorInvalidValue;
}

// One cooperative launch on one device for its n_local ranks (ids
// ranks[], the card's first rank first) of a W-rank mesh. Per local
// rank: a (M, k) its K shard, b (W * k, N) the replicated B, c (M, N) its
// output; all contiguous row-major, one dtype (0 = float32, 1 =
// bfloat16). n_prod: 1 when every local rank passes the same b (one
// product, stored into every c), else n_local. vec: 1 for the 16-byte
// copy path (N and k multiples of 16 bytes, operands 16-byte aligned).
// n_kc: K chunks per strip; grid: blocks (at most what the card holds,
// ag_gemm_blocks_per_sm); work: fp32 (n_prod, strips, n_kc, M, 256 /
// sizeof(T)) partials when n_kc > 1;
// cnt: n_prod * ceil(N / (256 / sizeof(T))) uint32 counters, zero at
// entry and left at zero. leaders: bit mask of the mesh's first rank on
// every card. The symmetric buffers as in fd_paged_launch
// (csrc/flash_decode_paged.cu); a slot holds M * k elements; PUSHERS
// flags per source. Returns the launch's cudaError_t (0 = launched).
extern "C" int ag_gemm_launch(const void* const* a, const void* const* b,
                              void* const* c, const int* ranks, int n_local,
                              int n_prod, int M, int N, int k, int dtype,
                              int vec, int n_kc, int grid, unsigned leaders,
                              void* work, void* cnt, const void* inbox_tab,
                              const void* flag_tab, void* state, int W,
                              int n_chunk, long long slot_bytes,
                              long long half, void* stream) {
  if (M <= 0 || N <= 0 || k <= 0 || n_local <= 0 ||
      n_local > symm::MAX_RANKS || W < n_local || W > 32 ||
      n_chunk < PUSHERS || grid <= 0 || n_kc <= 0 ||
      n_kc > W * ((k + BK - 1) / BK) || state == nullptr ||
      (n_kc > 1 && (work == nullptr || cnt == nullptr)) ||
      (dtype != 0 && dtype != 1) ||
      !((leaders >> ranks[0]) & 1u))
    return (int)cudaErrorInvalidValue;
  Args args;
  args.n_local = n_local;
  args.n_prod = n_prod;
  args.M = M;
  args.N = N;
  args.k = k;
  args.W = W;
  args.n_kc = n_kc;
  args.leaders = leaders;
  args.work = static_cast<float*>(work);
  args.cnt = static_cast<unsigned*>(cnt);
  const size_t esz = dtype == 0 ? 4 : 2;
  bool aligned = ((size_t)N * esz) % 16 == 0 && ((size_t)k * esz) % 16 == 0 &&
                 slot_bytes % 16 == 0;
  for (int i = 0; i < n_local; ++i) {
    args.A.p[i] = a[i];
    args.B.p[i] = b[i];
    args.C.p[i] = c[i];
    args.R.r[i] = ranks[i];
    aligned = aligned && reinterpret_cast<uintptr_t>(a[i]) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(b[i]) % 16 == 0;
    if (n_prod == 1 && b[i] != b[0]) return (int)cudaErrorInvalidValue;
  }
  if ((n_prod != 1 && n_prod != n_local) || (vec && !aligned))
    return (int)cudaErrorInvalidValue;
  const symm::Peers P = symm::make_peers(inbox_tab, flag_tab, state, W,
                                         n_chunk, slot_bytes, half, n_local);
  Maps maps = {};
  for (int i = 0; vec && i < n_prod; ++i) {
    const int e = encode_b(&maps.m[i], b[i], W * k, N, dtype);
    if (e != 0) return e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(M, vec != 0, &maps, &args, grid, &P, s, nullptr);
  return dispatch<__nv_bfloat16>(M, vec != 0, &maps, &args, grid, &P, s,
                                 nullptr);
}
