// GEMM for Hopper (sm_90a): C = A @ B with an fp32 accumulator, for one
// product or for a group of products that share A.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul.py
// (`_mm_kernel` / `matmul`): (bm,bk)x(bk,bn) VMEM tiles with an fp32
// accumulator carried across the sequential K grid axis.
//
// Layouts (row-major, contiguous): A (M, K); B (K, N) -- the JAX weight
// layout, N contiguous -- or, with trans_b, B given as (N, K) (the
// unembed's (vocab, d) table, read transposed without a copy); C (M, N).
// Types: bf16 x bf16 -> bf16 and f32 x f32 -> f32.
//
// What bounds it on the H100: decode has M <= batch, so every weight
// byte is used for only M multiply-adds -- far below the ~295 flop/byte
// ridge. The floor is the weight stream, (K*N*sizeof(B) + M*K + M*N) /
// 3.35 TB/s, and the design is judged by the bytes in flight on every
// SM (`gemm_stream`, the fused AG+GEMM's machinery, stream.cuh):
//   * A persistent grid over what the card holds at once walks items
//     (product, strip, K chunk), chunk fastest, products in order. A
//     strip is 256 bytes of a B row (B in (K, N)) or 16 table rows of
//     B (trans, fp32); kernels/matmul.py `gemm_plan` splits K into the
//     fewest chunks that finish within a slack of the shortest span on
//     the grid, from the product's own shape and the card alone.
//   * One producer warp keeps a ring of 4 stages of 16 KB B tiles in
//     flight (one to three blocks an SM), each completing on an mbarrier:
//     two 2D TMA boxes, or one, plus the M-row A tile as one more TMA
//     box. Eight consumer warps multiply.
//   * Split-K partials are folded in chunk order by the block whose chunk
//     of a strip arrives last (a per-strip counter, left at zero), after
//     that block's own items, so the fold does not stall its stream.
//     Every bit of C depends only on the shapes and the card: a product
//     computed in a group equals the same product computed alone.
//   * A group (`matmul_group`: wq/wk/wv, wg/wu) spans every product's
//     items in one launch: wk and wv's 8 strips join wq's 32.
// The consumers, by path:
//   * KN_MMA, bf16 B (K, N): `mma.sync` m16n8k16 with the operands
//     swapped, C^T = B^T A^T. The weight tile is the 16-row operand,
//     loaded by `ldmatrix.trans` from TMA's 128-byte swizzle (no bank
//     conflicts); the batch is the n = 8 side (M <= 8: one n8 tile, M <=
//     16: two). Each warp owns 16 columns, so no cross-warp sum. Kept over
//     the fp32 FMA consumer (KN_FMA, which at M = 8 issues 8 shared loads,
//     8 conversions and 32 FMAs per lane per B row): at the decode shapes
//     it ran 1.3-2.2x faster per launch on the H100 (PERF.md).
//   * KN_FMA, fp32 B (K, N): warps split the K rows of a tile, a lane
//     owns 2 columns, the warps' sums folded through shared memory in
//     warp order. No TF32: the plain version is full fp32.
//   * TRANS, B (N, K) (the fp32 unembed): rows of the table are
//     K-contiguous, so a tile is BN table rows x 256 K elements (16 rows
//     of 1 KB in fp32); each warp owns BN / 8 rows and takes their dot
//     products with the M rows of A (fp32 FMA, a lane 8 K elements,
//     warp-shuffle sums at the item's end).
//   * mm_kernel, the general path, for shapes and pointers TMA cannot
//     take (rows that are not whole 16-byte words, unaligned operands):
//     (32, 64) tiles of B through shared memory with the next tile
//     prefetched into registers.
// Any M: an item loops over M tiles of MT rows, streaming its B tiles
// once per M tile. Where the M tiles alone fill the grid (training
// shapes: M 2048 tokens, or 4096-128256 in a weight gradient), the plan
// splits M instead of K: an item is (product, strip, M chunk), its
// output written straight into C, with no split-K workspace (kernels/
// matmul.py `gemm_plan`). wgmma tiles for such M are later work.
// Batched (`matmul_batched`: the MoE layer's expert products, A (E, M, K)
// @ B (E, K, N) -> C (E, M, N)): every tensor map is 3D, over E matrices,
// so one descriptor serves all experts and a box never crosses into the
// next expert; an item is (product, expert, strip, M chunk, K chunk), so
// all E products are one launch (E = 1 is the plain GEMM). The general
// kernel takes the expert from blockIdx.y.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "stream.cuh"

namespace {

using stream::from_f;
using stream::load_f;
using stream::mbar_arrive_tx;
using stream::mbar_init;
using stream::mbar_wait;
using stream::smem_addr;
using stream::tma_load_3d;
using stream::to_f;

// ------------------------------------------------------------ mm_kernel
constexpr int BM = 16;            // rows of C per M tile
constexpr int BN = 64;            // columns of C a block owns
constexpr int BK = 32;            // depth of one K slice
constexpr int NT = 256;           // threads: 16 rows x 16 column groups of 4
constexpr int BN_PAD = BN + 4;    // keeps float4 rows aligned, spreads banks
constexpr int B_PER_T = BK * BN / NT;   // 8 B elements per thread per slice
constexpr int A_PER_T = BM * BK / NT;   // 2 A elements per thread per slice

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
  A += (size_t)blockIdx.y * M * K;        // this block's expert
  B += (size_t)blockIdx.y * K * N;
  C += (size_t)blockIdx.y * M * N;

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

// ---------------------------------------------------------- gemm_stream
constexpr int NCW = 8;                // consumer warps
constexpr int GT = 32 * (NCW + 1);    // + one producer warp
constexpr int TILE_B = 16384;         // bytes of B per stage
constexpr int STAGES = 4;             // ring depth: 64 KB of B in flight
constexpr int MAXP = 4;               // products of one group
constexpr int FOLD_CAP = 32;          // strips a block may fold at its end
enum Path { KN_MMA = 0, KN_FMA = 1, TRANS = 2 };

// A path's tiles: a strip is BN output columns, a tile KT of K; a stage
// holds NBOX B boxes of BOX_C elements x the rest of 16 KB (inner x
// outer) and the A box of KT x MT. B (K, N): 64 K rows of a strip of 256
// bytes (for KN_MMA two 128-byte swizzled boxes of 64 columns); B (N, K):
// BN table rows of 256 K elements (row pieces of 1 KB in fp32). (Strips
// of 512 bytes or 1 KB, and 6 or 8 stages, ran slower on the H100.)
template <int PATH, typename T>
struct Geo {
  static constexpr int BN = PATH == TRANS ? TILE_B / (256 * (int)sizeof(T))
                                          : 256 / (int)sizeof(T);
  static constexpr int KT = PATH == TRANS ? 256 : 64;
  static constexpr int NBOX = PATH == KN_MMA ? 2 : 1;
  static constexpr int BOX_C = PATH == KN_MMA ? 64 : PATH == KN_FMA ? BN : KT;
};

template <int PATH, typename T, int MT>
struct Layout {
  using G = Geo<PATH, T>;
  static constexpr int A_BYTES = MT * G::KT * (int)sizeof(T);
  static constexpr int STAGE = TILE_B + (A_BYTES + 1023) / 1024 * 1024;
  static constexpr int RED = PATH == KN_FMA ? NCW * MT * G::BN * 4 : 0;
  static constexpr int MISC = 4 * (2 + 2 * FOLD_CAP);
  static constexpr size_t bytes() {   // + 1024 to align the ring by hand
    return 1024 + (size_t)STAGES * STAGE + RED + 2 * STAGES * 8 + MISC;
  }
};

// B's tensor map per product and A's (3D: E matrices), in the kernel's
// parameter space (__grid_constant__), where the TMA unit reads them.
struct alignas(64) GemmMaps {
  CUtensorMap b[MAXP];
  CUtensorMap a;
};

struct GemmArgs {
  void* C[MAXP];
  int N[MAXP], strips[MAXP], n_kc[MAXP], n_mc[MAXP];
  int item0[MAXP + 1];      // product p's items: [item0[p], item0[p + 1])
  long long work_off[MAXP]; // its partials, in floats into work
  int cnt_off[MAXP];        // its strips' counters
  int n_prod, M, K, tiles, m_tiles;
  float* work;              // (E, strips, n_kc, M, BN) fp32 per product
  unsigned* cnt;            // counters, zero at entry and left at zero
};

struct Item {
  int prod, e, strip, kc, t0, t1, mt0, mt1;
};

// Item i: (product, expert, strip, M chunk, K chunk), K chunk fastest,
// then the M chunk; the chunk's K tiles [t0, t1) and M tiles [mt0,
// mt1). A plan splits K or M, never both. (Walking strips fastest
// instead, so that neighbouring blocks read neighbouring pieces of the
// same B rows, timed the same on the H100.)
__device__ __forceinline__ Item item_at(const GemmArgs& g, int i) {
  int p = 0;
  while (p + 1 < g.n_prod && i >= g.item0[p + 1]) ++p;
  const int nkc = g.n_kc[p], nmc = g.n_mc[p];
  const int per_e = g.strips[p] * nmc * nkc;
  const int local = (i - g.item0[p]) % per_e;
  const int kc = local % nkc, mc = local / nkc % nmc;
  return {p, (i - g.item0[p]) / per_e, local / nkc / nmc, kc,
          (int)((long long)kc * g.tiles / nkc),
          (int)((long long)(kc + 1) * g.tiles / nkc),
          (int)((long long)mc * g.m_tiles / nmc),
          (int)((long long)(mc + 1) * g.m_tiles / nmc)};
}

template <int PATH, typename T, int MT>
__device__ void producer(const GemmMaps& maps, const GemmArgs& g,
                         unsigned char* ring, uint64_t* full,
                         uint64_t* empty) {
  using G = Geo<PATH, T>;
  using L = Layout<PATH, T, MT>;
  if (threadIdx.x % 32 != 0) return;
  for (int p = 0; p < g.n_prod; ++p) stream::prefetch_map(&maps.b[p]);
  stream::prefetch_map(&maps.a);
  int cnt = 0;
  for (int i = blockIdx.x; i < g.item0[g.n_prod]; i += gridDim.x) {
    const Item it = item_at(g, i);
    const int n0 = it.strip * G::BN;
    for (int m0 = it.mt0 * MT; m0 < it.mt1 * MT; m0 += MT) {
      for (int t = it.t0; t < it.t1; ++t, ++cnt) {
        const int slot = cnt % STAGES;
        mbar_wait(&empty[slot], ((cnt / STAGES) & 1) ^ 1);
        unsigned char* st = ring + (size_t)slot * L::STAGE;
        mbar_arrive_tx(&full[slot], TILE_B + L::A_BYTES);
        const int k0 = t * G::KT;
        if constexpr (PATH == TRANS) {
          tma_load_3d(st, &maps.b[it.prod], k0, n0, it.e, &full[slot]);
        } else {
#pragma unroll
          for (int j = 0; j < G::NBOX; ++j)
            tma_load_3d(st + j * (TILE_B / G::NBOX), &maps.b[it.prod],
                        n0 + j * G::BOX_C, k0, it.e, &full[slot]);
        }
        tma_load_3d(st + TILE_B, &maps.a, k0, m0, it.e, &full[slot]);
      }
    }
  }
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ unsigned lds32(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// TMA's 128-byte swizzle: the 16-byte chunk c of 128-byte row r (of a
// 1024-byte aligned box) lies at chunk c ^ (r % 8).
__device__ __forceinline__ int swz(int r, int c) { return c ^ (r & 7); }
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Where a consumer puts C[m][n] (n within the strip): straight into C
// when the strip is one chunk, else into the chunk's partial.
template <typename T, int BNS>
struct Out {
  T* C;
  float* part;      // this strip's (n_kc, M, BNS) partials, or null
  int M, N, n0, kc;
  __device__ __forceinline__ void put(int m, int n, float v) const {
    if (m >= M || n0 + n >= N) return;
    if (part == nullptr)
      C[(size_t)m * N + n0 + n] = from_f<T>(v);
    else
      part[((size_t)kc * M + m) * BNS + n] = v;
  }
};

// Strip `gs` (expert gs / strips, strip gs % strips) of product `prod`
// in C: the sum of its n_kc partials in chunk order, by the consumer
// threads; each thread keeps FOLD_MLP elements' loads in flight at once.
template <typename T, int BNS>
__device__ void fold_strip(const GemmArgs& g, int prod, int gs) {
  constexpr int FOLD_MLP = 4;
  const int nkc = g.n_kc[prod], N = g.N[prod];
  const int n0 = gs % g.strips[prod] * BNS;
  const int ncol = min(BNS, N - n0), total = g.M * ncol;
  const float* part = g.work + g.work_off[prod] +
                      (size_t)gs * nkc * g.M * BNS;
  T* C = static_cast<T*>(g.C[prod]) +
         (size_t)(gs / g.strips[prod]) * g.M * N;
  for (int e0 = threadIdx.x; e0 < total; e0 += NCW * 32 * FOLD_MLP) {
    float v[FOLD_MLP];
    size_t at[FOLD_MLP];
#pragma unroll
    for (int j = 0; j < FOLD_MLP; ++j) {
      const int e = min(e0 + j * NCW * 32, total - 1);
      at[j] = (size_t)(e / ncol) * BNS + e % ncol;
      v[j] = 0.f;
    }
#pragma unroll 4
    for (int c = 0; c < nkc; ++c)
#pragma unroll
      for (int j = 0; j < FOLD_MLP; ++j)
        v[j] += __ldcg(part + (size_t)c * g.M * BNS + at[j]);
#pragma unroll
    for (int j = 0; j < FOLD_MLP; ++j) {
      const int e = e0 + j * NCW * 32;
      if (e < total)
        C[(size_t)(e / ncol) * N + n0 + e % ncol] = from_f<T>(v[j]);
    }
  }
}

// The consumers of one block: every item's M tiles. An item of a split
// strip leaves its partial and counts itself; the block that counts a
// strip last folds it after its own items (the producer keeps streaming
// meanwhile), or at once when its list of FOLD_CAP strips is full.
template <int PATH, typename T, int MT>
__device__ void consumer(const GemmArgs& g, unsigned char* ring, float* red,
                         uint64_t* full, uint64_t* empty, int* misc) {
  using G = Geo<PATH, T>;
  using L = Layout<PATH, T, MT>;
  constexpr int BNS = G::BN, KT = G::KT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned ring_s = smem_addr(ring);
  int* n_folds = misc;                 // [1] strips this block folds
  int* folds = misc + 2;               // [FOLD_CAP][2] (product, E strip)
  if (tid == 0) *n_folds = 0;
  int cnt = 0;
  for (int i = blockIdx.x; i < g.item0[g.n_prod]; i += gridDim.x) {
    const Item it = item_at(g, i);
    const int nkc = g.n_kc[it.prod];
    const int N = g.N[it.prod], n0 = it.strip * BNS;
    const int gs = it.e * g.strips[it.prod] + it.strip;   // strip of all E
    float* part = nkc == 1 ? nullptr
                           : g.work + g.work_off[it.prod] +
                                 (size_t)gs * nkc * g.M * BNS;
    const Out<T, BNS> out{
        static_cast<T*>(g.C[it.prod]) + (size_t)it.e * g.M * N, part, g.M,
        N, n0, it.kc};
    for (int m0 = it.mt0 * MT; m0 < it.mt1 * MT; m0 += MT) {
      if constexpr (PATH == KN_MMA) {
        // warp w: columns 16w..16w+15. ldmatrix: lane -> matrix j = lane
        // / 8 (j & 1: columns +8, j >> 1: K rows +8), row lane % 8
        constexpr int NT8 = MT / 8;
        const int j = lane / 8, gq = lane / 4, tq = lane % 4;
        const int ncol = warp * 16 + (j & 1) * 8;
        const unsigned boff = (ncol / 64) * (TILE_B / 2);
        const int cc = (ncol % 64) / 8;        // 16-byte chunk of the row
        const int kr0 = (j >> 1) * 8 + lane % 8;
        float d[NT8][4];
#pragma unroll
        for (int u = 0; u < NT8; ++u) d[u][0] = d[u][1] = d[u][2] = d[u][3] = 0.f;
        for (int t = it.t0; t < it.t1; ++t, ++cnt) {
          const int slot = cnt % STAGES;
          mbar_wait(&full[slot], (cnt / STAGES) & 1);
          const unsigned sb = ring_s + slot * L::STAGE, sa = sb + TILE_B;
#pragma unroll
          for (int ks = 0; ks < KT / 16; ++ks) {
            const int kr = ks * 16 + kr0;      // 128-byte rows, swizzled
            unsigned a[4];
            ldsm_x4_trans(sb + boff + kr * 128 + (swz(kr, cc) << 4), a);
#pragma unroll
            for (int u = 0; u < NT8; ++u) {
              const int m = u * 8 + gq;
              const unsigned row = sa + m * 128 + tq * 4;
              mma_bf16(d[u], a, lds32(row + (swz(m, 2 * ks) << 4)),
                       lds32(row + (swz(m, 2 * ks + 1) << 4)));
            }
          }
          stream::release_stage(&empty[slot]);
        }
        // d[u]: C^T rows (columns of C) 16w + gq (+8), cols (rows of C)
        // m0 + 8u + 2tq (+1)
#pragma unroll
        for (int u = 0; u < NT8; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            out.put(m0 + u * 8 + 2 * tq + (e & 1),
                    warp * 16 + gq + (e >> 1) * 8, d[u][e]);
      } else if constexpr (PATH == KN_FMA) {
        constexpr int CPL = BNS / 32;          // columns per lane
        float acc[MT][CPL];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[m][c] = 0.f;
        for (int t = it.t0; t < it.t1; ++t, ++cnt) {
          const int slot = cnt % STAGES;
          mbar_wait(&full[slot], (cnt / STAGES) & 1);
          const T* bs = reinterpret_cast<const T*>(ring + slot * L::STAGE) +
                        lane * CPL;
          const T* as = reinterpret_cast<const T*>(ring + slot * L::STAGE +
                                                   TILE_B);
          for (int kk = warp; kk < KT; kk += NCW) {
            float b[CPL];
            load_f<T, CPL>(bs + kk * BNS, b);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float av = to_f(as[m * KT + kk]);
#pragma unroll
              for (int c = 0; c < CPL; ++c) acc[m][c] = fmaf(av, b[c], acc[m][c]);
            }
          }
          stream::release_stage(&empty[slot]);
        }
        // every warp leaves its sums; then each element is summed over
        // the warps in warp order
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < CPL; ++c)
            red[((size_t)warp * MT + m) * BNS + lane * CPL + c] = acc[m][c];
        stream::consumers_sync<NCW * 32>();
        for (int e = tid; e < MT * BNS; e += NCW * 32) {
          float v = 0.f;
#pragma unroll
          for (int w = 0; w < NCW; ++w) v += red[(size_t)w * MT * BNS + e];
          out.put(m0 + e / BNS, e % BNS, v);
        }
        stream::consumers_sync<NCW * 32>();   // red is free again
      } else {                                 // TRANS
        // warp w: table rows RPW w .. + RPW - 1 of the tile; a lane: K
        // elements 8 lane .. + 7 of its 256
        constexpr int RPW = BNS / NCW;
        constexpr int CPL = KT / 32;
        constexpr int VN = 16 / (int)sizeof(T);   // elements per 16 bytes
        float acc[RPW][MT];
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;
        for (int t = it.t0; t < it.t1; ++t, ++cnt) {
          const int slot = cnt % STAGES;
          mbar_wait(&full[slot], (cnt / STAGES) & 1);
          const T* bs = reinterpret_cast<const T*>(ring + slot * L::STAGE) +
                        (size_t)warp * RPW * KT + lane * CPL;
          const T* as = reinterpret_cast<const T*>(ring + slot * L::STAGE +
                                                   TILE_B) + lane * CPL;
          float bv[RPW][CPL];
#pragma unroll
          for (int r = 0; r < RPW; ++r)
#pragma unroll
            for (int c = 0; c < CPL; c += VN)
              load_f<T, VN>(bs + r * KT + c, bv[r] + c);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            float av[CPL];
#pragma unroll
            for (int c = 0; c < CPL; c += VN)
              load_f<T, VN>(as + m * KT + c, av + c);
#pragma unroll
            for (int r = 0; r < RPW; ++r)
#pragma unroll
              for (int c = 0; c < CPL; ++c)
                acc[r][m] = fmaf(bv[r][c], av[c], acc[r][m]);
          }
          stream::release_stage(&empty[slot]);
        }
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float v = warp_sum(acc[r][m]);
            if (lane == (r * MT + m) % 32) out.put(m0 + m, warp * RPW + r, v);
          }
      }
    }
    if (part == nullptr) continue;
    // the block's partial, then the count (tid 0's fence publishes every
    // consumer's stores, ordered before it by the barrier)
    stream::consumers_sync<NCW * 32>();
    if (tid == 0) {
      unsigned* ct = g.cnt + g.cnt_off[it.prod] + gs;
      __threadfence();
      if (atomicAdd(ct, 1u) == (unsigned)nkc - 1u) {
        *ct = 0u;
        const int n = (*n_folds)++;
        folds[2 * n] = it.prod;
        folds[2 * n + 1] = gs;
      }
    }
    stream::consumers_sync<NCW * 32>();
    if (*n_folds == FOLD_CAP) {             // the list is full: fold now
      __threadfence();
      for (int f = 0; f < FOLD_CAP; ++f)
        fold_strip<T, BNS>(g, folds[2 * f], folds[2 * f + 1]);
      stream::consumers_sync<NCW * 32>();
      if (tid == 0) *n_folds = 0;
      stream::consumers_sync<NCW * 32>();
    }
  }
  stream::consumers_sync<NCW * 32>();
  if (*n_folds > 0) {
    __threadfence();
    for (int f = 0; f < *n_folds; ++f)
      fold_strip<T, BNS>(g, folds[2 * f], folds[2 * f + 1]);
  }
}

// Persistent grid (at most what the card holds at once), GT threads.
template <int PATH, typename T, int MT>
__global__ void __launch_bounds__(GT)
gemm_stream(const __grid_constant__ GemmMaps maps, const GemmArgs g) {
  using L = Layout<PATH, T, MT>;
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle wants its boxes 1024-byte aligned
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023))
                                    & 1023);
  float* red = reinterpret_cast<float*>(ring + (size_t)STAGES * L::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + (size_t)STAGES * L::STAGE + L::RED);
  uint64_t* empty = full + STAGES;
  int* misc = reinterpret_cast<int*>(empty + STAGES);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);          // the producer's expect_tx
      mbar_init(&empty[s], NCW);       // one arrival per consumer warp
    }
    stream::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x / 32 == NCW)
    producer<PATH, T, MT>(maps, g, ring, full, empty);
  else
    consumer<PATH, T, MT>(g, ring, red, full, empty, misc);
}

template <int PATH, typename T, int MT>
int set_smem() {
  static bool done = false;           // per instantiation
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_stream<PATH, T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<PATH, T, MT>::bytes());
  done = e == cudaSuccess;
  return (int)e;
}

template <int PATH, typename T, int MT>
int run(const GemmMaps* maps, const GemmArgs* g, int grid, cudaStream_t s,
        int* occ) {
  const int e = set_smem<PATH, T, MT>();
  if (e != 0) return e;
  const size_t smem = Layout<PATH, T, MT>::bytes();
  if (occ != nullptr) {
    *occ = 0;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, gemm_stream<PATH, T, MT>, GT, smem);
  }
  gemm_stream<PATH, T, MT><<<grid, GT, smem, s>>>(*maps, *g);
  return (int)cudaGetLastError();
}

// The instantiation for (path, dtype, MT): KN_MMA takes bf16 with MT 8 or
// 16, KN_FMA fp32 with MT 8, TRANS either with MT 8.
int by_path(int path, int dtype, int mt, const GemmMaps* maps,
            const GemmArgs* g, int grid, cudaStream_t s, int* occ) {
  using bf16 = __nv_bfloat16;
  if (path == KN_MMA && dtype == 1 && mt == 8)
    return run<KN_MMA, bf16, 8>(maps, g, grid, s, occ);
  if (path == KN_MMA && dtype == 1 && mt == 16)
    return run<KN_MMA, bf16, 16>(maps, g, grid, s, occ);
  if (path == KN_FMA && dtype == 0 && mt == 8)
    return run<KN_FMA, float, 8>(maps, g, grid, s, occ);
  if (path == TRANS && mt == 8)
    return dtype == 0 ? run<TRANS, float, 8>(maps, g, grid, s, occ)
                      : run<TRANS, bf16, 8>(maps, g, grid, s, occ);
  return (int)cudaErrorInvalidValue;
}

// (BN, KT) of a path for an element size (Geo).
void geometry(int path, int esz, int* bn, int* kt) {
  *bn = path == TRANS ? TILE_B / (256 * esz) : 256 / esz;
  *kt = path == TRANS ? 256 : 64;
}

template <typename T>
void launch_general(const void* a, const void* b, void* c, int E, int M,
                    int N, int K, int trans_b, cudaStream_t stream) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  T* C = static_cast<T*>(c);
  const dim3 grid((N + BN - 1) / BN, E);
  if (trans_b)
    mm_kernel<T, true><<<grid, NT, 0, stream>>>(A, B, C, M, N, K);
  else
    mm_kernel<T, false><<<grid, NT, 0, stream>>>(A, B, C, M, N, K);
}

}  // namespace

// The general kernel (any shape, any alignment): C_e = A_e @ B_e for the
// E (<= 65535) matrices of contiguous A (E, M, K), B (E, K, N) or (E,
// N, K) with trans_b, C (E, M, N). dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 = launched). Launches
// on `stream`; never synchronises, allocates nothing.
extern "C" int mm_launch(const void* a, const void* b, void* c, int E,
                         int M, int N, int K, int trans_b, int dtype,
                         void* stream) {
  if (E <= 0 || E > 65535 || M <= 0 || N <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_general<float>(a, b, c, E, M, N, K, trans_b, s);
  else if (dtype == 1)
    launch_general<__nv_bfloat16>(a, b, c, E, M, N, K, trans_b, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Blocks of gemm_stream for (path, dtype, mt) that fit on one SM of the
// current device (kernels/matmul.py sizes the persistent grid with it).
extern "C" int gemm_blocks_per_sm(int path, int dtype, int mt, int* out) {
  return by_path(path, dtype, mt, nullptr, nullptr, 0, nullptr, out);
}

// One launch of gemm_stream: C_p = A @ B_p for the n_prod (<= 4)
// products of a group, each for the E matrices of a batch (E = 1: one
// matrix). a: (E, M, K); b[p]: (E, K, N[p]), or (E, N[p], K) for path 2
// (TRANS); c[p]: (E, M, N[p]); all contiguous row-major, one dtype (0 =
// float32, 1 = bfloat16), 16-byte aligned, rows whole 16-byte words.
// path: 0 KN_MMA (bf16), 1 KN_FMA (fp32), 2 TRANS; mt: rows of an A tile
// (8, or 16 for KN_MMA). n_kc[p], n_mc[p]: K chunks and M chunks per
// strip of product p, one of them 1 (kernels/matmul.py gemm_plan); grid: blocks (at most what the card holds,
// gemm_blocks_per_sm). work: fp32 partials, per product with n_kc > 1
// in product order E * strips * n_kc * M * BN floats; cnt: one uint32
// counter per strip of every product and matrix, zero at entry and left
// at zero. Returns
// the launch's cudaError_t (0 = launched).
extern "C" int gemm_launch(const void* a, const void* const* b,
                           void* const* c, int n_prod, int E, int M, int K,
                           const int* N, const int* n_kc, const int* n_mc,
                           int dtype,
                           int path, int mt, int grid, void* work, void* cnt,
                           void* stream) {
  if (n_prod <= 0 || n_prod > MAXP || E <= 0 || M <= 0 || K <= 0 ||
      grid <= 0 ||
      mt <= 0 ||
      (dtype != 0 && dtype != 1) || path < 0 || path > 2 ||
      (path == KN_MMA && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int esz = dtype == 0 ? 4 : 2;
  int bn, kt;
  geometry(path, esz, &bn, &kt);
  const bool trans = path == TRANS;
  // KN_MMA's boxes (128-byte rows) are swizzled so that ldmatrix and the
  // A loads meet no bank twice
  const CUtensorMapSwizzle swz = path == KN_MMA
                                     ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_NONE;

  if (((size_t)K * esz) % 16 || reinterpret_cast<uintptr_t>(a) % 16)
    return (int)cudaErrorInvalidValue;
  GemmMaps maps = {};
  GemmArgs g = {};
  g.n_prod = n_prod;
  g.M = M;
  g.K = K;
  g.tiles = (K + kt - 1) / kt;
  g.m_tiles = (M + mt - 1) / mt;
  g.work = static_cast<float*>(work);
  g.cnt = static_cast<unsigned*>(cnt);
  long long work_off = 0;
  int cnt_off = 0;
  for (int p = 0; p < n_prod; ++p) {
    const int strips = (N[p] + bn - 1) / bn;
    if (N[p] <= 0 || n_kc[p] <= 0 || n_kc[p] > g.tiles || n_mc[p] <= 0 ||
        n_mc[p] > g.m_tiles || (n_kc[p] > 1 && n_mc[p] > 1) ||
        (!trans && ((size_t)N[p] * esz) % 16) ||
        reinterpret_cast<uintptr_t>(b[p]) % 16 ||
        (n_kc[p] > 1 && (work == nullptr || cnt == nullptr)))
      return (int)cudaErrorInvalidValue;
    g.C[p] = c[p];
    g.N[p] = N[p];
    g.strips[p] = strips;
    g.n_kc[p] = n_kc[p];
    g.n_mc[p] = n_mc[p];
    g.item0[p + 1] = g.item0[p] + E * strips * n_mc[p] * n_kc[p];
    g.work_off[p] = work_off;
    g.cnt_off[p] = cnt_off;
    if (n_kc[p] > 1) {
      work_off += (long long)E * strips * n_kc[p] * M * bn;
      cnt_off += E * strips;
    }
    const int e = trans ? stream::encode_3d(&maps.b[p], b[p], dtype, E, N[p],
                                            K, K, kt, bn, swz)
                        : stream::encode_3d(&maps.b[p], b[p], dtype, E, K,
                                            N[p], N[p],
                                            path == KN_MMA ? 64 : bn, kt,
                                            swz);
    if (e != 0) return e;
  }
  const int e = stream::encode_3d(&maps.a, a, dtype, E, M, K, K, kt, mt,
                                  swz);
  if (e != 0) return e;
  return by_path(path, dtype, mt, &maps, &g, grid,
                 static_cast<cudaStream_t>(stream), nullptr);
}
