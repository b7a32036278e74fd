// The single-launch GQA flash decode shared by the port's two decode
// kernels: the paged pool (flash_decode_paged.cu, `fd_paged`) and the
// contiguous strided cache (flash_decode.cu, `fd_strided`). They differ
// only in where a unit's K/V rows lie and which positions those rows
// hold -- the Walk each file defines -- and share everything else here.
//
// Both produce, per unit (local rank, slot, KV head, head group), the
// unnormalised fp32 record (o, m, l) of the group's gu query heads and
// finish it in one of three modes. A KV head's g = H / KVH query heads
// form HG = g / gu groups of gu = heads_per_unit(g, D) heads, the largest
// divisor of g with gu * D <= 1024 (so every head of a group lives in the
// registers of one block: HG = 1 up to g * D = 1024; paligemma's D 256 at
// g 8 runs as two units of 4 heads, each streaming the KV head's rows):
//   NORMAL   W = 1: o / max(l, 1e-30) in q's dtype (a row with nothing to
//            attend comes out as zeros);
//   PARTIAL  the rank's partial (o, m, l), fp32 (n_local, B, H, D + 2):
//            what the bsp, ring and rs_ag schedules combine in torch code;
//   FUSED    the paper's Algorithm 4 Part 2: push the rank's record into
//            slot `rank` of every rank's inbox, wait for every source and
//            fold them in rank order 0..W-1, so every rank's output is
//            bit-identical (symm.cuh).
//
// What bounds it on the H100: decode attention streams the K/V bytes it
// attends -- about one multiply-add per byte, so memory (3.35 TB/s), not
// the tensor cores. At decode shapes that is ~1 MB per call, a fraction
// of a microsecond: the real floor is the latency chain of one launch,
// one K/V read and (W > 1) one trip of the records between ranks. The
// design cuts that chain:
//   * One launch per call per card. A unit is (local rank, slot, KV
//     head, head group); `n_split` blocks share a unit only when its walk
//     is long (kernels/flash_decode.py `decode_plan`).
//   * K and V rows arrive as 16-byte cp.async copies into a ring of NST
//     staged tiles of TR rows, NST - 1 in flight ahead of the one being
//     scored.
//   * The gu query heads of the unit live in registers and share each
//     staged row. Each of the 8 warps takes every 8th row: a lane holds
//     D / 32 elements of q, k and v; the scores of all its rows and heads
//     are warp-shuffle dots over D, reduced together; each warp keeps its
//     own online softmax in log2 units (exp2f), and the warps are folded
//     in warp order at the end.
//   * Splits (when there are several) leave an fp32 record in a scratch
//     and bump a per-unit counter; the last to arrive folds the records
//     in split order and resets the counter.
//   * FUSED writes the record as LL lines (symm.cuh: each 8-byte half
//     carries the epoch, so no fence and no flag) into slot `rank` of
//     every rank's inbox, and -- after every block has pushed its units
//     -- each block polls the W sources' lines of its units, all at once,
//     and folds them in rank order. FUSED is a cooperative launch over
//     the card's local ranks whose grid fits the card (symm.cuh); its
//     epoch comes from the card's word in device memory, asked for while
//     the first tiles are in flight, so a CUDA graph can replay the call.
//
// A Walk is built by every thread of the block for one item (unit u,
// split sp) from the slot's cur_len, and gives the item's tiles:
//   W(const Args&, int* lc, int* lb, int* misc, int lr, int b, int sp,
//     int cl)                       (lc, lb, misc: shared scratch)
//   int tiles() const               number of TR-row tiles to walk
//   TileRef tile(int t) const       tile t: first row, rows, position
//   int pstep                       positions between consecutive rows
// A row is KVH * D elements of the pool or shard (both lay rows out so).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

#include "symm.cuh"

namespace fd {

constexpr float NEG = -FLT_MAX;  // jnp.finfo(float32).min, as in Pallas

enum Mode { NORMAL = 0, PARTIAL = 1, FUSED = 2 };

constexpr int NT = 256;          // threads of a block
constexpr int NW = NT / 32;      // warps
constexpr int TR = 16;           // K/V rows per staged tile
constexpr int NST = 4;           // staged tiles, NST - 1 in flight ahead
constexpr int LIST_CAP = 512;    // table entries one paged split may walk

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Everything a launch needs, by value.
struct Args {
  symm::Ptrs Q, K, V, CL, TB;
  symm::Ranks R;
  void* out;
  float* split_rec;        // (units, n_split, rec) fp32, if n_split > 1
  unsigned* cnt;           // (units,) arrival counters, left at 0
  int row_stride, n_local, n_loc, B, H, KVH, bs, C, n_split, window, mode;
  int S_loc, Wp;           // strided: shard rows per slot, ranks of layout
  int gu, HG;              // query heads of a unit, units per KV head
  int rec;                 // floats per unit record, a multiple of 4
  float scale;
};

// One tile of a walk: rows [row0, row0 + n) of the pool or shard; row r
// holds position pos0 + r * pstep.
struct TileRef {
  size_t row0;
  int n, pos0;
};

// Floats of a unit record: o (g, D), m (g), l (g), padded to 16 bytes.
__host__ __device__ inline int rec_floats(int g, int D) {
  return (g * D + 2 * g + 3) / 4 * 4;
}

// Query heads of a unit: the largest divisor of g with gu * D <= 1024.
__host__ __device__ inline int heads_per_unit(int g, int D) {
  int gu = g;
  while (gu > 1 && (gu * D > 1024 || g % gu != 0)) --gu;
  return gu;
}

template <typename T, int D>
size_t smem_bytes(int g) {
  return sizeof(T) * NST * 2 * TR * D          // NST stages of K and V
         + sizeof(T) * g * D                   // q of the g heads
         + sizeof(int) * 2 * LIST_CAP          // owned entries (paged)
         + sizeof(float) * NW * g * (D + 2)    // the warps' states
         + sizeof(float) * rec_floats(g, D)    // the unit's record
         + sizeof(void*) * 2 * NT              // the peers' table copies
         + sizeof(int) * (NW + 2);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every committed group but the newest NST - 1 has landed
__device__ __forceinline__ void cp_async_wait_tile() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NST - 1));
}

// N consecutive T from shared memory into floats, in one load.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float* f) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES == 32) {
    load_f<T, N / 2>(p, f);
    load_f<T, N / 2>(p + N / 2, f + N / 2);
  } else if constexpr (BYTES == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(t[j]);
  } else if constexpr (BYTES == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(t[j]);
  } else if constexpr (BYTES == 4) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(t[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(p[j]);
  }
}

template <typename T, int D>
struct Smem {
  T* stage;      // [NST][2][TR][D]: stage, K or V, row, d
  T* qs;         // [gu][D] q of the unit's heads
  int* lc;       // [LIST_CAP] table column of an owned entry (paged)
  int* lb;       // [LIST_CAP] its block within the rank's shard (paged)
  float* ws;     // [NW][gu][D + 2]
  float* rec;    // [rec]
  void** tab;    // [2 * NT] the W inbox and flag bases (FUSED)
  int* misc;     // [NW + 2]: warp counts, last-split flag, epoch

  __device__ Smem(unsigned char* p, int g, int rec_n) {
    stage = reinterpret_cast<T*>(p);
    qs = stage + NST * 2 * TR * D;
    lc = reinterpret_cast<int*>(qs + g * D);
    lb = lc + LIST_CAP;
    ws = reinterpret_cast<float*>(lb + LIST_CAP);
    rec = ws + NW * g * (D + 2);
    tab = reinterpret_cast<void**>(rec + rec_n);
    misc = reinterpret_cast<int*>(tab + 2 * NT);
  }
};

// Fold n partials (o, m, l), m in log2 units, into one: m = max m_i,
// every partial scaled by 2^(m_i - m) (independent exponentials), summed
// in index order.
// part(i) gives partial i's o at this element, m and l.
template <class Part>
__device__ __forceinline__ void fold_n(int n, Part part, float& o, float& m,
                                       float& l) {
  float mi, li;
  m = NEG;
  for (int i = 0; i < n; ++i) {
    part(i, mi, li);
    m = fmaxf(m, mi);
  }
  o = 0.f;
  l = 0.f;
  for (int i = 0; i < n; ++i) {
    const float oi = part(i, mi, li);
    const float c = exp2f(mi - m);     // 0 for an empty partial
    o = fmaf(oi, c, o);
    l = fmaf(li, c, l);
  }
}

// Part 1 of item (unit u, split sp): the fp32 record (o, m, l) of the
// unit's gu query heads over the tiles of the split's walk, into S.rec.
// Returns (block-uniform) whether this block holds the unit's record
// folded over every split, i.e. whether it finishes the unit. `P`
// (FUSED, a block's first item): the launch's epoch (into S.misc[NW + 1],
// by thread 0) and the peers' tables (into S.tab) are asked for while
// the first tiles are in flight and stored after the walk.
template <class Walk, typename T, int D, int G>
__device__ bool part1(const Args& a, const Smem<T, D>& S, int u, int sp,
                      symm::Peers* P) {
  constexpr int DL = D / 32;                 // elements per lane
  constexpr int RPW = TR / NW;               // rows of a tile per warp
  constexpr int RB = G <= 16 ? RPW : 1;     // rows scored at once
  constexpr int CPR = D * (int)sizeof(T) / 16;   // 16 B copies per row
  constexpr int VEC = 16 / (int)sizeof(T);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = a.gu;                        // the unit's query heads
  const int ups = a.KVH * a.HG;              // units per slot
  const int lr = u / (a.B * ups);
  const int b = (u / ups) % a.B, hu = u % ups, h = hu / a.HG;
  const T* kp = static_cast<const T*>(a.K.p[lr]);
  const T* vp = static_cast<const T*>(a.V.p[lr]);
  // scores in log2 units: the records keep m in them too (exp2f is one
  // MUFU op); PARTIAL converts m back to natural units
  const float sl2 = a.scale * 1.4426950408889634f;

  const int cl = static_cast<const int*>(a.CL.p[lr])[b];
  // the group's heads: hu * g = h * (H / KVH) + (hu % HG) * g
  const T* qp = static_cast<const T*>(a.Q.p[lr]) +
                ((size_t)b * a.H + (size_t)hu * g) * D;
  const Walk walk(a, S.lc, S.lb, S.misc, lr, b, sp, cl);

  // stream the walk's K and V rows through NST staged tiles, NST - 1 in
  // flight ahead of the one being scored
  const int n_tiles = walk.tiles();
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const TileRef tr = walk.tile(t);
      T* st = S.stage + (size_t)(t % NST) * 2 * TR * D;
      for (int i = tid; i < 2 * tr.n * CPR; i += NT) {
        const bool kv = i >= tr.n * CPR;       // CPR: a power of two
        const int rem = kv ? i - tr.n * CPR : i;
        const int r = rem / CPR, ch = rem % CPR;
        const T* src = (kv ? vp : kp) +
                       ((tr.row0 + r) * a.KVH + h) * D + ch * VEC;
        cp_async16(st + ((size_t)kv * TR + r) * D + ch * VEC, src);
      }
    }
    cp_async_commit();             // one group per tile, empty past the end
  };
  for (int i = tid; i < g * D / VEC; i += NT)       // q, with tile 0
    cp_async16(S.qs + i * VEC, qp + i * VEC);
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) issue(t);
  // the epoch and the peers' tables are asked for now, while the tiles
  // are in flight, and read after the walk
  unsigned long long ticket = 0;
  symm::TableEntries te{nullptr, nullptr};
  if (P != nullptr) {
    if (tid == 0) ticket = symm::epoch_ticket(P->state);
    te = symm::table_entries(*P);
  }
  __syncthreads();                 // the last item is done with S
  // q of the g heads (G >= g: heads g.. are zeros and never stored),
  // this lane's D / 32 elements each, and the running softmax state
  float q[G][DL], acc[G][DL], m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = NEG;
    l[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < DL; ++j) {
      q[gi][j] = 0.f;
      acc[gi][j] = 0.f;
    }
  }
  for (int t = 0; t < n_tiles; ++t) {
    issue(t + NST - 1);
    cp_async_wait_tile();                // tile t has landed (this thread)
    __syncthreads();                     // ... for every thread
    if (t == 0) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        if (gi < g) load_f<T, DL>(S.qs + gi * D + lane * DL, q[gi]);
    }
    const TileRef tr = walk.tile(t);
    const T* ks = S.stage + (size_t)(t % NST) * 2 * TR * D;
    const T* vs = ks + TR * D;
    // this warp's rows warp, warp + NW, ..., RB at a time: all RB x G
    // dots first (independent shuffle chains), then one online-softmax
    // step per head over the RB rows
#pragma unroll
    for (int i0 = 0; i0 < RPW; i0 += RB) {
      float s[RB][G], vf[RB][DL];
      bool ok[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = warp + (i0 + i) * NW;
        const int pos = tr.pos0 + r * walk.pstep;
        ok[i] = r < tr.n && pos < cl &&
                (a.window <= 0 || pos >= cl - a.window);
        float kf[DL];
        if (r < tr.n) {
          load_f<T, DL>(ks + r * D + lane * DL, kf);
          load_f<T, DL>(vs + r * D + lane * DL, vf[i]);
        } else {
#pragma unroll
          for (int j = 0; j < DL; ++j) kf[j] = vf[i][j] = 0.f;
        }
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          float d = 0.f;
#pragma unroll
          for (int j = 0; j < DL; ++j) d = fmaf(q[gi][j], kf[j], d);
          s[i][gi] = d;
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) s[i][gi] = warp_sum(s[i][gi]) * sl2;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float mx = NEG;
#pragma unroll
        for (int i = 0; i < RB; ++i)
          if (ok[i]) mx = fmaxf(mx, s[i][gi]);
        const float mn = fmaxf(m[gi], mx);
        const float corr = exp2f(m[gi] - mn);  // 1 while nothing is seen
        float p[RB], sum = 0.f;
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          p[i] = ok[i] ? exp2f(s[i][gi] - mn) : 0.f;
          sum += p[i];
        }
#pragma unroll
        for (int j = 0; j < DL; ++j) {
          float o = acc[gi][j] * corr;
#pragma unroll
          for (int i = 0; i < RB; ++i) o = fmaf(p[i], vf[i][j], o);
          acc[gi][j] = o;
        }
        l[gi] = l[gi] * corr + sum;
        m[gi] = mn;
      }
    }
    __syncthreads();                     // the stage is free for reuse
  }
  asm volatile("cp.async.wait_all;\n" ::);   // q copies of an empty walk
  if (P != nullptr) {
    if (tid == 0) S.misc[NW + 1] = symm::epoch_of(P->state, ticket);
    symm::cache_tables(*P, S.tab, te);
  }

  // fold the warps' states, in warp order, into the record
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi >= g) break;
    float* w = S.ws + ((size_t)warp * g + gi) * (D + 2);
#pragma unroll
    for (int j = 0; j < DL; ++j) w[lane * DL + j] = acc[gi][j];
    if (lane == 0) {
      w[D] = m[gi];
      w[D + 1] = l[gi];
    }
  }
  __syncthreads();
  for (int i = tid; i < g * D; i += NT) {
    const int gi = i / D, d = i % D;
    float o, mm, ll;
    fold_n(NW, [&](int w, float& mw, float& lw) {
      const float* p = S.ws + ((size_t)w * g + gi) * (D + 2);
      mw = p[D];
      lw = p[D + 1];
      return p[d];
    }, o, mm, ll);
    S.rec[i] = o;
    if (d == 0) {
      S.rec[g * D + gi] = mm;
      S.rec[g * D + g + gi] = ll;
    }
  }
  __syncthreads();
  if (a.n_split == 1) return true;

  // several splits: leave the record, the last to arrive folds them all
  const int rn = g * D + 2 * g;
  float* mine = a.split_rec + ((size_t)u * a.n_split + sp) * a.rec;
  for (int i = tid; i < rn; i += NT) mine[i] = S.rec[i];
  __syncthreads();
  if (tid == 0) {                  // the block's stores, then the count
    __threadfence();
    const unsigned old = atomicAdd(a.cnt + u, 1u);
    const bool last = old == (unsigned)a.n_split - 1u;
    if (last) {
      a.cnt[u] = 0u;
      __threadfence();
    }
    S.misc[NW] = last;
  }
  __syncthreads();
  if (!S.misc[NW]) return false;
  const float* recs = a.split_rec + (size_t)u * a.n_split * a.rec;
  for (int i = tid; i < g * D; i += NT) {
    const int gi = i / D, d = i % D;
    float o, mm, ll;
    fold_n(a.n_split, [&](int s_, float& ms, float& ls) {
      const float* p = recs + (size_t)s_ * a.rec;
      ms = __ldcg(p + g * D + gi);
      ls = __ldcg(p + g * D + g + gi);
      return __ldcg(p + i);
    }, o, mm, ll);
    S.rec[i] = o;
    if (d == 0) {
      S.rec[g * D + gi] = mm;
      S.rec[g * D + g + gi] = ll;
    }
  }
  __syncthreads();
  return true;
}

// The body of a decode kernel. Grid: items = n_local * B * KVH * HG *
// n_split, walked by gridDim.x blocks (item = blockIdx.x + i * gridDim.x, unit =
// item / n_split); FUSED then walks the units the same way for the
// combine.
template <class Walk, typename T, int D, int G>
__device__ void run(const Args& a, const symm::Peers& P0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g = a.gu;
  const int ups = a.KVH * a.HG;              // units per slot
  const Smem<T, D> S(smem_raw, g, a.rec);
  symm::Peers P = P0;
  const bool fused = a.mode == FUSED;
  const int tid = threadIdx.x;
  const int units = a.n_local * a.B * ups;
  const int items = units * a.n_split;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int u = it / a.n_split;
    if (!part1<Walk, T, D, G>(a, S, u, it % a.n_split,
                              fused && it == (int)blockIdx.x ? &P
                                                             : nullptr))
      continue;
    const int lr = u / (a.B * ups), bh = u % (a.B * ups);
    const int b = bh / ups, hu = bh % ups;
    const size_t row0 = ((size_t)lr * a.B + b) * a.H + (size_t)hu * g;
    if (a.mode == NORMAL) {
      T* o = static_cast<T*>(a.out) + row0 * D;
      for (int i = tid; i < g * D; i += NT)
        o[i] = from_f<T>(S.rec[i] / fmaxf(S.rec[g * D + g + i / D], 1e-30f));
    } else if (a.mode == PARTIAL) {
      float* o = static_cast<float*>(a.out) + row0 * (D + 2);
      for (int i = tid; i < g * D; i += NT) {
        const int gi = i / D, d = i % D;
        o[gi * (D + 2) + d] = S.rec[i];
        if (d == 0) {
          const float mm = S.rec[g * D + gi];   // log2 units; NEG stays
          o[gi * (D + 2) + D] = mm <= NEG / 2 ? NEG
                                              : mm * 0.6931471805599453f;
          o[gi * (D + 2) + D + 1] = S.rec[g * D + g + gi];
        }
      }
    } else {
      // push the record into slot `rank` of every inbox as LL lines
      const unsigned e = (unsigned)S.misc[NW + 1];
      P.epoch = e;
      const int rank = a.R.r[lr];
      const float2* src = reinterpret_cast<const float2*>(S.rec);
      const int lines = a.rec / 2;
      for (int dst = 0; dst < P.W; ++dst) {
        uint4* d = reinterpret_cast<uint4*>(P.slot(dst, rank)) +
                   (size_t)bh * lines;
        for (int i = tid; i < lines; i += NT)
          symm::ll_store(d + i, src[i].x, src[i].y, e);
      }
    }
  }
  if (!fused) return;
  if (blockIdx.x >= items) {               // took no item: take the epoch
    if (tid == 0) S.misc[NW + 1] = symm::take_epoch(P.state);
    symm::cache_tables(P, S.tab);
    __syncthreads();
  }
  P.epoch = (unsigned)S.misc[NW + 1];
  // combine: every source's record of this block's units, in rank order,
  // each word read once its LL line carries this launch's epoch
  const int lines = a.rec / 2;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int lr = u / (a.B * ups), bh = u % (a.B * ups);
    const int b = bh / ups, hu = bh % ups;
    const int rank = a.R.r[lr];
    T* o = static_cast<T*>(a.out) +
           (((size_t)lr * a.B + b) * a.H + (size_t)hu * g) * D;
    for (int i4 = tid; i4 < g * D / 4; i4 += NT) {
      const int gi = i4 * 4 / D;
      const int im = g * D + gi, il = g * D + g + gi;   // m and l words
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, mm = NEG, ll = 0.f;
      // SB sources at a time: every line requested before any is checked
      constexpr int SB = 4;
      for (int s0 = 0; s0 < P.W; s0 += SB) {
        const uint4* src[SB];
        uint4 v[SB][4];          // o[4 i4 .. +1], o[.. +3], m line, l line
#pragma unroll
        for (int j = 0; j < SB; ++j) {
          if (s0 + j >= P.W) break;
          src[j] = reinterpret_cast<const uint4*>(P.slot(rank, s0 + j)) +
                   (size_t)bh * lines;
          v[j][0] = symm::ll_peek(src[j] + 2 * i4);
          v[j][1] = symm::ll_peek(src[j] + 2 * i4 + 1);
          v[j][2] = symm::ll_peek(src[j] + im / 2);
          v[j][3] = symm::ll_peek(src[j] + il / 2);
        }
        // until every line carries this launch's epoch, ask for all of
        // them again (one round trip a round, not one a line)
        auto settled = [&] {
          bool ok = true;
#pragma unroll
          for (int j = 0; j < SB; ++j)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              ok = ok && (s0 + j >= P.W || (v[j][k].y == P.epoch &&
                                            v[j][k].w == P.epoch));
          return ok;
        };
        symm::Spin spin;
        while (!settled()) {
          spin.pause();
#pragma unroll
          for (int j = 0; j < SB; ++j) {
            if (s0 + j >= P.W) break;
            v[j][0] = symm::ll_peek(src[j] + 2 * i4);
            v[j][1] = symm::ll_peek(src[j] + 2 * i4 + 1);
            v[j][2] = symm::ll_peek(src[j] + im / 2);
            v[j][3] = symm::ll_peek(src[j] + il / 2);
          }
        }
#pragma unroll
        for (int j = 0; j < SB; ++j) {
          if (s0 + j >= P.W) break;
          // fold source s0 + j in (rank order, online rescaling)
          const float ms = __uint_as_float(im % 2 ? v[j][2].z : v[j][2].x);
          const float ls = __uint_as_float(il % 2 ? v[j][3].z : v[j][3].x);
          const float m_new = fmaxf(mm, ms);
          const float ca = exp2f(mm - m_new), cb = exp2f(ms - m_new);
          acc[0] = acc[0] * ca + __uint_as_float(v[j][0].x) * cb;
          acc[1] = acc[1] * ca + __uint_as_float(v[j][0].z) * cb;
          acc[2] = acc[2] * ca + __uint_as_float(v[j][1].x) * cb;
          acc[3] = acc[3] * ca + __uint_as_float(v[j][1].z) * cb;
          ll = ll * ca + ls * cb;
          mm = m_new;
        }
      }
      const float inv = 1.f / fmaxf(ll, 1e-30f);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i4 * 4 + j] = from_f<T>(acc[j] * inv);
    }
  }
}

// ---- host side: the kernel for (T, D, g), its launch and occupancy.
// `K` names the file's kernel: K::fn<T, D, G>() is its address.

// The kernel for g query heads per unit: G, the smallest power of two
// >= g (at most 1024 / D), and G's index.
template <class K, typename T, int D>
const void* kernel_for(int g, int* idx) {
  static_assert(D == 32 || D == 64 || D == 128 || D == 256, "head dim");
  *idx = g <= 1 ? 0 : g <= 2 ? 1 : g <= 4 ? 2 : g <= 8 ? 3 : g <= 16 ? 4 : 5;
  switch (*idx) {
    case 0: return K::template fn<T, D, 1>();
    case 1: return K::template fn<T, D, 2>();
    case 2: return K::template fn<T, D, 4>();
    case 3:
      if constexpr (D <= 128) return K::template fn<T, D, 8>();
      return nullptr;
    case 4:
      if constexpr (D <= 64) return K::template fn<T, D, 16>();
      return nullptr;
    default:
      if constexpr (D <= 32) return K::template fn<T, D, 32>();
      return nullptr;
  }
}

// kernel_for's kernel with its dynamic shared memory allowed, or null.
template <class K, typename T, int D>
const void* ready_kernel(int g, size_t smem, int* err) {
  static size_t allowed[6] = {0, 0, 0, 0, 0, 0};   // per G
  int idx = 0;
  const void* fn = kernel_for<K, T, D>(g, &idx);
  *err = fn == nullptr ? (int)cudaErrorInvalidValue : 0;
  if (fn != nullptr && smem > allowed[idx]) {
    *err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (*err == 0) allowed[idx] = smem;
  }
  return *err == 0 ? fn : nullptr;
}

template <class K, typename T, int D>
int launch_d(const Args& a, int grid, const symm::Peers& P,
             cudaStream_t stream) {
  const int g = a.gu;
  const size_t smem = smem_bytes<T, D>(g);
  int err = 0;
  const void* fn = ready_kernel<K, T, D>(g, smem, &err);
  if (fn == nullptr) return err;
  Args av = a;
  symm::Peers pv = P;
  void* args[] = {(void*)&av, (void*)&pv};
  if (a.mode == FUSED)
    return (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(NT), args,
                                            smem, stream);
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(NT), args, smem, stream);
}

template <class K, typename T, int D>
int occupancy_d(int g, int* out) {
  const size_t smem = smem_bytes<T, D>(g);
  int err = 0;
  const void* fn = ready_kernel<K, T, D>(g, smem, &err);
  if (fn == nullptr) return err;
  return symm::blocks_per_sm(fn, NT, smem, out);
}

// One launch of kernel K for dtype (0 = float32, 1 = bfloat16) and head
// dim D; with `occ`, the blocks of it that fit one SM instead.
template <class K>
int dispatch(int dtype, int D, const Args& a, int grid, const symm::Peers& P,
             cudaStream_t s, int* occ = nullptr) {
  const int g = a.gu;
#define FD_BY_DIM(T)                                                      \
  switch (D) {                                                            \
    case 32: return occ ? occupancy_d<K, T, 32>(g, occ)                   \
                        : launch_d<K, T, 32>(a, grid, P, s);              \
    case 64: return occ ? occupancy_d<K, T, 64>(g, occ)                   \
                        : launch_d<K, T, 64>(a, grid, P, s);              \
    case 128: return occ ? occupancy_d<K, T, 128>(g, occ)                 \
                         : launch_d<K, T, 128>(a, grid, P, s);            \
    case 256: return occ ? occupancy_d<K, T, 256>(g, occ)                 \
                         : launch_d<K, T, 256>(a, grid, P, s);            \
    default: return (int)cudaErrorInvalidValue;                           \
  }
  if (dtype == 0) { FD_BY_DIM(float) }
  if (dtype == 1) { FD_BY_DIM(__nv_bfloat16) }
#undef FD_BY_DIM
  return (int)cudaErrorInvalidValue;
}

// The kernel's resources for head dim D, g query heads per unit
// (heads_per_unit) and dtype: the blocks of it that fit on one SM of the
// current device.
template <class K>
int blocks_per_sm(int D, int g, int dtype, int* out) {
  if (g <= 0 || g * D > 1024) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.H = g;
  a.KVH = 1;
  a.gu = g;
  a.HG = 1;
  symm::Peers P = {};
  return dispatch<K>(dtype, D, a, 0, P, nullptr, out);
}

// The fields both kernels fill alike; false if an operand is misaligned.
inline bool common_args(Args& a, const void* const* q,
                        const void* const* kp, const void* const* vp,
                        const void* const* cur_len, const int* ranks,
                        int n_local, void* split_rec, void* cnt, void* out,
                        int B, int H, int KVH, int D, int C, int n_split,
                        float scale, int window, int mode) {
  for (int i = 0; i < n_local; ++i) {
    a.Q.p[i] = q[i];
    a.K.p[i] = kp[i];
    a.V.p[i] = vp[i];
    a.CL.p[i] = cur_len[i];
    a.R.r[i] = ranks[i];
    if ((reinterpret_cast<uintptr_t>(kp[i]) |
         reinterpret_cast<uintptr_t>(vp[i]) |
         reinterpret_cast<uintptr_t>(q[i])) % 16 != 0)
      return false;
  }
  a.out = out;
  a.split_rec = static_cast<float*>(split_rec);
  a.cnt = static_cast<unsigned*>(cnt);
  a.n_local = n_local;
  a.B = B;
  a.H = H;
  a.KVH = KVH;
  a.C = C;
  a.n_split = n_split;
  a.window = window;
  a.mode = mode;
  a.gu = heads_per_unit(H / KVH, D);
  a.HG = H / KVH / a.gu;
  a.rec = rec_floats(a.gu, D);
  a.scale = scale;
  return true;
}

// Argument checks both kernels make (true: the launch may go ahead).
inline bool args_ok(int B, int H, int KVH, int D, int C, int n_split,
                    int n_local, int grid, int mode, void* split_rec,
                    void* cnt) {
  return B > 0 && KVH > 0 && H >= KVH && H % KVH == 0 && D > 0 &&
         C > 0 && n_split > 0 && n_local > 0 &&
         n_local <= symm::MAX_RANKS && grid > 0 && mode >= 0 && mode <= 2 &&
         (n_split == 1 || (split_rec != nullptr && cnt != nullptr));
}

// FUSED's symmetric-buffer checks: room for the W records of B * KVH *
// HG units as LL lines (8 bytes a word).
inline bool fused_ok(const symm::Peers& P, const Args& a, int n_local) {
  return P.W <= NT && P.W >= n_local && P.state != nullptr &&
         P.slot_bytes >= (size_t)a.B * a.KVH * a.HG * a.rec * 8 &&
         P.slot_bytes % 16 == 0;
}

}  // namespace fd
