// Flash decode over a contiguous, strided, sequence-sharded KV cache
// (the paper's Algorithm 4) for Hopper (sm_90a), at W = 1 and over W
// ranks.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (`_fd_kernel` / `flash_decode_fused`). That kernel is one serial
// program per rank: for every (slot, KV head) it DMAs blk-row blocks of
// the rank's strided shard (local slot j holds global position
// j * W + rank) into VMEM, keeps an online softmax, packs a (B, H, D+2)
// partial, pushes it by remote DMA into every rank's inbox and folds the
// W sources in rank order; at W = 1 the single source is copied locally.
// It takes one scalar cur_len and asserts that blk divides S_loc.
//
// Here, in two launches (this kernel's design predates the paged
// kernel's single-launch one, csrc/flash_decode_paged.cu):
//   1. Part 1, grid (B, KVH, n_local * n_split): a block takes one slot,
//      one KV head, one local rank and one share of the shard's tiles of
//      TILE local slots. It walks only the local slots j whose position
//      j * W + rank lies below cur_len[b] (per slot) and, with a window,
//      at or above cur_len[b] - window; the ragged last tile is masked,
//      so S_loc needs no divisibility. It stages K and V rows of head h
//      through shared memory and runs the fp32 online softmax of the
//      g = H / KVH query heads, writing (o, m, l) per split.
//   2. Part 2 (mode): NORMAL at W = 1; PARTIAL returns each rank's
//      (o, m, l) for the bsp / ring / rs_ag combines; FUSED pushes every
//      rank's partial to every rank and combines the sources in rank
//      order inside one cooperative launch per device (symm.cuh; the
//      epoch is read from the card's word, so a CUDA graph can replay
//      the call).
//
// What bounds it on the H100: the same stream of K/V bytes as the paged
// kernel -- each rank reads its own cur_len / W positions of every slot,
// 2 * KVH * D * sizeof(T) bytes each -- plus the W partials moved, at
// about one multiply-add per byte: memory (3.35 TB/s), not the tensor
// cores. Every needed K/V element is read once and shared by the g query
// heads of its KV head; splits keep a small batch from leaving SMs idle.
#include "fd_common.cuh"

namespace {

using fd::NEG;
using fd::fold;
using fd::from_f;
using fd::to_f;
using fd::warp_max;
using fd::warp_sum;
using fd::FUSED;
using fd::NORMAL;
using fd::PARTIAL;

constexpr int NT = 128;          // threads of a Part 1 block
constexpr int ACCN = 8;          // accumulator registers: g * D <= NT * ACCN

// Shared memory of a Part 1 block, in floats.
inline size_t part1_smem(int g, int D, int tile) {
  return sizeof(float) * ((size_t)g * D + (size_t)tile * (D + 1) +
                          (size_t)tile * D + (size_t)g * tile + 3 * (size_t)g);
}

// Online-softmax state of one Part 1 block: q, the staged tile, the
// scores and (m, l) in shared memory; the P @ V accumulator in registers.
template <int D>
struct Online {
  float* qs;    // (g, D)
  float* ks;    // (tile, D + 1): padded rows
  float* vs;    // (tile, D)
  float* ss;    // (g, tile): scores, then p
  float* ms;    // (g,) running max
  float* ls;    // (g,) running sum
  float* cs;    // (g,) this step's correction
  int g, tile;
  float acc[ACCN];

  __device__ Online(float* smem, int g_, int tile_) : g(g_), tile(tile_) {
    qs = smem;
    ks = qs + g * D;
    vs = ks + tile * (D + 1);
    ss = vs + tile * D;
    ms = ss + g * tile;
    ls = ms + g;
    cs = ls + g;
#pragma unroll
    for (int j = 0; j < ACCN; ++j) acc[j] = 0.f;
  }

  // q: the (g, D) query rows of this block's KV head
  template <typename T>
  __device__ void init(const T* q) {
    for (int i = threadIdx.x; i < g * D; i += NT) qs[i] = to_f(q[i]);
    if ((int)threadIdx.x < g) {
      ms[threadIdx.x] = NEG;
      ls[threadIdx.x] = 0.f;
    }
  }

  // One tile of n <= tile rows: row t's K (and V) D-vector starts at
  // kp + off(t) (vp + off(t)); valid(t) says whether its position counts.
  template <typename T, class Off, class Valid>
  __device__ void step(const T* __restrict__ kp, const T* __restrict__ vp,
                       int n, Off off, Valid valid, float scale) {
    __syncthreads();                     // last step done with ks/vs/ss
    for (int i = threadIdx.x; i < n * D; i += NT) {
      const int t = i / D, d = i % D;
      const size_t o = off(t) + d;
      ks[t * (D + 1) + d] = to_f(kp[o]);
      vs[i] = to_f(vp[o]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < g * n; i += NT) {
      const int gi = i / n, t = i % n;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        s = fmaf(qs[gi * D + d], ks[t * (D + 1) + d], s);
      ss[gi * tile + t] = valid(t) ? s * scale : NEG;
    }
    __syncthreads();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int gi = warp; gi < g; gi += NT / 32) {
      float mx = NEG;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, ss[gi * tile + t]);
      mx = warp_max(mx);
      const float m_old = ms[gi];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = m_new <= NEG / 2 ? 0.f : m_new;
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float s = ss[gi * tile + t];
        const float p = s <= NEG / 2 ? 0.f : expf(s - m_safe);
        ss[gi * tile + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = m_old <= NEG / 2 ? 0.f : expf(m_old - m_safe);
        cs[gi] = corr;
        ls[gi] = ls[gi] * corr + sum;
        ms[gi] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ACCN; ++j) {
      const int i = threadIdx.x + j * NT;
      if (i < g * D) {
        const int gi = i / D, d = i % D;
        float a = acc[j] * cs[gi];
        for (int t = 0; t < n; ++t)
          a = fmaf(ss[gi * tile + t], vs[t * D + d], a);
        acc[j] = a;
      }
    }
  }

  // out: the block's g rows of the (.., H, D + 2) partial scratch
  __device__ void store(float* out) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ACCN; ++j) {
      const int i = threadIdx.x + j * NT;
      if (i < g * D) out[(i / D) * (D + 2) + i % D] = acc[j];
    }
    if ((int)threadIdx.x < g) {
      out[threadIdx.x * (D + 2) + D] = ms[threadIdx.x];
      out[threadIdx.x * (D + 2) + D + 1] = ls[threadIdx.x];
    }
  }
};


// Fold the n_split partials of row (b, hh) of one local rank, at head
// dim d. part: that rank's (B, n_split, H, D + 2) scratch.
template <int D>
__device__ __forceinline__ void fold_splits(const float* __restrict__ part,
                                            int b, int hh, int H,
                                            int n_split, int d, float& o,
                                            float& m, float& l) {
  o = 0.f;
  m = NEG;
  l = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* p = part + (((size_t)b * n_split + s) * H + hh) * (D + 2);
    fold(o, m, l, p[d], p[D], p[D + 1]);
  }
}

// grid (B * H, n_local), D threads
template <typename T, int D>
__global__ void fd_normal(const float* __restrict__ part, T* __restrict__ o,
                          int B, int H, int n_split) {
  const int bh = blockIdx.x, lr = blockIdx.y, d = threadIdx.x;
  float acc_o, acc_m, acc_l;
  fold_splits<D>(part + (size_t)lr * B * n_split * H * (D + 2), bh / H,
                 bh % H, H, n_split, d, acc_o, acc_m, acc_l);
  o[((size_t)lr * B * H + bh) * D + d] =
      from_f<T>(acc_o / fmaxf(acc_l, 1e-30f));
}

// grid (B * H, n_local), D threads; out (n_local, B, H, D + 2) fp32
template <int D>
__global__ void fd_fold(const float* __restrict__ part,
                        float* __restrict__ out, int B, int H, int n_split) {
  const int bh = blockIdx.x, lr = blockIdx.y, d = threadIdx.x;
  float acc_o, acc_m, acc_l;
  fold_splits<D>(part + (size_t)lr * B * n_split * H * (D + 2), bh / H,
                 bh % H, H, n_split, d, acc_o, acc_m, acc_l);
  float* row = out + ((size_t)lr * B * H + bh) * (D + 2);
  row[d] = acc_o;
  if (d == 0) {
    row[D] = acc_m;
    row[D + 1] = acc_l;
  }
}

// Cooperative grid (n_chunk, n_local), D threads (>= W). Block (j, lr)
// owns rows [j * rows, (j + 1) * rows) of the B * H rows of local rank
// R.r[lr]. Inbox slot layout: (B * H, D + 2) fp32. The epoch comes
// from the card's word in device memory (symm.cuh take_epoch).
template <typename T, int D>
__global__ void fd_comm(const float* __restrict__ part, T* __restrict__ o,
                        symm::Ranks R, symm::Peers P0, int B, int H,
                        int n_split, int rows) {
  __shared__ unsigned epoch;
  if (threadIdx.x == 0) epoch = symm::take_epoch(P0.state);
  __syncthreads();
  symm::Peers P = P0;
  P.epoch = epoch;
  const int j = blockIdx.x, lr = blockIdx.y, d = threadIdx.x;
  const int rank = R.r[lr];
  const int row0 = j * rows, row1 = min(B * H, row0 + rows);
  const float* mine = part + (size_t)lr * B * n_split * H * (D + 2);
  // fold the splits and push this rank's rows to every rank
  for (int bh = row0; bh < row1; ++bh) {
    float acc_o, acc_m, acc_l;
    fold_splits<D>(mine, bh / H, bh % H, H, n_split, d, acc_o, acc_m,
                   acc_l);
    for (int dst = 0; dst < P.W; ++dst) {
      float* row = reinterpret_cast<float*>(P.slot(dst, rank)) +
                   (size_t)bh * (D + 2);
      row[d] = acc_o;
      if (d == 0) {
        row[D] = acc_m;
        row[D + 1] = acc_l;
      }
    }
  }
  symm::publish(P, rank, j);
  symm::wait_all(P, rank, j);
  // combine the sources in rank order
  for (int bh = row0; bh < row1; ++bh) {
    float acc_o = 0.f, acc_m = NEG, acc_l = 0.f;
    for (int s = 0; s < P.W; ++s) {
      const float* row = reinterpret_cast<const float*>(P.slot(rank, s)) +
                         (size_t)bh * (D + 2);
      fold(acc_o, acc_m, acc_l, __ldcg(row + d), __ldcg(row + D),
           __ldcg(row + D + 1));
    }
    o[((size_t)lr * B * H + bh) * D + d] =
        from_f<T>(acc_o / fmaxf(acc_l, 1e-30f));
  }
}

// Part 2 launch for `mode`. out: (n_local, B, H, D) in T for NORMAL and
// FUSED, fp32 (n_local, B, H, D + 2) for PARTIAL. FUSED runs `chunks`
// blocks per local rank (chunks <= P.n_chunk, the flags per source).
template <typename T, int D>
int launch_part2(int mode, const float* part, void* out, int n_local, int B,
                 int H, int n_split, int chunks, symm::Ranks R,
                 const symm::Peers& P, cudaStream_t stream) {
  if (mode == NORMAL) {
    fd_normal<T, D><<<dim3(B * H, n_local), D, 0, stream>>>(
        part, static_cast<T*>(out), B, H, n_split);
    return (int)cudaGetLastError();
  }
  if (mode == PARTIAL) {
    fd_fold<D><<<dim3(B * H, n_local), D, 0, stream>>>(
        part, static_cast<float*>(out), B, H, n_split);
    return (int)cudaGetLastError();
  }
  if (mode != FUSED || P.W > D || chunks <= 0 || chunks > P.n_chunk)
    return (int)cudaErrorInvalidValue;
  const int rows = (B * H + chunks - 1) / chunks;
  T* o = static_cast<T*>(out);
  int Bv = B, Hv = H, ns = n_split, rv = rows;
  symm::Peers Pv = P;
  void* args[] = {(void*)&part, (void*)&o, (void*)&R, (void*)&Pv,
                  (void*)&Bv, (void*)&Hv, (void*)&ns, (void*)&rv};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)fd_comm<T, D>, dim3(chunks, n_local), dim3(D), args,
      0, stream);
}

constexpr int TILE = 16;         // local slots staged per step

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fd_strided_partial(symm::Ptrs Q, symm::Ptrs K, symm::Ptrs V, symm::Ptrs CL,
                   symm::Ranks R, int W, float* __restrict__ part, int B,
                   int H, int KVH, int S_loc, int n_split, float scale,
                   int window) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int lr = blockIdx.z / n_split, sp = blockIdx.z % n_split;
  const int g = H / KVH;
  const int rank = R.r[lr];
  const T* q = static_cast<const T*>(Q.p[lr]);
  const T* kp = static_cast<const T*>(K.p[lr]);
  const T* vp = static_cast<const T*>(V.p[lr]);
  const int cl = static_cast<const int*>(CL.p[lr])[b];

  // local slots with rank <= j*W + rank < cl (and >= cl - window)
  const int j_hi = cl > rank ? min(S_loc, (cl - rank + W - 1) / W) : 0;
  int j_lo = 0;
  if (window > 0 && cl - window > rank)
    j_lo = min((cl - window - rank + W - 1) / W, j_hi);
  const int t_lo = j_lo / TILE, t_hi = (j_hi + TILE - 1) / TILE;
  const int per = (t_hi - t_lo + n_split - 1) / n_split;
  const int my_lo = t_lo + sp * per;
  const int my_hi = min(t_hi, my_lo + per);

  Online<D> st(smem, g, TILE);
  st.init(q + ((size_t)b * H + h * g) * D);
  for (int t = my_lo; t < my_hi; ++t) {
    const int j0 = t * TILE;
    const int n = min(TILE, S_loc - j0);
    st.step(
        kp, vp, n,
        [&](int i) { return (((size_t)b * S_loc + j0 + i) * KVH + h) * D; },
        [&](int i) {
          const int pos = (j0 + i) * W + rank;
          return pos < cl && (window <= 0 || pos >= cl - window);
        },
        scale);
  }
  st.store(part + ((((size_t)lr * B + b) * n_split + sp) * H + h * g) *
                      (D + 2));
}

template <typename T, int D>
int launch(const symm::Ptrs& Q, const symm::Ptrs& K, const symm::Ptrs& V,
           const symm::Ptrs& CL, const symm::Ranks& R, int n_local, int W,
           float* part, void* out, int B, int H, int KVH, int S_loc,
           int n_split, float scale, int window, int mode, int chunks,
           const symm::Peers& P, cudaStream_t stream) {
  const int g = H / KVH;
  const size_t smem = part1_smem(g, D, TILE);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fd_strided_partial<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fd_strided_partial<T, D><<<dim3(B, KVH, n_local * n_split), NT, smem,
                             stream>>>(Q, K, V, CL, R, W, part, B, H, KVH,
                                       S_loc, n_split, scale, window);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_part2<T, D>(mode, part, out, n_local, B, H, n_split,
                                chunks, R, P, stream);
}

template <typename T>
int by_dim(int D, const symm::Ptrs& Q, const symm::Ptrs& K,
           const symm::Ptrs& V, const symm::Ptrs& CL, const symm::Ranks& R,
           int n_local, int W, float* part, void* out, int B, int H,
           int KVH, int S_loc, int n_split, float scale, int window,
           int mode, int chunks, const symm::Peers& P, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(Q, K, V, CL, R, n_local, W, part, out, B, H, KVH,
                           S_loc, n_split, scale, window, mode, chunks, P, s);
    case 64:
      return launch<T, 64>(Q, K, V, CL, R, n_local, W, part, out, B, H, KVH,
                           S_loc, n_split, scale, window, mode, chunks, P, s);
    case 128:
      return launch<T, 128>(Q, K, V, CL, R, n_local, W, part, out, B, H,
                            KVH, S_loc, n_split, scale, window, mode, chunks,
                            P, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch pair on one device for its n_local ranks (ids ranks[]) of a
// W-rank mesh. Per local rank: q (B, H, D); k/v shard (B, S_loc, KVH, D)
// contiguous, q's dtype, local slot j = global position j * W + rank;
// cur_len (B,) int32. part: fp32 scratch (n_local, B, n_split, H, D + 2).
// out: (n_local, B, H, D) in q's dtype for mode 0 (NORMAL, W = 1) and 2
// (FUSED), fp32 (n_local, B, H, D + 2) for mode 1 (PARTIAL). FUSED only:
// `chunks` blocks per rank, and the symmetric buffers as in
// fd_paged_launch (csrc/flash_decode_paged.cu). window <= 0 means no
// sliding window. dtype: 0 = float32, 1 = bfloat16. Returns the first
// cudaError_t (0 = launched).
extern "C" int fd_launch(const void* const* q, const void* const* kp,
                         const void* const* vp, const void* const* cur_len,
                         const int* ranks, int n_local, void* part,
                         void* out, int B, int H, int KVH, int D, int S_loc,
                         int n_split, float scale, int window, int dtype,
                         int mode, int chunks, const void* inbox_tab,
                         const void* flag_tab, void* state, int W,
                         int n_chunk, long long slot_bytes, long long half,
                         void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 ||
      (H / KVH) * D > NT * ACCN || S_loc <= 0 || n_split <= 0 ||
      n_local <= 0 || n_local > symm::MAX_RANKS || W < n_local)
    return (int)cudaErrorInvalidValue;
  symm::Ptrs Q, K, V, CL;
  symm::Ranks R;
  for (int i = 0; i < n_local; ++i) {
    Q.p[i] = q[i];
    K.p[i] = kp[i];
    V.p[i] = vp[i];
    CL.p[i] = cur_len[i];
    R.r[i] = ranks[i];
  }
  const symm::Peers P = symm::make_peers(inbox_tab, flag_tab, state, W,
                                         n_chunk, slot_bytes, half, n_local);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return by_dim<float>(D, Q, K, V, CL, R, n_local, W, p, out, B, H, KVH,
                         S_loc, n_split, scale, window, mode, chunks, P, s);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(D, Q, K, V, CL, R, n_local, W, p, out, B, H,
                                 KVH, S_loc, n_split, scale, window, mode,
                                 chunks, P, s);
  return (int)cudaErrorInvalidValue;
}
