// Pieces shared by the two flash-decode kernels (flash_decode_paged.cu,
// flash_decode.cu).
//
// Part 1 of both kernels is a grid of (slot, KV head, local rank x split)
// blocks; each block walks its share of the rank's KV rows in tiles,
// staging K and V through shared memory and running the online softmax
// of the g = H / KVH query heads of its KV head (struct Online). It
// writes an unnormalised fp32 partial (o, m, l) per split into a scratch
// (n_local, B, n_split, H, D + 2) that the wrapper allocates.
//
// Part 2 is one of three passes over that scratch:
//   fd_normal  W = 1: fold the splits and write o / max(l, 1e-30) in q's
//              dtype (a row with nothing to attend comes out as zeros);
//   fd_fold    fold the splits into the rank's partial (o, m, l), fp32
//              (n_local, B, H, D + 2): the local partial that the bsp,
//              ring and rs_ag schedules combine in torch code;
//   fd_comm    the paper's Algorithm 4 Part 2 (fused): fold the splits,
//              push the rank's (B, H, D + 2) partial into slot `rank` of
//              every rank's inbox with a flag per chunk of rows, then
//              wait for every source and combine them in rank order
//              0..W-1, so every rank's output is bit-identical. Launched
//              cooperatively over the device's local ranks (symm.cuh).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>

#include "symm.cuh"

namespace fd {

constexpr int NT = 128;          // threads of a Part 1 block
constexpr int ACCN = 8;          // accumulator registers: g * D <= NT * ACCN
constexpr float NEG = -FLT_MAX;  // jnp.finfo(float32).min, as in Pallas

enum Mode { NORMAL = 0, PARTIAL = 1, FUSED = 2 };

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// Online-softmax fold of partial (o_s, m_s, l_s) into (o, m, l).
__device__ __forceinline__ void fold(float& o, float& m, float& l, float o_s,
                                     float m_s, float l_s) {
  const float m_new = fmaxf(m, m_s);
  const float m_safe = m_new <= NEG / 2 ? 0.f : m_new;
  const float ca = m <= NEG / 2 ? 0.f : expf(m - m_safe);
  const float cb = m_s <= NEG / 2 ? 0.f : expf(m_s - m_safe);
  o = o * ca + o_s * cb;
  l = l * ca + l_s * cb;
  m = m_new;
}

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
// R.r[lr]. Inbox slot layout: (B * H, D + 2) fp32.
template <typename T, int D>
__global__ void fd_comm(const float* __restrict__ part, T* __restrict__ o,
                        symm::Ranks R, symm::Peers P, int B, int H,
                        int n_split, int rows) {
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

}  // namespace fd
