// Paged GQA flash decode for Hopper (sm_90a), W = 1.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (`_fd_paged_kernel` / `flash_decode_paged_fused`). That kernel is one
// serial program (grid=(1,)) that loops over every (slot, KV head), walks
// the slot's block-table slice, DMAs each referenced (block_size, D) K/V
// block into VMEM, keeps an online softmax, packs a (B, H, D+2) partial
// (o, m, l) and folds the partials per source into o / l.
//
// Here the serial loop becomes parallel blocks and the fold a second
// launch, both on the caller's stream:
//   1. partial pass, grid (B, KVH, n_split): a block takes one slot, one
//      KV head and one share of the slot's table entries. It reads each
//      entry from the table itself (row_stride allows the engine's
//      non-contiguous [:, :gather_width] slice), skips -1 holes, stages
//      the K and V rows of head h through shared memory, scores the
//      g = H / KVH query heads in fp32 with `scale`, masks positions
//      >= cur_len[b] and (with a window) < cur_len[b] - window, runs the
//      online softmax and accumulates P @ V. It writes (o, m, l) into an
//      fp32 scratch (B, n_split, H, D + 2) that the wrapper allocates.
//   2. combine pass, grid (B * H): folds the n_split partials exactly as
//      Part 2 of the Pallas kernel does and writes o / max(l, 1e-30) in
//      q's dtype. A row with no valid position comes out as zeros.
//
// What bounds it on the H100: decode attention is a pure stream of the
// slot's K/V bytes -- sum over slots of blocks_read * block_size * KVH *
// D * 2 * sizeof(T) -- at about one multiply-add per byte, so memory
// (3.35 TB/s), not the tensor cores. The design reads every needed K/V
// element once (all g query heads of a KV head share one staged block:
// GQA stays native), only walks the table entries that cur_len and the
// window can reach, and splits each slot's walk over n_split blocks so
// that a small batch still fills the SMs. Vector loads, cp.async/TMA
// pipelining and a fused single pass are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int NT = 128;          // threads of a partial block
constexpr int ACCN = 8;          // accumulator registers: g * D <= NT * ACCN
constexpr float NEG = -FLT_MAX;  // jnp.finfo(float32).min, as in Pallas

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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fd_partial(const T* __restrict__ q, const T* __restrict__ kp,
           const T* __restrict__ vp, const int* __restrict__ cur_len,
           const int* __restrict__ tables, int row_stride,
           float* __restrict__ part, int H, int KVH, int bs, int C,
           int n_split, float scale, int window) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int g = H / KVH;
  float* qs = smem;                      // (g, D)
  float* ks = qs + g * D;                // (bs, D + 1): padded rows
  float* vs = ks + bs * (D + 1);         // (bs, D)
  float* ss = vs + bs * D;               // (g, bs): scores, then p
  float* ms = ss + g * bs;               // (g,) running max
  float* ls = ms + g;                    // (g,) running sum
  float* cs = ls + g;                    // (g,) this step's correction

  // the table entries cur_len (and the window) can reach, split evenly
  const int cl = cur_len[b];
  const int c_hi = min(C, (cl + bs - 1) / bs);
  int c_lo = 0;
  if (window > 0) c_lo = min(max(cl - window, 0) / bs, c_hi);
  const int per = (c_hi - c_lo + n_split - 1) / n_split;
  const int my_lo = c_lo + sp * per;
  const int my_hi = min(c_hi, my_lo + per);

  for (int i = threadIdx.x; i < g * D; i += NT)
    qs[i] = to_f(q[((size_t)b * H + h * g) * D + i]);
  if (threadIdx.x < g) {
    ms[threadIdx.x] = NEG;
    ls[threadIdx.x] = 0.f;
  }
  float acc[ACCN];
#pragma unroll
  for (int j = 0; j < ACCN; ++j) acc[j] = 0.f;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = my_lo; c < my_hi; ++c) {
    const int blk = tables[(size_t)b * row_stride + c];
    if (blk < 0) continue;               // reclaim hole: uniform skip
    __syncthreads();                     // last step done with ks/vs/ss
    for (int i = threadIdx.x; i < bs * D; i += NT) {
      const int t = i / D, d = i % D;
      const size_t off = (((size_t)blk * bs + t) * KVH + h) * D + d;
      ks[t * (D + 1) + d] = to_f(kp[off]);
      vs[i] = to_f(vp[off]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < g * bs; i += NT) {
      const int gi = i / bs, t = i % bs;
      const int pos = c * bs + t;
      const bool valid = pos < cl && (window <= 0 || pos >= cl - window);
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        s = fmaf(qs[gi * D + d], ks[t * (D + 1) + d], s);
      ss[i] = valid ? s * scale : NEG;
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += NT / 32) {
      float mx = NEG;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, ss[gi * bs + t]);
      mx = warp_max(mx);
      const float m_old = ms[gi];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = m_new <= NEG / 2 ? 0.f : m_new;
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float s = ss[gi * bs + t];
        const float p = s <= NEG / 2 ? 0.f : expf(s - m_safe);
        ss[gi * bs + t] = p;
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
        for (int t = 0; t < bs; ++t) a = fmaf(ss[gi * bs + t], vs[t * D + d], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();
  float* out = part + (((size_t)b * n_split + sp) * H + h * g) * (D + 2);
#pragma unroll
  for (int j = 0; j < ACCN; ++j) {
    const int i = threadIdx.x + j * NT;
    if (i < g * D) out[(i / D) * (D + 2) + i % D] = acc[j];
  }
  if (threadIdx.x < g) {
    out[threadIdx.x * (D + 2) + D] = ms[threadIdx.x];
    out[threadIdx.x * (D + 2) + D + 1] = ls[threadIdx.x];
  }
}

template <typename T, int D>
__global__ void fd_combine(const float* __restrict__ part,
                           T* __restrict__ o, int H, int n_split) {
  const int bh = blockIdx.x, b = bh / H, hh = bh % H, d = threadIdx.x;
  float acc_o = 0.f, acc_m = NEG, acc_l = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* p = part + (((size_t)b * n_split + s) * H + hh) * (D + 2);
    const float m_s = p[D], l_s = p[D + 1], o_s = p[d];
    const float m_new = fmaxf(acc_m, m_s);
    const float m_safe = m_new <= NEG / 2 ? 0.f : m_new;
    const float ca = acc_m <= NEG / 2 ? 0.f : expf(acc_m - m_safe);
    const float cb = m_s <= NEG / 2 ? 0.f : expf(m_s - m_safe);
    acc_o = acc_o * ca + o_s * cb;
    acc_l = acc_l * ca + l_s * cb;
    acc_m = m_new;
  }
  o[(size_t)bh * D + d] = from_f<T>(acc_o / fmaxf(acc_l, 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* cur_len,
           const int* tables, int row_stride, float* part, void* out, int B,
           int H, int KVH, int bs, int C, int n_split, float scale,
           int window, cudaStream_t stream) {
  const int g = H / KVH;
  const size_t smem = sizeof(float) *
      ((size_t)g * D + (size_t)bs * (D + 1) + (size_t)bs * D +
       (size_t)g * bs + 3 * (size_t)g);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fd_partial<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fd_partial<T, D><<<dim3(B, KVH, n_split), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), cur_len, tables, row_stride, part, H, KVH,
      bs, C, n_split, scale, window);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fd_combine<T, D><<<B * H, D, 0, stream>>>(part, static_cast<T*>(out), H,
                                            n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int by_dim(int D, const void* q, const void* kp, const void* vp,
           const int* cur_len, const int* tables, int row_stride, float* part,
           void* out, int B, int H, int KVH, int bs, int C, int n_split,
           float scale, int window, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, kp, vp, cur_len, tables, row_stride, part, out,
                           B, H, KVH, bs, C, n_split, scale, window, s);
    case 64:
      return launch<T, 64>(q, kp, vp, cur_len, tables, row_stride, part, out,
                           B, H, KVH, bs, C, n_split, scale, window, s);
    case 128:
      return launch<T, 128>(q, kp, vp, cur_len, tables, row_stride, part,
                            out, B, H, KVH, bs, C, n_split, scale, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D); k/v pools (n_blocks, bs, KVH, D) contiguous, q's dtype;
// cur_len (B,) int32; tables (B, >= C) int32 with row stride row_stride;
// part: fp32 scratch (B, n_split, H, D + 2); out (B, H, D) in q's dtype.
// window <= 0 means no sliding window. dtype: 0 = float32, 1 = bfloat16.
// Returns the first cudaError_t of the two launches (0 = launched).
extern "C" int fd_paged_launch(const void* q, const void* kp, const void* vp,
                               const int* cur_len, const int* tables,
                               int row_stride, void* part, void* out, int B,
                               int H, int KVH, int D, int bs, int C,
                               int n_split, float scale, int window,
                               int dtype, void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || (H / KVH) * D > NT * ACCN ||
      bs <= 0 || C <= 0 || n_split <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return by_dim<float>(D, q, kp, vp, cur_len, tables, row_stride, p, out,
                         B, H, KVH, bs, C, n_split, scale, window, s);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(D, q, kp, vp, cur_len, tables, row_stride,
                                 p, out, B, H, KVH, bs, C, n_split, scale,
                                 window, s);
  return (int)cudaErrorInvalidValue;
}
