// Pieces shared by the two flash-decode kernels (flash_decode_paged.cu,
// flash_decode.cu): element conversions, warp reductions, the online-
// softmax fold of two partials (o, m, l) and the kernels' modes.
//
// Both kernels produce, per (slot, KV head), the unnormalised fp32
// partial (o, m, l) of the g = H / KVH query heads and finish it in one
// of three modes:
//   NORMAL   W = 1: o / max(l, 1e-30) in q's dtype (a row with nothing to
//            attend comes out as zeros);
//   PARTIAL  the rank's partial (o, m, l), fp32 (n_local, B, H, D + 2):
//            what the bsp, ring and rs_ag schedules combine in torch code;
//   FUSED    the paper's Algorithm 4 Part 2: push the rank's partial into
//            slot `rank` of every rank's inbox with a flag, wait for every
//            source and combine them in rank order 0..W-1, so every
//            rank's output is bit-identical (symm.cuh).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

#include "symm.cuh"

namespace fd {

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

}  // namespace fd
