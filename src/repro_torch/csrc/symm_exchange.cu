// The device-side all-gather and all-reduce of the model axis over
// processes (sm_90a): the counterpart of the plain collectives of
// core/collective_matmul.py (all_gather_devices, all_reduce_devices)
// when processes split a data group's model ranks, so that nothing of a
// decode step passes through torch.distributed and each process can
// capture its megatick in a CUDA graph. It is not the port of a Pallas
// kernel: JAX's collectives are XLA's.
//
// One cooperative launch per process over its n_local ranks (ids
// ranks[], the process's first rank first) of a W-rank group. Every
// rank r holds one block of `outer * inner` elements. The protocol is
// the fused kernels' (symm.cuh): every block of the launch takes the
// epoch; block c pushes its 1/grid share of each local rank's block into
// slot `rank` of the inbox of every OTHER process's first rank (the
// `leaders` mask, as the fused AG+GEMM pushes its shards) and publishes
// one flag per (source, c) there; then every block waits for every
// remote source's `grid` flags in its own first rank's inbox and writes
// its share of the output, reading the local blocks in place and the
// others from that inbox:
//   op 0 (gather): out (outer, W * inner), block s at columns
//     [s * inner, (s + 1) * inner) of every row: the blocks joined along
//     the gather dim, in rank order (any element size; bytes are moved
//     in the widest unit that divides a row and the alignment);
//   op 1 (sum): out (outer, inner) = x_0 + x_1 + ... + x_{W-1}, in rank
//     order, each partial sum rounded to the blocks' dtype (float32 or
//     bfloat16: fp32 arithmetic, round to nearest even), which is what
//     `acc = acc + x_s` in PyTorch computes in one process, bit for bit.
// What bounds it: bytes. Each process reads its blocks once, writes
// them once into every other process's inbox and reads the inbox once;
// at decode sizes (KB) it is a launch and a flag round trip.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "symm.cuh"

namespace {

constexpr int NT = 256;

struct XArgs {
  symm::Ptrs X;           // the local ranks' blocks
  symm::Ranks R;
  int n_local, W, op, dtype, esz, unit;
  long long outer, inner;
  unsigned leaders;
  void* out;
};

template <typename U>
__device__ __forceinline__ U ld_cg(const U* p) {
  return __ldcg(p);
}

__device__ __forceinline__ void copy_range(char* d, const char* s,
                                           size_t lo, size_t hi, bool vec) {
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    for (size_t i = lo / 16 + threadIdx.x; i < hi / 16; i += NT) d4[i] = s4[i];
  } else {
    for (size_t i = lo + threadIdx.x; i < hi; i += NT) d[i] = s[i];
  }
}

template <typename U>
__device__ void gather_out(const XArgs& a, const char* const* src) {
  const long long iu = a.inner * a.esz / (long long)sizeof(U);
  const long long row = (long long)a.W * iu;
  const long long n = a.outer * row;
  U* out = static_cast<U*>(a.out);
  for (long long u = (long long)blockIdx.x * NT + threadIdx.x; u < n;
       u += (long long)gridDim.x * NT) {
    const long long o = u / row, rem = u % row;
    const int s = (int)(rem / iu);
    out[u] = ld_cg(reinterpret_cast<const U*>(src[s]) + o * iu + rem % iu);
  }
}

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float ldf(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ldf(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

template <typename T>
__device__ void sum_out(const XArgs& a, const char* const* src) {
  const long long n = a.outer * a.inner;
  T* out = static_cast<T*>(a.out);
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += (long long)gridDim.x * NT) {
    T acc = ldf(reinterpret_cast<const T*>(src[0]) + i);
    for (int s = 1; s < a.W; ++s)
      acc = from_f<T>(__fadd_rn(to_f(acc),
                                to_f(ldf(reinterpret_cast<const T*>(src[s]) +
                                         i))));
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(NT)
exchange_kernel(XArgs a, symm::Peers P0) {
  __shared__ void* tab[2 * 32];
  __shared__ const char* src[32];
  __shared__ unsigned ep;
  symm::Peers P = P0;
  const int tid = threadIdx.x;
  if (tid == 0) ep = symm::take_epoch(P.state);
  symm::cache_tables(P, tab);
  __syncthreads();
  P.epoch = ep;
  unsigned local = 0;
  for (int i = 0; i < a.n_local; ++i) local |= 1u << a.R.r[i];
  const unsigned remote = a.leaders & ~local;
  const int me = a.R.r[0];
  const size_t bytes = (size_t)(a.outer * a.inner) * a.esz;
  bool vec = bytes % 16 == 0;
  for (int i = 0; i < a.n_local; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(a.X.p[i]) % 16 == 0;

  // ---- push this block's share of every local block
  size_t per = (bytes + gridDim.x - 1) / gridDim.x;
  per = (per + 15) / 16 * 16;
  const size_t at = (size_t)blockIdx.x * per;
  const size_t lo = at < bytes ? at : bytes;
  const size_t hi = lo + per < bytes ? lo + per : bytes;
  for (int lr = 0; lr < a.n_local; ++lr) {
    const int rank = a.R.r[lr];
    for (int dst = 0; dst < a.W; ++dst)
      if ((remote >> dst) & 1u)
        copy_range(P.slot(dst, rank),
                   static_cast<const char*>(a.X.p[lr]), lo, hi, vec);
    symm::publish(P, rank, blockIdx.x, remote);
  }

  // ---- every remote source's every share, in this process's inbox
  for (int i = tid; i < a.W * (int)gridDim.x; i += NT) {
    const int s = i / gridDim.x, c = i % gridDim.x;
    if (!((local >> s) & 1u)) symm::wait(P, me, s, c);
  }
  __threadfence();
  if (tid < a.W) {
    int lr = -1;
    for (int i = 0; i < a.n_local; ++i)
      if (a.R.r[i] == tid) lr = i;
    src[tid] = lr >= 0 ? static_cast<const char*>(a.X.p[lr])
                       : P.slot(me, tid);
  }
  __syncthreads();

  if (a.op == 1) {
    if (a.dtype == 0)
      sum_out<float>(a, src);
    else
      sum_out<__nv_bfloat16>(a, src);
    return;
  }
  switch (a.unit) {
    case 16: gather_out<uint4>(a, src); break;
    case 8: gather_out<uint2>(a, src); break;
    case 4: gather_out<unsigned>(a, src); break;
    case 2: gather_out<unsigned short>(a, src); break;
    default: gather_out<unsigned char>(a, src); break;
  }
}

}  // namespace

// Blocks of the kernel that fit on one SM of the current device.
extern "C" int symm_exchange_blocks_per_sm(int* out) {
  return symm::blocks_per_sm((const void*)exchange_kernel, NT, 0, out);
}

// One cooperative launch of `grid` blocks (at most what the device holds
// at once, symm_exchange_blocks_per_sm) for the n_local ranks ranks[] of
// this process (its first rank first) of a W-rank group: x[i] the local
// rank's block, contiguous, (outer, inner) elements of `esz` bytes; op 0
// gathers into out (outer, W * inner), op 1 sums into out (outer, inner)
// (dtype 0 = float32, 1 = bfloat16); leaders: bit mask of the first rank
// of every process of the group. The symmetric buffers as in
// ag_gemm_launch (csrc/ag_gemm.cu); a slot holds one block (slot_bytes
// >= outer * inner * esz); flags per source >= grid. Returns the
// launch's cudaError_t (0 = launched).
extern "C" int symm_exchange_launch(
    const void* const* x, const int* ranks, int n_local, int op, int dtype,
    int esz, long long outer, long long inner, unsigned leaders, void* out,
    int grid, const void* inbox_tab, const void* flag_tab, void* state, int W,
    int n_chunk, long long slot_bytes, long long half, void* stream) {
  if (n_local <= 0 || n_local > symm::MAX_RANKS || W < n_local || W > 32 ||
      grid <= 0 || n_chunk < grid || outer <= 0 || inner <= 0 ||
      state == nullptr || out == nullptr || (op != 0 && op != 1) ||
      (op == 1 && dtype != 0 && dtype != 1) ||
      (op == 1 && esz != (dtype == 0 ? 4 : 2)) ||
      (esz != 1 && esz != 2 && esz != 4 && esz != 8) ||
      slot_bytes < outer * inner * esz || !((leaders >> ranks[0]) & 1u))
    return (int)cudaErrorInvalidValue;
  XArgs a;
  a.n_local = n_local;
  a.W = W;
  a.op = op;
  a.dtype = dtype;
  a.esz = esz;
  a.outer = outer;
  a.inner = inner;
  a.leaders = leaders;
  a.out = out;
  // the widest unit that divides a row and every address
  const long long row = inner * esz;
  uintptr_t align = reinterpret_cast<uintptr_t>(out);
  for (int i = 0; i < n_local; ++i) {
    a.X.p[i] = x[i];
    a.R.r[i] = ranks[i];
    align |= reinterpret_cast<uintptr_t>(x[i]);
  }
  a.unit = 16;
  while (a.unit > 1 && (row % a.unit || align % a.unit || slot_bytes % a.unit))
    a.unit /= 2;
  const symm::Peers P = symm::make_peers(inbox_tab, flag_tab, state, W,
                                         n_chunk, slot_bytes, half, n_local);
  void* args[] = {(void*)&a, (void*)&P};
  return (int)cudaLaunchCooperativeKernel((const void*)exchange_kernel,
                                          dim3(grid), dim3(NT), args, 0,
                                          static_cast<cudaStream_t>(stream));
}
