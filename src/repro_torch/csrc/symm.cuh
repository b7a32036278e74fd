// The rank protocol of the port's fused multi-rank kernels (the fused
// AG+GEMM and the two fused flash decodes): in-kernel pushes into every
// rank's inbox and one flag per (source, chunk), the CUDA counterpart of
// the Pallas kernels' remote DMAs and per-source DMA semaphores.
//
// Symmetric buffers (allocated once per mesh by kernels/symm.py):
//   inbox[r]  rank r's inbox on rank r's device: two parities of W source
//             slots, each slot `slot_bytes` long, the parities `half`
//             bytes apart;
//   flags[r]  rank r's flags, W sources x n_chunk 32-bit words.
// The kernels get a device array of the W inbox bases and one of the W
// flag bases (Iris's heap-base table); for ranks on distinct devices
// these are peer pointers (symm_enable_peer below maps them).
//
// Flags carry an epoch. Every call of a fused kernel on a mesh takes the
// next epoch from the host (kernels/symm.py). A producer writes its
// payload into the receiver's slot, fences (__threadfence_system), and
// then stores the epoch into the receiver's flag with release semantics;
// a consumer spins with acquire loads until flag >= epoch. Flags only
// grow, so no memset is needed between calls, and a value left by an
// older call (of any fused kernel) is below the current epoch.
//
// Why two inbox parities suffice: the call with epoch n writes parity
// n & 1. On distinct devices rank r may start call n+1 while rank q still
// reads call n; r then writes parity (n+1) & 1, not the slots q reads. A
// third call n+2, which would reuse parity n & 1, cannot push into q
// before q has finished call n: a rank ends call n+1 only after every
// source's n+1 push has arrived, and a source pushes n+1 only after its
// own call n has ended -- so r's call n+2 starts after q's call n+1
// push, which q makes after its call n has ended.
//
// No deadlock on one device: ranks that share a device run in ONE
// launch (the grid spans the local ranks) and that launch is
// cooperative (cudaLaunchCooperativeKernel), so every block that another
// block waits on is resident; a grid that cannot be co-resident fails to
// launch instead of hanging. Every spin is bounded by the globaltimer
// (SPIN_NS): a peer that never arrives ends in __trap(), i.e. a CUDA
// error at the next synchronisation, not a hang.
#pragma once
#include <cuda_runtime.h>
#include <cstddef>

namespace symm {

constexpr int MAX_RANKS = 8;                        // ranks on one device
constexpr unsigned long long SPIN_NS = 1000000000ull;   // ~1 s

// Per-local-rank pointers and rank ids, passed by value.
struct Ptrs {
  const void* p[MAX_RANKS];
};
struct Ranks {
  int r[MAX_RANKS];
};

struct Peers {
  char* const* inbox;          // device array [W] of inbox bases
  unsigned* const* flags;      // device array [W] of flag bases
  int W;
  int n_chunk;                 // flags per source
  unsigned epoch;
  size_t slot_bytes;           // one source's slot
  size_t half;                 // parity stride of an inbox, in bytes

  // rank dst's inbox slot for source src, this call's parity
  __device__ char* slot(int dst, int src) const {
    return inbox[dst] + (size_t)(epoch & 1u) * half +
           (size_t)src * slot_bytes;
  }
  __device__ unsigned* flag(int dst, int src, int chunk) const {
    return flags[dst] + (size_t)src * n_chunk + chunk;
  }
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Spin until rank dst's flag for (src, chunk) reaches this epoch; trap
// after SPIN_NS.
__device__ __forceinline__ void wait(const Peers& P, int dst, int src,
                                     int chunk) {
  const unsigned* f = P.flag(dst, src, chunk);
  if (load_acquire(f) >= P.epoch) return;
  const unsigned long long t0 = now_ns();
  while (load_acquire(f) < P.epoch) {
    if (now_ns() - t0 > SPIN_NS) __trap();
    __nanosleep(64);
  }
}

// Called by EVERY thread of a block after its stores into peer inboxes:
// fence them to system scope, then one thread per destination publishes
// the epoch in that destination's flag for (src, chunk).
// Needs blockDim.x >= W.
__device__ __forceinline__ void publish(const Peers& P, int src,
                                        int chunk) {
  __threadfence_system();
  __syncthreads();
  if ((int)threadIdx.x < P.W)
    store_release(P.flag(threadIdx.x, src, chunk), P.epoch);
}

// Every thread: wait until every source's flag (dst, s, chunk) is set.
// Needs blockDim.x >= W.
__device__ __forceinline__ void wait_all(const Peers& P, int dst,
                                         int chunk) {
  if ((int)threadIdx.x < P.W) wait(P, dst, threadIdx.x, chunk);
  __threadfence();
  __syncthreads();
}

inline Peers make_peers(const void* inbox_tab, const void* flag_tab, int W,
                        int n_chunk, unsigned epoch, long long slot_bytes,
                        long long half) {
  Peers P;
  P.inbox = static_cast<char* const*>(inbox_tab);
  P.flags = static_cast<unsigned* const*>(flag_tab);
  P.W = W;
  P.n_chunk = n_chunk;
  P.epoch = epoch;
  P.slot_bytes = (size_t)slot_bytes;
  P.half = (size_t)half;
  return P;
}

// The most blocks of `fn` that can be co-resident on the current device.
inline int coop_capacity(const void* fn, int threads, size_t smem,
                         int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  *out = sms * per_sm;
  return (int)e;
}

}  // namespace symm

// Map device `peer`'s memory into device `dev`'s address space, so that
// kernels on `dev` can store into `peer`'s inboxes and flags. Returns
// cudaErrorPeerAccessUnsupported when the pair cannot reach each other.
extern "C" int symm_enable_peer(int dev, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(dev);
  e = cudaDeviceEnablePeerAccess(peer, 0);
  cudaSetDevice(prev);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();          // clear the sticky-free status
    return 0;
  }
  return (int)e;
}
