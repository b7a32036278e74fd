// The rank protocol of the port's fused multi-rank kernels (the fused
// AG+GEMM and the two fused flash decodes): in-kernel pushes into a
// rank's inbox and one flag per (source, chunk), the CUDA counterpart of
// the Pallas kernels' remote DMAs and per-source DMA semaphores.
//
// Symmetric buffers (allocated once per mesh by kernels/symm.py):
//   inbox[r]  rank r's inbox on rank r's device: two parities of W source
//             slots, each slot `slot_bytes` long, the parities `half`
//             bytes apart;
//   flags[r]  rank r's flags, W sources x n_chunk 32-bit words;
//   state     per device, one 64-bit word: the card's epoch and a count.
// The kernels get a device array of the W inbox bases and one of the W
// flag bases (Iris's heap-base table); for ranks on distinct devices
// these are peer pointers (symm_enable_peer below maps them).
//
// The epoch lives in device memory, so a CUDA graph can replay a fused
// call: one thread of every block of a fused launch takes the card's
// epoch e with one 64-bit atomic add on the word (take_epoch: the epoch
// in the high half, a count of the blocks that took it in the low half)
// and the block uses epoch e + 1 for its flags and its inbox parity; the
// last block to take it stores e + 1 with a zero count. The word
// therefore advances exactly once per launch, after every block has
// read it, and no block pays a fence or an atomic at exit. Every
// card of a mesh runs the same sequence of fused calls (one launch per
// card per call), so the words of distinct cards stay equal: call n
// runs with epoch n everywhere. A producer writes its payload into the
// receiver's slot, fences (__threadfence_system), and then stores the
// epoch into the receiver's flag with release semantics; a consumer
// spins with acquire loads until flag >= epoch. Flags only grow, so no
// memset is needed between calls, and a value left by an older call (of
// any fused kernel) is below the current epoch. When the buffers grow,
// the flags restart at 0 and the epoch word keeps its value, so the rule
// still holds. Payloads of a few KB (the fused paged decode's records)
// travel as LL lines instead (below): each 8-byte half of a line carries
// the epoch, so the writer needs no fence and no flag.
//
// Why two inbox parities suffice: call n writes parity n & 1, where n is
// the card's device-resident epoch, the same on every card. On distinct
// devices rank r may start call n+1 while rank q still reads call n; r
// then writes parity (n+1) & 1, not the slots q reads. A third call n+2,
// which would reuse parity n & 1, cannot push into q before q has
// finished call n: a rank ends call n+1 only after every source's n+1
// push has arrived, and a source pushes n+1 only after its own call n has
// ended (its card's launches run in stream order, and its word reads n
// only once its call-n launch has finished) -- so r's call n+2 starts
// after q's call n+1 push, which q makes after its call n has ended.
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
constexpr int HOT_POLLS = 4096;     // polls before the spin backs off

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
  unsigned long long* state;   // this card's word: epoch << 32 | count
  int W;
  int n_chunk;                 // flags per source
  int sys;                     // 1: some rank is on another card
  unsigned epoch;              // this launch's epoch (take_epoch)
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

// ONE thread of every block of a fused launch: this launch's epoch.
// The card's word packs the epoch (high 32 bits) and a count of the
// launch's blocks that have taken it (low 32 bits); the block that takes
// it last stores epoch + 1 with a zero count. No block reads the word
// after it has counted itself, so the word advances once per launch,
// after every block has read it.
// Split in two so that a block can issue the atomic early and read its
// answer late: epoch_ticket(state) returns the word's old value, and
// epoch_of(state, ticket) the launch's epoch (storing the next one when
// the ticket is the launch's last).
__device__ __forceinline__ unsigned long long epoch_ticket(
    unsigned long long* state) {
  return atomicAdd(state, 1ull);
}
__device__ __forceinline__ unsigned epoch_of(unsigned long long* state,
                                             unsigned long long ticket) {
  const unsigned n = gridDim.x * gridDim.y * gridDim.z;
  const unsigned e = (unsigned)(ticket >> 32) + 1u;
  if ((unsigned)ticket == n - 1u)
    atomicExch(state, (unsigned long long)e << 32);
  return e;
}
__device__ __forceinline__ unsigned take_epoch(unsigned long long* state) {
  return epoch_of(state, epoch_ticket(state));
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The pacing of a spin on data another block or card writes: the first
// HOT_POLLS rounds back to back, then rounds with a growing sleep; a
// trap after SPIN_NS. Callers re-poll between pause() calls.
struct Spin {
  int polls = 0;
  unsigned ns = 32;
  unsigned long long t0 = 0;
  __device__ __forceinline__ void pause() {
    if (++polls <= HOT_POLLS) return;
    const unsigned long long t = now_ns();
    if (t0 == 0) t0 = t;
    else if (t - t0 > SPIN_NS) __trap();
    __nanosleep(ns);
    if (ns < 1024) ns *= 2;
  }
};

// Flags are stored and read at system scope when a peer is on another
// card, at device scope (cheaper) when every rank shares this one.
__device__ __forceinline__ void store_release(unsigned* p, unsigned v,
                                              bool sys) {
  if (sys)
    asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
                 : "memory");
  else
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
                 : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p,
                                                 bool sys) {
  unsigned v;
  if (sys)
    asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
  return v;
}

// Spin until rank dst's flag for (src, chunk) reaches this epoch: first
// HOT_POLLS back-to-back polls, then polls with a growing sleep; trap
// after SPIN_NS.
__device__ __forceinline__ void wait(const Peers& P, int dst, int src,
                                     int chunk) {
  const unsigned* f = P.flag(dst, src, chunk);
  Spin spin;
  while (load_acquire(f, P.sys) < P.epoch) spin.pause();
}

// Called by EVERY thread of a block after its stores into peer inboxes:
// after the block's barrier, one thread per destination in `dsts` (a bit
// mask of ranks) publishes the epoch in that destination's flag for
// (src, chunk) with a release store, which orders the block's stores
// before it (to system scope when a peer is on another card). Needs
// blockDim.x >= W.
__device__ __forceinline__ void publish(const Peers& P, int src, int chunk,
                                        unsigned dsts = 0xffffffffu) {
  __syncthreads();
  const int t = threadIdx.x;
  if (t < P.W && ((dsts >> t) & 1u)) {
    if (P.sys)
      __threadfence_system();
    else
      __threadfence();
    store_release(P.flag(t, src, chunk), P.epoch, P.sys);
  }
}

// Low-latency (LL) lines, NCCL's LL protocol: a 16-byte line carries two
// 32-bit words, each beside a copy of the epoch, written by one 16-byte
// store. A reader spins on the line itself until both halves carry its
// epoch (each 8-byte half is written at once), so the writer needs no
// fence and no flag, and a payload costs one trip instead of three
// (stores, fence, flag). Used for payloads of a few KB.
__device__ __forceinline__ void ll_store(void* p, float a, float b,
                                         unsigned e) {
  asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(__float_as_uint(a)), "r"(e), "r"(__float_as_uint(b)),
               "r"(e)
               : "memory");
}

// One LL line as it is now (no wait).
__device__ __forceinline__ uint4 ll_peek(const void* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

// Every thread: copy the W inbox and flag bases into `tab` (2 * W
// pointers of shared memory) and point P at the copies, so that a push
// or a wait reads no table from device memory. Needs blockDim.x >= W;
// the caller synchronises the block before P is used. Split like the
// epoch: table_entries() loads this thread's two bases early,
// cache_tables() stores them.
struct TableEntries {
  void* inbox;
  void* flags;
};
__device__ __forceinline__ TableEntries table_entries(const Peers& P) {
  const int t = threadIdx.x;
  return t < P.W ? TableEntries{P.inbox[t], P.flags[t]}
                 : TableEntries{nullptr, nullptr};
}
__device__ __forceinline__ void cache_tables(Peers& P, void** tab,
                                             TableEntries te) {
  const int t = threadIdx.x;
  if (t < P.W) {
    tab[t] = te.inbox;
    tab[P.W + t] = te.flags;
  }
  P.inbox = reinterpret_cast<char* const*>(tab);
  P.flags = reinterpret_cast<unsigned* const*>(tab + P.W);
}
__device__ __forceinline__ void cache_tables(Peers& P, void** tab) {
  cache_tables(P, tab, table_entries(P));
}

// Every thread: wait until every source's flag (dst, s, chunk) is set.
// Needs blockDim.x >= W.
__device__ __forceinline__ void wait_all(const Peers& P, int dst,
                                         int chunk) {
  if ((int)threadIdx.x < P.W) wait(P, dst, threadIdx.x, chunk);
  __threadfence();
  __syncthreads();
}

// n_local: the ranks of this launch's card; the others are elsewhere.
inline Peers make_peers(const void* inbox_tab, const void* flag_tab,
                        void* state, int W, int n_chunk,
                        long long slot_bytes, long long half, int n_local) {
  Peers P;
  P.sys = n_local < W;
  P.inbox = static_cast<char* const*>(inbox_tab);
  P.flags = static_cast<unsigned* const*>(flag_tab);
  P.state = static_cast<unsigned long long*>(state);
  P.W = W;
  P.n_chunk = n_chunk;
  P.epoch = 0;
  P.slot_bytes = (size_t)slot_bytes;
  P.half = (size_t)half;
  return P;
}

// The most blocks of `fn` that can be co-resident on one SM of the
// current device.
inline int blocks_per_sm(const void* fn, int threads, size_t smem,
                         int* out) {
  *out = 0;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn,
                                                            threads, smem);
}

__global__ void empty_kernel() {}

}  // namespace symm

// One cooperative launch of an empty kernel (grid x threads) on `stream`:
// the latency floor of a fused call, which is one such launch plus its
// flag round trip (chip_smoke.py times it beside the kernels).
extern "C" int symm_empty_launch(int grid, int threads, void* stream) {
  return (int)cudaLaunchCooperativeKernel(
      (const void*)symm::empty_kernel, dim3(grid), dim3(threads), nullptr,
      0, static_cast<cudaStream_t>(stream));
}

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
