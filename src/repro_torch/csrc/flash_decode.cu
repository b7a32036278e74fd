// Flash decode over a contiguous, strided, sequence-sharded KV cache
// (the paper's Algorithm 4) for Hopper (sm_90a), at W = 1 and over W
// ranks, in ONE launch per call per card.
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
// Here it is the paged decode's kernel (fd_common.cuh: units of (local
// rank, slot, KV head), a 4-deep cp.async K/V ring, g heads in registers,
// exp2 softmax, split records folded by the last arrival, FUSED records
// pushed as LL lines and folded in rank order, the epoch from the card's
// word) with an implicit walk instead of a table: the shard
// (B, S_loc, KVH, D) has the paged pool's row stride, KVH * D, so entry c
// of slot b is local rows [c * TR, min((c + 1) * TR, S_loc)) starting at
// row b * S_loc + c * TR, every entry is owned by its rank, and local
// row j holds position j * W + rank. cur_len is per slot; the walk takes
// only the local rows below it (and, with a window, at or above
// cur_len - window, translated into local rows); the ragged last tile is
// masked, so S_loc needs no divisibility.
#include "fd_common.cuh"

namespace {

using fd::Args;
using fd::NT;
using fd::TileRef;
using fd::TR;

// One split of the tiles of a slot's shard rows that cur_len (and the
// window) reach.
struct StridedWalk {
  size_t slot_row;
  int S_loc, lo, n, rank, pstep;

  __device__ StridedWalk(const Args& a, int*, int*, int*, int lr, int b,
                         int sp, int cl) {
    const int W = a.Wp;
    rank = a.R.r[lr];
    S_loc = a.S_loc;
    pstep = W;
    slot_row = (size_t)b * S_loc;
    // local rows j with cl - window <= j * W + rank < cl
    const int j_hi = cl > rank ? min(S_loc, (cl - rank + W - 1) / W) : 0;
    int j_lo = 0;
    if (a.window > 0 && cl - a.window > rank)
      j_lo = min((cl - a.window - rank + W - 1) / W, j_hi);
    const int c_lo = j_lo / TR, c_hi = (j_hi + TR - 1) / TR;
    const int per = (c_hi - c_lo + a.n_split - 1) / a.n_split;
    lo = c_lo + sp * per;
    n = max(0, min(c_hi, lo + per) - lo);
  }

  __device__ int tiles() const { return n; }

  __device__ TileRef tile(int t) const {
    const int j0 = (lo + t) * TR;
    return {slot_row + j0, min(TR, S_loc - j0), j0 * pstep + rank};
  }
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(NT) fd_strided(Args a, symm::Peers P0) {
  fd::run<StridedWalk, T, D, G>(a, P0);
}

struct Strided {
  template <typename T, int D, int G>
  static const void* fn() {
    return (const void*)fd_strided<T, D, G>;
  }
};

}  // namespace

// Blocks of the kernel for head dim D, g query heads per KV head and
// dtype (0 = float32, 1 = bfloat16) that fit on one SM of the current
// device (kernels/flash_decode.py sizes the cooperative grid with it).
extern "C" int fd_blocks_per_sm(int D, int g, int dtype, int* out) {
  return fd::blocks_per_sm<Strided>(D, g, dtype, out);
}

// One launch on one device for its n_local ranks (ids ranks[]) of a
// W-rank mesh. Per local rank: q (B, H, D); k/v shard (B, S_loc, KVH, D)
// contiguous, q's dtype, local row j = global position j * W + rank; q
// and the shards 16-byte aligned; cur_len (B,) int32. C: tiles of TR rows
// per slot, ceil(S_loc / TR). split_rec, cnt, out, grid, the modes and
// the symmetric buffers as in fd_paged_launch (csrc/flash_decode_paged.cu);
// W is read in every mode (positions are j * W + rank). window <= 0 means
// no sliding window. dtype: 0 = float32, 1 = bfloat16. Returns the first
// cudaError_t (0 = launched).
extern "C" int fd_launch(
    const void* const* q, const void* const* kp, const void* const* vp,
    const void* const* cur_len, const int* ranks, int n_local,
    void* split_rec, void* cnt, void* out, int B, int H, int KVH, int D,
    int S_loc, int C, int n_split, int grid, float scale, int window,
    int dtype, int mode, const void* inbox_tab, const void* flag_tab,
    void* state, int W, int n_chunk, long long slot_bytes, long long half,
    void* stream) {
  if (!fd::args_ok(B, H, KVH, D, C, n_split, n_local, grid, mode, split_rec,
                   cnt) ||
      S_loc <= 0 || C != (S_loc + TR - 1) / TR || W < n_local)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  if (!fd::common_args(a, q, kp, vp, cur_len, ranks, n_local, split_rec, cnt,
                       out, B, H, KVH, D, C, n_split, scale, window, mode))
    return (int)cudaErrorMisalignedAddress;
  a.S_loc = S_loc;
  a.Wp = W;
  const symm::Peers P = symm::make_peers(inbox_tab, flag_tab, state, W,
                                         n_chunk, slot_bytes, half, n_local);
  if (mode == fd::FUSED && !fd::fused_ok(P, a, n_local))
    return (int)cudaErrorInvalidValue;
  return fd::dispatch<Strided>(dtype, D, a, grid, P,
                               static_cast<cudaStream_t>(stream));
}
