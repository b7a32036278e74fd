// Paged GQA flash decode for Hopper (sm_90a), at W = 1 and over W ranks,
// in ONE launch per call per card.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (`_fd_paged_kernel` / `flash_decode_paged_fused`). That kernel is one
// serial program (grid=(1,)) per rank that loops over every (slot, KV
// head), walks the slot's block-table slice, DMAs each referenced block
// this rank owns into VMEM (-1 holes and other ranks' blocks are
// masked), keeps an online softmax, packs a (B, H, D+2) partial
// (o, m, l), pushes it by remote DMA into every rank's inbox and folds
// the W sources in rank order.
//
// The kernel body -- what bounds it on the H100 and how the design cuts
// its latency chain -- is fd_common.cuh's, shared with the contiguous
// decode (flash_decode.cu). What is the paged kernel's own is its walk:
// cur_len and the first 32 table entries go out together; within one
// run of 32 entries every warp finds the entries its rank owns (and that
// cur_len and the window reach) from one ballot, in registers (longer
// walks compact them through shared memory); each owned block's rows are
// walked in tiles of TR rows.
#include "fd_common.cuh"

namespace {

using fd::Args;
using fd::LIST_CAP;
using fd::NT;
using fd::NW;
using fd::TileRef;
using fd::TR;

// The owned table entries of one split of a unit's table row.
struct PagedWalk {
  int c32, blk_l, n_own, n_sub, base, bs;
  unsigned own_mask;
  bool fast;
  const int* lc;
  const int* lb;
  static constexpr int pstep = 1;

  __device__ PagedWalk(const Args& a, int* lc_, int* lb_, int* misc, int lr,
                       int b, int sp, int cl)
      : lc(lc_), lb(lb_) {
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int* table = static_cast<const int*>(a.TB.p[lr]) +
                       (size_t)b * a.row_stride;
    const int first = lane < a.C ? table[lane] : -1;
    base = a.R.r[lr] * a.n_loc;
    bs = a.bs;
    n_sub = (bs + TR - 1) / TR;
    // the table entries cur_len (and the window) reach, split evenly
    const int c_hi = min(a.C, (cl + bs - 1) / bs);
    int c_lo = 0;
    if (a.window > 0) c_lo = min(max(cl - a.window, 0) / bs, c_hi);
    const int per = (c_hi - c_lo + a.n_split - 1) / a.n_split;
    const int my_lo = c_lo + sp * per;
    const int my_hi = min(c_hi, my_lo + per);

    // the entries of [my_lo, my_hi) this rank owns. Within one aligned
    // run of 32 columns every warp finds them alike from a ballot, in
    // registers; longer walks compact them into lc / lb
    c32 = my_lo / 32 * 32;
    fast = my_hi - c32 <= 32;
    own_mask = 0;
    blk_l = -1;
    n_own = 0;
    if (fast) {
      const int c = c32 + lane;
      blk_l = c32 == 0 ? first : (c < my_hi ? table[c] : -1);
      own_mask = __ballot_sync(0xffffffffu, c >= my_lo && c < my_hi &&
                                                blk_l >= base &&
                                                blk_l < base + a.n_loc);
      n_own = __popc(own_mask);
      return;
    }
    __syncthreads();               // lc / misc of the last item
    for (int c0 = my_lo / NT * NT; c0 < my_hi; c0 += NT) {
      const int c = c0 + tid;
      const int blk = c >= my_lo && c < my_hi ? table[c] : -1;
      const bool own = blk >= base && blk < base + a.n_loc;
      const unsigned mk = __ballot_sync(0xffffffffu, own);
      if (lane == 0) misc[warp] = __popc(mk);
      __syncthreads();
      int off = n_own, tot = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (w < warp) off += misc[w];
        tot += misc[w];
      }
      if (own) {
        const int i = off + __popc(mk & ((1u << lane) - 1u));
        lc_[i] = c;
        lb_[i] = blk - base;
      }
      n_own += tot;
      __syncthreads();
    }
  }

  __device__ int tiles() const { return n_own * n_sub; }

  // tile t: sub-tile t % n_sub of owned entry t / n_sub
  __device__ TileRef tile(int t) const {
    const int e = t / n_sub;
    int c, blk;
    if (fast) {
      unsigned mk = own_mask;
      for (int i = 0; i < e; ++i) mk &= mk - 1u;
      const int pos = __ffs(mk) - 1;
      c = c32 + pos;
      blk = __shfl_sync(0xffffffffu, blk_l, pos) - base;
    } else {
      c = lc[e];
      blk = lb[e];
    }
    const int r0 = (t % n_sub) * TR;
    return {(size_t)blk * bs + r0, min(TR, bs - r0), c * bs + r0};
  }
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(NT) fd_paged(Args a, symm::Peers P0) {
  fd::run<PagedWalk, T, D, G>(a, P0);
}

struct Paged {
  template <typename T, int D, int G>
  static const void* fn() {
    return (const void*)fd_paged<T, D, G>;
  }
};

}  // namespace

// Blocks of the kernel for head dim D, g query heads per KV head and
// dtype (0 = float32, 1 = bfloat16) that fit on one SM of the current
// device (kernels/flash_decode.py sizes the cooperative grid with it).
extern "C" int fd_paged_blocks_per_sm(int D, int g, int dtype, int* out) {
  return fd::blocks_per_sm<Paged>(D, g, dtype, out);
}

// One launch on one device for its n_local ranks (ids ranks[]). Per local
// rank: q (B, H, D); k/v pool shard (n_loc, bs, KVH, D) contiguous,
// q's dtype, holding global blocks [rank * n_loc, (rank + 1) * n_loc);
// q and the pools 16-byte aligned; cur_len (B,) int32; tables (B, >= C)
// int32 with row stride row_stride. split_rec: fp32 scratch (n_local *
// B * KVH * HG * n_split, rec_floats(gu, D)) when n_split > 1 (gu, HG:
// fd_common.cuh heads_per_unit); cnt: n_local * B * KVH * HG uint32
// counters, zero at entry and left at zero. out: (n_local, B, H,
// D) in q's dtype for mode 0 (NORMAL, W = 1) and 2 (FUSED), fp32
// (n_local, B, H, D + 2) for mode 1 (PARTIAL). `grid` blocks walk the
// items (FUSED: at most what the card holds at once,
// fd_paged_blocks_per_sm). FUSED only: the symmetric buffers' pointer
// tables (device arrays of W entries), this card's epoch word, the mesh
// size W (<= 256), flags per source (unused: the records travel as LL
// lines), one source's slot bytes (>= B * KVH * HG * rec_floats(gu, D) *
// 8) and the inbox parity stride. window <= 0 means no sliding window. dtype: 0 =
// float32, 1 = bfloat16. Returns the first cudaError_t (0 = launched).
extern "C" int fd_paged_launch(
    const void* const* q, const void* const* kp, const void* const* vp,
    const void* const* cur_len, const void* const* tables, int row_stride,
    const int* ranks, int n_local, void* split_rec, void* cnt, void* out,
    int B, int H, int KVH, int D, int bs, int n_loc, int C, int n_split,
    int grid, float scale, int window, int dtype, int mode,
    const void* inbox_tab, const void* flag_tab, void* state, int W,
    int n_chunk, long long slot_bytes, long long half, void* stream) {
  if (!fd::args_ok(B, H, KVH, D, C, n_split, n_local, grid, mode, split_rec,
                   cnt) ||
      bs <= 0 || n_loc <= 0 || (C + n_split - 1) / n_split > LIST_CAP)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  if (!fd::common_args(a, q, kp, vp, cur_len, ranks, n_local, split_rec, cnt,
                       out, B, H, KVH, D, C, n_split, scale, window, mode))
    return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < n_local; ++i) a.TB.p[i] = tables[i];
  a.row_stride = row_stride;
  a.n_loc = n_loc;
  a.bs = bs;
  const symm::Peers P = symm::make_peers(inbox_tab, flag_tab, state, W,
                                         n_chunk, slot_bytes, half, n_local);
  if (mode == fd::FUSED && !fd::fused_ok(P, a, n_local))
    return (int)cudaErrorInvalidValue;
  return fd::dispatch<Paged>(dtype, D, a, grid, P,
                             static_cast<cudaStream_t>(stream));
}
