// Paged GQA flash decode for Hopper (sm_90a), at W = 1 and over W ranks.
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
// Here the serial loop becomes parallel blocks and the push/fold a
// second launch, both on the caller's stream (fd_common.cuh):
//   1. Part 1, grid (B, KVH, n_local * n_split): a block takes one slot,
//      one KV head, one local rank and one share of the slot's table
//      entries. It reads each entry from the table itself (row_stride
//      allows the engine's non-contiguous [:, :gather_width] slice),
//      skips -1 holes and blocks outside the rank's range
//      [rank * n_loc, (rank + 1) * n_loc) alike, stages the block's K and
//      V rows of head h through shared memory, scores the g = H / KVH
//      query heads in fp32 with `scale`, masks positions >= cur_len[b]
//      and (with a window) < cur_len[b] - window, and runs the online
//      softmax. It writes (o, m, l) per split into an fp32 scratch.
//   2. Part 2 (mode): NORMAL at W = 1 folds the splits and normalises;
//      PARTIAL returns each rank's folded (o, m, l) for the bsp / ring /
//      rs_ag combines; FUSED folds, pushes to every rank and combines the
//      sources in rank order (the paper's Algorithm 4 Part 2), one
//      cooperative launch over the device's local ranks (symm.cuh).
//
// What bounds it on the H100: decode attention is a pure stream of the
// slot's K/V bytes -- sum over slots of blocks_read * block_size * KVH *
// D * 2 * sizeof(T) -- at about one multiply-add per byte, so memory
// (3.35 TB/s), not the tensor cores; over W ranks each rank streams only
// the blocks it owns, plus W partials of B * H * (D + 2) * 4 bytes moved
// per rank. The design reads every needed K/V element once (all g query
// heads of a KV head share one staged block: GQA stays native), only
// walks the table entries that cur_len and the window can reach, and
// splits each slot's walk over n_split blocks so that a small batch
// still fills the SMs. Vector loads, cp.async/TMA pipelining and fusing
// the two passes are later work.
#include "fd_common.cuh"

namespace {

using fd::NT;

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fd_paged_partial(symm::Ptrs Q, symm::Ptrs K, symm::Ptrs V, symm::Ptrs CL,
                 symm::Ptrs TB, int row_stride, symm::Ranks R, int n_loc,
                 float* __restrict__ part, int B, int H, int KVH, int bs,
                 int C, int n_split, float scale, int window) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int lr = blockIdx.z / n_split, sp = blockIdx.z % n_split;
  const int g = H / KVH;
  const T* q = static_cast<const T*>(Q.p[lr]);
  const T* kp = static_cast<const T*>(K.p[lr]);
  const T* vp = static_cast<const T*>(V.p[lr]);
  const int* tables = static_cast<const int*>(TB.p[lr]);
  const int base = R.r[lr] * n_loc;

  // the table entries cur_len (and the window) can reach, split evenly
  const int cl = static_cast<const int*>(CL.p[lr])[b];
  const int c_hi = min(C, (cl + bs - 1) / bs);
  int c_lo = 0;
  if (window > 0) c_lo = min(max(cl - window, 0) / bs, c_hi);
  const int per = (c_hi - c_lo + n_split - 1) / n_split;
  const int my_lo = c_lo + sp * per;
  const int my_hi = min(c_hi, my_lo + per);

  fd::Online<D> st(smem, g, bs);
  st.init(q + ((size_t)b * H + h * g) * D);
  for (int c = my_lo; c < my_hi; ++c) {
    const int blk = tables[(size_t)b * row_stride + c];
    // a -1 hole or another rank's block: uniform skip
    if (blk < base || blk >= base + n_loc) continue;
    const size_t blk0 = (size_t)(blk - base) * bs;
    st.step(
        kp, vp, bs,
        [&](int t) { return ((blk0 + t) * KVH + h) * D; },
        [&](int t) {
          const int pos = c * bs + t;
          return pos < cl && (window <= 0 || pos >= cl - window);
        },
        scale);
  }
  st.store(part + ((((size_t)lr * B + b) * n_split + sp) * H + h * g) *
                      (D + 2));
}

template <typename T, int D>
int launch(const symm::Ptrs& Q, const symm::Ptrs& K, const symm::Ptrs& V,
           const symm::Ptrs& CL, const symm::Ptrs& TB, int row_stride,
           const symm::Ranks& R, int n_local, int n_loc, float* part,
           void* out, int B, int H, int KVH, int bs, int C, int n_split,
           float scale, int window, int mode, int chunks,
           const symm::Peers& P, cudaStream_t stream) {
  const int g = H / KVH;
  const size_t smem = fd::part1_smem(g, D, bs);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fd_paged_partial<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fd_paged_partial<T, D><<<dim3(B, KVH, n_local * n_split), NT, smem,
                           stream>>>(Q, K, V, CL, TB, row_stride, R, n_loc,
                                     part, B, H, KVH, bs, C, n_split, scale,
                                     window);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return fd::launch_part2<T, D>(mode, part, out, n_local, B, H, n_split,
                                chunks, R, P, stream);
}

template <typename T>
int by_dim(int D, const symm::Ptrs& Q, const symm::Ptrs& K,
           const symm::Ptrs& V, const symm::Ptrs& CL, const symm::Ptrs& TB,
           int row_stride, const symm::Ranks& R, int n_local, int n_loc,
           float* part, void* out, int B, int H, int KVH, int bs, int C,
           int n_split, float scale, int window, int mode, int chunks,
           const symm::Peers& P, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(Q, K, V, CL, TB, row_stride, R, n_local, n_loc,
                           part, out, B, H, KVH, bs, C, n_split, scale,
                           window, mode, chunks, P, s);
    case 64:
      return launch<T, 64>(Q, K, V, CL, TB, row_stride, R, n_local, n_loc,
                           part, out, B, H, KVH, bs, C, n_split, scale,
                           window, mode, chunks, P, s);
    case 128:
      return launch<T, 128>(Q, K, V, CL, TB, row_stride, R, n_local, n_loc,
                            part, out, B, H, KVH, bs, C, n_split, scale,
                            window, mode, chunks, P, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch pair on one device for its n_local ranks (ids ranks[]).
// Per local rank: q (B, H, D); k/v pool shard (n_loc, bs, KVH, D)
// contiguous, q's dtype, holding global blocks [rank * n_loc,
// (rank + 1) * n_loc); cur_len (B,) int32; tables (B, >= C) int32 with
// row stride row_stride. part: fp32 scratch (n_local, B, n_split, H,
// D + 2). out: (n_local, B, H, D) in q's dtype for mode 0 (NORMAL, W = 1)
// and 2 (FUSED), fp32 (n_local, B, H, D + 2) for mode 1 (PARTIAL).
// FUSED only: the symmetric buffers' pointer tables (device arrays of W
// entries), the mesh size W, flags per source, the call's epoch, one
// source's slot bytes and the inbox parity stride; `chunks` blocks per
// rank. window <= 0 means no sliding window. dtype: 0 = float32,
// 1 = bfloat16. Returns the first cudaError_t (0 = launched).
extern "C" int fd_paged_launch(
    const void* const* q, const void* const* kp, const void* const* vp,
    const void* const* cur_len, const void* const* tables, int row_stride,
    const int* ranks, int n_local, void* part, void* out, int B, int H,
    int KVH, int D, int bs, int n_loc, int C, int n_split, float scale,
    int window, int dtype, int mode, int chunks, const void* inbox_tab,
    const void* flag_tab, int W, int n_chunk, unsigned epoch,
    long long slot_bytes, long long half, void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 ||
      (H / KVH) * D > fd::NT * fd::ACCN || bs <= 0 || C <= 0 ||
      n_split <= 0 || n_local <= 0 || n_local > symm::MAX_RANKS ||
      n_loc <= 0)
    return (int)cudaErrorInvalidValue;
  symm::Ptrs Q, K, V, CL, TB;
  symm::Ranks R;
  for (int i = 0; i < n_local; ++i) {
    Q.p[i] = q[i];
    K.p[i] = kp[i];
    V.p[i] = vp[i];
    CL.p[i] = cur_len[i];
    TB.p[i] = tables[i];
    R.r[i] = ranks[i];
  }
  const symm::Peers P = symm::make_peers(inbox_tab, flag_tab, W, n_chunk,
                                         epoch, slot_bytes, half);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return by_dim<float>(D, Q, K, V, CL, TB, row_stride, R, n_local, n_loc,
                         p, out, B, H, KVH, bs, C, n_split, scale, window,
                         mode, chunks, P, s);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(D, Q, K, V, CL, TB, row_stride, R, n_local,
                                 n_loc, p, out, B, H, KVH, bs, C, n_split,
                                 scale, window, mode, chunks, P, s);
  return (int)cudaErrorInvalidValue;
}
