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
// Here (fd_common.cuh):
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
//      order inside one cooperative launch per device (symm.cuh).
//
// What bounds it on the H100: the same stream of K/V bytes as the paged
// kernel -- each rank reads its own cur_len / W positions of every slot,
// 2 * KVH * D * sizeof(T) bytes each -- plus the W partials moved, at
// about one multiply-add per byte: memory (3.35 TB/s), not the tensor
// cores. Every needed K/V element is read once and shared by the g query
// heads of its KV head; splits keep a small batch from leaving SMs idle.
#include "fd_common.cuh"

namespace {

using fd::NT;
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

  fd::Online<D> st(smem, g, TILE);
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
  const size_t smem = fd::part1_smem(g, D, TILE);
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
  return fd::launch_part2<T, D>(mode, part, out, n_local, B, H, n_split,
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
// out, mode, chunks and the symmetric-buffer arguments as in
// fd_paged_launch (csrc/flash_decode_paged.cu). window <= 0 means no
// sliding window. dtype: 0 = float32, 1 = bfloat16. Returns the first
// cudaError_t (0 = launched).
extern "C" int fd_launch(const void* const* q, const void* const* kp,
                         const void* const* vp, const void* const* cur_len,
                         const int* ranks, int n_local, void* part,
                         void* out, int B, int H, int KVH, int D, int S_loc,
                         int n_split, float scale, int window, int dtype,
                         int mode, int chunks, const void* inbox_tab,
                         const void* flag_tab, int W, int n_chunk,
                         unsigned epoch, long long slot_bytes,
                         long long half, void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 ||
      (H / KVH) * D > fd::NT * fd::ACCN || S_loc <= 0 || n_split <= 0 ||
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
  const symm::Peers P = symm::make_peers(inbox_tab, flag_tab, W, n_chunk,
                                         epoch, slot_bytes, half);
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
