"""Paged GQA flash decode at W = 1 (port of the Pallas
``repro.kernels.flash_decode.flash_decode_paged_fused``).

:func:`flash_decode_paged` is the attention call of the paged decode
step. For CUDA tensors it launches the hand-written kernel in
``csrc/flash_decode_paged.cu`` (a partial pass over (slot, KV head,
split) blocks plus a combine pass); for CPU tensors it runs
:func:`paged_decode_plain`. A CUDA call the kernel cannot take raises.

Semantics (kernel and plain alike): slot ``b`` attends to the positions
``p < cur_len[b]`` (and ``p >= cur_len[b] - window`` with a window) that
its table slice maps to a block; ``-1`` table entries are holes and are
skipped. A slot with no valid position returns zeros (the dense
reference returns an average of garbage there; callers mask those rows).

Counters: ``flash_decode_paged.launches`` (kernel calls; each launches
the partial and the combine pass) and ``flash_decode_paged.plain_calls``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG = torch.finfo(torch.float32).min
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_THREADS, _ACC = 128, 8          # csrc: g * D <= NT * ACCN
_SM_COUNT: dict[int, int] = {}


def paged_decode_plain(q, k_pool, v_pool, cur_len, tables, scale,
                       window: int | None = None):
    """The kernel's function in plain PyTorch (fp32 softmax).

    q: (B, H, D); pools: (n_blocks, bs, KVH, D); cur_len: (B,) int;
    tables: (B, C) int (any strides). Returns (B, H, D) in q's dtype."""
    B, H, D = q.shape
    n_blocks, bs, KVH, _ = k_pool.shape
    C = tables.shape[1]
    g = H // KVH
    t = tables.long()
    idx = t.clamp(0, n_blocks - 1)
    kview = k_pool[idx].reshape(B, C * bs, KVH, D).float()
    vview = v_pool[idx].reshape(B, C * bs, KVH, D).float()
    pos = torch.arange(C * bs, device=q.device)
    cl = cur_len.long()[:, None]
    valid = (t >= 0).repeat_interleave(bs, dim=1) & (pos[None] < cl)
    if window is not None:
        valid = valid & (pos[None] >= cl - window)
    qg = q.float().reshape(B, KVH, g, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kview) * scale
    s = torch.where(valid[:, None, None, :], s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG / 2, 0.0, m)
    p = torch.where(valid[:, None, None, :], torch.exp(s - m_safe), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p, vview) / denom.clamp_min(1e-30)
    return o.reshape(B, H, D).to(q.dtype)


def _lib():
    lib = _build.load("flash_decode_paged")
    fn = lib.fd_paged_launch
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 5 + [i32] + [ptr] * 2 + [i32] * 7 + [
            ctypes.c_float, i32, i32, ptr]
        fn.restype = ctypes.c_int
    return fn


def n_splits(B: int, KVH: int, C: int, device) -> int:
    """Table entries per slot are walked by this many blocks: enough
    (slot, KV head, split) blocks for about two per SM, at most C."""
    idx = torch.device(device).index or 0
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    want = -(-2 * _SM_COUNT[idx] // max(B * KVH, 1))
    return max(1, min(C, 16, want))


def flash_decode_paged(q, k_pool, v_pool, cur_len, tables, scale,
                       window: int | None = None):
    """Paged decode attention. q: (B, H, D); k_pool/v_pool: (n_blocks,
    block_size, KVH, D); cur_len: (B,) int32 lengths including this
    step's token; tables: (B, C) int32 block ids (-1 = hole), possibly a
    leading ``[:, :gather_width]`` slice of a wider table. Returns
    (B, H, D) in q's dtype."""
    B, H, D = q.shape
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4 \
            or k_pool.shape[3] != D or H % k_pool.shape[2]:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if tables.dim() != 2 or tables.shape[0] != B or cur_len.shape != (B,):
        raise ValueError(f"tables {tuple(tables.shape)} / cur_len "
                         f"{tuple(cur_len.shape)} do not fit batch {B}")
    tensors = (q, k_pool, v_pool, cur_len, tables)
    if all(t.device.type == "cpu" for t in tensors):
        flash_decode_paged.plain_calls += 1
        return paged_decode_plain(q, k_pool, v_pool, cur_len, tables, scale,
                                  window)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("flash_decode_paged: all inputs must be CPU "
                         "tensors or on one CUDA device")
    n_blocks, bs, KVH, _ = k_pool.shape
    C = tables.shape[1]
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"kernel takes f32 or bf16 q and pools of the same "
                        f"dtype, got {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if cur_len.dtype != torch.int32 or tables.dtype != torch.int32:
        raise TypeError("cur_len and tables must be int32")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if D not in _HEAD_DIMS or (H // KVH) * D > _THREADS * _ACC:
        raise ValueError(f"kernel built for head dims {_HEAD_DIMS} with "
                         f"(H/KVH)*D <= {_THREADS * _ACC}; got D={D}, "
                         f"H={H}, KVH={KVH}")
    if not (q.is_contiguous() and k_pool.is_contiguous()
            and v_pool.is_contiguous() and cur_len.is_contiguous()):
        raise ValueError("q, pools and cur_len must be contiguous")
    if tables.stride(1) != 1:
        raise ValueError("table rows must be contiguous (a leading column "
                         "slice of a row-major table is fine)")
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_split = n_splits(B, KVH, C, q.device)
    part = torch.empty((B, n_split, H, D + 2), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                cur_len.data_ptr(), tables.data_ptr(), tables.stride(0),
                part.data_ptr(), out.data_ptr(), B, H, KVH, D, bs, C,
                n_split, float(scale), -1 if window is None else int(window),
                _DTYPES[q.dtype], stream)
    _build.check(rc, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
flash_decode_paged.plain_calls = 0
