"""Shared layers: norms, embeddings, rotary embeddings (port of
``repro.models.layers``)."""
from __future__ import annotations

import torch

from repro_torch.core import collective_matmul as cm
from repro_torch.kernels.matmul import matmul, matmul_group
from repro_torch.models.module import Param


# ---------------------------------------------------------------- norms
def norm_spec(d_model: int, kind: str = "rmsnorm"):
    if kind == "rmsnorm":
        return {"scale": Param((d_model,), init="ones", axes=("embed_no_fsdp",))}
    return {"scale": Param((d_model,), init="ones", axes=("embed_no_fsdp",)),
            "bias": Param((d_model,), init="zeros", axes=("embed_no_fsdp",))}


def apply_norm(params, x, kind: str = "rmsnorm", eps: float = 1e-6):
    """RMS or layer norm computed in fp32; output in ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    if kind == "rmsnorm":
        var = x.square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + eps) * params["scale"].float()
    else:
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        y = ((x - mu) * torch.rsqrt(var + eps) * params["scale"].float()
             + params["bias"].float())
    return y.to(dtype)


# ------------------------------------------------------------ embeddings
def embed_spec(vocab: int, d_model: int):
    return {"table": Param((vocab, d_model), init="normal", scale=0.02,
                           axes=("in_vocab", "in_embed"))}


def apply_embed(params, token_ids, dtype):
    return params["table"][token_ids].to(dtype)


def apply_unembed(params, x, dtype=torch.float32):
    """``x @ table.T`` with JAX's promotion: the product runs in the
    wider of the two dtypes (a bf16 ``x`` against the fp32 head table is
    an fp32 GEMM), then casts to ``dtype``. The table stays in its
    (vocab, d) layout; the GEMM kernel reads it transposed."""
    table = params["table"]
    wide = torch.promote_types(x.dtype, table.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(wide)

    def prod(a, ts):
        return [matmul(a, ts[0].to(wide), trans_b=True)]
    y = (cm.stationary(prod, x2, [table], kdim=1)[0]
         if isinstance(table, cm.Stationary) else prod(x2, [table])[0])
    return y.reshape(*lead, table.shape[0]).to(dtype)


# ----------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)      # (head_dim/2,)


def apply_rope(x, positions, theta: float):
    """Split-half rotation. x: (..., seq, heads, head_dim), positions:
    broadcastable to (..., seq)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)
    ang = positions[..., None].float() * inv          # (..., seq, hd/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- dense
def dense(x, w):
    """``x @ w`` for ``x`` (..., K) and a weight in the JAX (K, N) layout,
    through the GEMM kernel (its plain version for CPU tensors; a weight
    cut over ``data``, ``cm.Stationary``, block by block)."""
    return dense_group(x, [w])[0]


def dense_group(x, ws):
    """``[dense(x, w) for w in ws]`` in one GEMM launch (the products
    that share ``x``: wq/wk/wv, wg/wu); each output equals ``dense``'s
    bit for bit. Weights cut over ``data`` (``cm.Stationary``) run one
    launch a block (``cm.stationary``)."""
    if isinstance(ws[0], cm.Stationary):
        return cm.stationary(dense_group, x, ws, kdim=0)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    ws = [w.to(x.dtype) for w in ws]
    ys = (matmul_group(x2, ws) if len(ws) > 1 else [matmul(x2, ws[0])])
    return [y.reshape(*lead, w.shape[1]) for y, w in zip(ys, ws)]


def dense_group_ranks(xs, wss):
    """``[dense_group(x, ws) for x, ws in zip(xs, wss)]`` for this
    process's model ranks; weights cut over ``data`` across processes
    cross them in one collective for every rank
    (``cm.stationary_ranks``)."""
    if isinstance(wss[0][0], cm.Stationary):
        return cm.stationary_ranks(dense_group, xs, wss, kdim=0)
    return [dense_group(x, ws) for x, ws in zip(xs, wss)]


# ---------------------------------------------------------- slot state
def select_(active, old, new):
    """``old[b] = new[b]`` for the slots of ``active`` (B,) bool, IN
    PLACE (JAX's ``_sel_state``): the other slots keep their bytes, and
    ``old`` keeps its address (captured graphs replay on it)."""
    old.copy_(torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)),
                          new, old))
