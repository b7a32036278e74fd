"""Mamba2 (SSD) block, the zamba2 backbone (port of
``repro.models.mamba2``).

Train/prefill runs the chunked SSD form: inside a chunk the state-space
mixing is a masked quadratic form, across chunks a Python loop carries
the (heads, state, headdim) SSM state. Decode is the exact one-token
recurrence with a rolling conv state, written IN PLACE into the slot
state (inactive slots keep theirs byte-identical).

The in and out projections go through the GEMM kernel
(``layers.dense``; over W ranks the paper's AG+GEMM and GEMM+RS sites,
:func:`apply_mamba_ranks`); the scan and the recurrence are plain PyTorch ops,
as JAX leaves them to XLA. ``A_log``, ``dt_bias``, ``D`` and
``norm_scale`` are read as fp32 masters (``lm.storage_dtype``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import collective_matmul as cm
from repro_torch.core import patterns
from repro_torch.distributed import context as dctx
from repro_torch.models.layers import dense, select_
from repro_torch.models.module import Param

HEAD = 64                 # SSM head dim


def dims(cfg) -> tuple[int, int, int]:
    """(d_in, state size n, heads nh) of ``cfg``'s Mamba2 layer."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, cfg.ssm_state, d_in // HEAD


def mamba_spec(cfg):
    d = cfg.d_model
    d_in, n, nh = dims(cfg)
    conv_ch = d_in + 2 * n                # x + B + C (ngroups=1)
    return {
        # order: [z, x, B, C, dt]
        "in_proj": Param((d, 2 * d_in + 2 * n + nh), init="scaled",
                         axes=("embed", "ssm_inner")),
        "conv_w": Param((cfg.ssm_conv_width, conv_ch), init="scaled",
                        axes=("conv_width", None)),
        "conv_b": Param((conv_ch,), init="zeros", axes=(None,)),
        "A_log": Param((nh,), init="uniform", scale=1.0, axes=(None,)),
        "dt_bias": Param((nh,), init="zeros", axes=(None,)),
        "D": Param((nh,), init="ones", axes=(None,)),
        "norm_scale": Param((d_in,), init="ones", axes=(None,)),
        "out_proj": Param((d_in, d), init="scaled", axes=("ssm_inner", "embed")),
    }


def _split(cfg, zxbcdt):
    """z, x, B, C, dt along the last dim of the in-projection."""
    d_in, n, nh = dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in, n, n, nh], dim=-1)


def _dconv(x, w, b):
    """Causal depthwise conv over seq. x: (B, L, C); w: (K, C)."""
    K, L = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + L, :] * w[i] for i in range(K))
    return out + b


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-off
    (``F.softplus`` returns x above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """x: (b, l, h, p), dt: (b, l, h), A: (h,), Bm, Cm: (b, l, n). Returns
    (y (b, l, h, p), h_last (b, h, n, p)).

    h_t = exp(A dt_t) h_{t-1} + dt_t (B_t ⊗ x_t);  y_t = C_t · h_t
    """
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    c = min(chunk, l)
    if l % c:
        raise ValueError(f"ssd_chunked: sequence {l} does not divide by "
                         f"the chunk {c}")
    nc = l // c
    xr = x.reshape(b, nc, c, h, p)
    dtr = dt.reshape(b, nc, c, h)
    Br = Bm.reshape(b, nc, c, n)
    Cr = Cm.reshape(b, nc, c, n)

    dA = dtr * A                                          # (b,nc,c,h) <= 0
    cs = torch.cumsum(dA, dim=2)                          # inclusive

    # intra-chunk: decay(i, j) = exp(cs_i - cs_j) for j <= i. The mask
    # goes in BEFORE exp: the upper triangle's diff > 0 can overflow, and
    # where(mask, exp(diff), 0) would put 0 * inf = NaN into the backward
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]    # (b,nc,i,j,h)
    mask = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    Lm = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                               float("-inf")))
    cb = torch.einsum("bzin,bzjn->bzij", Cr, Br)
    att = cb[..., None] * Lm * dtr[:, :, None, :, :]      # (b,nc,i,j,h)
    y_diag = torch.einsum("bzijh,bzjhp->bzihp", att, xr)

    # chunk end-states: S_z = sum_j exp(cs_end - cs_j) dt_j B_j ⊗ x_j
    w = torch.exp(cs[:, :, -1:, :] - cs) * dtr            # (b,nc,c,h)
    S = torch.einsum("bzch,bzcn,bzchp->bzhnp", w, Br, xr)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA.sum(dim=2))                # (b,nc,h)
    carry = torch.zeros((b, h, n, p), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    prevs = []
    for z in range(nc):
        prevs.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + S[:, z]
    h_prevs = torch.stack(prevs, dim=1)                   # (b,nc,h,n,p)

    # off-diagonal: y_i += C_i · exp(cs_i) · H_prev
    y_off = torch.einsum("bzcn,bzhnp,bzch->bzchp", Cr, h_prevs,
                         torch.exp(cs))
    return (y_diag + y_off).reshape(b, l, h, p), carry


def _gate_norm(y, z, params, dtype):
    """y * silu(z), then RMSNorm over all of d_in (eps 1e-6) with the
    fp32 ``norm_scale``; output in ``dtype``."""
    y = y.to(dtype) * F.silu(z)
    y32 = y.float()
    var = y32.square().mean(dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + 1e-6) * params["norm_scale"]).to(dtype)


def _mix(params, zxbcdt, cfg, dtype, chunk):
    """The block between its projections: the causal conv, the chunked
    SSD scan and the gated RMSNorm of the whole in-projection output
    ``zxbcdt`` (B, L, 2 d_in + 2n + nh). Returns y (B, L, d_in) in
    ``dtype``."""
    d_in, n, nh = dims(cfg)
    z, xs, Bm, Cm, dt = _split(cfg, zxbcdt)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv = F.silu(_dconv(conv_in, params["conv_w"].to(dtype),
                         params["conv_b"].to(dtype)))
    xs, Bm, Cm = torch.split(conv, [d_in, n, n], dim=-1)
    dt = softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = xs.reshape(*xs.shape[:-1], nh, HEAD).float()
    y, _ = ssd_chunked(xh, dt, A, Bm.float(), Cm.float(), chunk)
    y = y + xh * params["D"].float()[:, None]
    return _gate_norm(y.reshape(*xs.shape[:-1], d_in), z, params, dtype)


def apply_mamba(params, x, cfg, chunk: int = 64):
    """Train/prefill. x: (B, L, d) -> (B, L, d); L divides by ``chunk``
    (or is shorter)."""
    y = _mix(params, dense(x, params["in_proj"]), cfg, x.dtype, chunk)
    return dense(y, params["out_proj"])


def apply_mamba_ranks(params, x, cfg, *, seq_sharded: bool,
                      chunk: int = 64):
    """Train/prefill over the W ranks of the ambient mesh (W = 1 is
    :func:`apply_mamba`). params: per rank the layer's shards by JAX's
    rules: ``in_proj`` column block r of the fused ``[z | x | B | C |
    dt]`` dim (``ssm_inner``; replicated where that width does not
    divide by W), ``out_proj`` row block r (whole heads when the heads
    divide by W), the rest replicated; x: per rank (B, L/W, d), the
    rank's rows (``seq_sharded``), or (B, L, d).

    The in-projection is the AG+GEMM site (``patterns.project_up``); its
    column blocks, which cut through z and x, are all-gathered, and
    every rank runs the conv, the scan and the gated norm over the whole
    sequence and width (the scan is batch-local and needs the gathered
    sequence; the norm spans all of d_in); each rank multiplies its
    columns of y by its rows of ``out_proj`` at the GEMM+RS site
    (``patterns.project_down``). Returns per rank the layout of ``x``."""
    W = len(x)
    if W == 1:
        return [apply_mamba(params[0], x[0], cfg, chunk)]
    d_in, n, nh = dims(cfg)
    (zx,) = patterns.project_up(x, [[p["in_proj"] for p in params]],
                                seq_axis_sharded=seq_sharded)
    if zx[0].shape[-1] != 2 * d_in + 2 * n + nh:
        zx = cm.all_gather(zx, gather_axis=-1)
    y = [_mix(p, zr, cfg, xr.dtype, chunk)
         for p, zr, xr in zip(params, zx, x)]
    k = params[0]["out_proj"].shape[0]
    if k == d_in:               # replicated: every rank its rows
        out = [dense(yr, p["out_proj"]) for p, yr in zip(params, y)]
        m = x[0].shape[1]
        return [o.narrow(1, r * m, m) if seq_sharded else o
                for r, o in enumerate(out)]
    return patterns.project_down(
        [yr[..., r * k:(r + 1) * k].contiguous() for r, yr in enumerate(y)],
        [p["out_proj"] for p in params])


def init_mamba_cache(cfg, batch: int, dtype=torch.bfloat16, device="cpu"):
    """One layer's decode state: the conv window's last K - 1 inputs in
    ``dtype`` and the SSM state in fp32."""
    d_in, n, nh = dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_in + 2 * n),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, nh, n, HEAD), dtype=torch.float32,
                               device=device)}


def apply_mamba_decode(params, x, cache, cfg, active):
    """One-token decode. x: (B, 1, d); cache: this layer's {"conv",
    "ssm"} (views into the stacked state), updated IN PLACE for the
    slots of ``active`` (B,) bool, the others byte-identical. Returns
    y (B, 1, d)."""
    y = _decode_mix(params, dense(x, params["in_proj"]), cache, cfg, active,
                    x.dtype)
    return dense(y, params["out_proj"])


def apply_mamba_decode_ranks(params, x, caches, cfg, active, split):
    """One-token decode over the W ranks of the ambient mesh, JAX's
    ``apply_mamba_decode`` on sharded weights: params per rank
    (``in_proj`` column block, ``out_proj`` row block, the rest
    replicated), x, caches (this layer's) and active per distinct
    device. The in_proj runs one GEMM a rank over its columns, the
    blocks all-gathered to every device (they cut through z and x), so
    the conv, the SSM update and the readout run whole on each device on
    its replicated state, as in :func:`apply_mamba_ranks`; ``out_proj``
    is the row-parallel site (``patterns.project_k_sharded``). ``split``
    (the layer's ``lm.split_axes``) says which projections are a rank's
    block; whole weights run once per device. Returns per device y (B,
    1, d)."""
    ctx = dctx.current()
    mesh = ctx.mesh
    dev = dctx.by_device(params)
    cols = split["in_proj"] is not None
    rows = split["out_proj"] is not None
    if ctx.data is not None:
        return _decode_data(params, dev, x, caches, cfg, active, cols, rows)
    if not (cols or rows):
        return [apply_mamba_decode(p, xd, c, cfg, a)
                for p, xd, c, a in zip(dev, x, caches, active)]
    (zx,) = patterns.gather_columns(x, [[p["in_proj"] for p in params]],
                                    [cols])
    y = [_decode_mix(p, z, c, cfg, a, xd.dtype)
         for p, z, c, a, xd in zip(dev, zx, caches, active, x)]
    if not rows:
        return [dense(yd, p["out_proj"]) for p, yd in zip(dev, y)]
    return dctx.by_device(patterns.project_k_sharded(
        mesh.per_rank(y), [p["out_proj"] for p in params], rows=True))


def _decode_data(params, dev, x, caches, cfg, active, cols, rows):
    """:func:`apply_mamba_decode_ranks` over a mesh with data groups (the
    ambient ``DistContext.data``; the weight sites on data group 0's
    model ranks, weights-stationary): the in_proj on the whole batch,
    the conv and SSM step of each group's rows on its own copy of the
    state (``patterns.over_groups``: the state's batch is on ``("pod",
    "data")``), the rows joined, then ``out_proj``."""
    mesh = dctx.current().mesh
    if cols:
        (zx,) = patterns.gather_columns(
            x, [[p["in_proj"] for p in params]], [True])
    else:
        zx = [dense(xd, p["in_proj"]) for p, xd in zip(dev, x)]
    y = patterns.over_groups(
        lambda p, c, z, a: _decode_mix(p, z, c, cfg, a, x[0].dtype),
        dev[0], caches, zx[0], active[0])
    y = [cm.to_device(y, xd.device) for xd in x]
    if not rows:
        return [dense(yd, p["out_proj"]) for p, yd in zip(dev, y)]
    return dctx.by_device(patterns.project_k_sharded(
        mesh.per_rank(y), [p["out_proj"] for p in params], rows=True))


def _decode_mix(params, zxbcdt, cache, cfg, active, dtype):
    """The decode step between the projections: the conv window, the
    SSM update, the readout and the gated norm over the in-projection's
    output ``zxbcdt`` (B, 1, 2 d_in + 2 n + nh); writes ``cache`` IN
    PLACE for the slots of ``active``. Returns y (B, 1, d_in)."""
    d_in, n, nh = dims(cfg)
    z, xs, Bm, Cm, dt = _split(cfg, zxbcdt)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)             # (B,1,C)
    hist = torch.cat([cache["conv"], conv_in], dim=1)     # (B,K,C)
    w = params["conv_w"].to(dtype)
    conv = F.silu((hist * w).sum(dim=1)
                  + params["conv_b"].to(dtype))[:, None, :]
    xs, Bm, Cm = torch.split(conv, [d_in, n, n], dim=-1)
    dt = softplus(dt.float() + params["dt_bias"].float())[:, 0]  # (B,nh)
    A = -torch.exp(params["A_log"].float())
    xh = xs[:, 0].reshape(-1, nh, HEAD).float()           # (B,nh,64)
    dec = torch.exp(dt * A)                               # (B,nh)
    upd = torch.einsum("bh,bn,bhp->bhnp", dt, Bm[:, 0].float(), xh)
    ssm = cache["ssm"] * dec[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), ssm)
    y = y + xh * params["D"].float()[:, None]
    y = _gate_norm(y.reshape(-1, 1, d_in), z, params, dtype)
    select_(active, cache["conv"], hist[:, 1:])
    select_(active, cache["ssm"], ssm)
    return y

