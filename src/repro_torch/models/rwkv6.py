"""RWKV6 "Finch" block: attention-free time mix with data-dependent decay
(port of ``repro.models.rwkv6``).

Recurrence per head (dk = dv = 64), decay on the key index d:
    out_t = r_t · (S_{t-1} + diag(u) k_t ⊗ v_t)
    S_t   = diag(w_t) S_{t-1} + k_t ⊗ v_t
with w_t = exp(-exp(w0 + lora(x_shift_t))), the per-step log-decay
clamped to [-CLAMP, 0).

Train/prefill runs JAX's chunked-parallel form (:func:`wkv_chunked`,
chunks of CHUNK steps, a Python loop carrying the state across chunks).
Decode runs the recurrence itself (:func:`wkv_step`), which is what the
chunked form computes at one step (JAX decodes through it at L = 1), and
writes the slot state IN PLACE. Every projection, the fp32 LoRA of the
decay included, goes through the GEMM kernel (``layers.dense``).
``w0``, ``w_lora_a``, ``w_lora_b``, ``u`` and ``gn_scale`` are read as
fp32 masters (``lm.storage_dtype``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_norm, dense, norm_spec, select_
from repro_torch.models.module import Param

HEAD = 64
CHUNK = 16
CLAMP = 4.6  # per-step |log decay| bound
LORA = 64


def rwkv_spec(cfg):
    d = cfg.d_model
    return {
        "ln_t": norm_spec(d, "layernorm"),
        "ln_c": norm_spec(d, "layernorm"),
        # time-mix
        "mu_r": Param((d,), init="uniform", scale=0.5, axes=(None,)),
        "mu_k": Param((d,), init="uniform", scale=0.5, axes=(None,)),
        "mu_v": Param((d,), init="uniform", scale=0.5, axes=(None,)),
        "mu_g": Param((d,), init="uniform", scale=0.5, axes=(None,)),
        "mu_w": Param((d,), init="uniform", scale=0.5, axes=(None,)),
        "wr": Param((d, d), init="scaled", axes=("embed", None)),
        "wk": Param((d, d), init="scaled", axes=("embed", None)),
        "wv": Param((d, d), init="scaled", axes=("embed", None)),
        "wg": Param((d, d), init="scaled", axes=("embed", None)),
        "wo": Param((d, d), init="scaled", axes=(None, "embed")),
        "w0": Param((d,), init="uniform", scale=1.0, axes=(None,)),
        "w_lora_a": Param((d, LORA), init="scaled", axes=("embed", None)),
        "w_lora_b": Param((LORA, d), init="zeros", axes=(None, None)),
        "u": Param((d,), init="uniform", scale=0.5, axes=(None,)),
        "gn_scale": Param((d,), init="ones", axes=(None,)),
        # channel-mix
        "mu_ck": Param((d,), init="uniform", scale=0.5, axes=(None,)),
        "ck": Param((d, cfg.d_ff), init="scaled", axes=("embed", "mlp")),
        "cv": Param((cfg.d_ff, d), init="scaled", axes=("mlp", "embed")),
    }


def _shift(x, x_prev=None):
    """x_{t-1} along seq; the first position takes x_prev (or zeros)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def _log_decay(params, xw):
    """The per-channel log-decay in [-CLAMP, 0): w0 + the fp32 LoRA
    tanh(xw A) B, two fp32 GEMM launches."""
    lora = dense(torch.tanh(dense(xw.float(), params["w_lora_a"].float())),
                 params["w_lora_b"].float())
    return -torch.clamp(torch.exp(params["w0"].float() + lora), 1e-6, CLAMP)


def wkv_chunked(r, k, v, lw, u, S0=None):
    """r, k, v, lw (log-decay): (B, L, H, D) fp32; u: (H, D). Returns
    (out (B, L, H, D), S_last (B, H, D, D)); L divides by CHUNK (or is
    shorter)."""
    B, L, H, D = r.shape
    c = min(CHUNK, L)
    if L % c:
        raise ValueError(f"wkv_chunked: sequence {L} does not divide by "
                         f"the chunk {c}")
    nc = L // c
    rs, ks, vs, lws = (t.reshape(B, nc, c, H, D) for t in (r, k, v, lw))
    cs = torch.cumsum(lws, dim=2)                      # inclusive
    cs_ex = cs - lws                                   # exclusive

    # within chunk: att[t, j] = sum_d r_td k_jd exp(cs_ex_t - cs_j), j < t
    r_in = rs * torch.exp(cs_ex)                       # <= |r|
    k_in = ks * torch.exp(-cs)                         # bounded by the clamp
    att = torch.einsum("bzthd,bzjhd->bzhtj", r_in, k_in)
    tri = torch.ones((c, c), dtype=r.dtype, device=r.device).tril(-1)
    att = att * tri
    diag = torch.einsum("bzthd,hd,bzthd->bzth", rs, u, ks)   # u bonus
    y_in = (torch.einsum("bzhtj,bzjhd->bzthd", att, vs)
            + diag[..., None] * vs)

    # chunk end state: S_z = diag(exp(cs_end)) S_{z-1} + sum_j ...
    kw = ks * torch.exp(cs[:, :, -1:] - cs)
    S_add = torch.einsum("bzjhd,bzjhe->bzhde", kw, vs)   # (B,nc,H,D,D)
    chunk_dec = torch.exp(cs[:, :, -1])                # (B,nc,H,D)
    S = torch.zeros((B, H, D, D), dtype=r.dtype, device=r.device) \
        if S0 is None else S0
    prevs = []
    for z in range(nc):
        prevs.append(S)
        S = S * chunk_dec[:, z, ..., None] + S_add[:, z]
    S_prev = torch.stack(prevs, dim=1)                 # (B,nc,H,D,D)

    # cross-chunk: y_t += (r_t * exp(cs_ex_t)) · S_prev
    y_cross = torch.einsum("bzthd,bzhde->bzthe", r_in, S_prev)
    return (y_in + y_cross).reshape(B, L, H, D), S


def wkv_step(r, k, v, lw, u, S):
    """One step of the recurrence. r, k, v, lw: (B, H, D) fp32; u: (H,
    D); S: (B, H, D, D). Returns (out (B, H, D), S')."""
    diag = (r * u * k).sum(dim=-1, keepdim=True)       # (B,H,1)
    out = diag * v + torch.einsum("bhd,bhde->bhe", r, S)
    S_new = S * torch.exp(lw)[..., None] + k[..., :, None] * v[..., None, :]
    return out, S_new


def _group_norm(y, params, g, dtype):
    """Per-head GroupNorm (population variance, eps 64e-5), the fp32
    ``gn_scale``, then the gate: (B, L, H, D) fp32 -> (B, L, d)."""
    B, L = y.shape[:2]
    mu = y.mean(dim=-1, keepdim=True)
    var = (y - mu).square().mean(dim=-1, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y = y.reshape(B, L, -1) * params["gn_scale"].float()
    return y.to(dtype) * g


def _time_inputs(params, x, xs):
    """r, k, v (B, L, H, D) fp32, the gate g and the log-decay lw."""
    B, L, d = x.shape
    nh = d // HEAD

    def proj(mu, w):
        return dense(_mix(x, xs, params[mu].to(x.dtype)), params[w])
    r, k, v = (proj(f"mu_{n}", f"w{n}").reshape(B, L, nh, HEAD).float()
               for n in "rkv")
    g = F.silu(proj("mu_g", "wg"))
    lw = _log_decay(params, _mix(x, xs, params["mu_w"].to(x.dtype)))
    return r, k, v, g, lw.reshape(B, L, nh, HEAD)


def apply_rwkv_timemix(params, x, cfg):
    """Train/prefill time mix from a zero state. x: (B, L, d), the
    ``ln_t`` output."""
    nh = x.shape[-1] // HEAD
    r, k, v, g, lw = _time_inputs(params, x, _shift(x))
    y, _ = wkv_chunked(r, k, v, lw, params["u"].float().reshape(nh, HEAD))
    return dense(_group_norm(y, params, g, x.dtype), params["wo"])


def apply_rwkv_channelmix(params, x, cfg, x_prev=None):
    """relu² channel mix. x: (B, L, d), the ``ln_c`` output."""
    xk = _mix(x, _shift(x, x_prev), params["mu_ck"].to(x.dtype))
    return dense(torch.square(F.relu(dense(xk, params["ck"]))), params["cv"])


def apply_rwkv_block(params, x, cfg):
    """Train/prefill block. x: (B, L, d) -> (B, L, d)."""
    x = x + apply_rwkv_timemix(params, apply_norm(params["ln_t"], x,
                                                  "layernorm"), cfg)
    return x + apply_rwkv_channelmix(params, apply_norm(params["ln_c"], x,
                                                        "layernorm"), cfg)


def init_rwkv_state(cfg, batch: int, dtype=torch.bfloat16, device="cpu"):
    """One layer's decode state: the last ``ln_t`` and ``ln_c`` outputs
    in ``dtype`` and the WKV state S in fp32."""
    d = cfg.d_model
    nh = d // HEAD
    return {"x_prev_t": torch.zeros((batch, 1, d), dtype=dtype, device=device),
            "x_prev_c": torch.zeros((batch, 1, d), dtype=dtype, device=device),
            "S": torch.zeros((batch, nh, HEAD, HEAD), dtype=torch.float32,
                             device=device)}


def apply_rwkv_decode(params, x, state, cfg, active):
    """One-token block. x: (B, 1, d); state: this layer's {"x_prev_t",
    "x_prev_c", "S"} (views into the stacked state), updated IN PLACE
    for the slots of ``active`` (B,) bool, the others byte-identical.
    Returns x (B, 1, d)."""
    B, _, d = x.shape
    nh = d // HEAD
    t_in = apply_norm(params["ln_t"], x, "layernorm")
    r, k, v, g, lw = _time_inputs(params, t_in, state["x_prev_t"])
    y, S = wkv_step(r[:, 0], k[:, 0], v[:, 0], lw[:, 0],
                    params["u"].float().reshape(nh, HEAD), state["S"])
    x = x + dense(_group_norm(y[:, None], params, g, x.dtype), params["wo"])
    c_in = apply_norm(params["ln_c"], x, "layernorm")
    x = x + apply_rwkv_channelmix(params, c_in, cfg, state["x_prev_c"])
    select_(active, state["x_prev_t"], t_in)
    select_(active, state["x_prev_c"], c_in)
    select_(active, state["S"], S)
    return x
