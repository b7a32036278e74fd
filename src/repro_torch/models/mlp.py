"""Feed-forward blocks (port of ``repro.models.mlp``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import patterns
from repro_torch.distributed import context as dctx
from repro_torch.models.layers import dense, dense_group
from repro_torch.models.module import Param


def mlp_spec(cfg):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {
            "wg": Param((d, f), init="scaled", axes=("embed", "mlp")),
            "wu": Param((d, f), init="scaled", axes=("embed", "mlp")),
            "wd": Param((f, d), init="scaled", axes=("mlp", "embed")),
        }
    return {
        "wu": Param((d, f), init="scaled", axes=("embed", "mlp")),
        "wd": Param((f, d), init="scaled", axes=("mlp", "embed")),
    }


def _act(cfg, g):
    if cfg.act == "swiglu":
        return F.silu(g)
    if cfg.act in ("geglu", "gelu"):
        return F.gelu(g, approximate="tanh")
    if cfg.act == "relu2":
        return torch.square(F.relu(g))
    raise ValueError(cfg.act)


def _names(cfg):
    return ("wg", "wu") if cfg.act in ("swiglu", "geglu") else ("wu",)


def _hidden(cfg, up):
    return _act(cfg, up[0]) * up[1] if len(up) == 2 else _act(cfg, up[0])


def apply_mlp(params, x, cfg):
    """One rank's block on the whole weights: x (..., d) -> (..., d);
    every projection is a GEMM-kernel call (the gate and up projections
    one grouped call). The decode block where the weights are
    replicated (:func:`apply_mlp_decode`)."""
    if cfg.act in ("swiglu", "geglu"):
        g, u = dense_group(x, [params["wg"], params["wu"]])
        h = _act(cfg, g) * u
    else:
        h = _act(cfg, dense(x, params["wu"]))
    return dense(h, params["wd"])


def apply_mlp_decode(params, x, cfg, split=None):
    """The decode block (S = 1) over the W ranks of the ambient mesh:
    params per rank {"wg", "wu" column blocks, "wd" row block} where
    ``split`` (the MLP's ``lm.split_axes``) names an axis, whole where
    it holds None; x per distinct device (B, 1, d), replicated. The
    gate and up projections
    run one grouped GEMM a rank over its columns; the hidden units stay
    on their rank (K-sliced) into ``wd`` at the row-parallel site
    (``patterns.project_k_sharded``), as JAX's ``apply_mlp_decode``.
    Whole weights (or W = 1) run :func:`apply_mlp` once a device. A
    tensor ``params``/``x`` pair is one rank (no ``split``). Returns per
    device (B, 1, d)."""
    if not isinstance(x, list):
        return apply_mlp(params, x, cfg)
    if split["wd"] is None:
        return [apply_mlp(p, xd, cfg)
                for p, xd in zip(dctx.by_device(params), x)]
    up = patterns.column_shards(x, [[p[n] for p in params]
                                    for n in _names(cfg)])
    h = [_hidden(cfg, u) for u in zip(*up)]
    return dctx.by_device(patterns.project_k_sharded(
        h, [p["wd"] for p in params], rows=True, x_sliced=True))


def apply_mlp_ranks(params, x, cfg, *, seq_sharded: bool):
    """The train/prefill block over the W ranks of the ambient mesh (W =
    1 included). params: per rank {"wg", "wu" column shards, "wd" row
    shard}; x: per rank (B, S/W, d), the rank's rows (``seq_sharded``),
    or (B, S, d). The up projections share the AG+GEMM site, the down
    projection is the GEMM+RS site (paper §4.1, ``core.patterns``); at W
    = 1 that is :func:`apply_mlp`'s three launches. Returns per rank the
    layout of ``x``."""
    up = patterns.project_up(x, [[p[n] for p in params]
                                 for n in _names(cfg)],
                             seq_axis_sharded=seq_sharded)
    return patterns.project_down([_hidden(cfg, u) for u in zip(*up)],
                                 [p["wd"] for p in params])
