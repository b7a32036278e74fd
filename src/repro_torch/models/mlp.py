"""Feed-forward blocks (port of ``repro.models.mlp``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import patterns
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


def apply_mlp(params, x, cfg):
    """One rank's block on the whole weights: x (..., d) -> (..., d);
    every projection is a GEMM-kernel call (the gate and up projections
    one grouped call). The decode block on every rank, where each holds
    every weight (``apply_mlp_decode``)."""
    if cfg.act in ("swiglu", "geglu"):
        g, u = dense_group(x, [params["wg"], params["wu"]])
        h = _act(cfg, g) * u
    else:
        h = _act(cfg, dense(x, params["wu"]))
    return dense(h, params["wd"])


apply_mlp_decode = apply_mlp


def apply_mlp_ranks(params, x, cfg, *, seq_sharded: bool):
    """The train/prefill block over the W ranks of the ambient mesh (W =
    1 included). params: per rank {"wg", "wu" column shards, "wd" row
    shard}; x: per rank (B, S/W, d), the rank's rows (``seq_sharded``),
    or (B, S, d). The up projections share the AG+GEMM site, the down
    projection is the GEMM+RS site (paper §4.1, ``core.patterns``); at W
    = 1 that is :func:`apply_mlp`'s three launches. Returns per rank the
    layout of ``x``."""
    names = ("wg", "wu") if cfg.act in ("swiglu", "geglu") else ("wu",)
    up = patterns.project_up(x, [[p[n] for p in params] for n in names],
                             seq_axis_sharded=seq_sharded)
    if len(names) == 2:
        h = [_act(cfg, g) * u for g, u in zip(*up)]
    else:
        h = [_act(cfg, u) for u in up[0]]
    return patterns.project_down(h, [p["wd"] for p in params])
