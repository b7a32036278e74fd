"""Feed-forward blocks (port of ``repro.models.mlp``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
    """x: (..., d) -> (..., d); every projection is a GEMM-kernel call
    (the gate and up projections one grouped call). At W = 1 the
    train/prefill and the decode blocks are the same."""
    if cfg.act in ("swiglu", "geglu"):
        g, u = dense_group(x, [params["wg"], params["wu"]])
        h = _act(cfg, g) * u
    else:
        h = _act(cfg, dense(x, params["wu"]))
    return dense(h, params["wd"])


apply_mlp_decode = apply_mlp
