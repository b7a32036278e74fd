"""Parameter declarations and seeded materialization (port of
``repro.models.module``).

A *spec tree* is a nested dict of :class:`Param` leaves. As JAX's init
splits one key per leaf, every leaf draws from its own
``torch.Generator``, seeded from the run's seed and the leaf's dotted
path by a stable hash (:func:`leaf_seed`), and a layer-stacked leaf is
drawn one layer slice at a time, in layer order (:func:`draws`). So a
rank can draw any leaf, or any slice, alone:
``distributed.sharding_rules.make_shards`` builds a whole tree, or each
rank's blocks, from these draws (``models.lm.init_params``), and one
seed gives the same numbers on every mesh. The numbers are
bit-identical across devices of one kind (CUDA's draw may depend on the
card's SM count: the same numbers on cards of one model; CPU and CUDA
generators differ), and they differ from ``jax.random``'s for the same
seed: tests that compare the two packages convert the JAX tree instead
(``repro_torch.convert.params_from_numpy``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Param:
    """Declaration of one parameter leaf."""

    shape: tuple[int, ...]
    dtype: Any = torch.float32
    init: str = "normal"          # normal | zeros | ones | scaled | uniform
    scale: float | None = None     # stddev override; default fan-in scaling
    axes: tuple[str | None, ...] = ()  # logical axis names, len == ndim

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank != shape {self.shape} rank")


LAYER_AXIS = "layers"        # the leading axis of a layer-stacked leaf


def leaf_seed(seed: int, path: str) -> int:
    """The generator seed of the leaf at dotted ``path``: a stable hash of
    (``seed``, ``path``), never Python's salted ``hash``, so every process
    and every rank draws the same leaf."""
    h = hashlib.blake2b(f"{int(seed)}:{path}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def constant(p: Param) -> float | None:
    """The value every entry of a ``zeros`` / ``ones`` leaf takes (made
    at any shape without a draw); None for a drawn leaf."""
    return {"zeros": 0.0, "ones": 1.0}.get(p.init)


def stacked(p: Param) -> bool:
    """Whether ``p`` is layer-stacked (:func:`stack_layer_specs`)."""
    return bool(p.axes) and p.axes[0] == LAYER_AXIS


def _sample(gen, p: Param, shape, fan_in: int, device) -> torch.Tensor:
    """One draw of ``shape`` for ``p``'s init, scaled in place."""
    if p.init == "uniform":
        scale = p.scale if p.scale is not None else 1.0
        x = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32)
        return x.mul_(2 * scale).sub_(scale).to(p.dtype)
    if p.init == "normal":
        std = p.scale if p.scale is not None else 0.02
    elif p.init == "scaled":
        scale = p.scale if p.scale is not None else 1.0
        std = scale / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {p.init!r}")
    x = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.float32)
    return x.mul_(std).to(p.dtype)


def draws(p: Param, *, seed: int, path: str, device):
    """The values of the drawn leaf ``p`` at dotted ``path``, on
    ``device``, from its own generator (:func:`leaf_seed`): ``(l, layer
    slice l)`` for every layer in order where ``p`` is layer-stacked,
    else one ``(None, the whole leaf)``; each in ``p.dtype``, so the
    largest draw alive is one slice or one unstacked leaf. The
    ``"scaled"`` init's fan-in is the whole leaf's ``shape[0]``, which
    for a stacked leaf is the layer count: it mirrors
    ``repro.models.module._materialize`` as written, so the port builds
    the JAX package's model."""
    if constant(p) is not None:
        raise ValueError(f"{path}: a {p.init} leaf is not drawn")
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, path))
    fan_in = p.shape[0] if p.shape else 1
    if not stacked(p):
        yield None, _sample(gen, p, p.shape, fan_in, device)
        return
    for layer in range(p.shape[0]):
        yield layer, _sample(gen, p, p.shape[1:], fan_in, device)


def leaf_values(p: Param, *, seed: int, path: str, device):
    """What ``distributed.sharding_rules.make_shards`` takes of the leaf
    ``p`` at dotted ``path``: its :func:`constant`, or its
    :func:`draws`."""
    c = constant(p)
    return c if c is not None else draws(p, seed=seed, path=path,
                                         device=device)


def tree_items(tree, prefix: str = ""):
    """Yield ``(dotted_path, leaf)`` in sorted-key order."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from tree_items(v, path)
        else:
            yield path, v


def tree_map(fn, tree):
    """Apply ``fn(path, leaf)`` to every leaf; same nesting out."""
    def go(t, prefix):
        out = {}
        for k, v in t.items():
            path = f"{prefix}.{k}" if prefix else k
            out[k] = go(v, path) if isinstance(v, dict) else fn(path, v)
        return out
    return go(tree, "")


def stack_layer_specs(spec, n_layers: int, layer_axis: str = LAYER_AXIS):
    """Turn a single-layer Param spec into a layer-stacked spec: every
    leaf gains a leading ``n_layers`` dim (the JAX scan layout)."""
    def _stack(_, p: Param) -> Param:
        return Param(shape=(n_layers,) + p.shape, dtype=p.dtype,
                     init=p.init, scale=p.scale,
                     axes=(layer_axis,) + tuple(p.axes))
    return tree_map(_stack, spec)
