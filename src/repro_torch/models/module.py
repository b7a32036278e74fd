"""Parameter declarations and seeded materialization (port of
``repro.models.module``).

A *spec tree* is a nested dict of :class:`Param` leaves; :func:`init_tree`
materializes it into a nested dict of tensors, drawing every leaf from
one ``torch.Generator`` in sorted-key order, so an init is reproducible
from its seed. The numbers differ from ``jax.random``'s for the same
seed: tests that compare the two packages convert the JAX tree instead
(``repro_torch.convert.params_from_numpy``).
"""
from __future__ import annotations

import dataclasses
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


def _materialize(gen: torch.Generator, p: Param, device) -> torch.Tensor:
    """Mirrors ``repro.models.module._materialize`` as written, including
    its fan-in: ``shape[0]``, which for a layer-stacked leaf is the layer
    count (kept so the port builds the JAX package's model)."""
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=device)
    if p.init == "normal":
        scale = p.scale if p.scale is not None else 0.02
        x = torch.randn(p.shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (x * scale).to(p.dtype)
    if p.init == "scaled":
        fan_in = p.shape[0] if p.shape else 1
        scale = p.scale if p.scale is not None else 1.0
        std = scale / math.sqrt(max(fan_in, 1))
        x = torch.randn(p.shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (x * std).to(p.dtype)
    if p.init == "uniform":
        scale = p.scale if p.scale is not None else 1.0
        x = torch.rand(p.shape, generator=gen, device=device,
                       dtype=torch.float32)
        return (x * (2 * scale) - scale).to(p.dtype)
    raise ValueError(f"unknown init {p.init!r}")


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


def init_tree(spec, *, seed: int, device, cast=None) -> dict:
    """Materialize a tree of :class:`Param` declarations into tensors.
    ``cast(path, tensor)`` converts each leaf to its storage form as soon
    as it is drawn, so at most one full-precision leaf is alive at once."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    cast = cast or (lambda _, x: x)
    # draw in sorted path order (the generator is sequential), then
    # rebuild the nesting
    values = {path: cast(path, _materialize(gen, p, device))
              for path, p in tree_items(spec)}
    return tree_map(lambda path, _: values[path], spec)


def stack_layer_specs(spec, n_layers: int, layer_axis: str = "layers"):
    """Turn a single-layer Param spec into a layer-stacked spec: every
    leaf gains a leading ``n_layers`` dim (the JAX scan layout)."""
    def _stack(_, p: Param) -> Param:
        return Param(shape=(n_layers,) + p.shape, dtype=p.dtype,
                     init=p.init, scale=p.scale,
                     axes=(layer_axis,) + tuple(p.axes))
    return tree_map(_stack, spec)
