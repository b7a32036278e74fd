"""The roofline of a traced step (port of ``repro.roofline.analysis``).

Three terms per (arch x shape x mesh) cell, in seconds, per rank:

    compute    = FLOPs / peak_FLOP/s[compute dtype]
    memory     = bytes / HBM_bw
    collective = sum over collectives of (wire bytes per rank) / link_bw

JAX reads FLOPs and bytes from ``compiled.cost_analysis()`` and parses
the optimized HLO for collectives; the port has no HLO. Its counts come
from tracing the step on fake tensors (``launch.dryrun``): FLOPs from
``torch.utils.flop_counter``, bytes as every op's inputs read once and
its output written once, and each collective of the port
(``core.collective_matmul``, ``core.flash_decode``) reporting its size
and group while a dry run records. The field names stay JAX's
(``hlo_flops``, ``hlo_bytes``) so a reader finds the counterpart.

Like JAX's CPU ``bytes accessed``, the traced byte count over-counts
chains a fused kernel would keep on chip, so the analytic term
(:func:`analytic_memory_bytes`) is kept beside it, as
``benchmarks/roofline_table.py::corrected`` does: ``dominant_star``,
``bound_s_star`` and ``frac_star`` use the analytic term.
"""
from __future__ import annotations

import dataclasses

from repro_torch.roofline.hw import H100, Chip

# ring factors per op: wire bytes per rank of an op of size R over a group
# of G ranks (JAX's ``collective_bytes``; R is the HLO line's result size,
# here the size the recording collective reports)
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")


def wire_bytes(op: str, size: float, group: int) -> float:
    """Per-rank wire bytes of one collective, JAX's ring factors:

      all-gather:         R·(G-1)/G  (its output minus its own shard)
      reduce-scatter:     R·(G-1)/G
      all-reduce:         RS + AG: 2·R·(G-1)/G
      all-to-all:         R·(G-1)/G
      collective-permute: R (point to point)
    """
    if op not in COLLECTIVE_OPS:
        raise ValueError(f"unknown collective {op!r}")
    g = group
    if op == "all-reduce":
        return 2.0 * size * (g - 1) / max(g, 1)
    if op == "collective-permute":
        return float(size)
    return float(size) * (g - 1) / max(g, 1)


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    wire_bytes_per_chip: float
    detail: list


def collective_stats(events) -> CollectiveStats:
    """:class:`CollectiveStats` of recorded ``(op, size, group)`` events;
    ``detail`` sums them per (op, group)."""
    counts: dict[str, int] = {}
    per: dict = {}
    total = 0.0
    for op, size, group in events:
        wire = wire_bytes(op, size, group)
        counts[op] = counts.get(op, 0) + 1
        d = per.setdefault((op, group), {"op": op, "group": group,
                                         "count": 0, "bytes": 0.0,
                                         "wire": 0.0})
        d["count"] += 1
        d["bytes"] += size
        d["wire"] += wire
        total += wire
    return CollectiveStats(counts, total, list(per.values()))


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float               # traced FLOPs per rank
    hlo_bytes: float               # traced bytes accessed per rank
    wire_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    collective_counts: dict
    per_device_hbm_peak: float | None = None
    memory_s_analytic: float = 0.0
    chip: Chip = H100
    dtype: str = "bf16"            # compute dtype: the peak it is held to

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / (FLOPs × chips): the counts are per rank.
        Remat/redundancy waste detector."""
        tot = self.hlo_flops * self.chips
        return self.model_flops / tot if tot else 0.0

    def _useful_s(self) -> float:
        return self.model_flops / (self.chips * self.chip.peak(self.dtype))

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / modeled step time (MFU-against-bound),
        at the peak of the chip and compute dtype this roofline holds."""
        return self._useful_s() / self.bound_s if self.bound_s else 0.0

    def _terms_star(self) -> dict:
        return {"compute": self.compute_s,
                "memory": self.memory_s_analytic or self.memory_s,
                "collective": self.collective_s}

    @property
    def dominant_star(self) -> str:
        terms = self._terms_star()
        return max(terms, key=terms.get)

    @property
    def bound_s_star(self) -> float:
        return max(self._terms_star().values())

    @property
    def frac_star(self) -> float:
        b = self.bound_s_star
        return self._useful_s() / b if b else 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["chip"] = self.chip.name
        d.update(dominant=self.dominant, useful_fraction=self.useful_fraction,
                 roofline_fraction=self.roofline_fraction,
                 bound_s=self.bound_s, dominant_star=self.dominant_star,
                 bound_s_star=self.bound_s_star, frac_star=self.frac_star)
        return d


def analyze(arch: str, shape_name: str, mesh_desc: str, chips: int,
            flops: float, bytes_: float, coll: CollectiveStats,
            model_flops: float, hbm_peak: float | None = None,
            analytic_bytes: float = 0.0, chip: Chip = H100,
            dtype: str = "bf16") -> Roofline:
    """The roofline of per-rank traced counts (``launch.dryrun``)."""
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_desc, chips=chips,
        hlo_flops=flops, hlo_bytes=bytes_,
        wire_bytes_per_chip=coll.wire_bytes_per_chip,
        compute_s=flops / chip.peak(dtype),
        memory_s=bytes_ / chip.hbm_bw,
        collective_s=coll.wire_bytes_per_chip / chip.link_bw,
        model_flops=model_flops,
        collective_counts=coll.counts,
        per_device_hbm_peak=hbm_peak,
        memory_s_analytic=analytic_bytes / chip.hbm_bw,
        chip=chip, dtype=dtype)


def analytic_memory_bytes(cfg, shape, chips: int) -> float:
    """Napkin per-chip HBM traffic per step — cross-check for the traced
    bytes (which over-count unfused elementwise chains).

    train:   weights fwd+bwd (2 × 2N/chips bytes bf16) + optimizer state
             rw (16N/chips fp32 m,v + master) + activation save/restore
             with per-layer remat (~8 passes over L·tokens·d per chip).
    prefill: weights read + activations (~4 passes).
    decode:  weights read + full KV cache read + state rw.
    """
    N = cfg.n_params()
    Na = cfg.n_active_params()
    d = cfg.d_model
    L = cfg.n_layers
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len / chips
        w = 2 * 2 * N / chips + 16 * N / chips
        acts = 8.0 * L * toks * d * 2
        return w + acts
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len / chips
        return 2 * Na / chips + 4.0 * L * toks * d * 2
    # decode: batch sharded over dp, cache seq over model
    cache = (2 * shape.global_batch * min(shape.seq_len,
                                          cfg.sliding_window or 1 << 62)
             * cfg.n_kv_heads * cfg.hd * 2) if not cfg.is_attention_free else 0
    if cfg.block in ("rwkv", "mamba_hybrid"):
        state = shape.global_batch * d * 64 * 4 * L  # ssm/wkv state rw
        cache = cache // (1 if cfg.block == "rwkv" else 6) + state
    return 2 * Na / chips + cache / chips


def model_flops_for(cfg, shape) -> float:
    """6·N·D convention (N = active params, D = tokens processed)."""
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * cfg.n_active_params() * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * cfg.n_active_params() * toks
    # decode: one token per sequence
    return 2.0 * cfg.n_active_params() * shape.global_batch
