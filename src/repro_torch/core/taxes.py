"""The "Three Taxes" analytical framework (paper §2.3), as a cost model
(port of ``repro.core.taxes``; the dataclasses and the schedule formulas
are JAX's, line for line).

Quantifies, for a compute+collective pair executed under a given
schedule, the three taxes the paper identifies:

* kernel-launch tax  — fixed dispatch cost per kernel boundary,
* bulk-synchronous tax — idle time from global barriers (serialization
  of compute and wire time instead of overlap, plus skew wait),
* inter-kernel data-locality tax — HBM round-trip of the intermediate
  between producer and consumer kernels.

The fields whose JAX names belong to a TPU are renamed: ``link_bw``
(NVLink; JAX's ``ici_bw``) and ``smem_bytes`` (a block's shared memory;
JAX's ``vmem_bytes``). The schedule and mode names stay: ``"pallas"``
is the fused mode's name in both packages. :func:`pick_mode` is a
model: ``fusion_mode="auto"`` does not call it, in either package
(``core.patterns`` keeps JAX's table). ``launch.dryrun`` reports each
cell's taxes under its fusion mode.

All times in seconds; all sizes in bytes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.roofline.hw import H100 as _CHIP


@dataclasses.dataclass(frozen=True)
class HW:
    """Per-card constants (defaults: the H100 of ``roofline.hw``)."""
    flops: float = _CHIP.peak_bf16_flops     # bf16 peak / card
    hbm_bw: float = _CHIP.hbm_bw             # bytes/s
    # NVLink per direction, the data sheet's: not measured (distinct
    # cards have not run; ROADMAP 10d)
    link_bw: float = _CHIP.link_bw
    # measured by chip_smoke.py phase 18 on an NVIDIA H100 80GB HBM3,
    # power limit 700.00 W: an empty kernel's launch as the host issues
    # it (launches queued back to back; its device time is 0.23 us), and
    # one global barrier of the port's bsp schedule at a site with no
    # bytes over 4 virtual ranks of one card (the all-gather's host loop
    # and copies; a straggler's wait across distinct cards is not
    # measured)
    kernel_launch: float = 6.38e-6
    barrier_skew: float = 60.13e-6
    smem_bytes: int = _CHIP.smem_bytes


H100 = HW()


@dataclasses.dataclass(frozen=True)
class OpShape:
    """One compute+collective stage (e.g. AG + GEMM)."""
    flops: float            # useful FLOPs of the compute
    hbm_bytes: float        # compute operand+result HBM traffic
    wire_bytes: float       # bytes each rank must move over the links
    intermediate_bytes: float  # producer->consumer intermediate size
    steps: int = 1          # pipeline depth available for overlap (W)


@dataclasses.dataclass(frozen=True)
class TaxReport:
    schedule: str
    compute_s: float
    wire_s: float
    launch_tax_s: float
    bulk_sync_tax_s: float
    locality_tax_s: float
    total_s: float

    @property
    def taxes_s(self) -> float:
        return self.launch_tax_s + self.bulk_sync_tax_s + self.locality_tax_s


def _base_times(op: OpShape, hw: HW):
    t_compute = max(op.flops / hw.flops, op.hbm_bytes / hw.hbm_bw)
    t_wire = op.wire_bytes / hw.link_bw
    return t_compute, t_wire


def bsp_schedule(op: OpShape, hw: HW = H100, n_kernels: int = 3
                 ) -> TaxReport:
    """Compute-Wait-Collective-Wait-Compute: everything serializes."""
    t_compute, t_wire = _base_times(op, hw)
    launch = n_kernels * hw.kernel_launch
    # two global barriers (before and after the collective)
    skew = 2 * hw.barrier_skew
    # no overlap: wire time is fully exposed
    bulk = t_wire + skew
    # intermediate goes HBM round trip (write by producer, read by consumer)
    locality = 2 * op.intermediate_bytes / hw.hbm_bw
    total = t_compute + bulk + launch + locality
    return TaxReport("bsp", t_compute, t_wire, launch, bulk, locality, total)


def ring_schedule(op: OpShape, hw: HW = H100, n_kernels: int = 1,
                  bidir: bool = False) -> TaxReport:
    """Fine-grained ring: per-step wire hides under per-step compute."""
    t_compute, t_wire = _base_times(op, hw)
    if bidir:
        t_wire = t_wire / 2
    steps = max(op.steps, 1)
    per_c, per_w = t_compute / steps, t_wire / steps
    # pipeline: total = steps * max(per_c, per_w) + startup bubble
    total_pipe = steps * max(per_c, per_w) + min(per_c, per_w)
    launch = n_kernels * hw.kernel_launch
    bulk = max(total_pipe - t_compute, 0.0)   # exposed (non-hidden) wire
    locality = 0.0                            # tiles consumed on chip
    total = t_compute + bulk + launch
    return TaxReport("ring_bidir" if bidir else "ring",
                     t_compute, t_wire, launch, bulk, locality, total)


def fused_pallas_schedule(op: OpShape, hw: HW = H100) -> TaxReport:
    """Single fused kernel: one launch, on-chip handoff, overlapped
    pushes."""
    rep = ring_schedule(op, hw, n_kernels=1)
    return dataclasses.replace(rep, schedule="pallas")


def pick_mode(op: OpShape, hw: HW = H100) -> str:
    """Modeled-latency argmin over the unfused schedules."""
    cands = {
        "bsp": bsp_schedule(op, hw).total_s,
        "ring": ring_schedule(op, hw).total_s,
        "ring_bidir": ring_schedule(op, hw, bidir=True).total_s,
    }
    return min(cands, key=cands.get)


def ag_gemm_op_shape(M: int, K: int, N: int, W: int, itemsize: int = 2
                     ) -> OpShape:
    """The paper's AG+GEMM: A (M,K) K-sharded, B (K,N) replicated."""
    flops = 2.0 * M * K * N
    wire = (W - 1) / W * M * K * itemsize      # every rank receives W-1 shards
    hbm = (M * K + K * N + M * N) * itemsize
    inter = M * K * itemsize                   # gathered A
    return OpShape(flops=flops, hbm_bytes=hbm, wire_bytes=wire,
                   intermediate_bytes=inter, steps=W)


def flash_decode_op_shape(B: int, H: int, D: int, S: int, KVH: int, W: int,
                          itemsize: int = 2) -> OpShape:
    """Seq-sharded flash decode: local attention + partial combine."""
    flops = 2.0 * B * H * D * S / W * 2        # qk and pv per rank
    hbm = B * (S // W) * KVH * D * 2 * itemsize
    partial = B * H * (D + 2) * 4              # fp32 (o, m, l)
    wire = (W - 1) * partial                   # ring pass
    return OpShape(flops=flops, hbm_bytes=hbm, wire_bytes=wire,
                   intermediate_bytes=partial, steps=W)


SCHEDULES = {"bsp": bsp_schedule, "ring": ring_schedule,
             "ring_bidir": lambda op, hw=H100: ring_schedule(op, hw,
                                                             bidir=True),
             "pallas": fused_pallas_schedule}
