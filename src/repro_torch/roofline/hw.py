"""The card's constants for the roofline model: one NVIDIA H100 SXM (the
counterpart of ``repro.roofline.hw``, whose ``Chip`` holds a TPU's).

Every number is NVIDIA's data sheet for the SXM part at 700 W: dense
peaks (no sparsity) of the tensor cores for bf16 and TF32, of the FMA
units for fp32 outside the tensor cores, the HBM3 rate and size, NVLink
4 (18 links, 900 GB/s both directions together), the SMs and the
shared memory a block may hold. A card whose power limit is set lower
runs below these peaks under load; a measurement keeps the card's name
and limit beside it (``chip_smoke.py`` prints them).
"""
from __future__ import annotations

import dataclasses

import torch

_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "bf16",
                torch.float32: "fp32", "bfloat16": "bf16",
                "float16": "bf16", "float32": "fp32"}


def dtype_name(dtype) -> str:
    """``"bf16"``, ``"tf32"`` or ``"fp32"`` for a torch dtype, its name
    (``"bfloat16"``) or one of those three."""
    if dtype in ("bf16", "tf32", "fp32"):
        return dtype
    return _DTYPE_NAMES[dtype]


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str = "h100-sxm"
    peak_bf16_flops: float = 989e12      # tensor cores, dense
    peak_tf32_flops: float = 495e12      # tensor cores, dense
    peak_fp32_flops: float = 67e12       # FMA units
    hbm_bw: float = 3.35e12              # bytes/s
    hbm_bytes: int = 80 * 10**9
    link_bw: float = 450e9               # NVLink bytes/s per direction
    sms: int = 132
    smem_bytes: int = 227 * 1024         # shared memory a block may hold

    def peak(self, dtype) -> float:
        """Operations per second of ``dtype``'s units (bf16 and fp16 on
        the tensor cores, tf32 on them at half rate, fp32 on FMA)."""
        return {"bf16": self.peak_bf16_flops, "tf32": self.peak_tf32_flops,
                "fp32": self.peak_fp32_flops}[dtype_name(dtype)]


H100 = Chip()


def bound_s(ops, bytes_, dtype=None, chip: Chip = H100):
    """(seconds, "bytes" or "operations"): the least time ``chip`` takes
    for work of ``ops`` operations of ``dtype`` that moves ``bytes_``
    bytes, ``max(ops / peak[dtype], bytes_ / hbm_bw)``, and the term
    that bounds it. ``ops`` may instead be a list of ``(ops, dtype)``
    pairs (products of several types), whose times add."""
    if isinstance(ops, (list, tuple)):
        ops_s = sum(n / chip.peak(dt) for n, dt in ops)
    else:
        ops_s = ops / chip.peak(dtype)
    bytes_s = bytes_ / chip.hbm_bw
    if ops_s >= bytes_s:
        return ops_s, "operations"
    return bytes_s, "bytes"
