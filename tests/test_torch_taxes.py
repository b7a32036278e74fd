"""The port's three-taxes model (``repro_torch.core.taxes``) against the
JAX package's (``repro.core.taxes``), on the CPU.

Both are pure Python. The port's ``HW`` defaults are the H100's, so each
case builds the port's ``HW`` from JAX's ``V5E`` numbers (``ici_bw`` ->
``link_bw``, ``vmem_bytes`` -> ``smem_bytes``) and compares every
schedule's ``TaxReport``, ``pick_mode`` and both ``*_op_shape`` helpers
on a grid of M, K, N, W to a relative 1e-12.
"""
import dataclasses
import itertools
import math

import pytest

pytest.importorskip("torch")

from repro.core import taxes as jt  # noqa: E402
from repro_torch.core import taxes as pt  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402

REL = 1e-12
V5E_AS_PORT = pt.HW(flops=jt.V5E.flops, hbm_bw=jt.V5E.hbm_bw,
                    link_bw=jt.V5E.ici_bw,
                    kernel_launch=jt.V5E.kernel_launch,
                    barrier_skew=jt.V5E.barrier_skew,
                    smem_bytes=jt.V5E.vmem_bytes)
GRID = list(itertools.product((8, 2048, 32768), (1024, 4096, 14336),
                              (1024, 4096, 128256), (2, 4, 8)))


def _close(a, b):
    return math.isclose(a, b, rel_tol=REL, abs_tol=0.0) or a == b


def _same(rep_p, rep_j):
    assert rep_p.schedule == rep_j.schedule
    for f in dataclasses.fields(jt.TaxReport):
        if f.name != "schedule":
            assert _close(getattr(rep_p, f.name), getattr(rep_j, f.name)), \
                f.name
    assert _close(rep_p.taxes_s, rep_j.taxes_s)


def _op_shapes(M, K, N, W):
    return ((pt.ag_gemm_op_shape(M, K, N, W), jt.ag_gemm_op_shape(M, K, N,
                                                                  W)),
            (pt.flash_decode_op_shape(M % 64 + 1, 32, 128, K * 8, 8, W),
             jt.flash_decode_op_shape(M % 64 + 1, 32, 128, K * 8, 8, W)))


@pytest.mark.parametrize("M,K,N,W", GRID)
def test_schedules_equal_jax(M, K, N, W):
    for op_p, op_j in _op_shapes(M, K, N, W):
        assert dataclasses.astuple(op_p) == dataclasses.astuple(op_j)
        _same(pt.bsp_schedule(op_p, V5E_AS_PORT),
              jt.bsp_schedule(op_j, jt.V5E))
        _same(pt.bsp_schedule(op_p, V5E_AS_PORT, n_kernels=5),
              jt.bsp_schedule(op_j, jt.V5E, n_kernels=5))
        for bidir in (False, True):
            _same(pt.ring_schedule(op_p, V5E_AS_PORT, bidir=bidir),
                  jt.ring_schedule(op_j, jt.V5E, bidir=bidir))
        _same(pt.fused_pallas_schedule(op_p, V5E_AS_PORT),
              jt.fused_pallas_schedule(op_j, jt.V5E))
        assert pt.pick_mode(op_p, V5E_AS_PORT) == jt.pick_mode(op_j, jt.V5E)


def test_fields_renamed_and_defaults_are_the_card():
    """The TPU names are gone; the defaults are the H100's (the data
    sheet's rates, the measured launch and barrier)."""
    names = {f.name for f in dataclasses.fields(pt.HW)}
    assert names == {"flops", "hbm_bw", "link_bw", "kernel_launch",
                     "barrier_skew", "smem_bytes"}
    assert pt.H100.flops == hw.H100.peak("bf16") == 989e12
    assert pt.H100.hbm_bw == hw.H100.hbm_bw == 3.35e12
    assert pt.H100.link_bw == 450e9
    assert pt.H100.smem_bytes == 227 * 1024
    assert pt.H100 != V5E_AS_PORT


def test_bound_s():
    """max(ops / peak[dtype], bytes / hbm) and the term that bounds."""
    import torch
    assert hw.bound_s(989e12, 1.0, torch.bfloat16) == (1.0, "operations")
    assert hw.bound_s(1.0, 3.35e12, "fp32") == (1.0, "bytes")
    s, by = hw.bound_s([(67e12, torch.float32), (989e12, "bf16")], 0.0)
    assert (s, by) == (2.0, "operations")
    assert hw.H100.peak("tf32") == 495e12
