"""The GEMM's batched mode (``kernels.matmul.matmul_batched``, the MoE
layer's expert products) on the CPU: its plain version and its gradient
against JAX's einsum and ``jax.grad``, its counters, and the launch plan
of a batch (``gemm_plan(..., E)``) against the item walk of
``csrc/matmul.cu`` (mirrored below, as ``tests/test_torch_launch_plan.py``
mirrors it for one product). The kernel itself runs on the card only
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 14).

Tolerances: float32 within 1e-5 relative to the largest |entry| (the
same fp32 products, summed in another order); bf16 outputs within one
bf16 ulp of the fp32 product (the plain version rounds an fp32 sum).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import matmul as kmm  # noqa: E402

torch.set_num_threads(2)


def _operands(seed, E, M, K, N):
    r = np.random.default_rng(seed)
    return (r.normal(size=(E, M, K)).astype(np.float32),
            (r.normal(size=(E, K, N)) / K ** 0.5).astype(np.float32),
            r.normal(size=(E, M, N)).astype(np.float32))


def _close(got, want, frac, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= frac * scale, f"{what}: {err:.3e} > {frac} x {scale:.3e}"


@pytest.mark.parametrize("E,M,K,N", [
    (8, 2, 128, 256),       # olmoe-smoke's wg/wu at decode (B 2 x C 1)
    (8, 8, 256, 128),       # its wd
    (4, 20, 136, 100),      # ragged
    (3, 1, 7, 5)])
def test_matmul_batched_and_grads_match_jax(E, M, K, N):
    a, b, dc = _operands(E + M + K + N, E, M, K, N)

    def f(a, b):
        return jnp.sum(jnp.einsum("emk,ekn->emn", a, b) * dc)
    want = jnp.einsum("emk,ekn->emn", a, b)
    wa, wb = jax.grad(f, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    n0, q0 = kmm.matmul.launches, kmm.matmul.plain_calls
    c = kmm.matmul_batched(ta, tb)
    (c * torch.from_numpy(dc)).sum().backward()
    assert kmm.matmul.plain_calls - q0 == 3       # forward, dA, dB
    assert kmm.matmul.launches == n0
    _close(c.detach().numpy(), want, 1e-5, "C")
    _close(ta.grad.numpy(), wa, 1e-5, "dA")
    _close(tb.grad.numpy(), wb, 1e-5, "dB")


def test_matmul_batched_bf16_rounds_an_fp32_sum():
    a, b, _ = _operands(0, 4, 8, 64, 32)
    ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    got = kmm.matmul_batched(ta, tb)
    assert got.dtype == torch.bfloat16
    want = torch.matmul(ta.float(), tb.float())
    assert torch.equal(got, want.to(torch.bfloat16))
    # each expert's product is the 2-D GEMM's
    for e in range(4):
        assert torch.equal(got[e], kmm.matmul(ta[e], tb[e]))


def test_matmul_batched_records_nothing_without_grad():
    a, b, _ = _operands(1, 2, 3, 4, 5)
    ta = torch.from_numpy(a).requires_grad_()
    with torch.inference_mode():
        assert kmm.matmul_batched(ta, torch.from_numpy(b)).grad_fn is None


def test_matmul_batched_refuses_what_it_cannot_take():
    a = torch.zeros(2, 3, 4)
    for b in (torch.zeros(3, 4, 5), torch.zeros(2, 5, 5), torch.zeros(4, 5)):
        with pytest.raises(ValueError):
            kmm.matmul_batched(a, b)


# ---------------------------------------------------------- the plan
def batch_items(plan) -> list[tuple]:
    """(expert, strip, M chunk, K chunk) of a batched ``gemm_stream``
    launch's items in item order: expert, then strip, then M chunk, K
    chunk fastest (mirrors ``item_at`` of ``csrc/matmul.cu``)."""
    return [(e, s, mc, kc) for e in range(plan.E)
            for s in range(plan.n_strips) for mc in range(plan.n_mc)
            for kc in range(plan.n_kc)]


# olmoe-1b-7b: wg/wu (2048 -> 1024) and wd (1024 -> 2048) at decode
# (batch 8 x C 1, 1 and 16 rows) and training (2 rows x C 160), with the
# gradients' shapes; olmoe-smoke; ragged
OLMOE = [(M, K, N) for M in (1, 8, 16, 320)
         for K, N in ((2048, 1024), (1024, 2048))] + [
    (2048, 320, 1024), (1024, 320, 2048), (320, 1024, 2048)]


@pytest.mark.parametrize("M,K,N", OLMOE + [(2, 128, 256), (5, 136, 1000)])
@pytest.mark.parametrize("E", [64, 8])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("capacity", [132, 264])
def test_batched_plan_covers_every_expert_strip_and_tile_once(
        M, K, N, E, itemsize, capacity):
    plan = kmm.gemm_plan(M, N, K, itemsize, capacity, None, E)
    alone = kmm.gemm_plan(M, N, K, itemsize, capacity)
    assert (plan.bn, plan.kt, plan.mt, plan.n_strips, plan.tiles) == \
        (alone.bn, alone.kt, alone.mt, alone.n_strips, alone.tiles)
    assert plan.items == E * plan.n_strips * plan.n_mc * plan.n_kc
    assert plan.work_floats == (0 if plan.n_kc == 1 else
                                E * alone.n_strips * plan.n_kc * M * plan.bn)
    grid = min(plan.items, capacity)
    walk = batch_items(plan)
    items = [it for blk in range(grid) for it in walk[blk::grid]]
    assert len(items) == len(set(items)) == plan.items
    assert set(items) == set(itertools.product(
        range(E), range(plan.n_strips), range(plan.n_mc), range(plan.n_kc)))
    tiles = [t for kc in range(plan.n_kc) for t in plan.chunk_tiles(kc)]
    assert tiles == list(range(plan.tiles))
    rows = [m for mc in range(plan.n_mc) for m in plan.m_chunk(mc)]
    assert rows == list(range(plan.m_tiles))


@pytest.mark.parametrize("capacity", [132, 264, 396])
def test_olmoe_decode_batch_needs_no_workspace(capacity):
    """At olmoe's decode shapes the 64 experts' strips alone fill the
    card: no K split, so no split-K workspace, and every item streams
    one expert's strip once."""
    for K, N in ((2048, 1024), (1024, 2048)):
        plan = kmm.gemm_plan(8, N, K, 2, capacity, None, 64)
        assert plan.n_kc == 1 and plan.n_mc == 1 and plan.work_floats == 0
        assert plan.items == 64 * N // plan.bn >= capacity
