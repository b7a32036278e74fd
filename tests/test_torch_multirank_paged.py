"""The port's W-rank paged decode attention against the JAX package's
on 4 fake CPU devices: ``decode_paged_attention_fused`` bounded and
masked, every combine, gather-width slices, a window, holes and blocks
of every rank, outputs and the written pool shards alike; plus the
ownership rules of the paged write.

The JAX side runs in one subprocess (``tests/multirank_oracle.py
paged``). The port's ``pallas`` mode (its fused kernel's plain version
on CPU ranks) folds the sources in rank order, as the JAX ``bsp``
combine does, and is held against that. Tolerance: float32 ``2e-4``
relative and absolute, as the battery's ``ATOL, RTOL``; the pools are
copies and must match exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import flash_decode as fd  # noqa: E402
from repro_torch.distributed.context import Mesh  # noqa: E402

from test_torch_multirank_kernels import run_oracle  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)
WS = (2, 4)


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return run_oracle("paged", tmp_path_factory)


def _t(x):
    return torch.from_numpy(np.array(x))


# -------------------------------------------------------------- paged pool
PAGED = [(6, None, m) for m in ("bsp", "ring", "rs_ag", "pallas")] + \
    [(4, None, "ring"), (4, 6, "ring"), (4, 6, "pallas")]


@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("width,window,mode", PAGED)
@pytest.mark.parametrize("bounded", [True, False])
def test_decode_paged_attention_fused_matches_jax(jx, W, width, window, mode,
                                                  bounded):
    want_mode = "bsp" if mode == "pallas" else mode
    if (width, window, want_mode) not in {(w, x, m) for w, x, m in PAGED}:
        want_mode = "ring"
    c = f"pd{W}/{width}/{window}/{want_mode}/{bounded}"
    q, kp, vp = _t(jx["pd/q"]), _t(jx["pd/kp"]), _t(jx["pd/vp"])
    kn, vn = _t(jx["pd/k_new"]), _t(jx["pd/v_new"])
    cur = _t(jx["pd/cur"])
    full = _t(jx["pd/tables"])
    tb = full[:, :width]                 # a leading gather-width slice
    n_loc = kp.shape[0] // W
    kps = [kp[r * n_loc:(r + 1) * n_loc].clone() for r in range(W)]
    vps = [vp[r * n_loc:(r + 1) * n_loc].clone() for r in range(W)]
    out, kps, vps = fd.decode_paged_attention_fused(
        [q] * W, [kn] * W, [vn] * W, kps, vps, [cur] * W, [tb] * W,
        scale=0.25, mode=mode, window=window, bounded=bounded,
        mesh=Mesh(["cpu"] * W))
    for o in out:
        np.testing.assert_allclose(o.numpy(), jx[f"{c}/out"], **TOL)
    np.testing.assert_array_equal(torch.cat(kps).numpy(), jx[f"{c}/ck"])
    np.testing.assert_array_equal(torch.cat(vps).numpy(), jx[f"{c}/cv"])
    if mode == "pallas":
        assert all(torch.equal(o, out[0]) for o in out)


def test_paged_write_drops_blocks_outside_the_owned_range():
    """Over W = 2 shards of 4 blocks: a slot whose block lives on the
    other rank, a -1 entry and an inactive slot leave the shard
    byte-identical; the owned write lands."""
    bs, n_loc = 2, 4
    pool = torch.arange(n_loc * bs * 2, dtype=torch.float32).reshape(
        n_loc, bs, 1, 2)
    before = pool.clone()
    new = torch.full((4, 1, 2), -1.0)
    tables = torch.tensor([[5], [1], [-1], [6]], dtype=torch.int32)
    cur = torch.tensor([1, 2, 1, 2], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    fd.paged_write(pool, new, tables, cur, active, owner_base=0, n_owned=4)
    changed = (pool != before).any(dim=(2, 3))
    assert changed.nonzero().tolist() == [[1, 1]]      # block 1, offset 1
    pool2 = before.clone()
    fd.paged_write(pool2, new, tables, cur, active, owner_base=4,
                   n_owned=4)
    changed = (pool2 != before).any(dim=(2, 3))
    assert changed.nonzero().tolist() == [[1, 0]]      # global block 5


def test_masked_paged_oracle_refuses_the_card():
    q = [torch.zeros(1, 2, 4)]
    pool = [torch.zeros(2, 2, 1, 4, device="meta")]
    cl = [torch.ones(1, dtype=torch.int32)]
    tb = [torch.zeros(1, 1, dtype=torch.int32)]
    with pytest.raises(ValueError, match="masked paged oracle"):
        fd.decode_paged_attention_fused(
            q, [torch.zeros(1, 1, 4)], [torch.zeros(1, 1, 4)], pool, pool,
            cl, tb, scale=1.0, bounded=False)
