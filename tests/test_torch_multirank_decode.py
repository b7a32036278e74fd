"""The port's W-rank contiguous-cache decode attention against the JAX
package's on 4 fake CPU devices: ``decode_attention_fused`` over the
strided cache (scalar and per-slot ``cur_len``, every combine, a window,
an inactive slot, the rolling cache), outputs and the written caches
alike.

The JAX side runs in one subprocess (``tests/multirank_oracle.py
contiguous``). The port's ``pallas`` mode (its fused kernels' plain
versions on CPU ranks) folds the sources in rank order, as the JAX
``bsp`` combine does, and is held against that. Tolerance: float32
``2e-4`` relative and absolute, as the battery's ``ATOL, RTOL``; the
caches are copies and must match exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import flash_decode as fd  # noqa: E402
from repro_torch.distributed.context import Mesh  # noqa: E402
from repro_torch.kernels.ref import strided  # noqa: E402

from test_torch_multirank_kernels import run_oracle  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)
WS = (2, 4)


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return run_oracle("contiguous", tmp_path_factory)


def _t(x):
    return torch.from_numpy(np.array(x))


def _shards(x, W):
    xs = strided(x, W)
    S = x.shape[1] // W
    return [xs[:, r * S:(r + 1) * S].clone() for r in range(W)]


def _join(shards, W):
    """Strided shards -> the JAX cache layout (rank r's shard at
    [:, r*S/W:(r+1)*S/W])."""
    return torch.cat(shards, dim=1).numpy()


def _contig(jx, W, cur, **kw):
    q, k, v = _t(jx["cd/q"]), _t(jx["cd/k"]), _t(jx["cd/v"])
    kn, vn = _t(jx["cd/k_new"]), _t(jx["cd/v_new"])
    ks, vs = _shards(k, W), _shards(v, W)
    out, ks, vs = fd.decode_attention_fused(
        [q] * W, [kn] * W, [vn] * W, ks, vs, [_t(cur)] * W, scale=0.25,
        mesh=Mesh(["cpu"] * W), **kw)
    return out, ks, vs


# -------------------------------------------------------- contiguous cache
@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("cname", ["scalar", "slots"])
@pytest.mark.parametrize("mode", ["bsp", "ring", "rs_ag", "pallas"])
def test_decode_attention_fused_matches_jax(jx, W, cname, mode):
    want_mode = "bsp" if mode == "pallas" else mode
    c = f"cd{W}/{cname}/{want_mode}"
    out, ks, vs = _contig(jx, W, jx[f"cd/cur_{cname}"], mode=mode)
    for o in out:
        np.testing.assert_allclose(o.numpy(), jx[f"{c}/fused"], **TOL)
    np.testing.assert_array_equal(_join(ks, W), jx[f"{c}/ck"])
    np.testing.assert_array_equal(_join(vs, W), jx[f"{c}/cv"])
    if mode == "pallas":
        assert all(torch.equal(o, out[0]) for o in out)


@pytest.mark.parametrize("W", WS)
def test_decode_attention_window_matches_jax(jx, W):
    q, k, v = _t(jx["cd/q"]), _t(jx["cd/k"]), _t(jx["cd/v"])
    out = fd.decode_attention([q] * W, _shards(k, W), _shards(v, W),
                              [49] * W, scale=0.25, mode="ring", window=16)
    for o in out:
        np.testing.assert_allclose(o.numpy(), jx[f"cd{W}/window"], **TOL)


@pytest.mark.parametrize("W", WS)
def test_inactive_slot_leaves_every_shard_byte_identical(jx, W):
    act = _t(jx["cd/active"])
    before = _shards(_t(jx["cd/k"]), W)
    out, ks, _ = _contig(jx, W, jx["cd/cur_slots"], mode="ring",
                         active=[act] * W)
    for o in out:
        np.testing.assert_allclose(o.numpy(), jx[f"cd{W}/active/fused"],
                                   **TOL)
    np.testing.assert_array_equal(_join(ks, W), jx[f"cd{W}/active/ck"])
    for b in np.flatnonzero(~act.numpy()):
        for r in range(W):
            assert torch.equal(ks[r][b], before[r][b])


@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("mode", ["ring", "pallas"])
def test_rolling_cache_matches_jax(jx, W, mode):
    q, k, v = _t(jx["roll/q"]), _t(jx["roll/k"]), _t(jx["roll/v"])
    kn, vn = _t(jx["roll/k_new"]), _t(jx["roll/v_new"])
    out, _, _ = fd.decode_attention_fused(
        [q] * W, [kn] * W, [vn] * W, _shards(k, W), _shards(v, W),
        [45] * W, scale=0.25, mode=mode, rolling_len=k.shape[1],
        mesh=Mesh(["cpu"] * W))
    for o in out:
        np.testing.assert_allclose(o.numpy(), jx[f"roll{W}/fused"], **TOL)


def test_strided_write_drops_positions_other_ranks_own():
    """Each position is written by exactly one rank: p % W."""
    W, B, S_loc = 4, 3, 5
    shards = [torch.zeros(B, S_loc, 1, 2) for _ in range(W)]
    new = torch.ones(B, 1, 2)
    cur = torch.tensor([1, 6, 20], dtype=torch.int32)
    for r in range(W):
        fd.strided_write(shards[r], new, cur, r, W)
    for b, p in enumerate((cur - 1).tolist()):
        for r in range(W):
            written = shards[r][b].sum().item()
            assert written == (2.0 if r == p % W else 0.0)
        assert shards[p % W][b, p // W].sum().item() == 2.0
