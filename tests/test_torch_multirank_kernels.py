"""The port's W-rank kernels' plain versions against the JAX package's
W-rank code on 4 fake CPU devices: the fused AG+GEMM (the Pallas kernel
in interpret mode and ``ag_gemm_k_sharded_sm`` in its three modes), and
the fused contiguous and paged flash decodes (the Pallas kernels).

The JAX side runs in one subprocess (``tests/multirank_oracle.py
kernels``), because the fake-device count must be set before JAX
starts; the port's ranks are W CPU ranks of one mesh.

Tolerances: float32 ``2e-4`` relative and absolute, as the battery's
``ATOL, RTOL`` (sums in another order); bf16 outputs one bf16 ulp
(``2**-7`` relative) plus ``1e-4`` of the largest |C| for sums near
zero, since both sides round one fp32 sum to bf16.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import collective_matmul as cm  # noqa: E402
from repro_torch.distributed.context import Mesh  # noqa: E402
from repro_torch.kernels import flash_decode as kfd  # noqa: E402
from repro_torch.kernels.ag_gemm import ag_gemm_fused  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    ag_gemm_ref, flash_decode_ref, strided)

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
WS = (2, 4)


def run_oracle(group, tmp_path_factory):
    """Run the JAX half of ``group`` on 4 fake devices; its arrays."""
    out = tmp_path_factory.mktemp("oracle") / f"{group}.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    subprocess.run([sys.executable, str(REPO / "tests" / "multirank_oracle.py"),
                    group, str(out)], env=env, check=True, timeout=600)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return run_oracle("kernels", tmp_path_factory)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _shards(a, W):
    k = a.shape[-1] // W
    return [a[:, r * k:(r + 1) * k].contiguous() for r in range(W)]


# ----------------------------------------------------------------- AG+GEMM
@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("mode", ["bsp", "ring", "ring_bidir"])
def test_ag_gemm_k_sharded_matches_jax(jx, W, mode):
    a, b = _t(jx[f"ag{W}/a"]), _t(jx[f"ag{W}/b"])
    out = cm.ag_gemm_k_sharded_sm(a, b, Mesh(["cpu"] * W), mode=mode)
    assert len(out) == W
    for o in out:
        np.testing.assert_allclose(o.numpy(), jx[f"ag{W}/{mode}"], **TOL)


@pytest.mark.parametrize("W", WS)
def test_ag_gemm_fused_plain_matches_pallas_kernel(jx, W):
    a, b = _t(jx[f"ag{W}/a"]), _t(jx[f"ag{W}/b"])
    n0 = ag_gemm_fused.plain_calls
    out = ag_gemm_fused(_shards(a, W), [b] * W, Mesh(["cpu"] * W))
    assert ag_gemm_fused.plain_calls == n0 + 1
    for o in out:
        np.testing.assert_allclose(o.numpy(), jx[f"ag{W}/pallas"], **TOL)
        np.testing.assert_allclose(o.numpy(), ag_gemm_ref(
            _shards(a, W), b).numpy(), **TOL)


@pytest.mark.parametrize("W", WS)
def test_ag_gemm_fused_plain_bf16_matches_pallas_kernel(jx, W):
    a = _t(jx[f"ag{W}/a_bf16"]).to(torch.bfloat16)
    b = _t(jx[f"ag{W}/b_bf16"]).to(torch.bfloat16)
    out = ag_gemm_fused(_shards(a, W), [b] * W, Mesh(["cpu"] * W))
    want = jx[f"ag{W}/pallas_bf16"]
    scale = np.abs(want).max()
    for o in out:
        assert o.dtype == torch.bfloat16
        err = np.abs(o.float().numpy() - want)
        assert (err <= 2 ** -7 * np.abs(want) + 1e-4 * scale).all()


@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("err", ["err_ragged", "err_bidir"])
def test_ag_gemm_validation_errors_match_jax(jx, W, err):
    mode = "ring" if err == "err_ragged" else "ring_bidir"
    a, b = _t(jx[f"ag{W}/{err}_a"]), _t(jx[f"ag{W}/{err}_b"])
    want = str(jx[f"ag{W}/{err}"])
    assert want
    with pytest.raises(ValueError) as e:
        cm.ag_gemm_k_sharded_sm(a, b, Mesh(["cpu"] * W), mode=mode)
    assert str(e.value) == want


def test_ag_gemm_fused_raises_on_shapes_it_does_not_take():
    a = [torch.zeros(4, 8), torch.zeros(4, 8)]
    with pytest.raises(ValueError, match="W=2 times"):
        ag_gemm_fused(a, [torch.zeros(15, 3)] * 2, Mesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="differ from rank 0"):
        ag_gemm_fused([a[0], torch.zeros(4, 7)], [torch.zeros(16, 3)] * 2,
                      Mesh(["cpu"] * 2))


# ------------------------------------------------------------ flash decode
def _strided_shards(x, W):
    xs = strided(x, W)
    S = x.shape[1] // W
    return [xs[:, r * S:(r + 1) * S].contiguous() for r in range(W)]


@pytest.mark.parametrize("W", WS)
def test_flash_decode_fused_plain_matches_pallas_kernel(jx, W):
    q, k, v = _t(jx["fd/q"]), _t(jx["fd/k"]), _t(jx["fd/v"])
    B = q.shape[0]
    cl = torch.full((B,), 41, dtype=torch.int32)
    n0 = kfd.flash_decode_fused.plain_calls
    out = kfd.flash_decode_fused([q] * W, _strided_shards(k, W),
                                 _strided_shards(v, W), [cl] * W, 0.25,
                                 mesh=Mesh(["cpu"] * W))
    assert kfd.flash_decode_fused.plain_calls == n0 + 1
    dense = flash_decode_ref(q, k, v, 41, 0.25).numpy()
    for o in out:
        np.testing.assert_allclose(o.numpy(), jx[f"fd{W}/pallas"], **TOL)
        np.testing.assert_allclose(o.numpy(), dense, **TOL)
        assert torch.equal(o, out[0])          # bit-identical across ranks


@pytest.mark.parametrize("W", WS)
def test_flash_decode_paged_fused_plain_matches_pallas_kernel(jx, W):
    q, kp, vp = _t(jx["fdp/q"]), _t(jx["fdp/kp"]), _t(jx["fdp/vp"])
    cur, tables = _t(jx["fdp/cur"]), _t(jx["fdp/tables"])
    n_loc = kp.shape[0] // W
    kps = [kp[r * n_loc:(r + 1) * n_loc] for r in range(W)]
    vps = [vp[r * n_loc:(r + 1) * n_loc] for r in range(W)]
    # the tables reach blocks of every rank
    assert {int(t) // n_loc for t in tables.flatten() if t >= 0} == \
        set(range(W))
    out = kfd.flash_decode_paged_fused([q] * W, kps, vps, [cur] * W,
                                       [tables] * W, 0.25,
                                       mesh=Mesh(["cpu"] * W))
    for o in out:
        np.testing.assert_allclose(o.numpy(), jx[f"fdp{W}/pallas"], **TOL)
        assert torch.equal(o, out[0])


@pytest.mark.parametrize("W", WS)
def test_paged_partials_fold_to_the_fused_output(jx, W):
    """The partial mode (what bsp/ring/rs_ag combine) folds, in rank
    order, to the fused mode's output bit for bit."""
    from repro_torch.core.flash_decode import combine_bsp, finalize
    q, kp, vp = _t(jx["fdp/q"]), _t(jx["fdp/kp"]), _t(jx["fdp/vp"])
    cur, tables = _t(jx["fdp/cur"]), _t(jx["fdp/tables"])
    n_loc = kp.shape[0] // W
    kps = [kp[r * n_loc:(r + 1) * n_loc] for r in range(W)]
    vps = [vp[r * n_loc:(r + 1) * n_loc] for r in range(W)]
    args = ([q] * W, kps, vps, [cur] * W, [tables] * W, 0.25)
    parts = kfd.flash_decode_paged_partial(*args)
    fused = kfd.flash_decode_paged_fused(*args, mesh=Mesh(["cpu"] * W))
    for o in combine_bsp(parts):
        assert torch.equal(finalize(o), fused[0])


def test_multirank_wrappers_check_their_inputs():
    q = [torch.zeros(2, 4, 32)] * 2
    kv = [torch.zeros(2, 8, 2, 32)] * 2
    cl = [torch.ones(2, dtype=torch.int32)] * 2
    with pytest.raises(ValueError, match="different lengths"):
        kfd.flash_decode_fused(q[:1], kv, kv, cl, 1.0)
    with pytest.raises(ValueError, match="window must be positive"):
        kfd.flash_decode_fused(q, kv, kv, cl, 1.0, window=0)
    with pytest.raises(ValueError, match="tables"):
        kfd.flash_decode_paged_fused(q, kv, kv, cl,
                                     [torch.zeros(3, 2, dtype=torch.int32)]
                                     * 2, 1.0)
