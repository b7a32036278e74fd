"""The port's ``distributed.grad_compress`` against the JAX package's:
the bf16 cast and the int8 block quantization bit for bit, and
``compressed_psum_tree`` over the ``data`` axis of a (4, 1) mesh for
every scheme, its residual carried into a second call.

The JAX half runs in one subprocess, this file's ``__main__`` block, on
4 fake CPU devices (set before JAX starts), under ``shard_map`` over a
mesh whose axes are ``AxisType.Auto``; each rank's gradient tree is its
row of a stacked array sharded over ``data``. The port's ranks are the
4 CPU ranks of a (4, 1) mesh.

Tolerances:
* ``compress_int8``'s q and scale, ``compress_bf16``: bit-equal (the
  same float32 ops; round half to even in both);
* ``compressed_psum_tree``'s mean and residual against JAX's: 1e-6
  relative and absolute (four float32 terms summed in another order);
* each mean against the true mean of the ranks' gradients:
  ``check_grad_compress_psum``'s 1e-2 (bf16), 3e-2 (int8) and 1e-6
  (none), relative and absolute.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np

SCHEMES = ("bf16", "int8", "none")
N_RANKS = 4
TOL = {"bf16": 1e-2, "int8": 3e-2, "none": 1e-6}


def int8_inputs() -> dict:
    """Arrays whose blocks cover the quantizer's cases: a ragged tail
    (padding), an all-zero block (the 1e-12 floor), exact halves (round
    to even) and a wide range of scales."""
    r = np.random.default_rng(0)
    ties = np.zeros(256, np.float32)
    ties[0] = 127.0                       # scale 1: q = round(x)
    ties[1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -3.5]
    return {"ragged": r.normal(size=(1000,)).astype(np.float32),
            "matrix": r.normal(size=(16, 32)).astype(np.float32),
            "zeros": np.concatenate([np.zeros(256, np.float32),
                                     r.normal(size=(100,))
                                     .astype(np.float32)]),
            "ties": ties,
            "scales": (r.normal(size=(4, 256)) *
                       np.array([[1e-8], [1e-3], [1.0], [1e4]]))
            .astype(np.float32)}


def rank_grads(seed: int) -> list:
    """One gradient tree a rank, different on every rank."""
    r = np.random.default_rng(seed)
    return [{"w": r.normal(size=(16, 32)).astype(np.float32),
             "b": r.normal(size=(32,)).astype(np.float32)}
            for _ in range(N_RANKS)]


def _oracle(path):
    """The JAX half: writes every output to ``path``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as P

    from repro.core import jax_compat
    from repro.distributed import grad_compress as gc

    out = {}
    for name, x in int8_inputs().items():
        q, s = gc.compress_int8(jnp.asarray(x))
        out[f"int8/{name}/q"] = np.asarray(q)
        out[f"int8/{name}/scale"] = np.asarray(s)
        out[f"int8/{name}/back"] = np.asarray(
            gc.decompress_int8(q, s, x.shape))
        out[f"bf16/{name}"] = np.asarray(
            gc.compress_bf16(jnp.asarray(x))).view(np.uint16)

    mesh = jax.make_mesh((N_RANKS, 1), ("data", "model"),
                         devices=jax.devices()[:N_RANKS],
                         axis_types=(AxisType.Auto,) * 2)
    stack = {k: P("data") for k in ("w", "b")}

    def stacked(trees):
        return {k: jnp.stack([t[k] for t in trees]) for k in ("w", "b")}

    for scheme in SCHEMES:
        def first(g, scheme=scheme):
            g = {k: v[0] for k, v in g.items()}
            mean, res = gc.compressed_psum_tree(g, "data", scheme=scheme)
            return ({k: v[None] for k, v in mean.items()},
                    {k: v[None] for k, v in res.items()})

        def second(g, r, scheme=scheme):
            g = {k: v[0] for k, v in g.items()}
            r = {k: v[0] for k, v in r.items()}
            mean, res = gc.compressed_psum_tree(g, "data", scheme=scheme,
                                                residual=r)
            return ({k: v[None] for k, v in mean.items()},
                    {k: v[None] for k, v in res.items()})

        m1, r1 = jax.jit(jax_compat.shard_map(
            first, mesh=mesh, in_specs=(stack,), out_specs=(stack, stack),
            axis_names={"data"}, check_vma=False))(stacked(rank_grads(1)))
        m2, r2 = jax.jit(jax_compat.shard_map(
            second, mesh=mesh, in_specs=(stack, stack),
            out_specs=(stack, stack), axis_names={"data"},
            check_vma=False))(stacked(rank_grads(2)), r1)
        for call, (m, r) in (("1", (m1, r1)), ("2", (m2, r2))):
            for k in ("w", "b"):
                out[f"psum/{scheme}/{call}/mean/{k}"] = np.asarray(m[k])
                out[f"psum/{scheme}/{call}/res/{k}"] = np.asarray(r[k])
    np.savez(path, **out)


if __name__ == "__main__":
    _oracle(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------------ the port
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

from repro_torch.distributed import grad_compress as gc  # noqa: E402
from repro_torch.distributed.context import DistContext, use  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def oracle_run(tmp_path_factory):
    """Starts the JAX half when the module's first test starts."""
    out = tmp_path_factory.mktemp("oracle") / "grad_compress.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_RANKS}")
    proc = subprocess.Popen([sys.executable, __file__, str(out)], env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jx(oracle_run):
    proc, out = oracle_run
    assert proc.wait(timeout=300) == 0, "the JAX half failed"
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _t(x):
    return torch.from_numpy(np.array(x))


def _trees(seed):
    return [{k: _t(v) for k, v in t.items()} for t in rank_grads(seed)]


def test_compress_bf16_roundtrip_is_the_cast():
    x = _t(int8_inputs()["matrix"])
    c = gc.compress_bf16(x)
    assert c.dtype == torch.bfloat16
    assert torch.equal(gc.decompress_bf16(c), c.float())


def test_int8_zero_block_and_padding():
    """An all-zero block quantizes to zeros at scale 0 (the 1e-12 floor
    keeps the division finite); the padding is dropped on the way
    back."""
    x = _t(int8_inputs()["zeros"])
    q, s = gc.compress_int8(x)
    assert tuple(q.shape) == (2, 256) and q.dtype == torch.int8
    assert not q[0].any() and float(s[0, 0]) == 0.0
    back = gc.decompress_int8(q, s, tuple(x.shape))
    assert tuple(back.shape) == (356,) and not back[:256].any()
    np.testing.assert_allclose(back.numpy(), x.numpy(),
                               atol=float(s.max()) / 2 + 1e-7)


def test_psum_over_the_data_groups_of_a_two_by_two_mesh():
    """Over a (2, 2) mesh the ``data`` groups are ranks {0, 2} and
    {1, 3}: each rank's mean is its group's (no compression: exact)."""
    trees = _trees(3)
    with use(DistContext(make_host_mesh(2, 2, device="cpu"))):
        mean, res = gc.compressed_psum_tree(trees, "data", "none")
    for r, g in enumerate(((0, 2), (1, 3), (0, 2), (1, 3))):
        want = (trees[g[0]]["w"] + trees[g[1]]["w"]) / 2
        assert torch.equal(mean[r]["w"], want)
        assert not res[r]["w"].any()
    with pytest.raises(ValueError, match="unknown scheme"):
        with use(DistContext(make_host_mesh(2, 2, device="cpu"))):
            gc.compressed_psum_tree(trees, "data", "fp8")


@pytest.mark.parametrize("name", sorted(int8_inputs()))
def test_int8_and_bf16_are_bit_equal_to_jax(jx, name):
    x = _t(int8_inputs()[name])
    q, s = gc.compress_int8(x)
    np.testing.assert_array_equal(q.numpy(), jx[f"int8/{name}/q"])
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  jx[f"int8/{name}/scale"].view(np.uint32))
    back = gc.decompress_int8(q, s, tuple(x.shape))
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  jx[f"int8/{name}/back"].view(np.uint32))
    np.testing.assert_array_equal(
        gc.compress_bf16(x).view(torch.int16).numpy().view(np.uint16),
        jx[f"bf16/{name}"])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_compressed_psum_tree_matches_jax_and_carries_the_residual(
        jx, scheme):
    """Two calls over the (4, 1) mesh's ``data`` axis, the first's
    residual fed to the second: every rank's mean and residual against
    JAX's, each mean against the true mean of the ranks' gradients (plus
    the carried residuals' mean in the second call)."""
    mesh = make_host_mesh(N_RANKS, 1, device="cpu")
    g1, g2 = _trees(1), _trees(2)
    with use(DistContext(mesh)):
        m1, r1 = gc.compressed_psum_tree(g1, "data", scheme)
        m2, r2 = gc.compressed_psum_tree(g2, "data", scheme, residual=r1)
    for call, (m, r, g, prev) in (("1", (m1, r1, g1, None)),
                                  ("2", (m2, r2, g2, r1))):
        for k in ("w", "b"):
            want_m = jx[f"psum/{scheme}/{call}/mean/{k}"]
            want_r = jx[f"psum/{scheme}/{call}/res/{k}"]
            true = sum(t[k] for t in g) / N_RANKS
            if prev is not None:
                true = true + sum(t[k] for t in prev) / N_RANKS
            for rank in range(N_RANKS):
                np.testing.assert_allclose(m[rank][k].numpy(),
                                           want_m[rank], rtol=1e-6,
                                           atol=1e-6)
                np.testing.assert_allclose(r[rank][k].numpy(),
                                           want_r[rank], rtol=1e-6,
                                           atol=1e-6)
                np.testing.assert_allclose(m[rank][k].numpy(),
                                           true.numpy(), rtol=TOL[scheme],
                                           atol=TOL[scheme])
                assert torch.equal(m[rank][k], m[0][k])
    if scheme != "none":
        assert any(t["w"].abs().max() > 0 for t in r1)
