"""The ``"dots"`` remat policy (JAX's ``checkpoint_dots``: save every
product's output in a layer, recompute the elementwise chains) against
the port's ``"full"`` policy and the JAX package's ``"dots"``, float32
smoke models of each trained family (llama3-8b, olmoe-1b-7b,
zamba2-1.2b, rwkv6-3b) at one rank, and llama3-8b over 2 ranks.

Tolerances: against ``"full"`` (and no remat) the loss and every
gradient leaf bit-equal (the backward reads the saved outputs where
``"full"`` recomputes them, on the CPU the same bits); against JAX under
``"dots"`` the existing port-vs-JAX bounds (``test_torch_train_model.py``:
the loss within 1e-5 relative, every leaf within 1e-3 of its largest
|entry|; the logits are bf16 in both packages). The GEMM's plain-route
counter (``matmul.plain_calls``, a group or a batch one call) shows what
the backward runs: under ``"dots"`` only the gradient products, as with
no remat; under ``"full"`` those and every layer's forward products
again (all the forward's but the unembed's one a rank).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.distributed.context import (DistContext, Mesh,  # noqa: E402
                                             use)
from repro_torch.kernels.matmul import matmul  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.module import tree_items  # noqa: E402
from test_torch_recurrent_engine import nonzero_inits  # noqa: E402

torch.set_num_threads(2)
ARCHS = ("llama3-8b", "olmoe-1b-7b", "zamba2-1.2b", "rwkv6-3b")
POLICIES = {"none": dict(remat=False), "full": dict(remat=True),
            "dots": dict(remat=True, remat_policy="dots")}


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(vocab, B=2, S=32, seed=0):
    r = np.random.default_rng(seed)
    tokens = r.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = r.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels[0, :3] = -100
    return tokens, labels


def _tree(arch):
    """JAX's float32 smoke parameters (numpy), the zero inits that would
    hide a path seeded nonzero."""
    jc = jax_smoke(jax_get_config(arch)).replace(dtype=jnp.float32)
    return nonzero_inits(jax.tree.map(np.asarray, jlm.init_params(
        jax.random.PRNGKey(0), jc)))


def _leaf_close(got, want, frac, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= frac * scale, f"{what}: max err {err:.3e} > {frac} x " \
                                f"{scale:.3e}"


def _port(arch, tree, policy, W=1):
    """(loss, {leaf: gradient}, plain calls of the forward, of the
    backward) of the port under ``policy`` at W ranks (``ring``)."""
    tc = smoke_config(get_config(arch)).replace(dtype=torch.float32,
                                                **POLICIES[policy])
    mesh = Mesh(["cpu"] * W) if W > 1 else None
    params = params_from_numpy(tree, tc, device="cpu", trainable=True,
                               mesh=mesh)
    tokens, labels = _batch(tc.vocab_size)
    with use(DistContext(mesh, "ring")):
        n0 = matmul.plain_calls
        loss, _ = tlm.loss_fn(params, {"tokens": _t(tokens),
                                       "labels": _t(labels)}, tc)
        n1 = matmul.plain_calls
        loss.backward()
        n2 = matmul.plain_calls
    grads = {f"{r}/{n}": t.grad for r, p in enumerate(tlm.as_ranks(params))
             for n, t in p.named_parameters()}
    return loss.detach(), grads, n1 - n0, n2 - n1


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    arch = request.param
    tree = _tree(arch)
    return arch, tree, {p: _port(arch, tree, p) for p in POLICIES}


def test_dots_equals_full_bit_for_bit(runs):
    _, _, r = runs
    for other in ("full", "none"):
        assert torch.equal(r["dots"][0], r[other][0]), other
        for n, g in r["dots"][1].items():
            assert torch.equal(g, r[other][1][n]), (other, n)


def test_dots_backward_relaunches_no_forward_product(runs):
    """The backward's GEMM calls: ``"dots"`` as no remat; ``"full"``
    adds each layer's forward products once more (every forward call
    but the unembed's)."""
    _, _, r = runs
    fwd = {p: v[2] for p, v in r.items()}
    bwd = {p: v[3] for p, v in r.items()}
    assert fwd["none"] == fwd["full"] == fwd["dots"]
    assert bwd["dots"] == bwd["none"]
    assert bwd["full"] == bwd["dots"] + fwd["dots"] - 1


def test_dots_matches_jax_dots(runs):
    arch, tree, r = runs
    jc = jax_smoke(jax_get_config(arch)).replace(
        dtype=jnp.float32, remat=True, remat_policy="dots")
    tokens, labels = _batch(jc.vocab_size)
    (jl, _), jg = jax.jit(jax.value_and_grad(jlm.loss_fn, has_aux=True),
                          static_argnums=2)(
        jax.tree.map(jnp.asarray, tree),
        {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}, jc)
    jg = dict(tree_items(jax.tree.map(np.asarray, jg)))
    loss, grads = r["dots"][:2]
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert {n.split("/", 1)[1] for n in grads} == set(jg)
    for n, g in grads.items():
        _leaf_close(g.numpy(), jg[n.split("/", 1)[1]], 1e-3, n)


def test_dots_over_two_ranks():
    """llama3-8b at W = 2 under ``ring``: ``"dots"`` bit-equal to
    ``"full"`` at W = 2, the backward as no remat's; the loss within
    1e-5 and every gradient (blocks joined, copies summed) within 1e-3
    of the port's at W = 1 (``test_torch_multirank_train.py``)."""
    arch = "llama3-8b"
    tree = _tree(arch)
    r = {p: _port(arch, tree, p, W=2) for p in POLICIES}
    assert torch.equal(r["dots"][0], r["full"][0])
    for n, g in r["dots"][1].items():
        assert torch.equal(g, r["full"][1][n]), n
    assert r["dots"][3] == r["none"][3] < r["full"][3]
    one, g1 = _port(arch, tree, "dots")[:2]
    np.testing.assert_allclose(r["dots"][0].item(), one.item(), rtol=1e-5)
    tc = smoke_config(get_config(arch))
    dims = tlm.shard_dims(tc, Mesh(["cpu"] * 2))
    for n, d in dims.items():
        g0, gr = r["dots"][1][f"0/{n}"], r["dots"][1][f"1/{n}"]
        got = g0 + gr if d is None else torch.cat([g0, gr], dim=d)
        _leaf_close(got.numpy(), g1[f"0/{n}"].numpy(), 1e-3, n)
