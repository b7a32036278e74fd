"""The port's MoE layer (``repro_torch.models.moe``) and the ``attn_moe``
decode against the JAX package's, on the same numpy inputs.

Tolerances, with their reasons:
* ``capacity``: equal (integer arithmetic);
* ``route``: every integer field equal; gates and the aux loss within
  1e-6 (the fp32 router product sums in another order). A top-k gap
  below ~1e-6 could pick another expert; each case reports the
  smallest gap it met between the k-th and (k+1)-th probability;
* ``apply_moe``: float32 within 1e-5; bf16 within 2e-2 (bf16 rounds at
  other places in the two frameworks: silu, the products' outputs);
* ``decode_step`` logits: one bf16 ulp (both packages cast the fp32
  unembed to bf16 logits: 2**-7 relative, 1e-4 absolute), as in
  ``tests/test_torch_decode.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.module import tree_items  # noqa: E402

torch.set_num_threads(2)
ARCHS = ("olmoe-1b-7b", "mixtral-8x22b")
INT_FIELDS = ("token_of_slot", "slot_valid", "expert_of_flat",
              "slot_of_flat", "kept_flat")
LOGIT_TOL = dict(rtol=2 ** -7, atol=1e-4)


def _cfgs(arch, smoke=True, **kw):
    jc, tc = jax_get_config(arch), get_config(arch)
    if smoke:
        jc, tc = jax_smoke(jc), smoke_config(tc)
    return jc.replace(**kw), tc.replace(**kw)


def _moe_params(seed, D, F, E):
    r = np.random.default_rng(seed)
    return {"router": r.normal(size=(D, E)).astype(np.float32) / D ** 0.5,
            "wg": r.normal(size=(E, D, F)).astype(np.float32) / D ** 0.5,
            "wu": r.normal(size=(E, D, F)).astype(np.float32) / D ** 0.5,
            "wd": r.normal(size=(E, F, D)).astype(np.float32) / F ** 0.5}


def _x(seed, B, T, D):
    return np.random.default_rng(seed).normal(
        size=(B, T, D)).astype(np.float32)


def _top_gap(x, router, K):
    """The smallest gap between the K-th and (K+1)-th router
    probability over the tokens of ``x`` (float64 reference)."""
    logits = x.astype(np.float64) @ router.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[..., ::-1]
    return float((p[..., K - 1] - p[..., K]).min())


# ------------------------------------------------------------- capacity
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("T", [1, 8, 1024])
def test_capacity_matches_jax(arch, smoke, T):
    jc, tc = _cfgs(arch, smoke)
    assert tmoe.capacity(tc, T) == jmoe.capacity(jc, T)
    for cf in (0.25, 2.0):
        assert tmoe.capacity(tc.replace(moe_capacity_factor=cf), T) == \
            jmoe.capacity(jc.replace(moe_capacity_factor=cf), T)


def test_capacity_at_the_olmoe_shapes():
    """Decode (T = 1) keeps C = 1; a 1024-token row rounds 160 up to a
    multiple of 8."""
    cfg = get_config("olmoe-1b-7b")
    assert tmoe.capacity(cfg, 1) == 1
    assert tmoe.capacity(cfg, 1024) == 160
    assert tmoe.capacity(cfg.replace(moe_capacity_factor=0.25), 100) == 3


# ---------------------------------------------------------------- route
@pytest.mark.parametrize("arch,smoke", [("olmoe-1b-7b", True),
                                        ("mixtral-8x22b", True),
                                        ("olmoe-1b-7b", False)])
@pytest.mark.parametrize("T", [1, 16, 64])
@pytest.mark.parametrize("cf", [0.25, 1.25])
def test_route_matches_jax(arch, smoke, T, cf):
    jc, tc = _cfgs(arch, smoke, moe_capacity_factor=cf)
    D, E, K = tc.d_model, tc.moe_num_experts, tc.moe_top_k
    x = _x(T, 2, T, D)
    router = _moe_params(T + 1, D, 8, E)["router"]
    gap = _top_gap(x, router, K)
    print(f"[route] {arch} smoke={smoke} T={T} cf={cf}: smallest top-k "
          f"gap {gap:.3e}")
    want = jmoe.route(jnp.asarray(x), jnp.asarray(router), jc)
    got = tmoe.route(torch.from_numpy(x), torch.from_numpy(router), tc)
    assert got["C"] == want["C"]
    for f in INT_FIELDS:
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]),
                                      err_msg=f"{f} (top-k gap {gap:.3e})")
    np.testing.assert_allclose(got["gate"].numpy(), np.asarray(want["gate"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["aux"].item(), float(want["aux"]),
                               rtol=1e-6)
    if T > 1 and cf == 0.25:          # the capacity drops something
        assert not got["kept_flat"].all()


def test_route_ties_go_to_the_lower_expert():
    """Equal router probabilities: the stable sort picks the lower
    expert ids first, as ``lax.top_k`` does."""
    jc, tc = _cfgs("olmoe-1b-7b")
    x = np.ones((1, 3, tc.d_model), np.float32)
    router = np.zeros((tc.d_model, tc.moe_num_experts), np.float32)
    router[:, 5] = 1.0                  # expert 5 first, then ties
    want = jmoe.route(jnp.asarray(x), jnp.asarray(router), jc)
    got = tmoe.route(torch.from_numpy(x), torch.from_numpy(router), tc)
    np.testing.assert_array_equal(got["expert_of_flat"].numpy(),
                                  np.asarray(want["expert_of_flat"]))
    assert got["expert_of_flat"][0, :2].tolist() == [5, 0]


# ------------------------------------------------------------ apply_moe
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,cf", [(1, 1.25), (16, 1.25), (16, 0.25)])
def test_apply_moe_matches_jax(arch, dtype, T, cf):
    jc, tc = _cfgs(arch, moe_capacity_factor=cf)
    D, F, E = tc.d_model, tc.d_ff, tc.moe_num_experts
    p = _moe_params(3, D, F, E)
    x = _x(4, 3, T, D)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    want, waux = jmoe.apply_moe({k: jnp.asarray(v) for k, v in p.items()},
                                jx, jc)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    got, gaux = tmoe.apply_moe({k: torch.from_numpy(v) for k, v in p.items()},
                               tx, tc)
    assert got.dtype == tdt and got.shape == (3, T, D)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(gaux.item(), float(waux), rtol=1e-6)


def test_apply_moe_counts_three_batched_products_and_the_router():
    """On the CPU every product is one plain-version call: the router
    and the three expert products (one batched call each)."""
    from repro_torch.kernels.matmul import matmul
    _, tc = _cfgs("olmoe-1b-7b")
    p = {k: torch.from_numpy(v) for k, v in
         _moe_params(0, tc.d_model, tc.d_ff, tc.moe_num_experts).items()}
    n0, q0 = matmul.launches, matmul.plain_calls
    tmoe.apply_moe(p, torch.from_numpy(_x(1, 2, 5, tc.d_model)), tc)
    assert matmul.plain_calls - q0 == 4 and matmul.launches == n0


def test_route_has_no_host_sync_ops():
    """The routing replays in a CUDA graph: no op that reads a device
    value back on the host."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(tmoe))
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert called & {"item", "nonzero", "unique", "tolist", "cpu", "numpy",
                     "masked_select", "one_hot"} == set()
    assert {"sort", "argsort", "searchsorted", "take_along_dim"} <= called


# ---------------------------------------------------- the decode step
B, BS, N_BLOCKS, MAX_BLOCKS = 3, 4, 12, 6
TABLES = np.array([[3, 0, 7, -1, -1, -1], [5, 1, -1, -1, -1, -1],
                   [2, 9, 4, 11, -1, -1]], np.int32)


def _models(arch, **kw):
    jc, tc = _cfgs(arch, n_layers=2, dtype=jnp.float32, **kw)
    tc = tc.replace(dtype=torch.float32)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, jp, tc, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chunk_then_step_matches_jax(arch):
    """Chunked prefill with ragged counts, then steps with an active
    mask (olmoe-smoke; mixtral-smoke: KVH 1 and a sliding window of 32):
    logits after every call, cur_len and the KV pools."""
    jc, jp, tc, tp = _models(arch)
    js = jlm.init_paged_decode_state(jp, jc, B, N_BLOCKS, BS, MAX_BLOCKS)
    js = {**js, "block_tables": jnp.asarray(TABLES)}
    ts = tlm.init_paged_decode_state(tp, tc, B, N_BLOCKS, BS, MAX_BLOCKS)
    ts["block_tables"].copy_(torch.from_numpy(TABLES))
    r = np.random.default_rng(0)
    for cnt in ([4, 4, 3], [2, 0, 4]):
        toks = r.integers(1, 512, (B, 4)).astype(np.int32)
        cnt = np.array(cnt, np.int32)
        jl, js = jlm.decode_chunk(jp, jnp.asarray(toks), jnp.asarray(cnt),
                                  js, jc)
        tl, ts = tlm.decode_chunk(tp, torch.from_numpy(toks),
                                  torch.from_numpy(cnt), ts, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for act in ([True, True, True], [False, True, True]):
        tok = r.integers(1, 512, (B, 1)).astype(np.int32)
        act = np.array(act)
        jl, js = jlm.decode_step(jp, jnp.asarray(tok), js, jc,
                                 active=jnp.asarray(act))
        tl, ts = tlm.decode_step(tp, torch.from_numpy(tok), ts, tc,
                                 active=torch.from_numpy(act))
        assert tl.dtype == torch.bfloat16
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, np.float32), **LOGIT_TOL)
    np.testing.assert_array_equal(ts["cur_len"].numpy(),
                                  np.asarray(js["cur_len"]))
    for leaf in ("k", "v"):
        np.testing.assert_allclose(ts["caches"][leaf].numpy(),
                                   np.asarray(js["caches"][leaf]),
                                   rtol=1e-4, atol=1e-4)


def test_inactive_slots_leave_the_moe_state_untouched():
    """A step with active=[F, T, F] writes only the active slot's new
    position (routing is per slot: the frozen rows' garbage routes touch
    nothing)."""
    _, tc = _cfgs("olmoe-1b-7b", n_layers=2)
    tc = tc.replace(dtype=torch.float32)
    tp = tlm.init_params(tc, seed=0, device="cpu")
    ts = tlm.init_paged_decode_state(tp, tc, B, N_BLOCKS, BS, MAX_BLOCKS)
    ts["block_tables"].copy_(torch.from_numpy(TABLES))
    with torch.inference_mode():
        for t in (5, 7, 9):
            tlm.decode_step(tp, torch.full((B, 1), t), ts, tc)
        before = {k: v.clone() for k, v in ts["caches"].items()}
        tlm.decode_step(tp, torch.full((B, 1), 11), ts, tc,
                        active=torch.tensor([False, True, False]))
    assert ts["cur_len"].tolist() == [3, 4, 3]
    blk = int(TABLES[1, 0])
    for k in ("k", "v"):
        changed = (ts["caches"][k] != before[k]).any(dim=(3, 4))
        assert changed[:, blk, 3].all()
        changed[:, blk, 3] = False
        assert not changed.any()


# ------------------------------------------------------ parameters
def test_moe_params_convert_with_an_fp32_router():
    """The converted olmoe-smoke (bf16 config): JAX's keys and shapes,
    the stacked (L, E, ...) expert leaves in bf16, the router kept in
    fp32 (JAX routes with the fp32 master)."""
    jc, tc = _cfgs("olmoe-1b-7b")
    jp = jlm.init_params(jax.random.PRNGKey(1), jc)
    np_tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(np_tree, tc, device="cpu")
    got = dict(tp.named_parameters())
    want = dict(tree_items(np_tree))
    assert set(got) == set(want)
    L, E, D, F = tc.n_layers, tc.moe_num_experts, tc.d_model, tc.d_ff
    shapes = {"router": (L, D, E), "wg": (L, E, D, F), "wu": (L, E, D, F),
              "wd": (L, E, F, D)}
    for leaf, shape in shapes.items():
        t = got[f"backbone.layers.moe.{leaf}"]
        assert tuple(t.shape) == shape
        assert t.dtype == (torch.float32 if leaf == "router"
                           else torch.bfloat16)
        ref = torch.from_numpy(np.array(want[f"backbone.layers.moe.{leaf}"]))
        assert torch.equal(t, ref.to(t.dtype)), leaf
    assert "backbone.layers.mlp.wg" not in got


def test_lm_spec_matches_jax_for_moe():
    for arch in ARCHS:
        for smoke in (False, True):
            jc, tc = _cfgs(arch, smoke)
            jspec = dict(tree_items(jax.tree.map(
                lambda s: s, jlm.lm_spec(jc),
                is_leaf=lambda x: hasattr(x, "shape"))))
            tspec = dict(tree_items(tlm.lm_spec(tc)))
            assert set(jspec) == set(tspec)
            for k, p in tspec.items():
                assert tuple(p.shape) == tuple(jspec[k].shape), k
                assert tuple(p.axes) == tuple(jspec[k].axes), k
