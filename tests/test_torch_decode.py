"""The port's decode entry points against the JAX package's, with the
JAX parameters converted (float32 config).

Tolerance: both packages cast the fp32 unembed to bf16 logits
(``lm.logits_fn``), so an element whose fp32 value sits on a bf16
rounding boundary can come out one bf16 ulp apart (at most 2**-7
relative); everything else agrees within 1e-4.
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
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.module import tree_items  # noqa: E402

torch.set_num_threads(2)
LOGIT_TOL = dict(rtol=2 ** -7, atol=1e-4)
B, BS, N_BLOCKS, MAX_BLOCKS = 3, 4, 12, 6


def _cfgs(n_layers=2, **kw):
    jc = jax_smoke(jax_get_config("llama3-8b")).replace(
        n_layers=n_layers, dtype=jnp.float32, **kw)
    tc = smoke_config(get_config("llama3-8b")).replace(
        n_layers=n_layers, dtype=torch.float32, **kw)
    return jc, tc


def _models(**kw):
    jc, tc = _cfgs(**kw)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, jp, tc, tp


def _states(jc, jp, tc, tp, tables):
    js = jlm.init_paged_decode_state(jp, jc, B, N_BLOCKS, BS, MAX_BLOCKS)
    js = {**js, "block_tables": jnp.asarray(tables)}
    ts = tlm.init_paged_decode_state(tp, tc, B, N_BLOCKS, BS, MAX_BLOCKS)
    ts["block_tables"].copy_(torch.from_numpy(tables))
    return js, ts


TABLES = np.array([[3, 0, 7, -1, -1, -1], [5, 1, -1, -1, -1, -1],
                   [2, 9, 4, 11, -1, -1]], np.int32)


def test_params_from_numpy_round_trip():
    """Keys, shapes and storage dtypes of the converted smoke llama3-8b
    (bf16 config): matrices and the embedding in bf16, norm scales and
    the head in fp32, stacked (n_layers, ...) layer leaves kept."""
    jc = jax_smoke(jax_get_config("llama3-8b"))
    tc = smoke_config(get_config("llama3-8b"))
    jp = jlm.init_params(jax.random.PRNGKey(1), jc)
    np_tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(np_tree, tc, device="cpu")
    got = {k: v for k, v in tp.named_parameters()}
    want = dict(tree_items(np_tree))
    assert set(got) == set(want)
    for k, arr in want.items():
        assert tuple(got[k].shape) == arr.shape, k
        leaf = k.rsplit(".", 1)[-1]
        fp32 = k == "head.table" or leaf == "scale"
        assert got[k].dtype == (torch.float32 if fp32 else torch.bfloat16), k
        ref = torch.from_numpy(np.array(arr)).to(got[k].dtype)
        assert torch.equal(got[k], ref), k
    assert got["backbone.layers.attn.wq"].shape[0] == tc.n_layers
    with pytest.raises(ValueError):
        params_from_numpy({k: v for k, v in np_tree.items() if k != "head"},
                          tc, device="cpu")


def test_decode_chunk_then_step_matches_jax():
    """Chunked prefill with ragged counts, then single steps with an
    active mask: logits after every call, cur_len, and the KV pools."""
    jc, jp, tc, tp = _models()
    js, ts = _states(jc, jp, tc, tp, TABLES)
    r = np.random.default_rng(0)
    chunks = [(r.integers(1, 512, (B, 4)).astype(np.int32),
               np.array([4, 4, 3], np.int32)),
              (r.integers(1, 512, (B, 4)).astype(np.int32),
               np.array([2, 0, 4], np.int32))]
    for gw in (4, None):
        js, ts = _states(jc, jp, tc, tp, TABLES)
        for toks, cnt in chunks:
            jl, js = jlm.decode_chunk(jp, jnp.asarray(toks),
                                      jnp.asarray(cnt), js, jc,
                                      gather_width=gw)
            tl, ts = tlm.decode_chunk(tp, torch.from_numpy(toks),
                                      torch.from_numpy(cnt), ts, tc,
                                      gather_width=gw)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGIT_TOL)
        for act in ([True, True, True], [False, True, True]):
            tok = r.integers(1, 512, (B, 1)).astype(np.int32)
            act = np.array(act)
            jl, js = jlm.decode_step(jp, jnp.asarray(tok), js, jc,
                                     active=jnp.asarray(act),
                                     gather_width=gw)
            tl, ts = tlm.decode_step(tp, torch.from_numpy(tok), ts, tc,
                                     active=torch.from_numpy(act),
                                     gather_width=gw)
            assert tl.dtype == torch.bfloat16
            np.testing.assert_allclose(tl.float().numpy(),
                                       np.asarray(jl, np.float32),
                                       **LOGIT_TOL)
        np.testing.assert_array_equal(ts["cur_len"].numpy(),
                                      np.asarray(js["cur_len"]))
        for leaf in ("k", "v"):
            np.testing.assert_allclose(ts["caches"][leaf].numpy(),
                                       np.asarray(js["caches"][leaf]),
                                       rtol=1e-4, atol=1e-4)


def test_decode_step_with_window_matches_jax():
    """A sliding-window config (window smaller than the history)."""
    jc, jp, tc, tp = _models(sliding_window=5)
    js, ts = _states(jc, jp, tc, tp, TABLES)
    r = np.random.default_rng(1)
    for _ in range(7):
        tok = r.integers(1, 512, (B, 1)).astype(np.int32)
        jl, js = jlm.decode_step(jp, jnp.asarray(tok), js, jc)
        tl, ts = tlm.decode_step(tp, torch.from_numpy(tok), ts, tc)
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl, np.float32), **LOGIT_TOL)


def test_inactive_slots_byte_identical():
    """A decode step with active=[F, T, F] leaves the pools byte-
    identical everywhere except the active slot's one new position, and
    leaves the inactive slots' cur_len alone."""
    _, tc = _cfgs()
    tp = tlm.init_params(tc, seed=0, device="cpu")
    ts = tlm.init_paged_decode_state(tp, tc, B, N_BLOCKS, BS, MAX_BLOCKS)
    ts["block_tables"].copy_(torch.from_numpy(TABLES))
    with torch.inference_mode():
        for t in (5, 7, 9):
            tlm.decode_step(tp, torch.full((B, 1), t), ts, tc)
        before = {k: v.clone() for k, v in ts["caches"].items()}
        len0 = ts["cur_len"].clone()
        tlm.decode_step(tp, torch.full((B, 1), 11), ts, tc,
                        active=torch.tensor([False, True, False]))
    assert ts["cur_len"].tolist() == [3, 4, 3] and len0.tolist() == [3] * 3
    blk, off = int(TABLES[1, 3 // BS]), 3 % BS    # slot 1 wrote pos 3
    for k in ("k", "v"):
        changed = (ts["caches"][k] != before[k]).any(dim=(3, 4))
        assert changed[:, blk, off].all()
        changed[:, blk, off] = False
        assert not changed.any()


def test_init_params_is_seeded_and_keyed_like_jax():
    _, tc = _cfgs()
    a = tlm.init_params(tc, seed=3, device="cpu")
    b = tlm.init_params(tc, seed=3, device="cpu")
    c = tlm.init_params(tc, seed=4, device="cpu")
    jc, _ = _cfgs()
    jkeys = {k for k, _ in tree_items(jax.tree.map(
        lambda s: s, jlm.lm_spec(jc),
        is_leaf=lambda x: hasattr(x, "shape")))}
    names = [k for k, _ in a.named_parameters()]
    assert set(names) == jkeys
    for (k, x), (_, y), (_, z) in zip(a.named_parameters(),
                                      b.named_parameters(),
                                      c.named_parameters()):
        assert torch.equal(x, y), k
        if not k.endswith("scale"):          # ones init: seed-free
            assert not torch.equal(x, z), k


def test_entry_points_refuse_cuda_without_a_gpu():
    """With no GPU the default device raises instead of continuing on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, tc = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_params(tc, seed=0)


def test_other_blocks_are_a_later_slice():
    """Every family builds now: the recurrent ones
    (tests/test_torch_recurrent_*.py) and the vlm and audio frontends
    (tests/test_torch_frontends*.py), their specs with JAX's keys and
    shapes, as the MoE family's (tests/test_torch_moe.py). The encoder
    (hubert) has no decode step. The ``"dots"`` remat policy trains:
    the loss and its gradients equal ``"full"``'s bit for bit
    (tests/test_torch_remat_dots.py)."""
    for arch in ("rwkv6-3b", "zamba2-1.2b", "paligemma-3b",
                 "hubert-xlarge"):
        want = {k: v.shape for k, v in tree_items(jlm.lm_spec(
            jax_smoke(jax_get_config(arch))))}
        got = {k: v.shape for k, v in tree_items(tlm.lm_spec(
            smoke_config(get_config(arch))))}
        assert got == want, arch
    assert not smoke_config(get_config("hubert-xlarge")).has_decode
    batch = {"tokens": torch.arange(4, dtype=torch.int32)[None],
             "labels": torch.arange(1, 5, dtype=torch.int32)[None]}
    out = {}
    for policy in ("full", "dots"):
        tc = smoke_config(get_config("llama3-8b")).replace(
            n_layers=1, remat=True, remat_policy=policy)
        params = tlm.init_params(tc, seed=0, device="cpu", trainable=True)
        loss, _ = tlm.loss_fn(params, batch, tc)
        loss.backward()
        out[policy] = [loss.detach()] + [t.grad for t in params.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(out["full"], out["dots"]))