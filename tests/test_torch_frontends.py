"""The vlm and audio frontends (paligemma-3b, hubert-xlarge) against the
JAX package's on the CPU: the parameter spec of all ten configurations,
``embed_inputs`` (the vlm with and without patches, the audio frames,
the label offset), the forward logits, ``loss_fn`` with every gradient
leaf against ``jax.value_and_grad`` (the vlm's -100 pad over its patch
rows included), one AdamW step on hubert (whose input table the loss
never reads, yet decays), the attention at hubert's head dim 80
(bidirectional, no RoPE, layernorm) and paligemma's 256 (prefix-LM),
and the parameter bridge with paligemma's row-sharded tied table.

Batches are seeded numpy arrays shaped as ``tests/test_configs_smoke.py``
shapes them (patches (B, num_prefix_tokens, frontend_dim), frames (B, S,
frontend_dim)); the models are the float32 smoke configs, their
parameters JAX's seeded init converted. The JAX runs are shared through
module-scoped fixtures.

Tolerances, as ``tests/test_torch_recurrent_train.py`` states them:
logits within one bf16 ulp (2**-7 relative, 1e-4 absolute: both
packages round the logits to bf16); the loss within 1e-5 relative;
every gradient leaf within 1e-3 of its largest |entry|; the embedding
and attention outputs (fp32 sums in another order) within 1e-5; the
AdamW step within 1e-6 of each leaf's largest |entry|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.configs.registry import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.distributed.context import Mesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.module import tree_items  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

torch.set_num_threads(2)
ARCHS = ("paligemma-3b", "hubert-xlarge")
B, S = 2, 24
# (arch, with patches): the vlm trains with its patch prefix and serves
# and trains text-only (JAX's CLI trainer); audio always has frames
CASES = {"vlm_patches": ("paligemma-3b", True),
         "vlm_text": ("paligemma-3b", False),
         "audio": ("hubert-xlarge", True)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(arch, **kw):
    jc = jax_smoke(jax_get_config(arch)).replace(dtype=jnp.float32, **kw)
    tc = smoke_config(get_config(arch)).replace(dtype=torch.float32, **kw)
    return jc, tc


def batch_for(cfg, front=True, seed=0):
    """A seeded numpy batch (labels with ignored entries)."""
    r = np.random.default_rng(seed)
    labels = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -100
    if cfg.family == "audio":
        return {"frames": r.normal(size=(B, S, cfg.frontend_dim))
                .astype(np.float32), "labels": labels}
    out = {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": labels}
    if front:
        out["patches"] = r.normal(size=(B, cfg.num_prefix_tokens,
                                        cfg.frontend_dim)).astype(np.float32)
    return out


def _leaf_close(got, want, frac, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= frac * scale, f"{what}: max err {err:.3e} > {frac} x " \
                                f"{scale:.3e}"


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: the JAX config, numpy parameters, batch, embed_inputs,
    logits, loss and gradients (one jitted ``value_and_grad`` each)."""
    out = {}
    for case, (arch, front) in CASES.items():
        jc, tc = _cfgs(arch)
        tree = jax.tree.map(np.asarray, jlm.init_params(
            jax.random.PRNGKey(0), jc))
        jp = jax.tree.map(jnp.asarray, tree)
        batch = batch_for(jc, front)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        prefix = jlm.embed_inputs(jp, jb, jc)[2]

        @jax.jit
        def run(p, b):
            x, pos, _ = jlm.embed_inputs(p, b, jc)
            logits, _ = jlm.forward(p, b, jc)
            (loss, _), grads = jax.value_and_grad(
                jlm.loss_fn, has_aux=True)(p, b, jc)
            return x, pos, logits.astype(jnp.float32), loss, grads
        x, pos, logits, loss, grads = run(jp, jb)
        out[case] = dict(
            jc=jc, tc=tc, tree=tree, batch=batch, x=np.asarray(x),
            positions=np.asarray(pos), prefix=prefix,
            logits=np.asarray(logits), loss=float(loss),
            grads=dict(tree_items(jax.tree.map(np.asarray, grads))))
    return out


# ------------------------------------------------------------------- spec
@pytest.mark.parametrize("arch", sorted(JAX_REGISTRY))
def test_spec_of_every_config_matches_jax(arch):
    """``lm_spec`` builds for all ten configurations, at full width and
    smoke, with JAX's keys, shapes and logical axes
    (``frontend_proj.kernel`` (frontend_dim, d_model) for the two
    frontends)."""
    for jc, tc in ((jax_get_config(arch), get_config(arch)),
                   (jax_smoke(jax_get_config(arch)),
                    smoke_config(get_config(arch)))):
        want = {k: (v.shape, v.axes)
                for k, v in tree_items(jlm.lm_spec(jc))}
        got = {k: (v.shape, v.axes) for k, v in tree_items(tlm.lm_spec(tc))}
        assert got == want
        assert ("frontend_proj.kernel" in got) == bool(tc.frontend_dim)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_jax(arch):
    """The frontend fields (and every other field but the dtypes) are
    JAX's, full width and smoke; hubert has no decode step."""
    for jc, tc in ((jax_get_config(arch), get_config(arch)),
                   (jax_smoke(jax_get_config(arch)),
                    smoke_config(get_config(arch)))):
        for f in ("family", "frontend_dim", "num_prefix_tokens",
                  "prefix_lm", "causal", "rope_theta", "norm", "act",
                  "head_dim", "tie_embeddings", "sharding_overrides"):
            assert getattr(tc, f) == getattr(jc, f), f
        assert tc.has_decode == jc.has_decode == (arch != "hubert-xlarge")


@pytest.mark.parametrize("arch", ARCHS)
def test_storage_dtypes(arch):
    """Serving form: ``frontend_proj`` in ``cfg.dtype`` (JAX casts it per
    call), the tied table in fp32 (it is also the fp32 unembed), norm
    scales and biases in fp32; trainable: every leaf an fp32 master."""
    tc = smoke_config(get_config(arch))
    params = tlm.init_params(tc, seed=0, device="cpu")
    dt = dict(params.named_parameters())
    assert dt["frontend_proj.kernel"].dtype == tc.dtype
    assert dt["embed.table"].dtype == (torch.float32 if tc.tie_embeddings
                                       else tc.dtype)
    assert dt["ln_f.scale"].dtype == torch.float32
    if tc.norm == "layernorm":
        assert dt["ln_f.bias"].dtype == torch.float32
    trained = tlm.init_params(tc, seed=0, device="cpu", trainable=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in trained.parameters())


# ------------------------------------------------------------- numerics
@pytest.mark.parametrize("case", sorted(CASES))
def test_embed_inputs_matches_jax(jax_runs, case):
    """x, positions and the label offset: the vlm's patches projected and
    put in front of the tokens' rows (offset P), or the tokens alone
    (offset 0); the audio frames projected (offset 0)."""
    r = jax_runs[case]
    tp = params_from_numpy(r["tree"], r["tc"], device="cpu")
    with torch.no_grad():
        x, pos, prefix = tlm.embed_inputs(
            tp, {k: _t(v) for k, v in r["batch"].items()}, r["tc"])
    assert prefix == r["prefix"]
    assert prefix == (r["tc"].num_prefix_tokens if case == "vlm_patches"
                      else 0)
    np.testing.assert_array_equal(pos.numpy(), r["positions"])
    assert x.dtype == r["tc"].dtype
    np.testing.assert_allclose(x.numpy(), r["x"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_every_grad_match_jax(jax_runs, case):
    """The logits, the loss (with the vlm's -100 pad over its patch rows)
    and every gradient leaf against ``jax.value_and_grad``; a leaf the
    loss does not read (the audio model's input table, the text-only
    vlm's ``frontend_proj``) has no gradient here and zeros in JAX."""
    r = jax_runs[case]
    tc = r["tc"]
    tp = params_from_numpy(r["tree"], tc, device="cpu", trainable=True)
    tb = {k: _t(v) for k, v in r["batch"].items()}
    with torch.no_grad():
        logits, _ = tlm.forward(tp, tb, tc)
    assert logits.shape[1] == S + (r["prefix"] or 0)
    np.testing.assert_allclose(logits.float().numpy(), r["logits"],
                               rtol=2 ** -7, atol=1e-4)
    loss, _ = tlm.loss_fn(tp, tb, tc)
    loss.backward()
    np.testing.assert_allclose(loss.item(), r["loss"], rtol=1e-5)
    unread = {"audio": {"embed.table"},
              "vlm_text": {"frontend_proj.kernel"}}.get(case, set())
    got = dict(tp.named_parameters())
    assert set(got) == set(r["grads"])
    for name, p in got.items():
        if name in unread:
            assert p.grad is None and not r["grads"][name].any(), name
            continue
        assert p.grad is not None and bool(p.grad.abs().max() > 0), name
        _leaf_close(p.grad.numpy(), r["grads"][name], 1e-3, name)


def test_adamw_step_decays_the_unread_table_as_jax(jax_runs):
    """One AdamW step on hubert from JAX's gradients, the input table's
    (zeros in JAX) handed to the port as ``None``, as its backward leaves
    it: the table decays by lr x wd x its value, and every leaf lands
    where JAX's step puts it."""
    r = jax_runs["audio"]
    tc = r["tc"]
    tp = params_from_numpy(r["tree"], tc, device="cpu", trainable=True)
    loss, _ = tlm.loss_fn(tp, {k: _t(v) for k, v in r["batch"].items()}, tc)
    loss.backward()
    assert tp["embed"]["table"].grad is None
    tree = tlm.param_tree(tp)
    grads = {n: None if n == "embed.table" else _t(g)
             for n, g in r["grads"].items()}
    lr = 1e-2
    jparams = jax.tree.map(jnp.asarray, r["tree"])
    jgrads = jax.tree.map(jnp.asarray, _nest(r["grads"]))
    jcfg = jadamw.AdamWConfig(lr=lr)
    jnew, _, jmet = jax.jit(lambda p, g: jadamw.apply_updates(
        p, g, jadamw.init_state(p), jcfg))(jparams, jgrads)
    before = tree["embed"]["table"].detach().clone()
    met = tadamw.apply_updates(tree, _nest(grads), tadamw.init_state(tree),
                               tadamw.AdamWConfig(lr=lr))
    np.testing.assert_allclose(met["grad_norm"].item(),
                               float(jmet["grad_norm"]), rtol=1e-6)
    torch.testing.assert_close(
        tree["embed"]["table"].detach(),
        before * (1 - lr * tadamw.AdamWConfig().weight_decay),
        rtol=1e-6, atol=0)
    want = dict(tree_items(jax.tree.map(np.asarray, jnew)))
    for name, p in tree_items(tree):
        _leaf_close(p.detach().numpy(), want[name], 1e-6, name)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *ks, leaf = path.split(".")
        for k in ks:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


@pytest.mark.parametrize("arch,hd", [("hubert-xlarge", 80),
                                     ("paligemma-3b", 256)])
def test_attention_at_the_frontends_head_dims(arch, hd):
    """``apply_attn`` against JAX's at hubert's head dim 80 (bidirectional,
    no RoPE) and paligemma's 256 (prefix-LM over the first
    ``num_prefix_tokens`` positions, RoPE), a sequence longer than the
    prefix."""
    jc, tc = _cfgs(arch, head_dim=hd)
    r = np.random.default_rng(1)
    d, H, KVH = tc.d_model, tc.n_heads, tc.n_kv_heads
    w = {"wq": r.normal(size=(d, H * hd)), "wk": r.normal(size=(d, KVH * hd)),
         "wv": r.normal(size=(d, KVH * hd)), "wo": r.normal(size=(H * hd, d))}
    w = {k: (v / np.sqrt(v.shape[0])).astype(np.float32) for k, v in w.items()}
    x = r.normal(size=(B, 20, d)).astype(np.float32)
    want = jattn.apply_attn({k: jnp.asarray(v) for k, v in w.items()},
                            jnp.asarray(x), jc)
    got = tattn.apply_attn({k: _t(v) for k, v in w.items()}, _t(x), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------- bridge
@pytest.mark.parametrize("W", [2, 4])
def test_bridge_carries_the_frontend_and_the_row_sharded_table(W):
    """``params_from_numpy`` keeps ``frontend_proj``; with a mesh, the
    tied table's rows are sharded over the ranks (paligemma's
    ``in_vocab`` -> model override: rank r holds rows [r V/W, (r+1)
    V/W)), ``frontend_proj`` is a copy on every rank, and
    ``gather_params`` gives the global tree back."""
    jc, tc = _cfgs("paligemma-3b")
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0),
                                                    jc))
    mesh = Mesh(["cpu"] * W)
    ranks = params_from_numpy(tree, tc, device="cpu", trainable=True,
                              mesh=mesh)
    V = tc.vocab_size
    for r, p in enumerate(ranks):
        np.testing.assert_array_equal(
            p["embed"]["table"].detach().numpy(),
            tree["embed"]["table"][r * V // W:(r + 1) * V // W])
        np.testing.assert_array_equal(
            p["frontend_proj"]["kernel"].detach().numpy(),
            tree["frontend_proj"]["kernel"])
    dims = tlm.shard_dims(tc, mesh)
    assert dims["embed.table"] == 0 and dims["frontend_proj.kernel"] is None
    back = dict(tree_items(tlm.param_tree(tlm.gather_params(ranks, mesh))))
    for name, want in tree_items(tree):
        np.testing.assert_array_equal(back[name].detach().numpy(), want)
