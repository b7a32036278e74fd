"""The port's MoE training path against the JAX package's on the CPU
(olmoe-smoke, 2 layers unless a test says otherwise): the forward and
its summed aux loss, the loss (ce + 0.01 aux) and every gradient leaf
(the router's included) against ``jax.value_and_grad``, the trainer's
3-step curve against JAX's trainer from the same parameters, a JAX
checkpoint resumed, and ``--tp W > 1`` refused before anything is
allocated.

Tolerances, with their reasons (as ``tests/test_torch_train_model.py``
and ``tests/test_torch_train_loop.py``):
* float32: logits within one bf16 ulp (2**-7 relative, 1e-4 absolute;
  both packages cast the fp32 unembed to bf16 logits); the loss, ce and
  aux within 1e-5 relative; every gradient leaf within 1e-3 of its
  largest |entry| (the logits' gradient is bf16 too, so an element on a
  rounding boundary moves by one bf16 ulp and spreads through the
  backward's sums);
* the trainers, run at float32 compute (``smoke_config`` patched in
  both packages' trainers): losses within 1e-5 relative of JAX's run.
  In bf16 the smoke MoE's gradient norms of 300-900 turn a bf16
  rounding difference into another expert at a near-tie: resuming JAX's
  step-2 checkpoint, the port's step-3 loss sat 3.6e-3 from JAX's, its
  gradient norm 1% (at float32: 1e-6).
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.module import tree_items  # noqa: E402

torch.set_num_threads(2)
ARCH = "olmoe-1b-7b"


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(**kw):
    jc = jax_smoke(jax_get_config(ARCH)).replace(n_layers=2,
                                                 dtype=jnp.float32, **kw)
    tc = smoke_config(get_config(ARCH)).replace(n_layers=2,
                                                dtype=torch.float32, **kw)
    return jc, tc


def _models(**kw):
    jc, tc = _cfgs(**kw)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu",
                           trainable=True)
    return jc, jp, tc, tp


def _batch(vocab, B=2, S=16, seed=0):
    r = np.random.default_rng(seed)
    tokens = r.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = r.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels[0, :3] = -100
    return tokens, labels


def _leaf_close(got, want, frac, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= frac * scale, f"{what}: max err {err:.3e} > {frac} x " \
                                f"{scale:.3e}"


def test_forward_logits_and_aux_match_jax():
    jc, jp, tc, tp = _models()
    tokens, _ = _batch(tc.vocab_size)
    jlog, jaux = jlm.forward(jp, {"tokens": jnp.asarray(tokens)}, jc)
    with torch.no_grad():
        tlog, taux = tlm.forward(tp, {"tokens": _t(tokens)}, tc)
    np.testing.assert_allclose(tlog.float().numpy(),
                               np.asarray(jlog.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-4)
    assert float(jaux) > 0
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("remat,cf", [(False, 1.25), (True, 1.25),
                                      (False, 0.25)])
def test_loss_and_grads_match_jax(remat, cf):
    """Every leaf's gradient, the router's through the gates and the aux
    loss; capacity factor 0.25 drops choices (C = 1 at 16 tokens)."""
    jc, jp, tc, tp = _models(remat=remat, moe_capacity_factor=cf)
    tokens, labels = _batch(tc.vocab_size)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jlm.loss_fn, has_aux=True),
                           static_argnums=2)(
        jp, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
        jc)
    jg = dict(tree_items(jax.tree.map(np.asarray, jg)))
    tl, tm = tlm.loss_fn(tp, {"tokens": _t(tokens), "labels": _t(labels)},
                         tc)
    tl.backward()
    for got, want in ((tl, jl), (tm["ce"], jm["ce"]), (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tl.item(), tm["ce"].item()
                               + 0.01 * tm["aux"].item(), rtol=1e-6)
    got = {n: t.grad for n, t in tp.named_parameters()}
    assert set(got) == set(jg)
    assert all(g is not None and g.dtype == torch.float32
               for g in got.values())
    assert got["backbone.layers.moe.router"].abs().max() > 0
    for name, g in got.items():
        _leaf_close(g.numpy(), jg[name], 1e-3, name)


# -------------------------------------------------------------- trainer
RUN = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16",
       "--log-every", "1"]


@pytest.fixture
def float32_trainers(monkeypatch):
    """Both packages' trainers build the smoke config at float32
    compute (module docstring)."""
    jsmoke, tsmoke = jtrain.smoke_config, ttrain.smoke_config
    monkeypatch.setattr(jtrain, "smoke_config",
                        lambda c: jsmoke(c).replace(dtype=jnp.float32))
    monkeypatch.setattr(ttrain, "smoke_config",
                        lambda c: tsmoke(c).replace(dtype=torch.float32))


def test_trainer_three_steps_match_jax_from_the_same_params(
        float32_trainers):
    """JAX's trainer and the port's, 3 steps of the same SyntheticLM
    batches from JAX's seeded init (converted to fp32 masters): the
    losses follow JAX's; the port's log carries the aux loss."""
    jlog = jtrain.main(RUN + ["--steps", "3"])
    cfg = ttrain.smoke_config(get_config(ARCH))
    jp = jlm.init_params(jax.random.PRNGKey(0),
                         jtrain.smoke_config(jax_get_config(ARCH)))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu", trainable=True)
    got = ttrain.train(cfg, ttrain.parse_args(
        RUN + ["--steps", "3", "--device", "cpu"]), params=params)
    assert [m["step"] for m in got["log"]] == [0, 1, 2]
    np.testing.assert_allclose([m["loss"] for m in got["log"]],
                               [m["loss"] for m in jlog], rtol=1e-5)
    assert all(m["aux"] > 0 for m in got["log"])


def _step_dir(src, step, dst):
    os.makedirs(dst, exist_ok=True)
    name = f"step_{step:08d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return str(dst)


def test_port_resumes_a_jax_moe_checkpoint(tmp_path, float32_trainers):
    """JAX trains olmoe-smoke 4 steps, checkpointing every 2; the port
    resumes step 2's checkpoint (the stacked (L, E, ...) expert leaves,
    the router and their AdamW moments) and runs steps 2 and 3 on the
    same data: their losses follow JAX's run, and the port's step-4
    checkpoint has JAX's keys, shapes and dtypes."""
    jdir = str(tmp_path / "jax")
    jlog = jtrain.main(RUN + ["--steps", "4", "--ckpt-dir", jdir,
                              "--ckpt-every", "2"])
    pdir = _step_dir(jdir, 2, tmp_path / "port")
    plog = ttrain.main(RUN + ["--steps", "4", "--ckpt-dir", pdir,
                              "--resume", "--device", "cpu"])
    assert [m["step"] for m in plog] == [2, 3]
    np.testing.assert_allclose([m["loss"] for m in plog],
                               [m["loss"] for m in jlog[2:]], rtol=1e-5)
    flat, manifest = Checkpointer(pdir).read()
    with np.load(os.path.join(jdir, "step_00000004", "shard_0.npz")) as z:
        assert set(flat) == set(z.files)
        assert any("moe" in k and "wg" in k for k in z.files)
        for k in z.files:
            assert tuple(flat[k].shape) == z[k].shape, k
            assert str(flat[k].dtype).split(".")[-1] == str(z[k].dtype), k
    assert manifest["extra"]["next_step"] == 4


def test_moe_training_over_ranks_raises_before_allocating(monkeypatch):
    """``--tp W > 1`` with attn_moe raises NotImplementedError naming the
    ROADMAP item, before any parameter is drawn; sharding an MoE model
    raises too, while serving replicates it."""
    drawn = []
    monkeypatch.setattr(tlm, "init_params",
                        lambda *a, **k: drawn.append(1))
    for tp in ("2", "4"):
        with pytest.raises(NotImplementedError, match="11b"):
            ttrain.main(RUN + ["--steps", "1", "--device", "cpu", "--tp",
                               tp])
    assert not drawn
    monkeypatch.undo()
    _, tc = _cfgs()
    params = tlm.init_params(tc, seed=0, device="cpu", trainable=True)
    mesh = make_mesh(2, device="cpu")
    with pytest.raises(NotImplementedError, match="expert"):
        tlm.shard_params(params, mesh)
    assert len(tlm.replicate(params, mesh)) == 1    # one distinct device


def test_train_cli_cpu_smoke_moe(capsys):
    log = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "16",
                       "--log-every", "1"])
    assert [m["step"] for m in log] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) and m["aux"] > 0 for m in log)
    assert " aux " in capsys.readouterr().out
