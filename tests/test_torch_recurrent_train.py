"""The recurrent families' training path against the JAX package's on the
CPU (zamba2-smoke: 5 Mamba2 layers, 2 shared-block calls and a tail of
1; rwkv6-smoke: 4 blocks and ``ln_in``; float32 compute; the zero inits
of ``dt_bias``, ``conv_b`` and ``w_lora_b`` seeded nonzero on both
sides): the logits, the loss and every gradient leaf against
``jax.value_and_grad`` with and without remat, the trainer's 3-step
curve against JAX's trainer from the same parameters, a JAX checkpoint
resumed, the serving storage dtypes, and ``--tp W > 1`` refused before
anything is allocated.

Tolerances, as ``tests/test_torch_moe_train.py`` states them: logits
within one bf16 ulp (2**-7 relative, 1e-4 absolute); the loss within
1e-5 relative; every gradient leaf within 1e-3 of its largest |entry|
(the logits' gradient is bf16, so an element on a rounding boundary
moves by one bf16 ulp and spreads through the backward's sums); the
trainers' losses within 1e-5 relative.
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
from test_torch_recurrent_engine import nonzero_inits  # noqa: E402

torch.set_num_threads(2)
ARCHS = ("zamba2-1.2b", "rwkv6-3b")


def _t(x):
    return torch.from_numpy(np.array(x))


def _models(arch, **kw):
    jc = jax_smoke(jax_get_config(arch)).replace(dtype=jnp.float32, **kw)
    tc = smoke_config(get_config(arch)).replace(dtype=torch.float32, **kw)
    tree = nonzero_inits(jax.tree.map(np.asarray, jlm.init_params(
        jax.random.PRNGKey(0), jc)))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tc, device="cpu", trainable=True)
    return jc, jp, tc, tp


def _batch(vocab, B=2, S=32, seed=0):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_and_storage_dtypes(arch):
    """The port's spec has JAX's keys and shapes (``shared_attn`` for the
    hybrid, ``ln_in`` for rwkv); a serving model keeps the leaves JAX
    reads as fp32 masters in fp32 and the rest in ``cfg.dtype``."""
    jc = jax_smoke(jax_get_config(arch))
    tc = smoke_config(get_config(arch))
    js = {k: v.shape for k, v in tree_items(jlm.lm_spec(jc))}
    ts = {k: v.shape for k, v in tree_items(tlm.lm_spec(tc))}
    assert ts == js
    assert ("backbone.shared_attn.attn.wq" in ts) == arch.startswith("zamba")
    assert ("ln_in.scale" in ts) == arch.startswith("rwkv")
    params = tlm.init_params(tc, seed=0, device="cpu")
    fp32 = {"A_log", "dt_bias", "D", "norm_scale", "w0", "w_lora_a",
            "w_lora_b", "u", "gn_scale", "scale", "bias"}
    for name, p in params.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        want = torch.float32 if leaf in fp32 or name == "head.table" \
            else tc.dtype
        assert p.dtype == want, name


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    jc, jp, tc, tp = _models(arch, remat=remat)
    tokens, labels = _batch(tc.vocab_size)
    jlog, _ = jlm.forward(jp, {"tokens": jnp.asarray(tokens)}, jc)
    with torch.no_grad():
        tlog, taux = tlm.forward(tp, {"tokens": _t(tokens)}, tc)
    np.testing.assert_allclose(tlog.float().numpy(),
                               np.asarray(jlog.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-4)
    assert taux.item() == 0.0
    (jl, jm), jg = jax.jit(jax.value_and_grad(jlm.loss_fn, has_aux=True),
                           static_argnums=2)(
        jp, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
        jc)
    jg = dict(tree_items(jax.tree.map(np.asarray, jg)))
    tl, tm = tlm.loss_fn(tp, {"tokens": _t(tokens), "labels": _t(labels)},
                         tc)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    got = {n: t.grad for n, t in tp.named_parameters()}
    assert set(got) == set(jg)
    for name, g in got.items():
        assert g is not None and g.dtype == torch.float32, name
        _leaf_close(g.numpy(), jg[name], 1e-3, name)
    nonzero = {n for n, g in got.items() if g.abs().max() > 0}
    assert nonzero == set(got), set(got) - nonzero


# -------------------------------------------------------------- trainer
def _run(arch):
    return ["--arch", arch, "--smoke", "--batch", "2", "--seq", "32",
            "--log-every", "1"]


@pytest.fixture
def float32_trainers(monkeypatch):
    """Both packages' trainers build the smoke config at float32
    compute."""
    jsmoke, tsmoke = jtrain.smoke_config, ttrain.smoke_config
    monkeypatch.setattr(jtrain, "smoke_config",
                        lambda c: jsmoke(c).replace(dtype=jnp.float32))
    monkeypatch.setattr(ttrain, "smoke_config",
                        lambda c: tsmoke(c).replace(dtype=torch.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_three_steps_match_jax(arch, float32_trainers):
    """JAX's trainer and the port's, 3 steps of the same SyntheticLM
    batches from JAX's seeded init converted to fp32 masters."""
    jlog = jtrain.main(_run(arch) + ["--steps", "3"])
    cfg = ttrain.smoke_config(get_config(arch))
    jp = jlm.init_params(jax.random.PRNGKey(0),
                         jtrain.smoke_config(jax_get_config(arch)))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu", trainable=True)
    got = ttrain.train(cfg, ttrain.parse_args(
        _run(arch) + ["--steps", "3", "--device", "cpu"]), params=params)
    assert [m["step"] for m in got["log"]] == [0, 1, 2]
    np.testing.assert_allclose([m["loss"] for m in got["log"]],
                               [m["loss"] for m in jlog], rtol=1e-5)


def _step_dir(src, step, dst):
    os.makedirs(dst, exist_ok=True)
    name = f"step_{step:08d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return str(dst)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_resumes_a_jax_checkpoint(tmp_path, arch, float32_trainers):
    """JAX trains 4 steps, checkpointing every 2; the port resumes step
    2's checkpoint (parameters and AdamW moments) and runs steps 2 and 3
    on the same data: their losses follow JAX's run, and the port's
    step-4 checkpoint has JAX's keys, shapes and dtypes."""
    jdir = str(tmp_path / "jax")
    jlog = jtrain.main(_run(arch) + ["--steps", "4", "--ckpt-dir", jdir,
                                     "--ckpt-every", "2"])
    pdir = _step_dir(jdir, 2, tmp_path / "port")
    plog = ttrain.main(_run(arch) + ["--steps", "4", "--ckpt-dir", pdir,
                                     "--resume", "--device", "cpu"])
    assert [m["step"] for m in plog] == [2, 3]
    np.testing.assert_allclose([m["loss"] for m in plog],
                               [m["loss"] for m in jlog[2:]], rtol=1e-5)
    flat, manifest = Checkpointer(pdir).read()
    with np.load(os.path.join(jdir, "step_00000004", "shard_0.npz")) as z:
        assert set(flat) == set(z.files)
        for k in z.files:
            assert tuple(flat[k].shape) == z[k].shape, k
            assert str(flat[k].dtype).split(".")[-1] == str(z[k].dtype), k
    assert manifest["extra"]["next_step"] == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_training_over_ranks_raises_before_allocating(arch, monkeypatch):
    """``--tp W > 1`` raises NotImplementedError naming ROADMAP item 11f
    before any parameter is drawn; sharding raises too, while serving
    replicates."""
    drawn = []
    monkeypatch.setattr(tlm, "init_params",
                        lambda *a, **k: drawn.append(1))
    for tp in ("2", "4"):
        with pytest.raises(NotImplementedError, match="11f"):
            ttrain.main(_run(arch) + ["--steps", "1", "--device", "cpu",
                                      "--tp", tp])
    assert not drawn
    monkeypatch.undo()
    tc = smoke_config(get_config(arch))
    params = tlm.init_params(tc, seed=0, device="cpu", trainable=True)
    mesh = make_mesh(2, device="cpu")
    with pytest.raises(NotImplementedError, match="11f"):
        tlm.shard_params(params, mesh)
    assert len(tlm.replicate(params, mesh)) == 1    # one distinct device


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_cpu_smoke(arch):
    log = ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "32",
                       "--log-every", "1"])
    assert [m["step"] for m in log] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in log)
