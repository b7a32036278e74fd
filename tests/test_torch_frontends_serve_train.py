"""The vlm and audio frontends through the port's entry points, on the
CPU: paligemma-smoke served by the engine (greedy at K = 1, seeded
temperature at K = 4) token-identical to the JAX engine; hubert refused
by ``launch.serve``, ``launch.server`` and ``Engine`` with JAX's
message; the trainers (paligemma text-only from the CLI against JAX's
trainer; hubert's CLI exit where JAX stops with ``KeyError: 'frames'``;
both models through ``steps.make_train_step`` on batches with patches
or frames, against JAX's loss and AdamW); and the loss and every
gradient at tp 2 against tp 1 (paligemma's vocab-row-sharded input
table, its patch rows split across the ranks, a sequence that does not
divide by W), and at tp 2 against the JAX package's own W = 2 run: its
``__main__`` block, started in a subprocess with the module's first
test, computes the loss and every gradient on 2 fake CPU devices whose
mesh axes are ``AxisType.Auto`` (jax 0.9's default Explicit axes refuse
the train step's sharding constraints; ROADMAP queue 3).

Tolerances: streams token-identical and counters equal (float32
configs, JAX's parameters converted); trainer and train-step losses
within 1e-5 relative at the first step and grad norms within 1e-3; after
an AdamW step losses 1e-3 and grad norms 2e-2 (its normalised update
moves entries whose gradient is near eps by what their rounding error
sets, ``tests/test_torch_multirank_train.py``: paligemma-smoke's second
grad norm moves by more than 1e-3 here); tp 2 against tp 1: the loss
1e-5 relative,
every gradient leaf within 1e-3 of its largest |entry|
(``tests/test_torch_multirank_train.py``).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np

ORACLE_ARCHS = ("paligemma-3b", "hubert-xlarge")
ORACLE_S = 24


def _oracle(path):
    """The JAX half: loss and gradients at W = 2 under ``bsp`` for each
    float32 smoke model from ``PRNGKey(0)``, on the port's seeded batch
    (``steps.synthetic_batch(seed=5)``), written to ``path``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import get_config, smoke_config
    from repro.distributed import context as dctx
    from repro.distributed.sharding_rules import rules_for
    from repro.launch import steps
    from repro.models import lm
    from repro_torch.configs import get_config as tget
    from repro_torch.configs import smoke_config as tsmoke
    from repro_torch.launch.steps import synthetic_batch

    mesh = jax.make_mesh((1, 2), ("data", "model"),
                         devices=jax.devices()[:2],
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch in ORACLE_ARCHS:
        cfg = smoke_config(get_config(arch)).replace(dtype=jnp.float32)
        params = lm.init_params(jax.random.PRNGKey(0), cfg)
        batch = {k: jnp.asarray(v.numpy()) for k, v in synthetic_batch(
            tsmoke(tget(arch)), 2, ORACLE_S, seed=5).items()}
        rules = rules_for(cfg, mesh)
        with dctx.use(dctx.make_context(mesh, fusion_mode="bsp",
                                        rules=rules)), mesh:
            p = jax.device_put(params, steps.param_shardings(cfg, rules))
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p: lm.loss_fn(p, batch, cfg), has_aux=True))(p)
        out[f"{arch}/loss"] = np.asarray(loss)
        for k, v in jax.tree_util.tree_flatten_with_path(grads)[0]:
            out[f"{arch}/g/" + ".".join(str(x.key) for x in k)] = \
                np.asarray(v)
    np.savez(path, **out)


if __name__ == "__main__":
    _oracle(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------------ the port
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.distributed.context import (DistContext, Mesh,  # noqa: E402
                                             use)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import server as tserver  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def oracle_run(tmp_path_factory):
    """Starts the JAX half when the module's first test starts, so the
    other tests run while it computes."""
    out = tmp_path_factory.mktemp("oracle") / "frontends.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.Popen([sys.executable, __file__, str(out)], env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jx(oracle_run):
    proc, out = oracle_run
    assert proc.wait(timeout=600) == 0, "the JAX half failed"
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _cfgs(arch):
    return (jax_smoke(jax_get_config(arch)).replace(dtype=jnp.float32),
            smoke_config(get_config(arch)).replace(dtype=torch.float32))


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX params, port config, numpy tree) per arch."""
    out = {}
    for arch in ("paligemma-3b", "hubert-xlarge"):
        jc, tc = _cfgs(arch)
        jp = jlm.init_params(jax.random.PRNGKey(0), jc)
        out[arch] = (jc, jp, tc, jax.tree.map(np.asarray, jp))
    return out


# ----------------------------------------------------------------- serve
_PROMPTS = [[int(t) for t in np.random.default_rng(s).integers(1, 512, n)]
            for s, n in enumerate((5, 9, 3, 12))]


def _drive(eng, req_cls):
    for rid, prompt in enumerate(_PROMPTS):
        eng.submit(req_cls(rid=rid, prompt=list(prompt), max_new_tokens=6,
                           temp=0.8), at_tick=rid)
    done = eng.run()
    return ({r.rid: list(r.out_tokens) for r in done},
            (eng.tick_count, eng.dispatch_count, eng.mixed_dispatch_count,
             eng.decode_token_count, eng.preempt_count))


@pytest.mark.parametrize("K,sampler", [(1, "greedy"), (4, "temperature")])
def test_paligemma_engine_matches_jax(models, K, sampler):
    """paligemma-smoke serves text (its decode is the text decoder's, as
    in JAX): the port's engine and JAX's, staggered arrivals, a
    megatick, token-identical streams and equal counters."""
    jc, jp, tc, tree = models["paligemma-3b"]
    kw = dict(batch=2, max_len=64, prefill_chunk=4, block_size=8,
              decode_steps=K, sampler=sampler, seed=3)
    want, jcount = _drive(JEngine(jp, jc, **kw), JRequest)
    got, tcount = _drive(Engine(params_from_numpy(tree, tc, device="cpu"),
                                tc, device="cpu", **kw), Request)
    assert len(got) == len(_PROMPTS)
    assert got == want
    assert tcount == jcount


def test_hubert_is_refused_by_serve_server_and_engine(models):
    """An encoder has no decode step: both CLIs exit with JAX's message
    before building anything, and ``Engine`` raises."""
    argv = ["--arch", "hubert-xlarge", "--smoke"]
    with pytest.raises(SystemExit) as want:
        jserve.main(argv)
    for main in (tserve.main, tserver.main):
        with pytest.raises(SystemExit) as got:
            main(argv + ["--device", "cpu"])
        assert str(got.value) == str(want.value)
    assert "encoder-only" in str(want.value)
    _, _, tc, tree = models["hubert-xlarge"]
    with pytest.raises(ValueError, match="encoder-only"):
        Engine(params_from_numpy(tree, tc, device="cpu"), tc, device="cpu")


# ----------------------------------------------------------------- train
@pytest.fixture
def float32_trainers(monkeypatch):
    """Both packages' trainers build the smoke config at float32
    compute."""
    jsmoke, tsmoke = jtrain.smoke_config, ttrain.smoke_config
    monkeypatch.setattr(jtrain, "smoke_config",
                        lambda c: jsmoke(c).replace(dtype=jnp.float32))
    monkeypatch.setattr(ttrain, "smoke_config",
                        lambda c: tsmoke(c).replace(dtype=torch.float32))


def _run(arch):
    return ["--arch", arch, "--smoke", "--batch", "2", "--seq", "16",
            "--log-every", "1", "--steps", "2"]


def test_paligemma_trainer_matches_jax(float32_trainers):
    """The CLI trainer on SyntheticLM text (no patches, as JAX's): 2
    steps from JAX's init, the losses as JAX's trainer's."""
    jlog = jtrain.main(_run("paligemma-3b"))
    cfg = ttrain.smoke_config(get_config("paligemma-3b"))
    jp = jlm.init_params(jax.random.PRNGKey(0),
                         jtrain.smoke_config(jax_get_config("paligemma-3b")))
    got = ttrain.train(cfg, ttrain.parse_args(
        _run("paligemma-3b") + ["--device", "cpu"]),
        params=params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                 device="cpu", trainable=True))
    losses = [m["loss"] for m in got["log"]]
    want = [m["loss"] for m in jlog]
    np.testing.assert_allclose(losses[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(losses, want, rtol=1e-3)


def test_hubert_trainer_exits_naming_the_frame_stream(monkeypatch):
    """JAX's CLI trainer cannot train hubert (its data has no "frames":
    ``KeyError``); the port's exits first with a message naming the
    stream, before any parameter is drawn."""
    with pytest.raises(KeyError, match="frames"):
        jtrain.main(_run("hubert-xlarge"))
    monkeypatch.setattr(tlm, "init_params", lambda *a, **k: 1 / 0)
    with pytest.raises(SystemExit, match="'frames'"):
        ttrain.main(_run("hubert-xlarge") + ["--device", "cpu"])


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge"])
def test_synthetic_batch_has_jax_input_specs(arch):
    """``steps.synthetic_batch`` holds the keys and shapes of JAX's
    ``input_specs`` for a training cell."""
    jc, tc = _cfgs(arch)
    want = jsteps.input_specs(jc, ShapeConfig("t", 16, 2, "train"))
    got = tsteps.synthetic_batch(tc, 2, 16)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge"])
def test_train_step_on_frontend_batches_matches_jax(models, arch):
    """``steps.make_train_step`` on a batch with patches (paligemma) or
    frames (hubert), two steps, against JAX's ``loss_fn`` gradients and
    ``adamw.apply_updates`` on the same batches: losses and grad norms.
    hubert's unread input table takes JAX's zero gradient and decays."""
    jc, jp, tc, tree = models[arch]
    cfg = tadamw.AdamWConfig(lr=1e-3)
    params = params_from_numpy(tree, tc, device="cpu", trainable=True)
    step = tsteps.make_train_step(tc, cfg)
    opt = tsteps.init_opt_state(params)
    jcfg = jadamw.AdamWConfig(lr=1e-3)

    @jax.jit
    def jstep(p, o, b):
        (loss, _), g = jax.value_and_grad(jlm.loss_fn, has_aux=True)(p, b,
                                                                     jc)
        p, o, met = jadamw.apply_updates(p, g, o, jcfg)
        return p, o, loss, met["grad_norm"]
    jo = jadamw.init_state(jp)
    table0 = params["embed"]["table"].detach().clone()
    for i in range(2):
        batch = tsteps.synthetic_batch(tc, 2, 16, seed=i)
        params, opt, met = step(params, opt, batch)
        jp, jo, jl, jg = jstep(jp, jo, {k: jnp.asarray(v.numpy())
                                        for k, v in batch.items()})
        np.testing.assert_allclose(met["loss"].item(), float(jl),
                                   rtol=1e-5 if i == 0 else 1e-3)
        np.testing.assert_allclose(met["grad_norm"].item(), float(jg),
                                   rtol=1e-3 if i == 0 else 2e-2)
    if arch == "hubert-xlarge":
        assert params["embed"]["table"].grad is None
        np.testing.assert_allclose(
            params["embed"]["table"].detach().numpy(),
            np.asarray(jp["embed"]["table"]), rtol=1e-6, atol=0)
        assert not torch.equal(params["embed"]["table"].detach(), table0)


# ------------------------------------------------------------- W ranks
def _global_grads(ps, mesh):
    """The gradient of every global leaf: sharded leaves' blocks joined,
    replicated leaves' per-rank copies summed (None: no gradient)."""
    dims = tlm.shard_dims(ps[0].cfg, mesh)
    grads = [dict(p.named_parameters()) for p in ps]
    out = {}
    for n, d in dims.items():
        gs = [g[n].grad for g in grads]
        if gs[0] is None:
            assert all(x is None for x in gs), n
            out[n] = None
        else:
            out[n] = (sum(gs) if d is None else torch.cat(gs, dim=d)).numpy()
    return out


@pytest.mark.parametrize("arch,S", [("paligemma-3b", 24),
                                    ("paligemma-3b", 23),
                                    ("hubert-xlarge", 24)])
@pytest.mark.parametrize("mode", ["bsp", "ring"])
def test_two_ranks_match_one(models, arch, S, mode):
    """The loss and every gradient at tp 2 against tp 1, float32 smoke,
    a batch with patches or frames: paligemma's vocab-row-sharded input
    table (the masked gather summed over the ranks), its 8 patch rows in
    front of the tokens before the sequence split (8 + 23 rows: every
    row on every rank); hubert's frames, its unread input table with no
    gradient on any rank."""
    _, _, tc, tree = models[arch]
    batch = tsteps.synthetic_batch(tc, 2, S, seed=5)
    one = params_from_numpy(tree, tc, device="cpu", trainable=True)
    l1, _ = tlm.loss_fn(one, batch, tc)
    l1.backward()
    want = {n: None if p.grad is None else p.grad.numpy()
            for n, p in one.named_parameters()}
    mesh = Mesh(["cpu"] * 2)
    ps = params_from_numpy(tree, tc, device="cpu", trainable=True,
                           mesh=mesh)
    if arch == "paligemma-3b":
        assert ps[0]["embed"]["table"].shape[0] == tc.vocab_size // 2
    with use(DistContext(mesh, mode)):
        l2, _ = tlm.loss_fn(ps, batch, tc)
        l2.backward()
    np.testing.assert_allclose(l2.item(), l1.item(), rtol=1e-5)
    got = _global_grads(ps, mesh)
    assert set(got) == set(want)
    for n, g in got.items():
        if want[n] is None:
            assert g is None, n
            continue
        scale = max(np.abs(want[n]).max(), 1e-30)
        assert np.abs(g - want[n]).max() <= 1e-3 * scale, n


@pytest.mark.parametrize("arch", ORACLE_ARCHS)
def test_two_ranks_match_jax_at_two_ranks(models, jx, arch):
    """The port at tp 2 (``bsp``) against the JAX package at W = 2 on the
    same parameters and batch: the loss, and every gradient leaf (zeros
    in JAX where the port has none)."""
    _, _, tc, tree = models[arch]
    mesh = Mesh(["cpu"] * 2)
    ps = params_from_numpy(tree, tc, device="cpu", trainable=True,
                           mesh=mesh)
    with use(DistContext(mesh, "bsp")):
        loss, _ = tlm.loss_fn(ps, tsteps.synthetic_batch(tc, 2, ORACLE_S,
                                                         seed=5), tc)
        loss.backward()
    np.testing.assert_allclose(loss.item(), float(jx[f"{arch}/loss"]),
                               rtol=1e-5)
    for n, g in _global_grads(ps, mesh).items():
        want = jx[f"{arch}/g/{n}"]
        if g is None:
            assert not want.any(), n
            continue
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(g - want).max() <= 1e-3 * scale, n
