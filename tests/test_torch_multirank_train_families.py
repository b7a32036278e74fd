"""Training over W ranks for the MoE and recurrent families: the port's
olmoe-smoke (experts over the ranks), mixtral-smoke (every expert, its
``expert_mlp`` columns over the ranks: the config's overrides),
zamba2-smoke (Mamba2 + the shared attention block) and rwkv6-smoke
(the replicated time mix, the channel mix at the paper's sites) against
the JAX package's W = 2 step on the same numpy inputs and against the
port at W = 1; the sharding rules against JAX's for these configs; the
expert-parallel layer where the experts degrade to replication; then
the port alone: an elastic checkpoint across W and the trainer's CLI.

The JAX half runs in one subprocess, this file's ``__main__`` block, on
2 fake CPU devices (set before JAX starts), on meshes whose axes are
``AxisType.Auto`` and at float32 compute (the Explicit-mesh and bf16
reference defects of ROADMAP queue 3), as in
``test_torch_multirank_train.py``. It also computes each family at W =
1: where its W = 2 step raises, the port is held against that (GSPMD
computes the unsharded function) and the failure is printed.

Tolerances (``test_torch_multirank_train.py``'s, with its reasons): the
loss within 1e-5 relative; every gradient leaf (sharded leaves' blocks
joined, replicated leaves' copies summed) within 1e-3 of its largest
|entry| of the port's at W = 1, and of JAX's at W = 2 within 1e-3
plus JAX's own gap between its W = 2 and W = 1 gradients (the bf16
logits' rounding moves with W in JAX too); two AdamW steps against the
port at W = 1: losses 1e-5 relative, the first grad norm 1e-3, the
second and every parameter leaf (1e-2 of the norm of its two-step
update) within the larger of those and 2 x their own move under one
ulp of weight noise (the test says why); the
elastic checkpoint: losses 1e-5, every leaf within 2e-2 of the norm of
its six-step update; the CLI (bf16 smoke): the first loss within 2e-3
relative of ``--tp 1`` (bf16 partial sums round at other places).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np

ARCHS = ("olmoe-1b-7b", "mixtral-8x22b", "zamba2-1.2b", "rwkv6-3b")
JAX_W = 2
TRAIN_B, TRAIN_S = 2, 32
LR = 1e-3


def train_batch(vocab):
    r = np.random.default_rng(0)
    tokens = r.integers(0, vocab, size=(TRAIN_B, TRAIN_S)).astype(np.int32)
    labels = r.integers(0, vocab, size=(TRAIN_B, TRAIN_S)).astype(np.int32)
    labels[0, :3] = -100                   # ignored positions
    return tokens, labels


def _oracle(path):
    """The JAX half: every family's parameters, and its loss and
    gradients at W = 1 and W = 2 (or the W = 2 step's error)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import get_config, smoke_config
    from repro.distributed import context as dctx
    from repro.distributed.sharding_rules import Rules
    from repro.launch import steps
    from repro.models import lm
    from test_torch_recurrent_engine import nonzero_inits

    def keyed(prefix, tree):
        return {prefix + ".".join(str(x.key) for x in k): np.asarray(v)
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    out = {}
    for arch in ARCHS:
        cfg = smoke_config(get_config(arch)).replace(dtype=jnp.float32)
        params = jax.tree.map(jnp.asarray, nonzero_inits(jax.tree.map(
            np.asarray, lm.init_params(jax.random.PRNGKey(0), cfg))))
        out.update(keyed(f"{arch}/p/", params))
        tokens, labels = train_batch(cfg.vocab_size)
        batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}

        def grad_fn(p, cfg=cfg, batch=batch):
            return jax.jit(jax.value_and_grad(
                lambda p: lm.loss_fn(p, batch, cfg), has_aux=True))(p)
        (loss, _), grads = grad_fn(params)
        out[f"{arch}/1/loss"] = np.asarray(loss)
        out.update(keyed(f"{arch}/1/g/", grads))
        mesh = jax.make_mesh((1, JAX_W), ("data", "model"),
                             devices=jax.devices()[:JAX_W],
                             axis_types=(AxisType.Auto,) * 2)
        rules = Rules(mesh)
        try:
            ctx = dctx.make_context(mesh, fusion_mode="ring", rules=rules)
            with dctx.use(ctx), mesh:
                (loss, _), grads = grad_fn(jax.device_put(
                    params, steps.param_shardings(cfg, rules)))
            out[f"{arch}/{JAX_W}/loss"] = np.asarray(loss)
            out.update(keyed(f"{arch}/{JAX_W}/g/", grads))
        except Exception as e:                 # a reference defect
            print(f"JAX W={JAX_W} step of {arch} failed: {e!r}",
                  flush=True)
            out[f"{arch}/{JAX_W}/error"] = np.array(repr(e))
    np.savez(path, **out)


if __name__ == "__main__":
    _oracle(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------------ the port
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.distributed import sharding_rules as jsr  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.distributed import sharding_rules as tsr  # noqa: E402
from repro_torch.distributed.context import (DistContext, Mesh,  # noqa: E402
                                             use)
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.module import tree_items, tree_map  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from test_torch_recurrent_engine import nonzero_inits  # noqa: E402

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
CASES = [(W, "ring") for W in (2, 4)] + [(2, m) for m in
                                          ("auto", "bsp", "pallas")]


@pytest.fixture(scope="module", autouse=True)
def oracle_run(tmp_path_factory):
    """Starts the JAX half when the module's first test starts, so the
    port-only tests run while it computes."""
    out = tmp_path_factory.mktemp("oracle") / "families.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={JAX_W}")
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


def _t(x):
    return torch.from_numpy(np.array(x))


def _mesh(W):
    return Mesh(["cpu"] * W)


def _cfg(arch, **kw):
    return smoke_config(get_config(arch)).replace(dtype=torch.float32, **kw)


def _leaf_close(got, want, frac, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= frac * scale, f"{what}: max err {err:.3e} > {frac} x " \
                                f"{scale:.3e}"


def _tree(flat, prefix):
    tree: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _batch(vocab=512):
    tokens, labels = train_batch(vocab)
    return {"tokens": _t(tokens), "labels": _t(labels)}


def _global_grads(ps, mesh):
    """Every global leaf's gradient: sharded blocks joined, replicated
    copies summed."""
    dims = tlm.shard_dims(ps[0].cfg, mesh)
    grads = [dict(p.named_parameters()) for p in ps]
    return {n: (sum(g[n].grad for g in grads) if d is None else
                torch.cat([g[n].grad for g in grads], dim=d)).numpy()
            for n, d in dims.items()}


@functools.lru_cache(maxsize=None)
def _flat(arch):
    """JAX's float32 smoke parameters of ``arch`` (numpy; the zero inits
    that would hide a path seeded nonzero), keyed as the JAX half writes
    them. Drawn here too, so the port's tests need not wait for the JAX
    half, which checks that it drew the same numbers."""
    jc = jax_smoke(jax_get_config(arch)).replace(dtype=jnp.float32)
    tree = nonzero_inits(jax.tree.map(np.asarray, jlm.init_params(
        jax.random.PRNGKey(0), jc)))
    return {f"{arch}/p/{k}": v for k, v in tree_items(tree)}


def _params(flat, arch, W=1):
    """The parameters of ``flat`` in the port: one trainable LM, or its
    per-rank shards over W CPU ranks."""
    return params_from_numpy(_tree(flat, f"{arch}/p/"), _cfg(arch),
                             device="cpu", trainable=True,
                             mesh=_mesh(W) if W > 1 else None)


@pytest.fixture(scope="module")
def one_rank():
    """The port at W = 1 on JAX's parameters, each family: (loss,
    gradients)."""
    out = {}
    for arch in ARCHS:
        p = _params(_flat(arch), arch)
        loss, _ = tlm.loss_fn(p, _batch(), _cfg(arch))
        loss.backward()
        out[arch] = (loss.item(), {n: t.grad.numpy()
                                   for n, t in p.named_parameters()})
    return out


def _ranks_loss(arch, W, mode):
    mesh = _mesh(W)
    ps = _params(_flat(arch), arch, W)
    assert len(ps) == W
    with use(DistContext(mesh, mode)):
        loss, metrics = tlm.loss_fn(ps, _batch(), _cfg(arch))
        loss.backward()
    return loss.item(), metrics, _global_grads(ps, mesh)


# ---------------------------------------------------------------- rules
class _FakeMesh:
    """What both packages' rules read of a mesh: its axis sizes."""

    def __init__(self, W):
        self.shape = {"data": 1, "model": W}
        self.size = W


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("W", [2, 4, 64])
def test_shard_dims_match_jax_specs_and_degradations(arch, smoke, W):
    """``lm.shard_dims`` against JAX's ``Rules.spec_for`` leaf by leaf
    (the ``experts``, ``expert_mlp`` and ``ssm_inner`` leaves among
    them) and the recorded degradations: at W = 64 olmoe's 64 experts
    still split, the smoke models' 8 degrade to replication, zamba2's
    fused in_proj width (548 at the smoke size, 8384 at full width)
    replicates where it does not divide."""
    jc, tc = jax_get_config(arch), get_config(arch)
    if smoke:
        jc, tc = jax_smoke(jc), smoke_config(tc)
    jr = jsr.rules_for(jc, _FakeMesh(W))
    want = {}
    for path, p in tree_items(jlm.lm_spec(jc)):
        spec = tuple(jr.spec_for(p.axes, p.shape, path))
        want[path] = next((i for i, s in enumerate(spec) if s is not None),
                          None)
        assert all(s in (None, "model") for s in spec), (path, spec)
    tr = tsr.rules_for(tc, _FakeMesh(W))
    assert tsr.shard_dims(tlm.lm_spec(tc), tr) == want
    assert tr.degradations == jr.degradations
    layers = "backbone.layers."         # stacked: dim 0 is the layer
    if arch == "olmoe-1b-7b":
        assert want[layers + "moe.wg"] == (1 if W <= tc.moe_num_experts
                                           else None)
    if arch == "mixtral-8x22b":
        assert (want[layers + "moe.wg"], want[layers + "moe.wd"]) == (3, 2)
    if arch == "zamba2-1.2b":
        N = tc.ssm_expand * tc.d_model * 2 + 2 * tc.ssm_state + \
            tc.ssm_expand * tc.d_model // 64
        assert want[layers + "mamba.in_proj"] == (2 if N % W == 0
                                                  else None)


# ------------------------------------------------- the expert-parallel layer
@pytest.mark.parametrize("arch,W,S", [("olmoe-1b-7b", 3, 33),
                                      ("olmoe-1b-7b", 2, 15),
                                      ("mixtral-8x22b", 4, 18)])
def test_moe_layer_over_ranks_equals_one_rank(arch, W, S):
    """``moe.apply_moe_ranks`` against ``apply_moe``, forward and
    gradients: E = 8 over W = 3 (the recorded degradation: every expert
    on every rank) with a sequence that does not divide by W, and
    sequences that do not divide by W with split experts (olmoe) or
    split expert columns (mixtral: every row on every rank, the partial
    combines all-reduced in fp32). 1e-5 of each leaf's largest |entry|
    (the same fp32 products summed in another order)."""
    cfg = _cfg(arch)
    mesh = _mesh(W)
    spec = tmoe.moe_spec(cfg)
    rules = tsr.rules_for(cfg, mesh)
    r = np.random.default_rng(W + S)
    p = {k: _t((r.normal(size=v.shape) / np.sqrt(v.shape[-2]))
               .astype(np.float32)) for k, v in spec.items()}
    x = _t(r.normal(size=(2, S, cfg.d_model)).astype(np.float32))
    dy = _t(r.normal(size=(2, S, cfg.d_model)).astype(np.float32))
    p1 = {k: v.clone().requires_grad_() for k, v in p.items()}
    x1 = x.clone().requires_grad_()
    y1, aux1 = tmoe.apply_moe(p1, x1, cfg)
    ((y1 * dy).sum() + aux1).backward()
    pr = [{k: v.requires_grad_() for k, v in t.items()}
          for t in tsr.shard_tree(p, spec, rules)]
    dims = tsr.shard_dims(spec, rules)
    if arch.startswith("olmoe"):
        assert dims["wg"] == (0 if 8 % W == 0 else None)
    xr = [x.clone().requires_grad_() for _ in range(W)]
    with use(DistContext(mesh, "ring")):
        y, stats = tmoe.apply_moe_ranks(pr, xr, cfg, seq_sharded=False)
        aux = tmoe.switch_aux(*stats)
    for yr in y:
        np.testing.assert_allclose(yr.detach().numpy(), y1.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert aux.item() == aux1.item()
    (sum((yr * dy).sum() / W for yr in y) + aux).backward()
    _leaf_close(sum(t.grad for t in xr), x1.grad, 1e-5, "dx")
    for k, d in dims.items():
        gs = [t[k].grad for t in pr]
        got = sum(gs) if d is None else torch.cat(gs, dim=d)
        _leaf_close(got, p1[k].grad, 1e-5, f"d{k}")


# ------------------------------------------------------------ the trainer
def _run(arch):
    return ["--arch", arch, "--smoke", "--batch", "2", "--seq", "32",
            "--log-every", "1", "--device", "cpu", "--warmup", "8"]


def _only_step(src, step, dst):
    import shutil
    name = f"step_{step:08d}"
    os.makedirs(dst, exist_ok=True)
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return str(dst)


def test_elastic_checkpoint_zamba2_two_one_four(tmp_path):
    """float32 zamba2-smoke (its zero-init dt_bias and conv_b seeded
    nonzero): 6 steps at W = 2 against 2 steps at W = 2, 2 more resumed
    at W = 1 and the last 2 resumed at W = 4 (the in_proj's column
    blocks and out_proj's row blocks re-cut at each W); the checkpoint
    holds the global arrays."""
    cfg = _cfg("zamba2-1.2b")
    tree = nonzero_inits(tree_map(lambda _, t: t.detach().numpy(),
                                  tlm.param_tree(tlm.init_params(
                                      cfg, seed=0, device="cpu"))))

    def train(argv):
        return ttrain.train(cfg, ttrain.parse_args(_run("zamba2-1.2b")
                                                   + argv),
                            params=params_from_numpy(tree, cfg,
                                                     device="cpu",
                                                     trainable=True))
    full = train(["--steps", "6", "--tp", "2", "--fusion-mode", "ring"])
    d = str(tmp_path / "ck")
    train(["--steps", "2", "--tp", "2", "--fusion-mode", "ring",
           "--ckpt-dir", d, "--ckpt-every", "2"])
    b = train(["--steps", "4", "--tp", "1", "--ckpt-dir", d, "--resume"])
    c = train(["--steps", "6", "--tp", "4", "--fusion-mode", "bsp",
               "--ckpt-dir", d, "--resume"])
    assert (b["start_step"], c["start_step"]) == (2, 4)
    np.testing.assert_allclose([m["loss"] for m in b["log"] + c["log"]],
                               [m["loss"] for m in full["log"][2:]],
                               rtol=1e-5)
    got = tlm.gather_params(c["params"], _mesh(4))
    want = tlm.gather_params(full["params"], _mesh(2))
    init = dict(tree_items(tree))
    for (n, x), (_, y) in zip(got.named_parameters(),
                              want.named_parameters()):
        x, y = x.detach().numpy(), y.detach().numpy()
        rel = np.linalg.norm(x - y) / np.linalg.norm(y - init[n])
        assert rel <= 2e-2, f"{n}: {rel:.3e} of the update"
    flat, _ = Checkpointer(d).read()
    assert tuple(flat["params%%backbone%%layers%%mamba%%in_proj"].shape) \
        == (5, 128, 548)
    assert tuple(flat["opt%%v%%backbone%%layers%%mamba%%out_proj"].shape) \
        == (5, 256, 128)


def test_cli_tp2_olmoe(capsys):
    """``launch.train --arch olmoe-1b-7b --smoke --device cpu --tp 2``
    (the bf16 smoke the CLI builds): finite losses with their aux, the
    first within 2e-3 of ``--tp 1``'s."""
    argv = _run("olmoe-1b-7b") + ["--steps", "2"]
    tp2 = ttrain.main(argv + ["--tp", "2"])
    assert " aux " in capsys.readouterr().out
    tp1 = ttrain.main(argv)
    assert [m["step"] for m in tp2] == [0, 1]
    assert all(np.isfinite(m["loss"]) and m["aux"] > 0 for m in tp2)
    np.testing.assert_allclose(tp2[0]["loss"], tp1[0]["loss"], rtol=2e-3)


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("W,mode", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_over_ranks_equals_one_rank(one_rank, arch, W, mode):
    loss, metrics, got = _ranks_loss(arch, W, mode)
    np.testing.assert_allclose(loss, one_rank[arch][0], rtol=1e-5)
    for n, g in got.items():
        _leaf_close(g, one_rank[arch][1][n], 1e-3, f"{n} vs W=1")


def _two_steps(arch, W, noise=None):
    """Two AdamW steps at W ranks from JAX's parameters (each entry
    scaled by 1 + one float32 ulp of noise drawn from ``noise``, a
    seed): (the parameters after them, gathered; the steps' metrics)."""
    mesh = _mesh(W) if W > 1 else None
    flat = dict(_flat(arch))
    if noise is not None:
        r = np.random.default_rng(noise)
        for k in flat:
            if k.startswith(f"{arch}/p/"):
                flat[k] = (flat[k] * (1 + (r.random(flat[k].shape) - 0.5)
                                      * 2 ** -23)).astype(np.float32)
    ps = _params(flat, arch, W)
    opt = tsteps.init_opt_state(ps)
    step = tsteps.make_train_step(_cfg(arch), tadamw.AdamWConfig(lr=LR))
    ms = []
    with use(DistContext(mesh, "ring")):
        for _ in range(2):
            ps, opt, m = step(ps, opt, _batch())
            ms.append({k: v.item() for k, v in m.items()})
    return (tlm.gather_params(ps, mesh) if W > 1 else ps), ms


@pytest.mark.parametrize("arch", ARCHS)
def test_two_adamw_steps_equal_one_rank(arch):
    """Two AdamW steps at W = 2 against W = 1: the first step's loss
    1e-5 and grad norm 1e-3; the second step's loss 1e-5, its grad norm
    and every parameter leaf (1e-2 of the norm of its two-step update)
    within the larger of those and 2 x what one float32 ulp of noise on
    the initial weights moves them at W = 1 (3 draws). AdamW's first
    update is lr x sign(g) entry by entry, so an entry whose gradient is
    ~0 moves by +-lr on a rounding; the smoke MoE then lands at another
    point of a steep loss (grad norms 150-660): its ulp noise moves the
    second grad norm by 1.2e-2 to 0.5 and the leaves by up to 0.2 of
    their update, where W = 2 moves them 1.3e-2 and 8e-3; zamba2's and
    rwkv's noise stays under the fixed bounds."""
    got, ms = _two_steps(arch, 2)
    want, one = _two_steps(arch, 1)
    init = dict(tree_items(_tree(_flat(arch), f"{arch}/p/")))
    w1 = {n: t.detach().numpy() for n, t in want.named_parameters()}

    def gaps(params, metrics):
        leaf = max(np.linalg.norm(t.detach().numpy() - w1[n])
                   / np.linalg.norm(w1[n] - init[n])
                   for n, t in params.named_parameters())
        return abs(metrics[1]["grad_norm"] / one[1]["grad_norm"] - 1), leaf
    noise = [gaps(*_two_steps(arch, 1, noise=seed)) for seed in range(3)]
    gn_tol = max(1e-3, 2 * max(g for g, _ in noise))
    leaf_tol = max(1e-2, 2 * max(x for _, x in noise))
    for m, m1 in zip(ms, one):
        np.testing.assert_allclose(m["loss"], m1["loss"], rtol=1e-5)
    np.testing.assert_allclose(ms[0]["grad_norm"], one[0]["grad_norm"],
                               rtol=1e-3)
    gn, leaf = gaps(got, ms)
    assert gn <= gn_tol, f"second grad norm {gn:.3e} from W = 1 ({gn_tol})"
    assert leaf <= leaf_tol, f"a leaf {leaf:.3e} of its update ({leaf_tol})"
    for n, t in want.named_parameters():
        assert np.linalg.norm(t.detach().numpy() - init[n]) > 0, n


def _jax_gap(jx, arch, names):
    """JAX's own largest leaf gap between its W = 2 and W = 1 gradients
    (each leaf's max |difference| over its largest |entry|)."""
    return max(np.abs(jx[f"{arch}/{JAX_W}/g/{n}"] - jx[f"{arch}/1/g/{n}"])
               .max() / np.abs(jx[f"{arch}/1/g/{n}"]).max() for n in names)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_match_jax_at_two_ranks(jx, one_rank, arch):
    """The port at W = 2 under ``ring`` against JAX's W = 2 step (JAX's
    W = 1 where that step raised) and the port at W = 1. Against JAX at
    W = 2 each leaf is held within 1e-3 plus JAX's own W = 2 vs W = 1
    gap (the bf16 logits round differently in JAX's two runs too:
    mixtral-smoke's gap is 5.5e-4, the port's W = 1 vs JAX's W = 1
    7.2e-4, so the port lands 1.0e-3 from JAX's W = 2 whatever its own
    W)."""
    for k, v in _flat(arch).items():
        np.testing.assert_array_equal(jx[k], v)
    loss, metrics, got = _ranks_loss(arch, JAX_W, "ring")
    ref = JAX_W if f"{arch}/{JAX_W}/loss" in jx else 1
    if ref == 1:
        print(f"{arch}: JAX's W = {JAX_W} step raised "
              f"{jx[f'{arch}/{JAX_W}/error']}; held against W = 1")
    np.testing.assert_allclose(loss, float(jx[f"{arch}/{ref}/loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(loss, one_rank[arch][0], rtol=1e-5)
    assert set(got) == set(one_rank[arch][1])
    tol = 1e-3 + (_jax_gap(jx, arch, got) if ref == JAX_W else 0.0)
    for n, g in got.items():
        _leaf_close(g, jx[f"{arch}/{ref}/g/{n}"], tol, f"{n} vs JAX")
        _leaf_close(g, one_rank[arch][1][n], 1e-3, f"{n} vs W=1")
    if arch.startswith(("olmoe", "mixtral")):
        assert metrics["aux"].item() > 0
