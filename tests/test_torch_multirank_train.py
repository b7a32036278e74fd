"""The port's training path over W ranks against the JAX package's on
the same numpy inputs: the sequence-parallel AG+GEMM (``ag_gemm_m_sharded``),
the GEMM+RS (``gemm_rs``) and the ring all-gather in their three modes,
the sharding rules, and the float32 smoke model's loss, every gradient
leaf and two AdamW steps at W = 2 and 4 in every fusion mode; then the
port alone: elastic checkpoints across W and the trainer's CLI.

The JAX half runs in one subprocess, this file's ``__main__`` block, on
4 fake CPU devices (the fake-device count must be set before JAX
starts), on meshes whose axes are ``AxisType.Auto`` (jax 0.9's default
Explicit axes refuse the train step's sharding constraints). The port's
ranks are W CPU ranks of one mesh.

Tolerances, with their reasons:
* collective matmuls: 2e-4 relative and absolute (float32 sums in
  another order; the tolerance of ``test_torch_multirank_kernels.py``);
  their gradients within 1e-5 of each gradient's largest |entry| of
  autograd through one single-rank product (the ring sums the same
  float32 products in another order);
* the model (float32 smoke, ``smoke_config("llama3-8b")``): the loss
  within 1e-5 relative; every gradient leaf within 1e-3 of its largest
  |entry|, against JAX at the same W and against the port at W = 1 (the
  logits are bf16 in both packages, so an fp32 sum in another order can
  move a logit by one bf16 ulp, 2**-8, and the one-ulp step spreads
  through the backward's sums: ``test_torch_train_model.py``);
* two AdamW steps: against the port at W = 1, losses 1e-5 relative,
  grad norms 1e-3 relative (the gradients above) and every parameter
  leaf within 1e-2 of the norm of its two-step update (measured 2.5e-3
  at most, the embedding table); against JAX, the first step's loss
  1e-5 and grad norm 1e-3, the second step's loss 1e-3 and grad norm
  2e-2, every leaf within 0.3 of the norm of its update (measured 0.13)
  and 4 x the sum of the lrs entry by entry. AdamW's normalised update
  g / (|g| + eps) moves an entry whose clipped gradient is near eps
  (1e-8) by an amount its rounding error sets, so thousands of the
  smoke model's entries (layer weights of std 0.5, many tiny gradients)
  step differently in another summation order, up to ~0.2 x the lr
  each: the port at W = 1 measured 2.7e-4 on the second loss and 1.3%
  on its grad norm from JAX at W = 1. A run that took no step stands at
  1.0 of its update on both norms. On the same gradients the W-rank
  step equals the one-rank step within 1e-6 of each leaf's largest
  |entry| (the global norm sums the shards' squares in another order,
  so the clip factor moves by an ulp);
* replicated copies: bit-equal;
* elastic checkpoints (float32 smoke, W 2 -> 1 -> 4 against W = 2
  uninterrupted): losses 1e-5 relative, every parameter leaf within
  2e-2 of the norm of its six-step update (the same AdamW argument
  across W; measured 5.7e-3 on the embedding table, whose rows the
  batch does not touch barely move, and under 1e-4 on every other
  leaf); the JAX trainer resuming the
  port's W = 2 checkpoint: losses 2e-3 relative (bf16 smoke, as in
  ``test_torch_train_loop.py``);
* the CLI at ``--tp 2`` against ``--tp 1`` (bf16 smoke): losses 2e-3
  relative (bf16 partial sums round at other places over W ranks; JAX's
  own bf16 loss moves ~1e-4 between W = 1 and 2 at the first step).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np

WS = (2, 4)
MODES = ("auto", "bsp", "ring", "pallas")
CM_MODES = ("bsp", "ring", "ring_bidir")
# (leading, M, K, N of the AG+GEMM, N of the GEMM+RS): M/W odd at W = 4
# (the bidirectional ring's halves differ by a row), an odd N for the
# GEMM+RS (its ring_bidir column halves differ by one)
CM_SHAPES = {"a": ((2,), 16, 32, 24, 24), "b": ((1,), 12, 16, 12, 11)}
TRAIN_B, TRAIN_S = 2, 32
LR = 1e-3
ADAM_W = 2                # the two jitted AdamW steps run at this W


def normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def err_a(W):
    return normal(4, (2, 4 * W + 1, 4 * W))


def err_b(W):
    return normal(5, (4 * W, 8))


def train_batch(vocab):
    r = np.random.default_rng(0)
    tokens = r.integers(0, vocab, size=(TRAIN_B, TRAIN_S)).astype(np.int32)
    labels = r.integers(0, vocab, size=(TRAIN_B, TRAIN_S)).astype(np.int32)
    labels[0, :3] = -100                   # ignored positions
    return tokens, labels


def _oracle(path):
    """The JAX half: writes every input and output to ``path``."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config, smoke_config
    from repro.core import collective_matmul as cm
    from repro.distributed import context as dctx
    from repro.distributed.sharding_rules import Rules
    from repro.launch import steps
    from repro.models import lm
    from repro.optim import adamw

    out = {}
    for W in WS:
        mesh = jax.make_mesh((W,), ("model",), devices=jax.devices()[:W],
                             axis_types=(AxisType.Auto,))
        for name, (lead, M, K, N, N_rs) in CM_SHAPES.items():
            a, b = normal(1, (*lead, M, K)), normal(2, (K, N))
            b_rs = normal(3, (K, N_rs))
            out[f"cm/{name}/a"], out[f"cm/{name}/b"] = a, b
            out[f"cm/{name}/b_rs"] = b_rs
            for mode in CM_MODES:
                out[f"cm{W}/{name}/ag/{mode}"] = np.asarray(jax.jit(
                    lambda a, b, m=mode: cm.ag_gemm_m_sharded_sm(
                        a, b, mesh, mode=m))(a, b))
                out[f"cm{W}/{name}/rs/{mode}"] = np.asarray(jax.jit(
                    lambda a, b, m=mode: cm.gemm_rs_sm(
                        a, b, mesh, mode=m))(a, b_rs))
            out[f"cm{W}/{name}/ring_ag"] = np.asarray(jax.jit(
                cm._smap(functools.partial(cm.all_gather_ring, axis="model",
                                           gather_axis=a.ndim - 2), mesh,
                         (P(*(None,) * (a.ndim - 2), "model", None),), P(),
                         "model", check_vma=False))(a))
        for fn in ("ag", "rs"):        # a ragged M
            sm = cm.ag_gemm_m_sharded_sm if fn == "ag" else cm.gemm_rs_sm
            try:
                sm(err_a(W), err_b(W), mesh, mode="ring")
                msg = ""
            except ValueError as e:
                msg = str(e)
            out[f"cm{W}/err_{fn}"] = np.array(msg)

    cfg = smoke_config(get_config("llama3-8b")).replace(dtype=jnp.float32)
    params = lm.init_params(jax.random.PRNGKey(0), cfg)
    for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["p/" + ".".join(str(x.key) for x in k)] = np.asarray(v)
    tokens, labels = train_batch(cfg.vocab_size)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    for W in WS:
        mesh = jax.make_mesh((1, W), ("data", "model"),
                             devices=jax.devices()[:W],
                             axis_types=(AxisType.Auto,) * 2)
        rules = Rules(mesh)
        psh = steps.param_shardings(cfg, rules)
        for mode in MODES:
            ctx = dctx.make_context(mesh, fusion_mode=mode, rules=rules)
            with dctx.use(ctx), mesh:
                p = jax.device_put(params, psh)
                (loss, _), grads = jax.jit(jax.value_and_grad(
                    lambda p: lm.loss_fn(p, batch, cfg), has_aux=True))(p)
            out[f"m{W}/{mode}/loss"] = np.asarray(loss)
            for k, v in jax.tree_util.tree_flatten_with_path(grads)[0]:
                out[f"m{W}/{mode}/g/" + ".".join(str(x.key) for x in k)] = \
                    np.asarray(v)
        if W != ADAM_W:
            continue
        jitted, ctx, _, osh = steps.jitted_train_step(
            cfg, mesh, adamw.AdamWConfig(lr=LR), fusion_mode="ring",
            donate=False)
        with dctx.use(ctx), mesh:
            p = jax.device_put(params, psh)
            o = jax.device_put(adamw.init_state(params), osh)
            for step in range(2):
                p, o, met = jitted(p, o, batch)
                out[f"adam{W}/loss{step}"] = np.asarray(met["loss"])
                out[f"adam{W}/gnorm{step}"] = np.asarray(met["grad_norm"])
        for k, v in jax.tree_util.tree_flatten_with_path(p)[0]:
            out[f"adam{W}/p/" + ".".join(str(x.key) for x in k)] = \
                np.asarray(v)
    np.savez(path, **out)


if __name__ == "__main__":
    _oracle(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------------ the port
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.distributed import sharding_rules as jsr  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import collective_matmul as cm  # noqa: E402
from repro_torch.distributed import sharding_rules as tsr  # noqa: E402
from repro_torch.distributed.context import (DistContext, Mesh,  # noqa: E402
                                             use)
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.module import tree_items  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def oracle_run(tmp_path_factory):
    """Starts the JAX half when the module's first test starts, so the
    port-only tests run while it computes."""
    out = tmp_path_factory.mktemp("oracle") / "train.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
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


def _shards(x, W, dim):
    n = x.shape[dim] // W
    return [x.narrow(dim, r * n, n).contiguous() for r in range(W)]


def _cfg(**kw):
    return smoke_config(get_config("llama3-8b")).replace(
        dtype=torch.float32, **kw)


def _leaf_close(got, want, frac, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= frac * scale, f"{what}: max err {err:.3e} > {frac} x " \
                                f"{scale:.3e}"


# ---------------------------------------------------------------- rules
class _FakeMesh:
    """What both packages' rules read of a mesh: its axis sizes."""

    def __init__(self, W):
        self.shape = {"data": 1, "model": W}
        self.size = W


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x22b",
                                  "paligemma-3b", "phi3-mini-3.8b"])
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("W", [2, 4, 64])
def test_rules_specs_and_degradations_match_jax(arch, smoke, W):
    """Every parameter leaf's spec and the degradations list, on the
    same shapes (JAX's ``lm_spec``), with each arch's overrides; at W =
    64 the smoke model's 32 k/v columns (KVH = 1) degrade."""
    jc, tc = jax_get_config(arch), get_config(arch)
    if smoke:
        jc, tc = jax_smoke(jc), smoke_config(tc)
    jr = jsr.rules_for(jc, _FakeMesh(W))
    tr = tsr.rules_for(tc, _FakeMesh(W))
    for path, p in tree_items(jlm.lm_spec(jc)):
        want = jr.spec_for(p.axes, p.shape, path)
        assert tr.spec_for(p.axes, p.shape, path) == tuple(want), path
    assert tr.degradations == jr.degradations


@pytest.mark.parametrize("W", WS)
def test_kv_columns_of_one_kv_head_split_mid_head(W):
    """smoke_config: KVH = 1, hd = 32: the rules shard wk/wv's 32
    columns, 32 / W to a rank (in the middle of the one KV head), as
    JAX's do; norm scales are replicated."""
    dims = tlm.shard_dims(_cfg(), _mesh(W))
    assert dims["backbone.layers.attn.wk"] == 2
    assert dims["backbone.layers.ln1.scale"] is None
    assert dims["embed.table"] == 1 and dims["head.table"] == 0
    ps = tlm.init_params(_cfg(), seed=0, device="cpu", mesh=_mesh(W))
    assert tuple(ps[0]["backbone"]["layers"]["attn"]["wk"].shape) == \
        (4, 128, 32 // W)


def test_shard_and_unshard_are_inverse():
    cfg = _cfg()
    p = tlm.init_params(cfg, seed=3, device="cpu", trainable=True)
    for W in WS:
        back = tlm.gather_params(tlm.shard_params(p, _mesh(W)), _mesh(W))
        for (n, x), (_, y) in zip(back.named_parameters(),
                                  p.named_parameters()):
            assert torch.equal(x, y), n
        assert all(t.requires_grad for t in back.parameters())


# ------------------------------------------------------ GQA head layouts
@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("heads", [(4, 1, 32), (4, 4, 32), (6, 2, 16)])
@pytest.mark.parametrize("seq", [24, 22])
def test_attention_over_ranks_equals_one_rank(W, heads, seq):
    """apply_attn over W ranks against one rank (checked against JAX in
    test_torch_train_model.py), forward and gradients: KV columns split
    mid-head (KVH 1), heads aligned with the ranks (KVH 4), query heads
    that do not divide by W (6 heads at W = 4), and a sequence that does
    not divide by W (22 at W = 4: the replicated fallback). 1e-5, the
    attention's own tolerance (the same fp32 ops in another order)."""
    H, KVH, hd = heads
    cfg = _cfg(n_heads=H, n_kv_heads=KVH, head_dim=hd)
    r = np.random.default_rng(seq + H + KVH)
    d = cfg.d_model
    p = {"wq": r.normal(size=(d, H * hd)), "wk": r.normal(size=(d, KVH * hd)),
         "wv": r.normal(size=(d, KVH * hd)), "wo": r.normal(size=(H * hd, d))}
    p = {k: _t((v / np.sqrt(d)).astype(np.float32)) for k, v in p.items()}
    x = _t(r.normal(size=(2, seq, d)).astype(np.float32))
    dy = _t(r.normal(size=(2, seq, d)).astype(np.float32))
    p1 = {k: v.clone().requires_grad_() for k, v in p.items()}
    x1 = x.clone().requires_grad_()
    y1 = tattn.apply_attn(p1, x1, cfg)
    (y1 * dy).sum().backward()
    sharded = seq % W == 0
    cut = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
    pr = [{k: v.narrow(cut[k], i * (v.shape[cut[k]] // W),
                       v.shape[cut[k]] // W).clone().requires_grad_()
           for k, v in p.items()} for i in range(W)]
    xr = [(_shards(x, W, 1)[i] if sharded else x).clone().requires_grad_()
          for i in range(W)]
    with use(DistContext(_mesh(W), "ring")):
        y = tattn.apply_attn(pr, xr, cfg,
                             positions=torch.arange(seq)[None, :])
    if sharded:
        got, dys = torch.cat(y, dim=1), _shards(dy, W, 1)
    else:
        for yr in y:
            np.testing.assert_allclose(yr.detach().numpy(),
                                       y[0].detach().numpy(), rtol=0, atol=0)
        got, dys = y[0], [dy / W] * W
    sum((yr * d).sum() for yr, d in zip(y, dys)).backward()
    np.testing.assert_allclose(got.detach().numpy(), y1.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    gx = torch.cat([t.grad for t in xr], dim=1) if sharded else \
        sum(t.grad for t in xr)
    _leaf_close(gx, x1.grad, 1e-5, "dx")
    for k in p:
        _leaf_close(torch.cat([q[k].grad for q in pr], dim=cut[k]),
                    p1[k].grad, 1e-5, f"d{k}")


# ------------------------------------------------------------ the trainer
RUN = ["--arch", "llama3-8b", "--smoke", "--batch", "2", "--seq", "16",
       "--log-every", "1", "--device", "cpu", "--warmup", "8"]


def _train(cfg, argv, **kw):
    return ttrain.train(cfg, ttrain.parse_args(RUN + argv), **kw)


def _only_step(src, step, dst):
    import shutil
    name = f"step_{step:08d}"
    os.makedirs(dst, exist_ok=True)
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return str(dst)


def test_elastic_checkpoint_two_one_four_equals_the_uninterrupted_run(
        tmp_path):
    """float32 smoke: 6 steps at W = 2, against 2 steps at W = 2, 2 more
    resumed at W = 1, the last 2 resumed at W = 4, and against the W = 2
    checkpoint resumed at W = 4 directly (warmup 8 > steps, so the lr
    schedule does not depend on the total)."""
    cfg = _cfg()
    full = _train(cfg, ["--steps", "6", "--tp", "2", "--fusion-mode",
                        "ring"])
    d = str(tmp_path / "ck")
    _train(cfg, ["--steps", "2", "--tp", "2", "--fusion-mode", "ring",
                 "--ckpt-dir", d, "--ckpt-every", "2"])
    b = _train(cfg, ["--steps", "4", "--tp", "1", "--ckpt-dir", d,
                     "--resume"])
    c = _train(cfg, ["--steps", "6", "--tp", "4", "--fusion-mode", "bsp",
                     "--ckpt-dir", d, "--resume"])
    direct = _train(cfg, ["--steps", "4", "--tp", "4", "--ckpt-dir",
                          _only_step(d, 2, tmp_path / "w4"), "--resume"])
    assert (b["start_step"], c["start_step"], direct["start_step"]) == \
        (2, 4, 2)
    np.testing.assert_allclose([m["loss"] for m in b["log"] + c["log"]],
                               [m["loss"] for m in full["log"][2:]],
                               rtol=1e-5)
    np.testing.assert_allclose([m["loss"] for m in direct["log"]],
                               [m["loss"] for m in full["log"][2:4]],
                               rtol=1e-5)
    got = tlm.gather_params(c["params"], _mesh(4))
    want = tlm.gather_params(full["params"], _mesh(2))
    init = dict(tlm.init_params(cfg, seed=0, device="cpu").named_parameters())
    for (n, x), (_, y) in zip(got.named_parameters(),
                              want.named_parameters()):
        rel = ((x - y).norm() / (y - init[n]).norm()).item()
        assert rel <= 2e-2, f"{n}: {rel:.3e} of the update"
    # the checkpoint holds the global arrays, as a one-rank run writes them
    from repro_torch.checkpoint.checkpointer import Checkpointer
    flat, _ = Checkpointer(d).read()
    assert tuple(flat["params%%backbone%%layers%%attn%%wq"].shape) == \
        (4, 128, 128)
    assert tuple(flat["opt%%m%%head%%table"].shape) == (512, 128)


def test_cli_tp2_matches_tp1_and_resumes_at_tp1_and_in_jax(tmp_path):
    """``python -m repro_torch.launch.train --tp 2 --device cpu`` (bf16
    smoke, as the CLI builds it) against ``--tp 1``; its checkpoint after
    2 steps resumed by the port at ``--tp 1`` and by JAX's trainer, each
    continuing the uninterrupted curve."""
    argv = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "32", "--log-every", "1", "--warmup", "8"]
    d, mf = tmp_path / "ck", tmp_path / "m.json"
    subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                    *argv, "--tp", "2", "--steps", "4", "--ckpt-dir", str(d),
                    "--ckpt-every", "2", "--metrics-file", str(mf)],
                   env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                   check=True, timeout=300)
    import json
    tp2 = [m["loss"] for m in json.loads(mf.read_text())]
    tp1 = [m["loss"] for m in ttrain.main(argv + ["--steps", "4"])]
    assert len(tp2) == 4
    np.testing.assert_allclose(tp2, tp1, rtol=2e-3)
    res = ttrain.main(argv + ["--steps", "4", "--resume", "--ckpt-dir",
                              _only_step(d, 2, tmp_path / "p1")])
    np.testing.assert_allclose([m["loss"] for m in res], tp2[2:], rtol=2e-3)
    jl = jtrain.main(["--arch", "llama3-8b", "--smoke", "--batch", "2",
                      "--seq", "32", "--log-every", "1", "--warmup", "8",
                      "--steps", "4", "--resume", "--ckpt-dir",
                      _only_step(d, 2, tmp_path / "jax")])
    assert [m["step"] for m in jl] == [2, 3]
    np.testing.assert_allclose([m["loss"] for m in jl], tp2[2:], rtol=2e-3)


def test_trainer_meshes():
    """``--devices`` lists one device per rank, as in ``launch.serve``;
    the production meshes need 16 and 32 processes (torchrun), and one
    process refuses them."""
    log = ttrain.main(RUN + ["--steps", "1", "--tp", "2", "--devices",
                             "cpu,cpu"])
    assert np.isfinite(log[0]["loss"])
    with pytest.raises(ValueError, match="one device per rank"):
        ttrain.main(RUN + ["--steps", "1", "--tp", "2", "--devices", "cpu"])
    for extra, n in ((["--mesh", "production"], 16), (["--multi-pod"], 32)):
        with pytest.raises(ValueError, match=f"over {n} processes"):
            ttrain.main(RUN + ["--steps", "1", "--tp", "2"] + extra)


# ---------------------------------------------- the collective matmuls
@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("mode", CM_MODES)
@pytest.mark.parametrize("shape", sorted(CM_SHAPES))
def test_collective_matmuls_match_jax(jx, W, mode, shape):
    a, b, b_rs = (_t(jx[f"cm/{shape}/{k}"]) for k in ("a", "b", "b_rs"))
    mesh = _mesh(W)
    ag = cm.ag_gemm_m_sharded_sm(a, b, mesh, mode=mode)
    np.testing.assert_allclose(torch.cat(ag, dim=-1).numpy(),
                               jx[f"cm{W}/{shape}/ag/{mode}"], **TOL)
    rs = cm.gemm_rs_sm(a, b_rs, mesh, mode=mode)
    np.testing.assert_allclose(torch.cat(rs, dim=-2).numpy(),
                               jx[f"cm{W}/{shape}/rs/{mode}"], **TOL)


@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("shape", sorted(CM_SHAPES))
def test_all_gather_ring_matches_jax(jx, W, shape):
    a = _t(jx[f"cm/{shape}/a"])
    for got in cm.all_gather_ring(_shards(a, W, -2), gather_axis=-2):
        np.testing.assert_array_equal(got.numpy(), jx[f"cm{W}/{shape}/ring_ag"])
    for got in cm.all_gather(_shards(a, W, -2), gather_axis=-2):
        assert torch.equal(got, a)


@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("fn", ["ag", "rs"])
def test_ragged_m_raises_jax_message(jx, W, fn):
    want = str(jx[f"cm{W}/err_{fn}"])
    assert want
    sm = cm.ag_gemm_m_sharded_sm if fn == "ag" else cm.gemm_rs_sm
    with pytest.raises(ValueError) as e:
        sm(_t(err_a(W)), _t(err_b(W)), _mesh(W), mode="ring")
    assert str(e.value) == want


@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("mode", CM_MODES)
@pytest.mark.parametrize("fn", ["ag", "rs"])
def test_collective_matmul_grads_match_one_product(W, mode, fn):
    """Autograd through the W-rank loops (the GEMM's own backward at
    every step) against autograd through one single-rank product."""
    lead, M, K, N, N_rs = CM_SHAPES["b" if fn == "ag" else "a"]
    if fn == "rs":
        N = N_rs
    a, b = _t(normal(7, (*lead, M, K))), _t(normal(8, (K, N)))
    dy = _t(normal(9, (*lead, M, N)))
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    ((a1 @ b1) * dy).sum().backward()
    if fn == "ag":      # rows of A, columns of B and of the output
        a_s, b_s = _shards(a, W, -2), _shards(b, W, -1)
        dims = (-2, -1, -1)
    else:               # columns of A, rows of B, rows of the output
        a_s, b_s = _shards(a, W, -1), _shards(b, W, 0)
        dims = (-1, 0, -2)
    for t in a_s + b_s:
        t.requires_grad_()
    body = cm.ag_gemm_m_sharded if fn == "ag" else cm.gemm_rs
    out = body(a_s, b_s, mode=mode)
    sum((o * d).sum() for o, d in zip(out, _shards(dy, W, dims[2]))
        ).backward()
    np.testing.assert_allclose(torch.cat(out, dim=dims[2]).detach().numpy(),
                               (a @ b).numpy(), **TOL)
    _leaf_close(torch.cat([t.grad for t in a_s], dim=dims[0]), a1.grad,
                1e-5, "dA")
    _leaf_close(torch.cat([t.grad for t in b_s], dim=dims[1]), b1.grad,
                1e-5, "dB")


# ------------------------------------------------------------ the model
def _jax_tree(jx, prefix):
    tree: dict = {}
    for key, v in jx.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _batch():
    tokens, labels = train_batch(512)
    return {"tokens": _t(tokens), "labels": _t(labels)}


def _global_grads(ps, mesh):
    """The gradient of every global leaf: sharded leaves' blocks joined,
    replicated leaves' per-rank copies summed (each rank's copy sees its
    rows only)."""
    dims = tlm.shard_dims(ps[0].cfg, mesh)
    grads = [dict(p.named_parameters()) for p in ps]
    out = {}
    for n, d in dims.items():
        gs = [g[n].grad for g in grads]
        out[n] = (sum(gs) if d is None else torch.cat(gs, dim=d)).numpy()
    return out


@pytest.fixture(scope="module")
def one_rank(jx):
    """The port at W = 1 on JAX's parameters: (loss, gradients)."""
    p = params_from_numpy(_jax_tree(jx, "p/"), _cfg(), device="cpu",
                          trainable=True)
    loss, _ = tlm.loss_fn(p, _batch(), _cfg())
    loss.backward()
    return loss.item(), {n: t.grad.numpy() for n, t in p.named_parameters()}


@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("mode", MODES)
def test_loss_and_every_grad_match_jax(jx, one_rank, W, mode):
    mesh = _mesh(W)
    ps = params_from_numpy(_jax_tree(jx, "p/"), _cfg(), trainable=True,
                           mesh=mesh)
    assert len(ps) == W
    with use(DistContext(mesh, mode)):
        loss, metrics = tlm.loss_fn(ps, _batch(), _cfg())
        loss.backward()
    np.testing.assert_allclose(loss.item(), float(jx[f"m{W}/{mode}/loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(loss.item(), one_rank[0], rtol=1e-5)
    got = _global_grads(ps, mesh)
    assert set(got) == set(one_rank[1])
    for n, g in got.items():
        _leaf_close(g, jx[f"m{W}/{mode}/g/{n}"], 1e-3, f"{n} vs JAX")
        _leaf_close(g, one_rank[1][n], 1e-3, f"{n} vs W=1")


def test_eval_step_over_ranks_equals_the_train_loss(jx, one_rank):
    mesh = _mesh(4)
    ps = params_from_numpy(_jax_tree(jx, "p/"), _cfg(), mesh=mesh)
    with use(DistContext(mesh, "ring")):
        m = tsteps.make_eval_step(_cfg())(ps, _batch())
    np.testing.assert_allclose(m["loss"].item(), one_rank[0], rtol=1e-5)


def _two_steps(jx, W):
    mesh = _mesh(W) if W > 1 else None
    ps = params_from_numpy(_jax_tree(jx, "p/"), _cfg(), device="cpu",
                           trainable=True, mesh=mesh)
    opt = tsteps.init_opt_state(ps)
    step = tsteps.make_train_step(_cfg(), tadamw.AdamWConfig(lr=LR))
    ms = []
    with use(DistContext(mesh, "ring")):
        for _ in range(2):
            ps, opt, m = step(ps, opt, _batch())
            ms.append({k: v.item() for k, v in m.items()})
    return mesh, ps, opt, ms


@pytest.fixture(scope="module")
def adam_run(jx):
    return _two_steps(jx, ADAM_W)


def test_two_adamw_steps_match_jax(jx, adam_run):
    mesh, ps, _, ms = adam_run
    _, p1, _, one = _two_steps(jx, 1)
    for i, (m, m1) in enumerate(zip(ms, one)):
        np.testing.assert_allclose(m["loss"], m1["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], m1["grad_norm"],
                                   rtol=1e-3)
        np.testing.assert_allclose(m["loss"],
                                   float(jx[f"adam{ADAM_W}/loss{i}"]),
                                   rtol=1e-5 if i == 0 else 1e-3)
        np.testing.assert_allclose(m["grad_norm"],
                                   float(jx[f"adam{ADAM_W}/gnorm{i}"]),
                                   rtol=1e-3 if i == 0 else 2e-2)
    want = dict(tree_items(_jax_tree(jx, f"adam{ADAM_W}/p/")))
    init = dict(tree_items(_jax_tree(jx, "p/")))
    got = tlm.gather_params(ps, mesh)
    w1 = dict(p1.named_parameters())
    for n, t in got.named_parameters():
        t, t1 = t.detach().numpy(), w1[n].detach().numpy()
        moved = np.linalg.norm(t1 - init[n])
        assert moved > 0, n
        rel = np.linalg.norm(t - t1) / moved
        assert rel <= 1e-2, f"{n}: {rel:.3e} of the update vs W = 1"
        rel = np.linalg.norm(t - want[n]) / moved
        diff = np.abs(t - want[n]).max()
        assert rel <= 0.3 and diff <= 4 * 2 * LR, \
            f"{n}: {rel:.3e} of the update, max {diff:.3e} vs JAX"


@pytest.mark.parametrize("W", WS)
def test_adamw_over_ranks_equals_one_rank_on_the_same_grads(W):
    """Two steps of ``apply_updates_ranks`` on per-rank shards of one set
    of gradients (a replicated leaf's gradient split over its copies)
    against ``apply_updates`` at W = 1: parameters, m and v within 1e-6
    of each leaf's largest |entry| (the clip factor from the shards'
    squares summed in another order); copies bit-identical."""
    cfg, mesh = _cfg(), _mesh(W)
    p1 = tlm.param_tree(tlm.init_params(cfg, seed=5, device="cpu",
                                        trainable=True))
    ps = [tlm.param_tree(p) for p in tlm.shard_params(
        tlm.from_tree(cfg, p1, trainable=True), mesh)]
    dims = tlm.shard_dims(cfg, mesh)
    o1 = tadamw.init_state(p1)
    os_ = [tadamw.init_state(p) for p in ps]
    opt = tadamw.AdamWConfig(lr=LR)
    for step in range(2):
        g1 = {n: _t(normal(20 + step, tuple(t.shape))) for n, t in
              tree_items(p1)}
        gs = [{} for _ in range(W)]
        for n, g in g1.items():
            d = dims[n]
            parts = ([g * (r + 1) / (W * (W + 1) / 2) for r in range(W)]
                     if d is None else _shards(g, W, d))
            for r in range(W):
                gs[r][n] = parts[r].clone()
        m1 = tadamw.apply_updates(p1, _nest(g1), o1, opt)
        mw = tadamw.apply_updates_ranks(ps, [_nest(g) for g in gs], os_,
                                        opt, tlm.leaf_specs(cfg, mesh),
                                        mesh.shape)
        assert float(m1["grad_norm"]) > opt.grad_clip      # clipped
        np.testing.assert_allclose(float(mw["grad_norm"]),
                                   float(m1["grad_norm"]), rtol=1e-6)
    for part, one, ranks in (("params", p1, ps),
                             ("m", o1["m"], [o["m"] for o in os_]),
                             ("v", o1["v"], [o["v"] for o in os_])):
        trees = [dict(tree_items(t)) for t in ranks]
        for n, want in tree_items(one):
            d = dims[n]
            if d is None:
                for t in trees[1:]:
                    assert torch.equal(t[n], trees[0][n]), (part, n)
                got = trees[0][n]
            else:
                got = torch.cat([t[n] for t in trees], dim=d)
            _leaf_close(got.detach(), want.detach(), 1e-6, f"{part} {n}")


def _nest(flat):
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *keys, leaf = path.split(".")
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def test_replicated_copies_stay_bit_identical(adam_run):
    mesh, ps, opt, _ = adam_run
    dims = tlm.shard_dims(ps[0].cfg, mesh)
    reps = [n for n, d in dims.items() if d is None]
    assert "backbone.layers.ln1.scale" in reps and "ln_f.scale" in reps
    trees = [dict(p.named_parameters()) for p in ps]
    ms = [dict(tree_items(o["m"])) for o in opt]
    for n in reps:
        for r in range(1, len(ps)):
            assert torch.equal(trees[r][n], trees[0][n]), n
            assert torch.equal(trees[r][n].grad, trees[0][n].grad), n
            assert torch.equal(ms[r][n], ms[0][n]), n
    assert all(int(o["step"]) == 2 for o in opt)
