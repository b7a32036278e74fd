"""The port's checkpointer (``repro_torch.checkpoint.checkpointer``) on
the cases of tests/test_checkpoint.py (round trip with bf16 leaves bit
for bit, async save, retention, no partial checkpoint, latest step, a
missing leaf), plus: reading checkpoints that the JAX package's
checkpointer wrote, and ``launch/serve.py --ckpt-dir`` on such a params
checkpoint, or on the port trainer's, served at one rank and on shards,
whose logits must equal the JAX model's."""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpointer as jckpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.module import cast_tree  # noqa: E402
from repro_torch.checkpoint.checkpointer import (Checkpointer,  # noqa: E402
                                                 flatten, unflatten)
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.module import tree_items  # noqa: E402

torch.set_num_threads(2)


def _tree(seed=0):
    """Nested dicts and a per-rank list, in float32, bf16 and int32 (the
    shapes of a paged decode state at W = 2, and a parameter dict)."""
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 16), generator=g),
                       "b": torch.zeros((16,))},
            "caches": {"k": [torch.randn((2, 4, 8), generator=g)
                             .to(torch.bfloat16) for _ in range(2)]},
            "cur_len": torch.arange(4, dtype=torch.int32),
            "step": np.int32(7) + np.zeros((), np.int32)}


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict)
            else [torch.zeros_like(x) for x in v] if isinstance(v, list)
            else torch.zeros_like(torch.as_tensor(v)) for k, v in tree.items()}


def _bits(t):
    t = torch.as_tensor(t)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("async_save", [False, True])
def test_roundtrip_bit_exact(tmp_path, async_save):
    ck = Checkpointer(str(tmp_path), async_save=async_save)
    t = _tree(1)
    ck.save(10, t, extra={"next_step": 10})
    ck.wait()
    template = _zeros(t)
    got, manifest = ck.restore(None, template)
    assert got is template
    assert manifest["step"] == 10 and manifest["extra"]["next_step"] == 10
    assert manifest["dtypes"] == {"caches%%k%%0": "bfloat16",
                                  "caches%%k%%1": "bfloat16"}
    want, have = flatten(t), flatten(got)
    assert sorted(want) == sorted(have)
    for key in want:
        assert have[key].dtype == torch.as_tensor(want[key]).dtype
        assert torch.equal(_bits(have[key]), _bits(want[key])), key


def test_save_snapshots_before_returning(tmp_path):
    """An async save holds its own host copy: writing the tensors right
    after save() does not reach the checkpoint."""
    ck = Checkpointer(str(tmp_path))
    t = _tree(2)
    want = t["params"]["w"].clone()
    ck.save(1, t)
    t["params"]["w"].fill_(0.0)
    ck.wait()
    got, _ = ck.restore(1, _zeros(t))
    assert torch.equal(got["params"]["w"], want)


def test_retention_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree())
    assert ck.all_steps() == [3, 4]


def test_no_partial_checkpoint_visible(tmp_path):
    """A crash mid-write (a stray tmp dir) is never listed, and a step
    directory without its manifest does not count."""
    ck = Checkpointer(str(tmp_path), async_save=False)
    os.makedirs(tmp_path / ".tmp_step_9_12345")
    ck.save(1, _tree())
    assert ck.all_steps() == [1]
    os.makedirs(tmp_path / "step_00000099")
    assert ck.all_steps() == [1] and ck.latest_step() == 1


def test_restore_latest_picks_max(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False, keep=10)
    for s in (3, 11, 7):
        ck.save(s, _tree(s))
    assert ck.latest_step() == 11
    got, m = ck.restore(None, _zeros(_tree()))
    assert m["step"] == 11
    assert torch.equal(got["params"]["w"], _tree(11)["params"]["w"])


@pytest.mark.parametrize("template,error", [
    ({"a": torch.ones(2), "extra": torch.ones(3)}, KeyError),
    ({"a": torch.ones(3)}, ValueError),
    ({"a": torch.ones(2, dtype=torch.bfloat16)}, ValueError)])
def test_restore_refuses_missing_leaf_or_shape(tmp_path, template, error):
    """A missing leaf, a shape mismatch or a dtype mismatch (``copy_``
    would cast) raises before anything is written into the template."""
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, {"a": torch.full((2,), 5.0)})
    before = {k: v.clone() for k, v in template.items()}
    with pytest.raises(error):
        ck.restore(1, template)
    assert all(torch.equal(template[k], before[k]) for k in template)
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(None, template)


def test_flatten_keys_match_the_jax_checkpointer(tmp_path):
    """The port's leaf paths are the JAX checkpointer's (dict keys and
    list indices joined by %%), and unflatten inverts a dict tree."""
    t = {"a": {"b": np.ones(2, np.float32), "c": [np.zeros(1, np.float32),
                                                    np.ones(1, np.float32)]}}
    jckpt.Checkpointer(str(tmp_path), async_save=False).save(1, t)
    flat, _ = Checkpointer(str(tmp_path)).read(1)
    assert sorted(flat) == sorted(flatten(t)) == [
        "a%%b", "a%%c%%0", "a%%c%%1"]
    assert unflatten({"x%%y": 1, "x%%z%%w": 2}) == {"x": {"y": 1,
                                                          "z": {"w": 2}}}


def _jax_models(dtype):
    """The smoke config (the one ``serve.py --smoke`` builds) in float32,
    and JAX parameters stored in ``dtype``."""
    jc = jax_smoke(jax_get_config("llama3-8b")).replace(dtype=jnp.float32)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    if dtype == "bfloat16":
        jp = cast_tree(jp, jnp.bfloat16)
    tc = smoke_config(get_config("llama3-8b")).replace(dtype=torch.float32)
    return jc, jp, tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reads_a_jax_params_checkpoint(tmp_path, dtype):
    """A params checkpoint the JAX checkpointer wrote (bf16 leaves come
    back from npz as raw void) reads back leaf for leaf, bits exact."""
    _, jp, _ = _jax_models(dtype)
    jckpt.Checkpointer(str(tmp_path), async_save=False).save(
        3, {"params": jp}, extra={"next_step": 3})
    flat, manifest = Checkpointer(str(tmp_path)).read(None)
    assert manifest["step"] == 3
    want = flatten({"params": jax.tree.map(np.asarray, jp)})
    assert sorted(flat) == sorted(want)
    for key, w in want.items():
        got = flat[key]
        if dtype == "bfloat16":
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  w.view(np.int16))
        else:
            assert np.array_equal(got.numpy(), w)


@functools.lru_cache(maxsize=None)
def _jax_logits(dtype):
    """The tokens and the JAX model's logits at each of their steps, for
    the JAX parameters stored in ``dtype``."""
    jc, jp, _ = _jax_models(dtype)
    toks = np.random.default_rng(0).integers(1, jc.vocab_size, (2, 6))
    jp32 = cast_tree(jp, jnp.float32)
    jst = jlm.init_decode_state(jp32, jc, 2, 16)
    out = []
    for j in range(toks.shape[1]):
        jl, jst = jlm.decode_step(jp32, jnp.asarray(toks[:, j:j + 1]), jst,
                                  jc)
        out.append(np.asarray(jl, np.float32))
    return toks, out


def _write_params(path, source):
    """A params checkpoint of the JAX parameters: the JAX checkpointer's
    at step 5 (``source`` float32 or bfloat16 leaves), or ("port") the
    port trainer's fp32 masters, saved from 2 ranks at step 0, after no
    step. Returns (the dtype of the JAX parameters it holds, its step)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import train as ttrain
    dtype = "float32" if source == "port" else source
    _, jp, tc = _jax_models(dtype)
    if source != "port":
        jckpt.Checkpointer(path, async_save=False).save(5, {"params": jp})
        return dtype, 5
    args = ttrain.parse_args(["--arch", "llama3-8b", "--smoke", "--device",
                              "cpu", "--tp", "2", "--steps", "0",
                              "--ckpt-dir", path])
    params = params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                               device="cpu", trainable=True)
    ttrain.train(tc, args, params=params)
    return dtype, 0


# the serving meshes: (CLI flags, the mesh's ranks, --tp)
SERVE_MESHES = {"tp1": ([], 1, 1), "tp2": (["--tp", "2"], 2, 2),
                "2x2": (["--devices", "cpu,cpu,cpu,cpu", "--tp", "2"], 4,
                        2)}


@pytest.mark.parametrize("mesh_name", list(SERVE_MESHES))
@pytest.mark.parametrize("source", ["float32", "bfloat16", "port"])
def test_serve_ckpt_dir_logits_equal_jax(tmp_path, source, mesh_name):
    """``serve.py --ckpt-dir`` on a params checkpoint the JAX package
    wrote (float32 or bf16 leaves) or the port's trainer wrote (fp32
    masters, from 2 ranks): restored at one rank, at tp 2 and on a
    (data 2, model 2) mesh, each rank's shards read leaf by leaf and cast
    after the cut (``serve.load_params``), the port's model gives the
    JAX model's logits on the same tokens (the tolerance of
    tests/test_torch_decode.py: both cast the fp32 logits to bf16, one
    bf16 ulp on a rounding boundary), and the CLI serves from it."""
    from repro_torch.distributed import context as dctx
    from repro_torch.launch import serve
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import make_mesh
    flags, n, tp = SERVE_MESHES[mesh_name]
    dtype, step = _write_params(str(tmp_path), source)
    tc = _jax_models(dtype)[2]
    mesh = make_mesh(tp, ["cpu"] * n, "cpu")
    params, manifest = serve.load_params(
        str(tmp_path), tc, "cpu", mesh if n > 1 else None)
    assert manifest["step"] == step
    if n > 1:
        want = tlm_shard_shapes(tc, mesh)
        assert len(params) == n
        for p in params:
            assert {k: tuple(v.shape) for k, v in
                    tree_items(lm.param_tree(p))} == want
    fn, _, _ = tsteps.jitted_serve_step(tc, mesh if n > 1 else None)
    with dctx.use(dctx.DistContext(mesh if n > 1 else None)):
        tst = lm.init_decode_state(params, tc, 2, 16)
    toks, jax_logits = _jax_logits(dtype)
    for j, want in enumerate(jax_logits):
        with torch.inference_mode():
            tl, tst = fn(params, torch.from_numpy(toks[:, j:j + 1]), tst)
        got = tl.float().numpy()
        assert np.all(np.abs(got - want) <= 1e-4 + 2 ** -7 * np.abs(want))
    stats = serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path), "--requests", "2",
                        "--batch", "2", "--max-new", "2", "--max-len",
                        "32", *flags])
    assert stats["requests"] == 2 and stats["new_tokens"] == 4


def tlm_shard_shapes(cfg, mesh):
    """``{dotted path: a rank's block shape}`` by the sharding rules."""
    from repro_torch.distributed import sharding_rules as sr
    specs = lm.leaf_specs(cfg, mesh)
    return {path: sr.spec_shape(p.shape, specs[path], mesh.shape)
            for path, p in tree_items(lm.lm_spec(cfg))}


def test_engine_snapshot_of_bf16_state_is_bit_exact(tmp_path):
    """A bf16 decode state (KV pools) goes through Engine.snapshot and
    restore bit for bit."""
    from repro_torch.serving.engine import Engine, Request
    cfg = smoke_config(get_config("llama3-8b")).replace(n_layers=1)
    assert cfg.dtype == torch.bfloat16
    params = lm.init_params(cfg, seed=0, device="cpu")
    kw = dict(batch=2, max_len=64, block_size=8, n_blocks=16,
              decode_steps=4, device="cpu")
    eng = Engine(params, cfg, **kw)
    eng.submit(Request(rid=0, prompt=list(range(1, 20)), max_new_tokens=9))
    eng.tick()
    eng.tick()
    eng.snapshot(Checkpointer(str(tmp_path)))
    fresh = Engine(params, cfg, **kw)
    fresh.restore(Checkpointer(str(tmp_path)))
    for key in ("k", "v"):
        a, b = eng.pool.state["caches"][key], fresh.pool.state["caches"][key]
        assert a.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
