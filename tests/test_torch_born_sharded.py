"""Parameters born sharded: ``lm.init_params(..., mesh=)`` (each rank's
blocks cut out of draws made on its own device,
``sharding_rules.make_shards``), as JAX's trainer builds them with
``jit(init_params, out_shardings=psh)``.

* for every family and the meshes (1, 2), (1, 4), (2, 2), (4, 1) and
  (pod 2, data 2, model 1), serving and trainable: bit-identical to
  ``lm.shard_params(lm.init_params(...), mesh)``, leaf by leaf, with the
  same dtypes, devices and sharing of replicated leaves;
* no op of a born-sharded init makes a tensor larger than one layer
  slice or one unstacked leaf, beside the ranks' own blocks: no stacked
  leaf is ever drawn whole;
* the init itself: a ``"scaled"`` stacked leaf keeps the whole leaf's
  fan-in (JAX's ``_materialize`` as written), every leaf draws from its
  own generator of a stable seed (a leaf draws alone, the same in every
  process);
* the CLIs (``launch.serve``, ``launch.server``) at ``--tp 2`` and on
  ``--devices cpu,cpu,cpu,cpu --tp 4`` hand ``Engine`` each rank's
  shards, of JAX's ``param_shardings`` shard shapes (JAX's rules in this
  process), never a whole model, and their float32 greedy streams equal
  ``--tp 1``'s; the trainer on (2, 2) never builds a whole model;
* ``Checkpointer.restore_sharded(..., cast=True)`` reads one member at
  a time and casts each block after its cut.

Everything runs at smoke widths on the CPU.
"""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.distributed import sharding_rules as jsr  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.checkpoint import checkpointer as tckpt  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.distributed import sharding_rules as sr  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_mesh_for_devices  # noqa: E402,E501
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import module as tmodule  # noqa: E402
from repro_torch.models.module import tree_items  # noqa: E402

torch.set_num_threads(2)

ARCHS = ("llama3-8b", "olmoe-1b-7b", "mixtral-8x22b", "zamba2-1.2b",
         "rwkv6-3b", "paligemma-3b", "hubert-xlarge")
# (ranks, model, pods)
MESHES = {"1x2": (2, 2, 1), "1x4": (4, 4, 1), "2x2": (4, 2, 1),
          "4x1": (4, 1, 1), "2px2dx1m": (4, 1, 2)}
CASES = [(a, m, kind) for a in ARCHS for m in MESHES
         for kind in ("serving", "trainable")
         if a != "hubert-xlarge" or kind == "trainable"]


def _mesh(name):
    n, model, pods = MESHES[name]
    return make_mesh_for_devices(n, model, pods, device="cpu")


def _leaves(p):
    return dict(tree_items(tlm.param_tree(p)))


@pytest.mark.parametrize("arch,mesh_name,kind", CASES)
def test_born_sharded_equals_shard_params(arch, mesh_name, kind):
    """``init_params(..., mesh=M)`` is ``shard_params(init_params(...),
    M)`` bit for bit: the same leaves, dtypes, devices, ``split`` and
    ``requires_grad``, and the same sharing (serving: one copy of a
    replicated leaf per device; trainable: a copy a rank)."""
    cfg = smoke_config(get_config(arch))
    mesh = _mesh(mesh_name)
    trainable = kind == "trainable"
    got = tlm.init_params(cfg, seed=3, device="cpu", trainable=trainable,
                          mesh=mesh)
    want = tlm.shard_params(tlm.init_params(cfg, seed=3, device="cpu",
                                            trainable=trainable), mesh)
    assert len(got) == len(want) == mesh.size
    for r, (a, b) in enumerate(zip(got, want)):
        la, lb = _leaves(a), _leaves(b)
        assert la.keys() == lb.keys()
        assert a.split == b.split
        for k in la:
            x, y = la[k], lb[k]
            assert (x.dtype, x.device, x.requires_grad) == \
                (y.dtype, y.device, y.requires_grad), (r, k)
            assert torch.equal(x, y), (r, k)
    for k in _leaves(got[0]):
        def groups(ranks):
            ptrs = [_leaves(p)[k].data_ptr() for p in ranks]
            return [ptrs.index(q) for q in ptrs]
        assert groups(got) == groups(want), k


class _Made(TorchDispatchMode):
    """Records (op, shape) of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                self.made.append((func, tuple(t.shape)))
        return out


RANDOM = {torch.ops.aten.randn.generator, torch.ops.aten.rand.generator}


@pytest.mark.parametrize("mesh_name,kind", [("1x2", "serving"),
                                            ("2x2", "trainable")])
@pytest.mark.parametrize("arch", ARCHS[:-1])
def test_no_stacked_leaf_is_drawn_whole(arch, mesh_name, kind):
    """Every draw of a born-sharded init is one layer slice or one
    unstacked leaf; every other tensor it makes is a rank's block or no
    larger than the largest draw; no tensor has the whole shape of a
    stacked leaf that the mesh cuts (unless a rank's block of another
    leaf has that shape)."""
    cfg = smoke_config(get_config(arch))
    mesh = _mesh(mesh_name)
    spec = dict(tree_items(tlm.lm_spec(cfg)))
    specs = tlm.leaf_specs(cfg, mesh)
    draws = {p.shape[1:] if tmodule.stacked(p) else p.shape
             for p in spec.values() if tmodule.constant(p) is None}
    biggest = max(int(np.prod(s)) for s in draws)
    blocks = {sr.spec_shape(p.shape, specs[k], mesh.shape)
              for k, p in spec.items()}
    whole = {p.shape for k, p in spec.items()
             if tmodule.stacked(p) and any(specs[k])} - blocks
    with _Made() as rec:
        tlm.init_params(cfg, seed=0, device="cpu",
                        trainable=kind == "trainable", mesh=mesh)
    assert any(f in RANDOM for f, _ in rec.made)
    for func, shape in rec.made:
        if func in RANDOM:
            assert shape in draws, (func, shape)
        assert shape in blocks or int(np.prod(shape)) <= biggest, \
            (func, shape)
        assert shape not in whole, (func, shape)


def test_scaled_stacked_leaf_keeps_the_whole_leaf_fan_in():
    """A stacked ``"scaled"`` leaf (wq: (layers, d, H hd)) is drawn a
    slice at a time from its own generator with the std of the whole
    leaf's ``shape[0]`` (the layer count), not the slice's (d), on one
    rank and born sharded alike."""
    cfg = smoke_config(get_config("llama3-8b")).replace(n_layers=3)
    p = dict(tree_items(tlm.lm_spec(cfg)))["backbone.layers.attn.wq"]
    assert p.init == "scaled" and tmodule.stacked(p)
    gen = torch.Generator().manual_seed(
        tmodule.leaf_seed(5, "backbone.layers.attn.wq"))
    want = torch.stack([torch.randn(p.shape[1:], generator=gen)
                        for _ in range(p.shape[0])]) * (1 / math.sqrt(
                            p.shape[0]))
    one = tlm.init_params(cfg, seed=5, device="cpu", trainable=True)
    got = one["backbone"]["layers"]["attn"]["wq"].detach()
    assert torch.equal(got, want)
    assert got.std() > 5 * p.shape[1] ** -0.5     # not the slice's fan-in
    ranks = tlm.init_params(cfg, seed=5, device="cpu", trainable=True,
                            mesh=make_mesh(2, device="cpu"))
    half = p.shape[2] // 2
    for r, rank in enumerate(ranks):
        assert torch.equal(rank["backbone"]["layers"]["attn"]["wq"],
                           want[..., r * half:(r + 1) * half])


def test_each_leaf_draws_alone_from_a_stable_seed():
    """A leaf's values depend on the seed and its path only: drawing it
    alone (``module.draws``, slice by slice) gives what the whole init
    gives, other leaves unseen; the seed is a stable hash (pinned here),
    not Python's salted one."""
    assert tmodule.leaf_seed(0, "embed.table") == 6328699771208170673
    cfg = smoke_config(get_config("olmoe-1b-7b"))
    whole = _leaves(tlm.init_params(cfg, seed=7, device="cpu",
                                    trainable=True))
    for path, p in tree_items(tlm.lm_spec(cfg)):
        c = tmodule.constant(p)
        if c is not None:
            assert torch.equal(whole[path], torch.full(p.shape, c)), path
            continue
        vals = list(tmodule.draws(p, seed=7, path=path, device="cpu"))
        alone = (vals[0][1] if vals[0][0] is None
                 else torch.stack([x for _, x in vals]))
        assert torch.equal(whole[path], alone), path


# ------------------------------------------------------------ the CLIs
def _jax_shard_shapes(arch, mesh_shape, **kw):
    """``{dotted path: shard shape}`` by JAX's rules and ``lm_spec``:
    what ``NamedSharding(mesh, spec).shard_shape`` gives under its
    ``param_shardings``."""
    jcfg = jax_smoke(jax_get_config(arch)).replace(**kw)
    rules = jsr.rules_for(jcfg, types.SimpleNamespace(shape=mesh_shape))

    def n(entry):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        return int(np.prod([mesh_shape.get(a, 1) for a in axes]))

    def go(t, prefix=""):
        out = {}
        for k, v in t.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                out.update(go(v, path))
            else:
                spec = rules.spec_for(v.axes, v.shape, path)
                spec = tuple(spec) + (None,) * (len(v.shape) - len(spec))
                out[path] = tuple(d // n(e) for d, e in zip(v.shape, spec))
        return out
    return go(jlm.lm_spec(jcfg))


CLI_MESHES = {"tp2": (["--tp", "2"], {"data": 1, "model": 2}),
              "4x_tp4": (["--devices", "cpu,cpu,cpu,cpu", "--tp", "4"],
                         {"data": 1, "model": 4})}
COMMON = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--batch",
          "2", "--max-len", "32", "--block-size", "8", "--decode-steps",
          "4", "--fusion-mode", "pallas"]


def _no_whole_model(monkeypatch):
    """Make building a whole model (an init or an empty model at one
    rank), cutting one or replicating one raise."""
    def refuse(*_, **__):
        raise AssertionError("a whole model was cut or replicated")
    for name in ("shard_params", "replicate"):
        monkeypatch.setattr(tlm, name, refuse)
    build = tlm._build

    def ranks_only(cfg, device, trainable, mesh, draw):
        assert mesh is not None and mesh.size > 1, "a whole model was built"
        return build(cfg, device, trainable, mesh, draw)
    monkeypatch.setattr(tlm, "_build", ranks_only)


def _f32(monkeypatch, *mods):
    small = lambda c: smoke_config(c).replace(  # noqa: E731
        dtype=torch.float32, n_layers=2)
    for m in mods:
        monkeypatch.setattr(m, "smoke_config", small)


@pytest.mark.parametrize("mesh_name", list(CLI_MESHES))
def test_serve_cli_serves_born_shards(monkeypatch, mesh_name):
    """``launch.serve`` at ``--tp 2`` and over 4 listed devices at
    ``--tp 4``: ``Engine`` gets each rank's shards (born sharded, JAX's
    shard shapes, no whole model built or replicated), and the float32
    greedy streams equal ``--tp 1``'s."""
    from repro_torch.launch import serve
    flags, shape = CLI_MESHES[mesh_name]
    _f32(monkeypatch, serve)
    args = COMMON + ["--requests", "3", "--max-new", "6"]
    want = serve.main(args)["streams"]
    seen = []

    class Spy(serve.Engine):
        def __init__(self, params, *a, **kw):
            seen.append(params)
            super().__init__(params, *a, **kw)
    monkeypatch.setattr(serve, "Engine", Spy)
    _no_whole_model(monkeypatch)
    got = serve.main(args + flags)
    assert got["streams"] == want
    (params,) = seen
    assert isinstance(params, list) and len(params) == shape["model"]
    jax_shapes = _jax_shard_shapes("llama3-8b", shape, n_layers=2)
    for p in params:
        assert {k: tuple(v.shape) for k, v in _leaves(p).items()} == \
            jax_shapes


@pytest.mark.parametrize("mesh_name", list(CLI_MESHES))
def test_server_cli_serves_born_shards(monkeypatch, mesh_name):
    """``launch.server``'s ``build_engine`` on the same meshes: each
    rank's shards in the engine, of JAX's shard shapes, no whole model;
    the float32 greedy streams equal ``--tp 1``'s."""
    import repro_torch.configs as tconfigs
    from repro_torch.launch import server as server_mod
    from repro_torch.serving.engine import Request
    flags, shape = CLI_MESHES[mesh_name]
    _f32(monkeypatch, tconfigs)

    def streams(extra):
        eng = server_mod.build_engine(server_mod.make_parser().parse_args(
            COMMON + extra))
        rng = np.random.default_rng(4)
        for i in range(3):
            eng.submit(Request(rid=i, prompt=[
                int(t) for t in rng.integers(1, 256, 3 + 2 * i)],
                max_new_tokens=6))
        return eng, {r.rid: r.out_tokens for r in eng.run()}
    _, want = streams([])
    _no_whole_model(monkeypatch)
    eng, got = streams(flags)
    assert got == want
    assert isinstance(eng.params, list) and len(eng.params) == shape["model"]
    jax_shapes = _jax_shard_shapes("llama3-8b", shape, n_layers=2)
    for p in eng.params:
        assert {k: tuple(v.shape) for k, v in _leaves(p).items()} == \
            jax_shapes


def test_trainer_on_a_data_mesh_builds_no_whole_model(monkeypatch):
    """``launch.train`` on (data 2, model 2): its masters are born
    sharded (no whole model built, none cut), and its first loss is the
    one of the same seed's model at one rank (the same numbers on every
    mesh)."""
    from repro_torch.launch import train as ttrain
    argv = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--steps",
            "1", "--batch", "2", "--seq", "16"]
    cfg = smoke_config(get_config("llama3-8b")).replace(dtype=torch.float32)
    want = ttrain.train(cfg, ttrain.parse_args(argv))["log"][0]["loss"]
    _no_whole_model(monkeypatch)
    got = ttrain.train(cfg, ttrain.parse_args(
        argv + ["--devices", "cpu,cpu,cpu,cpu", "--tp", "2"]))["log"]
    assert np.isfinite(got[0]["loss"])
    np.testing.assert_allclose(got[0]["loss"], want, rtol=1e-4)


# ----------------------------------------------------- the checkpoint
def test_restore_reads_a_leaf_at_a_time_and_casts_after_the_cut(
        tmp_path, monkeypatch):
    """A fp32 params checkpoint restored into bf16 serving shards on
    (2, 2): each member is read once, one at a time (the whole file is
    never read), and every block equals the fp32 leaf cut and then cast;
    without ``cast`` the dtype mismatch raises before anything is
    written."""
    cfg = smoke_config(get_config("llama3-8b"))
    assert cfg.dtype == torch.bfloat16
    src = tlm.init_params(cfg, seed=2, device="cpu", trainable=True)
    tckpt.Checkpointer(str(tmp_path), async_save=False).save(
        1, {"params": tlm.param_tree(src)})
    mesh = make_mesh(2, ["cpu"] * 4, "cpu")
    dims = {"params%%" + k.replace(".", "%%"): d
            for k, d in tlm.leaf_specs(cfg, mesh).items()}
    read, plain = [], np.lib.npyio.NpzFile.__getitem__

    def spy(self, key):
        read.append(key)
        return plain(self, key)
    monkeypatch.setattr(np.lib.npyio.NpzFile, "__getitem__", spy)
    monkeypatch.setattr(tckpt.Checkpointer, "read", None)
    dst = tlm.empty_params(cfg, device="cpu", mesh=mesh)
    templates = [{"params": tlm.param_tree(p)} for p in dst]
    with pytest.raises(ValueError, match="!= template"):
        tckpt.Checkpointer(str(tmp_path)).restore_sharded(
            None, templates, dims, mesh_shape=mesh.shape)
    assert read == []
    tckpt.Checkpointer(str(tmp_path)).restore_sharded(
        None, templates, dims, mesh_shape=mesh.shape, cast=True)
    assert sorted(read) == sorted(dims) and len(set(read)) == len(read)
    coords = sr.rank_coords(mesh.shape)
    whole = _leaves(src)
    for r, p in enumerate(dst):
        for k, t in _leaves(p).items():
            spec = dims["params%%" + k.replace(".", "%%")]
            want = sr.cut(whole[k].detach(), spec, coords[r], mesh.shape)
            assert t.dtype == tlm.storage_dtype(k, cfg)
            assert torch.equal(t, want.to(t.dtype)), (r, k)
