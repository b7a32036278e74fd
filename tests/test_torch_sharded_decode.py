"""Decode over sharded weights: the port's serve step on per-rank shards
(``lm.shard_params``, ``launch.steps.jitted_serve_step``) against the
JAX package's ``jitted_serve_step`` on ``param_shardings`` at W = 2 and
4, for every family JAX decodes (smoke llama3-8b, olmoe-1b-7b,
mixtral-8x22b with its ``expert_mlp`` overrides, zamba2-1.2b, rwkv6-3b,
paligemma-3b; float32; 4 decode steps over the contiguous state; modes
``auto`` and ``ring``); the per-rank leaf shapes against JAX's shard
shapes; the collectives the row-parallel site records; the engine over
shards against the replicated engine and tp 1; and the dry run's decode
cell against the real shards.

The JAX half runs in one subprocess, this file's ``__main__`` block, on
4 fake CPU devices (set before JAX starts), on meshes whose axes are
``AxisType.Auto`` (the Explicit-mesh defect of ROADMAP queue 3), and
starts with the module's first test, so the port-only tests run while it
computes.

Tolerance, as in ``tests/test_torch_multirank_lm.py``: both packages
cast the fp32 unembed to bf16 logits, so an element on a bf16 rounding
boundary can come out one bf16 ulp apart (``2**-7`` relative); 1e-4
otherwise. Engine streams (greedy, float32) must be token-identical.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np

ARCHS = ("llama3-8b", "olmoe-1b-7b", "mixtral-8x22b", "zamba2-1.2b",
         "rwkv6-3b", "paligemma-3b")
WS = (2, 4)
MODES = ("auto", "ring")
B, MAX_LEN, STEPS = 2, 16, 4


def tokens(vocab):
    return np.random.default_rng(0).integers(
        1, vocab, (STEPS, B, 1)).astype(np.int32)


def _oracle(path):
    """The JAX half: every family's parameters, its per-rank shard
    shapes under ``param_shardings`` and its sharded serve step's logits
    at each W and mode."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import get_config, smoke_config
    from repro.distributed.sharding_rules import rules_for
    from repro.launch import steps
    from repro.models import lm
    from test_torch_recurrent_engine import nonzero_inits

    def keyed(prefix, tree):
        return {prefix + ".".join(str(x.key) for x in k): v
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    out = {}
    for arch in ARCHS:
        cfg = smoke_config(get_config(arch)).replace(dtype=jnp.float32)
        params = jax.tree.map(jnp.asarray, nonzero_inits(jax.tree.map(
            np.asarray, lm.init_params(jax.random.PRNGKey(0), cfg))))
        out.update({k: np.asarray(v)
                    for k, v in keyed(f"{arch}/p/", params).items()})
        toks = tokens(cfg.vocab_size)
        for W in WS:
            mesh = jax.make_mesh((1, W), ("data", "model"),
                                 devices=jax.devices()[:W],
                                 axis_types=(AxisType.Auto,) * 2)
            rules = rules_for(cfg, mesh)
            for mode in MODES:
                fn, ctx, psh = steps.jitted_serve_step(cfg, mesh, mode)
                if mode == MODES[0]:
                    shapes = jax.tree.map(
                        lambda s, x: np.array(s.shard_shape(x.shape)),
                        psh, params)
                    out.update(keyed(f"{arch}/{W}/shape/", shapes))
                st = lm.init_decode_state(params, cfg, B, MAX_LEN)
                with mesh:
                    st = jax.device_put(st, steps.decode_state_shardings(
                        cfg, rules, st))
                    p = jax.device_put(params, psh)
                    step = jax.jit(fn)
                    for i in range(STEPS):
                        lg, st = step(p, jnp.asarray(toks[i]), st)
                        out[f"{arch}/{W}/{mode}/{i}"] = np.asarray(
                            lg, np.float32)
    np.savez(path, **out)


if __name__ == "__main__":
    _oracle(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------------ the port
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import collective_matmul as cm  # noqa: E402
from repro_torch.distributed import context as dctx  # noqa: E402
from repro_torch.distributed import sharding_rules as sr  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.module import tree_items  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
LOGIT_TOL = dict(rtol=2 ** -7, atol=1e-4)
SERVE_CASES = [(a, W, m) for a in ARCHS for W in WS for m in MODES]


@pytest.fixture(scope="module", autouse=True)
def oracle_run(tmp_path_factory):
    """Starts the JAX half when the module's first test starts."""
    out = tmp_path_factory.mktemp("oracle") / "sharded_decode.npz"
    # one compute thread: the oracle's arrays are tiny, and it runs
    # beside the port's tests
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]),
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{max(WS)} --xla_cpu_multi_thread_eigen=false "
                         f"intra_op_parallelism_threads=1")
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


def _cfg(arch, **kw):
    return smoke_config(get_config(arch)).replace(dtype=torch.float32,
                                                  **kw)


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


def _mesh(W):
    return make_mesh(W, device="cpu")


def _shardings(tree, prefix=""):
    """``{dotted path: leaf}`` of a ``steps`` sharding tree (its leaves
    are the dicts holding "dim")."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update({path: v} if "dim" in v else _shardings(v, path))
    return out


# ------------------------------------------------- the engine over shards
REQS = [(5, 0), (11, 1), (3, 1), (9, 3)]     # (prompt length, arrival)


def _serve(params, cfg, ctx, K):
    rng = np.random.default_rng(7)
    with dctx.use(ctx):
        eng = Engine(params, cfg, batch=4, max_len=64, block_size=4,
                     prefill_chunk=4, decode_steps=K, device="cpu")
        for rid, (n, at) in enumerate(REQS):
            eng.submit(Request(rid=rid, prompt=[
                int(t) for t in rng.integers(1, cfg.vocab_size, n)],
                max_new_tokens=6), at_tick=at)
        done = []
        while eng.queue or eng.active:
            done += eng.tick()
    assert len(done) == len(REQS)
    return {r.rid: r.out_tokens for r in done}


@pytest.mark.parametrize("K", [1, 8])
def test_engine_over_shards_streams_equal_replicated_and_tp1(K):
    """Paged pool, 4 ranks, every fusion mode: the engine built on
    ``lm.shard_params`` and on one LM (replicated once per device) serve
    the same greedy streams as one rank (2 layers)."""
    cfg = _cfg("llama3-8b", n_layers=2)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    want = _serve(params, cfg, dctx.DistContext(), K)
    mesh = _mesh(4)
    shards = tlm.shard_params(params, mesh)
    for mode in ("auto", "bsp", "ring", "pallas"):
        ctx = dctx.DistContext(mesh, mode)
        assert _serve(params, cfg, ctx, K) == want, f"replicated {mode}"
        assert _serve(shards, cfg, ctx, K) == want, f"shards {mode}"


@pytest.mark.parametrize("arch", ARCHS[1:])
def test_engine_over_shards_every_family(arch):
    """Every other family over 2 ranks under ``pallas``, K = 8: the
    streams over shards equal tp 1's (2 layers: zamba2's one shared
    block call)."""
    cfg = _cfg(arch, n_layers=2)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    want = _serve(params, cfg, dctx.DistContext(), 8)
    mesh = _mesh(2)
    got = _serve(tlm.shard_params(params, mesh), cfg,
                 dctx.DistContext(mesh, "pallas"), 8)
    assert got == want


# ------------------------------------------- storage and the collectives
def test_serving_shards_share_replicated_leaves_per_device():
    """Serving shards: one copy of a replicated leaf per distinct device
    (its ranks hold the same storage), the sharded leaves 1/W each, the
    serving storage dtypes kept; training shards keep a copy a rank."""
    cfg = smoke_config(get_config("llama3-8b"))
    mesh = _mesh(4)
    serve = tlm.shard_params(tlm.init_params(cfg, seed=0, device="cpu"),
                             mesh)
    train = tlm.shard_params(tlm.init_params(cfg, seed=0, device="cpu",
                                             trainable=True), mesh)
    dims = tlm.shard_dims(cfg, mesh)
    for path, x in tree_items(tlm.param_tree(serve[0])):
        other = dict(tree_items(tlm.param_tree(serve[1])))[path]
        same = x.untyped_storage().data_ptr() == \
            other.untyped_storage().data_ptr()
        assert same == (dims[path] is None), path
        assert x.dtype == tlm.storage_dtype(path, cfg), path
    t0, t1 = (dict(tree_items(tlm.param_tree(t))) for t in train[:2])
    assert all(t0[p].untyped_storage().data_ptr()
               != t1[p].untyped_storage().data_ptr() for p in t0)


def _row_parallel_weights(cfg):
    """Bytes of every row-parallel weight a decode step reads, once per
    layer call (wo and wd of each attention block; olmoe/mixtral's
    experts are not that site; Mamba2's out_proj; none in rwkv)."""
    d, f = cfg.d_model, cfg.d_ff
    wo = cfg.n_heads * cfg.hd * d * 4
    if cfg.block == "rwkv":
        return []
    if cfg.block == "mamba_hybrid":
        d_in = cfg.ssm_expand * d
        calls = cfg.n_layers // cfg.attn_every
        return [d_in * d * 4] * cfg.n_layers + [wo, f * d * 4] * calls
    if cfg.block == "attn_moe":
        return [wo] * cfg.n_layers
    return [wo, f * d * 4] * cfg.n_layers


@pytest.mark.parametrize("mode", ["auto", "bsp", "ring", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_row_parallel_site_gathers_weights_off_auto(arch, mode):
    """One decode step at W = 4: under ``auto`` no all-gather of a
    weight's size (partial products, all-reduced); under ``bsp``,
    ``ring`` and ``pallas`` one all-gather of each row-parallel weight a
    layer (JAX's HLO gathers ``wo``/``wd``/``out_proj`` under ``ring``).
    rwkv's channel mix is one all-reduce a block in every mode."""
    cfg = _cfg(arch)
    mesh = _mesh(4)
    shards = tlm.shard_params(tlm.init_params(cfg, seed=0, device="cpu"),
                              mesh)
    events = []
    with dctx.use(dctx.DistContext(mesh, mode)), torch.no_grad():
        st = tlm.init_decode_state(shards, cfg, B, MAX_LEN)
        with cm.recording(lambda op, size, g: events.append((op, size))):
            tlm.decode_step(shards, torch.from_numpy(
                tokens(cfg.vocab_size)[0]), st, cfg)
    weights = _row_parallel_weights(cfg)
    small = min(weights, default=1 << 30)
    gathered = sorted(s for op, s in events
                      if op == "all-gather" and s >= small)
    assert gathered == ([] if mode == "auto" else sorted(weights))
    reduces = sum(op == "all-reduce" for op, _ in events)
    if cfg.block == "rwkv":
        assert reduces == cfg.n_layers
    elif mode == "auto":
        assert reduces >= len(weights)


def test_decode_state_shardings_split_the_kv_sequence():
    """The KV caches split on their sequence dim (``kv_seq``), the
    recurrent state and ``cur_len`` replicated; the batch replicated."""
    mesh = _mesh(4)
    for arch in ("llama3-8b", "zamba2-1.2b", "rwkv6-3b"):
        cfg = _cfg(arch)
        rules = sr.rules_for(cfg, mesh)
        specs = tsteps.decode_state_specs(cfg, B, MAX_LEN)
        sh = _shardings(tsteps.decode_state_shardings(cfg, rules, specs))
        assert sh
        for path, v in sh.items():
            kv = path.endswith((".k", ".v"))
            assert v["dim"] == (2 if kv else None), (arch, path)
        if arch == "llama3-8b":
            assert sh["caches.k"]["shape"] == (cfg.n_layers, B,
                                               MAX_LEN // 4, 1, cfg.hd)
        batch = tsteps.batch_sharding(rules, {"token": specs["cur_len"]})
        assert batch["token"]["dim"] is None


@pytest.mark.parametrize("arch", ["llama3-8b", "olmoe-1b-7b", "zamba2-1.2b",
                                  "rwkv6-3b", "paligemma-3b"])
def test_dryrun_decode_cell_param_bytes_are_the_shards(arch):
    """The dry run builds a decode cell on shards: at W = 2 its per-rank
    parameter bytes equal the real serving shards' (one fake device a
    rank, so each holds its replicated leaves), and fall below the
    whole model's."""
    cfg = smoke_config(get_config(arch))
    params = tlm.init_params(cfg, device="cpu")
    shards = tlm.shard_params(params, _mesh(2))
    want = [sum(p.numel() * p.element_size() for p in s.parameters())
            for s in shards]
    t = dryrun.trace(cfg, ShapeConfig("d", 64, 2, "decode"), 2)
    assert t["param_bytes"] == max(want)
    assert t["param_bytes_all_ranks"] == sum(want)
    whole = sum(p.numel() * p.element_size() for p in params.parameters())
    assert t["param_bytes"] < whole


# --------------------------------------------------- the port against JAX
@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shapes_equal_jax_param_shardings(jx, arch, W):
    """Every rank's leaf shapes (``lm.shard_params`` of the converted
    JAX parameters) and ``steps.param_shardings``' shapes equal JAX's
    ``shard_shape`` under ``param_shardings``."""
    cfg = _cfg(arch)
    mesh = _mesh(W)
    want = {k: tuple(v) for k, v in tree_items(_tree(jx, f"{arch}/{W}/"
                                                          f"shape/"))}
    shards = params_from_numpy(_tree(jx, f"{arch}/p/"), cfg, mesh=mesh)
    for r, s in enumerate(shards):
        got = {k: tuple(v.shape) for k, v in tree_items(tlm.param_tree(s))}
        assert got == want, f"rank {r}"
    psh = tsteps.param_shardings(cfg, sr.rules_for(cfg, mesh))
    assert {k: tuple(v["shape"]) for k, v in _shardings(psh).items()} == \
        want


@pytest.mark.parametrize("arch,W,mode", SERVE_CASES)
def test_sharded_serve_step_matches_jax(jx, arch, W, mode):
    """``steps.jitted_serve_step``'s function on the shards of the JAX
    parameters over the contiguous state: 4 steps' logits against JAX's
    sharded serve step within one bf16 ulp."""
    cfg = _cfg(arch)
    mesh = _mesh(W)
    fn, ctx, _ = tsteps.jitted_serve_step(cfg, mesh, mode)
    shards = params_from_numpy(_tree(jx, f"{arch}/p/"), cfg, mesh=mesh)
    with dctx.use(ctx):
        st = tlm.init_decode_state(shards, cfg, B, MAX_LEN)
    toks = tokens(cfg.vocab_size)
    for i in range(STEPS):
        lg, st = fn(shards, torch.from_numpy(toks[i]), st)
        np.testing.assert_allclose(lg.float().numpy(),
                                   jx[f"{arch}/{W}/{mode}/{i}"],
                                   err_msg=f"step {i}", **LOGIT_TOL)


# ------------------------------------------- which weights are a rank's
@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("arch", ARCHS)
def test_split_axes_name_what_param_shardings_split(arch, W):
    """``lm.split_axes`` (what the decode sites read) names, at every
    leaf, the logical axis of the dim ``steps.param_shardings`` splits,
    and None where it keeps the leaf whole; every rank of
    ``lm.shard_params`` carries it, whole weights carry None."""
    cfg = smoke_config(get_config(arch))
    mesh = _mesh(W)
    split = dict(tree_items(tlm.split_axes(cfg, mesh)))
    spec = dict(tree_items(tlm.lm_spec(cfg)))
    psh = _shardings(tsteps.param_shardings(cfg, sr.rules_for(cfg, mesh)))
    assert set(split) == set(psh)
    for path, v in psh.items():
        want = None if v["dim"] is None else spec[path].axes[v["dim"]]
        assert split[path] == want, path
    assert any(a is not None for a in split.values())
    assert not any(dict(tree_items(tlm.split_axes(cfg, None))).values())
    params = tlm.init_params(cfg, seed=0, device="cpu")
    assert params.split is None
    assert all(s.split == tlm.split_axes(cfg, mesh)
               for s in tlm.shard_params(params, mesh))
    assert all(r.split is None for r in tlm.replicate(params, mesh))


def test_decode_sites_refuse_a_weight_of_the_wrong_shape():
    """The row-parallel site checks the weight against what the caller
    says it is (a rank's row block or the whole), and the decode step
    refuses shards cut for another mesh: no shape is taken for a
    shard by guessing."""
    from repro_torch.core import patterns
    mesh = _mesh(2)
    x = [torch.ones(2, 1, 8)] * 2
    with dctx.use(dctx.DistContext(mesh, "auto")):
        with pytest.raises(ValueError, match="row block"):
            patterns.project_k_sharded(x, [torch.ones(8, 4)] * 2, rows=True)
        with pytest.raises(ValueError, match="whole"):
            patterns.project_k_sharded(x, [torch.ones(4, 4)] * 2)
    cfg = _cfg("llama3-8b", n_layers=1)
    shards = tlm.shard_params(tlm.init_params(cfg, seed=0, device="cpu"),
                              _mesh(4))
    with dctx.use(dctx.DistContext(mesh, "auto")), torch.no_grad():
        st = tlm.init_decode_state(tlm.init_params(cfg, device="cpu"), cfg,
                                   B, MAX_LEN)
        with pytest.raises(ValueError, match="4 parameter trees"):
            tlm.decode_step(shards, torch.ones(B, 1, dtype=torch.long), st,
                            cfg)
