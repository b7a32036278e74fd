"""Serving over a data x model mesh: the port's serve step with the
weights-stationary decode (each rank's shards, ``lm.shard_params``: the
weights' ``embed`` dim cut over ``data``, every product a local partial
dot plus a small sum or join over ``data``; the KV caches' and the
recurrent state's batch on ``("pod", "data")``) against the JAX
package's ``jitted_serve_step`` on the same (data, model) mesh, for
every family JAX decodes (smoke llama3-8b at (2, 1), (2, 2) and (4, 1)
under ``auto`` and ``ring``; olmoe-1b-7b, mixtral-8x22b, zamba2-1.2b,
rwkv6-3b and paligemma-3b at (2, 2) under ``auto``; float32; over the
contiguous state and over the paged state with a fixed block table);
the per-rank weight, cache and recurrent-state shapes against JAX's
shard shapes; the engine on data meshes against one rank; the
collectives a data-mesh step records; what raises.

The JAX half runs in one subprocess, this file's ``__main__`` block, on
4 fake CPU devices (set before JAX starts), on meshes whose axes are
``AxisType.Auto`` (the Explicit-mesh defect of ROADMAP queue 3), and
starts with the module's first test, so the port-only tests run while it
computes.

Tolerance, as in ``tests/test_torch_sharded_decode.py``: both packages
cast the fp32 unembed to bf16 logits, so an element on a bf16 rounding
boundary can come out one bf16 ulp apart (``2**-7`` relative); 1e-4
otherwise. Engine streams (greedy, float32) must be token-identical,
with equal counters.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np

ARCHS = ("llama3-8b", "olmoe-1b-7b", "mixtral-8x22b", "zamba2-1.2b",
         "rwkv6-3b", "paligemma-3b")
STATES = ("contiguous", "paged")
B, MAX_LEN, STEPS = 4, 16, 4
# the paged state: 16 blocks of 2 tokens, each slot's 4 table entries a
# fixed draw of distinct blocks (so each slot's blocks lie on several
# ranks)
N_BLOCKS, BLOCK, MAX_BLOCKS = 16, 2, 4
SERVE_CASES = ([("llama3-8b", m, mode, st) for m in ((2, 1), (2, 2), (4, 1))
                for mode in ("auto", "ring") for st in STATES]
               + [(a, (2, 2), "auto", st) for a in ARCHS[1:]
                  for st in STATES])


def tokens(vocab):
    return np.random.default_rng(0).integers(
        1, vocab, (STEPS, B, 1)).astype(np.int32)


def block_table():
    return np.random.default_rng(1).permutation(N_BLOCKS)[
        :B * MAX_BLOCKS].reshape(B, MAX_BLOCKS).astype(np.int32)


def _oracle(path):
    """The JAX half: every family's parameters, its per-rank shapes at
    (2, 2) under ``param_shardings`` and ``decode_state_shardings`` (both
    states), and its serve step's logits at each case."""
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

    def state(params, cfg, kind):
        if kind == "contiguous":
            return lm.init_decode_state(params, cfg, B, MAX_LEN)
        st = lm.init_paged_decode_state(params, cfg, B, N_BLOCKS, BLOCK,
                                        MAX_BLOCKS)
        return {**st, "block_tables": jnp.asarray(block_table())}

    out = {}
    for arch in ARCHS:
        cfg = smoke_config(get_config(arch)).replace(dtype=jnp.float32)
        params = jax.tree.map(jnp.asarray, nonzero_inits(jax.tree.map(
            np.asarray, lm.init_params(jax.random.PRNGKey(0), cfg))))
        out.update({k: np.asarray(v)
                    for k, v in keyed(f"{arch}/p/", params).items()})
        toks = tokens(cfg.vocab_size)
        for a, (D, M), mode, kind in SERVE_CASES:
            if a != arch:
                continue
            mesh = jax.make_mesh((D, M), ("data", "model"),
                                 devices=jax.devices()[:D * M],
                                 axis_types=(AxisType.Auto,) * 2)
            rules = rules_for(cfg, mesh)
            fn, ctx, psh = steps.jitted_serve_step(cfg, mesh, mode)
            st = state(params, cfg, kind)
            ssh = steps.decode_state_shardings(cfg, rules, st)
            if (D, M) == (2, 2) and mode == "auto":
                if kind == STATES[0]:
                    out.update(keyed(f"{arch}/shape/p/", jax.tree.map(
                        lambda s, x: np.array(s.shard_shape(x.shape)),
                        psh, params)))
                out.update(keyed(f"{arch}/shape/{kind}/", jax.tree.map(
                    lambda s, x: np.array(s.shard_shape(x.shape)), ssh,
                    st)))
            with mesh:
                st = jax.device_put(st, ssh)
                p = jax.device_put(params, psh)
                step = jax.jit(fn)
                for i in range(STEPS):
                    lg, st = step(p, jnp.asarray(toks[i]), st)
                    out[f"{arch}/{D}x{M}/{mode}/{kind}/{i}"] = np.asarray(
                        lg, np.float32)
    np.savez(path, **out)


if __name__ == "__main__":
    _oracle(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------------ the port
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import collective_matmul as cm  # noqa: E402
from repro_torch.distributed import context as dctx  # noqa: E402
from repro_torch.distributed import sharding_rules as sr  # noqa: E402
from repro_torch.kernels import symm  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_mesh_for_devices  # noqa: E402,E501
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.module import tree_items  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
LOGIT_TOL = dict(rtol=2 ** -7, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def oracle_run(tmp_path_factory):
    """Starts the JAX half when the module's first test starts."""
    out = tmp_path_factory.mktemp("oracle") / "data_serve.npz"
    # one compute thread: the oracle's arrays are tiny, and it runs
    # beside the port's tests
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    proc = subprocess.Popen([sys.executable, __file__, str(out)], env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def oracle(oracle_run):
    proc, out = oracle_run
    assert proc.wait(timeout=900) == 0, "the JAX oracle failed"
    with np.load(out) as z:
        return dict(z)


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


def _mesh(D, M):
    return make_mesh(M, ["cpu"] * (D * M))


def _state(params, cfg, kind, batch=B):
    """The port's decode state under the ambient mesh, the paged one
    with the oracle's block table."""
    if kind == "contiguous":
        return tlm.init_decode_state(params, cfg, batch, MAX_LEN)
    st = tlm.init_paged_decode_state(params, cfg, batch, N_BLOCKS, BLOCK,
                                     MAX_BLOCKS)
    tables = st["block_tables"]
    for t in tables if isinstance(tables, list) else [tables]:
        t.copy_(torch.from_numpy(block_table()[:batch]))
    return st


def _serve(params, cfg, mesh, mode, kind, toks):
    """The port's serve step (``launch.steps.jitted_serve_step``) over
    ``mesh`` on ``lm.shard_params``: the logits of each step."""
    fn, ctx, _ = tsteps.jitted_serve_step(cfg, mesh, mode)
    ps = params if mesh is None else tlm.shard_params(params, mesh)
    with dctx.use(ctx):
        st = _state(ps, cfg, kind, toks.shape[1])
    out = []
    for i in range(toks.shape[0]):
        lg, st = fn(ps, torch.from_numpy(toks[i]), st)
        out.append(lg.float().numpy())
    return np.stack(out)


# ---------------------------------------------------------- the engine
def _prompts(seed, *lens):
    r = np.random.default_rng(seed)
    return [[int(t) for t in r.integers(1, 512, n)] for n in lens]


_SHARED = _prompts(3, 24)[0]
# phases of (prompt, max_new, arrival tick), each run to completion: a
# prompt registered whole, then hit again (prefix hits, a copy-on-write
# of its last block), then three slots outgrowing 6 blocks (preemption)
PHASES = [[(_SHARED, 5, 0)],
          [(_SHARED + [9, 8, 7], 6, 0), (_SHARED, 5, 1),
           (_prompts(4, 5)[0], 7, 2)],
          [(p, 12, 0) for p in _prompts(5, 7, 7, 7)]]
KEYS = ("ticks", "dispatches", "decode_dispatches", "mixed_dispatches",
        "preemptions", "prefix_hits", "cow_copies")


def _drive(params, cfg, ctx, K):
    with dctx.use(ctx):
        eng = Engine(params, cfg, batch=3, max_len=64, prefill_chunk=4,
                     block_size=8, n_blocks=6, decode_steps=K,
                     device="cpu")
        streams, rid, done = {}, 0, []
        for phase in PHASES:
            for prompt, max_new, at in phase:
                eng.submit(Request(rid=rid, prompt=list(prompt),
                                   max_new_tokens=max_new), at_tick=at)
                rid += 1
            out = eng.run()
            done += out
            streams.update({r.rid: list(r.out_tokens) for r in out})
        m = eng.metrics(done)
    return streams, {k: m[k] for k in KEYS}


@pytest.fixture(scope="module")
def one_rank():
    """The (1, 1) engine's streams and counters at K = 1 and 8 (2
    layers)."""
    cfg = _cfg("llama3-8b", n_layers=2)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    return cfg, params, {K: _drive(params, cfg, dctx.DistContext(), K)
                         for K in (1, 8)}


MESHES = {"2x2": lambda: _mesh(2, 2), "4x1": lambda: _mesh(4, 1),
          "2px2dx1m": lambda: make_mesh_for_devices(4, 1, 2, device="cpu")}


@pytest.mark.parametrize("mode", ["auto", "bsp", "ring", "pallas"])
@pytest.mark.parametrize("mesh_name", ["2x2", "4x1"])
def test_engine_on_a_data_mesh_equals_one_rank(one_rank, mesh_name, mode):
    """The engine over a data mesh's shards serves the (1, 1) engine's
    greedy streams token for token at K = 8 (pure and mixed megaticks)
    and at K = 1 (the eager single step), with equal
    tick, dispatch, preemption, prefix-hit and copy-on-write counts
    (JAX's pool rounding: the 6 blocks hold as on one rank, the 4
    ranks' pool shards padded to 8)."""
    cfg, params, want = one_rank
    mesh = MESHES[mesh_name]()
    shards = tlm.shard_params(params, mesh)
    for K in (8, 1):
        got = _drive(shards, cfg, dctx.DistContext(mesh, mode), K)
        assert got == want[K], (K, got, want[K])
    assert want[1][1]["preemptions"] >= 1
    assert want[1][1]["prefix_hits"] >= 2 and want[1][1]["cow_copies"] >= 1


def test_engine_on_a_pod_data_model_mesh_equals_one_rank(one_rank):
    """(pod 2, data 2, model 1): the batch over both axes, the weights
    cut over ``data`` and copied over ``pod``; streams and counters as
    one rank's."""
    cfg, params, want = one_rank
    mesh = MESHES["2px2dx1m"]()
    assert mesh.shape == {"pod": 2, "data": 2, "model": 1}
    got = _drive(tlm.shard_params(params, mesh), cfg,
                 dctx.DistContext(mesh, "ring"), 8)
    assert got == want[8]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-1.2b",
                                  "rwkv6-3b"])
def test_engine_every_state_family_on_a_data_mesh(arch):
    """MoE and the recurrent families at (2, 2) under ``pallas``, K = 8:
    the streams over a data mesh's shards (the recurrent state one copy
    a data group, its rows) equal one rank's."""
    cfg = _cfg(arch, n_layers=2)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    want = _drive(params, cfg, dctx.DistContext(), 8)
    mesh = _mesh(2, 2)
    got = _drive(tlm.shard_params(params, mesh), cfg,
                 dctx.DistContext(mesh, "pallas"), 8)
    assert got == want


@pytest.mark.parametrize("kind", STATES)
def test_a_batch_that_does_not_divide_is_held_whole_by_each_group(kind):
    """3 slots over 2 data groups: each group holds (and steps) every
    slot, JAX's divisibility fallback; the logits equal one rank's."""
    cfg = _cfg("zamba2-1.2b", n_layers=2)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (3, 3, 1)).astype(np.int32)
    want = _serve(params, cfg, None, "auto", kind, toks)
    mesh = _mesh(2, 2)
    got = _serve(params, cfg, mesh, "ring", kind, toks)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    with dctx.use(dctx.DistContext(mesh)):
        st = _state(tlm.shard_params(params, mesh), cfg, kind, 3)
    rec = transformer.recurrent_part(cfg, st["caches"])
    assert len(rec["ssm"]) == 2 and rec["ssm"][0].shape[1] == 3


def _leaves(plan, prefix=""):
    """(dotted path, leaf) of a ``launch.steps`` sharding tree."""
    for k, v in plan.items():
        path = f"{prefix}.{k}" if prefix else k
        if "dim" in v:
            yield path, v
        else:
            yield from _leaves(v, path)


# ------------------------------------------------------ the collectives
def _weight_gather_bytes(cfg, mesh) -> int:
    """The fewest bytes an all-gather of any weight over ``data`` would
    record: the smallest model block of a leaf the data axis cuts."""
    dims = tlm.data_dims(cfg, mesh)
    specs = tlm.leaf_specs(cfg, mesh)
    out = None
    for path, leaf in tree_items(tsteps.param_specs(cfg, trainable=False)):
        if dims[path] is None:
            continue
        shape = sr.spec_shape(leaf.shape, specs[path], {"model":
                                                        mesh.model})
        n = int(np.prod(shape)) * leaf.element_size()
        out = n if out is None else min(out, n)
    return out


@pytest.mark.parametrize("mode", ["auto", "bsp", "ring", "pallas"])
def test_no_weight_is_gathered_over_data(mode):
    """A paged decode step on (data 2, model 4) records all-reduces and
    all-gathers over ``data`` (groups of 2) of activations only: none
    as large as a weight's model block (what a gather of the FSDP shards
    would record); row weights are gathered over ``model`` (groups of
    4) only where the mode needs the whole weight (bsp, ring, pallas)."""
    cfg = _cfg("llama3-8b")
    mesh = _mesh(2, 4)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    shards = tlm.shard_params(params, mesh)
    limit = _weight_gather_bytes(cfg, mesh)
    events = []
    with dctx.use(dctx.DistContext(mesh, mode)):
        st = _state(shards, cfg, "paged")
        with cm.recording(lambda op, size, g: events.append((op, size, g))):
            tlm.decode_step(shards, torch.ones((B, 1), dtype=torch.int32),
                            st, cfg)
    over_data = [(op, n) for op, n, g in events if g == 2]
    assert {op for op, _ in over_data} == {"all-reduce", "all-gather"}
    assert all(n < limit for _, n in over_data), (limit, over_data)
    big = [n for op, n, g in events
           if op == "all-gather" and g == 4 and n >= limit]
    assert bool(big) == (mode != "auto")


# ---------------------------------------------------------- what raises
def test_replicas_on_a_data_mesh_raise():
    """A data mesh decodes only on shards: one LM (the engine) or
    per-device replicas (the decode step) raise, naming
    ``lm.shard_params``."""
    cfg = _cfg("llama3-8b", n_layers=2)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    mesh = _mesh(2, 2)
    with dctx.use(dctx.DistContext(mesh)):
        with pytest.raises(ValueError, match="shard_params"):
            Engine(params, cfg, batch=2, max_len=16, device="cpu")
        st = tlm.init_decode_state(params, cfg, 2, 16)
        with pytest.raises(ValueError, match="shard_params"):
            tlm.decode_step(tlm.replicate(params, mesh),
                            torch.ones((2, 1), dtype=torch.int32), st, cfg)


def test_a_virtual_mesh_over_max_ranks_raises():
    """More ranks on one card than a fused launch takes
    (``symm.MAX_RANKS``, 8) raise with the limit named; 8 pass."""
    assert symm.MAX_RANKS == 8
    with pytest.raises(ValueError, match="MAX_RANKS=8"):
        symm.check_virtual_ranks([torch.device("cuda", 0)] * 16)
    symm.check_virtual_ranks([torch.device("cuda", 0)] * 8
                             + [torch.device("cuda", 1)] * 8)
    symm.check_virtual_ranks([torch.device("cpu")] * 16)


# -------------------------------------------------------------- dry run
def test_dry_run_traces_a_decode_cell_on_a_data_mesh():
    """The dry run's decode cell on (data 2, model 4), one data group's
    role traced: each of the role's ranks holds its shards (JAX's shard
    shapes) and its group's rows of the caches, and no all-gather over
    ``data`` (groups of 2) is a weight's."""
    from repro_torch.configs import ShapeConfig
    cfg = smoke_config(get_config("llama3-8b"))
    shape = ShapeConfig("decode_tiny", 32, 8, "decode")
    t = dryrun.trace(cfg, shape, 4, "pallas", data=2)
    mesh = dryrun.make_mesh(4, data=2)
    spec = dict(tree_items(tsteps.param_specs(cfg, trainable=False)))
    plan = tsteps.param_shardings(cfg, sr.rules_for(cfg, mesh))
    assert t["param_bytes"] == sum(
        int(np.prod(v["shape"])) * spec[k].element_size()
        for k, v in _leaves(plan))
    kv = 2 * cfg.n_layers * (8 // 2) * (32 // 4) * cfg.n_kv_heads * \
        cfg.hd * 2
    assert t["state_bytes"] == kv + 8 * 4
    limit = _weight_gather_bytes(cfg, mesh)
    over_data = [n for op, n, g in t["events"] if g == 2]
    assert over_data and max(over_data) < limit


# --------------------------------------------------- the CLIs and resume
def test_server_on_a_data_mesh_streams_as_one_rank(monkeypatch):
    """``launch.server``'s engine from ``--devices cpu,cpu,cpu,cpu --tp
    2`` (a (2, 2) mesh, each rank's shards) streams over real sockets
    what ``--tp 1`` on one device decodes (float32, greedy)."""
    import asyncio

    import repro_torch.configs as tconfigs
    from repro_torch.launch import server as server_mod
    from repro_torch.serving import client as cl
    monkeypatch.setattr(tconfigs, "smoke_config", lambda c: smoke_config(
        c).replace(dtype=torch.float32, n_layers=2))
    common = ["--arch", "llama3-8b", "--smoke", "--device", "cpu",
              "--batch", "2", "--max-len", "64", "--block-size", "8",
              "--fusion-mode", "pallas", "--decode-steps", "4"]
    prompts = ([11, 12, 13, 14, 15, 16, 17, 18, 19], [31, 32, 33, 34])

    def solo(p):
        eng = server_mod.build_engine(server_mod.make_parser().parse_args(
            common + ["--tp", "1"]))
        req = Request(rid=0, prompt=list(p), max_new_tokens=8)
        eng.submit(req)
        eng.run()
        return req.out_tokens

    async def run():
        args = server_mod.make_parser().parse_args(
            common + ["--devices", "cpu,cpu,cpu,cpu", "--tp", "2"])
        eng = server_mod.build_engine(args)
        assert eng.ctx.mesh.shape == {"data": 2, "model": 2}
        srv = server_mod.Server(eng, port=0)
        await srv.start()
        try:
            return await asyncio.gather(*[
                cl.complete(srv.host, srv.port, list(p), max_new_tokens=8)
                for p in prompts])
        finally:
            await srv.stop()

    outs = asyncio.run(run())
    assert [o.token_ids for o in outs] == [solo(p) for p in prompts]


def test_snapshot_and_restore_on_a_data_mesh(tmp_path):
    """The robustness plane on (2, 2): an engine drained into a
    checkpoint mid-run (the pool split over the 4 ranks, the recurrent
    state one copy a data group) and restored into a fresh engine on
    the same mesh finishes every stream as the uninterrupted one."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    cfg = _cfg("zamba2-1.2b", n_layers=2)
    mesh = _mesh(2, 2)
    shards = tlm.shard_params(tlm.init_params(cfg, seed=0, device="cpu"),
                              mesh)
    prompts = _prompts(8, 9, 6)

    def engine():
        return Engine(shards, cfg, batch=2, max_len=48, prefill_chunk=4,
                      block_size=4, n_blocks=16, decode_steps=4,
                      device="cpu")

    with dctx.use(dctx.DistContext(mesh, "ring")):
        ref = engine()
        for i, p in enumerate(prompts):
            ref.submit(Request(rid=i, prompt=p, max_new_tokens=10))
        want = {r.rid: r.out_tokens for r in ref.run()}
        eng = engine()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=10))
        for _ in range(3):
            eng.tick()
        eng.snapshot(Checkpointer(str(tmp_path)))
        fresh = engine()
        fresh.restore(Checkpointer(str(tmp_path)))
        got = {r.rid: r.out_tokens for r in fresh.run()}
    assert got == want


# the tests that need the JAX half come last, so that the port-only
# ones above run while it computes
# ------------------------------------------- the serve step against JAX
@pytest.mark.parametrize("arch,dm,mode,kind", SERVE_CASES)
def test_serve_step_matches_jax_on_a_data_mesh(oracle, arch, dm, mode,
                                                kind):
    """The serve step on a (data, model) mesh of virtual ranks, every
    weight a rank's shard, equals JAX's serve step on the same Auto-axis
    mesh, step by step (4 steps, 4 slots)."""
    cfg = _cfg(arch)
    params = params_from_numpy(_tree(oracle, f"{arch}/p/"), cfg,
                               device="cpu")
    got = _serve(params, cfg, _mesh(*dm), mode, kind,
                 tokens(cfg.vocab_size))
    D, M = dm
    for i in range(STEPS):
        np.testing.assert_allclose(
            got[i], oracle[f"{arch}/{D}x{M}/{mode}/{kind}/{i}"],
            **LOGIT_TOL, err_msg=f"{arch} {dm} {mode} {kind} step {i}")


# ------------------------------------------------------ per-rank shapes
@pytest.mark.parametrize("arch", ARCHS)
def test_per_rank_shapes_equal_jax_shard_shapes(oracle, arch):
    """At (2, 2): every rank's weight shards (``lm.shard_params``) have
    JAX's ``param_shardings`` shard shapes; the contiguous state's KV
    caches and recurrent leaves (per rank, and per data group's copy)
    JAX's ``decode_state_shardings`` shard shapes, as
    ``steps.decode_state_shardings`` says; the paged pool a rank holds
    at most JAX's shard bytes."""
    cfg = _cfg(arch)
    mesh = _mesh(2, 2)
    shards = tlm.shard_params(tlm.init_params(cfg, device="cpu"), mesh)
    for r, p in enumerate(shards):
        for path, x in tree_items(tlm.param_tree(p)):
            want = tuple(oracle[f"{arch}/shape/p/{path}"])
            assert tuple(x.shape) == want, (r, path)
    rules = sr.rules_for(cfg, mesh)
    with dctx.use(dctx.DistContext(mesh)):
        cont = _state(shards, cfg, "contiguous")
        paged = _state(shards, cfg, "paged")
    plan = tsteps.decode_state_shardings(
        cfg, rules, tsteps.decode_state_specs(cfg, B, MAX_LEN))
    kv = transformer.kv_part(cfg, cont["caches"]) or {}
    rec = transformer.recurrent_part(cfg, cont["caches"]) or {}
    for part, name in ((kv, "attn" if cfg.block == "mamba_hybrid" else None),
                       (rec, "mamba" if cfg.block == "mamba_hybrid"
                        else None)):
        for leaf, per in part.items():
            path = ".".join(x for x in ("caches", name, leaf) if x)
            want = tuple(oracle[f"{arch}/shape/contiguous/{path}"])
            node = plan
            for k in path.split("."):
                node = node[k]
            assert tuple(node["shape"]) == want, path
            assert {tuple(t.shape) for t in per} == {want}, path
    for leaf, per in (transformer.kv_part(cfg, paged["caches"])
                      or {}).items():
        path = ".".join(x for x in ("caches", "attn" if cfg.block ==
                                    "mamba_hybrid" else None, leaf) if x)
        jax_bytes = int(np.prod(oracle[f"{arch}/shape/paged/{path}"])) * 4
        assert len(per) == mesh.size
        assert all(cm.nbytes(t) <= jax_bytes for t in per), path
