"""Serving with the ``model`` axis over processes
(``repro_torch.distributed.processes``, ``Mesh.split``): spawned CPU
processes in one gloo job (a ``file://`` rendezvous, the pool of
``tests/test_torch_processes.py``), each holding a block of the model
ranks of one (1, W) mesh, against the same run in one process and
against JAX.

* (a) llama3-8b smoke (float32) at tp 2 over 2 processes (1 rank each)
  and at tp 4 (2 each), under each of the four modes: 4 serve steps'
  logits over the contiguous and the paged state bit-identical to the
  one-process ``--tp W`` step, and the engine's greedy streams
  token-identical at K = 1 and K = 4;
* (b) olmoe-1b-7b smoke at tp 2 over 2 processes, ``auto`` and
  ``pallas``: the same;
* (c) the 2-process tp 2 logits from JAX's parameters against JAX's
  ``jitted_serve_step`` at tp 2 (``auto``), within
  ``tests/test_torch_sharded_decode.py``'s tolerance: one bf16 ulp on a
  rounding boundary (``2**-7`` relative), 1e-4 otherwise;
* (d) ``launch.serve`` over 2 processes against one process: the same
  streams, and only process 0 prints;
* (e) the rank maps of the ``model`` split, and the refusals before any
  parameter is drawn: serving data groups over processes, the trainer,
  the families outside the slice.

On the CPU what crosses processes goes over the gloo link of the model
peers (``kernels.symm.every_rank``); every cross-process value is a
gather or a sum made in rank order in every process, so the values are
the one-process ones bit for bit. The JAX half runs in one subprocess,
this file's ``__main__``, on 2 fake devices with Auto axes, started with
the module's first test.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np

B, MAX_LEN, STEPS = 2, 16, 4


def _oracle(path):
    """The JAX half: llama3-8b smoke's parameters (float32, no zero
    leaves) and its sharded serve step's logits at W = 2 (``auto``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import get_config, smoke_config
    from repro.distributed.sharding_rules import rules_for
    from repro.launch import steps
    from repro.models import lm
    from test_torch_recurrent_engine import nonzero_inits

    cfg = smoke_config(get_config("llama3-8b")).replace(dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, nonzero_inits(jax.tree.map(
        np.asarray, lm.init_params(jax.random.PRNGKey(0), cfg))))
    out = {"p/" + ".".join(str(x.key) for x in k): np.asarray(v)
           for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    toks = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    mesh = jax.make_mesh((1, 2), ("data", "model"),
                         devices=jax.devices()[:2],
                         axis_types=(AxisType.Auto,) * 2)
    fn, ctx, psh = steps.jitted_serve_step(cfg, mesh, "auto")
    st = lm.init_decode_state(params, cfg, B, MAX_LEN)
    with mesh:
        st = jax.device_put(st, steps.decode_state_shardings(
            cfg, rules_for(cfg, mesh), st))
        p = jax.device_put(params, psh)
        step = jax.jit(fn)
        for i in range(STEPS):
            lg, st = step(p, jnp.asarray(toks[i]), st)
            out[f"logits/{i}"] = np.asarray(lg, np.float32)
    np.savez(path, **out)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _oracle(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------------ the port
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import torch_processes_worker as worker  # noqa: E402
from test_torch_processes import Job, Pool  # noqa: E402

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.distributed import processes  # noqa: E402
from repro_torch.distributed.context import Mesh  # noqa: E402

torch.set_num_threads(1)        # the pool's processes run one thread too
REPO = pathlib.Path(__file__).resolve().parents[1]
MODES = ("auto", "bsp", "ring", "pallas")
LOGIT_TOL = dict(rtol=2 ** -7, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def oracle_run(tmp_path_factory):
    """Starts the JAX half with the module's first test."""
    out = tmp_path_factory.mktemp("oracle") / "model_processes.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]),
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    proc = subprocess.Popen([sys.executable, __file__, str(out)], env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jx(oracle_run):
    proc, out = oracle_run
    assert proc.wait(timeout=300) == 0, "the JAX half failed"
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    made = []

    def get():
        if not made or not made[-1].alive():
            made.append(Pool(tmp_path_factory.mktemp("pool")))
        return made[-1]
    yield get
    for p in made:
        p.close()


def _same_logits(two, one):
    for r, got in enumerate(two):
        assert len(got) == len(one)
        for i, (a, b) in enumerate(zip(got, one)):
            assert torch.equal(a, b), f"process {r}, step {i}"


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("W", [2, 4])
def test_serve_steps_over_processes_equal_one_process(pool, W, mode, paged):
    """(a) 4 decode steps of the llama3-8b smoke (float32) at tp W over 2
    processes (W / 2 ranks each), born sharded: every process's logits
    bit-identical to one process's ``--tp W`` step."""
    job = pool().submit("serve_steps", W=W, mode=mode, paged=paged)
    one = worker.serve_steps(W=W, mode=mode, paged=paged)
    _same_logits(job.results(), one)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("W", [2, 4])
def test_engine_over_processes_streams_equal_one_process(pool, W, mode, K):
    """(a) The engine (paged pool, staggered arrivals, greedy, megaticks
    of K) over 2 processes: the streams of one process's ``--tp W``
    engine, in every process (which also agree over the store at the
    end of the run)."""
    job = pool().submit("serve_engine", W=W, mode=mode, K=K)
    one = worker.serve_engine(W=W, mode=mode, K=K)
    two = job.results()
    assert two[0] == two[1] == one
    assert all(len(t) == 6 for t in one.values())


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_moe_over_processes_equals_one_process(pool, mode):
    """(b) olmoe-1b-7b smoke at tp 2 over 2 processes: the MoE decode's
    all-reduce crosses them; logits bit-identical, streams at K = 1 and
    4 token-identical."""
    arch = "olmoe-1b-7b"
    job = pool().submit("serve_steps", arch=arch, W=2, mode=mode)
    one = worker.serve_steps(arch=arch, W=2, mode=mode)
    _same_logits(job.results(), one)
    for K in (1, 4):
        job = pool().submit("serve_engine", arch=arch, W=2, mode=mode, K=K)
        one = worker.serve_engine(arch=arch, W=2, mode=mode, K=K)
        two = job.results()
        assert two[0] == two[1] == one


def test_mixtral_over_processes_equals_one_process(pool):
    """(b) mixtral-8x22b smoke (its ``expert_mlp`` columns over the ranks)
    at tp 4 over 2 processes under ``pallas``, paged: logits
    bit-identical to one process's."""
    kw = dict(arch="mixtral-8x22b", W=4, mode="pallas", paged=True)
    job = pool().submit("serve_steps", **kw)
    one = worker.serve_steps(**kw)
    _same_logits(job.results(), one)


@pytest.mark.parametrize("src,dst", [(1, 6), (5, 0), (4, 5), (0, 3)],
                         ids=["p0-to-p1", "p1-to-p0", "in-p1", "in-p0"])
def test_copy_on_write_over_processes(pool, src, dst):
    """(a) The engine's copy-on-write of a pool block whose source and
    destination lie in different processes (one exchange) or in one:
    every rank's pool as one process leaves it."""
    job = pool().submit("copy_block", W=4, src=src, dst=dst)
    one = worker.copy_block(W=4, src=src, dst=dst)
    two = job.results()
    assert all(torch.equal(a, b)
               for a, b in zip(two[0] + two[1], one))


# ------------------------------------------------------------------ (c)
def test_two_processes_match_jax_serve_step(tmp_path, jx, pool):
    """(c) JAX's parameters at tp 2 over 2 processes: 4 steps' logits
    within one bf16 ulp of JAX's ``jitted_serve_step`` at tp 2, and
    bit-identical to the same steps in one process."""
    tree = tmp_path / "tree.npz"
    np.savez(tree, **{k: v for k, v in jx.items() if k.startswith("p/")})
    job = pool().submit("serve_steps", W=2, tree_file=str(tree))
    one = worker.serve_steps(W=2, tree_file=str(tree))
    two = job.results()
    _same_logits(two, one)
    for i, lg in enumerate(two[0]):
        np.testing.assert_allclose(lg.numpy(), jx[f"logits/{i}"],
                                   err_msg=f"step {i}", **LOGIT_TOL)


# ------------------------------------------------------------------ (d)
def test_serve_cli_over_processes(pool):
    """(d) ``launch.serve`` at ``--tp 2`` over 2 processes (one rank
    each) serves one process's streams; process 0 alone prints."""
    argv = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--tp",
            "2", "--fusion-mode", "pallas", "--requests", "3", "--max-new",
            "4", "--decode-steps", "2"]
    job = pool().submit("serve_cli", argv=argv)
    one = worker.serve_cli(argv)
    two = job.results()
    assert two[0]["streams"] == two[1]["streams"] == one["streams"]
    assert "[serve]" in two[0]["printed"] and two[1]["printed"] == ""
    assert "'processes': 2" in two[0]["printed"]


# ------------------------------------------------------------------ (e)
@pytest.mark.parametrize("shape,world,S,blocks", [
    ({"data": 1, "model": 4}, 2, 2, [range(0, 2), range(2, 4)]),
    ({"data": 1, "model": 2}, 2, 2, [range(0, 1), range(1, 2)]),
    ({"data": 1, "model": 4}, 4, 4, [range(r, r + 1) for r in range(4)]),
    ({"data": 2, "model": 4}, 4, 2,
     [range(0, 2), range(2, 4), range(4, 6), range(6, 8)]),
    ({"data": 2, "model": 2}, 2, 1, [range(0, 2), range(2, 4)])],
    ids=["1x4/2", "1x2/2", "1x4/4", "2x4/4", "2x2/2"])
def test_model_split_rank_maps(shape, world, S, blocks):
    """(e) Process p holds the consecutive ranks [p n, (p + 1) n): a block
    of W / S of its group's model ranks where S processes share a group,
    whole groups otherwise (the trainer's layout); its model peers are the S
    processes of its group, its data peers those of the same block."""
    for p in range(world):
        assert processes.model_split(shape, world) == S
        assert processes.process_ranks(shape, world, p) == blocks[p]
        g = p // S if S > 1 else None
        if S > 1:
            assert processes.peers(shape, world, p, "model") == tuple(
                range(g * S, (g + 1) * S))
            assert processes.peers(shape, world, p, "data") == tuple(
                q for q in range(world) if q % S == p % S)
        else:
            assert processes.peers(shape, world, p, "model") == (p,)
            G = shape["data"] // world
            assert processes.peers(shape, world, p, "data") == (
                tuple(range(world)) if G < shape["data"] else (p,))
        # the ranks a model rank's data sums span, and the processes
        # that hold them: its data peers
        mesh = Mesh(["cpu"] * len(blocks[p]), tuple(shape.values()),
                    tuple(shape), processes.Processes(p, world))
        W = shape["model"]
        assert mesh.span(mesh.ranks) is mesh      # its own communicator
        for r in blocks[p]:
            span = mesh.axis_span(r, "data")
            want = tuple(range(r % W, mesh.size, W))
            assert span.ranks == want
            if shape["data"] > 1:
                assert span.spans and span.peers == processes.peers(
                    shape, world, p, "data")
                assert r // W in span.local
                assert len(span.local) * len(span.peers) == span.size


def test_align_waits_for_every_process_of_the_mesh(monkeypatch):
    """(e) ``processes.align``, at ``Engine.run`` and each graph capture:
    over processes a barrier on the job's store over every process of
    the mesh (each call its own key, alike in every process); in one
    process nothing."""
    class Store:
        def __init__(self):
            self.set_keys, self.got = [], []

        def set(self, key, value):
            self.set_keys.append(key)

        def get(self, key):
            self.got.append(key)
            return b"1"
    store = Store()
    monkeypatch.setattr(processes, "_store", lambda: store)
    processes.align(None, "run")
    processes.align(Mesh(["cpu"] * 4, (2, 2), ("data", "model")), "run")
    assert store.set_keys == store.got == []
    for p in range(2):
        mesh = Mesh(["cpu"] * 2, (2, 2), ("data", "model"),
                    processes.Processes(p, 2))
        processes.align(mesh, "run")
        key = store.set_keys[-1].rsplit("/", 1)[0]
        assert store.set_keys[-1] == f"{key}/{p}"
        assert store.got[-2:] == [f"{key}/0", f"{key}/1"]
    processes.align(mesh, "run")
    assert store.set_keys[-1] != f"{key}/1"


def test_serving_refuses_a_mesh_wider_than_a_span():
    """(e) Over processes a serving collective spans up to the whole mesh
    (the paged pool's combine), and the exchange and the fused kernels
    take a 32-bit mask of ranks: a mesh of more than
    ``processes.MAX_SPAN`` ranks refuses before any draw, naming the
    limit; 32 ranks serve, and one process is not limited."""
    cfg = smoke_config(get_config("llama3-8b"))
    with pytest.raises(ValueError, match="MAX_SPAN=32"):
        processes.check_model_split({"data": 4, "model": 16}, 4,
                                    what="serve", cfg=cfg)
    with pytest.raises(ValueError, match="MAX_SPAN=32"):
        processes.check_model_split({"data": 1, "model": 64}, 2,
                                    what="serve", cfg=cfg)
    processes.check_model_split({"data": 2, "model": 16}, 2, what="serve",
                                cfg=cfg)
    processes.check_model_split({"data": 4, "model": 16}, 1, what="serve",
                                cfg=cfg)
    processes.check_model_split({"data": 4, "model": 16}, 4, what="train")


def test_mesh_over_model_processes():
    """(e) A (1, 4) mesh over 2 processes: the job's size and shape, this
    process's 2 ranks and devices, the leaders of both processes."""
    for p in range(2):
        mesh = Mesh(["cpu"] * 2, (1, 4), ("data", "model"),
                    processes.Processes(p, 2))
        assert (mesh.size, mesh.model, mesh.split) == (4, 4, 2)
        assert mesh.local == range(2 * p, 2 * p + 2)
        assert list(mesh.local_groups) == [0]
        assert len(mesh.devices) == 2 and mesh.leaders == (0,)
        assert mesh.job_leaders == (0, 2)
        assert mesh.per_rank(["x"]) == ["x", "x"]
    with pytest.raises(ValueError, match="split neither"):
        processes.model_split({"data": 1, "model": 4}, 3)


@pytest.mark.parametrize("case", ["serve_data", "serve_zamba2",
                                  "serve_rwkv6", "serve_paligemma",
                                  "train"])
def test_refusals_before_any_draw(pool, tmp_path, case):
    """(e) Over 2 processes (``serve_data``: 4, a (2, 2) mesh whose model
    axis they split), each refuses before any parameter is drawn, naming
    the ROADMAP item that carries it: the families outside the slice
    over a split model axis, on a mesh with data groups too; the trainer
    over a split model axis."""
    cpu = ["--smoke", "--device", "cpu"]
    entry, argv, item = {
        "serve_data": ("serve", ["--arch", "zamba2-1.2b", *cpu, "--tp",
                                 "2", "--devices", "cpu"], "1d"),
        "serve_zamba2": ("serve", ["--arch", "zamba2-1.2b", *cpu, "--tp",
                                   "2"], "1d"),
        "serve_rwkv6": ("serve", ["--arch", "rwkv6-3b", *cpu, "--tp", "2"],
                        "1d"),
        "serve_paligemma": ("serve", ["--arch", "paligemma-3b", *cpu,
                                      "--tp", "2"], "1d"),
        "train": ("train", ["--arch", "llama3-8b", *cpu, "--tp", "2",
                            "--devices", "cpu", "--steps", "1"], "1b")}[case]
    if case == "serve_data":
        res = Job(tmp_path, "refused", world=4, entry=entry,
                  argv=argv).results()
    else:
        res = pool().submit("refused", entry=entry, argv=argv).results()
    for r in res:
        assert r["msg"] is not None and not r["drawn"], r
        assert f"ROADMAP queue 1, item {item}" in r["msg"], r["msg"]


@pytest.mark.parametrize("arch,ok", [("llama3-8b", True),
                                     ("olmoe-1b-7b", True),
                                     ("mixtral-8x22b", True),
                                     ("zamba2-1.2b", False),
                                     ("rwkv6-3b", False),
                                     ("paligemma-3b", False)])
def test_check_model_split_families(arch, ok):
    """(e) Which families serve over a split model axis: the attention
    families (dense and MoE), at data 1 and on a mesh with data groups;
    the hybrid, recurrent and vlm ones refuse at both; every family
    serves whole data groups over processes; the trainer refuses a
    split model axis."""
    cfg = smoke_config(get_config(arch))
    for split, world in (({"data": 1, "model": 4}, 2),
                         ({"data": 2, "model": 4}, 4)):
        if ok:
            processes.check_model_split(split, world, what="serve",
                                        cfg=cfg)
        else:
            with pytest.raises(NotImplementedError, match="item 1d"):
                processes.check_model_split(split, world, what="serve",
                                            cfg=cfg)
    processes.check_model_split({"data": 2, "model": 4}, 2, what="serve",
                                cfg=cfg)
    with pytest.raises(NotImplementedError, match="item 1b"):
        processes.check_model_split({"data": 1, "model": 4}, 2,
                                    what="train")
    processes.check_model_split({"data": 2, "model": 2}, 2, what="train")
