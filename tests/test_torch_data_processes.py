"""Serving with data groups over processes
(``repro_torch.distributed.processes``, ``Mesh.span``): spawned CPU
processes in one gloo job (the pools of ``tests/test_torch_processes.py``),
each holding whole data groups of a (data, model) mesh, or a block of
one group's model ranks, against the same mesh in one process and
against JAX.

* (a) llama3-8b smoke (float32) at (2, 2) over 2 processes (a group
  each) and over 4 (the model axis split too), every mode: 4 serve
  steps' logits over the contiguous and the paged state bit-identical to
  the one-process (2, 2) step, and the engine's greedy streams
  token-identical at K = 1 and K = 4;
* (b) (4, 1) over 2 processes (two groups each) and (pod 2, data 1,
  model 2) over 2 (a pod each): the same;
* (c) olmoe-1b-7b, zamba2-1.2b, rwkv6-3b and paligemma-3b smoke over 2
  processes, a group each: logits of both states and the streams at
  K = 4 (the recurrent families' state rows a process, the products
  inside them over every process's rows), and olmoe over 4 processes;
* (d) a batch of 3 over 2 groups (every group holds every slot);
* (e) the 2-process (2, 2) logits from JAX's parameters against JAX's
  ``jitted_serve_step`` on a (2, 2) Auto mesh, within
  ``tests/test_torch_data_serve.py``'s tolerance (one bf16 ulp on a
  rounding boundary, ``2**-7`` relative; 1e-4 otherwise);
* (f) ``launch.serve`` over 2 processes against one process: the same
  streams, and only process 0 prints; ``launch.server`` refuses
  torchrun before any parameter is drawn.

On the CPU what crosses processes goes over the gloo links of the ranks
each collective spans (``kernels.symm.every_rank``): the weights-
stationary products' sums and joins over ``data``, the batch rows over
``("pod", "data")``, the paged pool's combine over every rank. Each is
made in rank order in every process, so the values are the one-process
ones bit for bit. The JAX half runs in one subprocess, this file's
``__main__``, on 4 fake devices, started with the module's first test.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np

B, MAX_LEN, STEPS = 4, 16, 4


def _oracle(path):
    """The JAX half: llama3-8b smoke's parameters (float32, no zero
    leaves) and its serve step's logits on a (2, 2) Auto mesh
    (``auto``), 4 steps of batch 4 over the contiguous state."""
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
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         devices=jax.devices()[:4],
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
from test_torch_processes import Pool  # noqa: E402

torch.set_num_threads(1)        # the pools' processes run one thread too
REPO = pathlib.Path(__file__).resolve().parents[1]
MODES = ("auto", "bsp", "ring", "pallas")
LOGIT_TOL = dict(rtol=2 ** -7, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def oracle_run(tmp_path_factory):
    """Starts the JAX half with the module's first test."""
    out = tmp_path_factory.mktemp("oracle") / "data_processes.npz"
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
def jx(oracle_run):
    proc, out = oracle_run
    assert proc.wait(timeout=300) == 0, "the JAX half failed"
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """``pools(world)``: a pool of ``world`` processes, made once."""
    made: dict = {}

    def get(world):
        if world not in made or not made[world].alive():
            made[world] = Pool(tmp_path_factory.mktemp(f"pool{world}"),
                               world=world)
        return made[world]
    yield get
    for p in made.values():
        p.close()


def _held(pools, world, todo):
    """``todo`` (``(task, kwargs)`` of ``torch_processes_worker``) over
    ``world`` processes against one process: each result the same in
    every process and bit-identical to the one-process run."""
    many = pools(world).submit("cases", todo=todo).results()
    one = worker.cases(todo)
    for p, got in enumerate(many):
        for (task, kw), a, b in zip(todo, got, one):
            if task == "data_steps":
                assert len(a) == len(b)
                for i, (x, y) in enumerate(zip(a, b)):
                    assert torch.equal(x, y), (p, kw, f"step {i}")
            else:
                assert a == b, (p, kw)
                assert all(len(t) == 6 for t in a.values()), a
    return one


def _steps(**kw):
    return [("data_steps", dict(kw, paged=paged)) for paged in (False,
                                                               True)]


def _engines(Ks=(1, 4), **kw):
    return [("data_engine", dict(kw, K=K)) for K in Ks]


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", [2, 4])
def test_serve_steps_over_data_processes(pools, world, mode):
    """(a) 4 decode steps of the llama3-8b smoke (float32) at (2, 2) over
    2 processes (a data group each) or 4 (the model axis split as
    well), born sharded: logits over both states bit-identical to the
    one-process (2, 2) step."""
    _held(pools, world, _steps(mode=mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", [2, 4])
def test_engine_over_data_processes(pools, world, mode):
    """(a) The engine (paged pool, staggered arrivals, greedy) at (2, 2)
    over 2 or 4 processes: the one-process (2, 2) engine's streams at
    K = 1 and K = 4 in every process (which also agree over the store
    at the end of the run)."""
    _held(pools, world, _engines(mode=mode))


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("mesh", ["4x1", "pod2x1x2"])
def test_other_layouts_over_data_processes(pools, mesh):
    """(b) (4, 1) over 2 processes (two data groups each: the products'
    sums over 4 blocks, 2 a process) under ``pallas`` and ``auto``, and
    (pod 2, data 1, model 2) over 2 (a pod each: no weight crosses,
    the rows and the pool do) under ``ring``: logits and streams."""
    kws = ([dict(D=4, M=1, mode=m) for m in ("pallas", "auto")]
           if mesh == "4x1" else [dict(D=1, M=2, pods=2, mode="ring")])
    todo = []
    for kw in kws:
        todo += _steps(**kw) + _engines(Ks=(4,), **kw)
    _held(pools, 2, todo)


# ------------------------------------------------------------------ (c)
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-1.2b",
                                  "rwkv6-3b", "paligemma-3b"])
def test_families_over_data_processes(pools, arch):
    """(c) Each family at (2, 2) over 2 processes, a group each, under
    ``pallas`` (rwkv6: ``auto``, its channel mix's row sums): logits of
    both states and the streams at K = 4."""
    mode = "auto" if arch == "rwkv6-3b" else "pallas"
    _held(pools, 2, _steps(arch=arch, mode=mode)
          + _engines(Ks=(4,), arch=arch, mode=mode))


def test_moe_over_split_data_processes(pools):
    """(c) olmoe-1b-7b at (2, 2) over 4 processes (the model axis split,
    its experts over the model ranks): logits and streams."""
    _held(pools, 4, _steps(arch="olmoe-1b-7b", mode="auto")
          + _engines(Ks=(4,), arch="olmoe-1b-7b", mode="pallas"))


# ------------------------------------------------------------------ (d)
@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-1.2b"])
def test_a_batch_that_does_not_divide_over_data_processes(pools, arch):
    """(d) 3 slots over 2 data groups in 2 processes: each group holds
    and steps every slot; logits of both states as one process's."""
    _held(pools, 2, _steps(arch=arch, mode="ring", batch=3))


# ------------------------------------------------------------------ (e)
def test_two_processes_match_jax_serve_step_on_a_data_mesh(tmp_path, jx,
                                                           pools):
    """(e) JAX's parameters at (2, 2) over 2 processes: 4 steps' logits
    within one bf16 ulp of JAX's ``jitted_serve_step`` on a (2, 2) Auto
    mesh, and bit-identical to the same steps in one process."""
    tree = tmp_path / "tree.npz"
    np.savez(tree, **{k: v for k, v in jx.items() if k.startswith("p/")})
    one = _held(pools, 2, [("data_steps", dict(tree_file=str(tree)))])[0]
    for i, lg in enumerate(one):
        np.testing.assert_allclose(lg.numpy(), jx[f"logits/{i}"],
                                   err_msg=f"step {i}", **LOGIT_TOL)


# ------------------------------------------------------------------ (f)
def test_serve_cli_over_data_processes(pools):
    """(f) ``launch.serve`` at ``--tp 2 --devices cpu,cpu`` over 2
    processes (a (2, 2) mesh, a group each) serves the streams of one
    process's ``--devices cpu,cpu,cpu,cpu --tp 2``; process 0 alone
    prints."""
    argv = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--tp",
            "2", "--fusion-mode", "pallas", "--requests", "3", "--max-new",
            "4", "--decode-steps", "2"]
    two = pools(2).submit("serve_cli",
                          argv=argv + ["--devices", "cpu,cpu"]).results()
    one = worker.serve_cli(argv + ["--devices", "cpu,cpu,cpu,cpu"])
    assert two[0]["streams"] == two[1]["streams"] == one["streams"]
    assert "[serve]" in two[0]["printed"] and two[1]["printed"] == ""
    assert "'processes': 2" in two[0]["printed"]
    assert "'mesh': {'data': 2, 'model': 2}" in two[0]["printed"]


def test_rows_apart_rides_with_the_weights():
    """Which way a weight cut over ``data`` crosses processes is the
    weight's own: ``patterns.over_groups`` hands its function the
    layer's parameters with each weight that spans processes marked
    rows-apart (``cm.Stationary.rows_apart``, kept through casts and
    indexing), every other leaf as it was; in one process none."""
    from types import SimpleNamespace

    from repro_torch.core import collective_matmul as cm
    from repro_torch.core import patterns
    from repro_torch.distributed import fsdp
    t = torch.ones(2, 3, 4)
    w = cm.Stationary([t], 1, SimpleNamespace(size=2, local=range(0, 1)))
    here = cm.Stationary([t, t], 1)
    a = w.rows_apart()
    assert not w.apart and a.apart and a.blocks[0] is t
    assert a[0].apart and a[1:].apart and a.to(torch.float64).apart
    assert here.rows_apart() is here
    tree = fsdp.View({"att": {"wq": w, "ln": t}, "x": here}, "cpu")
    out = patterns._rows_apart(tree)
    assert isinstance(out, fsdp.View) and out.device == "cpu"
    assert isinstance(out["att"], fsdp.View)
    assert out["att"]["wq"].apart and not tree["att"]["wq"].apart
    assert out["att"]["ln"] is t and out["x"] is here
    layer = patterns._rows_apart({"wq": w, "ln": t})
    assert type(layer) is dict and layer["wq"].apart and layer["ln"] is t


def test_server_refuses_torchrun_before_any_draw(monkeypatch):
    """(f) ``launch.server.build_engine`` under torchrun (``WORLD_SIZE`` >
    1) refuses before any parameter is drawn, naming the ROADMAP item
    that carries the server over processes; one process still builds."""
    from repro_torch.launch import server
    from repro_torch.models import lm
    drawn = []
    real = lm.init_params

    def init(*a, **k):
        drawn.append(1)
        return real(*a, **k)
    monkeypatch.setattr(lm, "init_params", init)
    args = server.make_parser().parse_args(
        ["--arch", "llama3-8b", "--smoke", "--device", "cpu"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1, item 4"):
        server.build_engine(args)
    assert not drawn
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert server.build_engine(args) is not None and drawn
