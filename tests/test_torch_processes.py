"""The trainer over processes (``repro_torch.distributed.processes``):
spawned CPU processes in one gloo job (a ``file://`` rendezvous in
``tmp_path``), each holding whole data groups of one global mesh,
against the same run in one process and against JAX.

* (a) llama3-8b smoke (float32) at (data 2, model 2) over 2 processes,
  3 steps of ``launch.train.train``: losses, grad norms and the final
  checkpoint (parameters and AdamW moments, joined by process 0)
  bit-identical to the one-process ``--devices cpu,cpu,cpu,cpu --tp 2``
  run; two AdamW steps from JAX's parameters over the 2 processes
  against JAX's ``jitted_train_step`` at (2, 2), within
  ``tests/test_torch_data_mesh.py``'s bounds for that step (first loss
  1e-5 and grad norm 1e-3 relative, second 1e-3 and 2e-2; every leaf
  within 0.3 of the norm of its update and 4 x the sum of the lrs), and
  bit-identical to the same two steps in one process;
* (b) (pod 2, data 1, model 2) over 2 processes, one pod each: the same
  bit-identity with one process;
* (c) olmoe-1b-7b smoke at (2, 1) over 2 processes: losses, the MoE
  aux (taken over every group's statistics, its gradient reaching each
  process's router), grad norms and the checkpoint bit-identical;
* (d) a checkpoint written by 2 processes at step 2 resumed in one
  process at (2, 2) (bit-identical to the uninterrupted run) and at
  (1, 2) (losses within 1e-5 relative: another mesh sums in another
  order, ``test_torch_data_mesh.py``'s elastic bound); a one-process
  checkpoint resumed over 2 processes (bit-identical);
* (e) SIGTERM to one process at step 1: both agree, save step 2 and
  exit 0;
* (f) the rank maps of ``--mesh production`` over 16 processes and
  ``--multi-pod`` over 32 (each process one data group of 16 model
  ranks, JAX's ``make_production_mesh`` device order), the process
  groups the collectives run over, and the one-process refusals.

Bit-identity holds because every cross-process sum here has two terms
or is made in rank order on every process (``Link.share``), or adds
zeros (the norm's parts). The JAX half (the production meshes on 512
fake devices, the AdamW step at (2, 2)) runs in one subprocess, this
file's ``__main__``, started with the module's first test.
"""
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, smoke_config
    from repro.distributed import context as dctx
    from repro.launch import steps
    from repro.launch.mesh import make_production_mesh
    from repro.models import lm
    from repro.optim import adamw
    from test_torch_data_mesh import ADAM_MESH, LR, train_batch

    out = {}
    for name, multi in (("production", False), ("multi_pod", True)):
        n = 512 if multi else 256
        m = make_production_mesh(multi_pod=multi) if multi else \
            jax.make_mesh((16, 16), ("data", "model"),
                          devices=jax.devices()[:n])
        out[f"ids/{name}"] = np.vectorize(lambda d: d.id)(m.devices)
        out[f"axes/{name}"] = np.array(list(m.axis_names))
    cfg = smoke_config(get_config("llama3-8b")).replace(dtype=jnp.float32)
    params = lm.init_params(jax.random.PRNGKey(0), cfg)
    mesh = jax.make_mesh(ADAM_MESH, ("data", "model"),
                         devices=jax.devices()[:4],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jitted, ctx, psh, osh = steps.jitted_train_step(
        cfg, mesh, adamw.AdamWConfig(lr=LR), fusion_mode="ring",
        donate=False)
    b = train_batch(cfg, 4)
    for k, v in b.items():
        out[f"batch/{k}"] = v
    for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["p/" + ".".join(str(x.key) for x in k)] = np.asarray(v)
    with dctx.use(ctx), mesh:
        p = jax.device_put(params, psh)
        o = jax.device_put(adamw.init_state(params), osh)
        bsh = steps.batch_sharding(ctx.rules, b)
        batch = {k: jax.device_put(jnp.asarray(v), bsh[k])
                 for k, v in b.items()}
        for step in range(2):
            p, o, met = jitted(p, o, batch)
            out[f"adam/loss{step}"] = np.asarray(met["loss"])
            out[f"adam/gnorm{step}"] = np.asarray(met["grad_norm"])
    for k, v in jax.tree_util.tree_flatten_with_path(p)[0]:
        out["adam/p/" + ".".join(str(x.key) for x in k)] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    sys.exit(0)


# ------------------------------------------------------------ the port
import multiprocessing  # noqa: E402

import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import torch_processes_worker as worker  # noqa: E402

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.distributed import processes  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
RUN = ["--arch", "llama3-8b", "--smoke", "--batch", "4", "--seq", "16",
       "--log-every", "1", "--device", "cpu", "--warmup", "8",
       "--fusion-mode", "ring"]
MOE = ["--arch", "olmoe-1b-7b", "--smoke", "--batch", "2", "--seq", "16",
       "--log-every", "1", "--device", "cpu", "--warmup", "8"]
CASE_TIMEOUT = 90           # s a case's processes may take


@pytest.fixture(scope="module", autouse=True)
def oracle_run(tmp_path_factory):
    """Starts the JAX half with the module's first test."""
    out = tmp_path_factory.mktemp("oracle") / "processes.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
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


def _spawn(tmp_path, world, target, args_of):
    """``world`` spawn-started processes of ``target(rank, world,
    rendezvous, *args_of(rank))`` over a new ``file://`` rendezvous."""
    ctx = multiprocessing.get_context("spawn")
    Job.made += 1
    rdv = f"file://{tmp_path}/rdv_{Job.made}"
    procs = [ctx.Process(target=target, args=(r, world, rdv) + args_of(r))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


class Job:
    """``world`` spawned processes running one task of
    ``torch_processes_worker`` and exiting (started at once, so the
    caller's own reference runs beside them); :meth:`results` waits for
    them within :data:`CASE_TIMEOUT` and fails the case on a hang, an
    error or an exit code other than 0."""

    made = 0

    def __init__(self, tmp_path, task, world=2, **kwargs):
        self.out = str(tmp_path / f"out_{Job.made + 1}")
        self.procs = _spawn(tmp_path, world, worker.run,
                            lambda r: (self.out, task, kwargs))

    def results(self) -> list:
        for p in self.procs:
            p.join(CASE_TIMEOUT)
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        assert not hung, f"processes {hung} still running after " \
                         f"{CASE_TIMEOUT} s (a collective that hangs)"
        res = [torch.load(f"{self.out}.{r}") for r in range(len(self.procs))]
        for r, x in enumerate(res):
            assert "ok" in x, f"process {r}:\n{x['error']}"
        assert [p.exitcode for p in self.procs] == [0] * len(self.procs)
        return [x["ok"] for x in res]


class Pool:
    """2 spawned processes that joined one job once and run the cases'
    tasks (``torch_processes_worker.serve``), so each case pays no
    start-up; a case whose tasks do not answer within
    :data:`CASE_TIMEOUT` kills the pool (the next case starts another)
    and fails."""

    def __init__(self, tmp_path, world=2):
        ctx = multiprocessing.get_context("spawn")
        self.inbox = [ctx.Queue() for _ in range(world)]
        self.outbox = ctx.Queue()
        self.procs = _spawn(tmp_path, world, worker.serve,
                            lambda r: (self.inbox[r], self.outbox))

    def alive(self) -> bool:
        return all(p.is_alive() for p in self.procs)

    def submit(self, task, **kwargs):
        for q in self.inbox:
            q.put((task, kwargs))
        return self

    def results(self) -> list:
        import queue
        got = {}
        try:
            for _ in self.procs:
                r, x = self.outbox.get(timeout=CASE_TIMEOUT)
                got[r] = x
        except queue.Empty:
            self.close()
            pytest.fail(f"processes {sorted(set(range(2)) - set(got))} gave "
                        f"no answer in {CASE_TIMEOUT} s (a collective that "
                        f"hangs)")
        for r in sorted(got):
            if "ok" not in got[r]:
                self.close()
                pytest.fail(f"process {r}:\n{got[r]['error']}")
        return [got[r]["ok"] for r in sorted(got)]

    def close(self):
        for q in self.inbox:
            q.put(None)
        for p in self.procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = []

    def get():
        if not made or not made[-1].alive():
            made.append(Pool(tmp_path_factory.mktemp("pool")))
        return made[-1]
    yield get
    for p in made:
        p.close()


def _metrics(log):
    return [(m["step"], m["loss"], m["grad_norm"], m.get("aux"))
            for m in log]


def _same_ckpt(a, b):
    fa, ma = Checkpointer(str(a)).read()
    fb, mb = Checkpointer(str(b)).read()
    assert ma["step"] == mb["step"] and ma["extra"] == mb["extra"]
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def _one(cfg_argv, arch="llama3-8b", **kw):
    return worker.train(cfg_argv, arch=arch, **kw)


# ------------------------------------------------------------------ (a)
def test_data2_model2_over_two_processes_equals_one_process(tmp_path,
                                                            pools):
    """(a) 3 steps of ``launch.train.train`` at (2, 2), 2 processes of
    one data group of 2 ranks each: the log and the final checkpoint
    bit-identical to one process's."""
    argv = RUN + ["--tp", "2", "--steps", "3"]
    job = pools().submit("train",
                         argv=argv + ["--ckpt-dir", str(tmp_path / "two")])
    one = _one(argv + ["--devices", "cpu,cpu,cpu,cpu", "--ckpt-dir",
                       str(tmp_path / "one")])
    two = job.results()
    assert _metrics(two[0]["log"]) == _metrics(two[1]["log"]) \
        == _metrics(one["log"])
    _same_ckpt(tmp_path / "two", tmp_path / "one")


# ------------------------------------------------------------------ (b)
def test_pod2_data1_model2_over_two_processes_equals_one_process(
        tmp_path, pools):
    """(b) (pod 2, data 1, model 2), one pod a process: every leaf's
    gradient summed over the pods crosses the processes."""
    argv = RUN + ["--tp", "2", "--steps", "3"]
    job = pools().submit("train", pods=(2, 1, 2),
                         argv=argv + ["--ckpt-dir", str(tmp_path / "two")])
    one = _one(argv + ["--ckpt-dir", str(tmp_path / "one")], pods=(2, 1, 2))
    two = job.results()
    assert _metrics(two[0]["log"]) == _metrics(two[1]["log"]) \
        == _metrics(one["log"])
    _same_ckpt(tmp_path / "two", tmp_path / "one")


# ------------------------------------------------------------------ (c)
def test_moe_over_two_processes_equals_one_process(tmp_path, pools):
    """(c) olmoe smoke at (2, 1): the aux over every group's statistics,
    and its gradient, as in one process."""
    argv = MOE + ["--steps", "3"]
    job = pools().submit("train", arch="olmoe-1b-7b", float32=False,
                         argv=argv + ["--ckpt-dir", str(tmp_path / "two")])
    one = _one(argv + ["--devices", "cpu,cpu", "--ckpt-dir",
                       str(tmp_path / "one")], arch="olmoe-1b-7b",
               float32=False)
    two = job.results()
    assert all(m["aux"] > 0 for m in one["log"])
    assert _metrics(two[0]["log"]) == _metrics(two[1]["log"]) \
        == _metrics(one["log"])
    _same_ckpt(tmp_path / "two", tmp_path / "one")


# ------------------------------------------------------------------ (d)
def test_checkpoints_cross_process_layouts(tmp_path, pools):
    """(d) 2 processes write step 2; one process resumes it at (2, 2) and
    at (1, 2); the uninterrupted one-process run's step-2 checkpoint
    resumes over 2 processes. Each continues that run."""
    argv = RUN + ["--tp", "2", "--ckpt-every", "2"]
    four = ["--devices", "cpu,cpu,cpu,cpu"]
    job = pools().submit("train", argv=argv + [
        "--steps", "2", "--ckpt-dir", str(tmp_path / "two")])
    full = _one(argv + four + ["--steps", "4", "--ckpt-dir",
                               str(tmp_path / "one")])
    job.results()
    step2 = "step_00000002"
    for d in ("one0", "two0", "two1"):      # each resume its own copy
        shutil.copytree(tmp_path / d[:3] / step2, tmp_path / d / step2)
    job = pools().submit("train", argv=argv + [
        "--steps", "4", "--resume", "--ckpt-dir", str(tmp_path / "one0")])
    same = _one(argv + four + ["--steps", "4", "--resume", "--ckpt-dir",
                               str(tmp_path / "two0")])
    half = _one(argv + ["--steps", "4", "--resume", "--ckpt-dir",
                        str(tmp_path / "two1")])
    back = job.results()
    want = _metrics(full["log"][2:])
    assert same["start_step"] == back[0]["start_step"] == 2
    assert _metrics(same["log"]) == want
    assert _metrics(back[0]["log"]) == _metrics(back[1]["log"]) == want
    np.testing.assert_allclose([m["loss"] for m in half["log"]],
                               [m[1] for m in want], rtol=1e-5)


# ------------------------------------------------------------------ (e)
def test_preemption_in_one_process_stops_both_at_one_step(tmp_path):
    """(e) SIGTERM to process 1 during step 1: both processes agree at
    the step's end, save step 2 (process 0 writes it) and return; their
    exit codes are 0."""
    d = tmp_path / "ck"
    job = Job(tmp_path, "train", preempt=(1, 1), argv=RUN + [
        "--tp", "2", "--steps", "5", "--ckpt-dir", str(d), "--ckpt-every",
        "100"])
    res = job.results()
    assert [[m["step"] for m in r["log"]] for r in res] == [[0, 1]] * 2
    ck = Checkpointer(str(d))
    assert ck.all_steps() == [2]
    assert ck.manifest()["extra"] == {"next_step": 2}


# ------------------------------------------------- (a), against JAX
def test_two_adamw_steps_over_two_processes_match_jax(tmp_path, jx,
                                                      pools):
    """(a) Two AdamW steps from JAX's parameters on the test batch at
    (2, 2) over 2 processes: bit-identical to one process, within
    ``test_torch_data_mesh.py``'s bounds of JAX's ``jitted_train_step``
    on the same mesh."""
    tree = tmp_path / "tree.npz"
    np.savez(tree, **{k: v for k, v in jx.items()
                      if k.startswith(("p/", "batch/"))})
    kw = dict(tree_file=str(tree), lr=1e-3)
    job = pools().submit("adam", ckpt_dir=str(tmp_path / "two"), **kw)
    one = worker.adam(ckpt_dir=str(tmp_path / "one"), **kw)
    two = job.results()
    assert two[0] == two[1] == one
    _same_ckpt(tmp_path / "two", tmp_path / "one")
    for i, m in enumerate(one):
        lt, gt = (1e-5, 1e-3) if i == 0 else (1e-3, 2e-2)
        np.testing.assert_allclose(m["loss"], float(jx[f"adam/loss{i}"]),
                                   rtol=lt)
        np.testing.assert_allclose(m["grad_norm"],
                                   float(jx[f"adam/gnorm{i}"]), rtol=gt)
    got, _ = Checkpointer(str(tmp_path / "two")).read()
    for key, t in got.items():
        path = key.split("%%", 1)[1].replace("%%", ".")
        t, want, init = (t.numpy(), jx[f"adam/p/{path}"], jx[f"p/{path}"])
        moved = np.linalg.norm(want - init)
        assert moved > 0, path
        rel = np.linalg.norm(t - want) / moved
        diff = np.abs(t - want).max()
        assert rel <= 0.3 and diff <= 4 * 2 * 1e-3, \
            f"{path}: {rel:.3e} of the update, max {diff:.3e} vs JAX"


# ------------------------------------------------------------------ (f)
@pytest.mark.parametrize("multi", [False, True],
                         ids=["production", "multi_pod"])
def test_production_rank_maps_are_jax_meshes(jx, multi, monkeypatch):
    """(f) ``--mesh production`` over 16 processes, ``--multi-pod`` over
    32: process p holds data group p, the 16 ranks 16 p .. 16 p + 15,
    which are JAX's devices at mesh row p (``make_production_mesh``'s
    device ids, row-major); the FSDP gather runs over the pod's 16
    processes, the pod sums over processes p and p + 16. One process
    refuses both before any parameter is drawn."""
    name = "multi_pod" if multi else "production"
    world = 32 if multi else 16
    shape = {"pod": 2, "data": 16, "model": 16} if multi else \
        {"data": 16, "model": 16}
    ids = jx[f"ids/{name}"]
    assert list(jx[f"axes/{name}"]) == list(shape)
    for p in range(world):
        mesh = make_production_mesh(multi_pod=multi, device="cpu",
                                    procs=processes.Processes(p, world))
        assert tuple(mesh.shape.items()) == tuple(shape.items())
        assert mesh.local == range(16 * p, 16 * p + 16)
        assert list(mesh.local_groups) == [p]
        for r in mesh.local:
            assert ids[tuple(mesh.coords(r).values())] == r
        pod = p // 16
        assert processes.peers(shape, world, p, "data") == tuple(
            range(16 * pod, 16 * pod + 16))
        assert processes.peers(shape, world, p, ("pod",)) == (
            (p % 16, p % 16 + 16) if multi else (p,))
        assert processes.peers(shape, world, p, processes.AXES) == tuple(
            range(world))
    drawn = []
    monkeypatch.setattr(ttrain.lm, "init_params",
                        lambda *a, **k: drawn.append(1))
    extra = ["--multi-pod"] if multi else ["--mesh", "production"]
    with pytest.raises(ValueError, match=f"over {world} processes"):
        ttrain.main(RUN + ["--steps", "1"] + extra)
    assert not drawn
