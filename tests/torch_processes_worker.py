"""The processes of ``tests/test_torch_processes.py``: each joins a gloo
job of CPU processes over a ``file://`` rendezvous
(``repro_torch.distributed.processes.init``) and runs tasks of this
module: one, writing what it returns to ``<out>.<rank>``
(``torch.save``) before it exits (:func:`run`), or one after another
from a queue, answering on another (:func:`serve`). It imports no JAX:
these are the port's processes, as torchrun would start them."""
import os
import signal
import sys
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))


def run(rank, world, init_method, out, task, kwargs):
    """Spawn target: join, run ``task(**kwargs)``, write its result or
    the traceback, leave the job."""
    torch.set_num_threads(1)
    from repro_torch.distributed import processes
    try:
        processes.init("gloo", "cpu", init_method=init_method, rank=rank,
                       world_size=world)
        res = {"ok": globals()[task](**kwargs)}
    except Exception:
        res = {"error": traceback.format_exc()}
    torch.save(res, f"{out}.{rank}")
    processes.shutdown()
    if "error" in res:
        sys.exit(1)


def serve(rank, world, init_method, inbox, outbox):
    """Spawn target: join, then run each ``(task, kwargs)`` of ``inbox``
    (None ends), putting ``(rank, {"ok": result} or {"error":
    traceback})`` on ``outbox``."""
    torch.set_num_threads(1)
    from repro_torch.distributed import processes
    processes.init("gloo", "cpu", init_method=init_method, rank=rank,
                   world_size=world)
    for task, kwargs in iter(inbox.get, None):
        try:
            res = {"ok": globals()[task](**kwargs)}
        except Exception:
            res = {"error": traceback.format_exc()}
        outbox.put((rank, res))
    processes.shutdown()


def _cfg(arch, float32):
    from repro_torch.configs import get_config, smoke_config
    cfg = smoke_config(get_config(arch))
    return cfg.replace(dtype=torch.float32) if float32 else cfg


def pod_mesh(pods, data, model, procs=None):
    """(pods, data, model) over CPU ranks (``procs``: this process's)."""
    from repro_torch.launch.mesh import make_mesh_for_devices
    world = 1 if procs is None else procs.world
    n = pods * data * model
    return make_mesh_for_devices(n, model, pods,
                                 devices=["cpu"] * (n // world), procs=procs)


def train(argv, arch="llama3-8b", float32=True, pods=None, preempt=None):
    """``launch.train.train`` of ``arch``'s smoke config with ``argv``
    (``pods``: (pods, data, model) for a pod mesh; ``preempt``: (rank,
    step) at which that process sends itself SIGTERM). Returns the log
    and the start step."""
    from repro_torch.distributed import processes
    from repro_torch.launch import train as tr
    procs = processes.current()
    mesh = None if pods is None else pod_mesh(*pods, procs)
    on_step = None
    if preempt is not None and procs is not None \
            and procs.rank == preempt[0]:
        def on_step(step, params, metrics):
            if step == preempt[1]:
                os.kill(os.getpid(), signal.SIGTERM)
    res = tr.train(_cfg(arch, float32), tr.parse_args(argv), mesh=mesh,
                   on_step=on_step)
    return {"log": res["log"], "start_step": res["start_step"]}


def adam(tree_file, ckpt_dir, lr, mesh_shape=(2, 2)):
    """Two AdamW steps of the float32 llama3-8b smoke from the parameters
    in ``tree_file`` (an npz of dotted paths) on the rows of the
    deterministic test batch (``tests/test_torch_data_mesh.train_batch``'s
    arrays, in ``tree_file`` as ``batch/tokens`` and ``batch/labels``)
    over the (data, model) ``mesh_shape``, ``ring`` mode; the joined
    parameters written to ``ckpt_dir``. Returns each step's metrics."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import processes
    from repro_torch.distributed.context import DistContext, use
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    procs = processes.current()
    with np.load(tree_file) as z:
        flat = {k: z[k] for k in z.files}
    tree: dict = {}
    for k, v in flat.items():
        if k.startswith("p/"):
            node = tree
            *path, leaf = k[2:].split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    batch = {k: flat[f"batch/{k}"] for k in ("tokens", "labels")}
    cfg = _cfg("llama3-8b", True)
    D, W = mesh_shape
    world = 1 if procs is None else procs.world
    mesh = make_host_mesh(D, W, devices=["cpu"] * (D * W // world),
                          procs=procs)
    if procs is not None:
        procs.connect(mesh.shape)
    ps = params_from_numpy(tree, cfg, device="cpu", trainable=True,
                           mesh=mesh)
    opt = steps.init_opt_state(ps)
    step = steps.make_train_step(cfg, adamw.AdamWConfig(lr=lr))
    ms = []
    with use(DistContext(mesh, "ring")):
        for _ in range(2):
            ps, opt, m = step(ps, opt, shard_batch(batch, "cpu", mesh))
            ms.append({k: v.item() for k, v in m.items()})
    trees = [{"params": lm.param_tree(p)} for p in ps]
    dims = {f"params%%{k.replace('.', '%%')}": v
            for k, v in lm.leaf_specs(cfg, mesh).items()}
    Checkpointer(ckpt_dir).save_sharded(
        2, trees, dims, block=True, mesh_shape=mesh.shape,
        link=mesh.across(("pod", "data")))
    return ms
