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


# ------------------------------------------ serving, the model axis split
def split_mesh(W, procs=None):
    """A (1, W) mesh of CPU ranks whose model axis the job's processes
    split (``procs``; every rank here without)."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(W, device="cpu", procs=procs, split_model=True)
    if procs is not None:
        procs.connect(mesh.shape)
    return mesh


def serve_steps(arch="llama3-8b", W=2, mode="auto", tree_file=None,
                steps=4, batch=2, max_len=16, paged=False):
    """``steps`` decode steps of ``arch``'s float32 smoke over a (1, W)
    mesh (over this job's processes, which split its model axis, or in
    one process): parameters born sharded from seed 0, or cut from the
    npz ``tree_file`` (JAX's, dotted paths under ``p/``); the contiguous
    state (``paged``: a pool of 4-token blocks, every slot's table
    filled); the same seeded tokens everywhere. Returns each step's
    logits (float32 tensors)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import processes
    from repro_torch.distributed.context import DistContext, use
    from repro_torch.models import lm
    cfg = _cfg(arch, True)
    mesh = split_mesh(W, processes.current())
    if tree_file is None:
        params = lm.init_params(cfg, seed=0, device="cpu", mesh=mesh)
    else:
        with np.load(tree_file) as z:
            tree: dict = {}
            for k in z.files:
                if not k.startswith("p/"):
                    continue
                node = tree
                *path, leaf = k[2:].split(".")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = z[k]
        params = params_from_numpy(tree, cfg, device="cpu", mesh=mesh)
    toks = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (steps, batch, 1)).astype(np.int32)
    out = []
    with use(DistContext(mesh, mode)), torch.inference_mode():
        if paged:
            nb = batch * max_len // 4
            st = lm.init_paged_decode_state(params, cfg, batch, nb, 4,
                                            max_len // 4)
            table = np.arange(nb, dtype=np.int32).reshape(batch, -1)
            for t in st["block_tables"]:
                t.copy_(torch.from_numpy(table))
        else:
            st = lm.init_decode_state(params, cfg, batch, max_len)
        for i in range(steps):
            lg, st = lm.decode_step(params, torch.from_numpy(toks[i]), st,
                                    cfg)
            out.append(lg.float().clone())
    return out


SPLIT_REQS = [(5, 0), (11, 1), (3, 1), (9, 3)]   # (prompt length, arrival)


def serve_engine(arch="llama3-8b", W=2, mode="auto", K=1, n_layers=2):
    """The engine on ``arch``'s float32 smoke (``n_layers``) over a (1, W)
    mesh (split over this job's processes, or one process), paged pool,
    4 requests of seeded prompts, greedy, megaticks of K. Returns the
    streams."""
    from repro_torch.distributed import processes
    from repro_torch.distributed.context import DistContext, use
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, Request
    cfg = _cfg(arch, True).replace(n_layers=n_layers)
    mesh = split_mesh(W, processes.current())
    params = lm.init_params(cfg, seed=0, device="cpu",
                            mesh=mesh if W > 1 else None)
    rng = np.random.default_rng(7)
    with use(DistContext(mesh if W > 1 else None, mode)):
        eng = Engine(params, cfg, batch=4, max_len=64, block_size=4,
                     prefill_chunk=4, decode_steps=K, device="cpu")
        for rid, (n, at) in enumerate(SPLIT_REQS):
            eng.submit(Request(rid=rid, prompt=[
                int(t) for t in rng.integers(1, cfg.vocab_size, n)],
                max_new_tokens=6), at_tick=at)
        done = eng.run()
    return {r.rid: list(r.out_tokens) for r in done}


def serve_cli(argv):
    """``launch.serve.main(argv)`` with its standard output captured:
    (what it printed, its streams)."""
    import contextlib
    import io
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = serve.main(argv)
    return {"printed": buf.getvalue(), "streams": res["streams"]}


def refused(entry, argv):
    """``launch.serve.main(argv)`` (``entry`` "serve") or the trainer
    (``launch.train``, "train") expected to refuse the layout: the
    refusal's message and whether any parameter was drawn first."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import serve
    from repro_torch.launch import train as tr
    from repro_torch.models import lm
    drawn = []
    real = lm.init_params

    def init(*a, **k):
        drawn.append(1)
        return real(*a, **k)
    lm.init_params = init
    try:
        if entry == "serve":
            serve.main(argv)
        else:
            args = tr.parse_args(argv)
            tr.train(smoke_config(get_config(args.arch)), args)
    except NotImplementedError as e:
        return {"msg": str(e), "drawn": bool(drawn)}
    finally:
        lm.init_params = real
    return {"msg": None, "drawn": bool(drawn)}


def fused_on_card(path, W=4):
    """The three fused kernels over the (1, W) mesh this job's processes
    split, their W / P ranks virtual on cuda:0, on the inputs in
    ``path`` (every rank's, on the host: ``ag_a``, ``ag_b``; ``q``,
    ``pk``, ``pv``, ``cur``, ``tables``; ``sk``, ``sv``): this
    process's ranks' outputs, on the host."""
    from repro_torch.distributed import processes
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels.ag_gemm import ag_gemm_fused
    from repro_torch.launch.mesh import make_mesh
    procs = processes.current()
    torch.cuda.set_device(0)
    mesh = make_mesh(W, devices=["cuda:0"] * (W // procs.world),
                     procs=procs, split_model=True)
    procs.connect(mesh.shape)
    x = torch.load(path)
    n = len(mesh.local)

    def mine(k):
        return [x[k][r].cuda() for r in mesh.local]
    q, cur, tb = (x[k].cuda() for k in ("q", "cur", "tables"))
    scale = q.shape[-1] ** -0.5
    out = {"ag_gemm_fused": ag_gemm_fused(mine("ag_a"),
                                          [x["ag_b"].cuda()] * n, mesh),
           "flash_decode_paged_fused": kfd.flash_decode_paged_fused(
               [q] * n, mine("pk"), mine("pv"), [cur] * n, [tb] * n, scale,
               mesh=mesh),
           "flash_decode_fused": kfd.flash_decode_fused(
               [q] * n, mine("sk"), mine("sv"), [cur.clamp_max(
                   W * x["sk"][0].shape[1])] * n, scale, mesh=mesh)}
    torch.cuda.synchronize()
    mesh.close()
    return {k: [t.cpu() for t in v] for k, v in out.items()}



def copy_block(W=4, src=1, dst=6):
    """``lm.copy_cache_block`` (copy-on-write) over the paged state of the
    llama3-8b smoke on a (1, W) mesh (split over this job's processes,
    or one process): every pool block filled with its global id, then
    block ``src`` copied to ``dst``. Returns every rank's K pool here."""
    from repro_torch.distributed import processes
    from repro_torch.distributed.context import DistContext, use
    from repro_torch.models import lm
    cfg = _cfg("llama3-8b", True)
    mesh = split_mesh(W, processes.current())
    params = lm.init_params(cfg, seed=0, device="cpu", mesh=mesh)
    with use(DistContext(mesh, "auto")):
        st = lm.init_paged_decode_state(params, cfg, 2, 8, 4, 4)
        for r, k in zip(mesh.local, st["caches"]["k"]):
            n = k.shape[1]
            for b in range(n):
                k[:, b].fill_(r * n + b)
        lm.copy_cache_block(st, cfg, src, dst)
    return [k.clone() for k in st["caches"]["k"]]


# ------------------------------------- serving, data groups over processes
def data_mesh(D, M, pods=1, procs=None):
    """A (pods x D, M) serving mesh of CPU ranks (``pods`` > 1: (pod,
    data, model)) over this job's processes, each its block of the ranks
    (whole data groups, or a block of one group's model ranks), or every
    rank here without ``procs``; the job's process groups made."""
    from repro_torch.launch.mesh import make_mesh, make_mesh_for_devices
    world = 1 if procs is None else procs.world
    n = pods * D * M
    devs = ["cpu"] * (n // world)
    if pods > 1:
        mesh = make_mesh_for_devices(n, M, pods, devices=devs, procs=procs)
    else:
        mesh = make_mesh(M, devices=devs, procs=procs, split_model=True)
    if procs is not None:
        procs.connect(mesh.shape)
    return mesh


def _params(cfg, mesh, tree_file):
    """``cfg``'s shards over ``mesh``: born sharded from seed 0, or cut
    from the npz ``tree_file`` (dotted paths under ``p/``)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import lm
    if tree_file is None:
        return lm.init_params(cfg, seed=0, device="cpu", mesh=mesh)
    with np.load(tree_file) as z:
        tree: dict = {}
        for k in z.files:
            if not k.startswith("p/"):
                continue
            node = tree
            *path, leaf = k[2:].split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[k]
    return params_from_numpy(tree, cfg, device="cpu", mesh=mesh)


def data_steps(arch="llama3-8b", D=2, M=2, pods=1, mode="auto",
               paged=False, steps=4, batch=4, max_len=16, tree_file=None):
    """``steps`` decode steps of ``arch``'s float32 smoke over a (pods x
    D, M) mesh (over this job's processes, or one process), on its
    shards (:func:`_params`); the contiguous state, or (``paged``) a
    pool of 16 blocks of 2 tokens whose every slot's 4 table entries are
    a fixed draw of distinct blocks (on several ranks); the same seeded
    tokens everywhere. Returns each step's logits."""
    from repro_torch.distributed import processes
    from repro_torch.distributed.context import DistContext, use
    from repro_torch.models import lm
    cfg = _cfg(arch, True)
    mesh = data_mesh(D, M, pods, processes.current())
    params = _params(cfg, mesh, tree_file)
    toks = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (steps, batch, 1)).astype(np.int32)
    out = []
    with use(DistContext(mesh, mode)), torch.inference_mode():
        if paged:
            st = lm.init_paged_decode_state(params, cfg, batch, 16, 2, 4)
            table = np.random.default_rng(1).permutation(16)[
                :batch * 4].reshape(batch, 4).astype(np.int32)
            for t in st["block_tables"]:
                t.copy_(torch.from_numpy(table))
        else:
            st = lm.init_decode_state(params, cfg, batch, max_len)
        for i in range(steps):
            lg, st = lm.decode_step(params, torch.from_numpy(toks[i]), st,
                                    cfg)
            out.append(lg.float().clone())
    mesh.close()
    return out


def data_engine(arch="llama3-8b", D=2, M=2, pods=1, mode="auto", K=1,
                n_layers=2):
    """The engine on ``arch``'s float32 smoke (``n_layers``) over a (pods
    x D, M) mesh (over this job's processes, or one process), paged
    pool, 4 requests of seeded prompts (SPLIT_REQS), greedy, megaticks
    of K. Returns the streams."""
    from repro_torch.distributed import processes
    from repro_torch.distributed.context import DistContext, use
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, Request
    cfg = _cfg(arch, True).replace(n_layers=n_layers)
    mesh = data_mesh(D, M, pods, processes.current())
    params = lm.init_params(cfg, seed=0, device="cpu", mesh=mesh)
    rng = np.random.default_rng(7)
    with use(DistContext(mesh, mode)):
        eng = Engine(params, cfg, batch=4, max_len=64, block_size=4,
                     prefill_chunk=4, decode_steps=K, device="cpu")
        for rid, (n, at) in enumerate(SPLIT_REQS):
            eng.submit(Request(rid=rid, prompt=[
                int(t) for t in rng.integers(1, cfg.vocab_size, n)],
                max_new_tokens=6), at_tick=at)
        done = eng.run()
    mesh.close()
    return {r.rid: list(r.out_tokens) for r in done}


def cases(todo):
    """Each ``(task, kwargs)`` of ``todo`` in turn: their results."""
    return [globals()[task](**kwargs) for task, kwargs in todo]
