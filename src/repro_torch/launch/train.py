"""The trainer, with fault tolerance, on one rank or over W ranks
(port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --smoke --device cpu --steps 4 --batch 2 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --smoke --device cpu --tp 2 --fusion-mode ring --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
      --smoke --device cpu --tp 2 --steps 3   # also mixtral-8x22b
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
      --smoke --device cpu --tp 2 --steps 3   # also rwkv6-3b
  PYTHONPATH=src python -m repro_torch.launch.train --arch paligemma-3b \
      --smoke --device cpu --steps 3      # text only, as JAX's trainer
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --smoke --devices cpu,cpu,cpu,cpu --tp 2 --steps 4  # (data 2, model 2)
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --smoke --steps 50 --ckpt-dir /tmp/ckpt --ckpt-every 20   # the card

The flags are those of ``repro.launch.train`` plus ``--device`` (default
``cuda``; without a GPU the run raises unless ``--device cpu`` is given)
and ``--devices`` (one device per rank, comma-separated; default: all
``--tp`` ranks on ``--device``, i.e. virtual ranks), as in
``launch.serve``. As JAX's trainer builds its mesh, the run has n
ranks (those ``--devices`` lists; by default ``--tp`` ranks on
``--device``) as (data = n // model, model = min(tp, n)); a count that
does not divide by ``--tp`` raises. On each data group of W = model
ranks it trains what JAX trains on that mesh: Megatron-style shards on
``model`` and FSDP blocks on ``data`` (``lm.leaf_specs``: every
weight's ``embed`` / ``in_vocab`` dim over ``data``, gathered per layer
and its gradient reduce-scattered, ``distributed.fsdp``), the batch's
rows split over the data groups (``data.pipeline.shard_batch``), the
paper's sequence-parallel AG+GEMM and GEMM+RS at the projection sites in
``--fusion-mode`` (``core.patterns``); at W = 1 the mode has no effect,
as in JAX. The loss is JAX's global mean over every group's tokens.
``--devices cpu,cpu,cpu,cpu --tp 2`` trains on a (2, 2) mesh of virtual
ranks. The parameters are fp32 masters, born sharded on a mesh of
more than one rank, as JAX's trainer builds them
(``lm.init_params(..., trainable=True, mesh=)``: each rank's blocks
drawn on its own device, never the whole model; a generator a leaf,
seeded from ``--seed`` and the leaf's path, so not JAX's numbers, but
the same numbers on every mesh); the data is ``SyntheticLM``,
byte-identical to JAX's for the same seed and step. Checkpoints hold
the global ``{"params", "opt"}`` with ``extra={"next_step": ...}`` in
the JAX checkpointer's format, whatever mesh wrote them, so
``--resume`` continues a run of either package on any (data, model)
(JAX's elastic restore). SIGTERM/SIGINT checkpoints and exits
(``PreemptionGuard``), slow steps are flagged (``StragglerWatchdog``)
and ``--heartbeat-file`` records liveness (``Heartbeat``).

``--tp W`` trains every family JAX trains: the dense blocks, MoE
(``attn_moe``, e.g. ``--arch olmoe-1b-7b``: the experts over the ranks
as JAX's rules place them, the log lines carrying the aux loss, over
the global batch) and the recurrent ones (``mamba_hybrid``, ``rwkv``:
their scans on the gathered sequence). The remat policy comes from the
config, as in JAX's trainer (``cfg.replace(remat=True,
remat_policy="dots")`` reaches ``"dots"``; there is no flag).
``--mesh production`` and ``--multi-pod`` (256 and 512 ranks) raise
``NotImplementedError``: they need one process per card (ROADMAP item
10d). ``--grad-compress`` is parsed and unused, as in JAX's trainer
(``distributed.grad_compress`` is there for its callers).

The data is token batches, so a vlm (paligemma-3b) trains on text
alone, as JAX's trainer does (no "patches"; the prefix-LM mask still
spans the first ``num_prefix_tokens`` positions, JAX's behaviour), and an
audio model (hubert-xlarge) exits with a message: it reads a "frames"
stream that no data source makes (JAX's trainer stops with ``KeyError:
'frames'``). Both train through ``launch.steps.make_train_step`` on a
batch with patches or frames (``steps.synthetic_batch``).
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.checkpoint.checkpointer import SEP, Checkpointer
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import SyntheticLM, shard_batch
from repro_torch.distributed import context as dctx
from repro_torch.distributed.fault_tolerance import (Heartbeat,
                                                     PreemptionGuard,
                                                     StragglerWatchdog)
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw, schedule


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced config (CPU-runnable)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the model trains; cpu runs the kernels' "
                        "plain PyTorch versions")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", default="host", choices=("host", "production"))
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--tp", type=int, default=1,
                   help="ranks of the model axis")
    p.add_argument("--devices", default=None,
                   help="comma-separated device per rank (default: every "
                        "rank on --device, i.e. virtual ranks)")
    p.add_argument("--fusion-mode", default="auto",
                   choices=("auto", "bsp", "ring", "pallas"))
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--grad-compress", default="none",
                   choices=("none", "bf16", "int8"))
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--heartbeat-file", default=None)
    p.add_argument("--metrics-file", default=None)
    return p.parse_args(argv)


def build_mesh(args):
    """The run's mesh, JAX's ``build_mesh``: the ranks ``--devices``
    lists (default: ``--tp`` on ``--device``) as (data, model =
    ``--tp``)."""
    if args.mesh == "production" or args.multi_pod:
        raise NotImplementedError(
            "--mesh production and --multi-pod need one process per card "
            "(ROADMAP item 10d); the port's mesh is the ranks --devices "
            "lists, driven by one process")
    return make_mesh(args.tp, args.devices, args.device)


def _ckpt_dims(cfg, mesh) -> dict:
    """The spec of every checkpoint key (``params%%...``, ``opt%%m%%...``,
    ``opt%%v%%...``) of a run over ``mesh`` (``lm.leaf_specs``)."""
    dims = {}
    for path, d in lm.leaf_specs(cfg, mesh).items():
        key = path.replace(".", SEP)
        for prefix in ("params", f"opt{SEP}m", f"opt{SEP}v"):
            dims[f"{prefix}{SEP}{key}"] = d
    return dims


def train(cfg, args, params=None, on_step=None) -> dict:
    """Train ``cfg`` as ``args`` (:func:`parse_args`) says, from
    ``params`` (a trainable LM, cut by ``lm.shard_params`` on a mesh of
    more than one rank, or per-rank LMs; default: the seeded init, born
    sharded on such a mesh). ``on_step(step, params, metrics)`` runs
    after every step, the step's gradients still on the parameters.
    Returns {"log": the logged steps ({"step", "loss",
    "grad_norm", "s": wall seconds since the previous log}), "params":
    the trainable LM (at ``--tp`` > 1 the per-rank list), "opt": the
    optimizer state (one per rank), "start_step": the first step run};
    an MoE model's log entries also carry "aux", its load-balance loss."""
    if cfg.family == "audio":
        raise SystemExit(
            f"{cfg.name} is an audio model: it trains on a 'frames' stream "
            f"(B, S, {cfg.frontend_dim}) that the trainer's data "
            f"(SyntheticLM: tokens and labels) does not make; train it "
            f"with launch.steps.make_train_step on a batch holding "
            f"'frames' (steps.synthetic_batch)")
    mesh = build_mesh(args)
    dev = mesh.devices[0]
    W = mesh.size                 # every rank: data groups x model
    ctx = dctx.DistContext(mesh if W > 1 else None, args.fusion_mode)
    opt_cfg = adamw.AdamWConfig(
        lr=schedule.warmup_cosine(args.lr, args.warmup, args.steps))
    guard = PreemptionGuard().install()
    watchdog = StragglerWatchdog()
    hb = Heartbeat(args.heartbeat_file) if args.heartbeat_file else None
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed)

    if params is None:
        params = lm.init_params(cfg, seed=args.seed, device=dev,
                                trainable=True,
                                mesh=mesh if W > 1 else None)
    elif W > 1 and not isinstance(params, list):
        params = lm.shard_params(params, mesh)
    opt_state = steps_lib.init_opt_state(params)
    states = [{"params": lm.param_tree(p), "opt": o} for p, o in
              zip(lm.as_ranks(params), lm.as_ranks(opt_state))]
    dims = _ckpt_dims(cfg, mesh)

    start_step = 0
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        _, manifest = ckpt.restore_sharded(None, states, dims,  # in place
                                           mesh_shape=mesh.shape)
        start_step = manifest["extra"].get("next_step", 0)
        print(f"[train] resumed at step {start_step} on {W} rank(s) "
              f"{dict(mesh.shape)}", flush=True)

    step_fn = steps_lib.make_train_step(cfg, opt_cfg)
    metrics_log = []
    t_last = time.monotonic()
    for step in range(start_step, args.steps):
        t0 = time.monotonic()
        batch = shard_batch(data.batch_at(step), dev, mesh)
        with dctx.use(ctx):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        if on_step is not None:
            on_step(step, params, metrics)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            dt = time.monotonic() - t_last
            t_last = time.monotonic()
            entry = {"step": step, "loss": loss, "grad_norm": gnorm, "s": dt}
            aux = ""
            if cfg.block == "attn_moe":
                entry["aux"] = float(metrics["aux"])
                aux = f" aux {entry['aux']:.4f}"
            print(f"[train] step {step:5d} loss {loss:.4f}{aux} gnorm "
                  f"{gnorm:.3f} ({dt:.2f}s)", flush=True)
            metrics_log.append(entry)
            if hb:
                hb.beat(step, loss=loss)
        watchdog.timed(step, t0)

        if ckpt and ((step + 1) % args.ckpt_every == 0 or guard.preempted):
            ckpt.save_sharded(step + 1, states, dims,
                              extra={"next_step": step + 1},
                              block=guard.preempted, mesh_shape=mesh.shape)
        if guard.preempted:
            print(f"[train] preempted at step {step}; checkpoint saved, "
                  f"exiting cleanly", flush=True)
            break

    if ckpt:
        if not guard.preempted:
            # JAX saves here after a preemption too, marking the skipped
            # steps done
            ckpt.save_sharded(args.steps, states, dims,
                              extra={"next_step": args.steps}, block=True,
                              mesh_shape=mesh.shape)
        ckpt.wait()
    if watchdog.slow_steps:
        print(f"[train] straggler summary: {watchdog.summary()}")
    if args.metrics_file:
        with open(args.metrics_file, "w") as f:
            json.dump(metrics_log, f)
    return {"log": metrics_log, "params": params, "opt": opt_state,
            "start_step": start_step}


def main(argv=None):
    args = parse_args(argv)
    build_mesh(args)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    return train(cfg, args)["log"]


if __name__ == "__main__":
    main()
