"""Training driver at W = 1 with fault tolerance (port of
``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --smoke --device cpu --steps 4 --batch 2 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --smoke --steps 50 --ckpt-dir /tmp/ckpt --ckpt-every 20   # the card

The flags are those of ``repro.launch.train`` plus ``--device`` (default
``cuda``; without a GPU the run raises unless ``--device cpu`` is
given). The parameters are fp32 masters (``lm.init_params(...,
trainable=True)``, seeded from ``--seed`` with a ``torch.Generator``,
so not JAX's numbers); the data is ``SyntheticLM``, byte-identical to
JAX's for the same seed and step. Checkpoints hold ``{"params",
"opt"}`` with ``extra={"next_step": ...}`` in the JAX checkpointer's
format, so ``--resume`` continues a run of either package in place.
SIGTERM/SIGINT checkpoints and exits (``PreemptionGuard``), slow steps
are flagged (``StragglerWatchdog``) and ``--heartbeat-file`` records
liveness (``Heartbeat``).

Only one rank: ``--tp`` > 1, ``--mesh production`` and ``--multi-pod``
raise ``NotImplementedError`` (Megatron-style sharding and the train
sites' AG+GEMM / GEMM+RS are later slices). ``--fusion-mode`` has no
effect at W = 1, as in JAX; ``--grad-compress`` is parsed and unused, as
in JAX's driver.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import SyntheticLM, shard_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (Heartbeat,
                                                     PreemptionGuard,
                                                     StragglerWatchdog)
from repro_torch.launch import steps as steps_lib
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
    p.add_argument("--tp", type=int, default=1)
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


def _one_rank(args):
    if args.tp > 1 or args.mesh == "production" or args.multi_pod:
        raise NotImplementedError(
            "the port trains on one rank: --tp > 1, --mesh production and "
            "--multi-pod need Megatron-style sharding (ROADMAP item 10b) "
            "and the train sites' AG+GEMM / GEMM+RS (item 10c)")


def train(cfg, args, params=None, on_step=None) -> dict:
    """Train ``cfg`` as ``args`` (:func:`parse_args`) says, from
    ``params`` (a trainable LM on ``args.device``; default: the seeded
    init there). ``on_step(step, params, metrics)`` runs after every
    step, the step's gradients still on the parameters. Returns {"log":
    the logged steps ({"step", "loss", "grad_norm", "s": wall seconds
    since the previous log}), "params": the trainable LM, "opt": the
    optimizer state, "start_step": the first step run}."""
    _one_rank(args)
    dev = resolve_device(args.device)
    opt_cfg = adamw.AdamWConfig(
        lr=schedule.warmup_cosine(args.lr, args.warmup, args.steps))
    guard = PreemptionGuard().install()
    watchdog = StragglerWatchdog()
    hb = Heartbeat(args.heartbeat_file) if args.heartbeat_file else None
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed)

    if params is None:
        params = lm.init_params(cfg, seed=args.seed, device=dev,
                                trainable=True)
    opt_state = adamw.init_state(lm.param_tree(params))
    state = {"params": lm.param_tree(params), "opt": opt_state}

    start_step = 0
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        _, manifest = ckpt.restore(None, state)     # in place
        start_step = manifest["extra"].get("next_step", 0)
        print(f"[train] resumed at step {start_step}", flush=True)

    step_fn = steps_lib.make_train_step(cfg, opt_cfg)
    metrics_log = []
    t_last = time.monotonic()
    for step in range(start_step, args.steps):
        t0 = time.monotonic()
        batch = shard_batch(data.batch_at(step), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if on_step is not None:
            on_step(step, params, metrics)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            dt = time.monotonic() - t_last
            t_last = time.monotonic()
            print(f"[train] step {step:5d} loss {loss:.4f} gnorm "
                  f"{gnorm:.3f} ({dt:.2f}s)", flush=True)
            metrics_log.append({"step": step, "loss": loss,
                                "grad_norm": gnorm, "s": dt})
            if hb:
                hb.beat(step, loss=loss)
        watchdog.timed(step, t0)

        if ckpt and ((step + 1) % args.ckpt_every == 0 or guard.preempted):
            ckpt.save(step + 1, state, extra={"next_step": step + 1},
                      block=guard.preempted)
        if guard.preempted:
            print(f"[train] preempted at step {step}; checkpoint saved, "
                  f"exiting cleanly", flush=True)
            break

    if ckpt:
        if not guard.preempted:     # JAX saves here after a preemption too,
            ckpt.save(args.steps, state,    # marking the skipped steps done
                      extra={"next_step": args.steps}, block=True)
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
    _one_rank(args)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    return train(cfg, args)["log"]


if __name__ == "__main__":
    main()
