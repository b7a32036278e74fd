"""Serving entry point: seeded-init a model and serve batched requests
through the continuous-batching engine (port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --smoke --device cpu --requests 4 --batch 2 --max-new 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --tp 4 --fusion-mode pallas          # 4 virtual ranks on one card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --decode-steps 8 --sampler temperature --temp 0.8 --top-k 50
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --smoke --device cpu --decode-steps 4   # MoE (any --tp)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --smoke --device cpu --tp 2 --fusion-mode pallas   # also rwkv6-3b

The flags are those of ``repro.launch.serve`` plus ``--device``
(default ``cuda``; the run raises without a GPU unless ``--device cpu``
is given) and ``--devices`` (one device per rank, comma-separated;
default: all ``--tp`` ranks on ``--device``). The mesh is JAX's:
the ranks ``--devices`` lists as (data = n // tp, model = tp)
(``launch.mesh.make_mesh``). On every mesh of more than one rank the
engine serves each rank's shards, born sharded (``lm.init_params(...,
mesh=)``: each rank's blocks drawn on its own device, the whole model
never built; with ``--ckpt-dir`` restored into shards leaf by leaf):
the heads, MLP columns and vocab over ``model``; with data groups the
weights' embed dim also cut over ``data``, decoded weights-stationary,
the KV caches' batch on the data groups:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --smoke --device cpu --devices cpu,cpu,cpu,cpu --tp 2   # (2, 2)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --devices cuda:0,cuda:0,cuda:0,cuda:0 --tp 2   # virtual ranks

``--ckpt-dir`` serves the
parameters of the latest checkpoint there (keys ``params%%...``, as the
JAX package's trainer and the port's write them) instead of seeded
random ones.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.checkpoint.checkpointer import SEP, Checkpointer
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed import context as dctx
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.metrics import percentile


def load_params(ckpt_dir: str, cfg, device="cuda", mesh=None):
    """The parameters held under ``params`` in the latest checkpoint of
    ``ckpt_dir`` (as the JAX package's trainer and the port's write them:
    fp32 masters, or bf16 leaves), and the checkpoint's manifest: one
    :class:`~repro_torch.models.lm.LM` on ``device``, or each rank's
    blocks over a ``mesh`` of W > 1 ranks, in the serving storage dtypes
    (``lm.empty_params`` filled by ``Checkpointer.restore_sharded``: one
    leaf on the host at a time, each block cast after its cut), so no
    device or host ever holds the whole model widened."""
    params = lm.empty_params(cfg, device=device, mesh=mesh)
    ranks = lm.as_ranks(params)
    one = mesh is None or mesh.size == 1
    dims = {} if one else {
        SEP.join(("params", *path.split("."))): d
        for path, d in lm.leaf_specs(cfg, mesh).items()}
    _, manifest = Checkpointer(ckpt_dir).restore_sharded(
        None, [{"params": lm.param_tree(p)} for p in ranks], dims,
        mesh_shape=None if one else mesh.shape, cast=True)
    return params, manifest


def serving_params(cfg, mesh, seed: int = 0, ckpt_dir: str | None = None):
    """What the engine serves on ``mesh``, and the checkpoint's manifest
    (None without ``ckpt_dir``): one :class:`~repro_torch.models.lm.LM`
    at one rank; on a mesh of more than one rank, model-only or with data
    groups, each rank's blocks (``lm.shard_params``'s), born sharded from
    ``seed`` (``lm.init_params(..., mesh=)``) or restored into shards
    from ``ckpt_dir`` (:func:`load_params`): no device holds the whole
    model."""
    m = mesh if mesh.size > 1 else None
    if ckpt_dir:
        return load_params(ckpt_dir, cfg, mesh.devices[0], m)
    return lm.init_params(cfg, seed=seed, device=mesh.devices[0],
                          mesh=m), None


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the model runs; cpu runs the kernels' "
                        "plain PyTorch versions")
    p.add_argument("--ckpt-dir", default=None,
                   help="restore params from a training checkpoint")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--prefill-chunk", type=int, default=8,
                   help="prompt tokens consumed per slot per tick")
    p.add_argument("--decode-steps", type=int, default=1,
                   help="decode megatick length K: one dispatch (one "
                        "CUDA-graph replay on one card) runs K decode "
                        "steps with sampling on the device")
    p.add_argument("--megatick-token-budget", type=int, default=None,
                   help="per-slot token quota of a mixed megatick "
                        "(default max(decode-steps, prefill-chunk))")
    p.add_argument("--stagger", type=int, default=0,
                   help="admit request i no earlier than tick i*STAGGER "
                        "(0 = all at once)")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--tp", type=int, default=1,
                   help="ranks of the model axis")
    p.add_argument("--devices", default=None,
                   help="comma-separated device per rank (default: every "
                        "rank on --device, i.e. virtual ranks)")
    p.add_argument("--fusion-mode", default="auto",
                   choices=("auto", "bsp", "ring", "pallas"))
    p.add_argument("--sampler", default="greedy",
                   choices=("greedy", "temperature"))
    p.add_argument("--scheduler", default="fcfs",
                   choices=("fcfs", "priority", "slo"))
    p.add_argument("--deadline-ms", type=float, default=None)
    p.add_argument("--temp", type=float, default=1.0,
                   help="sampling temperature (temperature sampler)")
    p.add_argument("--top-k", type=int, default=0,
                   help="top-k truncation, 0 = full vocab (temperature "
                        "sampler)")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--kv-blocks", type=int, default=None)
    p.add_argument("--paged-gather", default="bounded",
                   choices=("bounded", "masked"),
                   help="W > 1 paged decode: walk each slot's table "
                        "(bounded) or score the masked whole pool shard "
                        "(masked; the CPU oracle, raises on the card); "
                        "single-device decode always walks the table")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics-file", default=None)
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")

    mesh = make_mesh(args.tp, args.devices, args.device)
    ctx = dctx.DistContext(mesh if mesh.size > 1 else None,
                           args.fusion_mode)
    params, manifest = serving_params(cfg, mesh, args.seed, args.ckpt_dir)
    if manifest is not None:
        print(f"[serve] restored step {manifest['step']}")
    with dctx.use(ctx):
        eng = Engine(params, cfg, batch=args.batch, max_len=args.max_len,
                     prefill_chunk=args.prefill_chunk, sampler=args.sampler,
                     seed=args.seed, block_size=args.block_size,
                     n_blocks=args.kv_blocks, scheduler=args.scheduler,
                     decode_steps=args.decode_steps,
                     megatick_token_budget=args.megatick_token_budget,
                     bounded_gather=args.paged_gather == "bounded",
                     device=mesh.devices[0])
    rng = np.random.default_rng(args.seed + 1)
    for i in range(args.requests):
        plen = min(2 + int(rng.integers(0, 6)), max(1, args.max_len - 2))
        prompt = [int(t) for t in rng.integers(1, cfg.vocab_size, plen)]
        eng.submit(Request(rid=i, prompt=prompt,
                           max_new_tokens=args.max_new,
                           temp=args.temp, top_k=args.top_k,
                           deadline_ms=args.deadline_ms),
                   at_tick=i * args.stagger)
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    lat = [r.finished_t - r.submitted_t for r in done]
    stats = {"device": str(eng.device), "tp": args.tp,
             "mesh": dict(mesh.shape),
             "devices": [str(d) for d in mesh.devices],
             "fusion_mode": args.fusion_mode, "requests": len(done),
             "new_tokens": toks, "wall_s": round(dt, 3),
             "tok_per_s": round(toks / dt, 2),
             "p50_latency_s": round(percentile(lat, 50), 3),
             "p99_latency_s": round(percentile(lat, 99), 3),
             **eng.metrics(done)}
    print(f"[serve] {stats}")
    if args.metrics_file:
        with open(args.metrics_file, "w") as f:
            json.dump(stats, f)
    return {**stats, "streams": {r.rid: list(r.out_tokens) for r in done}}


if __name__ == "__main__":
    main()
