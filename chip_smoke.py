"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--kernels-only | --peers] [--verbose]
    python3 chip_smoke.py --phase 23   # one phase alone: 2, 3, 7, 22, 23

Builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
source, in parallel), then runs, failing on the first phase that fails:

1. device: the card's name and power limit, CUDA present;
2. GEMM kernels vs their plain version at the decode shapes of llama3-8b
   (M 1, 3, 8, 16) and ragged ones, and the grouped launches (wq/wk/wv,
   wg/wu) bit-equal to single-product calls;
3. paged flash-decode kernel vs its plain version at full-width heads;
7. the W-rank kernels vs their plain versions on virtual ranks of
   cuda:0, each over several calls in a row (flag reuse, both inbox
   parities): the fused AG+GEMM (W 2 and 4, the ``wo`` shape and
   ragged ones, one B per card and one per rank), the paged decode over
   4 ranks (fused and partial modes, holes, blocks of every rank), the
   contiguous strided decode (W 1 and 4, with a window, shards that are
   not whole tiles; one launch per card per call in every mode, by the
   counters and the profiler), outputs bit-identical on every rank;
   then the three fused kernels replayed
   from CUDA graphs (alone and AG+GEMM with the paged decode in one
   graph) with fresh inputs, the card's epoch word advancing once per
   fused launch;
4. the smoke llama3-8b (float32) served on the card and on the CPU:
   token-identical greedy streams, equal scheduling counters, per-step
   logits under teacher forcing within tolerance; then K = 8 megaticks
   (one CUDA-graph replay each), greedy and seeded temperature: streams
   identical to the CPU's at K = 1, counters to its K = 8;
8. the same smoke serve over 4 virtual ranks in every fusion mode:
   streams and counters identical to tp=1, at K = 1 and K = 8;
5. full-width llama3-8b (bf16, seeded random weights) served through
   the engine at K = 1, at K = 8 (graph replays; then again on prompts
   of the same lengths for the steady time, each replay timed with CUDA
   events) and at K = 8 with the megatick loop run eagerly, with both
   W=1 kernels' launch counters read around each serve (decode steps
   from the engine's scan lengths and the graphs' warm-up steps); then
   one K = 8 serve on two engines in lockstep, graph replays against
   the eager loop: tokens, ``cur_len``, tables and KV bytes identical;
9. the same weights over 4 virtual ranks under ``pallas``: short serves
   at K = 1 and K = 8 and a few contiguous-cache decode steps (over the
   4 ranks, then on one) with every kernel's counters read around them,
   and teacher-forced logits vs tp=1 and across gather widths;
19. three taxes, static vs card, on the same weights: (a) the port's
   lint (``repro_torch.analysis``) over ``src/repro_torch`` and this
   file, in-process: no finding, the justified suppressions, each
   budgeted function's proven (dispatches, readbacks) per call and per
   graph key; (b) phase 5's traffic served at K = 8 (pure and mixed
   megaticks), at K = 1 (temperature sampler) and at K = 8 over 4
   virtual ranks under ``pallas``, replicated and on per-rank weight
   shards, every call of ``_megatick``,
   ``_megatick_mixed`` and ``_tick`` counted on the card (graph replays
   and program calls; synchronising calls under
   ``set_sync_debug_mode("warn")``) and held to the static budget;
20. decode over weight shards (JAX's serve step on ``param_shardings``),
   on the same weights cut by ``lm.shard_params`` over 4 virtual ranks
   (each rank's GB: 1/4 of the sharded leaves): phase 9's traffic at
   K = 8 (graph replays) under ``pallas`` (row-parallel weights
   all-gathered into the fused AG+GEMM) and ``auto`` (partial products
   summed in fp32), launches exact a step, first tokens against phase
   9's, steady tok/s, device ms and peak beside phase 9's, a profiled
   ``pallas`` step; teacher-forced logits vs tp 1 (bf16, and float32
   at 2 layers within one bf16 ulp); ``steps.jitted_serve_step``'s
   function over the contiguous state vs tp 1. Phases 14c, 15c and 16c
   each shard their model the same way for one teacher-forced chunk
   (launches exact, logits vs tp 1);
22. serving on a (data 2, model 2) mesh of virtual ranks of cuda:0,
   after phase 20 (each rank's shards, the ``embed`` dim cut over
   ``data`` and decoded weights-stationary; the pool over the 4 ranks):
   (a) the float32 smoke llama3-8b served with a prefix hit, a copy on
   write and a preemption at K = 8 and K = 1 under ``pallas`` and
   ``auto``: the card vs the CPU mesh vs the card's (1, 1), streams and
   counters identical; (b) phase 5's full-width weights on the mesh,
   each rank's bytes to the byte of the rules and its KV pool, phase
   9's traffic at K = 8 under ``pallas`` and ``auto``: launches exact a
   step (``data_mesh_per_step``), steady tok/s, ms a step, peak, no
   stream in error; (c) the GEMM over one ``auto`` step's products on
   the shards' data blocks and the fused paged decode over the 4
   sources, each graph-timed beside its plain version, one library call
   and its bound (kernel lines ``matmul_data_mesh``,
   ``flash_decode_paged_fused_data_mesh``);
23. parameters born sharded, after phase 22 (``lm.init_params(...,
   mesh=)``, each rank's blocks drawn on its device, no whole model):
   (a) llama3-8b at full width over 4 virtual ranks bit-equal to
   ``lm.shard_params`` of phase 5's model, the init's peak increment
   within the shards' bytes plus one draw and its cast; (b) the serving
   CLI (``launch.serve.main``) at ``--tp 4 --fusion-mode pallas`` and on
   ``--devices cuda:0,cuda:0,cuda:0,cuda:0 --tp 2`` with phase 9's
   batch and budget at K = 1: launches exact a step, each rank's bytes
   the rules', its peak increment, finite logits on its shards; (c) the
   float32 smoke model through the CLI at ``--tp 4`` token-identical to
   ``--tp 1``. ``--phase 23`` alone adds the CLI at ``--tp 4`` at K = 8
   in ``pallas`` and ``auto``: its steady rate and ms a step;
11. the robustness plane: (a), right after phase 8, phase 4's smoke
   serve at K = 8 under a fault plan (a dispatch failing twice, a slow
   tick, a pool spike that preempts between pure-megatick graph
   replays, a poisoned slot), drained, snapshotted and restored into a
   fresh engine, greedy and temperature: on the card, on the CPU and
   over 4 virtual ranks under ``pallas``, streams and counters
   identical, the resumed requests as the uninterrupted run's; (b),
   after phase 9, full-width llama3-8b through the SSE server
   (``repro_torch.launch.server``, built by its CLI with a chaos plan)
   driven by the port's client: a poisoned stream, a hang-up, a
   preemption between replays, ``/admin/drain`` into a checkpoint,
   ``/readyz`` 503, and a second server with ``--resume`` finishing the
   drained requests as prefix hits (the kernels' counters read around
   the serve);
12. the training path, after phase 9's weights are freed: (a) the GEMM
   kernel vs its plain version at the shapes of a full-width training
   step (the seven projections and the fp32 unembed at M = 2048,
   forward, dA by both routes, dB), each timed beside its plain
   version and ``torch.matmul``; (b) the float32 smoke model trained 4
   steps on the card and on the CPU from the same parameters (first
   gradients leaf by leaf, losses, grad norms, parameters), every leaf
   with a gradient, the GEMM's counters, and a checkpoint after step 2
   resumed to step 4 against the uninterrupted run; (c) llama3-8b at
   full width with 4 of its 32 layers (fp32 AdamW state does not fit
   one card at full depth), 6 steps of 2 x 1024 tokens through
   ``repro_torch.launch.train``: losses finite and falling, GEMM
   launches per step, peak memory, ms per step, tokens/s, executed
   TFLOP/s, and one profiled step for the GEMM's device time;
13. training over 4 virtual ranks of cuda:0, after phase 12: (a) the
   train sites' sequence-parallel AG+GEMM (wq, wg) and GEMM+RS (wd) at
   full-width training shapes in ``bsp`` and ``ring_bidir``, forward
   and both gradients, vs one single-rank product (float32 and bf16),
   each site's device ms and GEMM launches; (b) the float32 smoke model
   at tp 4 on the card vs tp 4 on the CPU and tp 1 on the card (first
   loss and every gradient leaf), and a tp 4 checkpoint resumed at tp
   1 vs the uninterrupted run; (c) llama3-8b at full width, 4 of 32
   layers, tp 4 under ``ring``, 4 steps of 2 x 1024 tokens: losses
   finite, the first beside 12c's, GEMM launches per step, ms per step,
   tokens/s, peak memory, and one profiled step (busy share, GEMM ms);
21. training on a data x model mesh, after phase 13 (FSDP on ``data``,
   the batch's rows over the data groups, ``distributed.fsdp``): (a)
   the float32 smoke model at (data 2, model 2) on 4 virtual ranks of
   cuda:0 vs the same mesh on the CPU and vs one rank on the card (first
   loss, every global gradient leaf); (b) llama3-8b at full width, 4 of
   32 layers, (2, 2) under 13c's ``ring``, 3 steps of 2 x 1024 tokens
   (one row a data group): each rank's fp32 masters at the rules' bytes
   (1.923 GB; 7.69 GB with grads, m and v), losses finite, the first
   beside 13c's, GEMM launches per step exact (``dm_products``), ms per
   step, tokens/s, peak memory, a profiled step, every product timed;
   (c) ``grad_compress``: ``compress_int8`` card vs CPU bit for bit,
   ``compressed_psum_tree`` over the mesh's data groups card vs CPU;
14. the MoE family, after phase 13: (a) the GEMM's batched mode
   (``matmul_batched``, one launch for all experts) vs its plain version
   at olmoe-1b-7b's expert products (decode: E 64, M 1, 8, 16, both
   projections, bf16 and f32; training: M 320, forward and both
   gradients; ragged batches), each timed beside its plain version and
   ``torch.bmm``; (b) the float32 olmoe-smoke served on the card and on
   the CPU (K = 1 and K = 8, greedy and temperature; over 4 virtual
   ranks under ``pallas``), streams and counters identical, and one
   K = 8 replay under sync-debug "error"; (c) olmoe-1b-7b at full width
   (16 layers, bf16, seeded weights, nothing cut) served with phase 5's
   traffic at K = 1 and K = 8 (launches per step counted), finite
   logits, graph vs eager in lockstep, a profiled step; (d) the smoke
   model trained 3 steps on the card vs the CPU (loss with the aux,
   every gradient leaf), then olmoe at full width with 4 of 16 layers,
   4 steps of 2 x 1024 tokens: losses finite, launches, ms per step,
   tokens/s, executed TFLOP/s, peak memory;
15. the recurrent families, after phase 14: (a) the paged decode at
   zamba2's heads (hd 64, q_per_kv 1) vs its plain version at W = 1
   and fused over 4 virtual ranks, and the GEMM at each model's decode
   products (the new shapes, zamba2's in_proj N 8384, rwkv's fp32 LoRA
   and its d_ff 8960, at M 1, 8 and 2048), each timed beside its plain
   version and ``torch.matmul``; then for zamba2-1.2b and rwkv6-3b in
   turn: (b) the float32 smoke model served on the card and on the CPU
   (K = 1, K = 8 greedy and temperature, over 4 virtual ranks under
   ``pallas``), streams and counters identical, teacher-forced decode
   steps (paged; contiguous for the hybrid) card vs CPU, a snapshot and
   restore mid-serve that resumes as the uninterrupted run; (c) the
   model at full width (nothing cut) with phase 5's traffic, K = 1 on 4
   requests and K = 8 on 8 plus the steady rerun, launches per step
   exact (zamba2 101 GEMM + 6 paged decodes, rwkv 289 GEMM), graph vs
   eager in lockstep down to every recurrent byte, a profiled step
   split into GEMM, paged decode and the rest; (d) the smoke model
   trained 3 steps card vs CPU, then the model at full width and depth
   3 steps of 2 x 1024 tokens: losses finite, GEMM launches per step,
   ms per step, tokens/s, peak memory;
16. the vlm and audio frontends, after phase 15: (a) both decode
   kernels at paligemma's heads (8 query heads per KV head of 256, two
   units of 4 heads) vs their plain versions, bf16 and f32: the paged
   decode at W = 1 and fused over 4 virtual ranks, the contiguous one at
   W = 1 and fused; the GEMM at paligemma's decode products (wq/wk/wv
   2048 -> 2048/256/256, wg/wu 2048 -> 16384, wd, the tied fp32 unembed
   N 257216) timed beside its plain version and ``torch.matmul``; (b)
   the float32 paligemma-smoke served on the card and on the CPU (K = 1,
   K = 8, over 4 virtual ranks under ``pallas``), streams and counters
   identical; hubert-smoke refused by the engine; both smoke models
   trained 3 steps with patches / frames through ``launch.steps``, card
   vs CPU and tp 4 vs tp 1; (c) paligemma-3b at full width (nothing
   cut) with phase 5's traffic at K = 1 (4 requests) and K = 8 (+ the
   steady rerun), launches exact a step (73 GEMM + 18 paged decodes),
   finite logits, contiguous-cache decode steps (18 contiguous decodes a
   step); (d) paligemma-3b (2 x (1024 tokens + 256 patches)) and
   hubert-xlarge (2 x 1024 frames) trained 3 steps at full width and
   depth: losses finite, GEMM launches per step exact, ms per step,
   tokens/s, peak memory, and every product of the step timed;
17. the ``"dots"`` remat policy and training every family over W ranks,
   after phase 16: (a) the float32 llama3-8b smoke model one step under
   ``"full"`` and ``"dots"`` on the card and on the CPU (losses and
   every gradient leaf across policies and devices; the forward's and
   the backward's GEMM launches by the counter and the profiler: under
   ``"dots"`` no layer forward product comes back), then 12c's
   configuration 3 steps under each policy (the config's
   ``remat_policy``): ms per step, peak memory, launches, one profiled
   step's GEMM ms, and the ``"dots"`` step's products timed; (b) the
   float32 smoke models of olmoe, mixtral, zamba2 and rwkv6 trained 3
   steps over 4 virtual ranks under ``ring`` vs tp 4 on the CPU and tp
   1 on the card, and zamba2's tp 4 checkpoint resumed at tp 1; (c)
   olmoe-1b-7b (4 of 16 layers), zamba2-1.2b (all 38) and rwkv6-3b (12
   of 32) at full width over 4 virtual ranks, 3 steps of 2 x 1024
   tokens: losses finite, launches exact, ms per step, tokens/s, peak
   memory, every product of the step timed beside its plain version
   and ``torch.matmul``/``torch.bmm`` with its bound;
6. W=1 kernel timings (the GEMM per shape and per group, its latency
   floor, the host's time per call of the GEMM wrappers beside
   ``torch.matmul``'s, and the sampler's time per step) and
10. W-rank kernel timings (and the contiguous decode at W = 1), both in
   CUDA-graph replays, each beside its bound, plain version and one
   PyTorch library call (phase 10 also times an empty cooperative
   launch of the paged decode's grid, its latency floor);
18. then the port's dry run (``repro_torch.launch.dryrun``:
   each step traced on fake CPU tensors at the phase's own depth) beside
   the numbers phases 5, 12c, 13c, 14d, 16d, 17a and 20 stored: per-rank
   peak vs ``max_memory_allocated`` (within 15% at one rank a card),
   FLOPs vs the executed count (12c, 14d: within 2%), the bound vs the
   measured ms; then the three-taxes model's fixed costs on the card
   (an empty kernel's launch, a ``bsp`` barrier at no bytes over 4
   virtual ranks) beside ``core.taxes.H100``'s, and a 2 GB copy's rate.

Every bound is ``repro_torch.roofline.hw.bound_s`` (the data sheet's
peaks and memory rate); ``--bounds-against FILE`` prints each kernel
line's bound beside the same line's in an earlier run's
``chip_smoke.json`` and fails where they differ in 3 significant
digits. ``--kernels-only`` stops after phases 1-3 and 7; ``--peers`` (two or
more cards) then runs phase 7's checks and wall times with one rank per
card beside virtual ranks, and stops; ``--verbose`` prints the
compiler's ``ptxas -v`` report. Prints one ``{"kernels": [...]}``
line, the total seconds, the ``nvidia-smi`` name/power line, and as
its last line
``{"ok": true, "device": {...}}``. Longer per-shape tables go to
``OUT_DIR/chip_smoke.json``. Exits non-zero, printing no result,
without a GPU or outside a checkout of the repo.
"""
from __future__ import annotations

import copy
import ctypes
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")   # git-ignored run outputs


def _hw():
    """``repro_torch.roofline.hw``: the card's data sheet and its bound
    (imported where used: ``main`` puts ``src`` on the path)."""
    from repro_torch.roofline import hw
    return hw


def bound(ops, bytes_, dtype=None):
    """(seconds, "bytes" or "operations"): the least time the card takes
    for ``ops`` operations of ``dtype`` (or a list of (ops, dtype)) that
    move ``bytes_`` bytes (``roofline.hw.bound_s``)."""
    return _hw().bound_s(ops, bytes_, dtype)


def ops_s(ops, dtype) -> float:
    """Seconds of ``ops`` operations at the card's peak for ``dtype``."""
    return ops / _hw().H100.peak(dtype)


def bytes_s(n) -> float:
    """Seconds to move ``n`` bytes at the card's memory rate."""
    return n / _hw().H100.hbm_bw


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of one ``fn()`` call, from CUDA events around
    ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20):
    """Mean device time of one ``fn()`` call with the host's launch cost
    taken out: ``iters`` calls are captured in one CUDA graph and the
    replays are timed with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * iters)


# the __global__ functions of csrc/*.cu, as the profiler names them
# ("(anonymous namespace)::<name><T, ...>(...)")
PORT_KERNELS = ("gemm_stream", "mm_kernel", "fd_paged", "fd_strided",
                "ag_gemm_kernel")


def port_kernel(name: str, key: str) -> bool:
    """Whether profiler entry ``key`` is csrc kernel ``name``."""
    return f"::{name}<" in key


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ----------------------------------------------------------------- phases
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and line, f"nvidia-smi failed: {smi.stderr}")
    check(torch.cuda.is_available(), "CUDA not available")
    print(f"[device] {line} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    return line


def gemm_cases():
    """(name, M, K, N, dtype, trans_b, count per decode step) of the
    llama3-8b decode path; M is the batch."""
    shapes = [("wq", 4096, 4096), ("wk", 4096, 1024), ("wv", 4096, 1024),
              ("wo", 4096, 4096), ("wg", 4096, 14336), ("wu", 4096, 14336),
              ("wd", 14336, 4096)]
    return [(n, K, N, torch.bfloat16, False, 32) for n, K, N in shapes] + \
        [("unembed", 4096, 128256, torch.float32, True, 1)]


GEMM_GROUPS = (("wqkv", ("wq", "wk", "wv")), ("wgu", ("wg", "wu")))


def _gemm_operands(gen, M, K, N, dtype, trans_b):
    a = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    bshape = (N, K) if trans_b else (K, N)
    b = (torch.randn(bshape, generator=gen, device="cuda")
         / K ** 0.5).to(dtype)
    return a, b


def _gemm_err(got, want, dt, what):
    """GEMM kernel vs plain: f32 within 1e-4 of the largest |C| (fp32
    sums in another order); bf16 within 1 ulp (rtol 1e-2) -- both round
    an fp32 sum to bf16 -- plus 1e-4 of the largest |C| for sums near
    zero. Returns the max |err|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = want.abs().max().item()
    if dt == torch.float32:
        ok = err.max().item() <= 1e-4 * scale
    else:
        ok = bool((err <= 1e-2 * want.abs() + 1e-4 * scale).all())
    check(ok, f"{what}: max err {err.max().item():.3e} (scale "
              f"{scale:.3e})")
    return err.max().item()


def phase_gemm(gen):
    """(2) the GEMM kernels vs the plain version at the llama3-8b decode
    shapes (M = batch 1, 3, 8, 16) and ragged ones, then the grouped
    launches (wq/wk/wv, wg/wu): bit-equal to single-product calls and
    within the GEMM's tolerance of the plain version."""
    from repro_torch.kernels.matmul import matmul, matmul_group, matmul_plain
    worst = 0.0
    cases = [(n, M, K, N, dt, tb) for (n, K, N, dt, tb, _) in gemm_cases()
             for M in (1, 3, 8, 16)]
    # general kernel (rows not whole 16-byte words), then the streaming
    # kernel's ragged tiles, strips and M tiles
    cases += [("ragged", 5, 100, 77, torch.bfloat16, False),
              ("ragged", 5, 100, 77, torch.float32, False),
              ("ragged_t", 5, 100, 77, torch.float32, True),
              ("ragged_t", 5, 136, 77, torch.bfloat16, True),
              ("ragged_tma", 20, 136, 1000, torch.bfloat16, False),
              ("ragged_tma", 20, 136, 1000, torch.float32, False)]
    for name, M, K, N, dt, tb in cases:
        a, b = _gemm_operands(gen, M, K, N, dt, tb)
        got = matmul(a, b, trans_b=tb)
        want = matmul_plain(a, b, tb)
        torch.cuda.synchronize()
        err = _gemm_err(got, want, dt, f"GEMM {name} M={M} K={K} N={N} "
                                       f"{dt}")
        if not name.startswith("ragged"):
            worst = max(worst, err)
    shapes = {n: (K, N) for n, K, N, _, _, _ in gemm_cases()}
    n_groups = 0
    for gname, members in GEMM_GROUPS:
        K = shapes[members[0]][0]
        for M in (1, 3, 8, 16):
            a = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            bs = [(torch.randn((K, shapes[m][1]), generator=gen,
                               device="cuda") / K ** 0.5).to(torch.bfloat16)
                  for m in members]
            n0 = matmul.launches
            got = matmul_group(a, bs)
            check(matmul.launches == n0 + 1, f"GEMM group {gname}: "
                  f"{matmul.launches - n0} launches, not 1")
            for m, b, c in zip(members, bs, got):
                single = matmul(a, b)
                torch.cuda.synchronize()
                check(torch.equal(c, single), f"GEMM group {gname} M={M}: "
                      f"{m} differs from its single-product call")
                worst = max(worst, _gemm_err(
                    c, matmul_plain(a, b), torch.bfloat16,
                    f"GEMM group {gname} M={M} {m}"))
            n_groups += 1
    print(f"[gemm] {len(cases)} cases and {n_groups} grouped launches "
          f"match the plain version, groups bit-equal to single calls "
          f"(max |err| {worst:.3e})", flush=True)
    return worst


def _decode_inputs(gen, dtype, B=8, H=32, KVH=8, D=128, bs=16, C=32,
                   n_blocks=512):
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((n_blocks, bs, KVH, D), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((n_blocks, bs, KVH, D), generator=gen,
                     device="cuda").to(dtype)
    perm = torch.randperm(n_blocks, generator=gen, device="cuda")
    tables = perm[:B * 2 * C].reshape(B, 2 * C).to(torch.int32)
    return q, kp, vp, tables


def phase_decode(gen):
    from repro_torch.kernels.flash_decode import (flash_decode_paged,
                                                  paged_decode_plain)
    bs, C = 16, 32
    worst = 0.0
    n = 0
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, kp, vp, full = _decode_inputs(gen, dtype, bs=bs, C=C)
        # cur_len 1, bs, bs+1, a full table, and ragged others
        cur = torch.tensor([1, bs, bs + 1, C * bs, 37, 200, 511, 130],
                           dtype=torch.int32, device="cuda")
        holes = full.clone()
        holes[4, 0] = -1           # reclaim holes (skipped entries)
        holes[6, 3:5] = -1
        for name, tables, window in (
                ("full", full[:, :C], None), ("holes", holes[:, :C], None),
                ("window32", holes[:, :C], 32),
                ("gather_slice", full[:, :C // 2], None)):
            cl = cur.clamp(max=tables.shape[1] * bs)
            got = flash_decode_paged(q, kp, vp, cl, tables, 128 ** -0.5,
                                     window=window).float()
            want = paged_decode_plain(q, kp, vp, cl, tables, 128 ** -0.5,
                                      window=window).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(err <= tol, f"decode {name} {dtype}: max err {err:.3e} "
                              f"> {tol}")
            if name == "gather_slice":
                check(not tables.is_contiguous(), "the slice must be a "
                                                  "strided view")
            worst = max(worst, err)
            n += 1
    print(f"[decode] {n} cases match the plain version (max |err| "
          f"{worst:.3e})", flush=True)
    return worst


def _close(got, want, dtype, what):
    """Kernel vs plain: f32 within 1e-5 (sums in another order), bf16
    within 2e-2 (outputs of magnitude ~1 rounded to bf16 by both, an
    ulp being 2**-7 relative); returns the max |err|."""
    err = (got.float() - want.float()).abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    check(err <= tol, f"{what}: max err {err:.3e} > {tol}")
    return err


VIRTUAL = (["cuda:0"] * 2, ["cuda:0"] * 4)     # virtual ranks of one card


def _sync(devs):
    for d in dict.fromkeys(devs):
        torch.cuda.synchronize(d)


def phase_ag_gemm(gen, epochs=3, rank_sets=VIRTUAL):
    """(7a) fused AG+GEMM vs its plain version on each set of rank
    devices, at the ``wo`` shape and ragged ones, ``epochs`` calls in a
    row with fresh inputs (flag reuse, both inbox parities); even calls
    pass one B per card (one product per card), odd ones a copy per
    rank (a product per rank). Outputs must be bit-identical on every
    rank."""
    from repro_torch.distributed.context import Mesh
    from repro_torch.kernels.ag_gemm import ag_gemm_fused, ag_gemm_plain
    worst, n = 0.0, 0
    for devs in rank_sets:
        W = len(devs)
        mesh = Mesh(devs)
        for M, k, N, dt in ((8, 4096 // W, 4096, torch.bfloat16),
                            (5, 37, 77, torch.float32),
                            (20, 48, 136, torch.float32),
                            (3, 64, 200, torch.bfloat16)):
            for ep in range(epochs):
                a, b = _gemm_operands(gen, M, W * k, N, dt, False)
                shards = [a[:, r * k:(r + 1) * k].contiguous()
                          for r in range(W)]
                bs_ = [b.to(d) if ep % 2 == 0 else b.to(d, copy=True)
                       for d in devs]
                got = ag_gemm_fused([x.to(d) for x, d in zip(shards, devs)],
                                    bs_, mesh)
                want = ag_gemm_plain(shards, [b])[0]
                _sync(devs)
                for r in range(W):
                    check(torch.equal(got[r].to("cuda:0"), got[0].to(
                        "cuda:0")), f"ag_gemm {devs} M={M} N={N} {dt} "
                                    f"epoch {ep}: rank {r}'s output differs "
                                    f"from rank 0's")
                    err = _gemm_err(got[r].to("cuda:0"), want, dt,
                                      f"ag_gemm {devs} M={M} K={W * k} "
                                      f"N={N} {dt} epoch {ep} rank {r}")
                    if dt == torch.bfloat16 and N == 4096:
                        worst = max(worst, err)
                n += 1
    print(f"[ag_gemm] {n} calls on ranks {[len(d) for d in rank_sets]} x "
          f"{sorted({x for d in rank_sets for x in d})} match the plain "
          f"version, outputs bit-identical across ranks (max |err| at the "
          f"wo shape {worst:.3e})", flush=True)
    return worst


def _paged_ranks_inputs(gen, dtype, W, B=8, H=32, KVH=8, D=128, bs=16,
                        n_blocks=512, C=16):
    """Paged W-rank inputs: pool shards of n_blocks / W blocks, tables
    drawn from the whole pool (blocks of every rank), holes, ragged
    lengths."""
    q, kp, vp, full = _decode_inputs(gen, dtype, B=B, H=H, KVH=KVH, D=D,
                                     bs=bs, C=C, n_blocks=n_blocks)
    tables = full[:, :C].contiguous()
    tables[1, 0] = -1
    tables[5, 2:4] = -1
    n_loc = n_blocks // W
    kps = [kp[r * n_loc:(r + 1) * n_loc].contiguous() for r in range(W)]
    vps = [vp[r * n_loc:(r + 1) * n_loc].contiguous() for r in range(W)]
    cur = torch.tensor([1, 40, bs, bs + 1, 100, 200, C * bs, 77],
                       dtype=torch.int32, device="cuda")[:B]
    return q, kps, vps, cur, tables


def phase_paged_ranks(gen, epochs=3, rank_sets=(["cuda:0"] * 4,)):
    """(7b) paged flash decode over W ranks: the fused mode (push +
    per-source combine) and the partial mode vs plain."""
    from repro_torch.core.flash_decode import combine_bsp, finalize
    from repro_torch.distributed.context import Mesh
    from repro_torch.kernels import flash_decode as kfd
    scale = 128 ** -0.5
    worst, n = 0.0, 0
    for devs in rank_sets:
        W = len(devs)
        mesh = Mesh(devs)
        for dt in (torch.float32, torch.bfloat16):
            for window in (None, 48):
                for ep in range(epochs):
                    q, kps, vps, cur, tb = _paged_ranks_inputs(gen, dt, W)
                    n_loc = kps[0].shape[0]
                    args = ([q.to(d) for d in devs],
                            [x.to(d) for x, d in zip(kps, devs)],
                            [x.to(d) for x, d in zip(vps, devs)],
                            [cur.to(d) for d in devs],
                            [tb.to(d) for d in devs], scale)
                    got = kfd.flash_decode_paged_fused(*args, window=window,
                                                       mesh=mesh)
                    parts = [kfd.paged_partial_plain(q, kps[r], vps[r], cur,
                                                     tb, scale, window,
                                                     base=r * n_loc)
                             for r in range(W)]
                    want = kfd.fused_plain(parts, dt)[0]
                    got_p = kfd.flash_decode_paged_partial(*args,
                                                           window=window)
                    _sync(devs)
                    what = f"paged {devs} {dt} window {window} epoch {ep}"
                    got = [o.to("cuda:0") for o in got]
                    for r in range(W):
                        check(torch.equal(got[r], got[0]),
                              f"{what}: rank {r}'s output differs from "
                              f"rank 0's")
                    worst = max(worst, _close(got[0], want, dt,
                                              what + " fused"))
                    comb = finalize(combine_bsp(
                        [tuple(t.to("cuda:0") for t in p) for p in got_p]
                    )[0]).to(dt)
                    _close(comb, want, dt, what + " partial")
                    n += 1
    print(f"[paged W>1] {n} fused + partial calls match the plain version, "
          f"outputs bit-identical across ranks (max |err| {worst:.3e})",
          flush=True)
    return worst


def _strided_inputs(gen, dtype, W, B=8, H=32, KVH=8, D=128, S_max=512):
    """Strided W-rank inputs; S_max 600 gives shards of S_max / W rows
    that are not whole tiles of 16 at W = 4 (150 rows)."""
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S_max, KVH, D), generator=gen, device="cuda") \
        .to(dtype)
    v = torch.randn((B, S_max, KVH, D), generator=gen, device="cuda") \
        .to(dtype)
    S = S_max // W
    ks = [k[:, r * S:(r + 1) * S].contiguous() for r in range(W)]
    vs = [v[:, r * S:(r + 1) * S].contiguous() for r in range(W)]
    cur = torch.tensor([1, 2, 63, 64, 65, 300, 511, 512], dtype=torch.int32,
                       device="cuda")[:B]
    return q, ks, vs, cur


def _kernel_launches(fn, name, traces=3):
    """Launches of csrc kernel ``name`` (and of all the port's kernels)
    in one ``fn()`` call, from the profiler's device trace, and the
    number of ``fn()`` calls made. A trace that holds no kernel of the
    port at all lost its device records (on the H100 one such trace in
    a run, of a call the wrapper counted: PERF.md §7): the call is traced
    again, up to ``traces`` times; any trace with records counts."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()                  # buffers sized, lib loaded
    for t in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        port = sum(e.count for e in ev for k in PORT_KERNELS
                   if port_kernel(k, e.key))
        if port:
            break
    return (sum(e.count for e in ev if port_kernel(name, e.key)), port,
            t + 2)


def phase_strided(gen, epochs=3, rank_sets=(["cuda:0"], ["cuda:0"] * 4)):
    """(7c) contiguous strided flash decode, fused (at W = 1 the
    single-source path) and its partial mode, vs plain, also over shards
    that are not whole tiles; then one call of each mode is counted by
    the wrappers' counters and in the profiler's device trace: one
    launch per card per call."""
    from repro_torch.core.flash_decode import combine_bsp, finalize
    from repro_torch.distributed.context import Mesh
    from repro_torch.kernels import flash_decode as kfd
    scale = 128 ** -0.5
    worst, n = 0.0, 0
    for devs in rank_sets:
        W = len(devs)
        mesh = Mesh(devs)
        for dt in (torch.float32, torch.bfloat16):
            for window, S_max, n_ep in ((None, 512, epochs),
                                        (100, 512, epochs),
                                        (100, 600, 1)):
                for ep in range(n_ep):
                    q, ks, vs, cur = _strided_inputs(gen, dt, W,
                                                     S_max=S_max)
                    args = ([q.to(d) for d in devs],
                            [x.to(d) for x, d in zip(ks, devs)],
                            [x.to(d) for x, d in zip(vs, devs)],
                            [cur.to(d) for d in devs], scale)
                    got = kfd.flash_decode_fused(*args, window=window,
                                                 mesh=mesh)
                    parts = [kfd.strided_partial_plain(q, ks[r], vs[r], cur,
                                                       scale, window, r, W)
                             for r in range(W)]
                    want = kfd.fused_plain(parts, dt)[0]
                    got_p = kfd.flash_decode_partial(*args, window=window)
                    _sync(devs)
                    what = (f"strided {devs} {dt} S_max {S_max} window "
                            f"{window} epoch {ep}")
                    got = [o.to("cuda:0") for o in got]
                    for r in range(W):
                        check(torch.equal(got[r], got[0]),
                              f"{what}: rank {r}'s output differs")
                    worst = max(worst, _close(got[0], want, dt,
                                              what + " fused"))
                    comb = finalize(combine_bsp(
                        [tuple(t.to("cuda:0") for t in p) for p in got_p]
                    )[0]).to(dt)
                    _close(comb, want, dt, what + " partial")
                    n += 1
    counted = []
    for devs in rank_sets:
        W = len(devs)
        mesh = Mesh(devs)
        q, ks, vs, cur = _strided_inputs(gen, torch.bfloat16, W)
        args = ([q.to(d) for d in devs], [x.to(d) for x, d in zip(ks, devs)],
                [x.to(d) for x, d in zip(vs, devs)],
                [cur.to(d) for d in devs], scale)
        cards = len(set(devs))
        for mode, wrapper, call in (
                ("NORMAL" if W == 1 else "FUSED", kfd.flash_decode_fused,
                 lambda: kfd.flash_decode_fused(*args, mesh=mesh)),
                ("PARTIAL", kfd.flash_decode_partial,
                 lambda: kfd.flash_decode_partial(*args))):
            n0 = wrapper.launches
            mine, port, calls = _kernel_launches(call, "fd_strided")
            counter = (wrapper.launches - n0) / calls  # warm-up + traces
            check(counter == cards and mine == cards and port == cards,
                  f"strided W={W} {mode}: {counter} counted, {mine} "
                  f"fd_strided and {port} port kernels traced per call "
                  f"({calls - 1} traces); want {cards}")
            counted.append(f"W={W} {mode}"
                           + (f" ({calls - 1} traces)" if calls > 2 else ""))
    print(f"[strided] {n} fused + partial calls match the plain version "
          f"(max |err| {worst:.3e}); one launch per card per call, by the "
          f"counters and the profiler: {', '.join(counted)}", flush=True)
    return worst


def phase_graph_replays(gen, W=4, reps=3):
    """(7d) the three fused kernels captured in CUDA graphs on W virtual
    ranks at phase 7's shapes: each alone, then the AG+GEMM and the
    fused paged decode in one graph. Every replay, with fresh inputs
    copied into the captured tensors, must match the plain version with
    outputs bit-identical on every rank, and the card's epoch word must
    advance once per fused launch (a replay waits for its own pushes)."""
    from repro_torch.distributed.context import Mesh
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels.ag_gemm import ag_gemm_fused, ag_gemm_plain
    bf16, scale = torch.bfloat16, 128 ** -0.5
    mesh = Mesh(["cuda:0"] * W)
    M, k, N = 8, 4096 // W, 4096
    a_st = [torch.empty((M, k), dtype=bf16, device="cuda")
            for _ in range(W)]
    b_st = torch.empty((W * k, N), dtype=bf16, device="cuda")
    pg = _paged_ranks_inputs(gen, bf16, W)
    st = _strided_inputs(gen, bf16, W)

    def refill(static, new):
        for dst, src in zip(static, new):
            for d, s_ in zip(*(x if isinstance(x, list) else [x]
                               for x in (dst, src))):
                d.copy_(s_)

    def fill_ag():
        a, b = _gemm_operands(gen, M, W * k, N, bf16, False)
        for r in range(W):
            a_st[r].copy_(a[:, r * k:(r + 1) * k])
        b_st.copy_(b)
        return ag_gemm_plain([a], [b])[0]

    def fill_paged():
        new = _paged_ranks_inputs(gen, bf16, W)
        refill(pg, new)
        q, kps, vps, cur, tb = new
        n_loc = kps[0].shape[0]
        return kfd.fused_plain(
            [kfd.paged_partial_plain(q, kps[r], vps[r], cur, tb, scale,
                                     None, base=r * n_loc)
             for r in range(W)], bf16)[0]

    def fill_strided():
        new = _strided_inputs(gen, bf16, W)
        refill(st, new)
        q, ks, vs, cur = new
        return kfd.fused_plain(
            [kfd.strided_partial_plain(q, ks[r], vs[r], cur, scale, None,
                                       r, W) for r in range(W)], bf16)[0]

    kernels = {
        "ag_gemm_fused": (fill_ag, lambda: ag_gemm_fused(
            a_st, [b_st] * W, mesh), _gemm_err),
        "flash_decode_paged_fused": (fill_paged, lambda:
                                     kfd.flash_decode_paged_fused(
                                         [pg[0]] * W, pg[1], pg[2],
                                         [pg[3]] * W, [pg[4]] * W, scale,
                                         mesh=mesh), _close),
        "flash_decode_fused": (fill_strided, lambda: kfd.flash_decode_fused(
            [st[0]] * W, st[1], st[2], [st[3]] * W, scale, mesh=mesh),
            _close)}
    n = 0
    for names in (["ag_gemm_fused"], ["flash_decode_paged_fused"],
                  ["flash_decode_fused"],
                  ["ag_gemm_fused", "flash_decode_paged_fused"]):
        for name in names:                  # warm-up: sizes the buffers
            kernels[name][0]()
            kernels[name][1]()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [kernels[name][1]() for name in names]
        torch.cuda.synchronize()
        e0 = mesh.symm.epoch()
        for rep in range(reps):
            wants = [kernels[name][0]() for name in names]
            graph.replay()
            torch.cuda.synchronize()
            for name, out, want in zip(names, outs, wants):
                what = f"graph {names} replay {rep}: {name}"
                for r in range(W):
                    check(torch.equal(out[r], out[0]),
                          f"{what}: rank {r}'s output differs")
                kernels[name][2](out[0], want, bf16, what)
            e = mesh.symm.epoch()
            check(e == e0 + len(names) * (rep + 1),
                  f"graph {names}: epoch word {e} after replay {rep}, "
                  f"expected {e0 + len(names) * (rep + 1)}")
            n += 1
        del graph
    print(f"[graphs] {n} CUDA-graph replays of the fused kernels (each "
          f"alone, AG+GEMM with the paged decode) match the plain version, "
          f"bit-identical across ranks; the epoch word advanced once per "
          f"fused launch", flush=True)


def wall_ms(fn, devs, iters=50):
    """Mean host wall time of one ``fn()`` call over ``iters`` calls,
    every device of ``devs`` synchronised before and after (launch cost
    included)."""
    for _ in range(3):
        fn()
    _sync(devs)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(devs)
    return 1e3 * (time.perf_counter() - t0) / iters


def phase_real_peers(gen):
    """(``--peers``, two or more cards) the W-rank kernels with one rank
    per card: phase 7's checks, then the wall time per call of each at
    the llama3-8b shapes, one rank per card beside the same calls on W
    virtual ranks of cuda:0."""
    from repro_torch.distributed.context import Mesh
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels.ag_gemm import ag_gemm_fused
    n = torch.cuda.device_count()
    check(n >= 2, f"--peers needs two or more cards, found {n}")
    sets = [[f"cuda:{i}" for i in range(w)] for w in (2, 4) if w <= n]
    phase_ag_gemm(gen, rank_sets=sets)
    phase_paged_ranks(gen, rank_sets=sets)
    phase_strided(gen, rank_sets=sets)
    bf16, scale = torch.bfloat16, 128 ** -0.5
    rows = []
    for real in sets:
        W = len(real)
        k = 4096 // W
        a, b = _gemm_operands(gen, 8, 4096, 4096, bf16, False)
        q, kps, vps, cur, tb = _paged_ranks_inputs(gen, bf16, W)
        qs, ks, vs, cs = _strided_inputs(gen, bf16, W)
        for label, devs in (("virtual", ["cuda:0"] * W), ("real", real)):
            mesh = Mesh(devs)
            sh = [a[:, r * k:(r + 1) * k].contiguous().to(d)
                  for r, d in enumerate(devs)]
            bs = [b.to(d) for d in devs]
            paged = ([q.to(d) for d in devs],
                     [x.to(d) for x, d in zip(kps, devs)],
                     [x.to(d) for x, d in zip(vps, devs)],
                     [cur.to(d) for d in devs], [tb.to(d) for d in devs],
                     scale)
            strided = ([qs.to(d) for d in devs],
                       [x.to(d) for x, d in zip(ks, devs)],
                       [x.to(d) for x, d in zip(vs, devs)],
                       [cs.to(d) for d in devs], scale)
            rows.append({
                "W": W, "ranks": label, "devices": devs,
                "ag_gemm_fused_wo_ms": wall_ms(
                    lambda: ag_gemm_fused(sh, bs, mesh), devs),
                "flash_decode_paged_fused_ms": wall_ms(
                    lambda: kfd.flash_decode_paged_fused(*paged,
                                                         mesh=mesh), devs),
                "flash_decode_fused_ms": wall_ms(
                    lambda: kfd.flash_decode_fused(*strided, mesh=mesh),
                    devs)})
            print(f"[peers] W={W} {label}: " + ", ".join(
                f"{key} {val:.4f}" for key, val in rows[-1].items()
                if key.endswith("_ms")), flush=True)
    return rows


def _smoke_requests(rng, vocab):
    """6 staggered requests sharing a 16-token prefix, with per-request
    temperatures and top-k (greedy rows, top_k 1, 3 and V) for the
    temperature sampler."""
    shared = [int(t) for t in rng.integers(1, vocab, 16)]
    temps = (1.0, 0.7, 1.3, 0.0, 1.0, 0.9)
    top_ks = (0, 20, 0, 0, vocab, 3)
    reqs = []
    for i in range(6):
        tail = [int(t) for t in rng.integers(1, vocab, 2 + i)]
        reqs.append((shared + tail, 10, i, temps[i], top_ks[i]))
    return reqs


def _serve_small(params, cfg, reqs, dev, K=1, sampler="greedy", ctx=None,
                 keep=None):
    """Serve ``reqs`` on the smoke model; returns (streams, counters
    (ticks, dispatches, mixed dispatches, preemptions, prefix hits),
    the engine's metrics). ``keep``: a list that receives the engine."""
    from repro_torch.distributed import context as dctx
    from repro_torch.serving.engine import Engine, Request
    with dctx.use(ctx or dctx.DistContext()):
        eng = Engine(params, cfg, batch=3, max_len=64, prefill_chunk=4,
                     block_size=8, n_blocks=8, decode_steps=K,
                     sampler=sampler, seed=5, device=dev)
    for rid, (prompt, max_new, at, temp, top_k) in enumerate(reqs):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new,
                           temp=temp, top_k=top_k), at_tick=at)
    done = eng.run()
    m = eng.metrics(done)
    if keep is not None:
        keep.append(eng)
    return ({r.rid: r.out_tokens for r in done},
            (m["ticks"], m["dispatches"], m["mixed_dispatches"],
             m["preemptions"], m["prefix_hits"]), m)


def phase_small_model():
    """(4) the smoke llama3-8b (float32) served on the card and on the
    CPU: at K = 1 greedy, token-identical streams and equal counters;
    then K = 8 megaticks (CUDA-graph replays on the card), greedy and
    seeded temperature: streams identical to the CPU's at K = 1,
    counters equal to the CPU's at K = 8; per-step logits under teacher
    forcing within tolerance."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm
    cfg = smoke_config(get_config("llama3-8b")).replace(
        dtype=torch.float32)
    p_cpu = lm.init_params(cfg, seed=0, device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    reqs = _smoke_requests(np.random.default_rng(0), cfg.vocab_size)
    runs = {dev: _serve_small(params, cfg, reqs, dev)
            for dev, params in (("cuda", p_gpu), ("cpu", p_cpu))}
    check(len(runs["cuda"][0]) == len(reqs), "small model: not all finished")
    check(runs["cuda"][0] == runs["cpu"][0],
          f"small model streams differ: {runs}")
    check(runs["cuda"][1] == runs["cpu"][1],
          f"small model counters differ: {runs['cuda'][1]} vs "
          f"{runs['cpu'][1]}")
    check(runs["cuda"][1][3] >= 1, "small model: no preemption happened")
    check(runs["cuda"][1][4] >= 1, "small model: no prefix hit happened")
    mega = {}
    for sampler in ("greedy", "temperature"):
        base = _serve_small(p_cpu, cfg, reqs, "cpu", sampler=sampler)
        cpu8 = _serve_small(p_cpu, cfg, reqs, "cpu", 8, sampler)
        gpu8 = _serve_small(p_gpu, cfg, reqs, "cuda", 8, sampler)
        what = f"small model K=8 {sampler}"
        check(cpu8[0] == base[0] and gpu8[0] == base[0],
              f"{what}: streams differ from the CPU at K=1: card {gpu8[0]}, "
              f"cpu {cpu8[0]}, K=1 {base[0]}")
        check(gpu8[1] == cpu8[1], f"{what}: counters {gpu8[1]} != the "
                                  f"CPU's {cpu8[1]}")
        check(gpu8[1][2] >= 1, f"{what}: no mixed megatick: {gpu8[1]}")
        m = gpu8[2]
        check(m["graphs"] and m["graph_captures"] >= 1
              and m["graph_replays"] == m["dispatches"],
              f"{what}: not one graph replay per megatick: {m}")
        mega[sampler] = gpu8
    check(mega["temperature"][0] != runs["cuda"][0],
          "small model: the temperature streams equal the greedy ones")

    # teacher forcing: the same tokens into both devices, logits compared
    # every step (both cast fp32 logits to bf16: one bf16 ulp, 2**-7
    # relative, on a rounding boundary; 1e-4 otherwise)
    B, bs, nb, mb = 4, 8, 16, 4
    tables = torch.arange(nb, dtype=torch.int32).reshape(B, mb)
    states = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        st = lm.init_paged_decode_state(params, cfg, B, nb, bs, mb)
        st["block_tables"].copy_(tables)
        states[dev] = (params, st)
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (B, 24))
    worst = 0.0
    with torch.inference_mode():
        for j in range(toks.shape[1]):
            out = {}
            for dev, (params, st) in states.items():
                t = torch.from_numpy(toks[:, j:j + 1]).to(dev)
                lg, _ = lm.decode_step(params, t, st, cfg)
                out[dev] = lg.float().cpu()
            diff = (out["cuda"] - out["cpu"]).abs()
            ok = bool((diff <= 1e-4 + 2 ** -7 * out["cpu"].abs()).all())
            check(ok, f"teacher-forced logits differ at step {j}: "
                      f"{diff.max().item():.3e}")
            worst = max(worst, diff.max().item())
    print(f"[small] streams token-identical on cuda and cpu, counters "
          f"(ticks, dispatches, mixed, preemptions, prefix hits) = "
          f"{runs['cuda'][1]}; K=8 megaticks (graph replays) greedy "
          f"{mega['greedy'][1]} and temperature {mega['temperature'][1]}: "
          f"streams identical to the CPU's K=1, counters to its K=8; "
          f"teacher-forced logits max |diff| {worst:.3e}", flush=True)
    return cfg, p_gpu, reqs, runs["cuda"], mega


def phase_small_model_ranks(cfg, params, reqs, want, mega, tp=4):
    """(8) the smoke model served over ``tp`` virtual ranks of cuda:0 in
    every fusion mode: greedy streams and counters equal to the tp=1
    run on the card (itself equal to the CPU's), at K = 1 and, greedy
    and temperature, at K = 8 (graph replays)."""
    from repro_torch.distributed import context as dctx
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(tp, device="cuda")
    for mode in ("auto", "bsp", "ring", "pallas"):
        ctx = dctx.DistContext(mesh, mode)
        got = _serve_small(params, cfg, reqs, "cuda", ctx=ctx)
        check(got[0] == want[0], f"small model tp={tp} {mode}: streams "
                                 f"differ from tp=1")
        check(got[1] == want[1], f"small model tp={tp} {mode}: counters "
                                 f"{got[1]} != tp=1's {want[1]}")
        for sampler, ref in mega.items():
            got = _serve_small(params, cfg, reqs, "cuda", 8, sampler, ctx)
            what = f"small model tp={tp} {mode} K=8 {sampler}"
            check(got[0] == ref[0], f"{what}: streams differ from tp=1")
            check(got[1] == ref[1], f"{what}: counters {got[1]} != tp=1's "
                                    f"{ref[1]}")
            check(got[2]["graphs"] and got[2]["graph_replays"]
                  == got[2]["dispatches"], f"{what}: {got[2]}")
    print(f"[small tp={tp}] auto, bsp, ring, pallas: streams and counters "
          f"identical to tp=1 on the card and to the CPU, at K=1 and at "
          f"K=8 (greedy, temperature; graph replays)", flush=True)


# phase 11a: the fault plan on the smoke serve of phase 4 at K = 8 (its
# engine geometry; ticks from the CPU run of the same plan): a dispatch
# that fails twice then succeeds, a slow tick, every free block seized at
# a pure megatick (all three slots stall at block boundaries: a
# preemption between graph replays), one poisoned slot; snapshot after
# ROBUST_SNAP_AFTER ticks
ROBUST_PLAN = (("dispatch", 2, {"count": 2}), ("slow", 3, {"delay_s": 0.05}),
               ("pool", 4, {"blocks": 8, "hold_ticks": 1}),
               ("tokens", 6, {"slot": 1}))
ROBUST_SNAP_AFTER = 6
ROBUST_KEYS = ("ticks", "dispatches", "mixed_dispatches", "preemptions",
               "prefix_hits", "faults_injected", "dispatch_retries",
               "dispatch_failures", "errors", "drained_requests",
               "kv_blocks_seized", "cancellations")


def _robust_serve(params, cfg, reqs, dev, ckpt_dir=None, sampler="greedy",
                  ctx=None):
    """Serve ``reqs`` on the smoke model at K = 8 under ROBUST_PLAN; with
    ``ckpt_dir``, drain and snapshot after ROBUST_SNAP_AFTER ticks and
    finish in a fresh engine restored from the snapshot. Returns the
    streams ({rid: (tokens, finish reason)}), the plan engine's counters,
    whether each preemption came at a pure-megatick boundary, and, with
    a snapshot, the resumed rids, their prefix hits and the seconds and
    bytes of the snapshot and the restore."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed import context as dctx
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    plan = FaultPlan([FaultSpec(site, t, **kw) for site, t, kw in ROBUST_PLAN])
    kw = dict(batch=3, max_len=64, prefill_chunk=4, block_size=8,
              n_blocks=8, decode_steps=8, sampler=sampler, seed=5,
              device=dev)
    with dctx.use(ctx or dctx.DistContext()):
        eng = Engine(params, cfg, fault_plan=plan, **kw)
        fresh = Engine(params, cfg, **kw) if ckpt_dir else None
    reqs_ = [Request(rid=rid, prompt=prompt, max_new_tokens=max_new,
                     temp=temp, top_k=top_k)
             for rid, (prompt, max_new, _, temp, top_k) in enumerate(reqs)]
    for r, (_, _, at, _, _) in zip(reqs_, reqs):
        eng.submit(r, at_tick=at)
    pure = []
    preempt = eng._preempt_one

    def record_preempt():
        pure.append(not any(r.prefilling for r in eng.active.values()))
        preempt()
    eng._preempt_one = record_preempt
    try:
        while (eng.queue or eng.active) and not (
                ckpt_dir and eng.tick_count >= ROBUST_SNAP_AFTER):
            eng.tick()
    finally:
        del eng._preempt_one        # no engine <-> closure cycle
    m = eng.metrics([])
    out = {"counters": {k: m[k] for k in ROBUST_KEYS},
           "slow_ticks": m["slow_ticks"], "graphs": m["graphs"],
           "graph_capture_ticks": m["graph_capture_ticks"],
           "pure_preempts": pure}
    if ckpt_dir:
        ckpt = Checkpointer(ckpt_dir)
        t0 = time.perf_counter()
        step = eng.snapshot(ckpt, block=True)
        out["snapshot_s"] = time.perf_counter() - t0
        out["counters"] = {k: eng.metrics([])[k] for k in ROBUST_KEYS}
        t0 = time.perf_counter()
        restored = fresh.restore(Checkpointer(ckpt_dir), step)
        if dev == "cuda":
            torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        out["snapshot_bytes"] = os.path.getsize(os.path.join(
            ckpt_dir, f"step_{step:08d}", "shard_0.npz"))
        hits0 = fresh.pool.prefix_hits
        fresh.run()
        out["resumed"] = sorted(r.rid for r in restored)
        out["resumed_prefix_hits"] = fresh.pool.prefix_hits - hits0
        out["resumed_graphs"] = fresh.metrics([])["graphs"]
        by_rid = {r.rid: r for r in restored}
        reqs_ = [by_rid.get(r.rid, r) for r in reqs_]
    out["streams"] = {r.rid: (list(r.out_tokens), r.finish_reason)
                      for r in reqs_}
    return out


def _robust_tp(params, cfg, reqs, ckpt_dir, sampler, ctx):
    """``_robust_serve`` over the ranks of ``ctx`` with the kernels'
    counters zeroed just before and read just after: the fused paged
    decode and the AG+GEMM must have launched, no plain version run."""
    from repro_torch.serving.graphs import launch_counted
    fns = launch_counted()
    _counted(fns)
    out = _robust_serve(params, cfg, reqs, "cuda", ckpt_dir, sampler, ctx)
    out["launches"] = {f.__name__: f.launches for f in fns if f.launches}
    plain = {f.__name__: f.plain_calls for f in fns if f.plain_calls}
    check(all(out["launches"].get(k, 0) > 0 for k in (
        "matmul", "ag_gemm_fused", "flash_decode_paged_fused"))
          and not plain, f"robustness tp: launches {out['launches']}, "
                         f"plain calls {plain}")
    return out


def phase_robust_small(cfg, params, reqs, tp=4):
    """(11a) phase 4's smoke serve at K = 8 under ROBUST_PLAN, drained,
    snapshotted and restored into a fresh engine, greedy and seeded
    temperature, on the card (graph replays) and on the CPU, and over
    ``tp`` virtual ranks under ``pallas``: streams, finish reasons and
    counters (but the clock's ``slow_ticks``) equal to the CPU's; a
    preemption at a pure-megatick boundary; exactly one error stream;
    two retried dispatch attempts; the resumed requests finish as the
    same plan's uninterrupted run does, as prefix hits."""
    from repro_torch.distributed import context as dctx
    from repro_torch.launch.mesh import make_mesh
    p_cpu = copy.deepcopy(params).to("cpu")
    root = os.path.join(ROOT, "build", "chip_smoke_robust")
    shutil.rmtree(root, ignore_errors=True)
    ctx = dctx.DistContext(make_mesh(tp, device="cuda"), "pallas")
    out = {}
    for sampler in ("greedy", "temperature"):
        runs = {"cpu": _robust_serve(p_cpu, cfg, reqs, "cpu",
                                     os.path.join(root, f"{sampler}_cpu"),
                                     sampler),
                "cuda": _robust_serve(params, cfg, reqs, "cuda",
                                      os.path.join(root, f"{sampler}_cuda"),
                                      sampler),
                "tp": _robust_tp(params, cfg, reqs,
                                 os.path.join(root, f"{sampler}_tp"),
                                 sampler, ctx)}
        whole = _robust_serve(p_cpu, cfg, reqs, "cpu", sampler=sampler)
        what = f"robustness {sampler}"
        gpu = runs["cuda"]
        for name, ref in (("the CPU", runs["cpu"]), ("tp=1", gpu)):
            got = gpu if ref is runs["cpu"] else runs["tp"]
            check(got["streams"] == ref["streams"],
                  f"{what}: streams differ from {name}'s: {got['streams']} "
                  f"vs {ref['streams']}")
            check(got["counters"] == ref["counters"],
                  f"{what}: counters {got['counters']} != {name}'s "
                  f"{ref['counters']}")
        check(gpu["graphs"] and runs["tp"]["graphs"]
              and gpu["resumed_graphs"], f"{what}: not graph replays")
        c = gpu["counters"]
        check(c["preemptions"] >= 1 and any(gpu["pure_preempts"]),
              f"{what}: no preemption at a pure-megatick boundary: "
              f"{gpu['pure_preempts']}")
        errors = [rid for rid, (_, why) in gpu["streams"].items()
                  if why == "error"]
        check(len(errors) == 1 and c["errors"] == 1,
              f"{what}: error streams {errors}")
        check(c["dispatch_retries"] == 2 and c["dispatch_failures"] == 0,
              f"{what}: retries {c}")
        check(c["faults_injected"] == len(ROBUST_PLAN),
              f"{what}: {c['faults_injected']} faults fired")
        check(gpu["resumed"] and gpu["resumed_prefix_hits"] >= 1,
              f"{what}: resumed {gpu['resumed']}, prefix hits "
              f"{gpu['resumed_prefix_hits']}")
        check(gpu["streams"] == whole["streams"],
              f"{what}: the resumed run differs from the uninterrupted "
              f"one: {gpu['streams']} vs {whole['streams']}")
        out[sampler] = {k: v for k, v in gpu.items() if k != "streams"}
        print(f"[robust {sampler}] K=8 smoke serve under {len(ROBUST_PLAN)} "
              f"faults: streams and counters identical on cuda, cpu and "
              f"tp={tp} pallas ({c}); preemption at a pure megatick "
              f"{gpu['pure_preempts']}; 1 error stream; {len(gpu['resumed'])}"
              f" requests resumed as {gpu['resumed_prefix_hits']} prefix "
              f"hits, identical to the uninterrupted run; snapshot "
              f"{gpu['snapshot_bytes']} bytes in {gpu['snapshot_s']:.3f} s, "
              f"restore {gpu['restore_s']:.3f} s; graph capture ticks "
              f"{gpu['graph_capture_ticks']}, slow ticks {gpu['slow_ticks']}; "
              f"tp={tp} launches {runs['tp']['launches']}", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return out


def _full_requests(cfg, plens, seed, max_new, stagger):
    """Requests of the given prompt lengths, tokens drawn from ``seed``:
    two seeds give two sets that the engine schedules alike."""
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(1, cfg.vocab_size, n)], max_new,
             stagger * i) for i, n in enumerate(plens)]


def _drive_timed(eng, reqs):
    """Submit ``reqs`` and tick to the end, timing every tick on the host
    clock and every graph replay with CUDA events. Returns (finished
    requests, wall s, [(tick s, (path, S) or None, replay ms)])."""
    from repro_torch.serving.engine import Request
    for rid, (prompt, max_new, at) in enumerate(reqs):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new),
                   at_tick=eng.tick_count + at)
    events, keys = [], []
    orig_replay = torch.cuda.CUDAGraph.replay
    runner = eng._runner

    def replay(graph):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        orig_replay(graph)
        b.record()
        events.append((a, b))
    if runner is not None:
        orig_run = runner.run

        def run(path, S, gw, **arrays):
            keys.append((path, S))
            return orig_run(path, S, gw, **arrays)
        runner.run = run
    torch.cuda.CUDAGraph.replay = replay
    ticks, done = [], []
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    try:
        while eng.queue or eng.active:
            n_ev, n_key = len(events), len(keys)
            t0 = time.perf_counter()
            done += eng.tick()
            ticks.append((time.perf_counter() - t0,
                          keys[n_key] if len(keys) > n_key else None,
                          events[n_ev:]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
    finally:
        torch.cuda.CUDAGraph.replay = orig_replay
        if runner is not None:
            del runner.run
    return done, wall, [(t, k, sum(a.elapsed_time(b) for a, b in ev))
                        for t, k, ev in ticks]


def _steady(eng, reqs_b, K, c0):
    """The steady numbers of ``eng`` serving ``reqs_b`` (the lengths it
    served already, other tokens: its graphs replay; ``c0`` its captures
    so far): tok/s, ms a token, busy share, the pure K-step megaticks'
    wall and device ms."""
    done_b, wall_b, ticks_b = _drive_timed(eng, reqs_b)
    toks_b = sum(len(r.out_tokens) for r in done_b)
    dev_ms = sum(t[2] for t in ticks_b)
    # the steady megatick: a pure one of the full length K
    steady = [t for t in ticks_b if t[1] == ("pure", K)]
    out = {
        "steady_wall_s": wall_b, "steady_tokens_per_s": toks_b / wall_b,
        "steady_ms_per_token": 1e3 * wall_b / max(toks_b, 1),
        "steady_captures": eng.metrics(done_b)["graph_captures"] - c0,
        "steady_replay_device_ms": dev_ms,
        "steady_busy_share": dev_ms / (1e3 * wall_b),
        "pure_megaticks": len(steady),
        "pure_megatick_wall_ms": (1e3 * sum(t[0] for t in steady)
                                  / max(len(steady), 1)),
        "pure_megatick_device_ms": (sum(t[2] for t in steady)
                                    / max(len(steady), 1))}
    out["pure_megatick_busy_share"] = (
        out["pure_megatick_device_ms"] / out["pure_megatick_wall_ms"]
        if steady else 0.0)
    return out


def serve_cell(params, cfg, K, reqs_a, reqs_b=None, *, batch, max_len,
               ctx=None, graphs=True, label=""):
    """Serve ``reqs_a`` through the engine at megatick length ``K`` with
    every kernel wrapper's counters set to 0 just before and read just
    after (launches, plain calls, decode steps from the engine's scan
    lengths plus the graphs' warm-up steps); then, when ``reqs_b`` (the
    same lengths, other tokens: the same scheduling, so the graphs of
    the first serve replay) is given, serve it again for the steady
    time. ``graphs=False`` runs the megatick loop eagerly (timing only).
    Returns the summary and the first serve's finished requests."""
    from repro_torch.distributed import context as dctx
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.graphs import launch_counted
    with dctx.use(ctx or dctx.DistContext()):
        eng = Engine(params, cfg, batch=batch, max_len=max_len,
                     block_size=16, prefill_chunk=8, decode_steps=K,
                     device="cuda")
    if eng._runner is not None:
        eng._runner.use_graphs = graphs
    fns = launch_counted()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counted(fns)

    def warm():
        return 0 if eng._runner is None else eng._runner.warmup_steps
    s0, w0 = eng.scan_steps, warm()
    done, wall, ticks = _drive_timed(eng, reqs_a)
    steps = eng.scan_steps - s0 + warm() - w0
    launches = {f.__name__: f.launches for f in fns}
    plain = {f.__name__: f.plain_calls for f in fns}
    peak = torch.cuda.max_memory_allocated()
    m = eng.metrics(done)
    toks = sum(len(r.out_tokens) for r in done)
    out = {"K": K, "graphs": m["graphs"], "requests": len(done),
           "new_tokens": toks, "wall_s": wall, "tokens_per_s": toks / wall,
           "ms_per_token": 1e3 * wall / max(toks, 1),
           "decode_steps": steps, "warmup_steps": warm() - w0,
           "mean_decode_step_ms": 1e3 * wall / max(steps, 1),
           "ticks": m["ticks"], "dispatches": m["dispatches"],
           "mixed_dispatches": m["mixed_dispatches"],
           "peak_mem_bytes": peak, "launches": launches,
           "plain_calls": plain,
           "graph_count": m.get("graph_count", 0),
           "graph_captures": m.get("graph_captures", 0),
           "graph_capture_s": m.get("graph_capture_s", 0.0),
           "graph_replays": m.get("graph_replays", 0),
           "p50_ttft_s": m["p50_ttft_s"], "p50_tpot_s": m["p50_tpot_s"]}
    if reqs_b is not None:
        out.update(_steady(eng, reqs_b, K, m.get("graph_captures", 0)))
    print(f"[serve {label} K={K}{'' if graphs else ' eager'}] {toks} tokens "
          f"in {wall:.2f} s: {toks / wall:.2f} tok/s, "
          f"{out['ms_per_token']:.2f} ms/token, {steps} steps "
          f"({out['mean_decode_step_ms']:.2f} ms/step), peak "
          f"{peak / 1e9:.2f} GB, {out['graph_captures']} graphs captured "
          f"in {out['graph_capture_s']:.2f} s"
          + (f"; steady: {out['steady_tokens_per_s']:.2f} tok/s, "
             f"{out['steady_ms_per_token']:.2f} ms/token, busy share "
             f"{out['steady_busy_share']:.3f} (pure K-step megatick "
             f"{out['pure_megatick_device_ms']:.2f} ms device in "
             f"{out['pure_megatick_wall_ms']:.2f} ms wall: "
             f"{out['pure_megatick_busy_share']:.3f})"
             if reqs_b is not None else ""), flush=True)
    del eng
    torch.cuda.empty_cache()
    return out, done


def _check_serve(cell, done, cfg, n, max_new, per_step, what):
    """The serve finished every request with in-vocabulary tokens, went
    through the kernels (no plain-version call) and launched each
    ``per_step[name]`` times a decode step."""
    check(len(done) == n, f"{what}: {len(done)} of {n} finished")
    for r in done:
        check(len(r.out_tokens) == max_new and all(
            0 <= t < cfg.vocab_size for t in r.out_tokens),
            f"{what}: request {r.rid} tokens {r.out_tokens}")
    check(all(v == 0 for v in cell["plain_calls"].values()),
          f"{what}: plain-version calls {cell['plain_calls']}")
    steps = cell["decode_steps"]
    check(steps > 0, f"{what}: no decode step ran")
    want = {name: steps * k for name, k in per_step.items()}
    got = {name: cell["launches"][name] for name in per_step}
    check(got == want, f"{what}: launches {got} != {want} "
                       f"({steps} steps)")
    others = {k: v for k, v in cell["launches"].items()
              if k not in per_step and v}
    check(not others, f"{what}: other kernels launched {others}")
    if cell["K"] > 1 and cell["graphs"]:
        check(cell["graph_replays"] == cell["dispatches"]
              and cell["graph_captures"] >= 1,
              f"{what}: not one graph replay per megatick: {cell}")


def phase_full_width():
    """(5) full-width llama3-8b (bf16, seeded random weights) served at
    K = 1 (eager, one dispatch a tick) and at K = 8 (one CUDA-graph
    replay a megatick; then the same lengths again with the graphs
    reused, for the steady time), and at K = 8 with the loop run
    eagerly; the launches of both W = 1 kernels counted around each
    serve."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("llama3-8b")
    t0 = time.time()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    plens = [int(n) for n in np.random.default_rng(0).integers(32, 129, 8)]
    reqs_a = _full_requests(cfg, plens, 1, 32, 2)
    reqs_b = _full_requests(cfg, plens, 2, 32, 2)
    kw = dict(batch=8, max_len=512, label="W=1")
    per_step = {"matmul": 4 * cfg.n_layers + 1,
                "flash_decode_paged": cfg.n_layers}
    cells = {}
    cells["k1"], done1 = serve_cell(params, cfg, 1, reqs_a, **kw)
    _check_serve(cells["k1"], done1, cfg, 8, 32, per_step, "full width K=1")
    cells["k8"], done8 = serve_cell(params, cfg, 8, reqs_a, reqs_b, **kw)
    _check_serve(cells["k8"], done8, cfg, 8, 32, per_step, "full width K=8")
    cells["k8_eager"], _ = serve_cell(params, cfg, 8, reqs_a, graphs=False,
                                      **kw)
    s1 = {r.rid: r.out_tokens for r in done1}
    s8 = {r.rid: r.out_tokens for r in done8}
    same = sum(s1[r] == s8[r] for r in s1)
    cells["k8"]["streams_identical_to_k1"] = same
    print(f"[full] K=8 streams identical to K=1 for {same} of {len(s1)} "
          f"requests (bf16: other gather-width buckets, other decode "
          f"plans; reported, not required)", flush=True)
    # the logits themselves: one teacher-forced step on the served model
    with torch.inference_mode():
        st = lm.init_paged_decode_state(params, cfg, 8, 64, 16, 8)
        st["block_tables"].copy_(torch.arange(64, dtype=torch.int32)
                                 .reshape(8, 8))
        tok = torch.randint(1, cfg.vocab_size, (8, 8), device="cuda")
        lg, _ = lm.decode_chunk(params, tok, torch.full(
            (8,), 8, device="cuda"), st, cfg)
        check(bool(torch.isfinite(lg).all()), "full width: non-finite "
                                              "logits")
        profile = profile_steps(params, cfg, st)
    summary = {"init_s": init_s, "prompt_tokens": sum(plens), **cells,
               "launches": cells["k8"]["launches"],
               "launches_k1": cells["k1"]["launches"],
               "launches_per_step": per_step, "profile": profile}
    lens = [n + 32 for n in plens]
    return params, summary, lens


def phase_graph_vs_eager(params, cfg=None, K=8):
    """(5b) one full-width serve at K = 8 on two engines in lockstep, one
    replaying CUDA graphs and one running the same megatick loop
    eagerly: after every tick the emitted tokens, ``cur_len``, the block
    tables and the bytes of every cache leaf (KV pools, recurrent state)
    must be identical (the mixed and the pure megaticks both run)."""
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import Engine, Request
    cfg = cfg or get_config("llama3-8b")
    engs = [Engine(params, cfg, batch=4, max_len=128, block_size=16,
                   prefill_chunk=8, decode_steps=K, device="cuda")
            for _ in range(2)]
    engs[1]._runner.use_graphs = False
    rng = np.random.default_rng(3)
    for rid, n in enumerate((9, 14, 20, 5)):
        prompt = [int(t) for t in rng.integers(1, cfg.vocab_size, n)]
        for eng in engs:
            eng.submit(Request(rid=rid, prompt=list(prompt),
                               max_new_tokens=12), at_tick=rid)
    paths, n = set(), 0
    done = [[], []]
    while any(e.queue or e.active for e in engs):
        keys = []
        orig = engs[0]._runner.run

        def run(path, S, gw, **arrays):
            keys.append(path)
            return orig(path, S, gw, **arrays)
        engs[0]._runner.run = run
        try:
            for d, eng in zip(done, engs):
                d += eng.tick()
        finally:
            del engs[0]._runner.run
        paths.update(keys)
        streams = [{r.rid: list(r.out_tokens)
                    for r in list(e.active.values()) + d}
                   for e, d in zip(engs, done)]
        check(streams[0] == streams[1], f"graph vs eager: tokens differ "
                                        f"at tick {engs[0].tick_count}")
        sa, sb = (e.pool.state for e in engs)
        check(torch.equal(sa["cur_len"], sb["cur_len"])
              and torch.equal(sa["block_tables"], sb["block_tables"]),
              f"graph vs eager: cur_len or tables differ at tick "
              f"{engs[0].tick_count}")
        ref = flatten(sb["caches"])
        for key, leaf in flatten(sa["caches"]).items():
            check(torch.equal(leaf.view(torch.uint8),
                              ref[key].view(torch.uint8)),
                  f"graph vs eager: cache leaf {key} differs at tick "
                  f"{engs[0].tick_count}")
        n += 1
    check(paths == {"pure", "mixed"}, f"graph vs eager: paths {paths}")
    m = engs[0].metrics(done[0])
    check(m["graph_replays"] == m["dispatches"] and
          engs[1].metrics(done[1])["graph_replays"] == 0,
          "graph vs eager: the engines did not take their routes")
    print(f"[graph vs eager] {cfg.name} K={K}: {n} megaticks (pure and "
          f"mixed, {m['graph_count']} graphs) bit-identical to the eager "
          f"loop: tokens, cur_len, tables, every cache leaf's bytes "
          f"({', '.join(sorted(flatten(sa['caches'])))})", flush=True)
    del engs
    torch.cuda.empty_cache()
    return n


def _counted(fns):
    """Zero the launch and plain-call counters of ``fns``."""
    for fn in fns:
        fn.launches = 0
        fn.plain_calls = 0


def _teacher_forced(params, cfg, tok, ctx, gather_width=None):
    """Logits of one chunk of ``tok`` (4 slots x 8 tokens) from a fresh
    paged state whose tables reach blocks of every rank; ``ctx`` None
    is one rank."""
    from repro_torch.distributed import context as dctx
    from repro_torch.models import lm
    tables = torch.arange(32, dtype=torch.int32, device="cuda").reshape(4, 8)
    with dctx.use(ctx or dctx.DistContext()), torch.inference_mode():
        st = lm.init_paged_decode_state(params, cfg, 4, 32, 16, 8)
        bt = st["block_tables"]
        for t in bt if isinstance(bt, list) else [bt]:
            t.copy_(tables)
        lg, _ = lm.decode_chunk(params, tok, torch.full(
            (4,), 8, device="cuda"), st, cfg, gather_width=gather_width)
    return lg.float()


def phase_full_width_ranks(params, tp=4):
    """(9) full-width llama3-8b (bf16) over ``tp`` virtual ranks of
    cuda:0 under ``pallas``: a short serve through the engine at K = 1
    (paged pool, fused paged decode + fused AG+GEMM) and a few steps of
    the contiguous-cache ``lm.decode_step`` (fused strided decode), with
    every kernel's counters zeroed just before and read just after; the
    same serve at K = 8 (graph replays) counted the same way, then
    again for the steady time; then teacher-forced chunks against the
    tp=1 logits and across gather widths."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import context as dctx
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    cfg = get_config("llama3-8b")
    L = cfg.n_layers
    ctx = dctx.DistContext(make_mesh(tp, device="cuda"), "pallas")
    plens = [int(n) for n in np.random.default_rng(1).integers(16, 49, 4)]
    reqs_a = _full_requests(cfg, plens, 3, 16, 1)
    reqs_b = _full_requests(cfg, plens, 4, 16, 1)
    kw = dict(batch=4, max_len=256, ctx=ctx, label=f"tp={tp} pallas")
    per_step = {"matmul": 3 * L + 1, "ag_gemm_fused": L,
                "flash_decode_paged_fused": L}
    cells = {}
    cells["k1"], done1 = serve_cell(params, cfg, 1, reqs_a, **kw)
    _check_serve(cells["k1"], done1, cfg, 4, 16, per_step,
                 f"full width tp={tp} K=1")
    # the contiguous-cache path: 4 steps over a strided cache on the tp
    # ranks, then 4 on one rank (the kernel's NORMAL mode)
    c_steps = 4
    c_launches = []
    for c_ctx in (ctx, dctx.DistContext()):
        n0 = kfd.flash_decode_fused.launches
        with dctx.use(c_ctx), torch.inference_mode():
            st = lm.init_decode_state(params, cfg, 4, 256)
            tok = torch.randint(1, cfg.vocab_size, (4, 1), device="cuda")
            for _ in range(c_steps):
                lg_c, _ = lm.decode_step(params, tok, st, cfg)
                tok = lg_c[:, 0].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
        check(bool(torch.isfinite(lg_c).all()),
              "contiguous path: non-finite logits")
        c_launches.append(kfd.flash_decode_fused.launches - n0)
        del st
    # one launch per card per call: one card, L calls a step, both widths
    check(c_launches == [c_steps * L] * 2,
          f"contiguous path: {c_launches} launches at tp={tp} and W=1 for "
          f"{c_steps} steps each")
    cells["k8"], done8 = serve_cell(params, cfg, 8, reqs_a, reqs_b, **kw)
    _check_serve(cells["k8"], done8, cfg, 4, 16, per_step,
                 f"full width tp={tp} K=8")
    s1 = {r.rid: r.out_tokens for r in done1}
    same = sum(s1[r.rid] == r.out_tokens for r in done8)
    cells["k8"]["streams_identical_to_k1"] = same

    # teacher forcing: one 8-token chunk at tp=1 and at tp on the served
    # bf16 weights and on the same weights unrounded (float32), and at
    # tp=1 over one table column (the narrowest gather width) and all 8
    cfg32 = cfg.replace(dtype=torch.float32)
    p32 = lm.init_params(cfg32, seed=0, device="cuda")
    tok = torch.randint(1, cfg.vocab_size, (4, 8), device="cuda")
    out = {(dt, W): _teacher_forced(p, c, tok, ctx if W > 1 else None)
           for dt, p, c in ((16, params, cfg), (32, p32, cfg32))
           for W in (1, tp)}
    narrow = _teacher_forced(params, cfg, tok, None, gather_width=1)
    with dctx.use(ctx), torch.inference_mode():
        st = lm.init_paged_decode_state(params, cfg, 4, 32, 16, 8)
        for t in st["block_tables"]:
            t.copy_(torch.arange(32, dtype=torch.int32).reshape(4, 8))
        profile = profile_steps(params, cfg, st, batch=4,
                                label=f"tp={tp} pallas decode step")
    del p32
    torch.cuda.empty_cache()
    # float32: the fp32 sums run in other orders, and both cast the fp32
    # logits to bf16: one bf16 ulp (2**-7 relative) on a rounding
    # boundary, 1e-4 otherwise
    d32 = (out[32, tp] - out[32, 1]).abs()
    check(bool((d32 <= 1e-4 + 2 ** -7 * out[32, 1].abs()).all()),
          f"float32 tp={tp} vs tp=1 logits: max |diff| "
          f"{d32.max().item():.3e}")
    # bf16: the residual stream rounds at other places on each of the 32
    # layers; the tp path, and another gather width (another decode
    # plan, as K = 8 and K = 1 may pick), must stay within the bf16
    # model's own distance from its unrounded (float32) weights
    diff = (out[16, tp] - out[16, 1]).abs().max().item()
    d_gw = (narrow - out[16, 1]).abs().max().item()
    own = (out[16, 1] - out[32, 1]).abs().max().item()
    check(diff <= own, f"bf16 tp={tp} vs tp=1 logits: max |diff| "
                       f"{diff:.3e} > the bf16 model's own error {own:.3e}")
    check(d_gw <= own, f"bf16 gather width 1 vs 8 logits: max |diff| "
                       f"{d_gw:.3e} > the bf16 model's own error {own:.3e}")
    ref = out[16, 1].abs().max().item()
    summary = {"tp": tp, "fusion_mode": "pallas", "prompt_tokens":
               sum(plens), **cells,
               "launches": cells["k8"]["launches"],
               "launches_k1": cells["k1"]["launches"],
               "serve_launches_per_step": per_step,
               "contiguous_steps": c_steps,
               "contiguous_launches": {"tp": c_launches[0],
                                       "w1": c_launches[1]},
               "teacher_forced_max_abs_diff": diff,
               "teacher_forced_gather_width_max_abs_diff": d_gw,
               "teacher_forced_bf16_vs_f32_max_abs_diff": own,
               "teacher_forced_f32_max_abs_diff": d32.max().item(),
               "teacher_forced_max_abs_logit": ref, "profile": profile,
               "streams_k8": {r.rid: r.out_tokens for r in done8}}
    print(f"[full tp={tp}] K=8 streams identical to K=1 for {same} of 4; "
          f"teacher-forced logits vs tp=1 max |diff| {diff:.3e} bf16, "
          f"gather width 1 vs 8 {d_gw:.3e} (bf16 vs float32 weights "
          f"{own:.3e}, max |logit| {ref:.3e}), {d32.max().item():.3e} "
          f"float32", flush=True)
    return summary, [n + 16 for n in plens]


def phase_server(smi):
    """(11b) llama3-8b at full width (bf16, phase 5's seeded weights and
    geometry: batch 8, max_len 512, block 16, K = 8) behind
    ``repro_torch.launch.server.Server``, built by its ``build_engine``
    with a ``--chaos-plan`` file, on an ephemeral port, driven by the
    port's client: phase 5's 8 prompts, 32 new tokens each, streamed.
    The shortest goes first alone, the other 7 once its first token is
    out; the plan fails tick 2's dispatch twice, slows tick 3, poisons
    slot 0 (the first request, decoding alone) the tick after its first
    token, and seizes every free block 4 ticks later for 6 ticks (the
    slots stall at block boundaries: a preemption between graph
    replays); one stream hangs up after its first token. Once the
    preemption and the hang-up have happened, ``/admin/drain``
    checkpoints the rest into ``build/``, ``/readyz`` answers 503, and a
    second server built with ``--resume`` finishes the drained requests
    as prefix hits. Streams against a fault-free engine are counted, not
    required (bf16: other schedules, other rounding)."""
    import asyncio
    from repro_torch.configs import get_config
    from repro_torch.launch import server as server_mod
    from repro_torch.serving import client as cl
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    cfg = get_config("llama3-8b")
    plens = [int(n) for n in np.random.default_rng(0).integers(32, 129, 8)]
    prompts = sorted(([int(t) for t in np.random.default_rng(1).integers(
        1, cfg.vocab_size, n)] for n in plens), key=len)
    max_new, M = 32, 8
    first_tick = -(-len(prompts[0]) // M)   # its prompt's last mixed tick
    root = os.path.join(ROOT, "build", "chip_smoke_server")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ckpt_dir = os.path.join(root, "ckpt")
    plan = FaultPlan([
        FaultSpec("dispatch", 2, count=2),
        FaultSpec("slow", 3, delay_s=0.05),
        FaultSpec("tokens", first_tick + 1, slot=0),
        FaultSpec("pool", first_tick + 4, blocks=8 * 512 // 16,
                  hold_ticks=6)])
    with open(os.path.join(root, "plan.json"), "w") as f:
        f.write(plan.to_json())
    flags = ["--arch", "llama3-8b", "--device", "cuda", "--batch", "8",
             "--max-len", "512", "--block-size", "16", "--prefill-chunk",
             "8", "--decode-steps", "8", "--seed", "0",
             "--checkpoint-dir", ckpt_dir]
    parse = server_mod.make_parser().parse_args
    part_s, t_part = {}, time.perf_counter()   # seconds of each part

    def part(name):
        nonlocal t_part
        part_s[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()
    engine = server_mod.build_engine(parse(
        flags + ["--chaos-plan", os.path.join(root, "plan.json")]))
    snap = {}
    snapshot = engine.snapshot

    def timed_snapshot(ckpt, step=None, block=True):
        t0 = time.perf_counter()
        step = snapshot(ckpt, step, block)
        snap["s"] = time.perf_counter() - t0
        snap["bytes"] = os.path.getsize(os.path.join(
            ckpt_dir, f"step_{step:08d}", "shard_0.npz"))
        return step
    engine.snapshot = timed_snapshot
    ticks = []          # (seconds, captured a graph) of each served tick
    tick1 = engine.tick

    def timed_tick1():
        c0 = engine._runner.captures
        t0 = time.perf_counter()
        try:
            return tick1()
        finally:
            ticks.append((time.perf_counter() - t0,
                          engine._runner.captures > c0))
    engine.tick = timed_tick1

    async def poll(host, port, pred, timeout_s=300.0):
        t_end = time.monotonic() + timeout_s
        while time.monotonic() < t_end:
            m = await cl.metrics(host, port)
            if pred(m):
                return m
            await asyncio.sleep(0.05)
        raise RuntimeError(f"server: timed out waiting; metrics {m}")

    async def serve():
        srv = server_mod.Server(engine, port=0, ckpt_dir=ckpt_dir,
                                drain_grace_s=0.0)
        await srv.start()
        host, port = srv.host, srv.port
        try:
            first = asyncio.Event()

            def on_first(ev):
                if ((ev.get("choices") or [{}])[0].get("delta")
                        or {}).get("token_ids"):
                    first.set()
            t0 = time.perf_counter()
            tasks = [asyncio.create_task(cl.complete(
                host, port, prompts[0], max_new_tokens=max_new,
                on_event=on_first))]
            await first.wait()
            tasks += [asyncio.create_task(cl.complete(
                host, port, p, max_new_tokens=max_new,
                hangup_after_tokens=1 if i == 0 else None))
                for i, p in enumerate(prompts[1:])]
            await poll(host, port, lambda m: m.get("preemptions", 0) >= 1
                       and m.get("cancellations", 0) >= 1)
            status, body = await cl.request_json(host, port, "POST",
                                                 "/admin/drain")
            check(status == 200 and body["draining"], f"drain: {body}")
            outs = await asyncio.wait_for(asyncio.gather(*tasks), 300)
            wall = time.perf_counter() - t0
            status, ready = await cl.request_json(host, port, "GET",
                                                  "/readyz")
            m = await cl.metrics(host, port)
            return outs, wall, status, ready, m
        finally:
            await srv.stop()

    from repro_torch.serving.graphs import launch_counted
    fns = launch_counted()
    _counted(fns)
    try:
        outs, wall, ready_status, ready, m1 = asyncio.run(serve())
    finally:
        del engine.snapshot, engine.tick   # no engine <-> closure cycles
    launches = {f.__name__: f.launches for f in fns if f.launches}
    plain = {f.__name__: f.plain_calls for f in fns if f.plain_calls}
    check(launches.get("matmul", 0) > 0
          and launches.get("flash_decode_paged", 0) > 0 and not plain,
          f"server: kernels not on the path: launches {launches}, "
          f"plain calls {plain}")
    check(ready_status == 503 and not ready["ready"] and ready["draining"],
          f"server: /readyz {ready_status} {ready} after the drain")
    poisoned = [o for o in outs if o.error and "non-finite" in o.error]
    drained = [o for o in outs if o.error and "checkpoint" in o.error]
    hung_up = [o for o in outs[1:2] if o.finish_reason is None
               and o.error is None]
    finished = [o for o in outs if o.finish_reason == "length"]
    check(len(poisoned) == 1 and outs[0] is poisoned[0],
          f"server: poisoned streams {[o.error for o in poisoned]}")
    check(len(hung_up) == 1 and m1["cancellations"] >= 1,
          f"server: the hang-up did not cancel: {m1['cancellations']}")
    outcomes = [(o.status, o.error, o.finish_reason) for o in outs]
    check(len(poisoned) + len(drained) + len(hung_up) + len(finished) == 8,
          f"server: a stream did not end: {outcomes}")
    check(drained and m1["drained_requests"] >= 1,
          f"server: nothing was drained: {m1['drained_requests']}, "
          f"{outcomes}")
    check(m1["dispatch_retries"] == 2 and m1["preemptions"] >= 1
          and m1["graphs"] and m1["graph_replays"] == m1["dispatches"],
          f"server: retries, preemptions or graph replays: {m1}")
    streamed = sum(len(o.token_ids) for o in outs)
    del engine
    torch.cuda.empty_cache()
    part("serve")

    # the second server: --resume restores the snapshot in build_engine
    from repro_torch.serving import engine as engine_mod
    restore = engine_mod.Engine.restore
    timing = {}

    def timed_restore(self, ckpt, step=None):
        t0 = time.perf_counter()
        out = restore(self, ckpt, step)
        torch.cuda.synchronize()
        timing["restore_s"] = time.perf_counter() - t0
        timing["t_restored"] = time.perf_counter()
        return out
    engine_mod.Engine.restore = timed_restore
    try:
        engine2 = server_mod.build_engine(parse(flags + ["--resume"]))
    finally:
        engine_mod.Engine.restore = restore
    resumed = list(engine2.queue)
    check(len(resumed) == len(drained), f"server: {len(resumed)} requests "
                                        f"restored, {len(drained)} drained")
    done0 = {r.rid: len(r.out_tokens) for r in resumed}
    tick = engine2.tick

    def timed_tick():
        out = tick()
        if "first_token_s" not in timing and any(
                len(r.out_tokens) > done0[r.rid] for r in resumed):
            timing["first_token_s"] = time.perf_counter() - timing[
                "t_restored"]
        return out
    engine2.tick = timed_tick

    async def resume():
        srv = server_mod.Server(engine2, port=0)
        await srv.start()
        try:
            t0 = time.perf_counter()
            m = await poll(srv.host, srv.port,
                           lambda m: m.get("requests", 0) >= len(resumed))
            return m, time.perf_counter() - t0
        finally:
            await srv.stop()
    try:
        m2, wall2 = asyncio.run(resume())
    finally:
        del engine2.tick
    check(all(r.done and r.finish_reason == "length"
              and len(r.out_tokens) == max_new and r.reused_tokens > 0
              for r in resumed) and m2["prefix_hits"] >= len(resumed),
          f"server: resumed requests "
          f"{[(r.rid, r.finish_reason, r.reused_tokens) for r in resumed]},"
          f" prefix hits {m2['prefix_hits']}")
    resumed_tokens = sum(len(r.out_tokens) - done0[r.rid] for r in resumed)
    part("resume")

    # a fault-free engine on the same weights: how many streams match
    ref = Engine(engine2.params, engine2.cfg, batch=8, max_len=512,
                 block_size=16, prefill_chunk=8, decode_steps=8,
                 device="cuda")
    want = [Request(rid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in want:
        ref.submit(r)
    ref.run()
    by_prompt = {tuple(r.prompt): r.out_tokens for r in want}
    ends = [(tuple(p), o.token_ids) for p, o in zip(prompts, outs)
            if o.finish_reason == "length"]
    ends += [(tuple(r.prompt), r.out_tokens) for r in resumed]
    same = sum(by_prompt[p] == toks for p, toks in ends)
    part("fault-free reference")
    # the degraded ladder's rung 1 (K halved): the same prompts again on
    # the warm engine, each tick timed; the first one at K = 4 captures
    # new (path, S, gw) graphs
    from repro_torch.serving.faults import DegradedModeController
    ref.degraded = DegradedModeController(recover_after=10 ** 6)
    ref.degraded.level = 1
    for i, prompt in enumerate(prompts):
        ref.submit(Request(rid=100 + i, prompt=list(prompt),
                           max_new_tokens=max_new))
    ladder = []
    while ref.queue or ref.active:
        c0 = ref._runner.captures
        t0 = time.perf_counter()
        ref.tick()
        ladder.append((time.perf_counter() - t0, ref._runner.captures - c0))
    capture_ticks = [t for t, c in ladder if c]
    steady = sorted(t for t, c in ladder if not c)
    rung1 = {"first_tick_s": ladder[0][0], "capture_ticks": len(capture_ticks),
             "capture_tick_s": capture_ticks,
             "median_other_tick_s": steady[len(steady) // 2] if steady
             else None}
    part("ladder rung 1")
    del engine2, ref
    shutil.rmtree(root, ignore_errors=True)
    out = {"streams": 8, "poisoned": len(poisoned), "drained": len(drained),
           "hung_up": len(hung_up), "finished_before_drain": len(finished),
           "streamed_tokens": streamed, "serve_wall_s": wall,
           "tokens_per_s": streamed / wall,
           "dispatch_retries": m1["dispatch_retries"],
           "preemptions": m1["preemptions"],
           "faults_injected": m1["faults_injected"],
           "slow_ticks": m1["slow_ticks"],
           "graph_capture_ticks": m1["graph_capture_ticks"],
           "graph_captures": m1["graph_captures"],
           "snapshot_bytes": snap["bytes"], "snapshot_s": snap["s"],
           "restore_s": timing["restore_s"],
           "first_token_after_resume_s": timing["first_token_s"],
           "resumed": len(resumed), "resumed_prefix_hits": m2["prefix_hits"],
           "resumed_tokens": resumed_tokens, "resume_wall_s": wall2,
           "resume_graph_capture_ticks": m2["graph_capture_ticks"],
           "streams_ended": len(ends),
           "streams_identical_to_fault_free": same, "launches": launches,
           "ladder_rung1": rung1, "ticks": len(ticks),
           "capture_ticks_s": sum(t for t, c in ticks if c),
           "other_ticks_s": sum(t for t, c in ticks if not c),
           "part_s": part_s, "device": smi}
    print(f"[server] full width K=8 through the SSE server: 8 streams "
          f"ended ({len(finished)} length, 1 poisoned, 1 hung up, "
          f"{len(drained)} drained into a checkpoint), {streamed} tokens "
          f"in {wall:.2f} s ({streamed / wall:.2f} tok/s), retries "
          f"{m1['dispatch_retries']}, preemptions {m1['preemptions']}, "
          f"graph capture ticks {m1['graph_capture_ticks']} "
          f"({out['capture_ticks_s']:.2f} s; {len(ticks)} ticks, the others "
          f"{out['other_ticks_s']:.2f} s), launches "
          f"{launches}; /readyz 503; "
          f"snapshot {snap['bytes']} bytes in {snap['s']:.3f} s, restore "
          f"{timing['restore_s']:.3f} s, first token after resume "
          f"{timing['first_token_s']:.3f} s; {len(resumed)} resumed as "
          f"{m2['prefix_hits']} prefix hits ({resumed_tokens} tokens in "
          f"{wall2:.2f} s); {same} of {len(ends)} finished streams equal a "
          f"fault-free engine's (reported, not required); ladder rung 1 "
          f"(K=4) on the warm engine: first tick {rung1['first_tick_s']:.3f}"
          f" s, {rung1['capture_ticks']} capture ticks, other ticks "
          f"median {rung1['median_other_tick_s'] or 0:.3f} s; parts "
          + ", ".join(f"{k} {v:.1f} s" for k, v in part_s.items())
          + f" | {smi}",
          flush=True)
    return out


def profile_steps(params, cfg, state, steps=4, batch=8,
                  label="decode step"):
    """Where a full-width decode step's time goes: ``steps`` single-token
    steps of ``batch`` slots timed on the host clock, then the same steps under
    ``torch.profiler`` for the device time of each kernel. Returns wall
    and device ms per step, the device busy share and the top kernels
    (device time 0 = not measured)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    tok = torch.randint(1, cfg.vocab_size, (batch, 1), device="cuda")
    lm.decode_step(params, tok, state, cfg)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(steps):
        lm.decode_step(params, tok, state, cfg)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.time() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            lm.decode_step(params, tok, state, cfg)
        torch.cuda.synchronize()
    kern = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        # aten:: entries repeat the device time of the kernels they
        # launch; count the kernels themselves
        if dev_us > 0 and not ev.key.startswith("aten::"):
            kern.append((dev_us, ev.key, ev.count))
    kern.sort(reverse=True)
    dev_ms = sum(k[0] for k in kern) / 1e3 / steps
    out = {"steps": steps, "wall_ms_per_step": wall_ms,
           "device_ms_per_step": dev_ms,
           "device_busy_share": dev_ms / wall_ms if wall_ms else 0.0,
           "top_kernels": [{"name": k[1][:80], "ms_per_step":
                            k[0] / 1e3 / steps, "calls_per_step":
                            k[2] / steps} for k in kern[:10]],
           # the port's own kernels (csrc/*.cu), wherever they rank
           "port_kernels": {
               name: {"ms_per_step": sum(k[0] for k in kern
                                         if port_kernel(name, k[1]))
                      / 1e3 / steps,
                      "calls_per_step": sum(k[2] for k in kern
                                            if port_kernel(name, k[1]))
                      / steps}
               for name in PORT_KERNELS}}
    print(f"[profile] {label}: wall {wall_ms:.2f} ms, device "
          f"{dev_ms:.2f} ms (busy share {out['device_busy_share']:.3f}); "
          f"top: " + "; ".join(f"{k['name'][:40]} {k['ms_per_step']:.2f} ms"
                               for k in out["top_kernels"][:4])
          + "; port: " + ", ".join(
              f"{n} {v['ms_per_step']:.3f} ms x {v['calls_per_step']:g}"
              for n, v in out["port_kernels"].items()
              if v["calls_per_step"]), flush=True)
    return out


def gemm_host_us(gen, iters=500, reps=5):
    """Host microseconds per call of the GEMM wrappers at batch 8 (wk
    alone, the wq/wk/wv group) beside ``torch.matmul``'s, and of the
    pieces of one call: the checks, one output's ``torch.empty``, the
    stream lookup and the launch (plan lookup, pointer arrays, the C
    call: the tensor maps' encoding and ``cudaLaunchKernel``). Each is
    ``iters`` calls between two ``perf_counter`` reads, without
    synchronising (fewer calls than the launch queue holds), the least
    of ``reps`` such runs: the host clock's spread is one-sided."""
    from repro_torch.kernels import matmul as kmm
    a = torch.randn((8, 4096), generator=gen, device="cuda").to(
        torch.bfloat16)
    ws = [(torch.randn((4096, n), generator=gen, device="cuda") / 64).to(
        torch.bfloat16) for n in (4096, 1024, 1024)]
    cs = [torch.empty((8, w.shape[1]), dtype=a.dtype, device="cuda")
          for w in ws]
    calls = {
        "torch.matmul wk": lambda: torch.matmul(a, ws[1]),
        "matmul wk": lambda: kmm.matmul(a, ws[1]),
        "torch.matmul wq, wk, wv": lambda: [torch.matmul(a, w) for w in ws],
        "matmul_group wq/wk/wv": lambda: kmm.matmul_group(a, ws),
        "checks wq/wk/wv": lambda: kmm._check(a, ws, False, "matmul_group"),
        "torch.empty (8, 4096)": lambda: torch.empty(
            (8, 4096), dtype=a.dtype, device="cuda"),
        "stream lookup": lambda: torch.cuda.current_stream(0).cuda_stream,
        "launch wk": lambda: kmm._launch_stream(a, ws[1:2], cs[1:2], False),
        "launch wq/wk/wv": lambda: kmm._launch_stream(a, ws, cs, False),
    }
    out = {}
    for name, fn in calls.items():
        fn()
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            best = min(best, time.perf_counter() - t0)
        out[name] = 1e6 * best / iters
    torch.cuda.synchronize()
    print("[gemm host] us per call: " + "; ".join(
        f"{n} {v:.1f}" for n, v in out.items()), flush=True)
    return out


def paged_row(gen, lens, H, KVH, D, launches, per, err, B=8, bs=16,
              name="flash_decode_paged"):
    """The paged decode's kernel line for one decode step of ``per``
    launches at the served lengths ``lens`` (bf16, B slots, H query and
    KVH KV heads of D): graph-timed (and eager) beside its plain version,
    SDPA over the gathered head-expanded view, and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode_paged,
                                                  paged_decode_plain)
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    gw = 1
    while gw < -(-max(lens) // bs):
        gw *= 2
    q, kp, vp, full = _decode_inputs(gen, torch.bfloat16, B=B, H=H, KVH=KVH,
                                     D=D, bs=bs, C=gw, n_blocks=B * 32)
    tables = full[:, :gw]
    scale = D ** -0.5
    t_e = time_ms(lambda: flash_decode_paged(q, kp, vp, cl, tables, scale),
                  iters=50)
    t_k = graph_ms(lambda: flash_decode_paged(q, kp, vp, cl, tables, scale),
                   iters=50)
    t_p = graph_ms(lambda: paged_decode_plain(q, kp, vp, cl, tables, scale),
                   iters=10)
    # library yardstick: SDPA over the gathered, head-expanded view
    idx = tables.long()
    S = gw * bs
    kv_k = kp[idx].reshape(B, S, KVH, D).repeat_interleave(H // KVH, 2)
    kv_v = vp[idx].reshape(B, S, KVH, D).repeat_interleave(H // KVH, 2)
    kk, vv = kv_k.transpose(1, 2).contiguous(), kv_v.transpose(1, 2) \
        .contiguous()
    mask = (torch.arange(S, device="cuda")[None] < cl[:, None])[:, None,
                                                                None, :]
    qq = q[:, :, None, :]
    t_l = graph_ms(lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, scale=scale), iters=50)
    blocks_read = sum(-(-n // bs) for n in lens)
    by = (blocks_read * bs * KVH * D * 2 * q.element_size()
          + 2 * nbytes(q) + nbytes(cl) + B * -(-max(lens) // bs) * 4)
    dec_bound, dec_by = bound(sum(4 * n * H * D for n in lens), by,
                              torch.bfloat16)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_decode_paged.cu",
            "replaces": "src/repro/kernels/flash_decode.py:272",
            "launches": launches, "launches_per_step": per,
            "max_abs_err": err,
            "ms": per * t_k, "kernel_ms": per * t_k,
            "eager_ms": per * t_e, "plain_ms": per * t_p,
            "library_ms": per * t_l,
            "bound_ms": 1e3 * per * dec_bound, "bound_by": dec_by,
            "unit": f"one decode step at batch {B}, {per:g} launches, "
                    f"H {H}, KVH {KVH}, hd {D}, cur_len {lens}, gather "
                    f"width {gw}"}


def cycled_ms(ws, call, lib, plain):
    """Eager, graph-timed, library and plain ms of ``call(ws)``,
    ``lib(ws)`` and ``plain(ws)`` (None: not timed), the weights ``ws``
    cycled through enough copies to overflow the 50 MB L2, as the
    layers' distinct weights do on the main path."""
    per = nbytes(*ws)
    copies = min(32, max(2, int(-(-256e6 // per))))
    cyc = itertools.cycle([ws] + [[torch.empty_like(w).copy_(w) for w in ws]
                                  for _ in range(copies - 1)])
    out = (time_ms(lambda: call(next(cyc))),
           graph_ms(lambda: call(next(cyc))),
           graph_ms(lambda: lib(next(cyc))),
           graph_ms(lambda: plain(next(cyc)), iters=5)
           if plain is not None else None)
    del cyc
    torch.cuda.empty_cache()
    return out


def phase_timings(gen, lens, launches, per_step, errs):
    """Per-decode-step device times (CUDA-graph replays) of both kernels
    at the full-width shapes, beside the plain version, one library call
    and the bound; ``eager_ms`` keeps the eager time, host launch cost
    included. The GEMM is timed per shape (one product a launch) and per
    group (wq/wk/wv, wg/wu in one launch each, as the main path runs
    them); its step total takes the groups."""
    from repro_torch.kernels.matmul import (matmul, matmul_group,
                                            matmul_plain)
    B = 8
    rows = {}

    def time_row(name, a, ws, call, lib, plain, count, **extra):
        t_e, t_k, t_l, t_p = cycled_ms(ws, call, lib, plain)
        by = nbytes(a, *ws) + sum(B * (w.shape[0] if extra.get("trans_b")
                                       else w.shape[1]) * a.element_size()
                                  for w in ws)
        flops = sum(2 * B * w.numel() for w in ws)
        rows[name] = {"shape": name, "M": B, "K": a.shape[1],
                      "dtype": str(a.dtype).replace("torch.", ""),
                      "count_per_step": count, "ms": t_k, "eager_ms": t_e,
                      "plain_ms": t_p, "library_ms": t_l, "bytes": by,
                      "flops": flops,
                      "bound_ms": 1e3 * bound(flops, by, a.dtype)[0],
                      "ops_s": ops_s(flops, a.dtype), **extra}

    for name, K, N, dt, tb, count in gemm_cases():
        a, b0 = _gemm_operands(gen, B, K, N, dt, tb)
        if tb:
            time_row(name, a, [b0], lambda w: matmul(a, w[0], trans_b=True),
                     lambda w: torch.matmul(a, w[0].T),
                     lambda w: matmul_plain(a, w[0], True), count, N=N,
                     trans_b=True)
        else:
            time_row(name, a, [b0], lambda w: matmul(a, w[0]),
                     lambda w: torch.matmul(a, w[0]),
                     lambda w: matmul_plain(a, w[0]), count, N=N)
    shapes = {n: (K, N) for n, K, N, _, _, _ in gemm_cases()}
    for gname, members in GEMM_GROUPS:
        K = shapes[members[0]][0]
        a = torch.randn((B, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        ws = [(torch.randn((K, shapes[m][1]), generator=gen, device="cuda")
               / K ** 0.5).to(torch.bfloat16) for m in members]
        time_row(gname, a, ws, lambda w: matmul_group(a, w),
                 lambda w: [torch.matmul(a, x) for x in w], None, 32,
                 members=list(members))
        rows[gname]["plain_ms"] = sum(rows[m]["plain_ms"] for m in members)
    # the launch's latency floor: one 16 KB tile of B on one block, then
    # one tile on every block of a full grid (K = 64, one strip a block)
    from repro_torch.kernels import matmul as kmm, symm
    per_sm = kmm._fn("gemm_blocks_per_sm",
                     [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
    floor = {}
    for blocks in (1, symm.capacity("cuda:0", per_sm, kmm.KN_MMA, 1, 8)):
        a, b0 = _gemm_operands(gen, B, 64, 128 * blocks, torch.bfloat16,
                               False)
        floor[blocks] = graph_ms(lambda: matmul(a, b0))
    print("[gemm floor] ms per launch of one 16 KB tile a block: "
          + ", ".join(f"{n} block(s) {t:.4f}" for n, t in floor.items()),
          flush=True)

    host = gemm_host_us(gen)

    # the main path's step: the two groups, wo, wd and the unembed
    step = ["wqkv", "wo", "wgu", "wd", "unembed"]
    tot = {key: sum(rows[r]["count_per_step"] * rows[r][key] for r in step)
           for key in ("ms", "eager_ms", "plain_ms", "library_ms", "bytes",
                       "ops_s")}
    ungrouped_ms = sum(r["count_per_step"] * r["ms"] for n, r in
                       rows.items() if n not in ("wqkv", "wgu"))
    gemm_bound, gemm_by = bound(
        [(rows[r]["count_per_step"] * rows[r]["flops"], rows[r]["dtype"])
         for r in step], tot["bytes"])
    gemm = {"name": "matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/matmul.cu",
            "replaces": "src/repro/kernels/matmul.py:34",
            "launches": launches["matmul"],
            "launches_per_step": per_step["matmul"],
            "max_abs_err": errs["gemm"],
            "ms": tot["ms"], "kernel_ms": tot["ms"],
            "ungrouped_ms": ungrouped_ms,
            "eager_ms": tot["eager_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": 1e3 * gemm_bound, "bound_by": gemm_by,
            "library_ms": tot["library_ms"],
            "latency_floor_ms": {str(n): t for n, t in floor.items()},
            "host_us_per_call": host,
            "unit": f"one decode step at batch 8 "
                    f"({per_step['matmul']:g} launches: per layer wq/wk/wv "
                    f"grouped, wo, wg/wu grouped, wd; the unembed)"}

    decode = paged_row(gen, lens, 32, 8, 128, launches["flash_decode_paged"],
                       per_step["flash_decode_paged"], errs["decode"])
    return [gemm, decode], list(rows.values())


def _paged_fused_times(gen, lens, mesh, B=None, H=32, KVH=8, D=128,
                       bs=16):
    """The fused paged decode over ``mesh``'s ranks (llama3-8b's heads,
    bf16, a pool of 16 blocks a slot split over the ranks, cur_len
    ``lens``) in CUDA-graph replays, its plain version (eager) and SDPA
    on the gathered view (the gather excluded): (call ms, plain ms,
    library ms, bytes read and written, operations, the launch plan,
    the gather width, max |fused - plain|)."""
    import torch.nn.functional as F
    from repro_torch.kernels import symm
    from repro_torch.kernels import flash_decode as kfd
    B = B or len(lens)
    W = mesh.size
    bf16 = torch.bfloat16
    n_blocks = B * 16
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    gw = 1
    while gw < -(-max(lens) // bs):
        gw *= 2
    q, kp, vp, full = _decode_inputs(gen, bf16, B=B, H=H, KVH=KVH, D=D,
                                     bs=bs, C=gw, n_blocks=n_blocks)
    tb = full[:, :gw].contiguous()
    n_loc = n_blocks // W
    kps = [kp[r * n_loc:(r + 1) * n_loc].contiguous() for r in range(W)]
    vps = [vp[r * n_loc:(r + 1) * n_loc].contiguous() for r in range(W)]
    scale = D ** -0.5
    args = ([q] * W, kps, vps, [cl] * W, [tb] * W, scale)
    t_k = graph_ms(lambda: kfd.flash_decode_paged_fused(*args, mesh=mesh),
                   iters=50)
    plan = kfd.decode_plan(B, KVH, W, gw, symm.sm_count("cuda:0"),
                           symm.capacity("cuda:0", kfd._per_sm_query(), D,
                                         H // KVH, 1))

    def paged_plain():
        return kfd.fused_plain(
            [kfd.paged_partial_plain(q, kps[r], vps[r], cl, tb, scale,
                                     base=r * n_loc) for r in range(W)],
            bf16)
    t_p = time_ms(paged_plain, iters=5)
    err = max((o.float() - paged_plain()[0].float()).abs().max().item()
              for o in kfd.flash_decode_paged_fused(*args, mesh=mesh))
    S = gw * bs
    idx = tb.long()
    kk = kp[idx].reshape(B, S, KVH, D).repeat_interleave(H // KVH, 2) \
        .transpose(1, 2).contiguous()
    vv = vp[idx].reshape(B, S, KVH, D).repeat_interleave(H // KVH, 2) \
        .transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None] < cl[:, None])[:, None,
                                                                None, :]
    t_l = graph_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kk, vv, attn_mask=mask, scale=scale), iters=50)
    blocks_read = sum(-(-n // bs) for n in lens)
    by = (blocks_read * bs * KVH * D * 2 * 2 + nbytes(q) + nbytes(cl)
          + nbytes(tb) + W * nbytes(q))
    ops = sum(4 * n * H * D for n in lens)
    return t_k, t_p, t_l, by, ops, plan, gw, err


def phase_timings_ranks(gen, lens, launches, steps, errs, tp=4):
    """(10) device time per call and per decode step of the three W-rank
    kernels at the shapes of phase 9 (tp virtual ranks, batch 4, the
    served lengths), in CUDA-graph replays like phase 6, beside their
    bound, their plain version (timed eagerly: it synchronises the host)
    and one PyTorch library call the port never makes. B of the AG+GEMM
    (the 33.5 MB ``wo``) is cycled through copies that overflow the 50 MB
    L2, as the layers' distinct weights do. The fused paged decode's row
    also gives its latency floor: one empty cooperative launch of its
    grid, graph-timed the same way."""
    import torch.nn.functional as F
    from repro_torch.distributed.context import Mesh
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels.ag_gemm import ag_gemm_fused, ag_gemm_plain
    L, B, H, KVH, D, bs = 32, len(lens), 32, 8, 128, 16
    mesh = Mesh(["cuda:0"] * tp)
    bf16 = torch.bfloat16
    rows = []

    def row(name, source, replaces, call_ms, plain_ms, lib_ms, by, ops,
            unit, **extra):
        per = launches[name] / steps[name]
        b, b_by = bound(ops, by, bf16)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "launches_per_step": per,
                     "max_abs_err": errs[name], "ms": per * call_ms,
                     "call_ms": call_ms, "plain_ms": per * plain_ms,
                     "bound_ms": 1e3 * per * b, "bound_by": b_by,
                     "library_ms": per * lib_ms, "unit": unit, **extra})

    # fused AG+GEMM at the wo shape
    M, K, N = B, 4096, 4096
    k = K // tp
    a = torch.randn((M, K), generator=gen, device="cuda").to(bf16)
    b0 = (torch.randn((K, N), generator=gen, device="cuda") / 64).to(bf16)
    bw = [b0] + [b0.clone() for _ in range(7)]      # 8 x 33.5 MB > L2
    cyc = itertools.cycle(bw)
    shards = [a[:, r * k:(r + 1) * k].contiguous() for r in range(tp)]

    def ag():
        b = next(cyc)
        return ag_gemm_fused(shards, [b] * tp, mesh)
    t_k = graph_ms(ag, iters=40)
    t_p = time_ms(lambda: ag_gemm_plain(shards, [next(cyc)] * tp),
                  iters=10)
    t_l = graph_ms(lambda: torch.matmul(a, next(cyc)), iters=40)
    by = nbytes(*shards) + nbytes(b0) + tp * M * N * 2
    row("ag_gemm_fused", "src/repro_torch/csrc/ag_gemm.cu",
        "src/repro/kernels/ag_gemm.py:114", t_k, t_p, t_l, by,
        tp * 2 * M * K * N,
        f"one decode step at batch {B} over {tp} virtual ranks "
        f"(wo: {M}x{K} . {K}x{N} bf16 per layer)")
    del bw, cyc
    torch.cuda.empty_cache()

    # fused paged decode at the served lengths
    t_k, t_p, t_l, by, ops, plan, gw, _ = _paged_fused_times(gen, lens,
                                                             mesh)
    empty = _build.load("flash_decode_paged").symm_empty_launch
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    t_floor = graph_ms(lambda: _build.check(empty(
        plan.grid, 128, torch.cuda.current_stream().cuda_stream),
        "symm_empty_launch"), iters=50)
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(bf16)
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = D ** -0.5
    row("flash_decode_paged_fused", "src/repro_torch/csrc/"
        "flash_decode_paged.cu", "src/repro/kernels/flash_decode.py:272",
        t_k, t_p, t_l, by, ops,
        f"one decode step at batch {B} over {tp} virtual ranks, cur_len "
        f"{lens}, gather width {gw}",
        grid=plan.grid, n_split=plan.n_split,
        latency_floor_call_ms=t_floor,
        latency_floor_ms=launches["flash_decode_paged_fused"]
        / steps["flash_decode_paged_fused"] * t_floor)

    # fused contiguous (strided) decode at the same lengths, S_max 256
    S_max = 256
    kc = torch.randn((B, S_max, KVH, D), generator=gen, device="cuda") \
        .to(bf16)
    vc = torch.randn((B, S_max, KVH, D), generator=gen, device="cuda") \
        .to(bf16)
    Sl = S_max // tp
    ks = [kc[:, r * Sl:(r + 1) * Sl].contiguous() for r in range(tp)]
    vs = [vc[:, r * Sl:(r + 1) * Sl].contiguous() for r in range(tp)]
    args = ([q] * tp, ks, vs, [cl] * tp, scale)
    t_k = graph_ms(lambda: kfd.flash_decode_fused(*args, mesh=mesh),
                   iters=50)

    def strided_plain():
        return kfd.fused_plain(
            [kfd.strided_partial_plain(q, ks[r], vs[r], cl, scale, None, r,
                                       tp) for r in range(tp)], bf16)
    t_p = time_ms(strided_plain, iters=5)
    # library: SDPA over the global-order view (the gather excluded)
    kg = torch.stack(ks, dim=2).reshape(B, S_max, KVH, D) \
        .repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
    vg = torch.stack(vs, dim=2).reshape(B, S_max, KVH, D) \
        .repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
    mask = (torch.arange(S_max, device="cuda")[None] < cl[:, None])[
        :, None, None, :]
    t_l = graph_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kg, vg, attn_mask=mask, scale=scale), iters=50)
    by = (sum(lens) * KVH * D * 2 * 2 + nbytes(q) + nbytes(cl)
          + tp * nbytes(q))
    row("flash_decode_fused", "src/repro_torch/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode.py:321", t_k, t_p, t_l, by,
        sum(4 * n * H * D for n in lens),
        f"one decode step at batch {B} over {tp} virtual ranks, strided "
        f"cache S_max {S_max}, cur_len {lens}")

    # the same cache on one rank (NORMAL mode), the same yardstick
    args1 = ([q], [kc], [vc], [cl], scale)
    t_k = graph_ms(lambda: kfd.flash_decode_fused(*args1), iters=50)
    t_p = time_ms(lambda: kfd.fused_plain([kfd.strided_partial_plain(
        q, kc, vc, cl, scale, None, 0, 1)], bf16), iters=5)
    row("flash_decode_fused_w1", "src/repro_torch/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode.py:321", t_k, t_p, t_l,
        by - tp * nbytes(q) + nbytes(q),
        sum(4 * n * H * D for n in lens),
        f"one decode step at batch {B} on one rank, contiguous cache "
        f"S_max {S_max}, cur_len {lens}")
    return rows


# ------------------------------------------------------ phase 12: training
# the full-width training run (12c): llama3-8b at full width, depth cut
# to TRAIN_LAYERS (fp32 AdamW state is 16 B a parameter: 32 layers would
# need ~128 GB), batch 2 x 1024 tokens of SyntheticLM(seed=0)
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ = 2, 1024
TRAIN_STEPS = 6
TRAIN_LR = 1e-3           # warmup = TRAIN_STEPS: lr(t) = TRAIN_LR * t / 6
PROJ = (("wq", "wqkv"), ("wk", "wqkv"), ("wv", "wqkv"), ("wo", None),
        ("wg", "wgu"), ("wu", "wgu"), ("wd", None))


def train_products(cfg, M):
    """Every GEMM product of one training step of ``cfg`` over M tokens:
    (name, kind, M, K, N, dtype, trans_b, count a step). Per layer each
    projection runs forward twice (remat recomputes the layer in the
    backward), then its dA and dB; the unembed
    (fp32, the (vocab, d) table read transposed) forward, dA and dB
    once."""
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    qd, kvd = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    shapes = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d),
              "wg": (d, f), "wu": (d, f), "wd": (f, d)}
    bf, f32 = torch.bfloat16, torch.float32
    out = []
    for name, _ in PROJ:
        K, N = shapes[name]
        out += [(name, "fwd", M, K, N, bf, False, 2 * L),
                (name, "dA", M, N, K, bf, False, L),
                (name, "dB", K, M, N, bf, False, L)]
    return out + [("unembed", "fwd", M, d, V, f32, True, 1),
                  ("unembed", "dA", M, V, d, f32, False, 1),
                  ("unembed", "dB", V, M, d, f32, False, 1)]


def train_launches_per_step(cfg):
    """GEMM launches of one training step: per layer 4 forward launches
    (wq/wk/wv and wg/wu grouped) twice, the dA of every projection (7)
    and one dB launch per call (4: the groups' dB is one grouped
    launch); the unembed's 3."""
    return cfg.n_layers * (2 * 4 + 7 + 4) + 3


def _product_bound(M, K, N, dt):
    """(seconds, bound_by) of one product on the H100: its operations
    over the peak of its type, or each operand read once and C written
    once over the memory rate, whichever is longer."""
    return bound(2 * M * N * K, (M * K + K * N + M * N)
                 * torch.tensor([], dtype=dt).element_size(), dt)


def phase_train_gemm(gen, cfg, M):
    """(12a) the GEMM kernel vs its plain version at the shapes of a
    full-width training step: the seven projections (bf16) and the fp32
    unembed, forward and both gradient products (dA by both routes),
    phase 2's tolerances; the wq/wk/wv group at M bit-equal to its
    single calls. Times each product (CUDA events: kernel, plain version,
    one ``torch.matmul``). Returns per (name, kind) the times and the
    worst error."""
    from repro_torch.kernels import matmul as kmm
    shapes = {n: (K, N) for n, kind, _, K, N, _, _, _ in
              train_products(cfg, M) if kind == "fwd"}
    rows, worst = {}, 0.0

    def timed(fn, big):
        return time_ms(fn, iters=2 if big else 5, warmup=1)
    for name, (K, N) in shapes.items():
        unembed = name == "unembed"
        dt = torch.float32 if unembed else torch.bfloat16
        a = torch.randn((M, K), generator=gen, device="cuda").to(dt)
        b = (torch.randn((N, K) if unembed else (K, N), generator=gen,
                         device="cuda") / K ** 0.5).to(dt)
        dc = (torch.randn((M, N), generator=gen, device="cuda")
              / N ** 0.5).to(dt)
        at = a.t().contiguous()
        dct = dc.t().contiguous() if unembed else None
        cases = {"fwd": (lambda: kmm.matmul(a, b, trans_b=unembed),
                         lambda: kmm.matmul_plain(a, b, unembed),
                         (lambda: a @ b.t()) if unembed
                         else (lambda: a @ b))}
        if unembed:
            cases["dA"] = (lambda: kmm.matmul(dc, b),
                           lambda: kmm.matmul_plain(dc, b),
                           lambda: dc @ b)
            cases["dB"] = (lambda: kmm.matmul(dct, a),
                           lambda: kmm.matmul_plain(dct, a),
                           lambda: dc.t() @ a)
        else:
            # dA = dC @ B^T: B^T made contiguous (the backward's
            # route, matmul._grad_a) or B read transposed (TRANS)
            cases["dA_copy"] = (lambda: kmm._grad_a(dc, b, False),
                                lambda: kmm.matmul_plain(dc, b, True),
                                lambda: dc @ b.t())
            cases["dA_trans"] = (lambda: kmm.matmul(dc, b, trans_b=True),
                                 lambda: kmm.matmul_plain(dc, b, True),
                                 lambda: dc @ b.t())
            cases["dB"] = (lambda: kmm.matmul(at, dc),
                           lambda: kmm.matmul_plain(at, dc),
                           lambda: a.t() @ dc)
        for kind, (kern, plain, lib) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = _gemm_err(got, want, dt, f"train GEMM {name} {kind} "
                                           f"{tuple(got.shape)}")
            worst = max(worst, err)
            del got, want
            rows[(name, kind)] = {
                "shape": [M, K, N], "max_abs_err": err,
                "ms": timed(kern, unembed), "plain_ms": timed(plain, unembed),
                "library_ms": timed(lib, unembed)}
        del a, b, dc, at, dct
        torch.cuda.empty_cache()
    # a group at M = 2048: each product's M chunks are its own plan
    K = shapes["wq"][0]
    a = torch.randn((M, K), generator=gen, device="cuda").to(
        torch.bfloat16)
    bs = [(torch.randn((K, shapes[n][1]), generator=gen, device="cuda")
           / K ** 0.5).to(torch.bfloat16) for n in ("wq", "wk", "wv")]
    for c, b in zip(kmm.matmul_group(a, bs), bs):
        check(torch.equal(c, kmm.matmul(a, b)), "train GEMM group "
              "wq/wk/wv differs from its single calls")
    print("[train gemm] " + "; ".join(
        f"{n} {k} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
        f"torch.matmul {r['library_ms']:.3f})"
        for (n, k), r in rows.items()), flush=True)
    print(f"[train gemm] {len(rows)} products at training shapes match the "
          f"plain version (max |err| {worst:.3e}); the wq/wk/wv group "
          f"at M={M} bit-equal to single calls", flush=True)
    return rows, worst


def _cpu_copy(params, cfg, dev):
    """A trainable copy of ``params`` on ``dev``."""
    from repro_torch.models import lm
    from repro_torch.models.module import tree_map
    return lm.from_tree(cfg, tree_map(lambda _, t: t.detach().to(dev, copy=True),
                                      lm.param_tree(params)),
                        trainable=True)


def _ulp_noise(params, cfg, seed):
    """A CPU copy of ``params`` with every entry scaled by 1 + u, u
    uniform within one float32 ulp (2**-24 either way)."""
    noisy = _cpu_copy(params, cfg, "cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in noisy.parameters():
            t.mul_(1 + (torch.rand(t.shape, generator=gen) - 0.5) * 2 ** -23)
    return noisy


def _param_diff(p, q):
    """(max |p - q| over every leaf, whether every leaf is bit-equal)."""
    diff, same = 0.0, True
    for (n, x), (_, y) in zip(p.named_parameters(), q.named_parameters()):
        x, y = x.detach().cpu(), y.detach().cpu()
        diff = max(diff, (x - y).abs().max().item())
        same = same and torch.equal(x, y)
    return diff, same


def phase_train_small(tmp):
    """(12b) the float32 smoke model trained 4 steps on the card and on
    the CPU from the same parameters on the same batches (lr 1e-4). The
    first step's gradients leaf by leaf within 1e-3 of each leaf's
    largest |entry| (the logits are bf16 on both, ``lm.logits_fn``: an
    fp32 sum in another order can put a logit on the other side of a
    bf16 rounding boundary, and the one-ulp step spreads through the
    backward, as between the port and JAX on the CPU); after it every
    trainable leaf has a nonzero gradient on the card. Losses within
    1e-4 relative, grad norms within 1e-2 relative and the parameters
    within 4 x the sum of the lrs: the smoke init's layer weights (std
    0.5, the stacked fan-in) make later gradients sensitive, and AdamW's
    normalised update moves an entry by ~lr whatever its gradient's size,
    so an entry whose gradient is near zero can step either way (the
    count of entries more than 1e-6 apart is printed). On the card the
    GEMM launched and its plain version never ran. Then a checkpoint
    after step 2 resumed to step 4 (``--resume``) equals the
    uninterrupted run within 1e-6 (bit-equality reported)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch import train as tr
    from repro_torch.models import lm
    cfg = smoke_config(get_config("llama3-8b")).replace(dtype=torch.float32)
    argv = ["--arch", "llama3-8b", "--smoke", "--steps", "4", "--batch",
            "2", "--seq", "32", "--log-every", "1", "--lr", "1e-4",
            "--warmup", "4"]
    init = lm.init_params(cfg, seed=0, device="cpu", trainable=True)
    p_card = _cpu_copy(init, cfg, "cuda")
    resume_init = _cpu_copy(init, cfg, "cuda")
    grads0 = {}

    def first_grads(step, params, metrics):
        if step == 0:
            grads0[params.device.type] = {
                n: p.grad.detach().cpu().clone()
                for n, p in params.named_parameters() if p.grad is not None}
    cpu = tr.train(cfg, tr.parse_args(argv + ["--device", "cpu"]),
                   params=init, on_step=first_grads)
    ckpt = os.path.join(tmp, "train_small")
    n0, p0 = matmul.launches, matmul.plain_calls
    card = tr.train(cfg, tr.parse_args(argv + [
        "--device", "cuda", "--ckpt-dir", ckpt, "--ckpt-every", "2"]),
        params=p_card, on_step=first_grads)
    launched, plain = matmul.launches - n0, matmul.plain_calls - p0
    check(launched > 0 and plain == 0, f"train small: {launched} GEMM "
          f"launches and {plain} plain calls on the card")
    names = [n for n, _ in card["params"].named_parameters()]
    g_card, g_cpu = grads0["cuda"], grads0["cpu"]
    missing = [n for n in names if n not in g_card
               or not bool(g_card[n].abs().max() > 0)]
    check(not missing, f"train small: leaves without a gradient after "
                       f"step 1 on the card: {missing}")
    g_err = max(((g_card[n] - g_cpu[n]).abs().max()
                 / g_cpu[n].abs().max()).item() for n in names)
    check(g_err <= 1e-3, f"train small: step-1 gradients card vs CPU "
                         f"{g_err:.3e} of a leaf's largest entry")
    lc = [m["loss"] for m in cpu["log"]]
    lg = [m["loss"] for m in card["log"]]
    gc_ = [m["grad_norm"] for m in cpu["log"]]
    gg = [m["grad_norm"] for m in card["log"]]
    check(np.allclose(lg, lc, rtol=1e-4, atol=0), f"train small: card "
          f"losses {lg} vs CPU {lc}")
    check(np.allclose(gg, gc_, rtol=1e-2, atol=0), f"train small: card "
          f"grad norms {gg} vs CPU {gc_}")
    lr_sum = sum(1e-4 * t / 4 for t in range(1, 5))
    pdiff, _ = _param_diff(card["params"], cpu["params"])
    far = sum(int(((x.detach().cpu() - y.detach()).abs() > 1e-6).sum())
              for (_, x), (_, y) in zip(card["params"].named_parameters(),
                                        cpu["params"].named_parameters()))
    check(pdiff <= 4 * lr_sum, f"train small: card vs CPU parameters "
          f"{pdiff:.3e} apart (bound {4 * lr_sum:.3e})")
    # save after step 2 + --resume = the uninterrupted run
    rdir = os.path.join(tmp, "train_small_resume")
    os.makedirs(rdir)
    shutil.copytree(os.path.join(ckpt, "step_00000002"),
                    os.path.join(rdir, "step_00000002"))
    res = tr.train(cfg, tr.parse_args(argv + [
        "--device", "cuda", "--ckpt-dir", rdir, "--resume"]),
        params=resume_init)
    lr_ = [m["loss"] for m in res["log"]]
    rdiff, bitwise = _param_diff(res["params"], card["params"])
    check(res["start_step"] == 2 and np.allclose(lr_, lg[2:], rtol=1e-6),
          f"train small: resumed losses {lr_} vs {lg[2:]}")
    check(rdiff <= 1e-6, f"train small: resumed parameters {rdiff:.3e} "
          f"from the uninterrupted run's")
    out = {"step1_grad_err": g_err, "cpu_losses": lc, "card_losses": lg,
           "cpu_grad_norms": gc_,
           "card_grad_norms": gg, "param_max_diff": pdiff,
           "params_more_than_1e-6_apart": far, "gemm_launches": launched,
           "resume_losses": lr_, "resume_param_max_diff": rdiff,
           "resume_bitwise": bitwise}
    print(f"[train small] float32 smoke, 4 steps: step-1 gradients card "
          f"vs CPU within {g_err:.3e} of a leaf's largest entry; card losses "
          f"{lg} vs CPU {lc}; grad norms {gg} vs {gc_}; parameters max |diff| "
          f"{pdiff:.3e} ({far} entries > 1e-6); every leaf had a gradient "
          f"after step 1; {launched} GEMM launches, 0 plain calls; resume "
          f"after step 2 {'bit-equal to' if bitwise else 'within'} the "
          f"uninterrupted run (max |diff| {rdiff:.3e})", flush=True)
    return out


def _last_step_descent(cfg, params, dev, mesh):
    """The loss of the trained ``params`` (per-rank over ``mesh``, under
    TP_MODE) on the batch of the last step of a :func:`phase_train_full`
    or :func:`phase_tp_full` run, whose logged loss is that batch's
    before the step: a gradient of the wrong sign, or far off in size,
    would raise it."""
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.distributed import context as dctx
    from repro_torch.launch import steps as steps_lib
    steps = TRAIN_STEPS if mesh is None else TP_STEPS
    batch = shard_batch(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                    seed=0).batch_at(steps - 1), dev, mesh)
    ctx = dctx.DistContext(mesh, TP_MODE) if mesh is not None \
        else dctx.DistContext()
    with dctx.use(ctx):
        loss = steps_lib.make_eval_step(cfg)(params, batch)["loss"]
    return float(loss)


def _joined_grads(params, cfg, mesh, dev=None):
    """The gradients on ``params`` (one LM, or per-rank ones over
    ``mesh``) as global leaves: sharded blocks joined, a replicated
    leaf's summed copies taken once, None where the loss reads nothing;
    moved to ``dev`` if given."""
    from repro_torch.models import lm
    dims = {} if mesh is None else lm.shard_dims(cfg, mesh)
    per = [dict(p.named_parameters()) for p in lm.as_ranks(params)]
    out = {}
    for n, t in per[0].items():
        d = dims.get(n)
        g = (None if t.grad is None else t.grad.detach().clone()
             if d is None else torch.cat([q[n].grad.detach() for q in per],
                                         dim=d))
        out[n] = g if g is None or dev is None else g.to(dev)
    return out


def _tp_leaf_grads():
    """(13c, last part) llama3-8b at full width, TP_LEAF_LAYERS layers,
    float32 compute: the gradients that one ``launch.steps`` train step
    leaves on every leaf over TP ranks (``lm.shard_params`` of the
    seed-0 init, TP_MODE; the replicated leaves' copies summed by the
    step) against one rank's, on the first batch of 12c's data, each
    leaf's gap ||g_W - g_1|| / ||g_1||; on the seeded init as it is
    (printed: which leaves carry the gap that saturation spreads) and on
    it scaled by TP_LEAF_TEMPER in every stacked matrix, where every
    leaf must lie within TP_LEAF_RTOL. Returns both inits' gaps and the
    seconds."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.distributed import context as dctx
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    t0 = time.time()
    cfg = get_config("llama3-8b").replace(n_layers=TP_LEAF_LAYERS,
                                          dtype=torch.float32)
    mesh = make_mesh(TP, device="cuda")
    host = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                       seed=0).batch_at(0)
    step = steps_lib.make_train_step(cfg, adamw.AdamWConfig(lr=TRAIN_LR))
    out = {}
    for init in ("seeded", "tempered"):
        whole = lm.init_params(cfg, seed=0, device="cuda", trainable=True)
        if init == "tempered":
            with torch.no_grad():
                for t in whole.parameters():
                    if t.dim() >= 3:
                        t.mul_(TP_LEAF_TEMPER)
        ranks = lm.shard_params(whole, mesh)
        grads = []
        for p, m in ((whole, None), (ranks, mesh)):
            ctx = dctx.DistContext(m, TP_MODE) if m is not None \
                else dctx.DistContext()
            opt = steps_lib.init_opt_state(p)
            with dctx.use(ctx):
                step(p, opt, shard_batch(host, "cuda", m))
            grads.append(_joined_grads(p, cfg, m))
            del opt
            for r in lm.as_ranks(p):
                r.zero_grad(set_to_none=True)
        del whole, ranks
        gaps = {}
        for n, g1 in grads[0].items():
            check((g1 is None) == (grads[1][n] is None),
                  f"tp leaf gradients: {n} present at one rank count only")
            if g1 is not None:
                gaps[n] = ((grads[1][n] - g1).norm()
                           / g1.norm().clamp_min(1e-30)).item()
        del grads
        torch.cuda.empty_cache()
        out[init] = gaps
    worst = max(out["tempered"], key=out["tempered"].get)
    check(out["tempered"][worst] <= TP_LEAF_RTOL,
          f"tp leaf gradients (float32, tempered init): {worst} "
          f"{out['tempered'][worst]:.3e} apart at tp {TP} and tp 1 "
          f"(bound {TP_LEAF_RTOL})")
    out["s"] = time.time() - t0
    top = sorted(out["seeded"].items(), key=lambda kv: -kv[1])
    print(f"[tp full] float32, {TP_LEAF_LAYERS} layers, first-step "
          f"gradients tp {TP} vs tp 1, ||g_W - g_1|| / ||g_1|| per leaf: "
          f"tempered init worst {worst} {out['tempered'][worst]:.3e} "
          f"(bound {TP_LEAF_RTOL}); seeded init " + ", ".join(
              f"{n} {g:.3e}" for n, g in top) + f" ({out['s']:.1f} s)",
          flush=True)
    return out


def phase_train_full(gem_rows):
    """(12c) llama3-8b at full width, depth cut to TRAIN_LAYERS, bf16
    compute with fp32 masters and AdamW, remat full: TRAIN_STEPS steps
    of 2 x 1024 tokens through ``launch.train.train`` with warmup = the
    steps. Checks the losses finite and the last step's descent: the
    trained parameters' loss on the last step's batch below that batch's
    loss before the step (:func:`_last_step_descent`; the logged losses
    are each a new batch's, all near ln V at this init, and whether the
    last lies below the first turns on the draw, so it is printed, not
    checked), the GEMM launches of every step, no plain call, and peak
    memory below 80 GB; then one more step under the profiler for the
    GEMM's device time. Returns the run's numbers."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as tr
    from repro_torch.optim import adamw
    cfg = get_config("llama3-8b").replace(n_layers=TRAIN_LAYERS)
    M = TRAIN_BATCH * TRAIN_SEQ
    args = tr.parse_args([
        "--arch", "llama3-8b", "--steps", str(TRAIN_STEPS), "--batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--warmup",
        str(TRAIN_STEPS), "--lr", str(TRAIN_LR), "--log-every", "1",
        "--device", "cuda"])
    per_step = train_launches_per_step(cfg)
    counts = []

    def count(step, params, metrics):
        counts.append(matmul.launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    matmul.launches = matmul.plain_calls = 0
    t0 = time.time()
    res = tr.train(cfg, args, on_step=count)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches, plain = matmul.launches, matmul.plain_calls
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for m in res["log"]]
    grad_norms = [m["grad_norm"] for m in res["log"]]
    steps_s = [m["s"] for m in res["log"]]
    check(all(np.isfinite(losses)), f"train full width: losses {losses}")
    descent = _last_step_descent(cfg, res["params"], "cuda", None)
    check(descent < losses[-1], f"train full width: the last step's batch "
          f"at {descent} after the step, {losses[-1]} before it")
    deltas = np.diff([0] + counts).tolist()
    check(plain == 0 and deltas == [per_step] * TRAIN_STEPS,
          f"train full width: GEMM launches per step {deltas} (want "
          f"{per_step}), {plain} plain calls")
    check(peak_gb < 80, f"train full width: peak {peak_gb:.1f} GB")
    n_params = sum(p.numel() for p in res["params"].parameters())
    step_s = float(np.mean(steps_s[1:]))
    prods = train_products(cfg, M)
    gemm_flops = sum(2 * m * k * n * c for _, _, m, k, n, _, _, c in prods)
    H, S, hd = cfg.n_heads, TRAIN_SEQ, cfg.hd
    # QK^T and PV (dense fp32 attention) forward twice (remat) and their
    # backward (two products each)
    attn_flops = cfg.n_layers * (2 + 2) * 2 * (2 * TRAIN_BATCH * H * S * S
                                              * hd)
    flops = gemm_flops + attn_flops
    # one more step under the profiler: the GEMM's device time
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR)
    step_fn = steps_lib.make_train_step(cfg, opt_cfg)
    batch = shard_batch(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                    seed=0).batch_at(TRAIN_STEPS), "cuda")
    params, opt = res["params"], res["opt"]
    del res
    torch.cuda.synchronize()
    t1 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
    prof_wall = time.time() - t1
    kern = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        # kernels only: the autograd Functions' and ops' CPU ranges
        # repeat their kernels' device time
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kern.append((dev_us, ev.key, ev.count))
    kern.sort(reverse=True)
    dev_ms = sum(k[0] for k in kern) / 1e3
    gemm_ms = sum(k[0] for k in kern if port_kernel("gemm_stream", k[1])
                  or port_kernel("mm_kernel", k[1])) / 1e3
    gemm_calls = sum(k[2] for k in kern if port_kernel("gemm_stream", k[1])
                     or port_kernel("mm_kernel", k[1]))
    del params, opt, batch, step_fn
    # per-step sums of 12a's per-product times (dA by the backward's
    # route, B^T made contiguous)

    def per_step_ms(key):
        tot = 0.0
        for name, kind, _, _, _, _, _, c in prods:
            k = kind if name == "unembed" or kind != "dA" else "dA_copy"
            tot += c * gem_rows[(name, k)][key]
        return tot
    bound_s = sum(c * _product_bound(m, k, n, dt)[0]
                  for _, _, m, k, n, dt, _, c in prods)
    ops_tot = sum(c * ops_s(2 * m * k * n, dt)
                    for _, _, m, k, n, dt, _, c in prods)
    by_tot = sum(c * bytes_s((m * k + k * n + m * n)
                                  * (4 if dt == torch.float32 else 2))
                      for _, _, m, k, n, dt, _, c in prods)
    out = {"config": f"llama3-8b full width, {cfg.n_layers} of 32 layers, "
                     f"bf16 compute, fp32 masters, remat full",
           "params": n_params, "tokens_per_step": M,
           "steps": TRAIN_STEPS, "lr": TRAIN_LR, "losses": losses,
           "last_below_first": losses[-1] < losses[0],
           "last_batch_loss_after_step": descent,
           "grad_norms": grad_norms, "step_s": steps_s, "ms_per_step": 1e3 * step_s,
           "tokens_per_s": M / step_s, "run_s": run_s,
           "flops_per_step": flops, "gemm_flops_per_step": gemm_flops,
           "tflops_per_s": flops / step_s / 1e12,
           "peak_share": ops_s(flops, torch.bfloat16) / step_s,
           "peak_gb": peak_gb, "gemm_launches": launches,
           "gemm_launches_per_step": per_step,
           "profiled_step": {"wall_ms": 1e3 * prof_wall,
                             "device_ms": dev_ms, "gemm_ms": gemm_ms,
                             "gemm_calls": gemm_calls,
                             "top_kernels": [
                                 {"name": k[1][:80], "ms": k[0] / 1e3,
                                  "calls": k[2]} for k in kern[:10]]},
           "gemm_ms_per_step_12a": per_step_ms("ms"),
           "plain_ms_per_step": per_step_ms("plain_ms"),
           "library_ms_per_step": per_step_ms("library_ms"),
           "bound_ms_per_step": 1e3 * bound_s,
           "bound_by": "operations" if ops_tot >= by_tot else "bytes"}
    print(f"[train full] {out['config']}: {n_params / 1e9:.3f} B "
          f"parameters; losses {[round(x, 4) for x in losses]} (last "
          f"below first: {losses[-1] < losses[0]}); the last step's "
          f"batch {losses[-1]:.4f} -> {descent:.4f} after it; "
          f"{out['ms_per_step']:.1f} ms per step after step 0 "
          f"({out['tokens_per_s']:.0f} tokens/s), "
          f"{out['tflops_per_s']:.1f} TFLOP/s executed "
          f"({100 * out['peak_share']:.1f}% of 989 TF); peak "
          f"{peak_gb:.2f} GB; {per_step} GEMM launches a step; profiled "
          f"step: wall {1e3 * prof_wall:.1f} ms, device {dev_ms:.1f} ms, "
          f"GEMM {gemm_ms:.1f} ms in {gemm_calls} launches; torch.matmul "
          f"at the same shapes {out['library_ms_per_step']:.1f} ms a "
          f"step, bound {out['bound_ms_per_step']:.1f} ms", flush=True)
    print("[train full] top kernels of the profiled step: " + "; ".join(
        f"{k['name'][:50]} {k['ms']:.1f} ms x {k['calls']}"
        for k in out["profiled_step"]["top_kernels"][:6]), flush=True)
    return out


def phase_train(gen):
    """(12) the training path: 12a, 12b, 12c; frees what it made."""
    from repro_torch.configs import get_config
    cfg = get_config("llama3-8b").replace(n_layers=TRAIN_LAYERS)
    tmp = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    rows, worst = phase_train_gemm(gen, cfg, TRAIN_BATCH * TRAIN_SEQ)
    small = phase_train_small(tmp)
    full = phase_train_full(rows)
    shutil.rmtree(tmp, ignore_errors=True)
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    kernel = {"name": "matmul_train", "route": "cuda",
              "source": "src/repro_torch/csrc/matmul.cu",
              "replaces": "src/repro/kernels/matmul.py:34",
              "launches": full["gemm_launches"],
              "launches_per_step": full["gemm_launches_per_step"],
              "max_abs_err": worst,
              "ms": full["profiled_step"]["gemm_ms"],
              "kernel_ms_12a": full["gemm_ms_per_step_12a"],
              "plain_ms": full["plain_ms_per_step"],
              "bound_ms": full["bound_ms_per_step"],
              "bound_by": full["bound_by"],
              "library_ms": full["library_ms_per_step"],
              "unit": f"one training step of {full['config']}, "
                      f"{full['tokens_per_step']} tokens"}
    return {"gemm": {f"{n} {k}": r for (n, k), r in rows.items()},
            "small": small, "full": full}, kernel


# --------------------------------------------- phase 13: training over W
TP = 4                     # virtual ranks of cuda:0
TP_STEPS = 4
TP_MODE = "ring"           # the train sites' ring_bidir (core.patterns)
# 13c against 12c at step 0, the same init and batch: the loss's absolute
# gap, ~5x what one H100 measured (9.7e-5; PERF.md). Both runs are
# deterministic on the card but for the embedding backward's atomics, so
# the gap repeats. The gradient norm's gap is printed, not checked: at
# this init (the stacked fan-in's std 0.5: attention saturated) bf16's
# rounding at other places over the ranks moves it by up to tens of
# percent with the seed. The gradients are held leaf by leaf in float32 instead, at
# TP_LEAF_LAYERS layers, on the seeded init scaled by TP_LEAF_TEMPER in
# every stacked matrix (std ~1/sqrt(fan-in): nothing saturates), within
# TP_LEAF_RTOL of each leaf's norm (float32 sums in another order).
TP_LOSS_ATOL = 5e-4
TP_LEAF_LAYERS = 2
TP_LEAF_TEMPER = 1 / 64
TP_LEAF_RTOL = 1e-4


def tp_products(cfg, M, W):
    """Every GEMM product of one training step of ``cfg`` over M tokens
    (B = 2 sequences) at ``W`` ranks under ``ring``/``pallas`` (the
    sites' ``ring_bidir``): (name, kind, M, K, N, dtype, trans_b, count a
    step). An up site (wq/wk/wv/wg/wu) multiplies each half of every
    rank's row block, M / (2W) rows, by the rank's N/W columns: 2W
    products a rank, 2W^2 a site; a down site (wo/wd) multiplies M/W
    rows of the rank's K/W columns by each N/2 half: 2W^2 too. Each runs
    forward twice under remat and has a dA and a dB; the unembed is one
    fp32 product a rank (the rows gathered, the rank's vocab shard)."""
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    qd, kvd = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    up = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wg": (d, f),
          "wu": (d, f)}
    down = {"wo": (qd, d), "wd": (f, d)}
    bf, f32 = torch.bfloat16, torch.float32
    n = 2 * W * W * L
    fwd = 2 * n if cfg.remat else n
    out = []
    for name, (K, N) in up.items():
        m, Nr = M // (2 * W), N // W
        out += [(name, "fwd", m, K, Nr, bf, False, fwd),
                (name, "dA", m, Nr, K, bf, False, n),
                (name, "dB", K, m, Nr, bf, False, n)]
    for name, (K, N) in down.items():
        m, Kr = M // W, K // W
        out += [(name, "fwd", m, Kr, N // 2, bf, False, fwd),
                (name, "dA", m, N // 2, Kr, bf, False, n),
                (name, "dB", Kr, m, N // 2, bf, False, n)]
    return out + [("unembed", "fwd", M, d, V // W, f32, True, W),
                  ("unembed", "dA", M, V // W, d, f32, False, W),
                  ("unembed", "dB", V // W, M, d, f32, False, W)]


def _ranks_close(got, want, dt, what):
    """13a's tolerance: float32, phase 12a's (1e-4 of the largest |C|;
    fp32 sums in another order); bf16, the norm of the error within 1e-2
    of the norm of the single product (a W-rank sum rounds each partial
    product to bf16, 2**-8 relative, so single entries near a
    cancellation move by more than 12a's per-entry bound). Returns the
    max |err| (float32) or the relative norm of the error (bf16)."""
    got, want = got.float(), want.float()
    if dt == torch.float32:
        return _gemm_err(got, want, dt, what)
    err = ((got - want).norm() / want.norm()).item()
    check(err <= 1e-2, f"{what}: relative error {err:.3e}")
    return err


def phase_tp_sites(gen, W=TP, B=TRAIN_BATCH, S=TRAIN_SEQ):
    """(13a) the train sites over W virtual ranks of cuda:0 at llama3-8b
    training shapes (M = B x S rows, d 4096; wq N 4096, wg N 14336, wd K
    14336): ``ag_gemm_m_sharded`` (wq, wg) and ``gemm_rs`` (wd) in
    ``bsp`` and ``ring_bidir``, forward and both gradients (autograd
    through the per-rank GEMM calls), against one single-rank product on
    the same data (``_ranks_close``), in float32 and in bf16; then device
    ms (CUDA events) and GEMM launches of one bf16 forward + backward
    per site and mode. Returns (rows, the worst float32 max |err|, the
    worst bf16 relative error)."""
    from repro_torch.core import collective_matmul as cm
    from repro_torch.kernels.matmul import matmul, matmul_plain
    d, f = 4096, 14336
    sites = (("wq ag", "ag", d, 4096), ("wg ag", "ag", d, f),
             ("wd rs", "rs", f, d))
    rows, worst = {}, {torch.float32: 0.0, torch.bfloat16: 0.0}

    def shards(x, dim):
        n = x.shape[dim] // W
        return [x.narrow(dim, r * n, n).contiguous().requires_grad_()
                for r in range(W)]
    for name, fn, K, N in sites:
        for dt in (torch.float32, torch.bfloat16):
            a = torch.randn((B, S, K), generator=gen, device="cuda").to(dt)
            b = (torch.randn((K, N), generator=gen, device="cuda")
                 / K ** 0.5).to(dt)
            dy = torch.randn((B, S, N), generator=gen, device="cuda").to(dt)
            # the single-rank product and its gradients (plain fp32 sums)
            want = matmul_plain(a.reshape(-1, K), b).reshape(B, S, N)
            d2 = dy.reshape(-1, N)
            want_da = matmul_plain(d2, b, True).reshape(B, S, K)
            want_db = matmul_plain(a.reshape(-1, K).t().contiguous(), d2)
            if fn == "ag":      # rows of A, columns of B and C
                dims, body = (1, 1, -1), cm.ag_gemm_m_sharded
            else:               # columns of A, rows of B, rows of C
                dims, body = (-1, 0, 1), cm.gemm_rs
            for mode in ("bsp", "ring_bidir"):
                a_s, b_s = shards(a, dims[0]), shards(b, dims[1])
                dys = [t.detach() for t in shards(dy, dims[2])]

                def run():
                    for t in a_s + b_s:
                        t.grad = None
                    out = body(a_s, b_s, mode=mode)
                    torch.autograd.backward(out, dys)
                    return out
                n0 = matmul.launches
                out = run()
                torch.cuda.synchronize()
                launches = matmul.launches - n0
                what = f"13a {name} {mode} {str(dt)[6:]}"
                errs = [_ranks_close(torch.cat(out, dim=dims[2]), want, dt,
                                     f"{what} forward"),
                        _ranks_close(torch.cat([t.grad for t in a_s],
                                               dim=dims[0]), want_da, dt,
                                     f"{what} dA"),
                        _ranks_close(torch.cat([t.grad for t in b_s],
                                               dim=dims[1]), want_db, dt,
                                     f"{what} dB")]
                worst[dt] = max([worst[dt]] + errs)
                if dt == torch.bfloat16:
                    rows[f"{name} {mode}"] = {
                        "launches": launches, "bf16_rel_err": max(errs),
                        "ms": time_ms(run, iters=3, warmup=1)}
                del out, a_s, b_s, dys
            del a, b, dy, want, want_da, want_db, d2
            torch.cuda.empty_cache()
    print("[tp sites] W=4 virtual ranks, M = 2 x 1024, forward + both "
          "gradients (bf16): " + "; ".join(
              f"{k} {r['ms']:.2f} ms in {r['launches']} GEMM launches"
              for k, r in rows.items()) + f"; within tolerance of the "
          f"single-rank product (float32 max |err| "
          f"{worst[torch.float32]:.3e}, bf16 relative "
          f"{worst[torch.bfloat16]:.3e})", flush=True)
    return rows, worst[torch.float32], worst[torch.bfloat16]


def _tp_train_args(extra):
    from repro_torch.launch import train as tr
    return tr.parse_args(["--arch", "llama3-8b", "--smoke", "--steps", "4",
                          "--batch", "2", "--seq", "32", "--log-every", "1",
                          "--lr", "1e-4", "--warmup", "4", "--fusion-mode",
                          TP_MODE] + extra)


def phase_tp_small(tmp):
    """(13b) the float32 smoke model at tp 4 on the card against tp 4 on
    the CPU and tp 1 on the card, from the same parameters on the same
    batches: the first step's loss within 1e-5 relative and every
    gradient leaf (the per-rank blocks joined, the copies of a replicated
    leaf summed) within 1e-3 of its largest |entry| (12b's tolerance: the
    bf16 logits), the GEMM launched and its plain version never ran on
    the card; then a checkpoint after step 2 at tp 4 resumed at tp 1 to
    step 4: losses within 1e-4 relative of the uninterrupted tp 4 run
    (12b's tolerance) and every parameter leaf within 1e-3 of the norm
    of its four-step update (10x the 1.0e-4 one H100 measured; a run
    that took no step stands at 1.0)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.distributed.context import Mesh
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch import train as tr
    from repro_torch.models import lm
    cfg = smoke_config(get_config("llama3-8b")).replace(dtype=torch.float32)
    init = lm.init_params(cfg, seed=0, device="cpu", trainable=True)
    grads = {}

    def first_grads(key):
        def keep(step, params, metrics):
            if step != 0:
                return
            ranks = params if isinstance(params, list) else [params]
            dims = lm.shard_dims(cfg, Mesh(["cpu"] * len(ranks)))
            per = [dict(p.named_parameters()) for p in ranks]
            grads[key] = {n: (per[0][n].grad.detach().cpu().clone()
                              if d is None or len(ranks) == 1 else
                              torch.cat([q[n].grad.detach().cpu()
                                         for q in per], dim=d))
                          for n, d in dims.items()}
        return keep
    tp = ["--tp", str(TP)]
    cpu = tr.train(cfg, _tp_train_args(tp + ["--device", "cpu"]),
                   params=_cpu_copy(init, cfg, "cpu"),
                   on_step=first_grads("cpu4"))
    one = tr.train(cfg, _tp_train_args(["--device", "cuda"]),
                   params=_cpu_copy(init, cfg, "cuda"),
                   on_step=first_grads("card1"))
    ckpt = os.path.join(tmp, "tp_small")
    n0, p0 = matmul.launches, matmul.plain_calls
    card = tr.train(cfg, _tp_train_args(tp + [
        "--device", "cuda", "--ckpt-dir", ckpt, "--ckpt-every", "2"]),
        params=_cpu_copy(init, cfg, "cuda"), on_step=first_grads("card4"))
    launched, plain = matmul.launches - n0, matmul.plain_calls - p0
    check(launched > 0 and plain == 0, f"tp small: {launched} GEMM "
          f"launches and {plain} plain calls on the card")
    l4 = [m["loss"] for m in card["log"]]
    errs = {}
    for other, run in (("cpu4", cpu), ("card1", one)):
        lo = [m["loss"] for m in run["log"]]
        check(np.isclose(l4[0], lo[0], rtol=1e-5, atol=0),
              f"tp small: first loss {l4[0]} vs {other} {lo[0]}")
        g_err = max(((grads["card4"][n] - g).abs().max()
                     / g.abs().max()).item()
                    for n, g in grads[other].items())
        check(g_err <= 1e-3, f"tp small: step-1 gradients vs {other} "
                             f"{g_err:.3e} of a leaf's largest entry")
        errs[other] = {"losses": lo, "grad_err": g_err}
    rdir = os.path.join(tmp, "tp_small_resume")
    os.makedirs(rdir)
    shutil.copytree(os.path.join(ckpt, "step_00000002"),
                    os.path.join(rdir, "step_00000002"))
    res = tr.train(cfg, _tp_train_args([
        "--device", "cuda", "--ckpt-dir", rdir, "--resume"]),
        params=_cpu_copy(init, cfg, "cuda"))
    lr_ = [m["loss"] for m in res["log"]]
    check(res["start_step"] == 2 and np.allclose(lr_, l4[2:], rtol=1e-4),
          f"tp small: resumed at tp 1 losses {lr_} vs tp 4 {l4[2:]}")
    full = lm.gather_params(card["params"], Mesh(["cuda"] * TP))
    rdiff, _ = _param_diff(res["params"], full)
    start = dict(init.named_parameters())
    rel = max(((x.detach().cpu() - y.detach().cpu()).norm()
               / (y.detach().cpu() - start[n]).norm()).item()
              for (n, x), (_, y) in zip(res["params"].named_parameters(),
                                        full.named_parameters()))
    check(rel <= 1e-3, f"tp small: resumed parameters {rel:.3e} of the "
                       f"update's norm from the uninterrupted run's")
    out = {"card_tp4_losses": l4, "vs": errs, "gemm_launches": launched,
           "resume_tp1_losses": lr_, "resume_param_max_diff": rdiff,
           "resume_param_diff_over_update": rel}
    print(f"[tp small] float32 smoke, tp 4 on the card: losses {l4}; "
          f"first step vs tp 4 on the CPU: gradients within "
          f"{errs['cpu4']['grad_err']:.3e} of a leaf's largest entry, vs "
          f"tp 1 on the card {errs['card1']['grad_err']:.3e}; {launched} "
          f"GEMM launches, 0 plain calls; checkpoint after step 2 resumed "
          f"at tp 1: losses {lr_}, parameters {rdiff:.3e} from the "
          f"uninterrupted run ({rel:.3e} of the update's norm)", flush=True)
    return out


def phase_tp_full(step0_loss, step0_gnorm):
    """(13c) llama3-8b at full width, TRAIN_LAYERS of 32 layers (as 12c),
    tp 4 virtual ranks, ``--fusion-mode ring``: TP_STEPS steps of 2 x
    1024 tokens of SyntheticLM(seed=0) through ``launch.train.train``
    (the same seeded init as 12c, born sharded). Checks the losses
    finite; the first within TP_LOSS_ATOL of 12c's first (the same
    parameters and batch); the last step's descent
    (:func:`_last_step_descent`, as 12c); the GEMM launches of every
    step (``tp_products``), no plain call, peak memory below 80 GB; then
    one more step under the profiler: device busy share, GEMM ms and
    launches; then every leaf's first-step gradient at tp 4 against tp 1
    (:func:`_tp_leaf_grads`). The first gradient norm's gap to 12c's is
    printed (TP_LOSS_ATOL's comment says why it is not checked). Returns
    the run's numbers."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.distributed import context as dctx
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as tr
    from repro_torch.optim import adamw
    cfg = get_config("llama3-8b").replace(n_layers=TRAIN_LAYERS)
    M = TRAIN_BATCH * TRAIN_SEQ
    args = tr.parse_args([
        "--arch", "llama3-8b", "--steps", str(TP_STEPS), "--batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--warmup",
        str(TRAIN_STEPS), "--lr", str(TRAIN_LR), "--log-every", "1",
        "--device", "cuda", "--tp", str(TP), "--fusion-mode", TP_MODE])
    prods = tp_products(cfg, M, TP)
    per_step = sum(p[-1] for p in prods)
    counts = []

    def count(step, params, metrics):
        counts.append(matmul.launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    matmul.launches = matmul.plain_calls = 0
    t0 = time.time()
    res = tr.train(cfg, args, on_step=count)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches, plain = matmul.launches, matmul.plain_calls
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for m in res["log"]]
    steps_s = [m["s"] for m in res["log"]]
    check(all(np.isfinite(losses)), f"tp full width: losses {losses}")
    gnorms = [m["grad_norm"] for m in res["log"]]
    loss_gap = abs(losses[0] - step0_loss)
    gnorm_gap = abs(gnorms[0] - step0_gnorm) / step0_gnorm
    check(loss_gap <= TP_LOSS_ATOL, f"tp full width: first loss "
          f"{losses[0]} vs 12c's {step0_loss}")
    descent = _last_step_descent(cfg, res["params"], res["params"][0].device,
                                 tr.build_mesh(args))
    check(descent < losses[-1], f"tp full width: the last step's batch "
          f"at {descent} after the step, {losses[-1]} before it")
    deltas = np.diff([0] + counts).tolist()
    check(plain == 0 and deltas == [per_step] * TP_STEPS,
          f"tp full width: GEMM launches per step {deltas} (want "
          f"{per_step}), {plain} plain calls")
    check(peak_gb < 80, f"tp full width: peak {peak_gb:.1f} GB")
    step_s = float(np.mean(steps_s[1:]))
    # one more step under the profiler
    dev0 = res["params"][0].device
    ctx = dctx.DistContext(tr.build_mesh(args), TP_MODE)
    step_fn = steps_lib.make_train_step(cfg, adamw.AdamWConfig(lr=TRAIN_LR))
    batch = shard_batch(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                    seed=0).batch_at(TP_STEPS), dev0)
    params, opt = res["params"], res["opt"]
    del res
    torch.cuda.synchronize()
    t1 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            dctx.use(ctx):
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
    prof_wall = time.time() - t1
    kern = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kern.append((dev_us, ev.key, ev.count))
    kern.sort(reverse=True)
    dev_ms = sum(k[0] for k in kern) / 1e3
    is_gemm = [port_kernel("gemm_stream", k[1])
               or port_kernel("mm_kernel", k[1]) for k in kern]
    gemm_ms = sum(k[0] for k, g in zip(kern, is_gemm) if g) / 1e3
    gemm_calls = sum(k[2] for k, g in zip(kern, is_gemm) if g)
    del params, opt, batch, step_fn
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    leaf = _tp_leaf_grads()
    busy = dev_ms / (1e3 * prof_wall)
    out = {"config": f"llama3-8b full width, {cfg.n_layers} of 32 layers, "
                     f"tp {TP} virtual ranks, fusion mode {TP_MODE}, bf16 "
                     f"compute, fp32 masters, remat full",
           "tokens_per_step": M, "steps": TP_STEPS, "losses": losses,
           "grad_norms": gnorms, "step0_loss_12c": step0_loss,
           "step0_grad_norm_12c": step0_gnorm, "step0_loss_gap": loss_gap,
           "step0_grad_norm_gap": gnorm_gap,
           "last_batch_loss_after_step": descent,
           "leaf_grads_f32": leaf, "step_s": steps_s,
           "ms_per_step": 1e3 * step_s, "tokens_per_s": M / step_s,
           "run_s": run_s, "peak_gb": peak_gb, "gemm_launches": launches,
           "gemm_launches_per_step": per_step,
           "device_ms_over_step_ms": dev_ms / (1e3 * step_s),
           "profiled_step": {"wall_ms": 1e3 * prof_wall,
                             "device_ms": dev_ms, "busy_share": busy,
                             "gemm_ms": gemm_ms, "gemm_calls": gemm_calls,
                             "top_kernels": [
                                 {"name": k[1][:80], "ms": k[0] / 1e3,
                                  "calls": k[2]} for k in kern[:10]]}}
    print(f"[tp full] {out['config']}: losses "
          f"{[round(x, 4) for x in losses]}; first loss {loss_gap:.3e} "
          f"from 12c's {step0_loss:.6f}, first grad norm {gnorms[0]:.6f} "
          f"vs 12c's {step0_gnorm:.6f} ({gnorm_gap:.3e} relative, not "
          f"checked); the last step's batch {losses[-1]:.4f} -> "
          f"{descent:.4f} after it; "
          f"{out['ms_per_step']:.1f} ms per step after step 0 "
          f"({out['tokens_per_s']:.0f} tokens/s); peak {peak_gb:.2f} GB; "
          f"{per_step} GEMM launches a step; profiled step: wall "
          f"{1e3 * prof_wall:.1f} ms, device {dev_ms:.1f} ms (busy "
          f"{busy:.3f}; {out['device_ms_over_step_ms']:.3f} of an "
          f"unprofiled step), GEMM {gemm_ms:.1f} ms in {gemm_calls} "
          f"launches", flush=True)
    return out


def tp_product_times(gen, prods):
    """Every distinct product of ``prods`` on random operands: the
    kernel held against its plain version (``_gemm_err``, the tolerance
    of phases 2 and 12a), and the device ms (CUDA events) of the kernel,
    its plain version and one ``torch.matmul``. Returns (times, the
    worst max |err|)."""
    from repro_torch.kernels.matmul import matmul, matmul_plain
    times, worst = {}, 0.0
    for _, _, m, k, n, dt, trans_b, _ in prods:
        key = (m, k, n, dt, trans_b)
        if key in times:
            continue
        a, b = _gemm_operands(gen, m, k, n, dt, trans_b)
        got, want = matmul(a, b, trans_b=trans_b), matmul_plain(a, b, trans_b)
        torch.cuda.synchronize()
        worst = max(worst, _gemm_err(
            got, want, dt, f"tp GEMM M={m} K={k} N={n} {str(dt)[6:]}"
                           f"{' TRANS' if trans_b else ''}"))
        del got, want
        bt = b.t() if trans_b else b
        times[key] = {
            "ms": time_ms(lambda: matmul(a, b, trans_b=trans_b), iters=5,
                          warmup=1),
            "plain_ms": time_ms(lambda: matmul_plain(a, b, trans_b),
                                iters=5, warmup=1),
            "library_ms": time_ms(lambda: a @ bt, iters=5, warmup=1)}
        del a, b, bt
    torch.cuda.empty_cache()
    print(f"[tp full] {len(times)} distinct products of the tp {TP} step "
          f"match the plain version (max |err| {worst:.3e})", flush=True)
    return times, worst


def phase_train_tp(gen, step0_loss, step0_gnorm):
    """(13) training over W ranks: 13a, 13b, 13c; frees what it made.
    Returns (numbers, the kernels-line row of the GEMM at tp 4)."""
    from repro_torch.configs import get_config
    tmp = os.path.join(ROOT, "build", "chip_smoke_train_tp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    sites, worst, worst_bf16 = phase_tp_sites(gen)
    small = phase_tp_small(tmp)
    full = phase_tp_full(step0_loss, step0_gnorm)
    shutil.rmtree(tmp, ignore_errors=True)
    cfg = get_config("llama3-8b").replace(n_layers=TRAIN_LAYERS)
    prods = tp_products(cfg, TRAIN_BATCH * TRAIN_SEQ, TP)
    times, prod_err = tp_product_times(gen, prods)

    def per_step(key):
        return sum(c * times[(m, k, n, dt, tb)][key]
                   for _, _, m, k, n, dt, tb, c in prods)
    bound_s = sum(c * _product_bound(m, k, n, dt)[0]
                  for _, _, m, k, n, dt, _, c in prods)
    ops_tot = sum(c * ops_s(2 * m * k * n, dt)
                    for _, _, m, k, n, dt, _, c in prods)
    by_tot = sum(c * bytes_s((m * k + k * n + m * n)
                                  * (4 if dt == torch.float32 else 2))
                      for _, _, m, k, n, dt, _, c in prods)
    kernel = {"name": "matmul_train_tp4", "route": "cuda",
              "source": "src/repro_torch/csrc/matmul.cu",
              "replaces": "src/repro/kernels/matmul.py:34",
              "launches": full["gemm_launches"],
              "launches_per_step": full["gemm_launches_per_step"],
              "max_abs_err": max(worst, prod_err),
              "bf16_rel_err": worst_bf16,
              "ms": full["profiled_step"]["gemm_ms"],
              "kernel_ms_products": per_step("ms"),
              "plain_ms": per_step("plain_ms"),
              "bound_ms": 1e3 * bound_s,
              "bound_by": "operations" if ops_tot >= by_tot else "bytes",
              "library_ms": per_step("library_ms"),
              "unit": f"one training step of {full['config']}, "
                      f"{full['tokens_per_step']} tokens"}
    print(f"[tp full] GEMM at tp {TP} a step: {kernel['ms']:.1f} ms "
          f"(profiled), {kernel['kernel_ms_products']:.1f} ms as the sum "
          f"of its products timed alone, plain {kernel['plain_ms']:.1f}, "
          f"torch.matmul {kernel['library_ms']:.1f}, bound "
          f"{kernel['bound_ms']:.1f} ms ({kernel['bound_by']})", flush=True)
    return {"sites": sites, "small": small, "full": full}, kernel


# ------------------------------------- phase 21: a data x model mesh
DM_MESH = (2, 2)           # (data, model): 4 virtual ranks of cuda:0
DM_STEPS = 3
DM_MODE = TP_MODE          # 13c's fusion mode at the model-axis sites


def _dm_args(extra, devices):
    from repro_torch.launch import train as tr
    D, W = DM_MESH
    return tr.parse_args(["--devices", ",".join([devices] * (D * W)),
                          "--tp", str(W), "--fusion-mode", DM_MODE] + extra)


def _dm_grads(params, cfg):
    """The global gradient of every leaf of a run's parameters after a
    step (one LM, or one a rank of the (data, model) mesh: the blocks
    joined, ``lm.gather_grads``), on the CPU."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    if not isinstance(params, list):
        return {n: t.grad.detach().cpu().clone()
                for n, t in params.named_parameters()}
    return {n: g.cpu() for n, g in lm.gather_grads(
        params, make_host_mesh(*DM_MESH, device="cpu")).items()}


def phase_dm_small():
    """(21a) the float32 smoke model at (data 2, model 2) on 4 virtual
    ranks of cuda:0 against the same mesh on the CPU and one rank on the
    card, from the same parameters on the same batch (2 rows: one a data
    group): the first loss within 1e-5 relative and every gradient leaf
    within 1e-3 of its largest |entry| (13b's bounds: the bf16 logits),
    the GEMM launched and its plain version never ran on the card."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch import train as tr
    from repro_torch.models import lm
    cfg = smoke_config(get_config("llama3-8b")).replace(dtype=torch.float32)
    init = lm.init_params(cfg, seed=0, device="cpu", trainable=True)
    base = ["--arch", "llama3-8b", "--smoke", "--steps", "1", "--batch",
            "2", "--seq", "32", "--log-every", "1", "--lr", "1e-4",
            "--warmup", "4"]
    grads, losses = {}, {}

    def keep(key):
        def fn(step, params, metrics):
            grads[key] = _dm_grads(params, cfg)
            losses[key] = float(metrics["loss"])
        return fn
    tr.train(cfg, _dm_args(base, "cpu"), params=_cpu_copy(init, cfg, "cpu"),
             on_step=keep("cpu_mesh"))
    tr.train(cfg, tr.parse_args(base + ["--device", "cuda"]),
             params=_cpu_copy(init, cfg, "cuda"), on_step=keep("card1"))
    n0, p0 = matmul.launches, matmul.plain_calls
    tr.train(cfg, _dm_args(base, "cuda:0"),
             params=_cpu_copy(init, cfg, "cuda"), on_step=keep("card_mesh"))
    launched, plain = matmul.launches - n0, matmul.plain_calls - p0
    check(launched > 0 and plain == 0, f"dm small: {launched} GEMM "
          f"launches and {plain} plain calls on the card")
    out = {"losses": losses, "gemm_launches": launched, "grad_err": {}}
    for other in ("cpu_mesh", "card1"):
        check(np.isclose(losses["card_mesh"], losses[other], rtol=1e-5,
                         atol=0), f"dm small: first loss "
              f"{losses['card_mesh']} vs {other} {losses[other]}")
        err = max(((grads["card_mesh"][n] - g).abs().max()
                   / g.abs().max()).item()
                  for n, g in grads[other].items())
        check(err <= 1e-3, f"dm small: gradients vs {other} {err:.3e} of "
                           f"a leaf's largest entry")
        out["grad_err"][other] = err
    print(f"[dm small] float32 smoke at (data, model) {DM_MESH} on the "
          f"card: loss {losses['card_mesh']:.6f} (CPU mesh "
          f"{losses['cpu_mesh']:.6f}, card (1, 1) {losses['card1']:.6f}); "
          f"gradients within {out['grad_err']['cpu_mesh']:.3e} of the CPU "
          f"mesh's and {out['grad_err']['card1']:.3e} of (1, 1)'s; "
          f"{launched} GEMM launches, 0 plain calls", flush=True)
    return out


def dm_products(cfg, M):
    """Every GEMM product of one training step over the (data, model)
    mesh: each data group runs :func:`tp_products` on its M / D tokens at
    W = model ranks; FSDP adds no product (the gathers are copies)."""
    D, W = DM_MESH
    return [p[:-1] + (D * p[-1],) for p in tp_products(cfg, M // D, W)]


def phase_dm_full(step0_loss_13c):
    """(21b) llama3-8b at full width, TRAIN_LAYERS of 32 layers (as 12c
    and 13c), on the (data 2, model 2) mesh of virtual ranks under 13c's
    fusion mode: DM_STEPS steps of 2 x 1024 tokens of SyntheticLM(seed=0)
    (one row a data group) through ``launch.train.train``, the same
    seeded init. Checks each rank's fp32 masters at the bytes the rules
    give (``steps.param_shardings``' shapes: 1.923 GB) and with
    gradients, ``m`` and ``v`` 4 times that; the losses finite, the
    first within TP_LOSS_ATOL of 13c's first (same parameters and
    batch: bf16 sums round at other places); the GEMM launches of every
    step (``dm_products``), no plain call; then one more step under the
    profiler (busy share, GEMM ms). Returns the run's numbers."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding_rules as sr
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as tr
    from repro_torch.models.module import tree_items
    from repro_torch.optim import adamw
    cfg = get_config("llama3-8b").replace(n_layers=TRAIN_LAYERS)
    M = TRAIN_BATCH * TRAIN_SEQ
    args = _dm_args([
        "--arch", "llama3-8b", "--steps", str(DM_STEPS), "--batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--warmup",
        str(TRAIN_STEPS), "--lr", str(TRAIN_LR), "--log-every", "1"],
        "cuda:0")
    mesh = tr.build_mesh(args)
    psh = steps_lib.param_shardings(cfg, sr.rules_for(cfg, mesh))
    rule_bytes = 4 * sum(int(np.prod(v["shape"]))
                         for v in _sharding_leaves(psh))
    prods = dm_products(cfg, M)
    per_step = sum(p[-1] for p in prods)
    counts, state_bytes = [], {}

    def count(step, params, metrics):
        counts.append(matmul.launches)
        if step == 0:
            for r, p in enumerate(params):
                ps = list(p.parameters())
                state_bytes[r] = {
                    "params": sum(t.numel() * t.element_size() for t in ps),
                    "grads": sum(t.grad.numel() * t.grad.element_size()
                                 for t in ps if t.grad is not None)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    matmul.launches = matmul.plain_calls = 0
    t0 = time.time()
    res = tr.train(cfg, args, on_step=count)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches, plain = matmul.launches, matmul.plain_calls
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    opt_bytes = [sum(t.numel() * t.element_size() for k in ("m", "v")
                     for _, t in tree_items(o[k])) for o in res["opt"]]
    for r in range(mesh.size):
        b = state_bytes[r]
        check(b["params"] == rule_bytes and b["grads"] == rule_bytes
              and opt_bytes[r] == 2 * rule_bytes,
              f"dm full: rank {r} holds {b} and {opt_bytes[r]} B of m, v; "
              f"the rules give {rule_bytes} B a tree")
    losses = [m["loss"] for m in res["log"]]
    gnorms = [m["grad_norm"] for m in res["log"]]
    steps_s = [m["s"] for m in res["log"]]
    check(all(np.isfinite(losses)), f"dm full: losses {losses}")
    loss_gap = abs(losses[0] - step0_loss_13c)
    check(loss_gap <= TP_LOSS_ATOL, f"dm full: first loss {losses[0]} vs "
                                    f"13c's {step0_loss_13c}")
    deltas = np.diff([0] + counts).tolist()
    check(plain == 0 and deltas == [per_step] * DM_STEPS,
          f"dm full: GEMM launches per step {deltas} (want {per_step}), "
          f"{plain} plain calls")
    check(peak_gb < 80, f"dm full: peak {peak_gb:.1f} GB")
    step_s = float(np.mean(steps_s[1:]))
    # one more step under the profiler
    ctx = dctx.DistContext(mesh, DM_MODE)
    step_fn = steps_lib.make_train_step(cfg, adamw.AdamWConfig(lr=TRAIN_LR))
    batch = shard_batch(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                    seed=0).batch_at(DM_STEPS),
                        mesh.devices[0], mesh)
    params, opt = res["params"], res["opt"]
    del res
    torch.cuda.synchronize()
    t1 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            dctx.use(ctx):
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
    prof_wall = time.time() - t1
    kern = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kern.append((dev_us, ev.key, ev.count))
    kern.sort(reverse=True)
    dev_ms = sum(k[0] for k in kern) / 1e3
    is_gemm = [port_kernel("gemm_stream", k[1])
               or port_kernel("mm_kernel", k[1]) for k in kern]
    gemm_ms = sum(k[0] for k, g in zip(kern, is_gemm) if g) / 1e3
    gemm_calls = sum(k[2] for k, g in zip(kern, is_gemm) if g)
    del params, opt, batch, step_fn
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    busy = dev_ms / (1e3 * prof_wall)
    out = {"config": f"llama3-8b full width, {cfg.n_layers} of 32 layers, "
                     f"(data, model) {DM_MESH} virtual ranks, FSDP on "
                     f"data, fusion mode {DM_MODE}, bf16 compute, fp32 "
                     f"masters, remat full",
           "tokens_per_step": M, "steps": DM_STEPS, "losses": losses,
           "grad_norms": gnorms, "step0_loss_13c": step0_loss_13c,
           "step0_loss_gap": loss_gap, "step_s": steps_s,
           "rank_param_bytes": rule_bytes,
           "rank_state_bytes": 4 * rule_bytes,
           "ms_per_step": 1e3 * step_s, "tokens_per_s": M / step_s,
           "run_s": run_s, "peak_gb": peak_gb, "gemm_launches": launches,
           "gemm_launches_per_step": per_step,
           "device_ms_over_step_ms": dev_ms / (1e3 * step_s),
           "profiled_step": {"wall_ms": 1e3 * prof_wall,
                             "device_ms": dev_ms, "busy_share": busy,
                             "gemm_ms": gemm_ms, "gemm_calls": gemm_calls,
                             "top_kernels": [
                                 {"name": k[1][:80], "ms": k[0] / 1e3,
                                  "calls": k[2]} for k in kern[:10]]}}
    print(f"[dm full] {out['config']}: each rank's fp32 masters "
          f"{rule_bytes} B ({rule_bytes / 1e9:.3f} GB; with grads, m, v "
          f"{4 * rule_bytes / 1e9:.2f} GB), as the rules give; losses "
          f"{[round(x, 4) for x in losses]}; first loss {loss_gap:.3e} "
          f"from 13c's {step0_loss_13c:.6f}; {out['ms_per_step']:.1f} ms "
          f"per step after step 0 ({out['tokens_per_s']:.0f} tokens/s); "
          f"peak {peak_gb:.2f} GB; {per_step} GEMM launches a step; "
          f"profiled step: wall {1e3 * prof_wall:.1f} ms, device "
          f"{dev_ms:.1f} ms (busy {busy:.3f}), GEMM {gemm_ms:.1f} ms in "
          f"{gemm_calls} launches", flush=True)
    return out


def _sharding_leaves(tree):
    """The leaves of a ``steps`` sharding tree (the dicts holding
    "spec")."""
    for v in tree.values():
        if "spec" in v:
            yield v
        else:
            yield from _sharding_leaves(v)


def phase_dm_compress():
    """(21c) ``distributed.grad_compress`` on the card: ``compress_int8``
    of a gradient-sized tensor bit-equal to the CPU's (q and scale), and
    ``compressed_psum_tree`` (int8, with a carried residual) over the
    ``data`` groups of the (2, 2) mesh of virtual ranks: every rank's
    mean and residual bit-equal to the same call on the CPU mesh, the
    groups' ranks holding one mean."""
    from repro_torch.distributed import grad_compress as gc
    from repro_torch.distributed.context import DistContext, use
    from repro_torch.launch.mesh import make_host_mesh
    gen = torch.Generator().manual_seed(21)
    x = torch.randn(4096 * 1024 + 77, generator=gen)
    q_c, s_c = gc.compress_int8(x.cuda())
    q, s = gc.compress_int8(x)
    check(torch.equal(q_c.cpu(), q) and torch.equal(s_c.cpu(), s),
          "dm compress: int8 q / scale on the card differ from the CPU's")
    trees = [{"w": torch.randn(1024, 4096, generator=gen),
              "b": torch.randn(4096, generator=gen)} for _ in range(4)]
    res = {}
    for dev in ("cpu", "cuda:0"):
        mesh = make_host_mesh(*DM_MESH, device=dev)
        t = [{k: v.to(dev) for k, v in tr.items()} for tr in trees]
        with use(DistContext(mesh)):
            _, r1 = gc.compressed_psum_tree(t, "data", "int8")
            res[dev] = gc.compressed_psum_tree(t, "data", "int8",
                                               residual=r1)
    for part in range(2):
        for r in range(4):
            for k in ("w", "b"):
                got = res["cuda:0"][part][r][k].cpu()
                check(torch.equal(got, res["cpu"][part][r][k]),
                      f"dm compress: rank {r} {('mean', 'residual')[part]}"
                      f" {k} on the card differs from the CPU's")
    means = res["cuda:0"][0]
    check(torch.equal(means[0]["w"], means[2]["w"])
          and not torch.equal(means[0]["w"], means[1]["w"]),
          "dm compress: the data groups' means")
    true = (trees[0]["w"] + trees[2]["w"]) / 2
    err = (means[0]["w"].cpu() - true).abs().max().item()
    print(f"[dm compress] int8 of {x.numel()} entries bit-equal card vs "
          f"CPU; compressed_psum_tree over the data groups of "
          f"{DM_MESH}, residual carried: means and residuals bit-equal "
          f"card vs CPU, {err:.3e} from the true mean", flush=True)
    return {"int8_entries": x.numel(), "mean_err": err}


def phase_data_mesh(gen, step0_loss_13c):
    """(21) training on a data x model mesh: 21a, 21b, 21c. Returns
    (numbers, the kernels-line row of the GEMM at (2, 2))."""
    from repro_torch.configs import get_config
    small = phase_dm_small()
    full = phase_dm_full(step0_loss_13c)
    comp = phase_dm_compress()
    cfg = get_config("llama3-8b").replace(n_layers=TRAIN_LAYERS)
    prods = dm_products(cfg, TRAIN_BATCH * TRAIN_SEQ)
    times, prod_err = tp_product_times(gen, prods)

    def per_step(key):
        return sum(c * times[(m, k, n, dt, tb)][key]
                   for _, _, m, k, n, dt, tb, c in prods)
    bound_s = sum(c * _product_bound(m, k, n, dt)[0]
                  for _, _, m, k, n, dt, _, c in prods)
    ops_tot = sum(c * ops_s(2 * m * k * n, dt)
                  for _, _, m, k, n, dt, _, c in prods)
    by_tot = sum(c * bytes_s((m * k + k * n + m * n)
                             * (4 if dt == torch.float32 else 2))
                 for _, _, m, k, n, dt, _, c in prods)
    kernel = {"name": "matmul_train_dp2_tp2", "route": "cuda",
              "source": "src/repro_torch/csrc/matmul.cu",
              "replaces": "src/repro/kernels/matmul.py:34",
              "launches": full["gemm_launches"],
              "launches_per_step": full["gemm_launches_per_step"],
              "max_abs_err": prod_err,
              "ms": full["profiled_step"]["gemm_ms"],
              "kernel_ms_products": per_step("ms"),
              "plain_ms": per_step("plain_ms"),
              "bound_ms": 1e3 * bound_s,
              "bound_by": "operations" if ops_tot >= by_tot else "bytes",
              "library_ms": per_step("library_ms"),
              "unit": f"one training step of {full['config']}, "
                      f"{full['tokens_per_step']} tokens"}
    print(f"[dm full] GEMM at (data, model) {DM_MESH} a step: "
          f"{kernel['ms']:.1f} ms (profiled), "
          f"{kernel['kernel_ms_products']:.1f} ms as the sum of its "
          f"products timed alone, plain {kernel['plain_ms']:.1f}, "
          f"torch.matmul {kernel['library_ms']:.1f}, bound "
          f"{kernel['bound_ms']:.1f} ms ({kernel['bound_by']})", flush=True)
    return {"small": small, "full": full, "compress": comp}, kernel


# ------------------------------------------------ phase 14: the MoE path
MOE_ARCH = "olmoe-1b-7b"
# 14d: olmoe at full width, depth cut to MOE_TRAIN_LAYERS of 16 (fp32
# AdamW state is 16 B a parameter: 6.9 B parameters would need ~110 GB),
# batch 2 x 1024 tokens of SyntheticLM(seed=0)
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_STEPS = 4


def moe_products(cfg, M, train=False):
    """The expert products of one olmoe layer over M rows per expert, as
    batched launches: (name, kind, E, M, K, N, count a layer). Decode:
    wg and wu (d -> f) and wd (f -> d) once. Training (``train``): each
    forward twice (remat), then dA (dC @ B^T) and dB (A^T @ dC)."""
    E, d, f = cfg.moe_num_experts, cfg.d_model, cfg.d_ff
    out = []
    for name, K, N in (("wg", d, f), ("wu", d, f), ("wd", f, d)):
        if not train:
            out.append((name, "fwd", E, M, K, N, 1))
            continue
        out += [(name, "fwd", E, M, K, N, 2), (name, "dA", E, M, N, K, 1),
                (name, "dB", E, K, M, N, 1)]
    return out


def moe_train_launches_per_step(cfg):
    """GEMM launches of one olmoe training step (remat full): per layer 6
    forward launches (wq/wk/wv grouped, wo, the fp32 router, the three
    batched expert products) twice, then the backward's 14 (wq/wk/wv
    dA 3 + dB 1, wo 2, the router 2, the experts' dA and dB 6); the
    unembed's 3. Of them the batched mode's: 12 a layer."""
    return cfg.n_layers * (2 * 6 + 14) + 3, cfg.n_layers * 12


def phase_moe_gemm(gen, cfg):
    """(14a) the GEMM's batched mode (``matmul_batched``) vs its plain
    version at olmoe-1b-7b's expert products, phase 2's tolerances, one
    launch each: decode (E 64, M = batch x C = 1, 8, 16 rows, both
    projections, bf16 and f32), training (M = 2 x C = 320 rows: forward,
    dA with B^T made contiguous, dB with A^T made contiguous), a ragged
    batch and one only the general kernel takes. Times the served
    decode products (M = 8, bf16) and the training ones in CUDA-graph
    replays beside the plain version and one ``torch.bmm``. Returns
    (rows, the worst error at the main path's shapes)."""
    from repro_torch.kernels import matmul as kmm
    from repro_torch.models import moe
    rows, worst = {}, 0.0

    def case(name, a, b, prep=None, lib=None, time_it=False, count=0):
        """``a @ b`` batched; ``prep`` makes the operands from (a, b) as
        the backward does (the transposed copy is timed with it)."""
        prep = prep or (lambda x, y: (x, y))
        dt = a.dtype
        n0 = kmm.matmul_batched.launches
        got = kmm.matmul_batched(*prep(a, b))
        want = kmm.matmul_batched_plain(*prep(a, b))
        torch.cuda.synchronize()
        check(kmm.matmul_batched.launches == n0 + 1,
              f"batched GEMM {name}: {kmm.matmul_batched.launches - n0} "
              f"launches, not 1")
        E, M, K = prep(a, b)[0].shape
        N = got.shape[-1]
        err = _gemm_err(got, want, dt, f"batched GEMM {name} E={E} M={M} "
                                       f"K={K} N={N} {dt}")
        del got, want
        row = {"E": E, "M": M, "K": K, "N": N,
               "dtype": str(dt).replace("torch.", ""), "max_abs_err": err}
        if time_it:
            flops = E * 2 * M * N * K
            by = E * (M * K + K * N + M * N) * a.element_size()
            ops_ms, bytes_ms = 1e3 * ops_s(flops, dt), 1e3 * bytes_s(by)
            b_s, b_by = bound(flops, by, dt)
            lib = lib or (lambda x, y: torch.bmm(x, y))
            row.update({
                "ms": graph_ms(lambda: kmm.matmul_batched(*prep(a, b))),
                "plain_ms": graph_ms(lambda: kmm.matmul_batched_plain(
                    *prep(a, b)), iters=5),
                "library_ms": graph_ms(lambda: lib(a, b)),
                "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                "bound_ms": 1e3 * b_s, "bound_by": b_by,
                "count": count})
        rows[name] = row
        return err

    def operands(E, M, K, N, dt):
        a = torch.randn((E, M, K), generator=gen, device="cuda").to(dt)
        b = (torch.randn((E, K, N), generator=gen, device="cuda")
             / K ** 0.5).to(dt)
        return a, b
    E = cfg.moe_num_experts
    for name, _, _, _, K, N, _ in moe_products(cfg, 8):
        if name == "wu":
            continue                  # wg's shape
        for dt in (torch.bfloat16, torch.float32):
            for M in (1, 8, 16):
                a, b = operands(E, M, K, N, dt)
                main = dt == torch.bfloat16 and M == 8
                err = case(f"decode {name} M={M} {dt}", a, b, time_it=main,
                           count=2 if name == "wg" else 1)
                if main:
                    worst = max(worst, err)
                del a, b
    # training: the forward's A and B, the output gradient dC; M = the
    # rows' capacity slots, B x C
    Mt = TRAIN_BATCH * moe.capacity(cfg, TRAIN_SEQ)
    for name, K, N in (("wg", cfg.d_model, cfg.d_ff),
                       ("wd", cfg.d_ff, cfg.d_model)):
        a, b = operands(E, Mt, K, N, torch.bfloat16)
        dc = (torch.randn((E, Mt, N), generator=gen, device="cuda")
              / N ** 0.5).to(torch.bfloat16)
        count = 2 if name == "wg" else 1
        case(f"train {name} fwd", a, b, time_it=True, count=2 * count)
        case(f"train {name} dA", dc, b,
             prep=lambda x, y: (x, y.transpose(1, 2).contiguous()),
             lib=lambda x, y: torch.bmm(x, y.transpose(1, 2)),
             time_it=True, count=count)
        case(f"train {name} dB", a, dc,
             prep=lambda x, y: (x.transpose(1, 2).contiguous(), y),
             lib=lambda x, y: torch.bmm(x.transpose(1, 2), y),
             time_it=True, count=count)
        del a, b, dc
    for dt in (torch.bfloat16, torch.float32):
        a, b = operands(5, 20, 136, 1000, dt)        # ragged tiles
        case(f"ragged tma {dt}", a, b)
        a, b = operands(3, 5, 100, 77, dt)           # the general kernel
        case(f"ragged general {dt}", a, b)
    torch.cuda.empty_cache()
    print("[moe gemm] " + "; ".join(
        f"{n} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, torch.bmm "
        f"{r['library_ms']:.3f}, bound {r['bound_ms']:.3f})"
        for n, r in rows.items() if "ms" in r), flush=True)
    print(f"[moe gemm] {len(rows)} batched products (E = {E}) match the "
          f"plain version in one launch each (max |err| at the served "
          f"shapes {worst:.3e})", flush=True)
    return rows, worst


def phase_moe_small(tp=4):
    """(14b) olmoe-smoke (float32) served on the card and on the CPU,
    phase 4's engine and requests: at K = 1 greedy, token-identical
    streams and equal counters; at K = 8 (graph replays), greedy and
    seeded temperature, streams identical to the CPU's K = 1 and
    counters to its K = 8; the same serves over ``tp`` virtual ranks
    under ``pallas`` identical to tp 1; the GEMM's plain version never
    ran on the card; then one K = 8 megatick replayed under
    ``torch.cuda.set_sync_debug_mode("error")`` (the routing waits for
    nothing)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.distributed import context as dctx
    from repro_torch.kernels.matmul import matmul, matmul_batched
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    cfg = smoke_config(get_config(MOE_ARCH)).replace(dtype=torch.float32)
    p_cpu = lm.init_params(cfg, seed=0, device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    reqs = _smoke_requests(np.random.default_rng(0), cfg.vocab_size)

    def card(*args):
        """A serve on the card, through the kernels only."""
        q0, b0 = matmul.plain_calls, matmul_batched.launches
        out = _serve_small(p_gpu, cfg, reqs, "cuda", *args)
        check(matmul.plain_calls == q0 and matmul_batched.launches > b0,
              f"moe small {args}: plain calls or no batched launch")
        return out
    runs = {"cuda": card(), "cpu": _serve_small(p_cpu, cfg, reqs, "cpu")}
    check(len(runs["cuda"][0]) == len(reqs), "moe small: not all finished")
    check(runs["cuda"][0] == runs["cpu"][0],
          f"moe small streams differ: card {runs['cuda'][0]}, cpu "
          f"{runs['cpu'][0]}")
    check(runs["cuda"][1] == runs["cpu"][1],
          f"moe small counters differ: {runs['cuda'][1]} vs "
          f"{runs['cpu'][1]}")
    check(runs["cuda"][1][3] >= 1 and runs["cuda"][1][4] >= 1,
          f"moe small: no preemption or no prefix hit: {runs['cuda'][1]}")
    mega = {}
    for sampler in ("greedy", "temperature"):
        base = _serve_small(p_cpu, cfg, reqs, "cpu", sampler=sampler)
        cpu8 = _serve_small(p_cpu, cfg, reqs, "cpu", 8, sampler)
        gpu8 = card(8, sampler)
        what = f"moe small K=8 {sampler}"
        check(cpu8[0] == base[0] and gpu8[0] == base[0],
              f"{what}: streams differ from the CPU at K=1")
        check(gpu8[1] == cpu8[1], f"{what}: counters {gpu8[1]} != the "
                                  f"CPU's {cpu8[1]}")
        m = gpu8[2]
        check(m["graphs"] and m["graph_replays"] == m["dispatches"],
              f"{what}: not one graph replay per megatick: {m}")
        mega[sampler] = gpu8
    ctx = dctx.DistContext(make_mesh(tp, device="cuda"), "pallas")
    got = card(1, "greedy", ctx)
    check(got[0] == runs["cuda"][0] and got[1] == runs["cuda"][1],
          f"moe small tp={tp}: K=1 differs from tp=1")
    for sampler, ref in mega.items():
        got = card(8, sampler, ctx)
        check(got[0] == ref[0] and got[1] == ref[1],
              f"moe small tp={tp} K=8 {sampler}: differs from tp=1")
    # the routing inside a captured megatick: replayed once more (the
    # served engine is done; the replay only advances its state) with
    # every host sync an error
    kept = []
    _serve_small(p_gpu, cfg, reqs, "cuda", 8, "greedy", keep=kept)
    eng, = kept
    graphs = list(eng._runner.graphs.values())
    check(graphs, "moe small: no graph captured")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graphs[0][0].replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    del eng, kept, graphs
    print(f"[moe small] olmoe-smoke float32: streams token-identical on "
          f"cuda and cpu, counters {runs['cuda'][1]}; K=8 (graph replays) "
          f"greedy {mega['greedy'][1]} and temperature "
          f"{mega['temperature'][1]}: streams as the CPU's K=1, counters "
          f"as its K=8; tp={tp} pallas identical to tp=1; no plain "
          f"GEMM call on the card; a K=8 replay under sync-debug 'error' "
          f"ran", flush=True)
    return {"counters": runs["cuda"][1],
            "k8": {s: v[1] for s, v in mega.items()}}


def _products_row(rows, names, L=1):
    """A kernel line's times and bound for ``L`` layers of the timed
    ``rows`` (14a's, 15a's) named by ``names``, each times its
    ``count`` (a layer, or a step with L = 1): the bound sums each
    product's larger of its operations and bytes times, and is said to
    be bound by whichever sum is larger."""
    def per_step(field):
        return L * sum(rows[n]["count"] * rows[n][field] for n in names)
    return {"ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
            "bound_ms": per_step("bound_ms"),
            "bound_by": ("operations" if per_step("ops_ms")
                         >= per_step("bytes_ms") else "bytes"),
            "library_ms": per_step("library_ms")}


def phase_moe_full(rows, worst):
    """(14c) olmoe-1b-7b at full width (16 layers, d 2048, 64 experts
    top-8, bf16, seeded random weights, nothing cut) served through the
    engine with phase 5's traffic at K = 1 and at K = 8 (graph replays;
    then prompts of the same lengths again for the steady time), every
    kernel's launches counted around each serve (6 GEMM launches a
    layer, 3 of them batched, + the unembed; one paged decode a layer);
    a teacher-forced chunk's logits finite; one K = 8 serve on two
    engines in lockstep, graph replays against the eager loop (phase
    5b's check); a profiled eager step. The batched GEMM's ms per step
    from 14a's graph-timed decode products."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(MOE_ARCH)
    t0 = time.time()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_gb = sum(p.numel() * p.element_size()
                    for p in params.parameters()) / 1e9
    plens = [int(n) for n in np.random.default_rng(0).integers(32, 129, 8)]
    reqs_a = _full_requests(cfg, plens, 1, 32, 2)
    reqs_b = _full_requests(cfg, plens, 2, 32, 2)
    kw = dict(batch=8, max_len=512, label="olmoe")
    L = cfg.n_layers
    per_step = {"matmul": 6 * L + 1, "matmul_batched": 3 * L,
                "flash_decode_paged": L}
    cells = {}
    cells["k1"], done1 = serve_cell(params, cfg, 1, reqs_a, **kw)
    _check_serve(cells["k1"], done1, cfg, 8, 32, per_step, "olmoe K=1")
    cells["k8"], done8 = serve_cell(params, cfg, 8, reqs_a, reqs_b, **kw)
    _check_serve(cells["k8"], done8, cfg, 8, 32, per_step, "olmoe K=8")
    s1 = {r.rid: r.out_tokens for r in done1}
    s8 = {r.rid: r.out_tokens for r in done8}
    same = sum(s1[r] == s8[r] for r in s1)
    cells["k8"]["streams_identical_to_k1"] = same
    lockstep = phase_graph_vs_eager(params, cfg)
    with torch.inference_mode():
        st = lm.init_paged_decode_state(params, cfg, 8, 64, 16, 8)
        st["block_tables"].copy_(torch.arange(64, dtype=torch.int32)
                                 .reshape(8, 8))
        tok = torch.randint(1, cfg.vocab_size, (8, 8), device="cuda")
        lg, _ = lm.decode_chunk(params, tok, torch.full(
            (8,), 8, device="cuda"), st, cfg)
        check(bool(torch.isfinite(lg).all()), "olmoe: non-finite logits")
        profile = profile_steps(params, cfg, st, label="olmoe decode step")
    del st, lg
    sharded = sharded_steps(params, cfg, MOE_ARCH)
    del params
    torch.cuda.empty_cache()
    names = ("decode wg M=8 torch.bfloat16", "decode wd M=8 torch.bfloat16")
    kernel = {"name": "matmul_batched", "route": "cuda",
              "source": "src/repro_torch/csrc/matmul.cu",
              "replaces": "src/repro/kernels/matmul.py:34",
              "launches": cells["k8"]["launches"]["matmul_batched"],
              "launches_per_step": per_step["matmul_batched"],
              "max_abs_err": worst, **_products_row(rows, names, L),
              "unit": f"one olmoe-1b-7b decode step at batch 8 "
                      f"({per_step['matmul_batched']} launches: wg, wu, "
                      f"wd of 64 experts x 8 rows per layer), CUDA-graph "
                      f"replays"}
    out = {"config": "olmoe-1b-7b full width, 16 layers, bf16, nothing "
                     "cut", "params": n_params, "weight_gb": weight_gb,
           "init_s": init_s, "prompt_tokens": sum(plens), **cells,
           "launches_per_step": per_step, "graph_vs_eager_megaticks":
           lockstep, "profile": profile, "sharded": sharded}
    print(f"[moe full] {n_params / 1e9:.3f} B parameters, {weight_gb:.2f} "
          f"GB of weights; K=1 {cells['k1']['tokens_per_s']:.2f} tok/s; "
          f"K=8 steady {cells['k8']['steady_tokens_per_s']:.2f} tok/s, "
          f"{cells['k8']['steady_ms_per_token']:.2f} ms/token, busy "
          f"{cells['k8']['steady_busy_share']:.3f}, peak "
          f"{cells['k8']['peak_mem_bytes'] / 1e9:.2f} GB; launches a step "
          f"{per_step}; K=8 streams identical to K=1 for {same} of 8 "
          f"(reported); batched GEMM {kernel['ms']:.3f} ms a step (bound "
          f"{kernel['bound_ms']:.3f}, plain {kernel['plain_ms']:.3f}, "
          f"torch.bmm {kernel['library_ms']:.3f})", flush=True)
    return out, kernel


def phase_moe_train_small():
    """(14d, first part) olmoe-smoke (float32) trained 3 steps on the card
    and on the CPU from the same parameters on the same batches (lr
    1e-4), phase 12b's tolerances where the model allows them: the first
    loss (ce + 0.01 aux) within 1e-5 relative, its aux within 1e-5,
    losses within 1e-4 and grad norms within 1e-2 relative; every
    first-step gradient leaf (the router's included) nonzero on the card
    and within max(1e-3, 2 x the CPU's own sensitivity) of the leaf's
    largest |entry|. The sensitivity is measured here: the largest
    first-step gradient gap on the CPU when every weight is scaled by
    1 + one float32 ulp of seeded noise (what another summation order
    does to a sum), over 3 draws; the smoke init's layer weights of std
    0.5 make olmoe-smoke's ~2e-3, above 12b's 1e-3. Every routing
    (experts chosen) is compared card vs CPU and the smallest top-k gap
    reported. On the card the batched GEMM launched and no plain
    version ran."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.matmul import matmul, matmul_batched
    from repro_torch.launch import train as tr
    from repro_torch.models import lm
    from repro_torch.models import moe
    cfg = smoke_config(get_config(MOE_ARCH)).replace(dtype=torch.float32)
    argv = ["--arch", MOE_ARCH, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "32", "--log-every", "1", "--lr", "1e-4", "--warmup",
            "3"]
    init = lm.init_params(cfg, seed=0, device="cpu", trainable=True)
    p_card = _cpu_copy(init, cfg, "cuda")
    grads0 = {}
    # every routing of the runs: the experts chosen and the smallest gap
    # between the K-th and (K+1)-th router probability (a gap below the
    # two devices' rounding would let them choose differently)
    routes = {"cpu": [], "cuda": []}
    route = moe.route

    def spy(x, router_w, cfg_):
        r = route(x, router_w, cfg_)
        probs = torch.softmax(x.detach().float() @ router_w.detach().float(),
                              dim=-1)
        top = probs.sort(dim=-1, descending=True).values
        K = cfg_.moe_top_k
        routes[x.device.type].append(
            (r["expert_of_flat"].cpu(),
             float((top[..., K - 1] - top[..., K]).min())))
        return r

    def first_grads(step, params, metrics):
        if step == 0:
            grads0[params.device.type] = {
                n: p.grad.detach().cpu().clone()
                for n, p in params.named_parameters() if p.grad is not None}
    moe.route = spy
    try:
        cpu = tr.train(cfg, tr.parse_args(argv + ["--device", "cpu"]),
                       params=init, on_step=first_grads)
        n0, p0, b0 = (matmul.launches, matmul.plain_calls,
                      matmul_batched.launches)
        card = tr.train(cfg, tr.parse_args(argv + ["--device", "cuda"]),
                        params=p_card, on_step=first_grads)
    finally:
        moe.route = route
    same_routes = [bool(torch.equal(a[0], b[0]))
                   for a, b in zip(routes["cpu"], routes["cuda"])]
    min_gap = min(g for _, g in routes["cpu"])
    launched, plain = matmul.launches - n0, matmul.plain_calls - p0
    batched = matmul_batched.launches - b0
    check(launched > 0 and batched > 0 and plain == 0,
          f"moe train small: {launched} GEMM launches ({batched} batched), "
          f"{plain} plain calls on the card")
    names = [n for n, _ in card["params"].named_parameters()]
    g_card, g_cpu = grads0["cuda"], grads0["cpu"]
    missing = [n for n in names if n not in g_card
               or not bool(g_card[n].abs().max() > 0)]
    check(not missing, f"moe train small: leaves without a gradient: "
                       f"{missing}")
    def gaps(g):
        return {n: ((g[n] - g_cpu[n]).abs().max()
                    / g_cpu[n].abs().max()).item() for n in names}
    leaf_err = gaps(g_card)
    g_err = max(leaf_err.values())
    # the CPU's own first-step gradient under one float32 ulp of noise on
    # every weight (step 0's batch)
    batch0 = {k: torch.from_numpy(np.array(v)) for k, v in SyntheticLM(
        cfg.vocab_size, 32, 2, seed=0).batch_at(0).items()}
    sens = []
    for seed in range(3):
        noisy = _ulp_noise(init, cfg, seed)
        loss, _ = lm.loss_fn(noisy, batch0, cfg)
        loss.backward()
        sens.append(max(gaps({n: t.grad for n, t in
                              noisy.named_parameters()}).values()))
    tol = max(1e-3, 2 * max(sens))
    print(f"[moe train small] routings card = CPU: {sum(same_routes)} of "
          f"{len(same_routes)} (first differing: "
          f"{same_routes.index(False) if False in same_routes else None}); "
          f"smallest top-k gap {min_gap:.3e}; the CPU's own step-1 "
          f"gradient gap under one ulp of weight noise "
          f"{[f'{x:.2e}' for x in sens]} -> bound {tol:.2e}; card vs CPU "
          f"by leaf: " + ", ".join(f"{n} {e:.2e}" for n, e in sorted(
              leaf_err.items(), key=lambda kv: -kv[1])), flush=True)
    check(g_err <= tol, f"moe train small: step-1 gradients card vs CPU "
                        f"{g_err:.3e} of a leaf's largest entry (bound "
                        f"{tol:.3e})")
    lc = [m["loss"] for m in cpu["log"]]
    lg = [m["loss"] for m in card["log"]]
    ac = [m["aux"] for m in cpu["log"]]
    ag = [m["aux"] for m in card["log"]]
    gc_ = [m["grad_norm"] for m in cpu["log"]]
    gg = [m["grad_norm"] for m in card["log"]]
    check(abs(lg[0] - lc[0]) <= 1e-5 * abs(lc[0])
          and abs(ag[0] - ac[0]) <= 1e-5 * abs(ac[0]),
          f"moe train small: first loss {lg[0]} (aux {ag[0]}) vs CPU "
          f"{lc[0]} ({ac[0]})")
    check(np.allclose(lg, lc, rtol=1e-4, atol=0), f"moe train small: card "
          f"losses {lg} vs CPU {lc}")
    check(np.allclose(gg, gc_, rtol=1e-2, atol=0), f"moe train small: "
          f"card grad norms {gg} vs CPU {gc_}")
    out = {"step1_grad_err": g_err, "step1_grad_err_by_leaf": leaf_err,
           "cpu_noise_grad_err": sens, "grad_bound": tol,
           "routings_identical": sum(same_routes),
           "routings": len(same_routes), "min_topk_gap": min_gap,
           "cpu_losses": lc, "card_losses": lg,
           "cpu_aux": ac, "card_aux": ag, "cpu_grad_norms": gc_,
           "card_grad_norms": gg, "gemm_launches": launched,
           "batched_launches": batched}
    print(f"[moe train small] float32 olmoe-smoke, 3 steps: step-1 "
          f"gradients card vs CPU within {g_err:.3e} of a leaf's largest "
          f"entry (router included; bound {tol:.2e}); losses {lg} vs CPU {lc}; aux {ag} vs "
          f"{ac}; grad norms {gg} vs {gc_}; {launched} GEMM launches "
          f"({batched} batched), 0 plain calls", flush=True)
    return out


def moe_train_products(cfg, M):
    """Every GEMM product of one olmoe training step over M tokens (B =
    TRAIN_BATCH rows): (name, kind, E, M, K, N, dtype, count a step); the
    expert products over their dense capacity slots (B x C rows an
    expert), as the program runs them."""
    from repro_torch.models import moe
    d, V, L, E = cfg.d_model, cfg.vocab_size, cfg.n_layers, \
        cfg.moe_num_experts
    qd, kvd = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    bf, f32 = torch.bfloat16, torch.float32
    out = []
    for name, K, N, dt in (("wq", d, qd, bf), ("wk", d, kvd, bf),
                           ("wv", d, kvd, bf), ("wo", qd, d, bf),
                           ("router", d, E, f32)):
        out += [(name, "fwd", 1, M, K, N, dt, 2 * L),
                (name, "dA", 1, M, N, K, dt, L),
                (name, "dB", 1, K, M, N, dt, L)]
    Me = TRAIN_BATCH * moe.capacity(cfg, M // TRAIN_BATCH)
    out += [(n, k, E, m, kk, nn, bf, c * L) for n, k, _, m, kk, nn, c in
            moe_products(cfg, Me, train=True)]
    return out + [("unembed", "fwd", 1, M, d, V, f32, 1),
                  ("unembed", "dA", 1, M, V, d, f32, 1),
                  ("unembed", "dB", 1, V, M, d, f32, 1)]


def phase_moe_train_full(rows, worst):
    """(14d, second part) olmoe-1b-7b at full width with MOE_TRAIN_LAYERS
    of its 16 layers, bf16 compute, fp32 masters, AdamW, remat full:
    MOE_TRAIN_STEPS steps of 2 x 1024 tokens through
    ``launch.train.train``. Checks the losses finite, the GEMM launches
    of every step (and the batched mode's), no plain call, peak memory
    below 80 GB. Executed FLOPs count every GEMM product as the program
    runs it (the experts over their dense capacity slots, B x E x C
    rows) and the dense attention's QK^T and PV with their gradients.
    The batched GEMM's ms a step from 14a's graph-timed training
    products."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.matmul import matmul, matmul_batched
    from repro_torch.launch import train as tr
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS)
    M = TRAIN_BATCH * TRAIN_SEQ
    args = tr.parse_args([
        "--arch", MOE_ARCH, "--steps", str(MOE_TRAIN_STEPS), "--batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--warmup",
        str(MOE_TRAIN_STEPS), "--lr", str(TRAIN_LR), "--log-every", "1",
        "--device", "cuda"])
    per_step, per_step_b = moe_train_launches_per_step(cfg)
    counts = []

    def count(step, params, metrics):
        counts.append((matmul.launches, matmul_batched.launches))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    matmul.launches = matmul.plain_calls = 0
    matmul_batched.launches = matmul_batched.plain_calls = 0
    t0 = time.time()
    res = tr.train(cfg, args, on_step=count)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches, plain = matmul.launches, matmul.plain_calls
    batched = matmul_batched.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for m in res["log"]]
    aux = [m["aux"] for m in res["log"]]
    steps_s = [m["s"] for m in res["log"]]
    n_params = sum(p.numel() for p in res["params"].parameters())
    del res
    check(all(np.isfinite(losses)) and all(np.isfinite(aux)),
          f"moe train full: losses {losses}, aux {aux}")
    deltas = np.diff([(0, 0)] + counts, axis=0).tolist()
    check(plain == 0 and deltas == [[per_step, per_step_b]]
          * MOE_TRAIN_STEPS, f"moe train full: GEMM launches (all, "
          f"batched) per step {deltas} (want {per_step}, {per_step_b}), "
          f"{plain} plain calls")
    check(peak_gb < 80, f"moe train full: peak {peak_gb:.1f} GB")
    step_s = float(np.mean(steps_s[1:]))
    prods = moe_train_products(cfg, M)
    gemm_flops = sum(2 * e * m * k * n * c
                     for _, _, e, m, k, n, _, c in prods)
    H, S, hd = cfg.n_heads, TRAIN_SEQ, cfg.hd
    attn_flops = cfg.n_layers * (2 + 2) * 2 * (2 * TRAIN_BATCH * H * S * S
                                              * hd)
    flops = gemm_flops + attn_flops
    L = cfg.n_layers
    names = [f"train {n} {k}" for n in ("wg", "wd")
             for k in ("fwd", "dA", "dB")]
    kernel = {"name": "matmul_batched_train", "route": "cuda",
              "source": "src/repro_torch/csrc/matmul.cu",
              "replaces": "src/repro/kernels/matmul.py:34",
              "launches": batched, "launches_per_step": per_step_b,
              "max_abs_err": max(rows[n]["max_abs_err"] for n in names),
              **_products_row(rows, names, L),
              "unit": f"one olmoe-1b-7b training step ({L} layers, "
                      f"{M} tokens): the expert products forward twice "
                      f"(remat) and both gradients, {per_step_b} "
                      f"launches, from 14a's graph-timed products"}
    out = {"config": f"olmoe-1b-7b full width, {L} of 16 layers, bf16 "
                     f"compute, fp32 masters, remat full",
           "params": n_params, "tokens_per_step": M,
           "steps": MOE_TRAIN_STEPS, "lr": TRAIN_LR, "losses": losses,
           "aux": aux, "step_s": steps_s, "ms_per_step": 1e3 * step_s,
           "tokens_per_s": M / step_s, "run_s": run_s,
           "flops_per_step": flops, "gemm_flops_per_step": gemm_flops,
           "tflops_per_s": flops / step_s / 1e12,
           "peak_share": ops_s(flops, torch.bfloat16) / step_s,
           "peak_gb": peak_gb, "gemm_launches": launches,
           "gemm_launches_per_step": per_step,
           "batched_launches_per_step": per_step_b}
    print(f"[moe train full] {out['config']}: {n_params / 1e9:.3f} B "
          f"parameters; losses {[round(x, 4) for x in losses]}, aux "
          f"{[round(x, 4) for x in aux]}; {out['ms_per_step']:.1f} ms per "
          f"step after step 0 ({out['tokens_per_s']:.0f} tokens/s), "
          f"{out['tflops_per_s']:.1f} TFLOP/s executed "
          f"({100 * out['peak_share']:.1f}% of 989 TF); peak "
          f"{peak_gb:.2f} GB; {per_step} GEMM launches a step "
          f"({per_step_b} batched); batched GEMM {kernel['ms']:.1f} ms a "
          f"step (plain {kernel['plain_ms']:.1f}, torch.bmm "
          f"{kernel['library_ms']:.1f}, bound {kernel['bound_ms']:.1f})",
          flush=True)
    return out, kernel


def phase_moe(gen):
    """(14) the MoE path: 14a-14d, each sub-phase's seconds kept; frees
    what it made."""
    import gc
    from repro_torch.configs import get_config
    secs = {}

    def sub(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        secs[name] = time.time() - t0
        return out
    rows, worst = sub("14a", phase_moe_gemm, gen, get_config(MOE_ARCH))
    small = sub("14b", phase_moe_small)
    full, kernel = sub("14c", phase_moe_full, rows, worst)
    train_small = sub("14d small", phase_moe_train_small)
    train_full, kernel_t = sub("14d full", phase_moe_train_full, rows,
                               worst)
    gc.collect()
    torch.cuda.empty_cache()
    print("[moe] sub-phases: " + ", ".join(f"{k} {v:.1f} s"
                                           for k, v in secs.items()),
          flush=True)
    return {"gemm": rows, "small": small, "full": full,
            "train_small": train_small, "train_full": train_full,
            "phase_s": secs}, [kernel, kernel_t]


# ------------------------------------------- (15) the recurrent families
REC_ARCHS = ("zamba2-1.2b", "rwkv6-3b")
REC_TRAIN_STEPS = 3
HIDING_ZEROS = ("dt_bias", "conv_b", "w_lora_b")   # zero inits


def _unhide(params, seed=1):
    """Seeded nonzero values in the zero-init leaves that would hide a
    path (Mamba2's dt_bias and conv_b, RWKV6's w_lora_b), in place."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if name.rsplit(".", 1)[-1] in HIDING_ZEROS:
                p.copy_(0.3 * torch.randn(p.shape, generator=g))


def rec_gemm_rows(cfg):
    """The GEMM launches of one decode step of a recurrent model: (name,
    K, the N of each product of the launch, dtype, trans_b, launches a
    step, whether the shape is new: checked at M 1, 8 and 2048). zamba2:
    in_proj and out_proj a Mamba2 layer, the shared block's wq/wk/wv,
    wo, wg/wu, wd a group; rwkv: wr, wk, wv, wg, wo (one shape), the fp32
    LoRA of the decay, ck and cv a block; the fp32 unembed."""
    from repro_torch.models import mamba2, rwkv6
    d, L = cfg.d_model, cfg.n_layers
    bf, f32 = torch.bfloat16, torch.float32
    unembed = ("unembed", d, [cfg.vocab_size], f32, True, 1, False)
    if cfg.block == "rwkv":
        r = rwkv6.LORA
        return [("wr/wk/wv/wg/wo", d, [d], bf, False, 5 * L, False),
                ("w_lora_a", d, [r], f32, False, L, True),
                ("w_lora_b", r, [d], f32, False, L, True),
                ("ck", d, [cfg.d_ff], bf, False, L, True),
                ("cv", cfg.d_ff, [d], bf, False, L, True), unembed]
    d_in, n, nh = mamba2.dims(cfg)
    G = L // cfg.attn_every
    qd, kvd = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    return [("in_proj", d, [2 * d_in + 2 * n + nh], bf, False, L, True),
            ("out_proj", d_in, [d], bf, False, L, False),
            ("wqkv", d, [qd, kvd, kvd], bf, False, G, False),
            ("wo", qd, [d], bf, False, G, False),
            ("wgu", d, [cfg.d_ff, cfg.d_ff], bf, False, G, False),
            ("wd", cfg.d_ff, [d], bf, False, G, False), unembed]


def phase_rec_gemm(gen, cfg, B=8, gemm_rows=None):
    """(15a) the GEMM vs its plain version at a recurrent model's decode
    products (phase 2's tolerances, one launch each, a group bit-equal
    to single calls), the new shapes (zamba2's in_proj N 8384, rwkv's
    fp32 LoRA with K or N 64, its relu² channel mix d_ff 8960) at M 1, 8
    and 2048, the rest at the served M = 8; then each launch timed at
    M = 8 in CUDA-graph replays, the weights cycled through copies that
    overflow the L2 as the layers' distinct weights do, beside the plain
    version and ``torch.matmul``. Returns (rows, the worst error)."""
    from repro_torch.kernels.matmul import (matmul, matmul_group,
                                            matmul_plain)
    rows, worst = {}, 0.0

    def call(a, ws, tb):
        return [matmul(a, ws[0], trans_b=True)] if tb else \
            matmul_group(a, ws) if len(ws) > 1 else [matmul(a, ws[0])]

    for name, K, Ns, dt, tb, count, new in (gemm_rows
                                            or rec_gemm_rows(cfg)):
        for M in ((1, 2048, B) if new else (B,)):     # timed at M = B
            a = torch.randn((M, K), generator=gen, device="cuda").to(dt)
            ws = [(torch.randn((N, K) if tb else (K, N), generator=gen,
                               device="cuda") / K ** 0.5).to(dt) for N in Ns]
            n0 = matmul.launches
            got = call(a, ws, tb)
            torch.cuda.synchronize()
            check(matmul.launches == n0 + 1, f"{cfg.name} GEMM {name} M={M}: "
                  f"{matmul.launches - n0} launches, not 1")
            for w, g in zip(ws, got):
                err = _gemm_err(g, matmul_plain(a, w, tb), dt,
                                f"{cfg.name} GEMM {name} M={M} K={K}")
                worst = max(worst, err)
                if len(ws) > 1:
                    check(torch.equal(g, matmul(a, w)), f"{cfg.name} "
                          f"{name}: the group differs from a single call")
            del got
        _, t_k, t_l, t_p = cycled_ms(
            ws, lambda w: call(a, w, tb),
            lambda w: [torch.matmul(a, x.T if tb else x) for x in w],
            lambda w: [matmul_plain(a, x, tb) for x in w])
        by = nbytes(a, *ws) + sum(B * N for N in Ns) * a.element_size()
        flops = sum(2 * B * w.numel() for w in ws)
        ops_ms, bytes_ms = 1e3 * ops_s(flops, dt), 1e3 * bytes_s(by)
        rows[name] = {
            "K": K, "N": Ns, "M": B, "dtype": str(dt).replace("torch.", ""),
            "trans_b": tb, "count": count, "ms": t_k, "plain_ms": t_p,
            "library_ms": t_l, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": 1e3 * bound(flops, by, dt)[0]}
        del a, ws
    print(f"[rec gemm] {cfg.name}: " + "; ".join(
        f"{n} {r['ms']:.4f} ms x{r['count']} (plain "
        f"{r['plain_ms']:.3f}, torch.matmul {r['library_ms']:.4f}, bound "
        f"{r['bound_ms']:.4f})" for n, r in rows.items())
        + f"; max |err| {worst:.3e}", flush=True)
    return rows, worst


def phase_rec_decode(gen, W=4):
    """(15a) the paged decode at zamba2's heads (hd 64, 32 query and 32
    KV heads: q_per_kv 1) vs its plain version: at W = 1 (full table,
    holes, a window, a gather slice) and the fused mode over ``W``
    virtual ranks of cuda:0, outputs bit-identical across ranks."""
    from repro_torch.distributed.context import Mesh
    from repro_torch.kernels import flash_decode as kfd
    H = KVH = 32
    D, bs, C = 64, 16, 32
    scale = D ** -0.5
    worst, n = 0.0, 0
    for dt in (torch.float32, torch.bfloat16):
        q, kp, vp, full = _decode_inputs(gen, dt, H=H, KVH=KVH, D=D, bs=bs,
                                         C=C)
        cur = torch.tensor([1, bs, bs + 1, C * bs, 37, 200, 511, 130],
                           dtype=torch.int32, device="cuda")
        holes = full.clone()
        holes[4, 0] = -1
        for name, tables, window in (("full", full[:, :C], None),
                                     ("holes", holes[:, :C], None),
                                     ("window32", holes[:, :C], 32),
                                     ("gather_slice", full[:, :C // 2],
                                      None)):
            cl = cur.clamp(max=tables.shape[1] * bs)
            got = kfd.flash_decode_paged(q, kp, vp, cl, tables, scale,
                                         window=window)
            want = kfd.paged_decode_plain(q, kp, vp, cl, tables, scale,
                                          window=window)
            torch.cuda.synchronize()
            worst = max(worst, _close(got, want, dt, f"hd64 paged {name} "
                                                     f"{dt}"))
            n += 1
        mesh = Mesh(["cuda:0"] * W)
        q, kps, vps, cur, tb = _paged_ranks_inputs(gen, dt, W, H=H, KVH=KVH,
                                                   D=D)
        n_loc = kps[0].shape[0]
        got = kfd.flash_decode_paged_fused([q] * W, kps, vps, [cur] * W,
                                           [tb] * W, scale, mesh=mesh)
        want = kfd.fused_plain([kfd.paged_partial_plain(
            q, kps[r], vps[r], cur, tb, scale, None, base=r * n_loc)
            for r in range(W)], dt)[0]
        torch.cuda.synchronize()
        for r in range(W):
            check(torch.equal(got[r], got[0]), f"hd64 fused {dt}: rank {r} "
                                               f"differs from rank 0")
        worst = max(worst, _close(got[0], want, dt, f"hd64 fused W={W} "
                                                    f"{dt}"))
        n += 1
    print(f"[rec decode] paged decode at hd 64, q_per_kv 1: {n} cases (W = "
          f"1 and the fused mode over {W} virtual ranks) match the plain "
          f"version (max |err| {worst:.3e})", flush=True)
    return worst


def _rec_smoke(arch):
    """(cfg, CPU params, card params) of ``arch``'s float32 smoke model,
    its hiding zeros seeded nonzero."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm
    cfg = smoke_config(get_config(arch)).replace(dtype=torch.float32)
    p_cpu = lm.init_params(cfg, seed=0, device="cpu")
    _unhide(p_cpu)
    return cfg, p_cpu, copy.deepcopy(p_cpu).to("cuda")


def _rec_teacher_forced(cfg, p_cpu, p_gpu, paged, T=12):
    """T teacher-forced decode steps on the card and on the CPU from the
    same tokens, some slots inactive at some steps: logits within 1e-4
    + one bf16 ulp, every recurrent leaf within 1e-4 of its largest
    |entry| (the smoke init's state reaches ~1e3), inactive slots'
    recurrent leaves unchanged. Returns the largest logit gap."""
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.models import lm
    B, bs, nb, mb = 4, 8, 16, 4
    states = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        if paged:
            st = lm.init_paged_decode_state(params, cfg, B, nb, bs, mb)
            st["block_tables"].copy_(torch.arange(nb, dtype=torch.int32)
                                     .reshape(B, mb))
        else:
            st = lm.init_decode_state(params, cfg, B, 32)
        states[dev] = (params, st)
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (B, T))
    worst = 0.0
    with torch.inference_mode():
        for j in range(T):
            act = np.array([True, j % 3 != 1, j != 4, True])
            out = {}
            for dev, (params, st) in states.items():
                lg, _ = lm.decode_step(
                    params, torch.from_numpy(toks[:, j:j + 1]).to(dev), st,
                    cfg, active=torch.from_numpy(act).to(dev))
                out[dev] = lg.float().cpu()
            diff = (out["cuda"] - out["cpu"]).abs()
            check(bool((diff <= 1e-4 + 2 ** -7 * out["cpu"].abs()).all()),
                  f"{cfg.name} teacher-forced logits (paged {paged}) differ "
                  f"at step {j}: {diff.max().item():.3e}")
            worst = max(worst, diff.max().item())
            ref = flatten(states["cpu"][1]["caches"])
            for key, leaf in flatten(states["cuda"][1]["caches"]).items():
                want, got = ref[key].float(), leaf.float().cpu()
                err = (got - want).abs().max().item()
                check(err <= 1e-4 * max(want.abs().max().item(), 1e-30),
                      f"{cfg.name} step {j}: state {key} {err:.3e} apart")
    return worst


def phase_rec_small(arch, tp=4):
    """(15b) a recurrent family's float32 smoke model served on the card
    and on the CPU, phase 4's engine and requests: at K = 1 greedy,
    streams token-identical and counters equal; at K = 8 (graph
    replays), greedy and seeded temperature, streams as the CPU's K = 1
    and counters as its K = 8; the same over ``tp`` virtual ranks under
    ``pallas`` identical to tp 1 (the hybrid's shared attention through
    the fused paged decode and the AG+GEMM); no plain GEMM call on the
    card; teacher-forced decode steps card vs CPU over the paged state
    (and the contiguous one for the hybrid: the strided decode kernel);
    phase 11a's fault plan with a drain, snapshot and restore in mid
    serve, on the card and on the CPU: streams and counters equal, and
    equal to the uninterrupted run's; the resumed requests re-prefill
    (no prefix hit)."""
    from repro_torch.distributed import context as dctx
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.graphs import launch_counted
    cfg, p_cpu, p_gpu = _rec_smoke(arch)
    reqs = _smoke_requests(np.random.default_rng(0), cfg.vocab_size)
    fns = launch_counted()

    def card(*args):
        _counted(fns)
        out = _serve_small(p_gpu, cfg, reqs, "cuda", *args)
        check(matmul.plain_calls == 0 and matmul.launches > 0,
              f"{cfg.name} small {args}: plain calls or no GEMM launch")
        return out + ({f.__name__: f.launches for f in fns if f.launches},)
    runs = {"cuda": card(), "cpu": _serve_small(p_cpu, cfg, reqs, "cpu")}
    what = f"{cfg.name} small"
    check(len(runs["cuda"][0]) == len(reqs), f"{what}: not all finished")
    check(runs["cuda"][0] == runs["cpu"][0], f"{what}: streams differ: card "
          f"{runs['cuda'][0]}, cpu {runs['cpu'][0]}")
    check(runs["cuda"][1] == runs["cpu"][1], f"{what}: counters differ: "
          f"{runs['cuda'][1]} vs {runs['cpu'][1]}")
    check(runs["cuda"][1][4] == 0, f"{what}: a prefix hit")
    mega = {}
    for sampler in ("greedy", "temperature"):
        base = _serve_small(p_cpu, cfg, reqs, "cpu", sampler=sampler)
        cpu8 = _serve_small(p_cpu, cfg, reqs, "cpu", 8, sampler)
        gpu8 = card(8, sampler)
        w = f"{what} K=8 {sampler}"
        check(cpu8[0] == base[0] and gpu8[0] == base[0],
              f"{w}: streams differ from the CPU at K=1")
        check(gpu8[1] == cpu8[1], f"{w}: counters {gpu8[1]} != the CPU's "
                                  f"{cpu8[1]}")
        check(gpu8[1][2] >= 1, f"{w}: no mixed megatick")
        m = gpu8[2]
        check(m["graphs"] and m["graph_replays"] == m["dispatches"],
              f"{w}: not one graph replay per megatick: {m}")
        mega[sampler] = gpu8
    ctx = dctx.DistContext(make_mesh(tp, device="cuda"), "pallas")
    ranks = card(8, "greedy", ctx)
    check(ranks[0] == mega["greedy"][0] and ranks[1] == mega["greedy"][1],
          f"{what} tp={tp} K=8: differs from tp=1")
    if cfg.block == "mamba_hybrid":
        check(ranks[3].get("flash_decode_paged_fused", 0) > 0
              and ranks[3].get("ag_gemm_fused", 0) > 0,
              f"{what} tp={tp}: fused kernels not launched: {ranks[3]}")
    errs = [_rec_teacher_forced(cfg, p_cpu, p_gpu, True)]
    if cfg.block == "mamba_hybrid":
        _counted(fns)
        errs.append(_rec_teacher_forced(cfg, p_cpu, p_gpu, False))
        launched = {f.__name__: f.launches for f in fns if f.launches}
        check(launched.get("flash_decode_fused", 0) > 0,
              f"{what}: contiguous steps did not launch the strided "
              f"decode: {launched}")
    root = os.path.join(ROOT, "build", f"chip_smoke_{arch}")
    shutil.rmtree(root, ignore_errors=True)
    rob = {dev: _robust_serve(p, cfg, reqs, dev, os.path.join(root, dev))
           for dev, p in (("cuda", p_gpu), ("cpu", p_cpu))}
    whole = _robust_serve(p_gpu, cfg, reqs, "cuda")
    shutil.rmtree(root, ignore_errors=True)
    g = rob["cuda"]
    check(g["streams"] == rob["cpu"]["streams"]
          and g["counters"] == rob["cpu"]["counters"],
          f"{what} restore: card {g['streams']} {g['counters']} vs CPU "
          f"{rob['cpu']['streams']} {rob['cpu']['counters']}")
    check(g["resumed"] and g["resumed_prefix_hits"] == 0 and g["graphs"],
          f"{what} restore: resumed {g['resumed']}, prefix hits "
          f"{g['resumed_prefix_hits']}")
    check(g["streams"] == whole["streams"], f"{what} restore: the resumed "
          f"run differs from the uninterrupted one: {g['streams']} vs "
          f"{whole['streams']}")
    print(f"[rec small] {cfg.name} float32: streams token-identical on cuda "
          f"and cpu, counters {runs['cuda'][1]}; K=8 (graph replays) greedy "
          f"{mega['greedy'][1]} and temperature {mega['temperature'][1]}: "
          f"streams as the CPU's K=1; tp={tp} pallas identical to tp=1 "
          f"(launches {ranks[3]}); teacher-forced logits max |diff| "
          f"{max(errs):.3e}; {len(g['resumed'])} requests resumed after "
          f"a snapshot ({g['snapshot_bytes']} bytes) by re-prefill, "
          f"identical to the uninterrupted run", flush=True)
    return {"counters": runs["cuda"][1],
            "k8": {s: v[1] for s, v in mega.items()},
            "tp_launches": ranks[3], "teacher_forced_err": max(errs),
            "robust": {k: v for k, v in g.items() if k != "streams"}}


def rec_per_step(cfg):
    """Kernel launches of one full-width decode step (module contract)."""
    if cfg.block == "rwkv":
        return {"matmul": 9 * cfg.n_layers + 1}
    groups = cfg.n_layers // cfg.attn_every
    return {"matmul": 2 * cfg.n_layers + 4 * groups + 1,
            "flash_decode_paged": groups}


def phase_rec_full(arch, gen, rows, worst, dec_err):
    """(15c) ``arch`` at full width (bf16, seeded weights, nothing cut)
    through the engine with phase 5's traffic: K = 1 on 4 requests, K =
    8 on all 8 (graph replays) and again on prompts of the same lengths
    for the steady time, every kernel's launches counted around each
    serve and exact per decode step (``rec_per_step``); a
    teacher-forced chunk's logits finite; one K = 8 serve on two engines
    in lockstep, graph replays against the eager loop, every recurrent
    byte compared; a profiled eager step split into GEMM, paged decode
    and the rest. Returns (summary, kernel lines)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(arch)
    t0 = time.time()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_gb = sum(p.numel() * p.element_size()
                    for p in params.parameters()) / 1e9
    plens = [int(n) for n in np.random.default_rng(0).integers(32, 129, 8)]
    kw = dict(batch=8, max_len=512, label=arch)
    per_step = rec_per_step(cfg)
    cells = {}
    cells["k1"], done1 = serve_cell(
        params, cfg, 1, _full_requests(cfg, plens[:4], 1, 32, 2), **kw)
    _check_serve(cells["k1"], done1, cfg, 4, 32, per_step, f"{arch} K=1")
    cells["k8"], done8 = serve_cell(
        params, cfg, 8, _full_requests(cfg, plens, 1, 32, 2),
        _full_requests(cfg, plens, 2, 32, 2), **kw)
    _check_serve(cells["k8"], done8, cfg, 8, 32, per_step, f"{arch} K=8")
    s1 = {r.rid: r.out_tokens for r in done1}
    s8 = {r.rid: r.out_tokens for r in done8}
    cells["k8"]["streams_identical_to_k1"] = sum(s1[r] == s8[r] for r in s1)
    lockstep = phase_graph_vs_eager(params, cfg)
    with torch.inference_mode():
        st = lm.init_paged_decode_state(params, cfg, 8, 64, 16, 8)
        st["block_tables"].copy_(torch.arange(64, dtype=torch.int32)
                                 .reshape(8, 8))
        tok = torch.randint(1, cfg.vocab_size, (8, 8), device="cuda")
        lg, _ = lm.decode_chunk(params, tok, torch.full(
            (8,), 8, device="cuda"), st, cfg)
        check(bool(torch.isfinite(lg).all()), f"{arch}: non-finite logits")
        profile = profile_steps(params, cfg, st, label=f"{arch} decode step")
    del st, lg
    sharded = sharded_steps(params, cfg, arch)
    del params
    torch.cuda.empty_cache()
    pk = profile["port_kernels"]
    gemm_ms = pk["gemm_stream"]["ms_per_step"] + pk["mm_kernel"][
        "ms_per_step"]
    profile["split_ms"] = {
        "gemm": gemm_ms, "paged_decode": pk["fd_paged"]["ms_per_step"],
        "rest": profile["device_ms_per_step"] - gemm_ms
        - pk["fd_paged"]["ms_per_step"]}
    kernels = [{"name": f"matmul_{arch}", "route": "cuda",
                "source": "src/repro_torch/csrc/matmul.cu",
                "replaces": "src/repro/kernels/matmul.py:34",
                "launches": cells["k8"]["launches"]["matmul"],
                "launches_per_step": per_step["matmul"],
                "max_abs_err": worst, **_products_row(rows, list(rows)),
                "unit": f"one {arch} decode step at batch 8 "
                        f"({per_step['matmul']} launches), 15a's "
                        f"graph-timed products"}]
    if "flash_decode_paged" in per_step:
        kernels.append(paged_row(
            gen, [n + 32 for n in plens], cfg.n_heads, cfg.n_kv_heads,
            cfg.hd, cells["k8"]["launches"]["flash_decode_paged"],
            per_step["flash_decode_paged"], dec_err,
            name=f"flash_decode_paged_{arch}"))
    out = {"config": f"{arch} full width, {cfg.n_layers} layers, bf16, "
                     f"nothing cut", "params": n_params,
           "weight_gb": weight_gb, "init_s": init_s,
           "prompt_tokens": sum(plens), **cells,
           "launches_per_step": per_step,
           "graph_vs_eager_megaticks": lockstep, "profile": profile,
           "sharded": sharded}
    k8 = cells["k8"]
    print(f"[rec full] {arch}: {n_params / 1e9:.3f} B parameters, "
          f"{weight_gb:.2f} GB; K=1 {cells['k1']['tokens_per_s']:.2f} tok/s; "
          f"K=8 steady {k8['steady_tokens_per_s']:.2f} tok/s, "
          f"{k8['steady_ms_per_token']:.2f} ms/token, busy "
          f"{k8['steady_busy_share']:.3f}, pure megatick "
          f"{k8['pure_megatick_device_ms']:.2f} ms device, peak "
          f"{k8['peak_mem_bytes'] / 1e9:.2f} GB; launches a step {per_step}; "
          f"eager step split (ms): " + ", ".join(
              f"{k} {v:.3f}" for k, v in profile["split_ms"].items())
          + "; " + "; ".join(f"{k['name']} {k['ms']:.3f} ms a step (bound "
                             f"{k['bound_ms']:.3f}, plain {k['plain_ms']:.3f}"
                             f", library {k['library_ms']:.3f})"
                             for k in kernels), flush=True)
    return out, kernels


def phase_rec_train_small(arch):
    """(15d, first part) the float32 smoke model trained 3 steps on the
    card and on the CPU from the same parameters on the same batches
    (lr 1e-4), phase 12b's tolerances: the first loss within 1e-5
    relative, losses within 1e-4, grad norms within 1e-2; every
    first-step gradient leaf nonzero on the card and within max(1e-3, 2
    x the CPU's own gap under one float32 ulp of weight noise, measured
    here as in 14d) of the leaf's largest |entry|; the GEMM launched, no
    plain call on the card."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch import train as tr
    from repro_torch.models import lm
    cfg = smoke_config(get_config(arch)).replace(dtype=torch.float32)
    argv = ["--arch", arch, "--smoke", "--steps", str(REC_TRAIN_STEPS),
            "--batch", "2", "--seq", "32", "--log-every", "1", "--lr",
            "1e-4", "--warmup", "3"]
    init = lm.init_params(cfg, seed=0, device="cpu", trainable=True)
    _unhide(init)
    p_card = _cpu_copy(init, cfg, "cuda")
    grads0 = {}

    def first_grads(step, params, metrics):
        if step == 0:
            grads0[params.device.type] = {
                n: p.grad.detach().cpu().clone()
                for n, p in params.named_parameters() if p.grad is not None}
    cpu = tr.train(cfg, tr.parse_args(argv + ["--device", "cpu"]),
                   params=_cpu_copy(init, cfg, "cpu"), on_step=first_grads)
    n0, p0 = matmul.launches, matmul.plain_calls
    card = tr.train(cfg, tr.parse_args(argv + ["--device", "cuda"]),
                    params=p_card, on_step=first_grads)
    launched, plain = matmul.launches - n0, matmul.plain_calls - p0
    what = f"{arch} train small"
    check(launched > 0 and plain == 0, f"{what}: {launched} GEMM launches, "
                                       f"{plain} plain calls on the card")
    names = [n for n, _ in card["params"].named_parameters()]
    g_card, g_cpu = grads0["cuda"], grads0["cpu"]
    missing = [n for n in names if n not in g_card
               or not bool(g_card[n].abs().max() > 0)]
    check(not missing, f"{what}: leaves without a gradient: {missing}")

    def gaps(g):
        return {n: ((g[n] - g_cpu[n]).abs().max()
                    / g_cpu[n].abs().max()).item() for n in names}
    g_err = max(gaps(g_card).values())
    batch0 = {k: torch.from_numpy(np.array(v)) for k, v in SyntheticLM(
        cfg.vocab_size, 32, 2, seed=0).batch_at(0).items()}
    sens = []
    for seed in range(3):
        noisy = _ulp_noise(init, cfg, seed)
        loss, _ = lm.loss_fn(noisy, batch0, cfg)
        loss.backward()
        sens.append(max(gaps({n: t.grad for n, t in
                              noisy.named_parameters()}).values()))
    tol = max(1e-3, 2 * max(sens))
    check(g_err <= tol, f"{what}: step-1 gradients card vs CPU {g_err:.3e} "
                        f"of a leaf's largest entry (bound {tol:.3e})")
    lc = [m["loss"] for m in cpu["log"]]
    lg = [m["loss"] for m in card["log"]]
    gc_ = [m["grad_norm"] for m in cpu["log"]]
    gg = [m["grad_norm"] for m in card["log"]]
    check(abs(lg[0] - lc[0]) <= 1e-5 * abs(lc[0]),
          f"{what}: first loss {lg[0]} vs CPU {lc[0]}")
    check(np.allclose(lg, lc, rtol=1e-4, atol=0), f"{what}: losses {lg} "
                                                  f"vs CPU {lc}")
    check(np.allclose(gg, gc_, rtol=1e-2, atol=0), f"{what}: grad norms "
                                                   f"{gg} vs CPU {gc_}")
    print(f"[rec train small] {arch} float32, {REC_TRAIN_STEPS} steps: "
          f"step-1 gradients card vs CPU within {g_err:.3e} of a leaf's "
          f"largest entry (bound {tol:.2e}; the CPU's own gap under one ulp "
          f"of weight noise {[f'{x:.2e}' for x in sens]}); losses {lg} vs "
          f"CPU {lc}; grad norms {gg} vs {gc_}; {launched} GEMM launches",
          flush=True)
    return {"step1_grad_err": g_err, "grad_bound": tol,
            "cpu_noise_grad_err": sens, "cpu_losses": lc, "card_losses": lg,
            "cpu_grad_norms": gc_, "card_grad_norms": gg,
            "gemm_launches": launched}


def rec_train_launches_per_step(cfg):
    """GEMM launches of one training step at one rank (remat full: every
    forward product twice, then dA and dB each): a Mamba2 layer 2 x 2 +
    4, a shared-block call 19 (as a llama3-8b layer), an RWKV6 block
    9 x 2 + 18; the unembed 3."""
    if cfg.block == "rwkv":
        return 36 * cfg.n_layers + 3
    return 8 * cfg.n_layers + 19 * (cfg.n_layers // cfg.attn_every) + 3


def phase_rec_train_full(arch):
    """(15d, second part) ``arch`` at full width and full depth, bf16
    compute, fp32 masters, AdamW, remat full: REC_TRAIN_STEPS steps of 2
    x 1024 tokens through ``launch.train.train``. Checks the losses
    finite, the GEMM launches of every step, no plain call, peak memory
    below 80 GB; ms per step, tokens/s."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch import train as tr
    cfg = get_config(arch)
    M = TRAIN_BATCH * TRAIN_SEQ
    args = tr.parse_args([
        "--arch", arch, "--steps", str(REC_TRAIN_STEPS), "--batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--warmup",
        str(REC_TRAIN_STEPS), "--lr", str(TRAIN_LR), "--log-every", "1",
        "--device", "cuda"])
    per_step = rec_train_launches_per_step(cfg)
    counts = []

    def count(step, params, metrics):
        counts.append(matmul.launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    matmul.launches = matmul.plain_calls = 0
    t0 = time.time()
    res = tr.train(cfg, args, on_step=count)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    plain = matmul.plain_calls
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for m in res["log"]]
    steps_s = [m["s"] for m in res["log"]]
    n_params = sum(p.numel() for p in res["params"].parameters())
    del res
    torch.cuda.empty_cache()
    check(all(np.isfinite(losses)), f"{arch} train full: losses {losses}")
    deltas = np.diff([0] + counts).tolist()
    check(plain == 0 and deltas == [per_step] * REC_TRAIN_STEPS,
          f"{arch} train full: GEMM launches per step {deltas} (want "
          f"{per_step}), {plain} plain calls")
    check(peak_gb < 80, f"{arch} train full: peak {peak_gb:.1f} GB")
    step_s = float(np.mean(steps_s[1:]))
    out = {"config": f"{arch} full width, all {cfg.n_layers} layers, bf16 "
                     f"compute, fp32 masters, remat full",
           "params": n_params, "tokens_per_step": M,
           "steps": REC_TRAIN_STEPS, "lr": TRAIN_LR, "losses": losses,
           "step_s": steps_s, "ms_per_step": 1e3 * step_s,
           "tokens_per_s": M / step_s, "run_s": run_s, "peak_gb": peak_gb,
           "gemm_launches_per_step": per_step}
    print(f"[rec train full] {out['config']}: {n_params / 1e9:.3f} B "
          f"parameters; losses {[round(x, 4) for x in losses]}; "
          f"{out['ms_per_step']:.1f} ms per step after step 0 "
          f"({out['tokens_per_s']:.0f} tokens/s); peak {peak_gb:.2f} GB; "
          f"{per_step} GEMM launches a step", flush=True)
    return out


def phase_recurrent(gen):
    """(15) the recurrent families: 15a-15d for zamba2-1.2b and
    rwkv6-3b, each sub-phase's seconds kept; frees what it made."""
    import gc
    from repro_torch.configs import get_config
    secs, out, kernels = {}, {}, []

    def sub(name, fn, *args):
        t0 = time.time()
        res = fn(*args)
        secs[name] = time.time() - t0
        return res
    dec_err = sub("15a decode", phase_rec_decode, gen)
    for arch in REC_ARCHS:
        tag = arch.split("-")[0]
        rows, worst = sub(f"15a {tag}", phase_rec_gemm, gen,
                          get_config(arch))
        small = sub(f"15b {tag}", phase_rec_small, arch)
        full, ks = sub(f"15c {tag}", phase_rec_full, arch, gen, rows, worst,
                       dec_err)
        train_small = sub(f"15d {tag} small", phase_rec_train_small, arch)
        train_full = sub(f"15d {tag} full", phase_rec_train_full, arch)
        out[arch] = {"gemm": rows, "small": small, "full": full,
                     "train_small": train_small, "train_full": train_full}
        kernels += ks
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = secs
    print("[recurrent] sub-phases: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in secs.items()), flush=True)
    return out, kernels


# ------------------------------------------- (16) the vlm and audio frontends
FRONT_ARCHS = ("paligemma-3b", "hubert-xlarge")
FRONT_STEPS = 3
# 16b's gradient bound: 2x the largest first-step gap of the CPU's own run
# under this many draws of one float32 ulp of weight noise (two of them
# also give the grad norms' bound over every step); the draws' gaps
# spread ~4x with the seed, so a few draws misjudge the spread
FRONT_NOISE_DRAWS = 8


def front_gemm_rows(cfg):
    """paligemma-3b's GEMM launches of one decode step, in
    ``rec_gemm_rows``' form: wq/wk/wv (2048 -> 2048, 256, 256) one
    group, wo, wg/wu (2048 -> 16384 x 2) one group, wd a layer; the tied
    fp32 unembed (2048 -> 257216, the table read transposed)."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    qd, kvd = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    bf = torch.bfloat16
    return [("wqkv", d, [qd, kvd, kvd], bf, False, L, True),
            ("wo", qd, [d], bf, False, L, False),
            ("wgu", d, [f, f], bf, False, L, True),
            ("wd", f, [d], bf, False, L, False),
            ("unembed", d, [cfg.vocab_size], torch.float32, True, 1, True)]


def front_train_launches(cfg):
    """GEMM launches of one training step at one rank on a batch with
    patches or frames (remat full): per layer the 4 forward launches
    (wq/wk/wv and the MLP's up projections grouped) twice, the dA of
    every projection (7 with a gate, 6 without), 4 dB launches; the
    unembed's 3; the frontend projection's forward and dB (its input
    needs no gradient)."""
    glu = cfg.act in ("swiglu", "geglu")
    return cfg.n_layers * (2 * 4 + (7 if glu else 6) + 4) + 3 + 2


def front_train_products(cfg, B, S):
    """Every GEMM product of one training step over B sequences of S
    tokens (+ the vlm's patches): (name, kind, M, K, N, dtype, trans_b,
    count a step), as ``train_products`` lists them, the MLP's products
    by the config's activation, the unembed against the fp32 table
    (tied or head), and the frontend projection's forward and dB."""
    P = cfg.num_prefix_tokens if cfg.family == "vlm" else 0
    M = B * (S + P)
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    qd, kvd = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    shapes = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d),
              "wg": (d, f), "wu": (d, f), "wd": (f, d)}
    if cfg.act not in ("swiglu", "geglu"):
        del shapes["wg"]
    bf, f32 = torch.bfloat16, torch.float32
    out = []
    for name, (K, N) in shapes.items():
        out += [(name, "fwd", M, K, N, bf, False, 2 * L),
                (name, "dA", M, N, K, bf, False, L),
                (name, "dB", K, M, N, bf, False, L)]
    Mf = B * (P or S)
    return out + [("unembed", "fwd", M, d, V, f32, True, 1),
                  ("unembed", "dA", M, V, d, f32, False, 1),
                  ("unembed", "dB", V, M, d, f32, False, 1),
                  ("frontend", "fwd", Mf, cfg.frontend_dim, d, bf, False, 1),
                  ("frontend", "dB", cfg.frontend_dim, Mf, d, bf, False, 1)]


def phase_front_products(gen, cfg, B, S):
    """(16d) the GEMM kernel vs its plain version at every product of a
    full-width training step of ``cfg`` (``front_train_products``: the
    frontend projections among them), phase 2's tolerances, each timed
    with CUDA events (kernel, plain version, one ``torch.matmul``).
    Returns (rows keyed "name kind" with ``count``, the worst error)."""
    from repro_torch.kernels import matmul as kmm
    rows, worst = {}, 0.0
    for name, kind, M, K, N, dt, tb, count in front_train_products(cfg, B,
                                                                   S):
        a = torch.randn((M, K), generator=gen, device="cuda").to(dt)
        b = (torch.randn((N, K) if tb else (K, N), generator=gen,
                         device="cuda") / K ** 0.5).to(dt)
        got, want = kmm.matmul(a, b, trans_b=tb), kmm.matmul_plain(a, b, tb)
        torch.cuda.synchronize()
        err = _gemm_err(got, want, dt, f"{cfg.name} train GEMM {name} "
                                       f"{kind} {(M, K, N)}")
        worst = max(worst, err)
        del got, want
        big = M * K * N > 1e12
        flops, by = 2 * M * N * K, (M * K + K * N + M * N) * a.element_size()
        rows[f"{name} {kind}"] = {
            "shape": [M, K, N], "dtype": str(dt).replace("torch.", ""),
            "count": count, "max_abs_err": err,
            "ms": time_ms(lambda: kmm.matmul(a, b, trans_b=tb),
                          iters=2 if big else 5, warmup=1),
            "plain_ms": time_ms(lambda: kmm.matmul_plain(a, b, tb),
                                iters=2 if big else 5, warmup=1),
            "library_ms": time_ms(lambda: a @ (b.t() if tb else b),
                                  iters=2 if big else 5, warmup=1),
            "bound_ms": 1e3 * bound(flops, by, dt)[0],
            "ops_ms": 1e3 * ops_s(flops, dt), "bytes_ms": 1e3 * bytes_s(by)}
        del a, b
        torch.cuda.empty_cache()
    return rows, worst


def phase_front_decode(gen, W=4):
    """(16a) both decode kernels at paligemma's heads (8 query heads per
    KV head of 256: two units of 4 heads, ``heads_per_unit``) vs their
    plain versions, phase 2's tolerances, bf16 and fp32: the paged decode
    at W = 1 (full table, holes, a window, a gather slice) and fused over
    ``W`` virtual ranks of cuda:0; the contiguous decode at W = 1
    (NORMAL) and fused over ``W`` ranks (a window, shards that are not
    whole tiles); fused outputs bit-identical across ranks. Returns the
    worst errors (paged, contiguous)."""
    from repro_torch.distributed.context import Mesh
    from repro_torch.kernels import flash_decode as kfd
    H, KVH, D, bs, C = 8, 1, 256, 16, 32
    scale = D ** -0.5
    worst = {"paged": 0.0, "strided": 0.0}
    n = 0
    mesh = Mesh(["cuda:0"] * W)
    check(kfd.heads_per_unit(H // KVH, D) == 4, "hd 256: not 4 heads a unit")
    for dt in (torch.float32, torch.bfloat16):
        q, kp, vp, full = _decode_inputs(gen, dt, H=H, KVH=KVH, D=D, bs=bs,
                                         C=C)
        cur = torch.tensor([1, bs, bs + 1, C * bs, 37, 200, 511, 130],
                           dtype=torch.int32, device="cuda")
        holes = full.clone()
        holes[4, 0] = -1
        for name, tables, window in (("full", full[:, :C], None),
                                     ("holes", holes[:, :C], None),
                                     ("window32", holes[:, :C], 32),
                                     ("gather_slice", full[:, :C // 2],
                                      None)):
            cl = cur.clamp(max=tables.shape[1] * bs)
            got = kfd.flash_decode_paged(q, kp, vp, cl, tables, scale,
                                         window=window)
            want = kfd.paged_decode_plain(q, kp, vp, cl, tables, scale,
                                          window=window)
            torch.cuda.synchronize()
            worst["paged"] = max(worst["paged"], _close(
                got, want, dt, f"hd256 paged {name} {dt}"))
            n += 1
        q, kps, vps, cur, tb = _paged_ranks_inputs(gen, dt, W, H=H, KVH=KVH,
                                                   D=D)
        n_loc = kps[0].shape[0]
        for _ in range(2):                 # both inbox parities
            got = kfd.flash_decode_paged_fused(
                [q] * W, kps, vps, [cur] * W, [tb] * W, scale, mesh=mesh)
            want = kfd.fused_plain([kfd.paged_partial_plain(
                q, kps[r], vps[r], cur, tb, scale, None, base=r * n_loc)
                for r in range(W)], dt)[0]
            torch.cuda.synchronize()
            for r in range(W):
                check(torch.equal(got[r], got[0]), f"hd256 paged fused "
                                                   f"{dt}: rank {r} differs")
            worst["paged"] = max(worst["paged"], _close(
                got[0], want, dt, f"hd256 paged fused W={W} {dt}"))
            n += 1
        for w_, window in ((1, None), (W, None), (W, 100)):
            q, ks, vs, cur = _strided_inputs(gen, dt, w_, H=H, KVH=KVH, D=D,
                                             S_max=600 if w_ > 1 else 512)
            got = kfd.flash_decode_fused([q] * w_, ks, vs, [cur] * w_, scale,
                                         window=window, mesh=mesh if w_ > 1
                                         else None)
            want = kfd.fused_plain([kfd.strided_partial_plain(
                q, ks[r], vs[r], cur, scale, window, r, w_)
                for r in range(w_)], dt)[0]
            torch.cuda.synchronize()
            for r in range(w_):
                check(torch.equal(got[r], got[0]), f"hd256 strided {dt}: "
                                                   f"rank {r} differs")
            worst["strided"] = max(worst["strided"], _close(
                got[0], want, dt, f"hd256 strided W={w_} window {window} "
                                  f"{dt}"))
            n += 1
    print(f"[front decode] paged and contiguous decode at hd 256, q_per_kv "
          f"8 (two units of 4 heads): {n} cases (W = 1 and fused over {W} "
          f"virtual ranks) match the plain versions (max |err| paged "
          f"{worst['paged']:.3e}, contiguous {worst['strided']:.3e})",
          flush=True)
    return worst


def strided_row(gen, lens, H, KVH, D, launches, per, err, B=8, S_max=256,
                name="flash_decode_fused"):
    """The contiguous decode's kernel line at W = 1 (NORMAL) for one
    decode step of ``per`` launches at the served lengths ``lens`` (bf16,
    a cache of ``S_max`` positions): graph-timed beside its plain version,
    SDPA over the head-expanded cache, and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as kfd
    bf16 = torch.bfloat16
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(bf16)
    kc = torch.randn((B, S_max, KVH, D), generator=gen, device="cuda").to(
        bf16)
    vc = torch.randn((B, S_max, KVH, D), generator=gen, device="cuda").to(
        bf16)
    scale = D ** -0.5
    t_k = graph_ms(lambda: kfd.flash_decode_fused([q], [kc], [vc], [cl],
                                                  scale), iters=50)
    t_p = time_ms(lambda: kfd.fused_plain([kfd.strided_partial_plain(
        q, kc, vc, cl, scale, None, 0, 1)], bf16), iters=5)
    kg = kc.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
    vg = vc.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
    mask = (torch.arange(S_max, device="cuda")[None] < cl[:, None])[
        :, None, None, :]
    t_l = graph_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kg, vg, attn_mask=mask, scale=scale), iters=50)
    by = sum(lens) * KVH * D * 2 * 2 + 2 * nbytes(q) + nbytes(cl)
    b_s, b_by = bound(sum(4 * n * H * D for n in lens), by, bf16)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:321",
            "launches": launches, "launches_per_step": per,
            "max_abs_err": err, "ms": per * t_k, "plain_ms": per * t_p,
            "library_ms": per * t_l,
            "bound_ms": 1e3 * per * b_s, "bound_by": b_by,
            "unit": f"one contiguous-cache decode step at batch {B} on one "
                    f"rank, {per:g} launches, H {H}, KVH {KVH}, hd {D}, "
                    f"S_max {S_max}, cur_len {lens}"}


def _front_smoke(arch):
    """(cfg, trainable CPU init) of ``arch``'s float32 smoke model."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm
    cfg = smoke_config(get_config(arch)).replace(dtype=torch.float32)
    return cfg, lm.init_params(cfg, seed=0, device="cpu", trainable=True)


def _front_train(init, cfg, dev, mesh=None, steps=FRONT_STEPS):
    """``steps`` steps of ``launch.steps``' train step on
    ``synthetic_batch(cfg, 2, 32, seed=step)`` (patches or frames),
    AdamW lr 1e-4, from a copy of ``init`` on ``dev`` (sharded over
    ``mesh`` under ``TP_MODE``): (losses, grad norms, the first step's
    gradients of the global leaves: sharded blocks joined, a replicated
    leaf's summed copies taken once, None where the loss reads nothing)
    and the GEMM's launches and plain calls."""
    from repro_torch.distributed import context as dctx
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch import steps as st
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    params = _cpu_copy(init, cfg, dev)
    if mesh is not None:
        params = lm.shard_params(params, mesh)
    ctx = dctx.DistContext(mesh, TP_MODE) if mesh is not None \
        else dctx.DistContext()
    step = st.make_train_step(cfg, adamw.AdamWConfig(lr=1e-4))
    opt = st.init_opt_state(params)
    losses, gnorms, g0 = [], [], None
    n0, p0 = matmul.launches, matmul.plain_calls
    for i in range(steps):
        batch = st.synthetic_batch(cfg, 2, 32, seed=i, device=dev)
        with dctx.use(ctx):
            params, opt, met = step(params, opt, batch)
        losses.append(met["loss"].item())
        gnorms.append(met["grad_norm"].item())
        if i:
            continue
        g0 = _joined_grads(params, cfg, mesh, "cpu")
    return losses, gnorms, g0, matmul.launches - n0, matmul.plain_calls - p0


def _grads_apart(g, want):
    """The largest gap of a gradient leaf over the leaf's largest |entry|;
    leaves without a gradient must be so in both."""
    worst = 0.0
    for n, w in want.items():
        check((g[n] is None) == (w is None), f"gradient of {n}: present in "
                                             f"one run only")
        if w is not None:
            worst = max(worst, ((g[n] - w).abs().max()
                                / w.abs().max().clamp_min(1e-30)).item())
    return worst


def phase_front_small(tp=4):
    """(16b) the float32 smoke models on the card against the CPU:
    paligemma-smoke served (phase 4's engine and requests) at K = 1 and K
    = 8 (graph replays) and at K = 8 over ``tp`` virtual ranks under
    ``pallas`` (the fused paged decode and AG+GEMM), greedy: streams
    token-identical and counters equal to the CPU's, no plain GEMM call
    on the card; hubert-smoke refused by the engine; both trained
    FRONT_STEPS steps through ``launch.steps``' train step on batches
    with patches or frames, card vs CPU and tp ``tp`` vs tp 1 on the
    card, phase 12b's and 13b's tolerances: the first loss within 1e-5
    relative, losses 1e-4 (card vs CPU), every first-step gradient leaf
    within 1e-3 of its largest |entry| and grad norms within 1e-2, each
    of the last two or 2x the CPU's own gap under one float32 ulp of
    weight noise if that is larger (the gradients' over
    FRONT_NOISE_DRAWS noisy CPU runs of the first step, the grad norms'
    over two runs of every step, 14d's and 15d's bound): hubert-smoke's
    second grad norm moves by more than 1% on the CPU alone under such
    noise, as AdamW's normalised update moves the entries whose gradient
    is near zero either way."""
    from repro_torch.distributed import context as dctx
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine
    cfg, init = _front_smoke("paligemma-3b")
    p_cpu = lm.init_params(cfg, seed=0, device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    reqs = _smoke_requests(np.random.default_rng(0), cfg.vocab_size)
    mesh = make_mesh(tp, device="cuda")
    serve = {}
    for K in (1, 8):
        cpu = _serve_small(p_cpu, cfg, reqs, "cpu", K)
        n0, pl0 = matmul.launches, matmul.plain_calls
        card = _serve_small(p_gpu, cfg, reqs, "cuda", K)
        check(matmul.plain_calls == pl0 and matmul.launches > n0,
              f"paligemma small K={K}: plain calls or no GEMM launch")
        check(len(card[0]) == len(reqs) and card[0] == cpu[0]
              and card[1] == cpu[1], f"paligemma small K={K}: card "
              f"{card[0]} {card[1]} vs CPU {cpu[0]} {cpu[1]}")
        serve[K] = card
    ranks = _serve_small(p_gpu, cfg, reqs, "cuda", 8, "greedy",
                         dctx.DistContext(mesh, "pallas"))
    check(ranks[0] == serve[8][0] and ranks[1] == serve[8][1],
          f"paligemma small tp={tp} K=8 differs from tp=1")
    hub, hub_init = _front_smoke("hubert-xlarge")
    try:
        Engine(lm.init_params(hub, seed=0, device="cuda"), hub,
               device="cuda")
        refused = False
    except ValueError as e:
        refused = "encoder-only" in str(e)
    check(refused, "hubert: the engine did not refuse an encoder")
    train = {}
    for arch, (c, p0) in (("paligemma-3b", (cfg, init)),
                          ("hubert-xlarge", (hub, hub_init))):
        cpu = _front_train(p0, c, "cpu")
        noise = [_front_train(_ulp_noise(p0, c, seed), c, "cpu")
                 for seed in (0, 1)]
        g_noise = [_grads_apart(n[2], cpu[2]) for n in noise] + [
            _grads_apart(_front_train(_ulp_noise(p0, c, seed), c, "cpu",
                                      steps=1)[2], cpu[2])
            for seed in range(2, FRONT_NOISE_DRAWS)]
        g_tol = max(1e-3, 2 * max(g_noise))
        n_tol = max(1e-2, 2 * max(abs(a / b - 1) for n in noise
                                  for a, b in zip(n[1], cpu[1])))
        card = _front_train(p0, c, "cuda")
        card_tp = _front_train(p0, c, "cuda", mesh)
        what = f"{arch} train small"
        check(card[3] > 0 and card[4] == 0 and card_tp[4] == 0,
              f"{what}: {card[3]} GEMM launches, plain calls {card[4]} / "
              f"{card_tp[4]} on the card")
        check(abs(card[0][0] - cpu[0][0]) <= 1e-5 * abs(cpu[0][0])
              and np.allclose(card[0], cpu[0], rtol=1e-4, atol=0)
              and np.allclose(card[1], cpu[1], rtol=n_tol, atol=0),
              f"{what}: card losses {card[0]} gnorms {card[1]} vs CPU "
              f"{cpu[0]} {cpu[1]} (grad-norm bound {n_tol:.3e})")
        check(abs(card_tp[0][0] - card[0][0]) <= 1e-5 * abs(card[0][0]),
              f"{what}: tp {tp} first loss {card_tp[0][0]} vs tp 1 "
              f"{card[0][0]}")
        g_cpu, g_tp = _grads_apart(card[2], cpu[2]), \
            _grads_apart(card_tp[2], card[2])
        check(g_cpu <= g_tol and g_tp <= g_tol, f"{what}: step-1 "
              f"gradients card vs CPU {g_cpu:.3e}, tp {tp} vs tp 1 "
              f"{g_tp:.3e} (bound {g_tol:.3e})")
        train[arch] = {"cpu_losses": cpu[0], "card_losses": card[0],
                       f"card_tp{tp}_losses": card_tp[0],
                       "cpu_grad_norms": cpu[1], "card_grad_norms": card[1],
                       "grad_err_vs_cpu": g_cpu, "grad_err_tp_vs_1": g_tp,
                       "grad_bound": g_tol, "grad_norm_bound": n_tol,
                       "cpu_noise_grad_errs": g_noise,
                       "gemm_launches": card[3]}
    print(f"[front small] paligemma-smoke float32 served on the card as on "
          f"the CPU at K=1 {serve[1][1]} and K=8 {serve[8][1]} (graph "
          f"replays), tp={tp} pallas as tp=1; hubert refused by the engine; "
          f"trained {FRONT_STEPS} steps with patches / frames: " + "; ".join(
              f"{a} card losses {[round(x, 5) for x in t['card_losses']]}, "
              f"grad norms {[round(x, 4) for x in t['card_grad_norms']]} vs "
              f"CPU {[round(x, 4) for x in t['cpu_grad_norms']]} (bound "
              f"{t['grad_norm_bound']:.2e}), step-1 gradients vs CPU "
              f"{t['grad_err_vs_cpu']:.2e}, tp {tp} vs 1 "
              f"{t['grad_err_tp_vs_1']:.2e} (bound {t['grad_bound']:.2e})"
              for a, t in train.items()), flush=True)
    return {"serve_counters": {K: v[1] for K, v in serve.items()},
            "train": train}


def phase_front_serve(gen, rows, worst, dec_err):
    """(16c) paligemma-3b at full width (18 layers, d 2048, 8/1 heads of
    256, d_ff 16384 geglu, tied vocab 257216; bf16 layers and the fp32
    tied table, seeded weights, nothing cut) through the engine with
    phase 5's traffic: K = 1 on 4 requests, K = 8 on all 8 (graph
    replays) and again on prompts of the same lengths for the steady
    time, launches exact a decode step (73 GEMM, 18 paged decodes);
    teacher-forced paged logits finite; decode steps over the contiguous
    cache (18 contiguous decodes a step, finite logits). Returns
    (summary, kernel lines 1p, 2p, 3p)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.models import lm
    from repro_torch.serving.graphs import launch_counted
    cfg = get_config("paligemma-3b")
    t0 = time.time()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_gb = sum(p.numel() * p.element_size()
                    for p in params.parameters()) / 1e9
    plens = [int(n) for n in np.random.default_rng(0).integers(32, 129, 8)]
    kw = dict(batch=8, max_len=512, label="paligemma")
    L = cfg.n_layers
    per_step = {"matmul": 4 * L + 1, "flash_decode_paged": L}
    cells = {}
    cells["k1"], done1 = serve_cell(
        params, cfg, 1, _full_requests(cfg, plens[:4], 1, 32, 2), **kw)
    _check_serve(cells["k1"], done1, cfg, 4, 32, per_step, "paligemma K=1")
    cells["k8"], done8 = serve_cell(
        params, cfg, 8, _full_requests(cfg, plens, 1, 32, 2),
        _full_requests(cfg, plens, 2, 32, 2), **kw)
    _check_serve(cells["k8"], done8, cfg, 8, 32, per_step, "paligemma K=8")
    s1 = {r.rid: r.out_tokens for r in done1}
    s8 = {r.rid: r.out_tokens for r in done8}
    cells["k8"]["streams_identical_to_k1"] = sum(s1[r] == s8[r] for r in s1)
    fns = launch_counted()
    with torch.inference_mode():
        st = lm.init_paged_decode_state(params, cfg, 8, 64, 16, 8)
        st["block_tables"].copy_(torch.arange(64, dtype=torch.int32)
                                 .reshape(8, 8))
        tok = torch.randint(1, cfg.vocab_size, (8, 8), device="cuda")
        lg, _ = lm.decode_chunk(params, tok, torch.full(
            (8,), 8, device="cuda"), st, cfg)
        check(bool(torch.isfinite(lg).all()), "paligemma: non-finite "
                                              "paged logits")
        del st
        cst = lm.init_decode_state(params, cfg, 8, 256)
        T = 4
        torch.cuda.synchronize()
        _counted(fns)
        for j in range(T):
            lg, _ = lm.decode_step(params, tok[:, j:j + 1], cst, cfg)
        torch.cuda.synchronize()
        contiguous = {f.__name__: f.launches for f in fns if f.launches}
        check(bool(torch.isfinite(lg).all()), "paligemma: non-finite "
                                              "contiguous logits")
    check(contiguous == {"matmul": T * per_step["matmul"],
                         "flash_decode_fused": T * L}, f"paligemma "
          f"contiguous decode: launches {contiguous} in {T} steps")
    del cst, lg
    sharded = sharded_steps(params, cfg, "paligemma-3b")
    del params
    torch.cuda.empty_cache()
    lens = [n + 32 for n in plens]
    kernels = [
        {"name": "matmul_paligemma", "route": "cuda",
         "source": "src/repro_torch/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:34",
         "launches": cells["k8"]["launches"]["matmul"],
         "launches_per_step": per_step["matmul"], "max_abs_err": worst,
         **_products_row(rows, list(rows)),
         "unit": f"one paligemma-3b decode step at batch 8 "
                 f"({per_step['matmul']} launches), 16a's graph-timed "
                 f"products"},
        paged_row(gen, lens, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                  cells["k8"]["launches"]["flash_decode_paged"], L,
                  dec_err["paged"], name="flash_decode_paged_paligemma"),
        strided_row(gen, lens, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                    contiguous["flash_decode_fused"], L, dec_err["strided"],
                    name="flash_decode_fused_paligemma")]
    k8 = cells["k8"]
    out = {"config": "paligemma-3b full width, 18 layers, bf16 layers and "
                     "the fp32 tied table, nothing cut", "params": n_params,
           "weight_gb": weight_gb, "init_s": init_s,
           "prompt_tokens": sum(plens), **cells,
           "launches_per_step": per_step,
           "contiguous_launches": contiguous, "contiguous_steps": T,
           "sharded": sharded}
    print(f"[front serve] paligemma-3b: {n_params / 1e9:.3f} B parameters, "
          f"{weight_gb:.2f} GB; K=1 {cells['k1']['tokens_per_s']:.2f} tok/s;"
          f" K=8 steady {k8['steady_tokens_per_s']:.2f} tok/s, "
          f"{k8['steady_ms_per_token']:.2f} ms/token, busy "
          f"{k8['steady_busy_share']:.3f}, pure megatick "
          f"{k8['pure_megatick_device_ms']:.2f} ms device, peak "
          f"{k8['peak_mem_bytes'] / 1e9:.2f} GB, {k8['graph_captures']} "
          f"graphs; launches a step {per_step}, contiguous {contiguous} in "
          f"{T} steps; " + "; ".join(
              f"{k['name']} {k['ms']:.3f} ms a step (bound "
              f"{k['bound_ms']:.3f}, plain {k['plain_ms']:.3f}, library "
              f"{k['library_ms']:.3f})" for k in kernels), flush=True)
    return out, kernels


def phase_front_train(gen, arch, B=TRAIN_BATCH, S=TRAIN_SEQ):
    """(16d) ``arch`` at full width and depth, bf16 compute, fp32 masters,
    AdamW (lr TRAIN_LR, warmup FRONT_STEPS), remat full: FRONT_STEPS
    steps of ``launch.steps``' train step on ``synthetic_batch`` batches
    of B x S tokens (paligemma: + 256 patches a sequence) or frames.
    Checks the losses finite, the GEMM launches of every step
    (``front_train_launches``), no plain call, peak memory below 80 GB;
    ms per step, tokens/s, peak. Then every product of the step timed
    (``phase_front_products``) for the kernel line. Returns (summary,
    kernel line)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch import steps as st
    from repro_torch.models import lm
    from repro_torch.optim import adamw, schedule
    cfg = get_config(arch)
    per_step = front_train_launches(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = lm.init_params(cfg, seed=0, device="cuda", trainable=True)
    opt = st.init_opt_state(params)
    step = st.make_train_step(cfg, adamw.AdamWConfig(
        lr=schedule.warmup_cosine(TRAIN_LR, FRONT_STEPS, FRONT_STEPS)))
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(p.numel() for p in params.parameters())
    matmul.launches = matmul.plain_calls = 0
    losses, step_s, counts = [], [], []
    for i in range(FRONT_STEPS):
        batch = st.synthetic_batch(cfg, B, S, seed=i, device="cuda")
        torch.cuda.synchronize()
        t1 = time.time()
        params, opt, met = step(params, opt, batch)
        losses.append(met["loss"].item())
        step_s.append(time.time() - t1)
        counts.append(matmul.launches)
    plain = matmul.plain_calls
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params, opt, met, batch, step
    torch.cuda.empty_cache()
    check(all(np.isfinite(losses)), f"{arch} train full: losses {losses}")
    deltas = np.diff([0] + counts).tolist()
    check(plain == 0 and deltas == [per_step] * FRONT_STEPS,
          f"{arch} train full: GEMM launches per step {deltas} (want "
          f"{per_step}), {plain} plain calls")
    check(peak_gb < 80, f"{arch} train full: peak {peak_gb:.1f} GB")
    rows, worst = phase_front_products(gen, cfg, B, S)
    P = cfg.num_prefix_tokens if cfg.family == "vlm" else 0
    tokens = B * (S + P)
    ms = 1e3 * float(np.mean(step_s[1:]))
    tag = arch.split("-")[0]
    kernel = {"name": f"matmul_{tag}_train", "route": "cuda",
              "source": "src/repro_torch/csrc/matmul.cu",
              "replaces": "src/repro/kernels/matmul.py:34",
              "launches": counts[-1], "launches_per_step": per_step,
              "max_abs_err": worst, **_products_row(rows, list(rows)),
              "unit": f"one {arch} training step at one rank ({tokens} "
                      f"rows, {per_step} launches): every product x its "
                      f"count, each timed alone (CUDA events)"}
    out = {"config": f"{arch} full width, all {cfg.n_layers} layers, bf16 "
                     f"compute, fp32 masters, remat full",
           "params": n_params, "init_s": init_s, "batch": B, "seq": S,
           "rows_per_step": tokens, "steps": FRONT_STEPS, "lr": TRAIN_LR,
           "losses": losses, "step_s": step_s, "ms_per_step": ms,
           "tokens_per_s": B * S / (ms / 1e3), "peak_gb": peak_gb,
           "gemm_launches_per_step": per_step, "products": rows}
    print(f"[front train] {out['config']}: {n_params / 1e9:.3f} B "
          f"parameters; losses {[round(x, 4) for x in losses]}; "
          f"{ms:.1f} ms per step after step 0 ({out['tokens_per_s']:.0f} "
          f"tokens/s of {B} x {S}{f' + {P} patches' if P else ''}); peak "
          f"{peak_gb:.2f} GB; {per_step} GEMM launches a step; GEMM "
          f"{kernel['ms']:.1f} ms a step by product (bound "
          f"{kernel['bound_ms']:.1f}, plain {kernel['plain_ms']:.1f}, "
          f"torch.matmul {kernel['library_ms']:.1f})", flush=True)
    return out, kernel


def phase_frontends(gen):
    """(16) the vlm and audio frontends: 16a-16d, each sub-phase's
    seconds kept; frees what it made."""
    import gc
    from repro_torch.configs import get_config
    secs = {}

    def sub(name, fn, *args):
        t0 = time.time()
        res = fn(*args)
        secs[name] = time.time() - t0
        return res
    dec_err = sub("16a decode", phase_front_decode, gen)
    cfg = get_config("paligemma-3b")
    rows, worst = sub("16a gemm", phase_rec_gemm, gen, cfg, 8,
                      front_gemm_rows(cfg))
    small = sub("16b small", phase_front_small)
    full, kernels = sub("16c serve", phase_front_serve, gen, rows, worst,
                        dec_err)
    out = {"gemm": rows, "decode_err": dec_err, "small": small,
           "serve": full}
    for arch in FRONT_ARCHS:
        out[f"train_{arch}"], k = sub(f"16d {arch.split('-')[0]}",
                                      phase_front_train, gen, arch)
        kernels.append(k)
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = secs
    print("[frontends] sub-phases: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in secs.items()), flush=True)
    return out, kernels


# ------------------------------- phase 17: "dots" and every family at tp W
TP_FAMILIES = ("olmoe-1b-7b", "mixtral-8x22b", "zamba2-1.2b", "rwkv6-3b")
TP_FAM_STEPS = 3
# 17c: the full-width models over TP virtual ranks, depth cut to fit 80
# GB where it must: olmoe as 14d (fp32 AdamW state, 16 B a parameter);
# rwkv6-3b's time mix is replicated on every rank (~2.8 GB of masters and
# state a block at tp 4), so 12 of its 32 blocks
TP_FAM_FULL = (("olmoe-1b-7b", 4), ("zamba2-1.2b", None), ("rwkv6-3b", 12))


class ProductLog:
    """Records every GEMM call the wrappers make on the card while it is
    on (the shapes of ``kernels.matmul._run`` and ``_product_batched``):
    (kind, A's shape, the B shapes, trans_b, dtype) -> launches
    (``counts``) and calls (``calls``; a group the general kernel takes
    is one launch a product)."""

    def __init__(self):
        from repro_torch.kernels import matmul as kmm
        self.kmm, self.counts, self.calls = kmm, {}, {}
        self._run, self._batched = kmm._run, kmm._product_batched

    def __enter__(self):
        def run(a, bs, trans_b, tma):
            key = ("2d", tuple(a.shape), tuple(tuple(b.shape) for b in bs),
                   trans_b, a.dtype)
            n = 1 if tma else sum(1 for b in bs if b.numel())
            self.calls[key] = self.calls.get(key, 0) + 1
            self.counts[key] = self.counts.get(key, 0) + n
            return self._run(a, bs, trans_b, tma)

        def batched(a, b):
            if a.is_cuda:
                key = ("bmm", tuple(a.shape), (tuple(b.shape),), False,
                       a.dtype)
                self.calls[key] = self.calls.get(key, 0) + 1
                self.counts[key] = self.counts.get(key, 0) + 1
            return self._batched(a, b)
        self.kmm._run, self.kmm._product_batched = run, batched
        return self

    def __exit__(self, *exc):
        self.kmm._run, self.kmm._product_batched = self._run, self._batched


def _log_operands(gen, key):
    kind, ash, bshs, trans_b, dt = key
    a = (torch.randn(ash, generator=gen, device="cuda") / 4).to(dt)
    bs = [(torch.randn(s, generator=gen, device="cuda") / 4).to(dt)
          for s in bshs]
    return a, bs


def _log_bound(key):
    """(operations, bytes, dtype) of one launch of ``key``."""
    kind, ash, bshs, trans_b, dt = key
    E = ash[0] if kind == "bmm" else 1
    M, K = ash[-2:]
    size = torch.tensor([], dtype=dt).element_size()
    ops, by = 0, E * M * K * size
    for s in bshs:
        N = s[-2] if trans_b else s[-1]
        ops += 2 * E * M * N * K
        by += E * (K * N + M * N) * size
    return ops, by, dt


def log_times(gen, log, per, what):
    """The products of ``log`` (a ProductLog over ``per`` steps): each
    distinct call on random operands held against its plain version
    (phase 2's tolerances) and timed (CUDA events) beside its plain
    version and one PyTorch call (``torch.matmul`` a product,
    ``torch.bmm`` a batch). Returns a kernel line's per-step fields (ms,
    plain_ms, library_ms, bound_ms, bound_by; launches a step,
    max_abs_err, distinct calls)."""
    from repro_torch.kernels.matmul import (matmul, matmul_batched,
                                            matmul_batched_plain,
                                            matmul_group, matmul_plain)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    ops_tot = by_tot = bound_sum = 0.0
    worst, launches = 0.0, 0
    with torch.no_grad():
        for key, n in log.calls.items():
            check(n % per == 0 and log.counts[key] % per == 0,
                  f"{what}: {n} calls of {key} over {per} steps")
            c = n // per
            launches += log.counts[key] // per
            kind, _, _, trans_b, dt = key
            a, bs = _log_operands(gen, key)
            if kind == "bmm":
                def kern():
                    return [matmul_batched(a, bs[0])]

                def plain():
                    return [matmul_batched_plain(a, bs[0])]

                def lib():
                    return [torch.bmm(a, bs[0])]
            else:
                def kern():
                    return (matmul_group(a, bs) if len(bs) > 1
                            else [matmul(a, bs[0], trans_b=trans_b)])

                def plain():
                    return [matmul_plain(a, b, trans_b) for b in bs]

                def lib():
                    return [a @ (b.t() if trans_b else b) for b in bs]
            for got, want in zip(kern(), plain()):
                worst = max(worst, _gemm_err(
                    got.reshape(-1, got.shape[-1]),
                    want.reshape(-1, want.shape[-1]), dt,
                    f"{what} {kind} {tuple(a.shape)} x "
                    f"{[tuple(b.shape) for b in bs]}"))
            for field, fn in (("ms", kern), ("plain_ms", plain),
                              ("library_ms", lib)):
                tot[field] += c * time_ms(fn, iters=5, warmup=1)
            ops, by, _ = _log_bound(key)
            ops_tot += c * ops_s(ops, dt)
            by_tot += c * bytes_s(by)
            bound_sum += c * bound(ops, by, dt)[0]
            del a, bs
    torch.cuda.empty_cache()
    return {**tot, "bound_ms": 1e3 * bound_sum,
            "bound_by": "operations" if ops_tot >= by_tot else "bytes",
            "launches_per_step": launches, "max_abs_err": worst,
            "distinct": len(log.calls)}


def _profiled_gemm(step_fn, params, opt, batch):
    """One more train step under the profiler: (wall ms, device ms, the
    GEMM kernels' device ms, their launches)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
    wall = 1e3 * (time.time() - t0)
    dev = gemm = 0.0
    calls = 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev += us / 1e3
        if port_kernel("gemm_stream", ev.key) or port_kernel("mm_kernel",
                                                             ev.key):
            gemm += us / 1e3
            calls += ev.count
    return wall, dev, gemm, calls


def _gemm_kernels_in(fn):
    """(the GEMM kernels the profiler saw during ``fn()``, the wrappers'
    launch count over it)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.matmul import matmul
    torch.cuda.synchronize()
    n0 = matmul.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    seen = sum(ev.count for ev in prof.key_averages()
               if port_kernel("gemm_stream", ev.key)
               or port_kernel("mm_kernel", ev.key))
    return seen, matmul.launches - n0


def phase_dots_small():
    """(17a, first part) the float32 llama3-8b smoke model (remat on) one
    step under ``"full"`` and ``"dots"``, on the card and on the CPU from
    the same parameters and batch: the loss within 1e-5 relative and
    every gradient leaf within 1e-3 of its largest |entry| (12b's
    tolerances), ``"dots"`` against ``"full"`` and the card against the
    CPU; the GEMM launches of the forward and of the backward, by the
    wrappers' counter and by the profiler (which can drop a record, so
    it is reported, and checked only to count fewer under ``"dots"``):
    the forward's the same under both policies, the backward's under
    ``"dots"`` fewer by every layer's forward products (all the
    forward's but the unembed's), none of which come back."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm
    base = smoke_config(get_config("llama3-8b")).replace(
        dtype=torch.float32, remat=True)
    init = lm.init_params(base, seed=0, device="cpu", trainable=True)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in SyntheticLM(
        base.vocab_size, 32, 2, seed=0).batch_at(0).items()}
    res = {}
    for dev in ("cpu", "cuda"):
        for pol in ("full", "dots"):
            cfg = base.replace(remat_policy=pol)
            p = _cpu_copy(init, cfg, dev)
            b = {k: v.to(dev) for k, v in batch.items()}
            out = {}
            if dev == "cuda":
                def fwd():
                    out["loss"] = lm.loss_fn(p, b, cfg)[0]
                out["fwd"] = _gemm_kernels_in(fwd)
                out["bwd"] = _gemm_kernels_in(out["loss"].backward)
            else:
                out["loss"] = lm.loss_fn(p, b, cfg)[0]
                out["loss"].backward()
            res[(dev, pol)] = (out["loss"].item(), {
                n: t.grad.detach().cpu() for n, t in p.named_parameters()},
                out.get("fwd", (0, 0)), out.get("bwd", (0, 0)))
    errs = {}
    for a, b in ((("cuda", "dots"), ("cuda", "full")),
                 (("cuda", "dots"), ("cpu", "dots")),
                 (("cuda", "full"), ("cpu", "full")),
                 (("cpu", "dots"), ("cpu", "full"))):
        la, ga = res[a][:2]
        lb, gb = res[b][:2]
        g_err = max(((ga[n] - g).abs().max() / g.abs().max()).item()
                    for n, g in gb.items())
        tag = f"{'/'.join(a)} vs {'/'.join(b)}"
        check(abs(la - lb) <= 1e-5 * abs(lb) and g_err <= 1e-3,
              f"dots small: {tag}: loss {la} vs {lb}, gradients "
              f"{g_err:.3e} of a leaf's largest entry")
        errs[tag] = {"loss_rel": abs(la - lb) / abs(lb), "grad_err": g_err}
    # (profiler, counter) launches of the forward and the backward
    (pf_full, f_full), (pb_full, b_full) = res[("cuda", "full")][2:]
    (pf_dots, f_dots), (pb_dots, b_dots) = res[("cuda", "dots")][2:]
    check(f_full == f_dots and b_full - b_dots == f_dots - 1
          and pb_dots < pb_full, f"dots small: GEMM launches forward "
          f"{f_full}/{f_dots}, backward full {b_full} vs dots {b_dots} "
          f"(want {f_dots - 1} fewer; profiler {pb_full} vs {pb_dots})")
    out = {"vs": errs, "launches": {"full": [f_full, b_full],
                                    "dots": [f_dots, b_dots]},
           "profiler": {"full": [pf_full, pb_full],
                        "dots": [pf_dots, pb_dots]}}
    print(f"[dots small] float32 llama3-8b smoke, one step: GEMM launches "
          f"forward {f_dots}, backward full {b_full} / dots {b_dots} (the "
          f"{f_dots - 1} layer forward products not relaunched); the "
          f"profiler's kernels: forward {pf_full}/{pf_dots}, backward "
          f"{pb_full}/{pb_dots}; " + "; ".join(
              f"{k}: loss {v['loss_rel']:.1e}, grads {v['grad_err']:.2e}"
              for k, v in errs.items()), flush=True)
    return out


def _train_counted(cfg, argv, what, per_step=None, log=None):
    """``launch.train.train`` of ``cfg`` with ``argv`` on the card,
    every step's GEMM launches (all, batched) counted: checks the losses
    finite, no plain call, equal launches every step (``per_step`` when
    given) and the peak below 80 GB. Returns (the run's numbers, the
    trained params, opt state)."""
    from repro_torch.kernels.matmul import matmul, matmul_batched
    from repro_torch.launch import train as tr
    from repro_torch.models import lm
    counts = []

    def count(step, params, metrics):
        counts.append((matmul.launches, matmul_batched.launches))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    matmul.launches = matmul.plain_calls = 0
    matmul_batched.launches = 0
    t0 = time.time()
    if log is None:
        res = tr.train(cfg, tr.parse_args(argv), on_step=count)
    else:
        with log:
            res = tr.train(cfg, tr.parse_args(argv), on_step=count)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for m in res["log"]]
    steps_s = [m["s"] for m in res["log"]]
    deltas = np.diff([(0, 0)] + counts, axis=0).tolist()
    check(all(np.isfinite(losses)), f"{what}: losses {losses}")
    check(matmul.plain_calls == 0 and all(d == deltas[0] for d in deltas)
          and (per_step is None or deltas[0][0] == per_step),
          f"{what}: GEMM launches (all, batched) per step {deltas} (want "
          f"{per_step}), {matmul.plain_calls} plain calls")
    check(peak_gb < 80, f"{what}: peak {peak_gb:.1f} GB")
    n_params = sum(p.numel() for q in lm.as_ranks(res["params"])
                   for p in q.parameters())
    step_s = float(np.mean(steps_s[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"params_per_rank_sum": n_params, "losses": losses,
           "step_s": steps_s, "ms_per_step": 1e3 * step_s,
           "tokens_per_s": tokens / step_s, "run_s": run_s,
           "peak_gb": peak_gb, "gemm_launches_per_step": deltas[0][0],
           "batched_launches_per_step": deltas[0][1],
           "aux": [m["aux"] for m in res["log"] if "aux" in m]}
    return out, res


def phase_dots_full(gen):
    """(17a, second part) 12c's configuration (llama3-8b at full width, 4
    of 32 layers, 2 x 1024 tokens, lr 1e-3) TP_FAM_STEPS steps under
    ``"full"`` and under ``"dots"`` (the config's ``remat_policy``, as
    JAX's perf harness reaches it), each from the same seeded init:
    losses finite and equal to 1e-3 relative between the policies (the
    same function; bf16 rounding aside), GEMM launches per step exact
    (``"full"``: 12c's 19 a layer + 3; ``"dots"``: 15 a layer + 3, no
    forward product relaunched), ms per step, peak memory (the run's,
    and one forward and backward's alone, where the saved outputs
    show), and one profiled step's GEMM device ms; the ``"dots"`` step's products timed
    (``log_times``) for the kernel line."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    L = TRAIN_LAYERS
    argv = ["--arch", "llama3-8b", "--steps", str(TP_FAM_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--warmup",
            str(TP_FAM_STEPS), "--lr", str(TRAIN_LR), "--log-every", "1",
            "--device", "cuda"]
    batch = shard_batch(SyntheticLM(get_config("llama3-8b").vocab_size,
                                    TRAIN_SEQ, TRAIN_BATCH, seed=0)
                        .batch_at(TP_FAM_STEPS), "cuda")
    out, logs = {}, {}
    for pol, per_step in (("full", L * 19 + 3), ("dots", L * 15 + 3)):
        cfg = get_config("llama3-8b").replace(n_layers=L, remat=True,
                                              remat_policy=pol)
        logs[pol] = ProductLog() if pol == "dots" else None
        run, res = _train_counted(cfg, argv, f"dots full {pol}", per_step,
                                  logs[pol])
        # the forward and backward alone (no optimizer step, the
        # gradients freed first): the activations' peak, remat's share
        params = res["params"]
        params.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        base_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        lm.loss_fn(params, batch, cfg)[0].backward()
        torch.cuda.synchronize()
        run["fwd_bwd_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        run["fwd_bwd_peak_over_base_gb"] = run["fwd_bwd_peak_gb"] - base_gb
        step_fn = steps_lib.make_train_step(cfg, adamw.AdamWConfig(
            lr=TRAIN_LR))
        wall, dev, gemm, calls = _profiled_gemm(step_fn, params,
                                                res["opt"], batch)
        run["profiled_step"] = {"wall_ms": wall, "device_ms": dev,
                                "gemm_ms": gemm, "gemm_calls": calls}
        out[pol] = run
        del res, step_fn, params
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    lf, ld = out["full"]["losses"], out["dots"]["losses"]
    check(np.allclose(ld, lf, rtol=1e-3, atol=0), f"dots full: losses dots "
          f"{ld} vs full {lf}")
    times = log_times(gen, logs["dots"], TP_FAM_STEPS, "dots full")
    check(times["launches_per_step"] == L * 15 + 3, f"dots full: logged "
          f"{times['launches_per_step']} launches a step")
    for pol in ("full", "dots"):
        r = out[pol]
        print(f"[dots full] llama3-8b, {L} of 32 layers, remat {pol}: "
              f"losses {[round(x, 4) for x in r['losses']]}; "
              f"{r['ms_per_step']:.1f} ms per step after step 0 "
              f"({r['tokens_per_s']:.0f} tokens/s); peak "
              f"{r['peak_gb']:.2f} GB (forward + backward alone "
              f"{r['fwd_bwd_peak_gb']:.2f} GB, "
              f"{r['fwd_bwd_peak_over_base_gb']:.2f} above the parameters "
              f"and optimizer state); {r['gemm_launches_per_step']} GEMM "
              f"launches a step; profiled step: wall "
              f"{r['profiled_step']['wall_ms']:.1f} ms, device "
              f"{r['profiled_step']['device_ms']:.1f} ms, GEMM "
              f"{r['profiled_step']['gemm_ms']:.1f} ms", flush=True)
    kernel = {"name": "matmul_train_dots", "route": "cuda",
              "source": "src/repro_torch/csrc/matmul.cu",
              "replaces": "src/repro/kernels/matmul.py:34",
              "launches": TP_FAM_STEPS * times["launches_per_step"],
              **{k: times[k] for k in ("launches_per_step", "max_abs_err",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")},
              "ms": out["dots"]["profiled_step"]["gemm_ms"],
              "kernel_ms_products": times["ms"],
              "unit": f"one training step of llama3-8b full width, {L} of "
                      f"32 layers, remat dots, "
                      f"{TRAIN_BATCH * TRAIN_SEQ} tokens"}
    print(f"[dots full] GEMM under dots a step: {kernel['ms']:.1f} ms "
          f"(profiled), {times['ms']:.1f} ms as its products timed alone, "
          f"plain {times['plain_ms']:.1f}, torch.matmul "
          f"{times['library_ms']:.1f}, bound {times['bound_ms']:.1f} ms",
          flush=True)
    return out, kernel


def tp_family_launches(cfg, W):
    """GEMM launches of one training step (remat full) over W > 1 ranks
    under ``ring`` (the sites' ``ring_bidir``: an up or down site is
    2 W^2 products, each a launch). Forward twice, then dA and dB of
    every forward launch. Attention 4 sites, an MLP 3; a Mamba2 layer
    in_proj and out_proj (2 sites); an MoE layer's router one product a
    rank and its experts 3 batched launches a rank; an RWKV6 block's
    time mix 7 products a rank (replicated), its ck one product a rank
    (the sequence already whole), cv one site; the unembed 3 a rank.
    Returns (all, batched)."""
    site = 2 * W * W
    if cfg.block == "attn_moe":
        layer, batched = 4 * (4 * site + W) + 4 * 3 * W, 4 * 3 * W
        return cfg.n_layers * layer + 3 * W, cfg.n_layers * batched
    if cfg.block == "mamba_hybrid":
        groups = cfg.n_layers // cfg.attn_every
        return (cfg.n_layers * 4 * 2 * site + groups * 4 * 7 * site
                + 3 * W), 0
    return cfg.n_layers * 4 * (8 * W + site) + 3 * W, 0


def phase_tp_families_small(tmp):
    """(17b) the float32 smoke models of olmoe, mixtral, zamba2 and
    rwkv6 (recurrent zero inits seeded nonzero) trained TP_FAM_STEPS
    steps over TP virtual ranks of cuda:0 under ``ring``, against tp TP
    on the CPU and tp 1 on the card from the same parameters and batches
    (lr 1e-4): the first loss within 1e-5 relative, losses within 1e-4,
    grad norms within 1e-2 (12b's, 13b's); every first-step gradient
    leaf (blocks joined, copies summed) within max(1e-3, 2 x the CPU's
    own gap under one float32 ulp of weight noise, 14d's and 15d's
    bound) of its largest |entry|; the GEMM launched (the batched mode
    for the MoE), no plain call on the card. zamba2's tp TP checkpoint
    after step 2 resumed at tp 1: the last loss within 1e-4 and every
    parameter leaf within 1e-2 of the norm of its three-step update
    (the CPU tests' bound across W) from the uninterrupted run's."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.context import Mesh
    from repro_torch.kernels.matmul import matmul, matmul_batched
    from repro_torch.launch import train as tr
    from repro_torch.models import lm
    out = {}
    for arch in TP_FAMILIES:
        cfg = smoke_config(get_config(arch)).replace(dtype=torch.float32)
        argv = ["--arch", arch, "--smoke", "--steps", str(TP_FAM_STEPS),
                "--batch", "2", "--seq", "32", "--log-every", "1", "--lr",
                "1e-4", "--warmup", "3", "--fusion-mode", TP_MODE]
        init = lm.init_params(cfg, seed=0, device="cpu", trainable=True)
        _unhide(init)
        grads = {}

        def first_grads(key):
            def keep(step, params, metrics):
                if step:
                    return
                # after the step every copy of a replicated leaf holds
                # the copies' summed gradient (apply_updates_ranks)
                ranks = lm.as_ranks(params)
                dims = lm.shard_dims(cfg, Mesh(["cpu"] * len(ranks)))
                per = [dict(p.named_parameters()) for p in ranks]
                grads[key] = {n: (per[0][n].grad.detach().cpu().clone()
                                  if d is None else
                                  torch.cat([q[n].grad.detach().cpu()
                                             for q in per], dim=d))
                              for n, d in dims.items()}
            return keep
        tp = ["--tp", str(TP)]
        ck = os.path.join(tmp, arch)
        runs = {"cpu4": tr.train(cfg, tr.parse_args(argv + tp + [
                    "--device", "cpu"]), params=_cpu_copy(init, cfg, "cpu"),
                    on_step=first_grads("cpu4")),
                "card1": tr.train(cfg, tr.parse_args(argv + [
                    "--device", "cuda"]), params=_cpu_copy(init, cfg, "cuda"),
                    on_step=first_grads("card1"))}
        n0, p0, b0 = (matmul.launches, matmul.plain_calls,
                      matmul_batched.launches)
        card = tr.train(cfg, tr.parse_args(argv + tp + [
            "--device", "cuda", "--ckpt-dir", ck, "--ckpt-every", "2"]),
            params=_cpu_copy(init, cfg, "cuda"), on_step=first_grads("card4"))
        launched, plain = matmul.launches - n0, matmul.plain_calls - p0
        batched = matmul_batched.launches - b0
        check(launched > 0 and plain == 0 and (batched > 0) == (
            cfg.block == "attn_moe"), f"{arch} tp small: {launched} GEMM "
            f"launches ({batched} batched), {plain} plain calls on the card")
        batch0 = {k: torch.from_numpy(np.array(v)) for k, v in SyntheticLM(
            cfg.vocab_size, 32, 2, seed=0).batch_at(0).items()}
        g_cpu1 = None
        sens = []
        for seed in [None, 0, 1, 2]:
            p = _cpu_copy(init, cfg, "cpu") if seed is None \
                else _ulp_noise(init, cfg, seed)
            loss, _ = lm.loss_fn(p, batch0, cfg)
            loss.backward()
            g = {n: t.grad for n, t in p.named_parameters()}
            if seed is None:
                g_cpu1 = g
                continue
            sens.append(max(((g[n] - g_cpu1[n]).abs().max()
                             / g_cpu1[n].abs().max()).item() for n in g))
        tol = max(1e-3, 2 * max(sens))
        l4 = [m["loss"] for m in card["log"]]
        gn4 = [m["grad_norm"] for m in card["log"]]
        errs = {}
        for other in ("cpu4", "card1"):
            lo = [m["loss"] for m in runs[other]["log"]]
            gno = [m["grad_norm"] for m in runs[other]["log"]]
            g_err = max(((grads["card4"][n] - g).abs().max()
                         / g.abs().max()).item()
                        for n, g in grads[other].items())
            check(abs(l4[0] - lo[0]) <= 1e-5 * abs(lo[0])
                  and np.allclose(l4, lo, rtol=1e-4, atol=0)
                  and np.allclose(gn4, gno, rtol=1e-2, atol=0),
                  f"{arch} tp small: losses {l4} vs {other} {lo}, grad "
                  f"norms {gn4} vs {gno}")
            check(g_err <= tol, f"{arch} tp small: step-1 gradients vs "
                                f"{other} {g_err:.3e} of a leaf's largest "
                                f"entry (bound {tol:.3e})")
            errs[other] = {"losses": lo, "grad_err": g_err}
        out[arch] = {"card_tp4_losses": l4, "vs": errs, "grad_bound": tol,
                     "cpu_noise_grad_err": sens, "gemm_launches": launched,
                     "batched_launches": batched}
        if arch.startswith("zamba2"):
            rdir = os.path.join(tmp, arch + "_resume")
            os.makedirs(rdir)
            shutil.copytree(os.path.join(ck, "step_00000002"),
                            os.path.join(rdir, "step_00000002"))
            res = tr.train(cfg, tr.parse_args(argv + [
                "--device", "cuda", "--ckpt-dir", rdir, "--resume"]),
                params=_cpu_copy(init, cfg, "cuda"))
            lr_ = [m["loss"] for m in res["log"]]
            full = lm.gather_params(card["params"], Mesh(["cuda"] * TP))
            start = dict(init.named_parameters())
            rel = max(((x.detach().cpu() - y.detach().cpu()).norm()
                       / (y.detach().cpu() - start[n]).norm()).item()
                      for (n, x), (_, y) in zip(
                          res["params"].named_parameters(),
                          full.named_parameters()))
            check(res["start_step"] == 2
                  and np.allclose(lr_, l4[2:], rtol=1e-4) and rel <= 1e-2,
                  f"{arch} tp small: resumed at tp 1 losses {lr_} vs tp "
                  f"{TP} {l4[2:]}; parameters {rel:.3e} of the update")
            out[arch].update(resume_tp1_losses=lr_,
                             resume_param_diff_over_update=rel)
        print(f"[tp families small] {arch} float32, tp {TP} on the card: "
              f"losses {l4}; step-1 gradients vs tp {TP} on the CPU "
              f"{errs['cpu4']['grad_err']:.3e}, vs tp 1 on the card "
              f"{errs['card1']['grad_err']:.3e} of a leaf's largest entry "
              f"(bound {tol:.2e}); {launched} GEMM launches ({batched} "
              f"batched)" + (f"; tp {TP} checkpoint resumed at tp 1: losses "
                             f"{out[arch]['resume_tp1_losses']}, parameters "
                             f"{out[arch]['resume_param_diff_over_update']:.2e}"
                             f" of the update" if arch.startswith("zamba2")
                             else ""), flush=True)
    return out


def phase_tp_families_full(gen):
    """(17c) olmoe-1b-7b (4 of 16 layers), zamba2-1.2b (all 38) and
    rwkv6-3b (12 of 32 blocks) at full width over TP virtual ranks of
    cuda:0 under ``ring``, bf16 compute, fp32 masters, AdamW, remat
    full: TP_FAM_STEPS steps of 2 x 1024 tokens through
    ``launch.train.train``: losses finite, GEMM (and batched) launches
    per step exact (``tp_family_launches``), no plain call, peak below 80
    GB, ms per step, tokens/s; every product of the step timed beside its
    plain version and ``torch.matmul``/``torch.bmm`` with its bound
    (``log_times``). Returns (numbers, kernel lines)."""
    from repro_torch.configs import get_config
    out, kernels = {}, []
    for arch, layers in TP_FAM_FULL:
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(n_layers=layers)
        per_step, per_b = tp_family_launches(cfg, TP)
        argv = ["--arch", arch, "--steps", str(TP_FAM_STEPS), "--batch",
                str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--warmup",
                str(TP_FAM_STEPS), "--lr", str(TRAIN_LR), "--log-every",
                "1", "--device", "cuda", "--tp", str(TP), "--fusion-mode",
                TP_MODE]
        log = ProductLog()
        run, res = _train_counted(cfg, argv, f"{arch} tp full", per_step,
                                  log)
        del res
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        check(run["batched_launches_per_step"] == per_b, f"{arch} tp full: "
              f"{run['batched_launches_per_step']} batched launches a step "
              f"(want {per_b})")
        times = log_times(gen, log, TP_FAM_STEPS, f"{arch} tp full")
        check(times["launches_per_step"] == per_step, f"{arch} tp full: "
              f"logged {times['launches_per_step']} launches a step")
        tag = arch.split("-")[0]
        run["config"] = (f"{arch} full width, {cfg.n_layers} of "
                         f"{get_config(arch).n_layers} layers, tp {TP} "
                         f"{TP_MODE}, bf16 compute, fp32 masters, remat full")
        run["products"] = times
        out[arch] = run
        kernels.append({
            "name": f"matmul_train_tp{TP}_{tag}", "route": "cuda",
            "source": "src/repro_torch/csrc/matmul.cu",
            "replaces": "src/repro/kernels/matmul.py:34",
            "launches": TP_FAM_STEPS * per_step, "launches_per_step":
            per_step, "batched_launches_per_step": per_b,
            **{k: times[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms",
                                     "max_abs_err")},
            "unit": f"one training step of {run['config']}, "
                    f"{TRAIN_BATCH * TRAIN_SEQ} tokens: its "
                    f"{times['distinct']} distinct products timed alone"})
        print(f"[tp families full] {run['config']}: losses "
              f"{[round(x, 4) for x in run['losses']]}"
              + (f", aux {[round(x, 4) for x in run['aux']]}" if run["aux"]
                 else "") + f"; {run['ms_per_step']:.1f} ms per step after "
              f"step 0 ({run['tokens_per_s']:.0f} tokens/s); peak "
              f"{run['peak_gb']:.2f} GB; {per_step} GEMM launches a step "
              f"({per_b} batched); its products alone {times['ms']:.1f} ms "
              f"(plain {times['plain_ms']:.1f}, library "
              f"{times['library_ms']:.1f}, bound {times['bound_ms']:.1f} "
              f"{times['bound_by']})", flush=True)
    return out, kernels


def phase_dots_and_tp_families(gen):
    """(17) 17a-17c, each sub-phase's seconds kept; frees what it made.
    Returns (numbers, kernel lines: PERF.md's rows 1t-dots, 1e-tp,
    1z-tp, 1r-tp)."""
    import gc
    secs = {}
    tmp = os.path.join(ROOT, "build", "chip_smoke_tp_families")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)

    def sub(name, fn, *args):
        t0 = time.time()
        res = fn(*args)
        secs[name] = time.time() - t0
        gc.collect()
        torch.cuda.empty_cache()
        return res
    small = sub("17a small", phase_dots_small)
    dots, dots_kernel = sub("17a full", phase_dots_full, gen)
    fam_small = sub("17b", phase_tp_families_small, tmp)
    fam_full, fam_kernels = sub("17c", phase_tp_families_full, gen)
    shutil.rmtree(tmp, ignore_errors=True)
    print("[phase 17] " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                   secs.items()), flush=True)
    return {"dots_small": small, "dots_full": dots,
            "tp_small": fam_small, "tp_full": fam_full,
            "phase_s": secs}, [dots_kernel] + fam_kernels


def sampler_ms(gen, B=8, V=128256):
    """Device ms of one sampling step at the full-width serve's shapes
    (batch 8, vocab 128256, bf16 logits), in CUDA-graph replays: greedy,
    and the seeded temperature sampler (plain PyTorch ops: the threefry
    keys and bits, the float32 Gumbel logs, the per-row top-k sort)
    with no truncation and with top_k 50 on half the rows."""
    from repro_torch.serving import sampler as sl
    logits = torch.randn((B, 1, V), generator=gen, device="cuda").to(
        torch.bfloat16)
    key = sl.prng_key(0, "cuda")
    rids = torch.arange(B, dtype=torch.int32, device="cuda")
    steps = torch.full((B,), 17, dtype=torch.int32, device="cuda")
    temps = torch.full((B,), 0.8, dtype=torch.float32, device="cuda")
    topks = torch.tensor([0, 50] * (B // 2), dtype=torch.int32,
                         device="cuda")
    out = {"batch": B, "vocab": V,
           "greedy_ms": graph_ms(lambda: sl.greedy(logits), iters=50),
           "temperature_ms": graph_ms(lambda: sl.sample_batch(
               logits, key, rids, steps, temps, topks), iters=20),
           "temperature_eager_ms": time_ms(lambda: sl.sample_batch(
               logits, key, rids, steps, temps, topks), iters=20)}
    print(f"[sampler] ms per step at batch {B} x vocab {V}: greedy "
          f"{out['greedy_ms']:.4f}, temperature {out['temperature_ms']:.4f} "
          f"(eager {out['temperature_eager_ms']:.4f})", flush=True)
    return out


# ------------------------------------- phase 18: the dry run vs the card
PRED_PEAK_RTOL = 0.15       # predicted per-rank peak vs max_memory_allocated
PRED_FLOPS_RTOL = 0.02      # traced FLOPs vs the phase's executed count


def launch_costs(iters=2000, reps=5):
    """The card's fixed costs for the three-taxes model
    (``core.taxes.HW``): an empty kernel's launch as the host issues it
    back to back (wall time per launch over ``iters`` launches, the least
    of ``reps`` runs) and its device time in a CUDA graph; and one
    global barrier of the port's ``bsp`` schedule at a site with no
    bytes, over 4 virtual ranks (``cm.all_gather`` of one element a rank:
    its host loop and copies; no straggler wait across distinct cards)."""
    from repro_torch.core import collective_matmul as cm
    from repro_torch.kernels import _build
    empty = _build.load("flash_decode_paged").symm_empty_launch
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        _build.check(empty(1, 32, stream), "symm_empty_launch")

    def per_call_s(fn, n):
        fn()
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best / n
    x = [torch.zeros((1, 1), dtype=torch.bfloat16, device="cuda")
         for _ in range(4)]
    out = {"kernel_launch_s": per_call_s(launch, iters),
           "empty_kernel_device_s": 1e-3 * graph_ms(launch, iters=50),
           "barrier_skew_s": per_call_s(lambda: cm.all_gather(x), iters // 4)}
    # a 2 GB device-to-device copy: bytes read and written over the time
    src = torch.empty(2 * 10**9, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    t = time_ms(lambda: dst.copy_(src), iters=5, warmup=2)
    out["copy_2gb_ms"] = t
    out["copy_bytes_per_s"] = 2 * src.numel() / (t / 1e3)
    out["hbm_bytes_per_s_datasheet"] = _hw().H100.hbm_bw
    del src, dst
    torch.cuda.empty_cache()
    return out


def phase_dryrun(smi, train, train_tp, moe, front, fam, serve, host_us,
                 sharded):
    """(18) the port's dry run (``launch.dryrun``: the step traced on fake
    CPU tensors, at the phase's own depth) beside what earlier phases
    measured on the card, reusing their stored numbers: 12c (llama3-8b,
    4 layers, ``"full"``; 17a's ``"dots"``), 13c (tp 4 virtual ranks
    under ``ring``), 14d (olmoe-1b-7b, 4 layers), 16d (paligemma-3b,
    hubert-xlarge), phase 5's K = 1 serve (a decode step at batch 8
    over a cache of 512) and phase 20's serve on shards (a decode step at
    batch 4 over a cache of 256 on 4 virtual ranks under ``pallas``, the
    card's peak less the replicated weights resident beside it). Per-rank
    peak vs ``max_memory_allocated``
    (within PRED_PEAK_RTOL where one rank per card), FLOPs vs the phase's
    executed count (12c, 14d: PRED_FLOPS_RTOL), and the bound vs the
    measured ms (the step's share of its bound). Then the three-taxes
    model's fixed costs measured (``launch_costs``) beside
    ``core.taxes.H100``'s, the GEMM wrapper's fixed host cost from phase
    6 and a 2 GB copy's rate beside the data sheet's."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import taxes
    from repro_torch.launch import dryrun
    train_sh = ShapeConfig("train_2x1024", TRAIN_SEQ, TRAIN_BATCH, "train")
    llama4 = get_config("llama3-8b").replace(n_layers=TRAIN_LAYERS)
    front_sh = ShapeConfig("train_2x1024", TRAIN_SEQ, TRAIN_BATCH, "train")
    k8 = serve["k8"]
    cases = [
        ("12c", llama4, train_sh, 1, "auto", train["full"], True),
        ("17a dots", llama4.replace(remat_policy="dots"), train_sh, 1,
         "auto", fam["dots_full"]["dots"], False),
        ("13c", llama4, train_sh, TP, TP_MODE, train_tp["full"], False),
        ("14d", get_config(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS),
         train_sh, 1, "auto", moe["train_full"], True),
        ("16d paligemma-3b", get_config("paligemma-3b"), front_sh, 1,
         "auto", front["train_paligemma-3b"], False),
        ("16d hubert-xlarge", get_config("hubert-xlarge"), front_sh, 1,
         "auto", front["train_hubert-xlarge"], False),
        ("5 serve", get_config("llama3-8b"),
         ShapeConfig("decode_8x512", 512, 8, "decode"), 1, "auto",
         {"peak_gb": serve["k1"]["peak_mem_bytes"] / 1e9,
          "ms_per_step": k8["pure_megatick_device_ms"] / k8["K"]}, False),
        ("20 serve on shards", get_config("llama3-8b"),
         ShapeConfig("decode_4x256", 256, 4, "decode"), SHARD_TP, "pallas",
         {"peak_gb": sharded["cells"]["pallas"]["peak_mem_bytes"] / 1e9
          - sharded["whole_gb"],
          "ms_per_step": sharded["cells"]["pallas"][
              "pure_megatick_device_ms"] / 8}, False),
    ]
    rows = []
    for name, cfg, shape, tp, mode, card, flops_checked in cases:
        t0 = time.time()
        rec = dryrun.run_cell_cfg(cfg, shape, tp, mode, virtual=tp > 1,
                                  direct=True)
        check(rec["status"] == "ok", f"dry run {name}: {rec}")
        pred_gb = rec["memory"]["peak_bytes"] / 1e9
        # the bound on the analytic memory term (``bound_s_star``): the
        # traced bytes count every unfused op's operands
        bound_ms = 1e3 * rec["roofline"]["bound_s_star"]
        row = {"case": name, "tp": tp, "fusion_mode": mode,
               "trace_s": time.time() - t0,
               "pred_peak_gb": pred_gb, "card_peak_gb": card["peak_gb"],
               "peak_rel": pred_gb / card["peak_gb"] - 1,
               "pred_flops": rec["cost"]["flops_all_ranks"],
               "card_flops": card.get("flops_per_step"),
               "bound_ms": bound_ms,
               "dominant": rec["roofline"]["dominant_star"],
               "bound_counted_ms": 1e3 * rec["roofline"]["bound_s"],
               "card_ms": card["ms_per_step"],
               "share_of_bound": bound_ms / card["ms_per_step"]}
        if row["card_flops"]:
            row["flops_rel"] = row["pred_flops"] / row["card_flops"] - 1
        rows.append(row)
        where = "" if tp == 1 else " on one card"
        print(f"[dryrun vs card] {name} (tp {tp}{where}): "
              f"peak predicted {pred_gb:.2f} GB, card {card['peak_gb']:.2f}"
              f" ({100 * row['peak_rel']:+.1f}%); FLOPs predicted "
              f"{row['pred_flops']:.4e}"
              + (f", executed {row['card_flops']:.4e} "
                 f"({100 * row['flops_rel']:+.2f}%)" if row['card_flops']
                 else "")
              + f"; bound* {bound_ms:.2f} ms ({row['dominant']}), card "
              f"{row['card_ms']:.2f} ms (the bound "
              f"{100 * row['share_of_bound']:.1f}% of it); traced in "
              f"{row['trace_s']:.1f} s", flush=True)
        if tp == 1:
            check(abs(row["peak_rel"]) <= PRED_PEAK_RTOL,
                  f"dry run {name}: peak {pred_gb:.2f} GB predicted, "
                  f"{card['peak_gb']:.2f} on the card")
        if flops_checked:
            check(abs(row["flops_rel"]) <= PRED_FLOPS_RTOL,
                  f"dry run {name}: FLOPs {row['pred_flops']:.4e} "
                  f"predicted, {row['card_flops']:.4e} executed")
    costs = launch_costs()
    hw = taxes.H100
    costs.update({"gemm_host_us_per_call": host_us["matmul wk"],
                  "gemm_launch_us_per_call": host_us["launch wk"],
                  "hw_kernel_launch_s": hw.kernel_launch,
                  "hw_barrier_skew_s": hw.barrier_skew, "device": smi})
    print(f"[taxes] {smi}: kernel launch {1e6 * costs['kernel_launch_s']:.2f}"
          f" us (core.taxes.H100 {1e6 * hw.kernel_launch:.2f}; the empty "
          f"kernel's device time {1e6 * costs['empty_kernel_device_s']:.2f} "
          f"us; the GEMM wrapper's call {costs['gemm_host_us_per_call']:.1f}"
          f" us, its launch {costs['gemm_launch_us_per_call']:.1f}); bsp "
          f"barrier at no bytes over 4 virtual ranks "
          f"{1e6 * costs['barrier_skew_s']:.2f} us (core.taxes.H100 "
          f"{1e6 * hw.barrier_skew:.2f}); 2 GB copy {costs['copy_2gb_ms']:.3f}"
          f" ms: {costs['copy_bytes_per_s'] / 1e12:.3f} TB/s read + write "
          f"(data sheet {costs['hbm_bytes_per_s_datasheet'] / 1e12:.2f})",
          flush=True)
    return {"cases": rows, "taxes": costs}


# ------------------------------------------- phase 20: sharded weights
SHARD_TP = 4                # virtual ranks of cuda:0 holding the shards


def sharded_per_step(cfg, mode="pallas", tp=SHARD_TP):
    """Kernel launches of one decode step over ``tp`` ranks on one card
    on per-rank shards (``lm.shard_params``; paged pool): column-parallel
    groups one GEMM a rank (q/k/v, the gate and up projections, the
    Mamba2 in_proj, RWKV6's ck, the unembed over its vocab shard); under
    ``pallas`` each row-parallel weight (wo, wd, out_proj) one fused
    AG+GEMM on the card, under ``auto`` one partial GEMM a rank; the
    MoE router once a card, its experts one batched launch a product a
    rank; RWKV6's time mix once a card (7 products), its cv one partial
    GEMM a rank; attention one paged decode a card a call (fused under
    ``pallas``, partial under ``auto``)."""
    L = cfg.n_layers
    row = {"pallas": 0, "auto": tp}[mode]
    attn = "flash_decode_paged_fused" if mode == "pallas" else \
        "flash_decode_paged_partial"
    if cfg.block == "rwkv":
        return {"matmul": L * (7 + 2 * tp) + tp}
    if cfg.block == "mamba_hybrid":
        calls = L // cfg.attn_every
        out = {"matmul": L * (tp + row) + calls * (2 * tp + 2 * row) + tp,
               attn: calls}
        n_ag = L + 2 * calls
    elif cfg.block == "attn_moe":
        out = {"matmul": L * (tp + row + 1 + 3 * tp) + tp,
               "matmul_batched": 3 * tp * L, attn: L}
        n_ag = L
    else:
        out = {"matmul": L * (2 * tp + 2 * row) + tp, attn: L}
        n_ag = 2 * L
    if mode == "pallas":
        out["ag_gemm_fused"] = n_ag
    return out


def _resident_gb(ranks):
    """GB of the distinct tensors ``ranks`` (LMs) hold (a replicated leaf
    that ranks on one card share counts once)."""
    seen, n = set(), 0
    for p in ranks:
        for t in p.parameters():
            if t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                n += t.numel() * t.element_size()
    return n / 1e9


def _shard(params, tp=SHARD_TP):
    """(mesh, per-rank shards of ``params``, their bytes): every rank
    must hold 1/tp of each leaf the rules shard and the whole of each
    they replicate, no more."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.module import tree_items
    mesh = make_mesh(tp, device="cuda")
    t0 = time.time()
    shards = lm.shard_params(params, mesh)
    torch.cuda.synchronize()
    dims = lm.shard_dims(params.cfg, mesh)
    leaves = dict(tree_items(lm.param_tree(params)))
    nb = {k: t.numel() * t.element_size() for k, t in leaves.items()}
    rep = sum(n for k, n in nb.items() if dims[k] is None)
    want = sum(n // tp if dims[k] is not None else n for k, n in nb.items())
    mem = {"shard_s": time.time() - t0, "whole_gb": _resident_gb([params]),
           "sharded_leaves_gb": (sum(nb.values()) - rep) / 1e9,
           "replicated_leaves_gb": rep / 1e9, "rank_gb_expected": want / 1e9,
           "rank_gb": [_resident_gb([s]) for s in shards],
           "card_gb": _resident_gb(shards)}
    check(all(abs(g - want / 1e9) < 1e-9 for g in mem["rank_gb"]),
          f"shards: {mem['rank_gb']} GB a rank, expected {want / 1e9:.6f} "
          f"(1/{tp} of the sharded leaves + the replicated ones)")
    return mesh, shards, mem


def sharded_steps(params, cfg, label, tp=SHARD_TP):
    """(20, other families) a full-width model whose phase loaded
    ``params`` (bf16, seed 0) sharded over ``tp`` virtual ranks (each
    rank's resident GB, 1/tp of the sharded leaves); one teacher-forced
    chunk (4 slots x 8 tokens over the paged pool, every rank's blocks)
    under ``pallas`` on the shards with every kernel's launches counted
    around it, exact per decode step (:func:`sharded_per_step`); its
    logits against tp 1 on ``params`` within the bf16 model's own error
    (tp 1 against the same numbers unrounded in float32, phase 9's
    bound; with random weights that bound is wide), and the tight check:
    the model at full width in float32, cut to 2 layers (zamba2: one
    group of ``attn_every``, so its shared block runs), on its shards
    under ``pallas`` and ``auto`` against tp 1 within one bf16 ulp
    (:func:`_f32_cut`)."""
    from repro_torch.distributed import context as dctx
    from repro_torch.models import lm
    from repro_torch.serving.graphs import launch_counted
    mesh, shards, mem = _shard(params, tp)
    g = torch.Generator(device="cuda")
    g.manual_seed(20)
    tok = torch.randint(1, cfg.vocab_size, (4, 8), device="cuda",
                        generator=g)
    fns = launch_counted()
    torch.cuda.synchronize()
    _counted(fns)
    t0 = time.time()
    lg_s = _teacher_forced(shards, cfg, tok, dctx.DistContext(mesh,
                                                              "pallas"))
    torch.cuda.synchronize()
    step_s = (time.time() - t0) / 8
    launches = {f.__name__: f.launches for f in fns if f.launches}
    plain = {f.__name__: f.plain_calls for f in fns if f.plain_calls}
    want = {k: 8 * v for k, v in sharded_per_step(cfg, "pallas", tp).items()}
    check(launches == want and not plain,
          f"{label} shards: launches {launches} != {want} in 8 steps "
          f"(plain calls {plain})")
    del shards
    torch.cuda.empty_cache()
    lg_1 = _teacher_forced(params, cfg, tok, None)
    cfg32 = cfg.replace(dtype=torch.float32)
    p32 = lm.init_params(cfg32, seed=0, device="cuda")
    lg_32 = _teacher_forced(p32, cfg32, tok, None)
    del p32
    torch.cuda.empty_cache()
    diff = (lg_s - lg_1).abs().max().item()
    own = (lg_1 - lg_32).abs().max().item()
    top = (lg_s.argmax(-1) == lg_1.argmax(-1)).float().mean().item()
    top_own = (lg_32.argmax(-1) == lg_1.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(lg_s).all()), f"{label} shards: non-finite")
    check(diff <= own, f"{label} shards tp={tp} vs tp=1 logits: max |diff| "
                       f"{diff:.3e} > the bf16 model's own error {own:.3e}")
    layers = cfg.attn_every if cfg.block == "mamba_hybrid" else 2
    f32 = _f32_cut(cfg.name, tp, layers)
    out = {**mem, "tp": tp, "fusion_mode": "pallas", "launches_8_steps":
           launches, "eager_step_s": step_s, "max_abs_diff_vs_tp1": diff,
           "f32_cut": f32,
           "bf16_vs_f32_max_abs_diff": own, "argmax_agree": top,
           "argmax_agree_bf16_vs_f32": top_own,
           "max_abs_logit": lg_1.abs().max().item()}
    print(f"[sharded {label}] tp={tp} pallas: {mem['whole_gb']:.3f} GB "
          f"whole, a rank " + ", ".join(f"{x:.3f}" for x in mem["rank_gb"])
          + f" GB (card {mem['card_gb']:.3f}); launches a step "
          f"{sharded_per_step(cfg, 'pallas', tp)}; teacher-forced logits "
          f"vs tp=1 max |diff| {diff:.3e} (bf16 vs float32 weights "
          f"{own:.3e}, max |logit| {out['max_abs_logit']:.3e}), argmax "
          f"agree {top:.3f} (bf16 vs float32 weights {top_own:.3f}); "
          f"float32 at {layers} layers vs tp=1 max |diff| " + ", ".join(
              f"{m} {v:.3e}" for m, v in f32["max_abs_diff"].items())
          + " (one bf16 ulp)", flush=True)
    return out


def _serve_streams(params, cfg, ctx, reqs):
    """Greedy streams of ``reqs`` served through the engine at K = 8
    (paged pool, batch 4; graph replays on one card) under ``ctx``
    (None: one rank): {rid: tokens}; no stream may end in error."""
    from repro_torch.distributed import context as dctx
    from repro_torch.serving.engine import Engine, Request
    with dctx.use(ctx or dctx.DistContext()):
        eng = Engine(params, cfg, batch=4, max_len=256, block_size=16,
                     prefill_chunk=8, decode_steps=8, device="cuda")
    for rid, (prompt, max_new, at) in enumerate(reqs):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new),
                   at_tick=at)
    done = []
    while eng.queue or eng.active:
        done += eng.tick()
    check(len(done) == len(reqs)
          and all(r.finish_reason != "error" for r in done),
          f"{cfg.name} float32 streams: {len(done)} of {len(reqs)} done, "
          f"{[r.finish_reason for r in done]}")
    return {r.rid: r.out_tokens for r in done}


def _f32_cut(arch, tp=SHARD_TP, layers=2, streams=False, data=1):
    """``arch`` at full width, cut to ``layers`` layers, in float32
    (seeded): one teacher-forced chunk (4 slots x 8 tokens) on its
    shards (over ``tp`` model ranks, or a (``data``, ``tp``) mesh of
    virtual ranks, weights-stationary) under ``pallas`` and ``auto``
    against tp 1 within one bf16 ulp (2**-7 relative; 1e-4), phase 9's
    float32 bound: a wrong block offset, gather, dropped partial sum or
    join over ``data`` shows far above it. With
    ``streams``: 4 requests' greedy streams (16 new tokens each) served
    through the engine at K = 8 on the shards in both modes must be
    token-identical to tp 1's. Returns the max |diff| per mode (and the
    streams)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import context as dctx
    from repro_torch.models import lm
    cfg = get_config(arch).replace(n_layers=layers, dtype=torch.float32)
    g = torch.Generator(device="cuda")
    g.manual_seed(22)
    tok = torch.randint(1, cfg.vocab_size, (4, 8), device="cuda",
                        generator=g)
    p32 = lm.init_params(cfg, seed=0, device="cuda")
    want = _teacher_forced(p32, cfg, tok, None)
    if data > 1:
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(tp, ["cuda:0"] * (data * tp))
        shards = lm.shard_params(p32, mesh)
    else:
        mesh, shards, _ = _shard(p32, tp)
    out = {"layers": layers, "mesh": dict(mesh.shape), "max_abs_diff": {}}
    for mode in ("pallas", "auto"):
        got = _teacher_forced(shards, cfg, tok, dctx.DistContext(mesh, mode))
        d = (got - want).abs()
        out["max_abs_diff"][mode] = d.max().item()
        check(bool((d <= 1e-4 + 2 ** -7 * want.abs()).all()),
              f"{arch} float32 {layers} layers shards on {mesh.shape} "
              f"{mode} vs tp=1: max |diff| "
              f"{out['max_abs_diff'][mode]:.3e}")
    if streams:
        plens = [int(n) for n in np.random.default_rng(2).integers(16, 49,
                                                                   4)]
        reqs = _full_requests(cfg, plens, 5, 16, 1)
        ref = _serve_streams(p32, cfg, None, reqs)
        out["streams_tp1"] = ref
        for mode in ("pallas", "auto"):
            got = _serve_streams(shards, cfg, dctx.DistContext(mesh, mode),
                                 reqs)
            check(got == ref, f"{arch} float32 {layers} layers: streams "
                              f"on shards under {mode} {got} != tp=1's "
                              f"{ref}")
        out["streams_identical"] = len(ref)
    del p32, shards
    torch.cuda.empty_cache()
    return out


def _gemm_io_bytes(a, ws, out_dtype):
    """Bytes one GEMM launch moves: ``a`` read once, each of ``ws`` read
    once, each output (M x N_i in ``out_dtype``) written once."""
    M = a.shape[0]
    return nbytes(a, *ws) + sum(M * w.shape[-1] for w in ws) * \
        torch.empty((), dtype=out_dtype).element_size()


def shard_kernel_rows(params, shards, cfg, launches, steps, tp=SHARD_TP,
                      B=4):
    """(20) the GEMM (#1) and the fused AG+GEMM (#4) as they run on
    llama3-8b's weight shards under ``pallas``: one decode step of
    phase 20's serve (batch 4) over the real shards of every layer (no
    weight read twice a step, as on the main path): a layer's wq/wk/wv
    and wg/wu column blocks one launch each a rank, the unembed over
    each rank's fp32 vocab shard (``trans_b``); a layer's wo and wd
    (gathered whole, phase 5's copy: the same numbers) one fused
    AG+GEMM each on the K-slices of the ranks' inputs. Each graph-timed
    (the whole step's launches in one graph), beside the plain versions
    (eager), one ``torch.matmul`` a product, the bound from the bytes
    the launches read and write, and layer 0's products held to their
    plain versions (``_gemm_err``: bf16 within one ulp, fp32 within
    1e-4 of the largest |C|); the gather of the row blocks (``torch.cat``, which
    ``core.patterns`` runs in front of #4) timed the same way.
    ``launches``/``steps``: the main path's counts (phase 20's
    ``pallas`` cell)."""
    from repro_torch.distributed.context import Mesh
    from repro_torch.kernels.ag_gemm import ag_gemm_fused, ag_gemm_plain
    from repro_torch.kernels.matmul import (matmul, matmul_group,
                                            matmul_plain)
    L, d = cfg.n_layers, cfg.d_model
    bf16 = torch.bfloat16
    mesh = Mesh(["cuda:0"] * tp)
    g = torch.Generator(device="cuda")
    g.manual_seed(23)
    a = torch.randn((B, d), generator=g, device="cuda").to(bf16)
    h = torch.randn((B, cfg.d_ff), generator=g, device="cuda").to(bf16)
    af = a.float()
    lay = [s["backbone"]["layers"] for s in shards]
    cols = [([x["attn"][n][li] for n in ("wq", "wk", "wv")],
             [x["mlp"][n][li] for n in ("wg", "wu")])
            for li in range(L) for x in lay]
    heads = [s["head"]["table"] for s in shards]

    def gemm_step(one, unembed):
        for qkv, gu in cols:
            one(qkv)
            one(gu)
        for t in heads:
            unembed(t)

    def lib_one(ws):
        return [torch.matmul(a, w) for w in ws]
    t_k = graph_ms(lambda: gemm_step(lambda ws: matmul_group(a, ws),
                                     lambda t: matmul(af, t, trans_b=True)),
                   iters=1)
    t_l = graph_ms(lambda: gemm_step(lib_one,
                                     lambda t: torch.matmul(af, t.T)),
                   iters=1)
    t_p = time_ms(lambda: gemm_step(
        lambda ws: [matmul_plain(a, w) for w in ws],
        lambda t: matmul_plain(af, t, True)), iters=2, warmup=1)
    err = max([_gemm_err(x, matmul_plain(a, w), bf16,
                         f"matmul on shards {tuple(w.shape)}")
               for ws in cols[0] for x, w in zip(matmul_group(a, ws), ws)]
              + [_gemm_err(matmul(af, heads[0], trans_b=True),
                           matmul_plain(af, heads[0], True), torch.float32,
                           "matmul on the head's vocab shard")])
    by = sum(_gemm_io_bytes(a, ws, bf16) for c in cols for ws in c) + \
        sum(nbytes(af, t) + B * t.shape[0] * 4 for t in heads)
    ops = [(sum(2 * B * w.numel() for c in cols for ws in c for w in ws),
            bf16), (sum(2 * B * t.numel() for t in heads), torch.float32)]
    b_s, b_by = bound(ops, by)
    gemm = {"name": "matmul_shards", "route": "cuda",
            "source": "src/repro_torch/csrc/matmul.cu",
            "replaces": "src/repro/kernels/matmul.py:34",
            "launches": launches["matmul"],
            "launches_per_step": launches["matmul"] / steps,
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": 1e3 * b_s, "bound_by": b_by, "bytes": by,
            "library_ms": t_l,
            "unit": f"one decode step at batch {B} on llama3-8b's shards "
                    f"over {tp} ranks ({len(cols) * 2 + len(heads)} "
                    f"launches: per layer and rank wq/wk/wv and wg/wu "
                    f"column blocks grouped; the unembed's vocab shard a "
                    f"rank)"}
    # the row-parallel site: wo and wd whole (what the gather makes)
    whole = params["backbone"]["layers"]
    rows = [(a, whole["attn"]["wo"][li]) for li in range(L)] + \
        [(h, whole["mlp"]["wd"][li]) for li in range(L)]
    sl = [[x[:, r * (x.shape[1] // tp):(r + 1) * (x.shape[1] // tp)]
           .contiguous() for r in range(tp)] for x in (a, h)]

    def k_slices(x):
        return sl[0] if x is a else sl[1]
    t_k = graph_ms(lambda: [ag_gemm_fused(k_slices(x), [w] * tp, mesh)
                            for x, w in rows], iters=1)
    t_l = graph_ms(lambda: [torch.matmul(x, w) for x, w in rows], iters=1)
    t_p = time_ms(lambda: [ag_gemm_plain(k_slices(x), [w] * tp)
                           for x, w in rows], iters=2, warmup=1)
    err = max(_gemm_err(u, v, bf16, f"ag_gemm_fused {tuple(w.shape)}")
              for x, w in (rows[0], rows[L]) for u, v in
              zip(ag_gemm_fused(k_slices(x), [w] * tp, mesh),
                  ag_gemm_plain(k_slices(x), [w] * tp)))
    by = sum(nbytes(x, w) + tp * B * w.shape[1] * 2 for x, w in rows)
    b_s, b_by = bound(sum(tp * 2 * B * w.numel() for _, w in rows), by,
                      bf16)
    blocks = [[x["attn"]["wo"][li] for x in lay] for li in range(L)] + \
        [[x["mlp"]["wd"][li] for x in lay] for li in range(L)]
    t_gather = graph_ms(lambda: [torch.cat(w, dim=0) for w in blocks],
                        iters=1)
    ag = {"name": "ag_gemm_fused_shards", "route": "cuda",
          "source": "src/repro_torch/csrc/ag_gemm.cu",
          "replaces": "src/repro/kernels/ag_gemm.py:114",
          "launches": launches["ag_gemm_fused"],
          "launches_per_step": launches["ag_gemm_fused"] / steps,
          "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
          "bound_ms": 1e3 * b_s, "bound_by": b_by, "bytes": by,
          "library_ms": t_l, "gather_ms": t_gather,
          "gather_bytes": sum(nbytes(*w) for w in blocks),
          "unit": f"one decode step at batch {B} over {tp} ranks: per "
                  f"layer wo ({B}x{d} . {d}x{d}) and wd ({B}x{cfg.d_ff} . "
                  f"{cfg.d_ff}x{d}) gathered whole from their row blocks "
                  f"(the gather: gather_ms)"}
    for k in (gemm, ag):
        print(f"[sharded kernels] {k['name']}: {k['ms']:.3f} ms a step "
              f"(bound {k['bound_ms']:.3f} {k['bound_by']}, "
              f"{k['bytes'] / 1e9:.3f} GB; plain {k['plain_ms']:.3f}, "
              f"torch.matmul {k['library_ms']:.3f}; max |err| "
              f"{k['max_abs_err']:.3e})", flush=True)
    print(f"[sharded kernels] the row blocks' gather: {t_gather:.3f} ms a "
          f"step ({ag['gather_bytes'] / 1e9:.3f} GB)", flush=True)
    return [gemm, ag]


def phase_sharded(params, tp9, tp=SHARD_TP):
    """(20) full-width llama3-8b (phase 5's bf16 weights) sharded over
    ``tp`` virtual ranks of cuda:0 (JAX's serve step on
    ``param_shardings``): each rank's resident GB (1/tp of the sharded
    leaves) and the card's; phase 9's traffic served through the engine
    on the shards at K = 8 (graph replays, then the steady rerun) under
    ``pallas`` (each row-parallel weight all-gathered into the fused
    AG+GEMM) and ``auto`` (partial products, all-reduced), launches
    exact a step (:func:`sharded_per_step`), no stream in error, the
    first token of every stream equal to phase 9's replicated tp 4
    streams' where tp 1's top-2 margin is decisive (reported: with
    random weights no margin has been; the float32 cut below is the
    stream check that binds); the GEMM and the fused AG+GEMM graph-timed
    on the shards (:func:`shard_kernel_rows`); teacher-forced logits on
    the shards in both modes against tp 1 within the bf16 model's own
    error (phase 9's); in float32 at 2 layers within one bf16 ulp, and
    the engine's greedy streams at K = 8 on the shards token-identical
    to tp 1's (:func:`_f32_cut`); and
    ``steps.jitted_serve_step``'s function over the contiguous state, 4
    steps at tp 4 on the shards against tp 1 (launches exact: the fused
    strided decode once a card a layer)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import context as dctx
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.serving.graphs import launch_counted
    cfg = get_config("llama3-8b")
    L = cfg.n_layers
    parts_s = {}
    t_part = [time.time()]

    def part(name):
        now = time.time()
        parts_s[name] = now - t_part[0]
        t_part[0] = now
    mesh, shards, mem = _shard(params, tp)
    print(f"[sharded] llama3-8b over {tp} ranks of one card: whole "
          f"{mem['whole_gb']:.3f} GB, a rank " + ", ".join(
              f"{x:.3f}" for x in mem["rank_gb"]) + f" GB, the shards on "
          f"the card {mem['card_gb']:.3f} GB (cut in {mem['shard_s']:.2f} "
          f"s)", flush=True)
    plens = [int(n) for n in np.random.default_rng(1).integers(16, 49, 4)]
    reqs_a = _full_requests(cfg, plens, 3, 16, 1)
    reqs_b = _full_requests(cfg, plens, 4, 16, 1)
    want9 = {int(k): v for k, v in tp9["streams_k8"].items()}
    # teacher forcing against tp 1 (bf16: phase 9's bound) and float32
    g = torch.Generator(device="cuda")
    g.manual_seed(21)
    tok = torch.randint(1, cfg.vocab_size, (4, 8), device="cuda",
                        generator=g)
    lg_1 = _teacher_forced(params, cfg, tok, None)
    own = tp9["teacher_forced_bf16_vs_f32_max_abs_diff"]
    tf = {}
    for mode in ("pallas", "auto"):
        lg = _teacher_forced(shards, cfg, tok, dctx.DistContext(mesh, mode))
        tf[mode] = (lg - lg_1).abs().max().item()
        check(bool(torch.isfinite(lg).all()) and tf[mode] <= own,
              f"shards {mode} vs tp=1 logits: max |diff| {tf[mode]:.3e} > "
              f"the bf16 model's own error {own:.3e}")
    # a first token must equal phase 9's where tp 1's top-2 margin after
    # the prompt exceeds twice the larger of the two paths' measured
    # distances from tp 1 (then both pick tp 1's token); below that it
    # is a near-tie of bf16 rounding, reported
    part("teacher_forced")
    margin = _prompt_margins(params, cfg, [r[0] for r in reqs_a])
    part("prompt_margins")
    cells = {}
    for mode in ("pallas", "auto"):
        ctx = dctx.DistContext(mesh, mode)
        per_step = sharded_per_step(cfg, mode, tp)
        cell, done = serve_cell(shards, cfg, 8, reqs_a, reqs_b, batch=4,
                                max_len=256, ctx=ctx,
                                label=f"tp={tp} {mode} shards")
        _check_serve(cell, done, cfg, 4, 16, per_step,
                     f"shards tp={tp} {mode} K=8")
        check(all(r.finish_reason != "error" for r in done),
              f"shards {mode}: a stream ended in error")
        got = {r.rid: r.out_tokens for r in done}
        first = sum(got[r][0] == want9[r][0] for r in want9)
        need = 2 * max(tf[mode], tp9["teacher_forced_max_abs_diff"])
        must = [r for r in want9 if margin[r] > need]
        check(all(got[r][0] == want9[r][0] for r in must),
              f"shards {mode}: first tokens "
              f"{[got[r][0] for r in sorted(got)]} vs phase 9's "
              f"{[want9[r][0] for r in sorted(want9)]} (top-2 margins "
              f"{[round(m, 4) for m in margin]}, decisive "
              f"above {need:.3e})")
        cell["first_tokens_equal_phase9"] = first
        cell["first_tokens_decisive"] = len(must)
        cell["streams_identical_to_phase9"] = sum(got[r] == want9[r]
                                                  for r in want9)
        cell["launches_per_step"] = per_step
        part(f"serve_{mode}")
        cells[mode] = cell
    # where the pallas step's time goes: #1 and #4 on the shards, and
    # the gather of the row blocks, graph-timed at the served shapes
    kernels = shard_kernel_rows(params, shards, cfg,
                                cells["pallas"]["launches"],
                                cells["pallas"]["decode_steps"], tp)
    part("kernels")
    # the serve step (JAX's jitted_serve_step) over the contiguous state
    fns = launch_counted()
    c_steps, c_diff = 4, 0.0
    runs = {}
    for W in (tp, 1):
        fn, ctx, _ = steps.jitted_serve_step(cfg, mesh if W > 1 else None,
                                             "pallas")
        p = shards if W > 1 else params
        with dctx.use(ctx):
            st = lm.init_decode_state(p, cfg, 4, 256)
        torch.cuda.synchronize()
        _counted(fns)
        lgs = []
        for j in range(c_steps):
            lg, st = fn(p, tok[:, j:j + 1], st)
            lgs.append(lg.float())
        torch.cuda.synchronize()
        runs[W] = ({f.__name__: f.launches for f in fns if f.launches}, lgs)
        del st
    c_launch = runs[tp][0]
    c_want = {"matmul": c_steps * (2 * tp * L + tp),
              "ag_gemm_fused": c_steps * 2 * L,
              "flash_decode_fused": c_steps * L}
    check(c_launch == c_want, f"serve step on shards: launches {c_launch} "
                              f"!= {c_want}")
    for a, b in zip(runs[tp][1], runs[1][1]):
        c_diff = max(c_diff, (a - b).abs().max().item())
    check(c_diff <= own, f"serve step shards vs tp=1: max |diff| "
                         f"{c_diff:.3e} > {own:.3e}")
    part("serve_step")
    del shards
    torch.cuda.empty_cache()
    f32 = _f32_cut("llama3-8b", tp, streams=True)
    part("f32_cut")
    p9 = tp9["k8"]
    summary = {"tp": tp, **mem, "cells": cells,
               "teacher_forced_max_abs_diff": tf, "own_error_bound": own,
               "f32_2_layers": f32, "parts_s": parts_s,
               "kernels": kernels,
               "serve_step": {"steps": c_steps, "launches": c_launch,
                              "max_abs_diff_vs_tp1": c_diff},
               "phase9_pallas": {k: p9[k] for k in (
                   "steady_tokens_per_s", "pure_megatick_device_ms",
                   "peak_mem_bytes")}}
    for mode, c in cells.items():
        print(f"[sharded] {mode}: steady {c['steady_tokens_per_s']:.2f} "
              f"tok/s, pure megatick {c['pure_megatick_device_ms']:.2f} ms "
              f"device ({c['pure_megatick_device_ms'] / 8:.2f} ms a step), "
              f"peak {c['peak_mem_bytes'] / 1e9:.2f} GB (with the "
              f"replicated {mem['whole_gb']:.2f} GB resident) | phase 9 "
              f"replicated pallas: {p9['steady_tokens_per_s']:.2f} tok/s, "
              f"{p9['pure_megatick_device_ms']:.2f} ms, peak "
              f"{p9['peak_mem_bytes'] / 1e9:.2f} GB; first tokens equal "
              f"phase 9's {c['first_tokens_equal_phase9']} of 4 "
              f"({c['first_tokens_decisive']} decisive), whole "
              f"streams {c['streams_identical_to_phase9']} of 4; "
              f"teacher-forced vs tp=1 {tf[mode]:.3e} (bound {own:.3e}), "
              f"float32 2 layers {f32['max_abs_diff'][mode]:.3e}, its "
              f"engine streams identical to tp=1's "
              f"{f32['streams_identical']} of 4", flush=True)
    print(f"[sharded] serve step (contiguous, {c_steps} steps): launches "
          f"{c_launch}, logits vs tp=1 max |diff| {c_diff:.3e}; s: " + ", ".join(
              f"{k} {v:.1f}" for k, v in parts_s.items()), flush=True)
    return summary


def _prompt_margins(params, cfg, prompts):
    """tp 1's top-2 logit margin after each prompt (one slot a prompt,
    the prompts consumed through ``lm.decode_chunk``), as floats."""
    from repro_torch.models import lm
    B, C = len(prompts), max(len(p) for p in prompts)
    blocks = -(-C // 16)
    tok = torch.zeros((B, C), dtype=torch.int64, device="cuda")
    for b, p in enumerate(prompts):
        tok[b, :len(p)] = torch.tensor(p)
    counts = torch.tensor([len(p) for p in prompts], device="cuda")
    with torch.inference_mode():
        st = lm.init_paged_decode_state(params, cfg, B, B * blocks, 16,
                                        blocks)
        st["block_tables"].copy_(torch.arange(
            B * blocks, dtype=torch.int32).reshape(B, blocks))
        lg, _ = lm.decode_chunk(params, tok, counts, st, cfg)
    top = lg[:, 0].float().topk(2, dim=-1).values
    return [float(x) for x in (top[:, 0] - top[:, 1]).tolist()]


# ------------------------------------------------------------ phase 19
TAX_FNS = ("_megatick", "_megatick_mixed", "_tick")
SYNC_WARNING = "synchronizing CUDA operation"   # set_sync_debug_mode("warn")


def taxes_static():
    """(19a) the port's lint (``repro_torch.analysis``) run in-process
    over the port's tree (``src/repro_torch``, this file): no finding,
    the justified suppressions, and each budgeted function's proven
    (dispatches, readbacks) per call and per graph key."""
    from repro_torch.analysis import analyze_paths
    from repro_torch.analysis.callgraph import build_project
    from repro_torch.analysis.core import iter_python_files
    from repro_torch.analysis.rules import proven_budgets
    roots = [os.path.join(ROOT, "src", "repro_torch"), __file__]
    t0 = time.time()
    findings, suppressed, nfiles = analyze_paths(roots)
    check(not findings, "torchlint findings:\n"
          + "\n".join(f.render() for f in findings))
    proven = proven_budgets(build_project(list(iter_python_files(roots))))
    inventory = [(f.rule, os.path.relpath(f.path, ROOT), f.line)
                 for f in suppressed]
    print(f"[taxes static] {nfiles} files in {time.time() - t0:.1f} s: 0 "
          f"findings, {len(inventory)} justified suppressions: "
          + ", ".join(f"{r} {p}:{n}" for r, p, n in inventory), flush=True)
    for name, b in sorted(proven.items()):
        print(f"[taxes static] {name}: per call {b['per_call']} (budget "
              f"{b['budget']}), per graph key {b['fill']} (budget "
              f"{b['fill_budget']})", flush=True)
    return {"files": nfiles, "suppressed": inventory,
            "proven": {k: {f: list(v) for f, v in b.items()}
                       for k, b in proven.items()}}


def count_taxes(eng, drive):
    """Run ``drive()`` with every call of ``eng``'s :data:`TAX_FNS`
    counted: the dispatches (graph replays, and program calls -- the
    ``lm.decode_*`` steps and the samplers -- made outside a capture;
    a program called inside another is not counted) and the
    synchronising CUDA operations (``torch.cuda.set_sync_debug_mode(
    "warn")``'s warnings) the call made, nested calls included, and
    whether it captured a graph. Returns ([(fn, captured, dispatches,
    syncs)], ``drive()``'s result)."""
    import warnings

    from repro_torch.models import lm
    from repro_torch.serving import sampler
    runner = eng._runner
    state = {"calls": 0, "depth": 0}

    def program(fn):
        def counted(*args, **kwargs):
            if state["depth"] == 0 \
                    and not torch.cuda.is_current_stream_capturing():
                state["calls"] += 1
            state["depth"] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                state["depth"] -= 1
        return counted

    def graph_count(attr):
        return 0 if runner is None else getattr(runner, attr)

    records, log = [], []

    def tick_fn(name):
        orig = getattr(eng, name)

        def counted(*args, **kwargs):
            d0, c0, s0 = (state["calls"] + graph_count("replays"),
                          graph_count("captures"), len(log))
            out = orig(*args, **kwargs)
            records.append((
                name, graph_count("captures") > c0,
                state["calls"] + graph_count("replays") - d0,
                sum(SYNC_WARNING in str(w.message) for w in log[s0:])))
            return out
        return counted

    progs = [(lm, n) for n in ("decode_step", "decode_chunk",
                               "decode_multi", "decode_mixed")]
    progs += [(sampler, n) for n in ("greedy", "sample_batch")]
    saved = [(m, n, getattr(m, n)) for m, n in progs]
    for m, n, fn in saved:
        setattr(m, n, program(fn))
    for name in TAX_FNS:
        setattr(eng, name, tick_fn(name))
    prev = torch.cuda.get_sync_debug_mode()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            log = caught
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = drive()
            finally:
                torch.cuda.set_sync_debug_mode(prev)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
        for name in TAX_FNS:
            delattr(eng, name)
    return records, out


def taxes_card(params, cfg, reqs, K, sampler, ctx=None):
    """Serve ``reqs`` (llama3-8b, batch 8, max_len 512, block 16, chunk 8)
    at megatick length ``K`` under :func:`count_taxes`; returns the
    records and the finished requests."""
    from repro_torch.distributed import context as dctx
    from repro_torch.serving.engine import Engine, Request
    with dctx.use(ctx or dctx.DistContext()):
        eng = Engine(params, cfg, batch=8, max_len=512, block_size=16,
                     prefill_chunk=8, decode_steps=K, sampler=sampler,
                     device="cuda")
    for rid, (prompt, max_new, at) in enumerate(reqs):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new),
                   at_tick=at)

    def drive():
        done = []
        while eng.queue or eng.active:
            done += eng.tick()
        torch.cuda.synchronize()
        return done
    with torch.inference_mode():
        records, done = count_taxes(eng, drive)
    del eng
    torch.cuda.empty_cache()
    return records, done


def phase_taxes(params, smi, tp=4):
    """(19) three taxes, static vs card: (a) :func:`taxes_static`; (b)
    phase 5's weights and traffic (8 requests of 32-128 prompt tokens,
    32 new each, admitted 2 ticks apart) served at K = 8 (pure and mixed
    megaticks, graph replays), at K = 1 with the temperature sampler
    (every host input of ``_tick`` and ``_next_tokens``) and at K = 8
    over ``tp`` virtual ranks under ``pallas`` (the fused kernels, whose
    first capture grows the symmetric buffers), replicated and on
    per-rank shards (``lm.shard_params``: the row-parallel weights
    all-gathered in the step), each call of ``_megatick``,
    ``_megatick_mixed`` and ``_tick`` counted (:func:`count_taxes`).
    Fails where a call shows more than the static proof allows: on a
    call that captured no graph its per-call budget, on one that
    captured, the per-call budget plus the per-key one."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import context as dctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    static = taxes_static()
    proven = static["proven"]
    cfg = get_config("llama3-8b")
    plens = [int(n) for n in np.random.default_rng(0).integers(32, 129, 8)]
    reqs = _full_requests(cfg, plens, 5, 32, 2)
    cells = {}
    for label, K, sampler, ctx in (
            ("K=8", 8, "greedy", None), ("K=1", 1, "temperature", None),
            (f"tp={tp} K=8", 8, "greedy",
             dctx.DistContext(make_mesh(tp, device="cuda"), "pallas")),
            (f"tp={tp} K=8 shards", 8, "greedy",
             dctx.DistContext(make_mesh(tp, device="cuda"), "pallas"))):
        t0 = time.time()
        p = lm.shard_params(params, ctx.mesh) if "shards" in label \
            else params
        records, done = taxes_card(p, cfg, reqs, K, sampler, ctx)
        del p
        check(len(done) == len(reqs) and all(
            len(r.out_tokens) == 32
            and all(0 <= t < cfg.vocab_size for t in r.out_tokens)
            for r in done), f"taxes {label}: not every stream finished")
        rows = {}
        for fn in TAX_FNS:
            per_call = tuple(proven[f"serving/engine.py::{fn}"]["per_call"])
            fill = tuple(proven[f"serving/engine.py::{fn}"]["fill"])
            row = {"static_per_call": per_call, "static_fill": fill}
            for kind, captured in (("steady", False), ("capture", True)):
                got = [(d, n) for name, c, d, n in records
                       if name == fn and c == captured]
                limit = per_call if not captured else tuple(
                    a + b for a, b in zip(per_call, fill))
                most = (max((d for d, _ in got), default=0),
                        max((n for _, n in got), default=0))
                row[kind] = {"calls": len(got), "max_dispatches": most[0],
                             "max_syncs": most[1], "limit": limit}
                check(most[0] <= limit[0] and most[1] <= limit[1],
                      f"taxes {label}: {fn} {kind} calls showed "
                      f"{most} (dispatches, syncs) on the card, above the "
                      f"static {limit}: the proof is unsound")
            rows[fn] = row
            print(f"[taxes card] {label} {fn}: {row['steady']['calls']} "
                  f"calls, most {row['steady']['max_dispatches']} "
                  f"dispatches and {row['steady']['max_syncs']} syncs a "
                  f"call (static {per_call}); {row['capture']['calls']} "
                  f"capturing, most {row['capture']['max_dispatches']} and "
                  f"{row['capture']['max_syncs']} (static "
                  f"{row['capture']['limit']}) | {smi}", flush=True)
        check(rows["_tick"]["steady"]["calls"] > 0,
              f"taxes {label}: no _tick call")
        if K > 1:
            for fn in ("_megatick", "_megatick_mixed"):
                check(rows[fn]["steady"]["calls"] > 0
                      and rows[fn]["steady"]["max_dispatches"] == 1,
                      f"taxes {label}: {fn} did not replay a graph: "
                      f"{rows[fn]}")
        cells[label] = {"rows": rows, "s": time.time() - t0}
    return {"static": static, "card": cells, "device": smi}


# --------------------------------------- phase 22: serving on a data mesh
DM_SERVE = (2, 2)           # (data, model) virtual ranks of cuda:0


def data_mesh_per_step(cfg, mode, D, M):
    """Kernel launches of one llama3-8b (``attn_mlp``) decode step on a
    (data D, model M > 1) mesh of virtual ranks of one card, weights-
    stationary (``models.lm``: data group 0's model ranks run the weight
    sites, each product one launch a ``data`` block of its weight): a
    column group (wq/wk/wv, wg/wu) and the unembed one GEMM a block and
    model rank (D M); a row site (wo, wd) under ``auto`` one GEMM a block
    and model rank, under ``pallas`` one fused AG+GEMM a block (over
    that data group's M ranks); attention one paged decode a layer (the
    pool over the D M ranks, one launch on the card)."""
    L, n = cfg.n_layers, D * M
    row = {"pallas": 0, "auto": n}[mode]
    attn = "flash_decode_paged_fused" if mode == "pallas" else \
        "flash_decode_paged_partial"
    out = {"matmul": L * (2 * n + 2 * row) + n, attn: L}
    if mode == "pallas":
        out["ag_gemm_fused"] = 2 * L * D
    return out


def _dm_prompts(seed, *lens):
    r = np.random.default_rng(seed)
    return [[int(t) for t in r.integers(1, 512, n)] for n in lens]


# phases of (prompt, max_new, arrival tick), each run to completion: a
# prompt registered whole, hit again (prefix hits, a copy-on-write of
# its last block), then three slots outgrowing 6 blocks (a preemption);
# tests/test_torch_data_serve.py serves the same on the CPU
_DM_SHARED = _dm_prompts(3, 24)[0]
DM_PHASES = [[(_DM_SHARED, 5, 0)],
             [(_DM_SHARED + [9, 8, 7], 6, 0), (_DM_SHARED, 5, 1),
              (_dm_prompts(4, 5)[0], 7, 2)],
             [(p, 12, 0) for p in _dm_prompts(5, 7, 7, 7)]]
DM_KEYS = ("ticks", "dispatches", "mixed_dispatches", "preemptions",
           "prefix_hits", "cow_copies")


def _dm_drive(params, cfg, ctx, K, device):
    """The DM_PHASES traffic through the engine (batch 3, 6 blocks of 8)
    under ``ctx``: ({rid: tokens}, {counter: value})."""
    from repro_torch.distributed import context as dctx
    from repro_torch.serving.engine import Engine, Request
    with dctx.use(ctx):
        eng = Engine(params, cfg, batch=3, max_len=64, prefill_chunk=4,
                     block_size=8, n_blocks=6, decode_steps=K,
                     device=device)
        streams, rid, done = {}, 0, []
        for phase in DM_PHASES:
            for prompt, max_new, at in phase:
                eng.submit(Request(rid=rid, prompt=list(prompt),
                                   max_new_tokens=max_new), at_tick=at)
                rid += 1
            out = eng.run()
            done += out
            streams.update({r.rid: list(r.out_tokens) for r in out})
        m = eng.metrics(done)
    check(all(r.finish_reason != "error" for r in done),
          f"dm serve small: a stream ended in error under {ctx}")
    return streams, {k: m[k] for k in DM_KEYS}


def phase_dm_serve_small():
    """(22a) the float32 smoke llama3-8b (2 layers) served on (data 2,
    model 2) virtual ranks of cuda:0 (each rank's shards) against one
    rank on the card, with the cases that differ on the card (the CPU
    tests serve every mode at K = 8 and K = 1 on the CPU mesh): K = 8
    (graph replays) under ``pallas``, also against the same mesh on the
    CPU, and under ``auto``; K = 1 (the eager tick) under ``ring``.
    Greedy streams token-identical, the engine's counters (ticks,
    dispatches, preemptions, prefix hits, copies on write) equal; the
    kernels ran, their plain versions never on the card."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.distributed import context as dctx
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    cfg = smoke_config(get_config("llama3-8b")).replace(
        n_layers=2, dtype=torch.float32)
    D, M = DM_SERVE
    p_cpu = lm.init_params(cfg, seed=0, device="cpu")
    p_card = lm.replicate(p_cpu, make_mesh(1, ["cuda:0"]))[0]
    card_mesh = make_mesh(M, ["cuda:0"] * (D * M))
    card_shards = lm.shard_params(p_card, card_mesh)
    out = {}
    # K: [(mode, also on the CPU mesh)]
    for K, runs in ((8, [("pallas", True), ("auto", False)]),
                    (1, [("ring", False)])):
        want = _dm_drive(p_card, cfg, dctx.DistContext(), K, "cuda")
        check(want[1]["preemptions"] >= 1 and want[1]["prefix_hits"] >= 2
              and want[1]["cow_copies"] >= 1,
              f"dm serve small: the traffic missed a path {want[1]}")
        for mode, on_cpu in runs:
            n0, q0 = matmul.launches, matmul.plain_calls
            got = _dm_drive(card_shards, cfg,
                            dctx.DistContext(card_mesh, mode), K, "cuda")
            check(matmul.launches > n0 and matmul.plain_calls == q0,
                  f"dm serve small {mode} K={K}: the GEMM kernel did not "
                  f"carry the card's serve")
            check(got == want, f"dm serve small {mode} K={K}: card (2, 2) "
                               f"{got} != card (1, 1) {want}")
            if on_cpu:
                cpu_mesh = make_mesh(M, ["cpu"] * (D * M))
                got_cpu = _dm_drive(lm.shard_params(p_cpu, cpu_mesh), cfg,
                                    dctx.DistContext(cpu_mesh, mode), K,
                                    "cpu")
                check(got == got_cpu, f"dm serve small {mode} K={K}: card "
                                      f"{got} != CPU mesh {got_cpu}")
        out[f"k{K}"] = {"streams": len(want[0]), "counters": want[1],
                        "modes": [m for m, _ in runs]}
    print(f"[dm serve small] float32 smoke at (data, model) {DM_SERVE}: "
          f"card = card (1, 1) under pallas (= the CPU mesh) and auto at "
          f"K = 8 {out['k8']['counters']}, under ring at K = 1 "
          f"{out['k1']['counters']}", flush=True)
    return out


def _rules_rank_bytes(cfg, mesh):
    """The bytes a rank of ``mesh`` holds by the rules: every leaf's
    ``launch.steps.param_shardings`` shape in its serving storage dtype
    (``lm.storage_dtype``)."""
    from repro_torch.distributed import sharding_rules as sr
    from repro_torch.launch import steps
    from repro_torch.models import lm

    def per_rank(tree, prefix=""):
        n = 0
        for k, v in tree.items():
            path = f"{prefix}.{k}" if prefix else k
            n += (int(np.prod(v["shape"]))
                  * lm.storage_dtype(path, cfg).itemsize
                  if "dim" in v else per_rank(v, path))
        return n
    return per_rank(steps.param_shardings(cfg, sr.rules_for(cfg, mesh)))


def _dm_rank_bytes(params, shards, mesh):
    """Each rank's resident bytes on ``mesh`` against the rules' (every
    leaf's ``launch.steps.param_shardings`` per-rank shape in its
    storage dtype, :func:`_rules_rank_bytes`): equal to the byte."""
    want = _rules_rank_bytes(params.cfg, mesh)
    got = [round(_resident_gb([s]) * 1e9) for s in shards]
    check(all(g == want for g in got), f"dm serve: {got} B a rank, the "
                                       f"rules' {want}")
    return {"rank_bytes": want, "rank_gb": want / 1e9,
            "card_gb": _resident_gb(shards),
            "whole_gb": _resident_gb([params])}


def dm_serve_kernel_rows(gen, shards, cfg, mesh, cells, lens, B=4):
    """(22c) the kernels as the (2, 2) serve runs them: the GEMM (#1) over
    one ``auto`` decode step's products on the real shards (per layer,
    model rank m and data block g: wq/wk/wv and wg/wu grouped on x's
    g-th d/D columns, wo and wd on the model rank's K-slice into their
    d/D columns; the fp32 unembed on each block: 16 L + 4 launches),
    graph-timed, beside the plain versions, one ``torch.matmul`` a
    product and the bound from the bytes they move, layer 0's products
    held to their plain versions; and the fused paged decode (#2) over
    the mesh's D M ranks (sources) at the served lengths
    (:func:`_paged_fused_times`), beside its plain version and SDPA."""
    from repro_torch.kernels.matmul import (matmul, matmul_group,
                                            matmul_plain)
    D, M = DM_SERVE
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    hq = cfg.n_heads * cfg.hd
    bf16 = torch.bfloat16
    g_ = torch.Generator(device="cuda")
    g_.manual_seed(24)
    xs = [torch.randn((B, d // D), generator=g_, device="cuda").to(bf16)
          for _ in range(D)]
    o = torch.randn((B, hq // M), generator=g_, device="cuda").to(bf16)
    h = torch.randn((B, f // M), generator=g_, device="cuda").to(bf16)
    lay = [s["backbone"]["layers"] for s in shards]
    groups, rows = [], []
    for li in range(L):
        for m in range(M):
            for g in range(D):
                x = lay[g * M + m]
                groups.append((xs[g], [x["attn"][n][li]
                                       for n in ("wq", "wk", "wv")]))
                groups.append((xs[g], [x["mlp"][n][li]
                                       for n in ("wg", "wu")]))
                rows += [(o, x["attn"]["wo"][li]), (h, x["mlp"]["wd"][li])]
    heads = [(xs[g].float(), shards[g * M + m]["head"]["table"])
             for m in range(M) for g in range(D)]

    def step(group, one, unembed):
        for a, ws in groups:
            group(a, ws)
        for a, w in rows:
            one(a, w)
        for a, t in heads:
            unembed(a, t)
    t_k = graph_ms(lambda: step(matmul_group, matmul,
                                lambda a, t: matmul(a, t, trans_b=True)),
                   iters=1)
    t_l = graph_ms(lambda: step(
        lambda a, ws: [torch.matmul(a, w) for w in ws], torch.matmul,
        lambda a, t: torch.matmul(a, t.T)), iters=1)
    t_p = time_ms(lambda: step(
        lambda a, ws: [matmul_plain(a, w) for w in ws], matmul_plain,
        lambda a, t: matmul_plain(a, t, True)), iters=2, warmup=1)
    err = max([_gemm_err(y, matmul_plain(a, w), bf16,
                         f"matmul on a data block {tuple(w.shape)}")
               for a, ws in groups[:2 * M * D]
               for y, w in zip(matmul_group(a, ws), ws)]
              + [_gemm_err(matmul(a, w), matmul_plain(a, w), bf16,
                           f"matmul on a row block {tuple(w.shape)}")
                 for a, w in rows[:2 * M * D]]
              + [_gemm_err(matmul(a, t, trans_b=True),
                           matmul_plain(a, t, True), torch.float32,
                           "matmul on the head's block")
                 for a, t in heads[:1]])
    by = (sum(_gemm_io_bytes(a, ws, bf16) for a, ws in groups)
          + sum(_gemm_io_bytes(a, [w], bf16) for a, w in rows)
          + sum(nbytes(a, t) + B * t.shape[0] * 4 for a, t in heads))
    ops = [(sum(2 * B * w.numel() for _, ws in groups for w in ws)
            + sum(2 * B * w.numel() for _, w in rows), bf16),
           (sum(2 * B * t.numel() for _, t in heads), torch.float32)]
    b_s, b_by = bound(ops, by)
    auto = cells["auto"]
    n_launch = len(groups) + len(rows) + len(heads)
    check(n_launch == data_mesh_per_step(cfg, "auto", D, M)["matmul"],
          f"dm serve kernels: {n_launch} products a step")
    gemm = {"name": "matmul_data_mesh", "route": "cuda",
            "source": "src/repro_torch/csrc/matmul.cu",
            "replaces": "src/repro/kernels/matmul.py:34",
            "launches": auto["launches"]["matmul"],
            "launches_per_step": auto["launches"]["matmul"]
            / auto["decode_steps"],
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": 1e3 * b_s, "bound_by": b_by, "bytes": by,
            "library_ms": t_l,
            "unit": f"one auto decode step at batch {B} on llama3-8b's "
                    f"shards over (data, model) {DM_SERVE} ({n_launch} "
                    f"launches: each product on each data block of its "
                    f"weight, weights-stationary)"}
    pallas = cells["pallas"]
    name = "flash_decode_paged_fused"
    per = pallas["launches"][name] / pallas["decode_steps"]
    t_k, t_p, t_l, by, ops1, plan, gw, err = _paged_fused_times(gen, lens,
                                                                mesh)
    check(err <= 2e-2, f"dm serve: fused paged decode over {mesh.size} "
                       f"sources vs plain {err:.3e}")
    b1, b1_by = bound(ops1, by, bf16)
    paged = {"name": "flash_decode_paged_fused_data_mesh", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_decode_paged.cu",
             "replaces": "src/repro/kernels/flash_decode.py:272",
             "launches": pallas["launches"][name],
             "launches_per_step": per, "max_abs_err": err,
             "ms": per * t_k, "call_ms": t_k, "plain_ms": per * t_p,
             "bound_ms": 1e3 * per * b1, "bound_by": b1_by,
             "library_ms": per * t_l, "grid": plan.grid,
             "n_split": plan.n_split,
             "unit": f"one decode step at batch {B}, the pool over the "
                     f"{mesh.size} ranks of (data, model) {DM_SERVE} "
                     f"(sources), cur_len {lens}, gather width {gw}"}
    for k in (gemm, paged):
        print(f"[dm serve kernels] {k['name']}: {k['ms']:.3f} ms a step "
              f"(bound {k['bound_ms']:.3f} {k['bound_by']}; plain "
              f"{k['plain_ms']:.3f}, library {k['library_ms']:.3f}; "
              f"{k['launches_per_step']:.0f} launches a step; max |err| "
              f"{k['max_abs_err']:.3e})", flush=True)
    return [gemm, paged]


def dm_ag_gemm_row(shards, cfg, cells, B=4):
    """(22c) the fused AG+GEMM (#4) as the (2, 2) serve's ``pallas`` step
    runs it on the real shards: per layer and data block g, wo ((B, hq/M)
    a rank . (hq, d/D)) and wd ((B, f/M) a rank . (f, d/D)), each one
    launch over data group g's M ranks, on block g's columns of the
    weight gathered over ``model`` from the ranks' row blocks
    (``patterns._gather_row_blocks``: that gather, a ``torch.cat``,
    timed apart, as phase 20's), graph-timed, beside the plain version
    (eager), one ``torch.matmul`` a product and the bound from the bytes
    (x and the block read once, each rank's output written once); every
    product of layer 0 on both blocks held to its plain version
    (``_gemm_err``: bf16 within one ulp)."""
    from repro_torch.distributed.context import Mesh
    from repro_torch.kernels.ag_gemm import ag_gemm_fused, ag_gemm_plain
    D, M = DM_SERVE
    L = cfg.n_layers
    bf16 = torch.bfloat16
    grp = Mesh(["cuda:0"] * M)
    g_ = torch.Generator(device="cuda")
    g_.manual_seed(25)
    xs = {"wo": torch.randn((B, cfg.n_heads * cfg.hd), generator=g_,
                            device="cuda").to(bf16),
          "wd": torch.randn((B, cfg.d_ff), generator=g_,
                            device="cuda").to(bf16)}
    sl = {n: [x[:, m * (x.shape[1] // M):(m + 1) * (x.shape[1] // M)]
              .contiguous() for m in range(M)] for n, x in xs.items()}
    lay = [s["backbone"]["layers"] for s in shards]
    site = {"wo": "attn", "wd": "mlp"}
    parts = [(n, li, [lay[g * M + m][site[n]][n][li] for m in range(M)])
             for n in ("wo", "wd") for li in range(L) for g in range(D)]
    t_gather = graph_ms(lambda: [torch.cat(ws, dim=0) for *_, ws in parts],
                        iters=1)
    whole = [(n, li, torch.cat(ws, dim=0)) for n, li, ws in parts]
    check(len(whole) == data_mesh_per_step(cfg, "pallas", D, M)[
        "ag_gemm_fused"], f"dm serve kernels: {len(whole)} AG+GEMM "
                          f"products a step")
    t_k = graph_ms(lambda: [ag_gemm_fused(sl[n], [w] * M, grp)
                            for n, _, w in whole], iters=1)
    t_l = graph_ms(lambda: [torch.matmul(xs[n], w) for n, _, w in whole],
                   iters=1)
    t_p = time_ms(lambda: [ag_gemm_plain(sl[n], [w] * M)
                           for n, _, w in whole], iters=2, warmup=1)
    err = max(_gemm_err(u, v, bf16, f"ag_gemm_fused on data block columns "
                                    f"{n} {tuple(w.shape)}")
              for n, li, w in whole if li == 0
              for u, v in zip(ag_gemm_fused(sl[n], [w] * M, grp),
                              ag_gemm_plain(sl[n], [w] * M)))
    by = sum(nbytes(xs[n], w) + M * B * w.shape[1] * 2
             for n, _, w in whole)
    b_s, b_by = bound(sum(M * 2 * B * w.numel() for *_, w in whole), by,
                      bf16)
    pallas = cells["pallas"]
    n_l = pallas["launches"]["ag_gemm_fused"]
    d, f = cfg.d_model, cfg.d_ff
    hq = cfg.n_heads * cfg.hd
    row = {"name": "ag_gemm_fused_data_mesh", "route": "cuda",
           "source": "src/repro_torch/csrc/ag_gemm.cu",
           "replaces": "src/repro/kernels/ag_gemm.py:114",
           "launches": n_l, "launches_per_step": n_l / pallas[
               "decode_steps"],
           "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
           "bound_ms": 1e3 * b_s, "bound_by": b_by, "bytes": by,
           "library_ms": t_l, "gather_ms": t_gather,
           "gather_bytes": sum(nbytes(*ws) for *_, ws in parts),
           "unit": f"one pallas decode step at batch {B} over (data, "
                   f"model) {DM_SERVE}: per layer and data block, wo "
                   f"({B}x{hq // M} a rank . {hq}x{d // D}) and wd "
                   f"({B}x{f // M} a rank . {f}x{d // D}) over the "
                   f"block's {M} model ranks, on the columns gathered "
                   f"over model from the row blocks (the gather: "
                   f"gather_ms)"}
    del whole
    torch.cuda.empty_cache()
    print(f"[dm serve kernels] {row['name']}: {t_k:.3f} ms a step (bound "
          f"{row['bound_ms']:.3f} {b_by}; plain {t_p:.3f}, library "
          f"{t_l:.3f}; {row['launches_per_step']:.0f} launches a step; max "
          f"|err| {err:.3e}); the row blocks' gather over model {t_gather:.3f}"
          f" ms ({row['gather_bytes'] / 1e9:.3f} GB)", flush=True)
    return row


def phase_serve_data_mesh(gen, params):
    """(22) serving on a (data 2, model 2) mesh of virtual ranks of
    cuda:0: (a) :func:`phase_dm_serve_small`; (b) full-width llama3-8b
    (``params``: phase 5's bf16 weights) on each rank's shards
    (``lm.shard_params``: the embed dim cut over ``data``, decoded
    weights-stationary), the bytes a rank to the byte of the rules and
    the KV pool a rank; phase 9's traffic at K = 8 under ``pallas`` and
    ``auto`` (graph replays, then the steady rerun): launches exact a
    step (:func:`data_mesh_per_step`), no stream in error, tok/s, ms a
    step, the peak; (c) :func:`dm_serve_kernel_rows` and
    :func:`dm_ag_gemm_row`; then the model at full width in float32, cut
    to 2 layers, on its (2, 2) shards under ``pallas`` and ``auto``
    against tp 1 within one bf16 ulp (:func:`_f32_cut`). Returns
    (numbers, kernel rows)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding_rules as sr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    D, M = DM_SERVE
    parts_s, t_part = {}, [time.time()]

    def part(name):
        now = time.time()
        parts_s[name] = now - t_part[0]
        t_part[0] = now
    small = phase_dm_serve_small()
    part("small")
    cfg = get_config("llama3-8b")
    mesh = make_mesh(M, ["cuda:0"] * (D * M))
    t0 = time.time()
    shards = lm.shard_params(params, mesh)
    torch.cuda.synchronize()
    mem = {**_dm_rank_bytes(params, shards, mesh),
           "shard_s": time.time() - t0}
    plens = [int(n) for n in np.random.default_rng(1).integers(16, 49, 4)]
    reqs_a = _full_requests(cfg, plens, 3, 16, 1)
    reqs_b = _full_requests(cfg, plens, 4, 16, 1)
    n_blocks = 4 * (256 // 16)                # the engine's default pool
    n_loc, _ = sr.pool_blocks(n_blocks, mesh.size)
    mem["kv_rank_bytes"] = (cfg.n_layers * 2 * n_loc * 16 * cfg.n_kv_heads
                            * cfg.hd * 2)
    print(f"[dm serve] llama3-8b on (data, model) {DM_SERVE} of one card: "
          f"a rank {mem['rank_bytes']} B ({mem['rank_gb']:.3f} GB, the "
          f"rules' to the byte), the shards on the card "
          f"{mem['card_gb']:.3f} GB (cut in {mem['shard_s']:.2f} s); KV "
          f"pool a rank {n_loc} of {n_blocks} blocks, "
          f"{mem['kv_rank_bytes'] / 1e6:.1f} MB", flush=True)
    cells = {}
    for mode in ("pallas", "auto"):
        per_step = data_mesh_per_step(cfg, mode, D, M)
        cell, done = serve_cell(shards, cfg, 8, reqs_a, reqs_b, batch=4,
                                max_len=256,
                                ctx=dctx.DistContext(mesh, mode),
                                label=f"(data, model) {DM_SERVE} {mode}")
        _check_serve(cell, done, cfg, 4, 16, per_step,
                     f"data mesh {DM_SERVE} {mode} K=8")
        check(all(r.finish_reason != "error" for r in done),
              f"data mesh {mode}: a stream ended in error")
        cell["launches_per_step"] = per_step
        cell["steady_ms_per_step"] = (cell["pure_megatick_wall_ms"] / 8
                                      if cell["pure_megaticks"] else None)
        cells[mode] = cell
        part(f"serve_{mode}")
    lens = [n + 8 for n in plens]
    kernels = dm_serve_kernel_rows(gen, shards, cfg, mesh, cells, lens)
    kernels.insert(1, dm_ag_gemm_row(shards, cfg, cells))
    part("kernels")
    for mode, c in cells.items():
        print(f"[dm serve] {mode}: steady {c['steady_tokens_per_s']:.2f} "
              f"tok/s, {c['steady_ms_per_token']:.2f} ms/token, pure "
              f"megatick {c['pure_megatick_wall_ms'] / 8:.2f} ms a step "
              f"({c['pure_megatick_device_ms'] / 8:.2f} ms device), peak "
              f"{c['peak_mem_bytes'] / 1e9:.2f} GB, launches a step "
              f"{c['launches_per_step']}", flush=True)
    del shards
    torch.cuda.empty_cache()
    f32 = _f32_cut("llama3-8b", M, data=D)
    part("f32_cut")
    print(f"[dm serve] float32 llama3-8b at full width, 2 layers, on the "
          f"{DM_SERVE} shards vs tp=1: max |diff| " + ", ".join(
              f"{m} {v:.3e}" for m, v in f32["max_abs_diff"].items())
          + " (within one bf16 ulp)", flush=True)
    print("[dm serve] parts: " + ", ".join(f"{k} {v:.1f} s"
                                           for k, v in parts_s.items()),
          flush=True)
    return {"small": small, "memory": mem, "cells": cells, "f32_cut": f32,
            "parts_s": parts_s}, kernels


BORN_TP = 4                 # phase 23: virtual ranks of cuda:0
CLI_TRAFFIC = ["--batch", "4", "--max-len", "256", "--max-new", "16",
               "--requests", "4", "--stagger", "1", "--seed", "0"]


def _draw_bound(cfg):
    """(bytes, path) of the largest draw of a born-sharded init and its
    cast: one layer slice or one unstacked leaf drawn in fp32, and the
    same values in the leaf's storage dtype."""
    from repro_torch.models import lm
    from repro_torch.models import module
    from repro_torch.models.module import tree_items
    best = (0, None)
    for path, p in tree_items(lm.lm_spec(cfg)):
        if module.constant(p) is not None:
            continue
        n = int(np.prod(p.shape[1:] if module.stacked(p) else p.shape))
        size = lm.storage_dtype(path, cfg).itemsize
        best = max(best, (n * (4 + size), path))
    return best


def cli_serve(argv, cfg, per_step, what, steady_seed=None):
    """``launch.serve.main(argv)`` as a user runs it, with every kernel
    wrapper's counters set to 0 just before and read just after, the
    engine it builds kept (a subclass of ``serve.Engine`` that records
    it and what it is sent): its checks as a serve cell's (every request
    finished in vocabulary, no plain-version call, launches exact a
    decode step: ``per_step``), the peak increment over what the card
    held before, each rank's bytes against the rules'; with
    ``steady_seed`` the same lengths served again with other tokens on
    the CLI's engine, its graphs replaying (:func:`_steady`). Returns
    (summary, the engine)."""
    from repro_torch.launch import serve
    from repro_torch.serving.graphs import launch_counted
    made = []

    class Kept(serve.Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.sent = []
            made.append(self)

        def submit(self, req, at_tick=None):
            self.sent.append((len(req.prompt), req.max_new_tokens, at_tick))
            return super().submit(req, at_tick=at_tick)
    fns = launch_counted()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _counted(fns)
    plain_engine, serve.Engine = serve.Engine, Kept
    t0 = time.time()
    try:
        stats = serve.main(argv)
    finally:
        serve.Engine = plain_engine
    torch.cuda.synchronize()
    wall = time.time() - t0
    (eng,) = made
    made.clear()          # no cycle through Kept's closure: del frees it
    runner = eng._runner
    steps = eng.scan_steps + (runner.warmup_steps if runner else 0)
    cell = {"K": eng.decode_steps, "graphs": stats["graphs"],
            "decode_steps": steps,
            "launches": {f.__name__: f.launches for f in fns},
            "plain_calls": {f.__name__: f.plain_calls for f in fns},
            "graph_replays": stats.get("graph_replays", 0),
            "graph_captures": stats.get("graph_captures", 0),
            "dispatches": stats["dispatches"],
            "peak_increment_bytes": torch.cuda.max_memory_allocated() - base,
            "main_s": wall, "tok_per_s": stats["tok_per_s"],
            "mesh": stats["mesh"], "fusion_mode": stats["fusion_mode"]}
    done = [types.SimpleNamespace(rid=rid, out_tokens=toks, finish_reason="")
            for rid, toks in stats["streams"].items()]
    _check_serve(cell, done, cfg, len(eng.sent), eng.sent[0][1], per_step,
                 what)
    ranks = eng.params
    check(isinstance(ranks, list) and len(ranks) == len(eng.ctx.mesh.devices),
          f"{what}: the engine holds {type(ranks)}, not a rank's shards")
    want = _rules_rank_bytes(cfg, eng.ctx.mesh)
    got = [round(_resident_gb([r]) * 1e9) for r in ranks]
    check(all(g == want for g in got), f"{what}: {got} B a rank, the "
                                       f"rules' {want}")
    cell.update({"rank_bytes": want, "card_gb": _resident_gb(ranks)})
    if steady_seed is not None:
        rng = np.random.default_rng(steady_seed)
        reqs_b = [([int(t) for t in rng.integers(1, cfg.vocab_size, n)],
                   max_new, at or 0) for n, max_new, at in eng.sent]
        cell.update(_steady(eng, reqs_b, eng.decode_steps,
                            cell["graph_captures"]))
        cell["steady_ms_per_step"] = (
            cell["pure_megatick_wall_ms"] / eng.decode_steps
            if cell["pure_megaticks"] else None)
    print(f"[born] {what}: {stats['new_tokens']} tokens in {wall:.2f} s "
          f"(init, engine, serve), {steps} decode steps, launches exact, "
          f"peak +{cell['peak_increment_bytes'] / 1e9:.2f} GB, a rank "
          f"{want} B, the card {cell['card_gb']:.3f} GB"
          + (f"; steady {cell['steady_tokens_per_s']:.2f} tok/s, "
             f"{cell['steady_ms_per_step']:.2f} ms a step"
             if cell.get("steady_ms_per_step") else ""), flush=True)
    return cell, eng


def _f32_cli_streams(flags):
    """The CLI's greedy streams of the float32 smoke model on the card."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    plain = serve.smoke_config
    serve.smoke_config = lambda c: smoke_config(c).replace(
        dtype=torch.float32)
    try:
        return serve.main(["--arch", "llama3-8b", "--smoke", "--batch", "2",
                           "--max-len", "64", "--max-new", "8",
                           "--requests", "4", "--decode-steps", "4",
                           *flags])["streams"]
    finally:
        serve.smoke_config = plain


def phase_born_sharded(params, steady=False):
    """(23) parameters born sharded, on one card: (a) llama3-8b at full
    width over 4 virtual ranks (``lm.init_params(..., mesh=)``), every
    leaf of every rank ``torch.equal`` to ``lm.shard_params`` of
    ``params`` (phase 5's whole model, seed 0), the init's peak
    increment within the shards' bytes plus the largest draw and its
    cast (:func:`_draw_bound`); (b) ``launch.serve.main`` with phase 9's
    batch and budget (4 requests, 16 new tokens, stagger 1, K = 1; the
    prompts the CLI's own, 2-7 tokens, where phase 9's are 16-48) at
    ``--tp 4 --fusion-mode pallas`` and on the (data 2, model 2)
    mesh ``--devices cuda:0,cuda:0,cuda:0,cuda:0 --tp 2``
    (:func:`cli_serve`: launches exact, each rank's bytes the rules',
    the peak increment), and finite logits of a teacher-forced chunk on
    the CLI's shards; (c) the float32 smoke model through the CLI at
    ``--tp 4`` token-identical to ``--tp 1``. ``steady`` (``--phase
    23``): the CLI at ``--tp 4`` also at K = 8 in ``pallas`` and
    ``auto``, its steady rate and ms a step on its own engine."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.module import tree_items
    parts_s, t_part = {}, [time.time()]

    def part(name):
        now = time.time()
        parts_s[name] = now - t_part[0]
        t_part[0] = now
    cfg = get_config("llama3-8b")
    mesh = make_mesh(BORN_TP, device="cuda")
    draw_bytes, draw_path = _draw_bound(cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    born = lm.init_params(cfg, seed=0, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    inc = torch.cuda.max_memory_allocated() - base
    shards_bytes = round(_resident_gb(born) * 1e9)
    init = {"init_s": init_s, "peak_increment_bytes": inc,
            "shards_bytes": shards_bytes, "draw_bytes": draw_bytes,
            "draw_leaf": draw_path,
            "rank_bytes": _rules_rank_bytes(cfg, mesh)}
    check(inc <= shards_bytes + draw_bytes,
          f"born-sharded init: peak +{inc} B > the shards' {shards_bytes} "
          f"+ one draw and its cast {draw_bytes} ({draw_path})")
    cut = lm.shard_params(params, mesh)
    for r, (a, b) in enumerate(zip(born, cut)):
        la, lb = (dict(tree_items(lm.param_tree(x))) for x in (a, b))
        for k, t in la.items():
            check(t.dtype == lb[k].dtype and torch.equal(t, lb[k]),
                  f"born-sharded init: rank {r} {k} differs from "
                  f"lm.shard_params of phase 5's model")
    del born, cut
    torch.cuda.empty_cache()
    part("a_init")
    print(f"[born] llama3-8b over {BORN_TP} ranks born sharded in "
          f"{init_s:.2f} s, bit-equal to lm.shard_params of phase 5's "
          f"model: peak +{inc / 1e9:.3f} GB for {shards_bytes / 1e9:.3f} "
          f"GB of shards (bound: + {draw_bytes / 1e9:.3f} GB, {draw_path} "
          f"drawn in fp32 and cast)", flush=True)
    full = ["--arch", "llama3-8b", *CLI_TRAFFIC]
    cli = {}
    tp4 = ["--tp", str(BORN_TP), "--fusion-mode", "pallas"]
    dm = ["--devices", ",".join(["cuda:0"] * 4), "--tp", "2",
          "--fusion-mode", "pallas"]
    tok = torch.randint(1, cfg.vocab_size, (4, 8), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
    for name, flags, per_step in (
            ("tp4_pallas", tp4, sharded_per_step(cfg, "pallas", BORN_TP)),
            ("dm_2x2_pallas", dm, data_mesh_per_step(cfg, "pallas", 2, 2))):
        cli[name], eng = cli_serve(full + flags + ["--decode-steps", "1"],
                                   cfg, per_step, f"CLI {name} K=1")
        lg = _teacher_forced(eng.params, cfg, tok, eng.ctx)
        check(bool(torch.isfinite(lg).all()),
              f"CLI {name}: non-finite logits on its shards")
        del eng, lg
        torch.cuda.empty_cache()
        part(f"b_{name}")
    if steady:
        for mode in ("pallas", "auto"):
            name = f"tp4_{mode}_k8"
            cli[name], eng = cli_serve(
                full + ["--tp", str(BORN_TP), "--fusion-mode", mode,
                        "--decode-steps", "8"], cfg,
                sharded_per_step(cfg, mode, BORN_TP), f"CLI {name}",
                steady_seed=4)
            del eng
            torch.cuda.empty_cache()
            part(f"d_{name}")
    one = _f32_cli_streams(["--tp", "1"])
    four = _f32_cli_streams(["--tp", str(BORN_TP), "--fusion-mode",
                             "pallas"])
    check(one == four, f"float32 smoke through the CLI: --tp 4 streams "
                       f"{four} != --tp 1 {one}")
    part("c_f32_cli")
    print(f"[born] float32 smoke through the CLI: --tp {BORN_TP} pallas "
          f"token-identical to --tp 1 ({sum(map(len, one.values()))} "
          f"tokens)", flush=True)
    print("[born] parts: " + ", ".join(f"{k} {v:.1f} s"
                                       for k, v in parts_s.items()),
          flush=True)
    return {"init": init, "cli": cli,
            "f32_cli_tokens": sum(map(len, one.values())),
            "parts_s": parts_s}


def check_bounds(kernels, path):
    """Print every kernel line's bound beside the same line's in the
    ``chip_smoke.json`` at ``path`` (an earlier run's) and fail where the
    two differ in their first 3 significant digits."""
    with open(path) as f:
        prev = {k["name"]: k for k in json.load(f)["kernels"]}
    for k in kernels:
        p = prev.get(k["name"])
        if p is None:
            print(f"[bounds] {k['name']}: {k['bound_ms']:.6g} ms (not in "
                  f"{path})", flush=True)
            continue
        same = f"{k['bound_ms']:.3g}" == f"{p['bound_ms']:.3g}"
        print(f"[bounds] {k['name']}: {k['bound_ms']:.6g} ms ({k['bound_by']}"
              f"), {path}: {p['bound_ms']:.6g} ms ({p['bound_by']})"
              f"{'' if same else ' DIFFERENT'}", flush=True)
        check(same and k["bound_by"] == p["bound_by"],
              f"bound of {k['name']} moved: {k['bound_ms']} vs "
              f"{p['bound_ms']}")


def run_alone(phase, gen, smi, timed, phase_s, t_start):
    """``--phase N``: only phase N after the build, for the phases that
    need no earlier phase's output (2, 3, 7: the kernel checks; 22 and
    23: their own full-width weights, seeded as phase 5's; 23 alone also
    times the CLI's steady megaticks), then the kernels line, the card
    and the last line as a whole run prints them."""
    kernels = []
    if phase == "2":
        timed("2 gemm", phase_gemm, gen)
    elif phase == "3":
        timed("3 decode", phase_decode, gen)
    elif phase == "7":
        timed("7a ag_gemm", phase_ag_gemm, gen)
        timed("7b paged ranks", phase_paged_ranks, gen)
        timed("7c strided", phase_strided, gen)
        timed("7d graph replays", phase_graph_replays, gen)
    elif phase == "22":
        from repro_torch.configs import get_config
        from repro_torch.models import lm
        params = lm.init_params(get_config("llama3-8b"), seed=0,
                                device="cuda")
        out, kernels = timed("22 serve on a data mesh",
                             phase_serve_data_mesh, gen, params)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_phase22.json"),
                  "w") as f:
            json.dump({"device": smi, "serve_data_mesh": out,
                       "kernels": kernels, "phase_s": phase_s}, f, indent=1)
    elif phase == "23":
        from repro_torch.configs import get_config
        from repro_torch.models import lm
        params = lm.init_params(get_config("llama3-8b"), seed=0,
                                device="cuda")
        out = timed("23 born sharded", phase_born_sharded, params, True)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_phase23.json"),
                  "w") as f:
            json.dump({"device": smi, "born_sharded": out,
                       "phase_s": phase_s}, f, indent=1)
    else:
        print(f"chip_smoke: --phase {phase}: only 2, 3, 7, 22 and 23 run "
              f"alone (the others take earlier phases' outputs)",
              file=sys.stderr)
        sys.exit(2)
    print("[phases] " + ", ".join(f"{k} {v:.1f} s"
                                  for k, v in phase_s.items()), flush=True)
    print(f"[total] {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a "
              "GPU", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    t0 = time.time()
    logs = _build.build_all(verbose="--verbose" in sys.argv)
    build_s = time.time() - t0
    print(f"[build] {len(logs)} kernel libraries built in {build_s:.1f} s",
          flush=True)
    if "--verbose" in sys.argv:
        for name, log in logs.items():
            print(f"--- {name}\n{log}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    phase_s = {"build": build_s}    # seconds of each phase, in order

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        phase_s[name] = time.time() - t0
        return out
    if "--phase" in sys.argv:
        return run_alone(sys.argv[sys.argv.index("--phase") + 1], gen, smi,
                         timed, phase_s, t_start)
    errs = {"gemm": timed("2 gemm", phase_gemm, gen),
            "decode": timed("3 decode", phase_decode, gen),
            "ag_gemm_fused": timed("7a ag_gemm", phase_ag_gemm, gen),
            "flash_decode_paged_fused": timed(
                "7b paged ranks", phase_paged_ranks, gen),
            "flash_decode_fused": timed("7c strided", phase_strided, gen)}
    timed("7d graph replays", phase_graph_replays, gen)
    if "--kernels-only" in sys.argv:
        return
    if "--peers" in sys.argv:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_peers.json"), "w") as f:
            json.dump({"device": smi, "count": torch.cuda.device_count(),
                       "rows": phase_real_peers(gen)}, f, indent=1)
        return
    small = timed("4 small", phase_small_model)
    timed("8 small ranks", phase_small_model_ranks, *small)
    robust = timed("11a robust small", phase_robust_small, *small[:3])
    params, summary, lens = timed("5 full width", phase_full_width)
    summary["graph_vs_eager_megaticks"] = timed(
        "5b graph vs eager", phase_graph_vs_eager, params)
    summary_tp, lens_tp = timed("9 full width ranks",
                                phase_full_width_ranks, params)
    taxes = timed("19 three taxes", phase_taxes, params, smi)
    sharded = timed("20 sharded weights", phase_sharded, params, summary_tp)
    serve_dm, serve_dm_kernels = timed("22 serve on a data mesh",
                                       phase_serve_data_mesh, gen, params)
    born = timed("23 born sharded", phase_born_sharded, params)
    del params
    torch.cuda.empty_cache()
    train, train_kernel = timed("12 training", phase_train, gen)
    train_tp, train_tp_kernel = timed(
        "13 training tp", phase_train_tp, gen, train["full"]["losses"][0],
        train["full"]["grad_norms"][0])
    dm, dm_kernel = timed("21 data mesh", phase_data_mesh, gen,
                          train_tp["full"]["losses"][0])
    moe, moe_kernels = timed("14 moe", phase_moe, gen)
    rec, rec_kernels = timed("15 recurrent", phase_recurrent, gen)
    front, front_kernels = timed("16 frontends", phase_frontends, gen)
    fam, fam_kernels = timed("17 dots + tp families",
                             phase_dots_and_tp_families, gen)
    server = timed("11b server", phase_server, smi)
    kernels, rows = timed("6 timings", phase_timings, gen, lens,
                          summary["launches"], summary["launches_per_step"],
                          errs)
    sampler = timed("6b sampler", sampler_ms, gen)
    c_steps = summary_tp["contiguous_steps"]
    steps = summary_tp["k8"]["decode_steps"]
    errs["flash_decode_fused_w1"] = errs["flash_decode_fused"]
    launches_tp = dict(summary_tp["launches"])
    launches_tp["flash_decode_fused"] = summary_tp["contiguous_launches"][
        "tp"]
    launches_tp["flash_decode_fused_w1"] = summary_tp[
        "contiguous_launches"]["w1"]
    kernels += timed("10 timings ranks", phase_timings_ranks,
                     gen, lens_tp, launches_tp,
                     {"ag_gemm_fused": steps,
                      "flash_decode_paged_fused": steps,
                      "flash_decode_fused": c_steps,
                      "flash_decode_fused_w1": c_steps}, errs)
    kernels += ([train_kernel, train_tp_kernel, dm_kernel] + moe_kernels
                + rec_kernels + front_kernels + sharded["kernels"]
                + serve_dm_kernels)
    dry = timed("18 dry run vs card", phase_dryrun, smi, train, train_tp,
                moe, front, fam, summary, kernels[0]["host_us_per_call"],
                sharded)
    if "--bounds-against" in sys.argv:
        check_bounds(kernels, sys.argv[sys.argv.index("--bounds-against")
                                       + 1])
    for k in kernels:
        print(f"[time] {k['name']}: {k['ms']:.3f} ms per step (bound "
              f"{k['bound_ms']:.3f}, plain {k['plain_ms']:.3f}, library "
              f"{k['library_ms']:.3f})", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "build_s": build_s, "serve": summary,
                   "serve_tp": summary_tp, "kernels": kernels,
                   "sampler": sampler, "gemm_shapes": rows,
                   "robust_small": robust, "server": server,
                   "train": train, "train_tp": train_tp, "moe": moe,
                   "recurrent": rec, "frontends": front,
                   "dots_tp_families": fam,
                   "dots_tp_family_kernels": fam_kernels,
                   "dryrun_vs_card": dry, "taxes": taxes,
                   "sharded": sharded, "data_mesh": dm,
                   "serve_data_mesh": serve_dm, "born_sharded": born,
                   "phase_s": phase_s, "total_s": time.time() - t_start},
                  f, indent=1)
    print("[phases] " + ", ".join(f"{k} {v:.1f} s"
                                  for k, v in phase_s.items()), flush=True)
    print(f"[total] {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
