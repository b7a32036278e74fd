"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--kernels-only | --peers] [--verbose]

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
6. W=1 kernel timings (the GEMM per shape and per group, its latency
   floor, the host's time per call of the GEMM wrappers beside
   ``torch.matmul``'s, and the sampler's time per step) and
10. W-rank kernel timings (and the contiguous decode at W = 1), both in
   CUDA-graph replays, each beside its bound, plain version and one
   PyTorch library call (phase 10 also times an empty cooperative
   launch of the paged decode's grid, its latency floor).

``--kernels-only`` stops after phases 1-3 and 7; ``--peers`` (two or
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

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")   # git-ignored run outputs
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


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


def _kernel_launches(fn, name):
    """Launches of csrc kernel ``name`` (and of all the port's kernels)
    in one ``fn()`` call, from the profiler's device trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()                  # buffers sized, lib loaded
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    return (sum(e.count for e in ev if port_kernel(name, e.key)),
            sum(e.count for e in ev for k in PORT_KERNELS
                if port_kernel(k, e.key)))


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
            mine, port = _kernel_launches(call, "fd_strided")
            counter = (wrapper.launches - n0) // 2    # warm-up + traced call
            check(counter == cards and mine == cards and port == cards,
                  f"strided W={W} {mode}: {counter} counted, {mine} "
                  f"fd_strided and {port} port kernels traced per call; "
                  f"want {cards}")
            counted.append(f"W={W} {mode}")
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


def _serve_small(params, cfg, reqs, dev, K=1, sampler="greedy", ctx=None):
    """Serve ``reqs`` on the smoke model; returns (streams, counters
    (ticks, dispatches, mixed dispatches, preemptions, prefix hits),
    the engine's metrics)."""
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
        c0 = m.get("graph_captures", 0)
        done_b, wall_b, ticks_b = _drive_timed(eng, reqs_b)
        toks_b = sum(len(r.out_tokens) for r in done_b)
        dev_ms = sum(t[2] for t in ticks_b)
        # the steady megatick: a pure one of the full length K
        steady = [t for t in ticks_b if t[1] == ("pure", K)]
        out.update({
            "steady_wall_s": wall_b, "steady_tokens_per_s": toks_b / wall_b,
            "steady_ms_per_token": 1e3 * wall_b / max(toks_b, 1),
            "steady_captures": eng.metrics(done_b)["graph_captures"] - c0,
            "steady_replay_device_ms": dev_ms,
            "steady_busy_share": dev_ms / (1e3 * wall_b),
            "pure_megaticks": len(steady),
            "pure_megatick_wall_ms": (1e3 * sum(t[0] for t in steady)
                                      / max(len(steady), 1)),
            "pure_megatick_device_ms": (sum(t[2] for t in steady)
                                        / max(len(steady), 1))})
        out["pure_megatick_busy_share"] = (
            out["pure_megatick_device_ms"] / out["pure_megatick_wall_ms"]
            if steady else 0.0)
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
    tables and the KV pools' bytes must be identical (the mixed and the
    pure megaticks both run)."""
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
        for key in ("k", "v"):
            check(torch.equal(sa["caches"][key].view(torch.int16),
                              sb["caches"][key].view(torch.int16)),
                  f"graph vs eager: the {key} pool differs at tick "
                  f"{engs[0].tick_count}")
        n += 1
    check(paths == {"pure", "mixed"}, f"graph vs eager: paths {paths}")
    m = engs[0].metrics(done[0])
    check(m["graph_replays"] == m["dispatches"] and
          engs[1].metrics(done[1])["graph_replays"] == 0,
          "graph vs eager: the engines did not take their routes")
    print(f"[graph vs eager] full width K={K}: {n} megaticks (pure and "
          f"mixed, {m['graph_count']} graphs) bit-identical to the eager "
          f"loop: tokens, cur_len, tables, KV pool bytes", flush=True)
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
               "teacher_forced_max_abs_logit": ref, "profile": profile}
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


def phase_timings(gen, lens, launches, per_step, errs):
    """Per-decode-step device times (CUDA-graph replays) of both kernels
    at the full-width shapes, beside the plain version, one library call
    and the bound; ``eager_ms`` keeps the eager time, host launch cost
    included. The GEMM is timed per shape (one product a launch) and per
    group (wq/wk/wv, wg/wu in one launch each, as the main path runs
    them); its step total takes the groups."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode_paged,
                                                  paged_decode_plain)
    from repro_torch.kernels.matmul import (matmul, matmul_group,
                                            matmul_plain)
    B = 8
    rows = {}

    def time_row(name, a, ws, call, lib, plain, count, **extra):
        """Graph-timed ``call(ws)`` (and eager, library, plain) with the
        weights cycled through enough copies to overflow the 50 MB L2,
        as the layers' distinct weights do on the main path."""
        per = nbytes(*ws)
        copies = min(32, max(2, int(-(-256e6 // per))))
        sets = [ws] + [[torch.empty_like(w).copy_(w) for w in ws]
                       for _ in range(copies - 1)]
        cyc = itertools.cycle(sets)
        t_e = time_ms(lambda: call(next(cyc)))
        t_k = graph_ms(lambda: call(next(cyc)))
        t_l = graph_ms(lambda: lib(next(cyc)))
        t_p = (graph_ms(lambda: plain(next(cyc)), iters=5)
               if plain is not None else None)
        by = nbytes(a, *ws) + sum(B * (w.shape[0] if extra.get("trans_b")
                                       else w.shape[1]) * a.element_size()
                                  for w in ws)
        flops = sum(2 * B * w.numel() for w in ws)
        rows[name] = {"shape": name, "M": B, "K": a.shape[1],
                      "dtype": str(a.dtype).replace("torch.", ""),
                      "count_per_step": count, "ms": t_k, "eager_ms": t_e,
                      "plain_ms": t_p, "library_ms": t_l, "bytes": by,
                      "bound_ms": 1e3 * max(by / HBM_BYTES_PER_S,
                                            flops / PEAK_OPS[a.dtype]),
                      "ops_s": flops / PEAK_OPS[a.dtype], **extra}
        del sets, cyc
        torch.cuda.empty_cache()

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
    gemm_bound_bytes = tot["bytes"] / HBM_BYTES_PER_S
    gemm = {"name": "matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/matmul.cu",
            "replaces": "src/repro/kernels/matmul.py:34",
            "launches": launches["matmul"],
            "launches_per_step": per_step["matmul"],
            "max_abs_err": errs["gemm"],
            "ms": tot["ms"], "kernel_ms": tot["ms"],
            "ungrouped_ms": ungrouped_ms,
            "eager_ms": tot["eager_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": 1e3 * max(gemm_bound_bytes, tot["ops_s"]),
            "bound_by": ("bytes" if gemm_bound_bytes >= tot["ops_s"]
                         else "operations"),
            "library_ms": tot["library_ms"],
            "latency_floor_ms": {str(n): t for n, t in floor.items()},
            "host_us_per_call": host,
            "unit": f"one decode step at batch 8 "
                    f"({per_step['matmul']:g} launches: per layer wq/wk/wv "
                    f"grouped, wo, wg/wu grouped, wd; the unembed)"}

    # paged decode at the served lengths (prompt + 32 new tokens)
    bs, H, KVH, D = 16, 32, 8, 128
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
    ops_t = sum(4 * n * H * D for n in lens) / PEAK_OPS[torch.bfloat16]
    per = per_step["flash_decode_paged"]     # one launch per layer
    dec_bound = max(by / HBM_BYTES_PER_S, ops_t)
    decode = {"name": "flash_decode_paged", "route": "cuda",
              "source": "src/repro_torch/csrc/flash_decode_paged.cu",
              "replaces": "src/repro/kernels/flash_decode.py:272",
              "launches": launches["flash_decode_paged"],
              "launches_per_step": per_step["flash_decode_paged"],
              "max_abs_err": errs["decode"],
              "ms": per * t_k, "kernel_ms": per * t_k,
              "eager_ms": per * t_e, "plain_ms": per * t_p,
              "library_ms": per * t_l,
              "bound_ms": 1e3 * per * dec_bound,
              "bound_by": ("bytes" if by / HBM_BYTES_PER_S >= ops_t
                           else "operations"),
              "unit": f"one decode step at batch 8, {per:g} launches, "
                      f"cur_len {lens}, gather width {gw}"}
    return [gemm, decode], list(rows.values())


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
    from repro_torch.kernels import _build, symm
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels.ag_gemm import ag_gemm_fused, ag_gemm_plain
    L, B, H, KVH, D, bs = 32, len(lens), 32, 8, 128, 16
    mesh = Mesh(["cuda:0"] * tp)
    bf16 = torch.bfloat16
    rows = []

    def row(name, source, replaces, call_ms, plain_ms, lib_ms, by, ops_t,
            unit, **extra):
        per = launches[name] / steps[name]
        bound = max(by / HBM_BYTES_PER_S, ops_t)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "launches_per_step": per,
                     "max_abs_err": errs[name], "ms": per * call_ms,
                     "call_ms": call_ms, "plain_ms": per * plain_ms,
                     "bound_ms": 1e3 * per * bound,
                     "bound_by": ("bytes" if by / HBM_BYTES_PER_S >= ops_t
                                  else "operations"),
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
        tp * 2 * M * K * N / PEAK_OPS[bf16],
        f"one decode step at batch {B} over {tp} virtual ranks "
        f"(wo: {M}x{K} . {K}x{N} bf16 per layer)")
    del bw, cyc
    torch.cuda.empty_cache()

    # fused paged decode at the served lengths
    n_blocks = B * 16
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    gw = 1
    while gw < -(-max(lens) // bs):
        gw *= 2
    q, kp, vp, full = _decode_inputs(gen, bf16, B=B, H=H, KVH=KVH, D=D,
                                     bs=bs, C=gw, n_blocks=n_blocks)
    tb = full[:, :gw].contiguous()
    n_loc = n_blocks // tp
    kps = [kp[r * n_loc:(r + 1) * n_loc].contiguous() for r in range(tp)]
    vps = [vp[r * n_loc:(r + 1) * n_loc].contiguous() for r in range(tp)]
    scale = D ** -0.5
    args = ([q] * tp, kps, vps, [cl] * tp, [tb] * tp, scale)
    t_k = graph_ms(lambda: kfd.flash_decode_paged_fused(*args, mesh=mesh),
                   iters=50)
    plan = kfd.decode_plan(B, KVH, tp, gw, symm.sm_count("cuda:0"),
                           symm.capacity("cuda:0", kfd._per_sm_query(), D,
                                         H // KVH, 1))
    empty = _build.load("flash_decode_paged").symm_empty_launch
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    t_floor = graph_ms(lambda: _build.check(empty(
        plan.grid, 128, torch.cuda.current_stream().cuda_stream),
        "symm_empty_launch"), iters=50)

    def paged_plain():
        return kfd.fused_plain(
            [kfd.paged_partial_plain(q, kps[r], vps[r], cl, tb, scale,
                                     base=r * n_loc) for r in range(tp)],
            bf16)
    t_p = time_ms(paged_plain, iters=5)
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
          + nbytes(tb) + tp * nbytes(q))
    row("flash_decode_paged_fused", "src/repro_torch/csrc/"
        "flash_decode_paged.cu", "src/repro/kernels/flash_decode.py:272",
        t_k, t_p, t_l, by,
        sum(4 * n * H * D for n in lens) / PEAK_OPS[bf16],
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
        sum(4 * n * H * D for n in lens) / PEAK_OPS[bf16],
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
        sum(4 * n * H * D for n in lens) / PEAK_OPS[bf16],
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
    ops_s = 2 * M * N * K / PEAK_OPS[dt]
    by_s = (M * K + K * N + M * N) * torch.tensor([], dtype=dt) \
        .element_size() / HBM_BYTES_PER_S
    return max(ops_s, by_s), "operations" if ops_s >= by_s else "bytes"


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


def phase_train_full(gem_rows):
    """(12c) llama3-8b at full width, depth cut to TRAIN_LAYERS, bf16
    compute with fp32 masters and AdamW, remat full: TRAIN_STEPS steps
    of 2 x 1024 tokens through ``launch.train.train`` with warmup = the
    steps. Checks the losses finite and the last below the first, the
    GEMM launches of every step, no plain call, and peak memory below 80
    GB; then one more step under the profiler for the GEMM's device
    time. Returns the run's numbers."""
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
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train full width: losses {losses}")
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
    ops_s = sum(c * 2 * m * k * n / PEAK_OPS[dt]
                for _, _, m, k, n, dt, _, c in prods)
    bytes_s = sum(c * (m * k + k * n + m * n) * (4 if dt == torch.float32
                                                   else 2) / HBM_BYTES_PER_S
                  for _, _, m, k, n, dt, _, c in prods)
    out = {"config": f"llama3-8b full width, {cfg.n_layers} of 32 layers, "
                     f"bf16 compute, fp32 masters, remat full",
           "params": n_params, "tokens_per_step": M,
           "steps": TRAIN_STEPS, "lr": TRAIN_LR, "losses": losses,
           "grad_norms": grad_norms, "step_s": steps_s, "ms_per_step": 1e3 * step_s,
           "tokens_per_s": M / step_s, "run_s": run_s,
           "flops_per_step": flops, "gemm_flops_per_step": gemm_flops,
           "tflops_per_s": flops / step_s / 1e12,
           "peak_share": flops / step_s / PEAK_OPS[torch.bfloat16],
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
           "bound_by": "operations" if ops_s >= bytes_s else "bytes"}
    print(f"[train full] {out['config']}: {n_params / 1e9:.3f} B "
          f"parameters; losses {[round(x, 4) for x in losses]}; "
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
# gap and the gradient norm's relative gap, ~5x and ~1.5x what one H100
# measured (9.7e-5 and 6.5e-3; PERF.md). Both runs are deterministic on
# the card but for the embedding backward's atomics, so the gaps repeat.
TP_LOSS_ATOL = 5e-4
TP_GNORM_RTOL = 1e-2


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
    (the same seeded init as 12c, sharded). Checks the losses finite;
    the first within TP_LOSS_ATOL of 12c's first and the first gradient
    norm within TP_GNORM_RTOL of 12c's first (the same parameters and
    batch: bf16 sums round at other places over the ranks; the loss at
    init sits near ln V whatever the layers compute, so the gradient
    norm, which every leaf's gradient feeds, is the sharper check); the
    GEMM launches of every step (``tp_products``), no plain call, peak
    memory below 80 GB; then one more step under the profiler: device
    busy share, GEMM ms and launches. Returns the run's numbers."""
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
    check(gnorm_gap <= TP_GNORM_RTOL, f"tp full width: first grad norm "
          f"{gnorms[0]} vs 12c's {step0_gnorm} ({gnorm_gap:.3e} relative)")
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
    busy = dev_ms / (1e3 * prof_wall)
    out = {"config": f"llama3-8b full width, {cfg.n_layers} of 32 layers, "
                     f"tp {TP} virtual ranks, fusion mode {TP_MODE}, bf16 "
                     f"compute, fp32 masters, remat full",
           "tokens_per_step": M, "steps": TP_STEPS, "losses": losses,
           "grad_norms": gnorms, "step0_loss_12c": step0_loss,
           "step0_grad_norm_12c": step0_gnorm, "step0_loss_gap": loss_gap,
           "step0_grad_norm_gap": gnorm_gap, "step_s": steps_s,
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
          f"vs 12c's {step0_gnorm:.6f} ({gnorm_gap:.3e} relative); "
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
    ops_s = sum(c * 2 * m * k * n / PEAK_OPS[dt]
                for _, _, m, k, n, dt, _, c in prods)
    bytes_s = sum(c * (m * k + k * n + m * n) * (4 if dt == torch.float32
                                                   else 2) / HBM_BYTES_PER_S
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
              "bound_by": "operations" if ops_s >= bytes_s else "bytes",
              "library_ms": per_step("library_ms"),
              "unit": f"one training step of {full['config']}, "
                      f"{full['tokens_per_step']} tokens"}
    print(f"[tp full] GEMM at tp {TP} a step: {kernel['ms']:.1f} ms "
          f"(profiled), {kernel['kernel_ms_products']:.1f} ms as the sum "
          f"of its products timed alone, plain {kernel['plain_ms']:.1f}, "
          f"torch.matmul {kernel['library_ms']:.1f}, bound "
          f"{kernel['bound_ms']:.1f} ms ({kernel['bound_by']})", flush=True)
    return {"sites": sites, "small": small, "full": full}, kernel


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
    del params
    torch.cuda.empty_cache()
    train, train_kernel = timed("12 training", phase_train, gen)
    train_tp, train_tp_kernel = timed(
        "13 training tp", phase_train_tp, gen, train["full"]["losses"][0],
        train["full"]["grad_norms"][0])
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
    kernels += [train_kernel, train_tp_kernel]
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
                   "train": train, "train_tp": train_tp,
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
