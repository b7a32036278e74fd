"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--kernels-only | --peers] [--verbose]

Builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
source, in parallel), then runs, failing on the first phase that fails:

1. device: the card's name and power limit, CUDA present;
2. GEMM kernel vs its plain version at the decode shapes of llama3-8b;
3. paged flash-decode kernel vs its plain version at full-width heads;
7. the W-rank kernels vs their plain versions on virtual ranks of
   cuda:0, each over several calls in a row (flag reuse, both inbox
   parities): the fused AG+GEMM (W 2 and 4, the ``wo`` shape and
   ragged ones), the paged decode over 4 ranks (fused and partial
   modes, holes, blocks of every rank), the contiguous strided decode
   (W 1 and 4, with a window);
4. the smoke llama3-8b (float32) served on the card and on the CPU:
   token-identical greedy streams, equal scheduling counters, per-step
   logits under teacher forcing within tolerance;
8. the same smoke serve over 4 virtual ranks in every fusion mode:
   streams and counters identical to tp=1;
5. full-width llama3-8b (bf16, seeded random weights) served through
   the engine, with both W=1 kernels' launch counters read around it;
9. the same weights over 4 virtual ranks under ``pallas``: a short
   serve and a few contiguous-cache decode steps with every kernel's
   counters read around them, and teacher-forced logits vs tp=1;
6. W=1 kernel timings (CUDA-graph replays) and
10. W-rank kernel timings (queued behind a sleep kernel), each beside
   its bound, plain version and one PyTorch library call.

``--kernels-only`` stops after phases 1-3 and 7; ``--peers`` (two or
more cards) then runs phase 7's checks and wall times with one rank per
card beside virtual ranks, and stops; ``--verbose`` prints the
compiler's ``ptxas -v`` report. Prints one ``{"kernels": [...]}``
line, the ``nvidia-smi`` name/power line, and as its last line
``{"ok": true, "device": {...}}``. Longer per-shape tables go to
``OUT_DIR/chip_smoke.json``. Exits non-zero, printing no result,
without a GPU or outside a checkout of the repo.
"""
from __future__ import annotations

import copy
import itertools
import json
import os
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


def queued_ms(fn, iters=20):
    """Mean device time of one ``fn()`` call, for calls a CUDA graph
    cannot replay (the fused multi-rank kernels take their epoch as a
    launch argument): a sleep kernel holds the stream while the host
    enqueues ``iters`` calls, so the CUDA events around them time the
    device alone. Retries with a longer sleep if the host fell behind."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold_s = 3 * (time.perf_counter() - t0) * iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(int(hold_s * 2e9))      # cycles, <= ~2 GHz
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()      # the sleep outlasted the enqueue
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / iters
        hold_s *= 4
    raise RuntimeError("queued_ms: the host could not enqueue the calls "
                       "while the stream was held")


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


def _gemm_operands(gen, M, K, N, dtype, trans_b):
    a = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    bshape = (N, K) if trans_b else (K, N)
    b = (torch.randn(bshape, generator=gen, device="cuda")
         / K ** 0.5).to(dtype)
    return a, b


def phase_gemm(gen):
    from repro_torch.kernels.matmul import matmul, matmul_plain
    worst = 0.0
    cases = [(n, M, K, N, dt, tb) for (n, K, N, dt, tb, _) in gemm_cases()
             for M in (1, 3, 8)]
    cases += [("ragged", 5, 100, 77, torch.bfloat16, False),
              ("ragged", 5, 100, 77, torch.float32, False),
              ("ragged_t", 5, 100, 77, torch.float32, True)]
    for name, M, K, N, dt, tb in cases:
        a, b = _gemm_operands(gen, M, K, N, dt, tb)
        got = matmul(a, b, trans_b=tb).float()
        want = matmul_plain(a, b, tb).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        scale = want.abs().max().item()
        if dt == torch.float32:
            # fp32 sums in another order: 1e-4 of the largest |C|
            ok = err.max().item() <= 1e-4 * scale
        else:
            # both round an fp32 sum to bf16: within 1 ulp (rtol 1e-2),
            # plus 1e-4 of the largest |C| for sums near zero
            ok = bool((err <= 1e-2 * want.abs() + 1e-4 * scale).all())
        check(ok, f"GEMM {name} M={M} K={K} N={N} {dt}: max err "
                  f"{err.max().item():.3e} (scale {scale:.3e})")
        if name not in ("ragged", "ragged_t"):
            worst = max(worst, err.max().item())
    print(f"[gemm] {len(cases)} cases match the plain version "
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


def _gemm_close(got, want, dtype, what):
    """AG+GEMM vs plain, with phase_gemm's tolerances."""
    err = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        ok = err.max().item() <= 1e-4 * scale
    else:
        ok = bool((err <= 1e-2 * want.float().abs() + 1e-4 * scale).all())
    check(ok, f"{what}: max err {err.max().item():.3e} (scale "
              f"{scale:.3e})")
    return err.max().item()


VIRTUAL = (["cuda:0"] * 2, ["cuda:0"] * 4)     # virtual ranks of one card


def _sync(devs):
    for d in dict.fromkeys(devs):
        torch.cuda.synchronize(d)


def phase_ag_gemm(gen, epochs=3, rank_sets=VIRTUAL):
    """(7a) fused AG+GEMM vs its plain version on each set of rank
    devices, at the ``wo`` shape and ragged ones, ``epochs`` calls in a
    row with fresh inputs (flag reuse, both inbox parities)."""
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
                got = ag_gemm_fused([x.to(d) for x, d in zip(shards, devs)],
                                    [b.to(d) for d in devs], mesh)
                want = ag_gemm_plain(shards, [b])[0]
                _sync(devs)
                for r in range(W):
                    err = _gemm_close(got[r].to("cuda:0"), want, dt,
                                      f"ag_gemm {devs} M={M} K={W * k} "
                                      f"N={N} {dt} epoch {ep} rank {r}")
                    if dt == torch.bfloat16 and N == 4096:
                        worst = max(worst, err)
                n += 1
    print(f"[ag_gemm] {n} calls on ranks {[len(d) for d in rank_sets]} x "
          f"{sorted({x for d in rank_sets for x in d})} match the plain "
          f"version (max |err| at the wo shape {worst:.3e})", flush=True)
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


def phase_strided(gen, epochs=3, rank_sets=(["cuda:0"], ["cuda:0"] * 4)):
    """(7c) contiguous strided flash decode, fused (at W = 1 the
    single-source path) and its partial mode, vs plain."""
    from repro_torch.core.flash_decode import combine_bsp, finalize
    from repro_torch.distributed.context import Mesh
    from repro_torch.kernels import flash_decode as kfd
    scale = 128 ** -0.5
    worst, n = 0.0, 0
    for devs in rank_sets:
        W = len(devs)
        mesh = Mesh(devs)
        for dt in (torch.float32, torch.bfloat16):
            for window in (None, 100):
                for ep in range(epochs):
                    q, ks, vs, cur = _strided_inputs(gen, dt, W)
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
                    what = f"strided {devs} {dt} window {window} epoch {ep}"
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
    print(f"[strided] {n} fused + partial calls match the plain version "
          f"(max |err| {worst:.3e})", flush=True)
    return worst


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
    """6 staggered requests sharing a 16-token prefix."""
    shared = [int(t) for t in rng.integers(1, vocab, 16)]
    reqs = []
    for i in range(6):
        tail = [int(t) for t in rng.integers(1, vocab, 2 + i)]
        reqs.append((shared + tail, 10, i))
    return reqs


def phase_small_model():
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, Request
    cfg = smoke_config(get_config("llama3-8b")).replace(
        dtype=torch.float32)
    p_cpu = lm.init_params(cfg, seed=0, device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    reqs = _smoke_requests(np.random.default_rng(0), cfg.vocab_size)
    runs = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        eng = Engine(params, cfg, batch=3, max_len=64, prefill_chunk=4,
                     block_size=8, n_blocks=8, device=dev)
        for rid, (prompt, max_new, at) in enumerate(reqs):
            eng.submit(Request(rid=rid, prompt=prompt,
                               max_new_tokens=max_new), at_tick=at)
        done = eng.run()
        runs[dev] = ({r.rid: r.out_tokens for r in done},
                     (eng.tick_count, eng.dispatch_count, eng.preempt_count,
                      eng.pool.prefix_hits))
    check(len(runs["cuda"][0]) == len(reqs), "small model: not all finished")
    check(runs["cuda"][0] == runs["cpu"][0],
          f"small model streams differ: {runs}")
    check(runs["cuda"][1] == runs["cpu"][1],
          f"small model counters differ: {runs['cuda'][1]} vs "
          f"{runs['cpu'][1]}")
    check(runs["cuda"][1][2] >= 1, "small model: no preemption happened")
    check(runs["cuda"][1][3] >= 1, "small model: no prefix hit happened")

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
          f"(ticks, dispatches, preemptions, prefix hits) = "
          f"{runs['cuda'][1]}; teacher-forced logits max |diff| "
          f"{worst:.3e}", flush=True)
    return cfg, p_gpu, reqs, runs["cuda"]


def phase_small_model_ranks(cfg, params, reqs, want, tp=4):
    """(8) the smoke model served over ``tp`` virtual ranks of cuda:0 in
    every fusion mode: greedy streams and counters equal to the tp=1
    run on the card (itself equal to the CPU's)."""
    from repro_torch.distributed import context as dctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import Engine, Request
    mesh = make_mesh(tp, device="cuda")
    for mode in ("auto", "bsp", "ring", "pallas"):
        with dctx.use(dctx.DistContext(mesh, mode)):
            eng = Engine(params, cfg, batch=3, max_len=64, prefill_chunk=4,
                         block_size=8, n_blocks=8, device="cuda")
        for rid, (prompt, max_new, at) in enumerate(reqs):
            eng.submit(Request(rid=rid, prompt=prompt,
                               max_new_tokens=max_new), at_tick=at)
        done = eng.run()
        got = ({r.rid: r.out_tokens for r in done},
               (eng.tick_count, eng.dispatch_count, eng.preempt_count,
                eng.pool.prefix_hits))
        check(got[0] == want[0], f"small model tp={tp} {mode}: streams "
                                 f"differ from tp=1")
        check(got[1] == want[1], f"small model tp={tp} {mode}: counters "
                                 f"{got[1]} != tp=1's {want[1]}")
    print(f"[small tp={tp}] auto, bsp, ring, pallas: streams and counters "
          f"identical to tp=1 on the card and to the CPU", flush=True)


def phase_full_width():
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import flash_decode_paged
    from repro_torch.kernels.matmul import matmul
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, Request
    cfg = get_config("llama3-8b")
    t0 = time.time()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    eng = Engine(params, cfg, batch=8, max_len=512, block_size=16,
                 prefill_chunk=8, device="cuda")
    rng = np.random.default_rng(0)
    plens = [int(n) for n in rng.integers(32, 129, 8)]
    for rid, n in enumerate(plens):
        prompt = [int(t) for t in rng.integers(1, cfg.vocab_size, n)]
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=32),
                   at_tick=2 * rid)
    torch.cuda.reset_peak_memory_stats()
    for fn in (matmul, flash_decode_paged):
        fn.launches = 0
        fn.plain_calls = 0
    # count decode steps (one per token position of the batch) by
    # wrapping the step function the engine and decode_chunk call
    step_fn, steps_run = lm.decode_step, [0]

    def counted_step(*args, **kwargs):
        steps_run[0] += 1
        return step_fn(*args, **kwargs)
    lm.decode_step = counted_step
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        done = eng.run()
        torch.cuda.synchronize()
    finally:
        lm.decode_step = step_fn
    wall = time.time() - t0
    steps = steps_run[0]
    counts = {"matmul": (matmul.launches, matmul.plain_calls),
              "flash_decode_paged": (flash_decode_paged.launches,
                                     flash_decode_paged.plain_calls)}
    peak = torch.cuda.max_memory_allocated()
    check(len(done) == 8, f"full width: {len(done)} of 8 finished")
    for r in done:
        check(len(r.out_tokens) == 32, f"request {r.rid}: "
                                       f"{len(r.out_tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"request {r.rid}: token id outside the vocabulary")
    for name, (launches, plain) in counts.items():
        check(launches > 0, f"{name}: no kernel launch on the main path")
        check(plain == 0, f"{name}: {plain} plain-version calls on the "
                          f"main path")
    check(steps > 0, "full width: no decode step ran")
    check(counts["matmul"][0] == steps * (7 * cfg.n_layers + 1)
          and counts["flash_decode_paged"][0] == steps * cfg.n_layers,
          f"launches {counts} != (225, 32) per step x {steps} steps")
    toks = sum(len(r.out_tokens) for r in done)
    m = eng.metrics(done)
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
    summary = {"requests": len(done), "new_tokens": toks,
               "prompt_tokens": sum(plens), "wall_s": wall,
               "tokens_per_s": toks / wall, "decode_steps": steps,
               "mean_decode_step_ms": 1e3 * wall / max(steps, 1),
               "ticks": m["ticks"], "dispatches": m["dispatches"],
               "peak_mem_bytes": peak, "init_s": init_s,
               "launches": {k: v[0] for k, v in counts.items()},
               "launches_per_step": {k: v[0] / steps
                                     for k, v in counts.items()},
               "p50_ttft_s": m["p50_ttft_s"], "p50_tpot_s": m["p50_tpot_s"],
               "profile": profile}
    print(f"[full] llama3-8b bf16 served {toks} tokens in {wall:.2f} s: "
          f"{toks / wall:.2f} tok/s, {steps} decode steps, "
          f"{1e3 * wall / max(steps, 1):.2f} ms/step, peak "
          f"{peak / 1e9:.2f} GB, launches {summary['launches']}",
          flush=True)
    lens = [n + 32 for n in plens]
    return params, summary, lens


def _counted(fns):
    """Zero the launch and plain-call counters of ``fns``."""
    for fn in fns:
        fn.launches = 0
        fn.plain_calls = 0


def _teacher_forced(params, cfg, tok, ctx):
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
            (4,), 8, device="cuda"), st, cfg)
    return lg.float()


def phase_full_width_ranks(params, tp=4):
    """(9) full-width llama3-8b (bf16) over ``tp`` virtual ranks of
    cuda:0 under ``pallas``: a short serve through the engine (paged
    pool, fused paged decode + fused AG+GEMM) and a few steps of the
    contiguous-cache ``lm.decode_step`` (fused strided decode), with
    every kernel's counters zeroed just before and read just after;
    then one teacher-forced chunk against the tp=1 logits."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import context as dctx
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels.ag_gemm import ag_gemm_fused
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, Request
    cfg = get_config("llama3-8b")
    L = cfg.n_layers
    ctx = dctx.DistContext(make_mesh(tp, device="cuda"), "pallas")
    with dctx.use(ctx):
        eng = Engine(params, cfg, batch=4, max_len=256, block_size=16,
                     prefill_chunk=8, device="cuda")
    rng = np.random.default_rng(1)
    plens = [int(n) for n in rng.integers(16, 49, 4)]
    for rid, n in enumerate(plens):
        prompt = [int(t) for t in rng.integers(1, cfg.vocab_size, n)]
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=16),
                   at_tick=rid)
    fused = (ag_gemm_fused, kfd.flash_decode_paged_fused,
             kfd.flash_decode_fused)
    others = (kfd.flash_decode_paged, kfd.flash_decode_paged_partial,
              kfd.flash_decode_partial)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counted((matmul, *fused, *others))
    step_fn, steps_run = lm.decode_step, [0]

    def counted_step(*args, **kwargs):
        steps_run[0] += 1
        return step_fn(*args, **kwargs)
    lm.decode_step = counted_step
    t0 = time.time()
    try:
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        steps = steps_run[0]
        serve_launches = {f.__name__: f.launches for f in (matmul, *fused)}
        # the contiguous-cache path: 4 steps over a strided cache
        c_steps = 4
        with dctx.use(ctx), torch.inference_mode():
            st = lm.init_decode_state(params, cfg, 4, 256)
            tok = torch.randint(1, cfg.vocab_size, (4, 1), device="cuda")
            for _ in range(c_steps):
                lg_c, _ = step_fn(params, tok, st, cfg)
                tok = lg_c[:, 0].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
    finally:
        lm.decode_step = step_fn
    launches = {f.__name__: f.launches for f in (matmul, *fused, *others)}
    plain = {f.__name__: f.plain_calls for f in (matmul, *fused, *others)}
    peak = torch.cuda.max_memory_allocated()
    check(len(done) == 4, f"full width tp={tp}: {len(done)} of 4 finished")
    for r in done:
        check(len(r.out_tokens) == 16 and all(
            0 <= t < cfg.vocab_size for t in r.out_tokens),
            f"full width tp={tp}: request {r.rid} tokens {r.out_tokens}")
    check(all(n == 0 for n in plain.values()),
          f"full width tp={tp}: plain-version calls {plain}")
    check(all(launches[f.__name__] > 0 for f in (matmul, *fused)),
          f"full width tp={tp}: a kernel was not launched: {launches}")
    check(all(launches[f.__name__] == 0 for f in others),
          f"full width tp={tp} pallas went through another mode's "
          f"kernels: {launches}")
    check(serve_launches == {"matmul": steps * (6 * L + 1),
                             "ag_gemm_fused": steps * L,
                             "flash_decode_paged_fused": steps * L,
                             "flash_decode_fused": 0},
          f"full width tp={tp}: serve launches {serve_launches} for "
          f"{steps} steps")
    check(launches["flash_decode_fused"] == c_steps * L,
          f"contiguous path: {launches['flash_decode_fused']} launches")
    check(bool(torch.isfinite(lg_c).all()), "contiguous path: non-finite")
    toks = sum(len(r.out_tokens) for r in done)

    # teacher forcing: one 8-token chunk at tp=1 and at tp on the served
    # bf16 weights and on the same weights unrounded (float32)
    cfg32 = cfg.replace(dtype=torch.float32)
    p32 = lm.init_params(cfg32, seed=0, device="cuda")
    tok = torch.randint(1, cfg.vocab_size, (4, 8), device="cuda")
    out = {(dt, W): _teacher_forced(p, c, tok, ctx if W > 1 else None)
           for dt, p, c in ((16, params, cfg), (32, p32, cfg32))
           for W in (1, tp)}
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
    # layers; the tp path must stay within the bf16 model's own distance
    # from its unrounded (float32) weights
    diff = (out[16, tp] - out[16, 1]).abs().max().item()
    own = (out[16, 1] - out[32, 1]).abs().max().item()
    check(diff <= own, f"bf16 tp={tp} vs tp=1 logits: max |diff| "
                       f"{diff:.3e} > the bf16 model's own error {own:.3e}")
    ref = out[16, 1].abs().max().item()
    summary = {"tp": tp, "fusion_mode": "pallas", "requests": len(done),
               "new_tokens": toks, "prompt_tokens": sum(plens),
               "wall_s": wall, "tokens_per_s": toks / wall,
               "decode_steps": steps,
               "mean_decode_step_ms": 1e3 * wall / max(steps, 1),
               "peak_mem_bytes": peak, "launches": launches,
               "serve_launches_per_step": {k: v / steps for k, v in
                                           serve_launches.items()},
               "contiguous_steps": c_steps,
               "teacher_forced_max_abs_diff": diff,
               "teacher_forced_bf16_vs_f32_max_abs_diff": own,
               "teacher_forced_f32_max_abs_diff": d32.max().item(),
               "teacher_forced_max_abs_logit": ref, "profile": profile}
    print(f"[full tp={tp}] llama3-8b bf16 pallas served {toks} tokens in "
          f"{wall:.2f} s: {toks / wall:.2f} tok/s, {steps} decode steps, "
          f"{1e3 * wall / max(steps, 1):.2f} ms/step, peak "
          f"{peak / 1e9:.2f} GB, launches {launches}; teacher-forced "
          f"logits vs tp=1 max |diff| {diff:.3e} bf16 (bf16 vs float32 "
          f"weights {own:.3e}, max |logit| {ref:.3e}), "
          f"{d32.max().item():.3e} float32", flush=True)
    return summary, [n + 16 for n in plens]


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
                            k[2] / steps} for k in kern[:10]]}
    print(f"[profile] {label}: wall {wall_ms:.2f} ms, device "
          f"{dev_ms:.2f} ms (busy share {out['device_busy_share']:.3f}); "
          f"top: " + "; ".join(f"{k['name'][:40]} {k['ms_per_step']:.2f} ms"
                               for k in out["top_kernels"][:4]), flush=True)
    return out


def phase_timings(gen, lens, launches, per_step, errs):
    """Per-decode-step device times (CUDA-graph replays) of both kernels
    at the full-width shapes, beside the plain version, one library call
    and the bound; ``eager_ms`` keeps the eager time, host launch cost
    included."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode_paged,
                                                  paged_decode_plain)
    from repro_torch.kernels.matmul import matmul, matmul_plain
    B = 8
    rows = []
    tot = dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0,
               ops_t=0.0)
    for name, K, N, dt, tb, count in gemm_cases():
        a, b0 = _gemm_operands(gen, B, K, N, dt, tb)
        # rotate through enough weight copies to overflow the 50 MB L2,
        # as the layers' distinct weights do on the main path
        copies = max(2, int(-(-256e6 // nbytes(b0))))
        bs_ = [b0] + [torch.empty_like(b0).copy_(b0) for _ in
                      range(min(copies, 32) - 1)]
        cyc = itertools.cycle(bs_)
        t_e = time_ms(lambda: matmul(a, next(cyc), trans_b=tb))
        t_k = graph_ms(lambda: matmul(a, next(cyc), trans_b=tb))
        t_p = graph_ms(lambda: matmul_plain(a, next(cyc), tb), iters=5)
        if tb:
            t_l = graph_ms(lambda: torch.matmul(a, next(cyc).T))
        else:
            t_l = graph_ms(lambda: torch.matmul(a, next(cyc)))
        by = nbytes(a, b0) + B * N * a.element_size()
        ops_t = 2 * B * K * N / PEAK_OPS[dt]
        rows.append({"shape": name, "M": B, "K": K, "N": N,
                     "dtype": str(dt).replace("torch.", ""),
                     "count_per_step": count, "ms": t_k, "eager_ms": t_e,
                     "plain_ms": t_p,
                     "library_ms": t_l,
                     "bound_ms": 1e3 * max(by / HBM_BYTES_PER_S, ops_t)})
        tot["ms"] += count * t_k
        tot["eager_ms"] += count * t_e
        tot["plain_ms"] += count * t_p
        tot["library_ms"] += count * t_l
        tot["bytes"] += count * by
        tot["ops_t"] += count * ops_t
        del bs_, cyc, a, b0
        torch.cuda.empty_cache()
    gemm_bound_bytes = tot["bytes"] / HBM_BYTES_PER_S
    gemm = {"name": "matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/matmul.cu",
            "replaces": "src/repro/kernels/matmul.py:34",
            "launches": launches["matmul"],
            "launches_per_step": per_step["matmul"],
            "max_abs_err": errs["gemm"],
            "ms": tot["ms"], "kernel_ms": tot["ms"],
            "eager_ms": tot["eager_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": 1e3 * max(gemm_bound_bytes, tot["ops_t"]),
            "bound_by": ("bytes" if gemm_bound_bytes >= tot["ops_t"]
                         else "operations"),
            "library_ms": tot["library_ms"],
            "unit": f"one decode step at batch 8 "
                    f"({per_step['matmul']:g} launches)"}

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
    return [gemm, decode], rows


def phase_timings_ranks(gen, lens, launches, steps, errs, tp=4):
    """(10) device time per call and per decode step of the three W-rank
    kernels at the shapes of phase 9 (tp virtual ranks, batch 4, the
    served lengths), beside their bound, their plain version (timed
    eagerly: it synchronises the host) and one PyTorch library call the
    port never makes. B of the AG+GEMM (the
    33.5 MB ``wo``) is cycled through copies that overflow the 50 MB L2,
    as the layers' distinct weights do."""
    import torch.nn.functional as F
    from repro_torch.distributed.context import Mesh
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
    t_k = queued_ms(ag, iters=40)
    t_p = time_ms(lambda: ag_gemm_plain(shards, [next(cyc)] * tp),
                  iters=10)
    t_l = graph_ms(lambda: torch.matmul(a, next(cyc)), iters=40)
    by = nbytes(*shards) + nbytes(b0) + tp * M * N * 2
    row("ag_gemm_fused", "src/repro_torch/csrc/ag_gemm.cu",
        "src/repro/kernels/ag_gemm.py:114", t_k, t_p, t_l, by,
        tp * 2 * M * K * N / PEAK_OPS[bf16],
        f"one decode step at batch {B} over {tp} virtual ranks "
        f"(wo: {M}x{K} . {K}x{N} bf16 per layer)",
        bound_b_w_times_ms=1e3 * launches["ag_gemm_fused"]
        / steps["ag_gemm_fused"] * (by + (tp - 1) * nbytes(b0))
        / HBM_BYTES_PER_S)
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
    t_k = queued_ms(lambda: kfd.flash_decode_paged_fused(*args, mesh=mesh),
                    iters=50)

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
        f"{lens}, gather width {gw}")

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
    t_k = queued_ms(lambda: kfd.flash_decode_fused(*args, mesh=mesh),
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
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a "
              "GPU", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

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
    errs = {"gemm": phase_gemm(gen), "decode": phase_decode(gen),
            "ag_gemm_fused": phase_ag_gemm(gen),
            "flash_decode_paged_fused": phase_paged_ranks(gen),
            "flash_decode_fused": phase_strided(gen)}
    if "--kernels-only" in sys.argv:
        return
    if "--peers" in sys.argv:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_peers.json"), "w") as f:
            json.dump({"device": smi, "count": torch.cuda.device_count(),
                       "rows": phase_real_peers(gen)}, f, indent=1)
        return
    phase_small_model_ranks(*phase_small_model())
    params, summary, lens = phase_full_width()
    summary_tp, lens_tp = phase_full_width_ranks(params)
    del params
    torch.cuda.empty_cache()
    kernels, rows = phase_timings(gen, lens, summary["launches"],
                                  summary["launches_per_step"], errs)
    c_steps = summary_tp["contiguous_steps"]
    steps = summary_tp["decode_steps"]
    kernels += phase_timings_ranks(
        gen, lens_tp, summary_tp["launches"],
        {"ag_gemm_fused": steps + c_steps,
         "flash_decode_paged_fused": steps,
         "flash_decode_fused": c_steps}, errs)
    for k in kernels:
        print(f"[time] {k['name']}: {k['ms']:.3f} ms per step (bound "
              f"{k['bound_ms']:.3f}, plain {k['plain_ms']:.3f}, library "
              f"{k['library_ms']:.3f})", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "build_s": build_s, "serve": summary,
                   "serve_tp": summary_tp, "kernels": kernels,
                   "gemm_shapes": rows}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
