"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
source, in parallel), then runs, failing on the first phase that fails:

1. device: the card's name and power limit, CUDA present;
2. GEMM kernel vs its plain version at the decode shapes of llama3-8b;
3. paged flash-decode kernel vs its plain version at full-width heads;
4. the smoke llama3-8b (float32) served on the card and on the CPU:
   token-identical greedy streams, equal scheduling counters, per-step
   logits under teacher forcing within tolerance;
5. full-width llama3-8b (bf16, seeded random weights) served through
   the engine, with both kernels' launch counters read around the run;
6. kernel timings (CUDA events) beside their bound, plain version and
   one PyTorch library call.

Prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power
line, and as its last line ``{"ok": true, "device": {...}}``. Longer
per-shape tables go to ``OUT_DIR/chip_smoke.json``. Exits non-zero,
printing no result, without a GPU or outside a checkout of the repo.
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


def profile_steps(params, cfg, state, steps=4):
    """Where a full-width decode step's time goes: ``steps`` single-token
    steps (batch 8) timed on the host clock, then the same steps under
    ``torch.profiler`` for the device time of each kernel. Returns wall
    and device ms per step, the device busy share and the top kernels
    (device time 0 = not measured)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    tok = torch.randint(1, cfg.vocab_size, (8, 1), device="cuda")
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
    print(f"[profile] decode step: wall {wall_ms:.2f} ms, device "
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
    _build.build_all()
    build_s = time.time() - t0
    print(f"[build] both kernels built in {build_s:.1f} s", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"gemm": phase_gemm(gen), "decode": phase_decode(gen)}
    phase_small_model()
    params, summary, lens = phase_full_width()
    del params
    torch.cuda.empty_cache()
    kernels, rows = phase_timings(gen, lens, summary["launches"],
                                  summary["launches_per_step"], errs)
    for k in kernels:
        print(f"[time] {k['name']}: {k['ms']:.3f} ms per step (bound "
              f"{k['bound_ms']:.3f}, plain {k['plain_ms']:.3f}, library "
              f"{k['library_ms']:.3f})", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "build_s": build_s, "serve": summary,
                   "kernels": kernels, "gemm_shapes": rows}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
