"""The recurrent families through the port's decode entry points and
serving engine against the JAX package's, float32 on the CPU
(zamba2-smoke: 5 Mamba2 layers in 2 groups of 2 + a tail of 1, the
shared attention block after each group; rwkv6-smoke: 4 blocks;
converted parameters, the zero inits of ``dt_bias``, ``conv_b`` and
``w_lora_b`` overwritten with seeded nonzero values on both sides):

* ``lm.decode_step`` teacher-forced over the paged and the contiguous
  state: logits within one bf16 ulp (2**-7 relative, 1e-4 absolute:
  both packages cast the fp32 unembed to bf16) and every state leaf
  within 1e-4 of its largest |entry| (the layers' 1e-5 compounds over
  ten steps through 5 layers: the smoke init's layer-stacked fan-in
  drives the SSM state to ~1e3); the state tree has JAX's keys,
  shapes and dtypes; inactive slots stay byte-identical;
* the engine: streams token-identical and the scheduling counters
  equal at K = 1 and K = 4 (pure and mixed megaticks), greedy and the
  seeded temperature sampler, staggered admission, and for the hybrid
  a ``pool``-fault spike that preempts; drain -> snapshot -> restore
  into a fresh engine (restored requests re-prefill: no prefix
  sharing for recurrent state);
* the hybrid over 2 and 4 CPU ranks (``bsp``, ``ring``, ``pallas``) and
  rwkv over 2: streams and counters identical to tp = 1;
* the pool's family flags, and the serve CLI on the CPU.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpointer as jckpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.checkpoint.checkpointer import (Checkpointer,  # noqa: E402
                                                 flatten)
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.distributed import context as dctx  # noqa: E402
from repro_torch.distributed import fault_tolerance as tft  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

torch.set_num_threads(2)
ARCHS = ("zamba2-1.2b", "rwkv6-3b")


def nonzero_inits(tree, seed=0):
    """JAX's param tree (numpy) with the zero-init leaves that would hide
    a path (Mamba2's dt_bias and conv_b, RWKV6's w_lora_b) seeded
    nonzero."""
    r = np.random.default_rng(seed)

    def go(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = go(v)
            elif k in ("dt_bias", "conv_b", "w_lora_b"):
                out[k] = (0.3 * r.standard_normal(v.shape)).astype(v.dtype)
            else:
                out[k] = v
        return out
    return go(tree)


@functools.lru_cache(maxsize=None)
def models(arch):
    jc = jax_smoke(jax_get_config(arch)).replace(dtype=jnp.float32)
    tc = smoke_config(get_config(arch)).replace(dtype=torch.float32)
    tree = nonzero_inits(jax.tree.map(np.asarray, jlm.init_params(
        jax.random.PRNGKey(0), jc)))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tc, device="cpu")
    return jc, jp, tc, tp


def _close(got, want, frac, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= frac * scale, f"{what}: {err:.3e} > {frac} x {scale:.3e}"


def _jax_leaves(tree):
    return {k.replace("%%", "/"): np.asarray(v)
            for k, v in flatten(jax.tree.map(np.asarray, tree)).items()}


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_teacher_forced_matches_jax(arch, paged):
    jc, jp, tc, tp = models(arch)
    B, bs, nb, mb, T = 3, 8, 12, 4, 10
    if paged:
        jst = jlm.init_paged_decode_state(jp, jc, B, nb, bs, mb)
        tables = np.arange(nb, dtype=np.int32).reshape(B, mb)
        jst = {**jst, "block_tables": jnp.asarray(tables)}
        tst = tlm.init_paged_decode_state(tp, tc, B, nb, bs, mb)
        tst["block_tables"].copy_(torch.from_numpy(tables))
    else:
        jst = jlm.init_decode_state(jp, jc, B, 32)
        tst = tlm.init_decode_state(tp, tc, B, 32)
    want = _jax_leaves(jst["caches"])
    got = {k.replace("%%", "/"): v for k, v in flatten(tst["caches"]).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    step = jax.jit(jlm.decode_step, static_argnums=3)
    toks = np.random.default_rng(1).integers(1, tc.vocab_size, (B, T))
    for j in range(T):
        active = np.array([True, j % 3 != 1, j != 4])
        tok = toks[:, j:j + 1].astype(np.int32)
        jl, jst = step(jp, jnp.asarray(tok), jst, jc, jnp.asarray(active))
        before = {k: v.clone() for k, v in flatten(tst["caches"]).items()}
        with torch.inference_mode():
            tl, _ = tlm.decode_step(tp, torch.from_numpy(tok), tst, tc,
                                    active=torch.from_numpy(active))
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-4)
        assert np.array_equal(tst["cur_len"].numpy(),
                              np.asarray(jst["cur_len"]))
        jleaves = _jax_leaves(jst["caches"])
        for k, v in flatten(tst["caches"]).items():
            _close(v.numpy(), jleaves[k.replace("%%", "/")], 1e-4,
                   f"{arch} step {j} {k}")
            if k.split("%%")[-1] not in ("k", "v"):     # recurrent leaves
                for b in np.nonzero(~active)[0]:
                    assert torch.equal(v[:, b], before[k][:, b]), (j, k, b)


# ------------------------------------------------------------------ engine
KEYS = ("ticks", "dispatches", "decode_dispatches", "mixed_dispatches",
        "preemptions", "prefix_hits", "cow_copies", "faults_injected",
        "kv_blocks_seized")


def _prompts(seed, *lens):
    r = np.random.default_rng(seed)
    return [[int(t) for t in r.integers(1, 512, n)] for n in lens]


# name: (archs, engine kwargs, [(prompt, max_new, arrival tick, temp)],
# fault specs)
CASES = {
    "stagger": (ARCHS, dict(batch=3, max_len=64, prefill_chunk=4,
                            block_size=8),
                [(p, 6 + i % 3, i, (1.0, 0.7, 1.3, 0.9)[i]) for i, p in
                 enumerate(_prompts(2, 9, 5, 13, 7))], ()),
    "pool_preempt": (("zamba2-1.2b",),
                     dict(batch=2, max_len=64, prefill_chunk=8,
                          block_size=8, n_blocks=12),
                     [(p, 20, 0, 1.0) for p in _prompts(3, 18, 16)],
                     [("pool", 4, {"blocks": 10, "hold_ticks": 3})]),
}


def _engine(pkg, arch, kw, specs=()):
    jc, jp, tc, tp = models(arch)
    mod = jfaults if pkg == "jax" else tfaults
    plan = mod.FaultPlan([mod.FaultSpec(s, t, **k) for s, t, k in specs]) \
        if specs else None
    if pkg == "jax":
        return JEngine(jp, jc, fault_plan=plan, watchdog=jft.StragglerWatchdog(
            min_samples=10 ** 9), **kw)
    return Engine(tp, tc, fault_plan=plan, device="cpu",
                  watchdog=tft.StragglerWatchdog(min_samples=10 ** 9), **kw)


def _drive(eng, reqs, pkg):
    cls = JRequest if pkg == "jax" else Request
    for rid, (prompt, max_new, at, temp) in enumerate(reqs):
        eng.submit(cls(rid=rid, prompt=list(prompt), max_new_tokens=max_new,
                       temp=temp), at_tick=at)
    done = eng.run()
    m = eng.metrics(done)
    return {r.rid: list(r.out_tokens) for r in done}, {k: m[k] for k in KEYS}


ENGINE_RUNS = [(c, a) for c, (archs, _, _, _) in sorted(CASES.items())
               for a in archs]


@pytest.mark.parametrize("sampler", ["greedy", "temperature"])
@pytest.mark.parametrize("case,arch", ENGINE_RUNS)
def test_engine_matches_jax_engine(case, arch, sampler):
    _, kw, reqs, specs = CASES[case]
    runs = {}
    for K in (1, 4):
        kwk = dict(kw, decode_steps=K, sampler=sampler, seed=7)
        want = _drive(_engine("jax", arch, kwk, specs), reqs, "jax")
        got = _drive(_engine("torch", arch, kwk, specs), reqs, "torch")
        assert got == want, (K, got, want)
        runs[K] = got
    assert runs[4][0] == runs[1][0]             # K = 4 streams as K = 1
    assert runs[4][1]["mixed_dispatches"] > 0
    assert runs[1][1]["prefix_hits"] == 0       # recurrent: no sharing
    if case == "pool_preempt":
        assert runs[4][1]["preemptions"] >= 1


SNAP_PROMPTS = _prompts(5, 11, 6, 9)


def _snapshot_run(pkg, arch, tmp_path, K):
    kw = dict(batch=2, max_len=64, prefill_chunk=4, block_size=8,
              decode_steps=K)
    eng, fresh = _engine(pkg, arch, kw), _engine(pkg, arch, kw)
    reqs = [(p, 8, 0, 1.0) for p in SNAP_PROMPTS]
    cls = JRequest if pkg == "jax" else Request
    subs = [cls(rid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n, _, _) in enumerate(reqs)]
    for r in subs:
        eng.submit(r)
    for _ in range(3):
        eng.tick()
    ckpt_cls = jckpt.Checkpointer if pkg == "jax" else Checkpointer
    step = eng.snapshot(ckpt_cls(str(tmp_path / pkg)))
    restored = fresh.restore(ckpt_cls(str(tmp_path / pkg)), step)
    fresh.run()
    done = {r.rid: list(r.out_tokens) for r in subs if r.done}
    done.update({r.rid: list(r.out_tokens) for r in restored})
    return done, fresh.metrics([])["prefix_hits"], len(restored)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_snapshot_restore_matches_jax(tmp_path, arch, K):
    """Drain mid-flight, snapshot, restore into a fresh engine and run to
    the end, on both packages: the same streams; the resumed requests
    re-prefill (no prefix hits)."""
    want = _snapshot_run("jax", arch, tmp_path, K)
    got = _snapshot_run("torch", arch, tmp_path, K)
    assert got == want
    assert got[1] == 0 and got[2] >= 1


def _serve_ranks(arch, W, mode, sampler="greedy"):
    _, _, tc, tp = models(arch)
    _, kw, reqs, _ = CASES["pool_preempt" if arch.startswith("zamba2")
                           else "stagger"]
    kw = dict(kw, n_blocks=8 if "n_blocks" in kw else None, decode_steps=4,
              sampler=sampler, seed=3)
    mesh = make_mesh(W, device="cpu") if W > 1 else None
    with dctx.use(dctx.DistContext(mesh, mode)):
        eng = Engine(tp, tc, device="cpu", **kw)
    return _drive(eng, reqs, "torch")


@pytest.mark.parametrize("arch,W,mode", [
    ("zamba2-1.2b", 2, "bsp"), ("zamba2-1.2b", 2, "ring"),
    ("zamba2-1.2b", 4, "pallas"), ("zamba2-1.2b", 4, "ring"),
    ("zamba2-1.2b", 4, "bsp"), ("rwkv6-3b", 2, "pallas")])
def test_serve_over_cpu_ranks_matches_one_rank(arch, W, mode):
    """The hybrid's shared attention on the W-rank pool (the fused
    decode's plain version under ``pallas``), the recurrent state once
    per distinct device: streams and counters identical to tp = 1."""
    one = _serve_ranks(arch, 1, "auto")
    got = _serve_ranks(arch, W, mode)
    assert got == one
    if arch.startswith("zamba2"):
        assert one[1]["preemptions"] >= 1


def test_pool_flags_follow_the_family():
    """rwkv needs no KV blocks; neither family shares prefixes (recurrent
    state cannot be rebuilt from KV blocks), as the JAX pool says."""
    from repro.serving.kv_cache import CachePool as JPool
    from repro_torch.serving.kv_cache import CachePool as TPool
    kw = dict(batch=2, max_len=32, block_size=4)
    for arch, flags in zip(ARCHS, ((True, False), (False, False))):
        jc, jp, tc, tp = models(arch)
        jpool, tpool = JPool(jp, jc, **kw), TPool(tp, tc, **kw)
        assert (tpool._needs_blocks, tpool._can_share) == \
            (jpool._needs_blocks, jpool._can_share) == flags
        assert tpool.alloc([1] * 9) == jpool.alloc([1] * 9)
        assert tpool.blocks_in_use == jpool.blocks_in_use


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_cpu_smoke(arch):
    from repro_torch.launch import serve
    stats = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "3", "--batch", "2", "--max-new", "3",
                        "--max-len", "64", "--decode-steps", "4"])
    assert stats["requests"] == 3 and stats["new_tokens"] == 9
    assert stats["device"] == "cpu" and stats["mixed_dispatches"] >= 1


def test_snapshot_over_ranks_saves_recurrent_state_once(tmp_path):
    """The hybrid at tp = 4 on CPU ranks (one distinct device): the
    snapshot holds each rank's KV shard and ONE copy of the recurrent
    state (one per distinct device, never joined as if it were blocks);
    restored into a fresh tp = 4 engine, the run ends as tp = 1's
    uninterrupted one."""
    _, _, tc, tp = models("zamba2-1.2b")
    kw = dict(batch=2, max_len=64, prefill_chunk=4, block_size=8,
              n_blocks=16, decode_steps=4, device="cpu")
    reqs = [(p, 8, 0, 1.0) for p in SNAP_PROMPTS]
    want = _drive(Engine(tp, tc, **kw), reqs, "torch")[0]
    with dctx.use(dctx.DistContext(make_mesh(4, device="cpu"), "pallas")):
        eng, fresh = Engine(tp, tc, **kw), Engine(tp, tc, **kw)
    subs = [Request(rid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n, _, _) in enumerate(reqs)]
    for r in subs:
        eng.submit(r)
    for _ in range(3):
        eng.tick()
    ckpt = Checkpointer(str(tmp_path))
    step = eng.snapshot(ckpt)
    keys = sorted(k for k in ckpt.read(step)[0] if k.startswith("caches"))
    assert keys == sorted(
        [f"caches%%attn%%{k}%%{r}" for k in "kv" for r in range(4)]
        + [f"caches%%mamba%%{k}%%0" for k in ("conv", "ssm")])
    restored = fresh.restore(ckpt, step)
    fresh.run()
    got = {r.rid: list(r.out_tokens) for r in subs if r.done}
    got.update({r.rid: list(r.out_tokens) for r in restored})
    assert got == want


@pytest.mark.parametrize("arch,tp", [("zamba2-1.2b", "2"), ("rwkv6-3b", "1")])
def test_server_drain_then_resume(tmp_path, arch, tp):
    """The SSE server built by its CLI (``build_engine``) streams a
    request, drains it into ``--checkpoint-dir`` mid-stream; a second
    server built with ``--resume`` re-prefills it (recurrent state is
    not shared: no prefix hit) and finishes the stream an uninterrupted
    engine gives."""
    import asyncio
    from repro_torch.launch import server as server_mod
    from repro_torch.launch.server import Server
    from repro_torch.serving import client as cl
    common = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
              "--max-len", "64", "--block-size", "8", "--tp", tp,
              "--fusion-mode", "pallas", "--checkpoint-dir", str(tmp_path)]
    prompt = _prompts(9, 12)[0]

    async def first():
        srv = Server(server_mod.build_engine(
            server_mod.make_parser().parse_args(common)), port=0,
            ckpt_dir=str(tmp_path), drain_grace_s=0.0)
        await srv.start()
        try:
            seen = asyncio.Event()

            def on_ev(ev):
                if ((ev.get("choices") or [{}])[0].get("delta") or {}).get(
                        "token_ids"):
                    seen.set()
            stream = asyncio.create_task(cl.complete(
                srv.host, srv.port, prompt, max_new_tokens=30,
                on_event=on_ev))
            await seen.wait()
            await cl.request_json(srv.host, srv.port, "POST",
                                  "/admin/drain")
            return await stream
        finally:
            await srv.stop()

    out = asyncio.run(first())
    assert out.error is not None and 0 < len(out.token_ids) < 30
    eng = server_mod.build_engine(server_mod.make_parser().parse_args(
        common + ["--resume"]))
    (resumed,) = list(eng.queue)
    eng.run()
    ref = server_mod.build_engine(server_mod.make_parser().parse_args(
        common))
    req = Request(rid=0, prompt=list(prompt), max_new_tokens=30)
    ref.submit(req)
    ref.run()
    assert resumed.reused_tokens == 0 and eng.pool.prefix_hits == 0
    assert resumed.out_tokens == req.out_tokens
    assert resumed.out_tokens[:len(out.token_ids)] == out.token_ids
