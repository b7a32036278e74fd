"""The port's robustness plane against the JAX engine's (float32 smoke
llama3-8b, 1 layer, converted parameters): for every fault site of a
``FaultPlan`` (the cases of tests/test_faults.py) the two engines run the
same plan, and the streams, the finish reasons and the counters must be
equal. Both engines get a watchdog that never flags, so the degraded
ladder sees the same adverse ticks in both (the clock decides
``slow_ticks``); the watchdog itself is tested on the port alone.

Also: drain -> snapshot -> restore into a fresh engine on both packages
(each through its own checkpointer), identity checks on restore, a
non-transient exception inside a dispatch, and the same
snapshot/restore over 4 CPU ranks against the port at tp = 1.
"""
import functools
import json

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
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

torch.set_num_threads(2)

PROMPTS = ([11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
            21, 22, 23, 24, 25, 26, 27, 28],
           [31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
            41, 42, 43, 44, 45, 46])

# the counters both engines keep, by the JAX engine's metrics() keys
KEYS = ("ticks", "dispatches", "decode_dispatches", "mixed_dispatches",
        "preemptions", "cancellations", "faults_injected",
        "dispatch_retries", "dispatch_failures", "errors", "slow_ticks",
        "degraded_mode", "degraded_transitions", "drained_requests",
        "prefix_hits", "prefix_hit_tokens", "kv_blocks_seized",
        "kv_blocks_in_use", "kv_slots_aborted")

# name: ([(site, tick, spec kwargs)], engine kwargs, max_new per prompt,
# degraded ladder kwargs or None)
CASES = {
    "transient_retry": ([("dispatch", 1, {"count": 2})], {}, (8, 8), None),
    "retry_exhausted": ([("dispatch", 1, {"count": 3})], {}, (8, 8), None),
    "poisoned_slot": ([("tokens", 4, {"slot": 0})], {}, (8, 8), None),
    "pool_spike": ([("pool", 1, {"blocks": 8, "hold_ticks": 2})], {},
                   (8, 8), None),
    # a spike at a pure megatick that leaves the pool too small: the
    # megatick boundary preempts
    "pool_spike_preempts": ([("pool", 4, {"blocks": 10, "hold_ticks": 3})],
                            {"n_blocks": 12}, (20, 20), None),
    "slow_tick": ([("slow", 2, {"delay_s": 0.01})], {}, (8, 8), None),
    "degraded_ladder": ([("dispatch", t, {"count": 1}) for t in (1, 2, 3)],
                        {}, (12, 12), {"trip_after": 2,
                                       "recover_after": 50}),
    "degraded_recovers": ([("dispatch", t, {"count": 1}) for t in (1, 2)]
                          + [("tokens", 3, {"slot": 1})], {}, (20, 6),
                          {"trip_after": 1, "recover_after": 2}),
}


@functools.lru_cache(maxsize=1)
def _models():
    jc = jax_smoke(jax_get_config("llama3-8b")).replace(
        n_layers=1, dtype=jnp.float32)
    tc = smoke_config(get_config("llama3-8b")).replace(
        n_layers=1, dtype=torch.float32)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, jp, tc, tp


def _plan(pkg, specs):
    mod = jfaults if pkg == "jax" else tfaults
    return mod.FaultPlan([mod.FaultSpec(site, tick, **kw)
                          for site, tick, kw in specs])


def _engine(pkg, specs=(), degraded=None, K=4, **kw):
    """An engine of either package; its watchdog never flags."""
    jc, jp, tc, tp = _models()
    kw = {"batch": 2, "max_len": 64, "prefill_chunk": 8, "block_size": 8,
          "n_blocks": 24, "decode_steps": K, **kw}
    plan = _plan(pkg, specs) if specs else None
    if pkg == "jax":
        deg = jfaults.DegradedModeController(**degraded) if degraded \
            else None
        eng = JEngine(jp, jc, fault_plan=plan, degraded=deg,
                      watchdog=jft.StragglerWatchdog(min_samples=10 ** 9),
                      **kw)
        # the JAX engine's single-step readback is a read-only view of
        # the device array, which its own ``tokens`` fault cannot write
        # (no JAX test poisons at K = 1): hand it a writable copy
        read = eng._next_tokens
        eng._next_tokens = lambda logits, emit: np.array(read(logits, emit))
        return eng
    deg = tfaults.DegradedModeController(**degraded) if degraded else None
    return Engine(tp, tc, fault_plan=plan, degraded=deg,
                  watchdog=tft.StragglerWatchdog(min_samples=10 ** 9),
                  device="cpu", **kw)


def _submit(pkg, eng, n_new, rid0=0, prompts=PROMPTS):
    req_cls = JRequest if pkg == "jax" else Request
    reqs = [req_cls(rid=rid0 + i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    for r in reqs:
        eng.submit(r)
    return reqs


def _run(eng):
    """Tick to the end; a tick that exhausts its retries raises, and the
    next tick goes on (as the server's containment does). Returns the
    number of failed ticks."""
    failed_error = (jfaults.DispatchFailedError if isinstance(eng, JEngine)
                    else tfaults.DispatchFailedError)
    failed = 0
    while eng.queue or eng.active:
        try:
            eng.tick()
        except failed_error:
            failed += 1
    return failed


def _outcome(eng, reqs, failed):
    m = eng.metrics(list(reqs))
    return ({r.rid: (list(r.out_tokens), r.finish_reason) for r in reqs},
            {k: m[k] for k in KEYS}, failed)


@functools.lru_cache(maxsize=None)
def _jax_outcome(case, K):
    specs, kw, n_new, degraded = CASES[case]
    eng = _engine("jax", specs, degraded, K, **kw)
    reqs = _submit("jax", eng, n_new)
    return _outcome(eng, reqs, _run(eng))


@functools.lru_cache(maxsize=None)
def _reference(K=4, n_new=(8, 8)):
    eng = _engine("jax", K=K)
    reqs = _submit("jax", eng, n_new)
    eng.run()
    return {r.rid: list(r.out_tokens) for r in reqs}


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fault_plan_matches_jax_engine(case, K):
    specs, kw, n_new, degraded = CASES[case]
    eng = _engine("torch", specs, degraded, K, **kw)
    reqs = _submit("torch", eng, n_new)
    got = _outcome(eng, reqs, _run(eng))
    assert got == _jax_outcome(case, K)
    streams, counters, failed = got
    ref = _reference(K, n_new)
    survivors = {rid: s for rid, (s, why) in streams.items()
                 if why != "error"}
    assert survivors == {rid: ref[rid] for rid in survivors}
    assert counters["faults_injected"] == len(specs)
    if case == "transient_retry":
        assert counters["dispatch_retries"] == 2 and failed == 0
    if case == "retry_exhausted":
        assert failed == counters["dispatch_failures"] == 1
    if case.startswith("poisoned") or case == "degraded_recovers":
        assert counters["errors"] == 1 and len(survivors) == 1
        (victim, (toks, _)), = [(r, v) for r, v in streams.items()
                                if v[1] == "error"]
        assert toks == ref[victim][:len(toks)] and len(toks) < len(
            ref[victim])
    if case.startswith("pool_spike"):
        assert counters["kv_blocks_seized"] > 0
        assert not eng.pool._seized
    if case == "pool_spike_preempts" and K > 1:
        assert counters["preemptions"] >= 1
    if case == "degraded_ladder":
        assert counters["degraded_mode"] >= 1
        assert eng.eff_decode_steps < eng.decode_steps or K == 1
    if case == "degraded_recovers":
        assert counters["degraded_transitions"] >= 2
    assert eng.metrics([])["graph_capture_ticks"] == 0   # no graph on CPU


@pytest.mark.parametrize("K", [1, 4])
def test_poisoned_kv_never_enters_prefix_cache(K):
    """After a poisoned slot retires, the same prompt again resumes from
    the victim's clean history only: both engines give the fault-free
    stream and the same prefix-hit counters."""
    out = {}
    for pkg in ("jax", "torch"):
        eng = _engine(pkg, [("tokens", 4, {"slot": 0})], K=K)
        _submit(pkg, eng, (8, 8))
        _run(eng)
        redo = _submit(pkg, eng, (8,), rid0=7)[0]
        eng.run()
        m = eng.metrics([redo])
        out[pkg] = (list(redo.out_tokens), m["prefix_hits"],
                    m["prefix_hit_tokens"])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == _reference(K)[0]


@pytest.mark.parametrize("ticks", [1, 2, 3])
def test_drain_snapshot_restore_matches_jax(tmp_path, ticks):
    """Drain mid-flight, snapshot, restore into a FRESH engine, run to
    the end, on both packages: the manifests' pool bookkeeping and
    request payloads agree, every resumed request finishes identical to
    the uninterrupted run, and its written KV comes back as prefix
    hits."""
    out = {}
    for pkg, ckpt_cls in (("jax", jckpt.Checkpointer),
                          ("torch", Checkpointer)):
        eng = _engine(pkg)
        reqs = _submit(pkg, eng, (8, 8))
        for _ in range(ticks):
            eng.tick()
        assert any(not r.done for r in reqs)
        ckpt = ckpt_cls(str(tmp_path / pkg))
        step = eng.snapshot(ckpt)
        with open(tmp_path / pkg / f"step_{step:08d}" / "manifest.json") as f:
            meta = json.load(f)
        fresh = _engine(pkg)
        restored = fresh.restore(ckpt_cls(str(tmp_path / pkg)), step)
        hits0 = fresh.pool.prefix_hits
        fresh.run()
        out[pkg] = (
            meta["extra"]["serving"]["pool"],
            [{k: v for k, v in d.items()
              if k not in ("submitted_t", "first_token_t")}
             for d in meta["extra"]["serving"]["requests"]],
            {r.rid: list(r.out_tokens) for r in restored},
            [r.reused_tokens for r in restored],
            fresh.pool.prefix_hits - hits0,
            eng.metrics([])["drained_requests"])
    assert out["torch"] == out["jax"]
    pool, _, streams, reused, hits, drained = out["torch"]
    ref = _reference()
    assert streams == {rid: ref[rid] for rid in streams}
    assert hits > 0 and all(n > 0 for n in reused)
    assert drained == len(streams) >= 1


# max_len 60 and 64 at block 8 give state tensors of equal shapes: only
# the geometry check can refuse that snapshot
MISMATCH = {"seed": ({"seed": 1}, "sampler/seed"),
            "sampler": ({"sampler": "temperature"}, "sampler/seed"),
            "geometry": ({"max_len": 60}, "geometry")}


@pytest.mark.parametrize("what", sorted(MISMATCH))
def test_restore_refuses_mismatched_identity(tmp_path, what):
    """A snapshot of one (sampler, seed) never resumes under another,
    nor into a pool of another geometry, and the refusal comes before
    the engine's state is touched."""
    eng = _engine("torch")
    _submit("torch", eng, (8,))
    eng.tick()
    eng.snapshot(Checkpointer(str(tmp_path)))
    kw, match = MISMATCH[what]
    other = _engine("torch", **kw)
    assert [t.shape for t in flatten(other.pool.state).values()] == \
        [t.shape for t in flatten(eng.pool.state).values()]
    before = other.pool.state["cur_len"].clone()
    other.pool.state["caches"]["k"].fill_(7.0)
    with pytest.raises(ValueError, match=match):
        other.restore(Checkpointer(str(tmp_path)))
    assert torch.equal(other.pool.state["cur_len"], before)
    assert bool((other.pool.state["caches"]["k"] == 7.0).all())
    assert not other.queue


def test_restore_copies_into_the_existing_state_tensors(tmp_path):
    """restore() writes the snapshot into the tensors the engine already
    holds (captured graphs keep their addresses) and never rebinds
    them; the bytes equal the snapshotted state's."""
    eng = _engine("torch")
    _submit("torch", eng, (8, 8))
    eng.tick()
    eng.tick()
    eng.snapshot(Checkpointer(str(tmp_path)))
    fresh = _engine("torch")
    st = fresh.pool.state
    ptrs = [st["caches"]["k"].data_ptr(), st["caches"]["v"].data_ptr(),
            st["cur_len"].data_ptr(), st["block_tables"].data_ptr()]
    fresh.restore(Checkpointer(str(tmp_path)))
    assert fresh.pool.state is st
    assert ptrs == [st["caches"]["k"].data_ptr(),
                    st["caches"]["v"].data_ptr(),
                    st["cur_len"].data_ptr(),
                    st["block_tables"].data_ptr()]
    for key in ("k", "v"):
        assert torch.equal(st["caches"][key], eng.pool.state["caches"][key])


@pytest.mark.parametrize("K", [1, 4])
def test_non_transient_dispatch_error_propagates_unretried(K):
    """An exception other than TransientDispatchError raised inside a
    dispatch (on the card: a sticky CUDA error) leaves the tick at once:
    no retry, no DispatchFailedError, the counters unchanged."""
    eng = _engine("torch", K=K)
    _submit("torch", eng, (8, 8))
    eng.tick()

    def boom(*args, **kwargs):
        raise RuntimeError("simulated device fault")
    if K == 1:
        import repro_torch.models.lm as tlm
        mp = pytest.MonkeyPatch()
        mp.setattr(tlm, "decode_step", boom)
        mp.setattr(tlm, "decode_chunk", boom)
    else:
        mp = pytest.MonkeyPatch()
        mp.setattr(eng._runner, "run", boom)
    try:
        with pytest.raises(RuntimeError, match="simulated device fault"):
            eng.tick()
    finally:
        mp.undo()
    m = eng.metrics([])
    assert (m["dispatch_retries"], m["dispatch_failures"]) == (0, 0)


def _drive_tp(tmp_path, tp, mode="pallas"):
    """Drain/snapshot/restore over ``tp`` CPU ranks; the fresh engine
    runs on the same mesh."""
    _, _, tc, tp_params = _models()
    mesh = make_mesh(tp, device="cpu") if tp > 1 else None
    ctx = dctx.DistContext(mesh, mode)
    specs = [("dispatch", 2, {"count": 2}), ("tokens", 4, {"slot": 1}),
             ("pool", 3, {"blocks": 6, "hold_ticks": 2})]
    kw = dict(batch=3, max_len=64, prefill_chunk=8, block_size=8,
              n_blocks=24, decode_steps=4, device="cpu",
              watchdog=tft.StragglerWatchdog(min_samples=10 ** 9))
    with dctx.use(ctx):
        eng = Engine(tp_params, tc, fault_plan=_plan("torch", specs), **kw)
        fresh = Engine(tp_params, tc, **kw)
    prompts = PROMPTS + ([5, 6, 7, 8, 9, 10, 11, 12, 13],)
    reqs = _submit("torch", eng, (16, 16, 16), prompts=prompts)
    for _ in range(4):
        eng.tick()
    ckpt = Checkpointer(str(tmp_path / f"tp{tp}"))
    step = eng.snapshot(ckpt)
    restored = fresh.restore(ckpt, step)
    fresh.run()
    done = {r.rid: (list(r.out_tokens), r.finish_reason)
            for r in reqs if r.done}
    done.update({r.rid: (list(r.out_tokens), r.finish_reason)
                 for r in restored})
    m = eng.metrics([])
    return (done, {k: m[k] for k in KEYS},
            fresh.metrics([])["prefix_hits"],
            sorted(ckpt.read(step)[0]))


def test_snapshot_restore_over_4_ranks_matches_tp1(tmp_path):
    """The same faults, drain, snapshot and restore over 4 CPU ranks
    (per-rank pool shards in the checkpoint) as at tp = 1: identical
    streams, finish reasons and counters, prefix hits on resume."""
    one = _drive_tp(tmp_path, 1)
    four = _drive_tp(tmp_path, 4)
    assert four[:3] == one[:3]
    assert four[2] > 0 and one[1]["dispatch_retries"] == 2
    assert "caches%%k%%3" in four[3] and "caches%%k" in one[3]


def test_watchdog_flags_slow_tick_and_ladder_steps_down():
    """A real watchdog flags the injected slow tick (0.5 s against
    ticks of milliseconds), and a ladder that trips on one adverse tick
    halves K; the streams stay the fault-free ones."""
    _, _, tc, tp = _models()
    eng = Engine(tp, tc, batch=2, max_len=64, prefill_chunk=8,
                 block_size=8, n_blocks=24, decode_steps=4, device="cpu",
                 fault_plan=_plan("torch", [("slow", 5, {"delay_s": 0.5})]),
                 watchdog=tft.StragglerWatchdog(min_samples=3),
                 degraded=tfaults.DegradedModeController(
                     trip_after=1, recover_after=100))
    reqs = _submit("torch", eng, (20, 20))
    eng.run()
    m = eng.metrics(reqs)
    assert m["slow_ticks"] >= 1 and m["degraded_mode"] >= 1
    assert 5 in [step for step, _, _ in eng.watchdog.slow_steps]
    assert {r.rid: list(r.out_tokens) for r in reqs} == _reference(
        4, (20, 20))


def test_fault_tolerance_copies_match_jax():
    """The port's copies of the watchdog, the heartbeat and the
    preemption guard behave as the JAX package's on the same input."""
    times = [1.0] * 12 + [5.0, 1.0, 2.5, 9.0]
    dogs = [m.StragglerWatchdog(factor=2.0, window=10, min_samples=5)
            for m in (jft, tft)]
    flags = [[d.record(s, dt) for s, dt in enumerate(times)] for d in dogs]
    assert flags[0] == flags[1] and sum(flags[1]) >= 2
    assert dogs[0].summary() == dogs[1].summary()
    t = [100.0]
    beats = [m.Heartbeat(path=None, host_id=2, timeout_s=5.0,
                         clock=lambda: t[0]) for m in (jft, tft)]
    for hb in beats:
        hb.beat(1)
    t[0] += 10.0
    assert [hb.dead_hosts() for hb in beats] == [[2], [2]]
    guard = tft.PreemptionGuard()
    assert not guard.preempted
    guard.trigger()
    assert guard.preempted
    plan = tfaults.FaultPlan.seeded(3, 40, batch=2)
    jplan = jfaults.FaultPlan.seeded(3, 40, batch=2)
    assert plan.to_json() == jplan.to_json()
    assert tfaults.FaultPlan.from_json(jplan.to_json()).to_json() \
        == plan.to_json()
