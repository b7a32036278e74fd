"""The port's serving engine against the JAX engine (float32 config,
converted parameters): greedy streams token-identical and the same
scheduling counters on the staggered, prefix-sharing and preemption
workloads of tests/test_serving.py. Plus the serve CLI on the CPU and
the package's import hygiene."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _rand_prompt(seed, n, k=1):
    r = np.random.default_rng(seed)
    return [[int(t) for t in r.integers(1, 512, n)] for _ in range(k)]


_SHARED = _rand_prompt(3, 64)[0]
_BASE = _rand_prompt(11, 16)[0]

# (engine kwargs, phases of [(prompt, max_new, arrival tick)]): each
# phase is submitted and run to completion before the next one
CASES = {
    "staggered_chunk1": (
        dict(batch=2, max_len=128, prefill_chunk=1),
        [[([1, 2, 3, 4, 5, 6, 7], 4, 0), ([3, 4], 4, 0),
          ([5, 6, 9, 11, 13], 4, 1), ([9, 8, 7], 4, 3), ([2] * 11, 4, 6)]]),
    "staggered_chunk4": (
        dict(batch=2, max_len=128, prefill_chunk=4),
        [[([1, 2, 3, 4, 5, 6, 7], 4, 0), ([3, 4], 4, 0),
          ([5, 6, 9, 11, 13], 4, 1), ([9, 8, 7], 4, 3), ([2] * 11, 4, 6)]]),
    "prefix_hit": (
        dict(batch=2, max_len=128, prefill_chunk=8, block_size=16),
        [[(_SHARED, 4, 0)], [(_SHARED + [9, 8, 7], 4, 0)]]),
    "prefix_cow": (
        dict(batch=3, max_len=64, prefill_chunk=8, block_size=8),
        [[(_BASE, 5, 0)], [(_BASE, 5, 0), (_BASE + [3, 1, 4], 5, 0)]]),
    "preempt": (
        dict(batch=2, max_len=64, prefill_chunk=4, block_size=8,
             n_blocks=2),
        [[([1, 2, 3, 4, 5, 6, 7], 8, 0), ([9, 8, 7, 6, 5, 4, 3], 8, 0)]]),
    "preempt_resume_prefix_hit": (
        dict(batch=2, max_len=64, prefill_chunk=8, block_size=8,
             n_blocks=6),
        [[(p, 12, 0) for p in _rand_prompt(5, 17, 2)]]),
    # sliding window 8 at block size 4: reclaim leaves -1 holes that the
    # paged attention must skip
    "window_reclaim": (
        dict(batch=2, max_len=64, prefill_chunk=4, block_size=4),
        [[(p, 10, i) for i, p in enumerate(_rand_prompt(7, 13, 3))]]),
}
_WINDOW = {"window_reclaim": 8}

_STAGGER_ANCHOR = {"staggered_chunk1": (27, 27), "staggered_chunk4": (15, 15)}


@pytest.fixture(scope="module")
def models():
    jc = jax_smoke(jax_get_config("llama3-8b")).replace(
        n_layers=2, dtype=jnp.float32)
    tc = smoke_config(get_config("llama3-8b")).replace(
        n_layers=2, dtype=torch.float32)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, jp, tc, tp


def _drive(eng, req_cls, phases):
    streams, rid = {}, 0
    for phase in phases:
        for prompt, max_new, at in phase:
            eng.submit(req_cls(rid=rid, prompt=list(prompt),
                               max_new_tokens=max_new), at_tick=at)
            rid += 1
        for r in eng.run():
            streams[r.rid] = list(r.out_tokens)
    return streams, (eng.tick_count, eng.dispatch_count, eng.preempt_count,
                     eng.pool.prefix_hits, eng.pool.cow_copies,
                     eng.pool.blocks_reclaimed)


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax_engine(models, case):
    jc, jp, tc, tp = models
    kw, phases = CASES[case]
    if case in _WINDOW:
        jc = jc.replace(sliding_window=_WINDOW[case])
        tc = tc.replace(sliding_window=_WINDOW[case])
    want, jcount = _drive(JEngine(jp, jc, **kw), JRequest, phases)
    got, tcount = _drive(Engine(tp, tc, device="cpu", **kw), Request, phases)
    assert got == want
    assert tcount == jcount, (tcount, jcount)
    if case in _STAGGER_ANCHOR:
        assert tcount[:2] == _STAGGER_ANCHOR[case]
    if case.startswith("preempt"):
        assert tcount[2] >= 1
    if case.startswith("prefix") or case == "preempt_resume_prefix_hit":
        assert tcount[3] >= 1
    if case in _WINDOW:
        assert tcount[5] >= 1


def test_cache_pool_bookkeeping_matches_jax(models):
    """The host half of CachePool, driven by one seeded random sequence
    of allocations, growth, prefix registration, reclaim, preemption,
    aborts and frees on both packages: tables, lengths, refcounts, free
    list, LRU order, prefix registry and counters stay equal."""
    from repro.serving.kv_cache import CachePool as JPool
    from repro_torch.serving.kv_cache import CachePool as TPool
    jc, jp, tc, tp = models
    kw = dict(batch=3, max_len=48, block_size=4, n_blocks=14)
    pools = (JPool(jp, jc, **kw), TPool(tp, tc, **kw))
    r = np.random.default_rng(0)
    prefixes = _rand_prompt(9, 8, 2)
    for _ in range(300):
        op = r.choice(["alloc", "grow", "grow", "reclaim", "preempt",
                       "abort", "free"])
        slot = int(r.integers(0, 3))
        live = bool(pools[1].active[slot])
        if op == "alloc":
            # tail 0: the exact registered prefix, a copy-on-write hit
            prompt = prefixes[int(r.integers(0, 2))] + _rand_prompt(
                int(r.integers(0, 99)), int(r.integers(0, 9)))[0]
            res = [p.alloc(prompt) for p in pools]
            assert res[0] == res[1]
            continue
        if not live:
            continue
        if op == "grow":
            n = int(r.integers(1, 7))
            got = [p.writable(slot, n) for p in pools]
            assert got[0] == got[1]
            for p in pools:
                p.advance(slot, got[0])
                p.register_prompt_chunks(slot, prefixes[0] + [7] * 40)
        elif op == "reclaim":
            got = [p.reclaim_out_of_window(slot, 6) for p in pools]
            assert got[0] == got[1]
        elif op in ("preempt", "abort"):
            for p in pools:
                getattr(p, op)(slot, prefixes[1] + [5] * 40)
        else:
            for p in pools:
                p.free(slot)
        jpool, tpool = pools
        np.testing.assert_array_equal(tpool.tables, jpool.tables)
        np.testing.assert_array_equal(tpool.lengths, jpool.lengths)
        np.testing.assert_array_equal(tpool.ref, jpool.ref)
        assert tpool._free == jpool._free
        assert list(tpool._lru) == list(jpool._lru)
        assert tpool._key_of == jpool._key_of
        assert tpool.gather_width() == jpool.gather_width()
    jm, tm = (p.metrics() for p in pools)
    assert {k: v for k, v in jm.items() if k in tm} == tm
    assert tm["prefix_hits"] > 0 and tm["cow_copies"] > 0


def test_engine_rejects_later_slices(models):
    """What the engine cannot serve raises: an encoder without a decode
    step (hubert-xlarge, JAX's "encoder-only" message), and a request
    without a prompt. The vlm paligemma-3b, once a later slice, builds
    and serves text (tests/test_torch_frontends_serve_train.py); the
    robustness plane too (tests/test_torch_faults.py): drain() on an
    idle engine parks nothing."""
    from repro_torch.models import lm
    _, _, tc, tp = models
    hub = smoke_config(get_config("hubert-xlarge"))
    with pytest.raises(ValueError, match="encoder-only"):
        Engine(lm.init_params(hub, device="cpu"), hub, device="cpu")
    pali = smoke_config(get_config("paligemma-3b"))
    assert Engine(lm.init_params(pali, device="cpu"), pali, device="cpu",
                  batch=2, max_len=32).drain() == []
    eng = Engine(tp, tc, device="cpu", batch=2, max_len=32)
    assert eng.drain() == []
    with pytest.raises(ValueError):
        eng.submit(Request(rid=0, prompt=[]))


def test_engine_takes_the_retry_backoff_arguments(models, monkeypatch):
    """``Engine(retry_backoff_s=, retry_backoff_cap_s=)`` as JAX's engine
    takes them: a dispatch fault that trips twice is retried after
    ``backoff_s(1, base, cap)`` = base and ``backoff_s(2, base, cap)`` =
    cap (< 2 x base) seconds, as the JAX engine sleeps under the same
    plan."""
    base, cap = 0.001, 0.0015
    from repro.serving import engine as jengine
    from repro.serving import faults as jfaults
    from repro_torch.serving import engine as tengine
    from repro_torch.serving import faults as tfaults
    jc, jp, tc, tp = models
    slept = {}
    for name, mod, fmod, eng_cls, req_cls, params, cfg in (
            ("jax", jengine, jfaults, JEngine, JRequest, jp, jc),
            ("port", tengine, tfaults, Engine, Request, tp, tc)):
        naps = slept.setdefault(name, [])
        monkeypatch.setattr(mod.time, "sleep", naps.append)
        kw = {} if name == "jax" else {"device": "cpu"}
        eng = eng_cls(params, cfg, batch=2, max_len=32,
                      fault_plan=fmod.FaultPlan([fmod.FaultSpec(
                          "dispatch", 1, count=2)]),
                      retry_backoff_s=base, retry_backoff_cap_s=cap, **kw)
        assert (eng.retry_backoff_s, eng.retry_backoff_cap_s) == (base, cap)
        eng.submit(req_cls(rid=0, prompt=[1, 2, 3], max_new_tokens=2))
        eng.run()
        assert eng.dispatch_retry_count == 2
    assert slept["port"] == slept["jax"] == [base, cap] == [
        tfaults.backoff_s(a, base, cap) for a in (1, 2)]


def test_engine_cancel_frees_blocks(models):
    _, _, tc, tp = models
    eng = Engine(tp, tc, device="cpu", batch=2, max_len=64, block_size=8)
    eng.submit(Request(rid=0, prompt=list(range(1, 12)), max_new_tokens=8))
    eng.submit(Request(rid=1, prompt=[4, 5], max_new_tokens=3))
    eng.tick()
    assert eng.cancel(0) and not eng.cancel(0)
    assert eng.blocks_freed_on_abort >= 1
    done = eng.run()
    assert [r.rid for r in done] == [1] and len(done[0].out_tokens) == 3


def test_serve_cli_cpu_smoke():
    from repro_torch.launch import serve
    stats = serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                        "--requests", "3", "--batch", "2", "--max-new", "2",
                        "--max-len", "64", "--stagger", "1"])
    assert stats["requests"] == 3 and stats["new_tokens"] == 6
    assert stats["device"] == "cpu"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


# the robustness plane and the front end: modules the scan must reach
_PLANE = ("serving/faults.py", "serving/client.py",
          "distributed/fault_tolerance.py", "checkpoint/checkpointer.py",
          "launch/server.py", "launch/serve.py", "serving/engine.py")


@pytest.mark.parametrize("root", ["src/repro_torch", "chip_smoke.py"])
def test_port_never_imports_jax_or_repro(root):
    paths = ([REPO / root] if root.endswith(".py")
             else sorted((REPO / root).rglob("*.py")))
    assert paths
    if root == "src/repro_torch":
        assert {PORT / m for m in _PLANE} <= set(paths)
    for path in paths:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
