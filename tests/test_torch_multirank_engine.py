"""The port's serving engine over W ranks (CPU ranks of one mesh) against
its own W = 1 engine, which ``tests/test_torch_engine.py`` holds against
the JAX engine: greedy streams and the tick, dispatch, preemption,
prefix-hit, copy-on-write and reclaim counters must be identical in
every fusion mode (float32 smoke llama3-8b).

The pool's ``n_blocks`` rounds up to a multiple of W as in the JAX
engine, so each workload's pool size is a multiple of 4 and the W = 1
engine sees the same pool.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.distributed import context as dctx  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.kv_cache import CachePool  # noqa: E402

torch.set_num_threads(2)


def _prompts(seed, n, k=1):
    r = np.random.default_rng(seed)
    return [[int(t) for t in r.integers(1, 512, n)] for _ in range(k)]


_BASE = _prompts(11, 16)[0]

# (engine kwargs, sliding window, phases of [(prompt, max_new, tick)])
CASES = {
    "staggered": (
        dict(batch=2, max_len=128, prefill_chunk=4), None,
        [[([1, 2, 3, 4, 5, 6, 7], 4, 0), ([3, 4], 4, 0),
          ([5, 6, 9, 11, 13], 4, 1), ([9, 8, 7], 4, 3), ([2] * 11, 4, 6)]]),
    "prefix_cow": (
        dict(batch=3, max_len=64, prefill_chunk=8, block_size=8,
             n_blocks=8), None,
        [[(_BASE, 5, 0)], [(_BASE, 5, 0), (_BASE + [3, 1, 4], 5, 0)]]),
    "preempt": (
        dict(batch=2, max_len=64, prefill_chunk=4, block_size=8,
             n_blocks=4), None,
        [[([1, 2, 3, 4, 5, 6, 7], 12, 0), ([9, 8, 7, 6, 5, 4, 3], 12, 0)]]),
    "window_reclaim": (
        dict(batch=2, max_len=64, prefill_chunk=4, block_size=4), 8,
        [[(p, 10, i) for i, p in enumerate(_prompts(7, 13, 3))]]),
}


@pytest.fixture(scope="module")
def cfg_params():
    cfg = smoke_config(get_config("llama3-8b")).replace(
        n_layers=2, dtype=torch.float32)
    return cfg, lm.init_params(cfg, seed=0, device="cpu")


def _drive(cfg, params, case, tp=1, mode="auto"):
    kw, window, phases = CASES[case]
    if window is not None:
        cfg = cfg.replace(sliding_window=window)
    copies = []
    copy_fn = lm.copy_cache_block

    def record(state, cfg_, src, dst):
        copies.append((src, dst))
        return copy_fn(state, cfg_, src, dst)
    mesh = make_mesh(tp, device="cpu") if tp > 1 else None
    lm.copy_cache_block = record
    try:
        with dctx.use(dctx.DistContext(mesh, mode)):
            eng = Engine(params, cfg, device="cpu", **kw)
        streams, rid = {}, 0
        for phase in phases:
            for prompt, max_new, at in phase:
                eng.submit(Request(rid=rid, prompt=list(prompt),
                                   max_new_tokens=max_new), at_tick=at)
                rid += 1
            for r in eng.run():
                streams[r.rid] = list(r.out_tokens)
    finally:
        lm.copy_cache_block = copy_fn
    counters = (eng.tick_count, eng.dispatch_count, eng.preempt_count,
                eng.pool.prefix_hits, eng.pool.cow_copies,
                eng.pool.blocks_reclaimed)
    return streams, counters, copies, eng.pool.n_blocks


@pytest.fixture(scope="module")
def solo(cfg_params):
    cfg, params = cfg_params
    return {case: _drive(cfg, params, case) for case in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", ["auto", "bsp", "ring", "pallas"])
def test_engine_over_w_ranks_matches_one_rank(cfg_params, solo, case, tp,
                                              mode):
    cfg, params = cfg_params
    want, want_counts, _, n_blocks = solo[case]
    got, counts, copies, n_blocks_w = _drive(cfg, params, case, tp, mode)
    assert n_blocks_w == n_blocks
    assert got == want
    assert counts == want_counts
    if case == "preempt":
        assert counts[2] >= 1
    if case == "prefix_cow":
        assert counts[3] >= 1 and counts[4] >= 1
        n_loc = n_blocks // tp
        # at W = 4 the copy-on-write goes between two ranks' blocks
        assert any(s // n_loc != d // n_loc for s, d in copies) == (tp == 4)
    if case == "window_reclaim":
        assert counts[5] >= 1


@pytest.mark.parametrize("W,n,want", [(1, 5, 5), (2, 5, 6), (4, 5, 8),
                                      (4, 8, 8)])
def test_pool_rounds_n_blocks_up_to_the_ranks(cfg_params, W, n, want):
    cfg, params = cfg_params
    mesh = make_mesh(W, device="cpu") if W > 1 else None
    with dctx.use(dctx.DistContext(mesh)):
        pool = CachePool(params, cfg, batch=2, max_len=32, block_size=8,
                         n_blocks=n)
    assert pool.n_blocks == want
    shards = pool.state["caches"]["k"]
    if W > 1:
        assert len(shards) == W
        assert all(s.shape[1] == want // W for s in shards)
    else:
        assert shards.shape[1] == want


def test_serve_cli_over_ranks_on_cpu():
    from repro_torch.launch import serve
    stats = serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                        "--requests", "2", "--batch", "2", "--max-new", "2",
                        "--tp", "2", "--fusion-mode", "pallas"])
    assert stats["tp"] == 2 and stats["new_tokens"] == 4
