"""The port's megaticks (``decode_steps=K > 1``: ``Engine._megatick`` /
``_megatick_mixed`` over ``lm.decode_multi`` / ``decode_mixed``) against
the JAX engine at the same K and against the port at K = 1 (float32
smoke llama3-8b, 2 layers, converted parameters), greedy and seeded
temperature sampling:

* streams token-identical, and after every tick the same emitted-token
  counts per request (so the first token lands in the same dispatch);
* equal tick, dispatch, pure/mixed, preemption, prefix-hit and reclaim
  counters, through mid-megatick finishes, preemption (``n_blocks=2``),
  sliding-window reclaim and per-slot token quotas M in {4, 6, 16};
* combined dispatches per decode token <= 1/K, the validation errors,
  and tp = 4 on CPU ranks under ``pallas`` identical to tp = 1.

On the CPU the megatick runs eagerly (no CUDA graph); the graph replay
against the eager loop is ``tests/test_torch_cuda.py``'s.
"""
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
from repro_torch.distributed import context as dctx  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

torch.set_num_threads(2)


def _prompts(seed, *lens):
    r = np.random.default_rng(seed)
    return [[int(t) for t in r.integers(1, 512, n)] for n in lens]


# name: (engine kwargs, sliding window, [(prompt, max_new, tick, temp,
# top_k)], the K values run). Each runs at K = 1 and at every K, on
# both packages, with both samplers.
CASES = {
    "staggered_mixed": (
        dict(batch=4, max_len=64, prefill_chunk=4), None,
        [(p, 9, 2 * i, 1.0, 0)
         for i, p in enumerate(_prompts(0, 7, 3, 11, 5))], (2, 8)),
    "mid_megatick_finish": (
        dict(batch=2, max_len=64, prefill_chunk=8), None,
        [(p, n, 0, 1.0, 0) for p, n in zip(_prompts(2, 6, 4), (5, 11))],
        (2, 8)),
    "preempt": (
        dict(batch=2, max_len=64, prefill_chunk=4, block_size=8,
             n_blocks=2), None,
        [(p, 8, 0, 1.0, 0) for p in ([1, 2, 3, 4, 5, 6, 7],
                                     [9, 8, 7, 6, 5, 4, 3],
                                     [2, 4, 6, 8, 10])], (2, 8)),
    "window_reclaim": (
        dict(batch=2, max_len=64, prefill_chunk=8, block_size=8), 16,
        [(_prompts(9, 30)[0], 12, 0, 1.0, 0),
         (_prompts(10, 9)[0], 10, 3, 0.8, 4)], (2, 8)),
    "budget_4": (
        dict(batch=3, max_len=64, prefill_chunk=4,
             megatick_token_budget=4), None,
        [(p, 7, i, 1.0, 0) for i, p in enumerate(_prompts(3, 9, 4, 13))],
        (2, 4)),
    "budget_6": (
        dict(batch=3, max_len=64, prefill_chunk=4,
             megatick_token_budget=6), None,
        [(p, 7, i, 1.0, 0) for i, p in enumerate(_prompts(3, 9, 4, 13))],
        (2, 4)),
    "budget_16": (
        dict(batch=3, max_len=64, prefill_chunk=4,
             megatick_token_budget=16), None,
        [(p, 7, i, 1.0, 0) for i, p in enumerate(_prompts(3, 9, 4, 13))],
        (2, 8)),
    # per-request temperature and top-k: greedy rows, top_k 1, V, > V
    "sampling_rows": (
        dict(batch=4, max_len=64, prefill_chunk=4), None,
        [(p, 8, i, t, k) for i, (p, t, k) in enumerate(zip(
            _prompts(4, 5, 8, 3, 6), (0.0, 1.0, 0.6, 1.4),
            (0, 1, 512, 700)))], (2, 8)),
}


@pytest.fixture(scope="module")
def models():
    jc = jax_smoke(jax_get_config("llama3-8b")).replace(
        n_layers=2, dtype=jnp.float32)
    tc = smoke_config(get_config("llama3-8b")).replace(
        n_layers=2, dtype=torch.float32)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, jp, tc, tp


def _drive(eng, req_cls, reqs):
    """Run to completion; returns (streams, per-tick emitted counts,
    counters)."""
    for rid, (prompt, max_new, at, temp, top_k) in enumerate(reqs):
        eng.submit(req_cls(rid=rid, prompt=list(prompt),
                           max_new_tokens=max_new, temp=temp, top_k=top_k),
                   at_tick=at)
    live = {}
    trace, done = [], []
    while eng.queue or eng.active:
        done += eng.tick()
        for r in list(eng.active.values()) + done:
            live[r.rid] = len(r.out_tokens)
        trace.append(dict(live))
    m = eng.metrics(done)
    keys = ("ticks", "dispatches", "decode_dispatches", "decode_tokens",
            "mixed_dispatches", "mixed_prompt_tokens", "mixed_decode_tokens",
            "decode_dispatches_per_token", "preemptions", "prefix_hits",
            "kv_blocks_reclaimed")
    return ({r.rid: list(r.out_tokens) for r in done}, trace,
            {k: m[k] for k in keys})


def _engines(models, case, K, sampler):
    jc, jp, tc, tp = models
    kw, window, _, _ = CASES[case]
    if window is not None:
        jc = jc.replace(sliding_window=window)
        tc = tc.replace(sliding_window=window)
    kw = dict(kw, decode_steps=K, sampler=sampler, seed=7)
    if K == 1:
        kw.pop("megatick_token_budget", None)
    return (lambda: JEngine(jp, jc, **kw),
            lambda: Engine(tp, tc, device="cpu", **kw))


@pytest.mark.parametrize("sampler", ["greedy", "temperature"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_megatick_matches_jax_and_single_step(models, case, sampler):
    _, _, reqs, Ks = CASES[case]
    base, _, c1 = _drive(_engines(models, case, 1, sampler)[1](), Request,
                         reqs)
    assert len(base) == len(reqs)
    for K in Ks:
        jeng, teng = _engines(models, case, K, sampler)
        want, jtrace, jcount = _drive(jeng(), JRequest, reqs)
        got, ttrace, tcount = _drive(teng(), Request, reqs)
        assert got == want, (K, got, want)
        assert got == base, (K, got, base)
        assert ttrace == jtrace, K
        assert tcount == jcount, (K, tcount, jcount)
        assert tcount["mixed_dispatches"] > 0
        assert tcount["ticks"] < c1["ticks"]
        if case == "preempt":
            assert tcount["preemptions"] >= 1
        if case == "window_reclaim":
            assert tcount["kv_blocks_reclaimed"] >= 3


@pytest.mark.parametrize("sampler", ["greedy", "temperature"])
def test_first_token_sampled_in_completing_dispatch(models, sampler):
    """One mixed megatick with quota M = 8 both finishes a 5-token
    prompt and emits 4 tokens: 1 at the completing step + 3 piggybacked
    decode steps (K = 4)."""
    _, _, tc, tp = models
    eng = Engine(tp, tc, device="cpu", batch=2, max_len=64,
                 prefill_chunk=8, decode_steps=4, megatick_token_budget=8,
                 sampler=sampler)
    eng.submit(Request(rid=0, prompt=_prompts(1, 5)[0], max_new_tokens=9))
    eng.tick()
    req = next(iter(eng.active.values()))
    assert req.consumed == 5 and len(req.out_tokens) == 4
    assert (eng.mixed_dispatch_count, eng.mixed_prompt_token_count,
            eng.mixed_decode_token_count) == (1, 5, 4)
    assert req.first_token_t > 0


@pytest.mark.parametrize("K", [2, 4, 8])
def test_dispatches_per_token_within_one_over_k(models, K):
    """Staggered arrivals keep prefill in flight, yet pure + mixed
    dispatches per decode token stay <= 1/K, equal to the JAX engine's
    counters."""
    jc, jp, tc, tp = models
    reqs = [(p, 32, 2 * i, 1.0, 0) for i, p in
            enumerate(_prompts(4, 6, 6, 6, 6))]
    kw = dict(batch=4, max_len=64, prefill_chunk=8, decode_steps=K)
    _, _, jcount = _drive(JEngine(jp, jc, **kw), JRequest, reqs)
    _, _, tcount = _drive(Engine(tp, tc, device="cpu", **kw), Request, reqs)
    assert tcount == jcount
    assert tcount["decode_tokens"] + tcount["mixed_decode_tokens"] == 128
    assert tcount["decode_dispatches_per_token"] <= 1.0 / K
    assert tcount["mixed_dispatches"] > 0


def test_megatick_validation(models):
    _, _, tc, tp = models
    with pytest.raises(ValueError, match="decode_steps"):
        Engine(tp, tc, device="cpu", decode_steps=0)
    with pytest.raises(ValueError, match="megatick_token_budget"):
        Engine(tp, tc, device="cpu", batch=2, max_len=64, decode_steps=4,
               megatick_token_budget=3)
    with pytest.raises(ValueError, match="sampler"):
        Engine(tp, tc, device="cpu", sampler="nucleus")
    eng = Engine(tp, tc, device="cpu", batch=2, max_len=64,
                 prefill_chunk=8, decode_steps=4)
    assert eng.megatick_tokens == 8 and eng.eff_decode_steps == 4
    m = eng.metrics([])
    assert m["graphs"] is False and m["graph_captures"] == 0


@pytest.mark.parametrize("sampler", ["greedy", "temperature"])
def test_megatick_over_cpu_ranks_matches_one_rank(models, sampler):
    """tp = 4 on CPU ranks under ``pallas`` at K = 4 (the fused kernels'
    plain versions): streams, per-tick counts and counters identical to
    tp = 1."""
    _, _, tc, tp = models
    kw, _, reqs, _ = CASES["preempt"]
    # a pool of 4 blocks (one a rank) that 12-token streams outgrow
    reqs = [(p, 12, at, t, k) for p, _, at, t, k in reqs]
    kw = dict(kw, n_blocks=4, decode_steps=4, sampler=sampler, seed=3)
    runs = []
    for mesh in (None, make_mesh(4, device="cpu")):
        with dctx.use(dctx.DistContext(mesh, "pallas")):
            eng = Engine(tp, tc, device="cpu", **kw)
        runs.append(_drive(eng, Request, reqs))
    assert runs[1] == runs[0]
    assert runs[0][2]["preemptions"] >= 1
