"""The port's serving engine on the MoE family against the JAX engine
(float32 olmoe-smoke and mixtral-smoke, 2 layers, converted parameters):
streams token-identical and the same scheduling counters at K = 1 and K
= 4 megaticks, greedy and seeded temperature, through prefix hits,
copy-on-write, preemption and (mixtral's window) reclaim; the same
serves over 2 and 4 CPU ranks (replicated experts) identical to one
rank; the pool's family flags; and the serve CLI on the CPU."""
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


_SHARED = _prompts(3, 24)[0]

# name: (arch, sliding window, engine kwargs, phases of [(prompt,
# max_new, arrival tick, temperature)]); each phase runs to completion
# before the next is submitted
CASES = {
    "prefix_cow": (
        "olmoe-1b-7b", None,
        dict(batch=3, max_len=64, prefill_chunk=4, block_size=8),
        [[(_SHARED, 5, 0, 1.0)],
         [(_SHARED + [9, 8, 7], 6, 0, 0.7), (_SHARED, 5, 1, 1.0),
          (_prompts(4, 5)[0], 7, 2, 1.0)]]),
    "preempt": (
        "olmoe-1b-7b", None,
        dict(batch=2, max_len=64, prefill_chunk=4, block_size=8,
             n_blocks=2),
        [[(p, 8, 0, 1.0) for p in _prompts(5, 7, 7)]]),
    "window_reclaim": (
        "mixtral-8x22b", 8,
        dict(batch=2, max_len=64, prefill_chunk=4, block_size=4),
        [[(p, 10, i, 1.0) for i, p in enumerate(_prompts(7, 13, 6, 9))]]),
}
KEYS = ("ticks", "dispatches", "decode_dispatches", "mixed_dispatches",
        "preemptions", "prefix_hits", "cow_copies", "kv_blocks_reclaimed")


def _models(arch, window):
    jc = jax_smoke(jax_get_config(arch)).replace(
        n_layers=2, dtype=jnp.float32, sliding_window=window)
    tc = smoke_config(get_config(arch)).replace(
        n_layers=2, dtype=torch.float32, sliding_window=window)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, jp, tc, tp


@pytest.fixture(scope="module")
def models():
    return {c: _models(arch, w) for c, (arch, w, _, _) in CASES.items()}


def _drive(eng, req_cls, phases):
    streams, rid, done = {}, 0, []
    for phase in phases:
        for prompt, max_new, at, temp in phase:
            eng.submit(req_cls(rid=rid, prompt=list(prompt),
                               max_new_tokens=max_new, temp=temp),
                       at_tick=at)
            rid += 1
        out = eng.run()
        done += out
        streams.update({r.rid: list(r.out_tokens) for r in out})
    m = eng.metrics(done)
    return streams, {k: m[k] for k in KEYS}


@pytest.mark.parametrize("sampler", ["greedy", "temperature"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_engine_matches_jax_engine(models, case, sampler):
    jc, jp, tc, tp = models[case]
    _, _, kw, phases = CASES[case]
    runs = {}
    for K in (1, 4):
        kwk = dict(kw, decode_steps=K, sampler=sampler, seed=7)
        want, jcount = _drive(JEngine(jp, jc, **kwk), JRequest, phases)
        got, tcount = _drive(Engine(tp, tc, device="cpu", **kwk), Request,
                             phases)
        assert got == want, (K, got, want)
        assert tcount == jcount, (K, tcount, jcount)
        runs[K] = got, tcount
    assert runs[4][0] == runs[1][0]          # K = 4 streams as K = 1
    count = runs[1][1]
    if case == "prefix_cow":
        assert count["prefix_hits"] >= 2 and count["cow_copies"] >= 1
    if case == "preempt":
        assert count["preemptions"] >= 1
    if case == "window_reclaim":
        assert count["kv_blocks_reclaimed"] >= 1
    assert runs[4][1]["mixed_dispatches"] > 0


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("sampler", ["greedy", "temperature"])
def test_moe_serve_over_cpu_ranks_matches_one_rank(models, W, sampler):
    """tp = W on CPU ranks under ``pallas`` at K = 4 (replicated experts,
    the fused kernels' plain versions): streams and counters identical
    to tp = 1, through a preemption."""
    _, _, tc, tp = models["preempt"]
    _, _, kw, phases = CASES["preempt"]
    # a pool of 4 blocks (one or two a rank) that 12-token streams outgrow
    phases = [[(p, 12, at, t) for p, _, at, t in phases[0]]]
    kw = dict(kw, n_blocks=4, decode_steps=4, sampler=sampler, seed=3)
    runs = []
    for mesh in (None, make_mesh(W, device="cpu")):
        with dctx.use(dctx.DistContext(mesh, "pallas")):
            eng = Engine(tp, tc, device="cpu", **kw)
        runs.append(_drive(eng, Request, phases))
    assert runs[1] == runs[0]
    assert runs[0][1]["preemptions"] >= 1


def test_pool_flags_follow_the_family(models):
    """MoE needs KV blocks and shares prefixes, as the dense block and
    as the JAX pool's ``_needs_blocks`` / ``_can_share`` say (the
    recurrent families, a later slice, will not share)."""
    from repro.serving.kv_cache import CachePool as JPool
    from repro_torch.serving.kv_cache import CachePool as TPool
    kw = dict(batch=2, max_len=32, block_size=4)
    for case in ("prefix_cow", "window_reclaim"):
        jc, jp, tc, tp = models[case]
        jpool, tpool = JPool(jp, jc, **kw), TPool(tp, tc, **kw)
        assert (tpool._needs_blocks, tpool._can_share) == \
            (jpool._needs_blocks, jpool._can_share) == (True, True)
        assert tpool.alloc([1] * 9) == jpool.alloc([1] * 9)


def test_serve_cli_cpu_smoke_moe():
    from repro_torch.launch import serve
    stats = serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device",
                        "cpu", "--requests", "3", "--batch", "2",
                        "--max-new", "3", "--max-len", "64",
                        "--decode-steps", "4"])
    assert stats["requests"] == 3 and stats["new_tokens"] == 9
    assert stats["device"] == "cpu" and stats["mixed_dispatches"] >= 1
