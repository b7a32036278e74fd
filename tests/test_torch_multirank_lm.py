"""The port's contiguous-cache decode (``lm.init_decode_state`` +
``lm.decode_step`` without block tables, the path
``examples/quickstart.py`` drives) at W = 1 and over 2 and 4 CPU ranks
in every fusion mode, against the JAX package's ``lm.decode_step`` at
W = 1 (float32 smoke llama3-8b, converted parameters).

Tolerance, as in ``tests/test_torch_decode.py``: both packages cast the
fp32 unembed to bf16 logits, so an element on a bf16 rounding boundary
can come out one bf16 ulp apart (``2**-7`` relative); everything else
within ``1e-4``. The greedy tokens must be equal, and the caches, read
back in global position order, agree within ``1e-4``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.distributed import context as dctx  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

torch.set_num_threads(2)
LOGIT_TOL = dict(rtol=2 ** -7, atol=1e-4)
B, MAX_LEN = 3, 16
# (active mask or None, slot to reset before the step or None)
STEPS = [(None, None), (None, None), ([True, False, True], None),
         (None, 1), ([False, True, True], None), (None, None),
         (None, None), ([True, True, False], None)]
CONFIGS = {"full": {}, "rolling": {"sliding_window": 8}}


def _steps(cfg_name):
    n = 12 if cfg_name == "rolling" else len(STEPS)   # wrap the ring
    return (STEPS * 2)[:n]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_run(request):
    """The JAX model, its converted parameters and its W = 1 run."""
    kw = CONFIGS[request.param]
    jc = jax_smoke(jax_get_config("llama3-8b")).replace(
        n_layers=2, dtype=jnp.float32, **kw)
    tc = smoke_config(get_config("llama3-8b")).replace(
        n_layers=2, dtype=torch.float32, **kw)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    toks = np.random.default_rng(0).integers(1, 512, (16, B, 1)) \
        .astype(np.int32)
    js = jlm.init_decode_state(jp, jc, B, MAX_LEN)
    logits = []
    for i, (act, reset) in enumerate(_steps(request.param)):
        if reset is not None:
            js = jlm.reset_slot(js, reset)
        a = None if act is None else jnp.asarray(act)
        lg, js = jlm.decode_step(jp, jnp.asarray(toks[i]), js, jc, active=a)
        logits.append(np.asarray(lg, np.float32))
    caches = {k: np.asarray(v) for k, v in js["caches"].items()}
    return request.param, tc, tp, toks, logits, caches, \
        np.asarray(js["cur_len"])


def _global(shards):
    """Per-rank strided shards (layers, B, S/W, ...) -> global order."""
    W = len(shards)
    x = torch.stack(shards, dim=3)              # (L, B, S/W, W, ...)
    return x.reshape(x.shape[0], x.shape[1], -1, *x.shape[4:]).numpy()


@pytest.mark.parametrize("W,mode", [(1, "auto")] + [
    (w, m) for w in (2, 4) for m in ("auto", "bsp", "ring", "pallas")])
def test_contiguous_decode_step_matches_jax(jax_run, W, mode):
    name, tc, tp, toks, want, caches, cur_len = jax_run
    mesh = make_mesh(W, device="cpu") if W > 1 else None
    with dctx.use(dctx.DistContext(mesh, mode)):
        params = tp if mesh is None else tlm.replicate(tp, mesh)
        ts = tlm.init_decode_state(tp, tc, B, MAX_LEN)
        for i, (act, reset) in enumerate(_steps(name)):
            if reset is not None:
                tlm.reset_slot(ts, reset)
            a = None if act is None else torch.tensor(act)
            lg, ts = tlm.decode_step(params, torch.from_numpy(toks[i]), ts,
                                     tc, active=a)
            got = lg.float().numpy()
            np.testing.assert_allclose(got, want[i], **LOGIT_TOL)
            np.testing.assert_array_equal(got.argmax(-1),
                                          want[i].argmax(-1))
    cl = ts["cur_len"] if W == 1 else ts["cur_len"][0]
    np.testing.assert_array_equal(cl.numpy(), cur_len)
    for leaf in ("k", "v"):
        shards = ts["caches"][leaf]
        got = shards.numpy() if W == 1 else _global(shards)
        np.testing.assert_allclose(got, caches[leaf], rtol=1e-4, atol=1e-4)


def test_strided_cache_needs_a_length_the_ranks_divide():
    tc = smoke_config(get_config("llama3-8b")).replace(n_layers=1)
    tp = tlm.init_params(tc, seed=0, device="cpu")
    with dctx.use(dctx.DistContext(make_mesh(3, device="cpu"))):
        with pytest.raises(ValueError, match="divide by the 3 ranks"):
            tlm.init_decode_state(tp, tc, 2, 16)
