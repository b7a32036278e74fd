"""The port's RWKV6 block against the JAX package's, float32 on the CPU
(rwkv6-smoke widths: d 128, 2 heads of 64, d_ff 256): the chunked WKV
at several lengths (one chunk of 1, 8 and 16 steps, several chunks)
with and without an initial state, the state carried over two halves
against one shot, the one-step recurrence the decode runs against
JAX's chunked form at L = 1, the train/prefill block and the decode
step with its in-place state update (inactive slots byte-identical).

Inputs come from a numpy seed and go through both packages. The zero
init of ``w_lora_b`` is overwritten with seeded nonzero values (the same
arrays on both sides), so the data-dependent decay varies.

Tolerance: 1e-5 relative to the largest |entry| of the output (the ops
match one for one; fp32 sums in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import rwkv6 as jr  # noqa: E402
from repro.models.module import init_tree  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import rwkv6 as tr  # noqa: E402

torch.set_num_threads(2)
RTOL = 1e-5
ARCH = "rwkv6-3b"


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= RTOL * scale, f"{what}: max err {err:.3e} vs scale " \
                                f"{scale:.3e}"


def _wkv_inputs(seed, B=2, L=32, H=3, D=8):
    r = np.random.default_rng(seed)
    f = np.float32
    rkv = [r.standard_normal((B, L, H, D)).astype(f) for _ in range(3)]
    lw = -np.clip(np.exp(r.standard_normal((B, L, H, D))), 1e-6,
                  jr.CLAMP).astype(f)
    u = (0.5 * r.standard_normal((H, D))).astype(f)
    S0 = r.standard_normal((B, H, D, D)).astype(f)
    return (*rkv, lw, u, S0)


@pytest.mark.parametrize("with_S0", [False, True])
@pytest.mark.parametrize("L", [1, 8, 16, 48])
def test_wkv_chunked_matches_jax(L, with_S0):
    r, k, v, lw, u, S0 = _wkv_inputs(L, L=L)
    jy, jS = jr.wkv_chunked(*map(jnp.asarray, (r, k, v, lw, u)),
                            S0=jnp.asarray(S0) if with_S0 else None)
    ty, tS = tr.wkv_chunked(*map(torch.from_numpy, (r, k, v, lw, u)),
                            S0=torch.from_numpy(S0) if with_S0 else None)
    _close(ty, jy, "y")
    _close(tS, jS, "S_last")


def test_wkv_state_carry_two_halves():
    r, k, v, lw, u, _ = _wkv_inputs(3, B=1, H=2)
    t = [torch.from_numpy(a) for a in (r, k, v, lw)]
    tu = torch.from_numpy(u)
    y_all, S_all = tr.wkv_chunked(*t, tu)
    y1, S1 = tr.wkv_chunked(*[a[:, :16] for a in t], tu)
    y2, S2 = tr.wkv_chunked(*[a[:, 16:] for a in t], tu, S0=S1)
    _close(torch.cat([y1, y2], 1), y_all, "halves y")
    _close(S2, S_all, "halves S")
    jy, jS = jr.wkv_chunked(*map(jnp.asarray, (r, k, v, lw, u)))
    _close(y_all, jy, "y vs jax")
    _close(S_all, jS, "S vs jax")


def test_wkv_step_is_jax_chunked_form_at_one_step():
    """The decode's recurrence == JAX's ``wkv_chunked`` at L = 1 (how JAX
    decodes), eight steps in a row from a seeded state."""
    r, k, v, lw, u, S0 = _wkv_inputs(11, L=8)
    jS, tS = jnp.asarray(S0), torch.from_numpy(S0)
    for t in range(8):
        sl = [a[:, t:t + 1] for a in (r, k, v, lw)]
        jy, jS = jr.wkv_chunked(*map(jnp.asarray, sl), jnp.asarray(u), S0=jS)
        ty, tS = tr.wkv_step(*[torch.from_numpy(a[:, 0]) for a in sl],
                             torch.from_numpy(u), tS)
        _close(ty, jy[:, 0], f"step {t} out")
        _close(tS, jS, f"step {t} S")


def test_wkv_chunk_must_divide_the_sequence():
    r, k, v, lw, u, _ = _wkv_inputs(0, L=24)
    with pytest.raises(ValueError, match="divide"):
        tr.wkv_chunked(*map(torch.from_numpy, (r, k, v, lw, u)))


def _block(seed=0):
    jc = jax_smoke(jax_get_config(ARCH)).replace(dtype=jnp.float32)
    tc = smoke_config(get_config(ARCH)).replace(dtype=torch.float32)
    p = jax.tree.map(np.asarray, init_tree(jax.random.PRNGKey(seed),
                                           jr.rwkv_spec(jc)))
    r = np.random.default_rng(seed + 100)
    p["w_lora_b"] = (0.5 * r.standard_normal(p["w_lora_b"].shape)).astype(
        np.float32)
    for ln in ("ln_t", "ln_c"):
        p[ln] = {"scale": (1 + 0.2 * r.standard_normal(128)).astype(
                     np.float32),
                 "bias": (0.1 * r.standard_normal(128)).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    return jc, tc, jp, tp


def test_rwkv_spec_matches_jax():
    jc, tc, _, _ = _block()
    js, ts = jr.rwkv_spec(jc), tr.rwkv_spec(tc)
    assert sorted(js) == sorted(ts)
    for k in js:
        if isinstance(js[k], dict):
            assert sorted(js[k]) == sorted(ts[k])
            continue
        assert (js[k].shape, js[k].init, js[k].axes, js[k].scale) == \
            (ts[k].shape, ts[k].init, ts[k].axes, ts[k].scale), k


def test_log_decay_matches_jax_and_is_contractive():
    jc, tc, jp, tp = _block()
    x = (10 * np.random.default_rng(1).standard_normal((2, 16, 128))).astype(
        np.float32)
    want = jr._log_decay(jp, jnp.asarray(x))
    got = tr._log_decay(tp, torch.from_numpy(x))
    _close(got, want, "log decay")
    w = got.exp()
    assert bool((w > 0).all() and (w < 1).all())
    assert float(got.std()) > 0


@pytest.mark.parametrize("L", [16, 32])
def test_rwkv_block_matches_jax(L):
    jc, tc, jp, tp = _block()
    x = np.random.default_rng(L).standard_normal((2, L, 128)).astype(
        np.float32)
    want, _ = jr.apply_rwkv_block(jp, jnp.asarray(x), jc, state=None)
    got = tr.apply_rwkv_block(tp, torch.from_numpy(x), tc)
    _close(got, want, "block")


def test_decode_steps_match_jax_and_freeze_inactive_slots():
    """Six one-token block steps from a seeded state against JAX's block
    at L = 1 with its state: outputs and every state leaf; a slot
    inactive at a step keeps its state bytes (JAX's ``_sel_state``)."""
    jc, tc, jp, tp = _block(1)
    B = 3
    r = np.random.default_rng(4)
    st = jr.init_rwkv_state(jc, B, jnp.float32)
    st = {k: jnp.asarray(r.standard_normal(v.shape).astype(np.float32))
          for k, v in st.items()}
    tst = {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
    for step in range(6):
        x = r.standard_normal((B, 1, 128)).astype(np.float32)
        active = np.array([True, step % 2 == 0, step != 2])
        jy, jnew = jr.apply_rwkv_block(jp, jnp.asarray(x), jc, state=st)
        st = {k: jnp.where(jnp.asarray(active).reshape(
            (-1,) + (1,) * (v.ndim - 1)), jnew[k], v) for k, v in st.items()}
        before = {k: v.clone() for k, v in tst.items()}
        ty = tr.apply_rwkv_decode(tp, torch.from_numpy(x), tst, tc,
                                  torch.from_numpy(active))
        _close(ty, jy, f"step {step} x")
        for k in tst:
            _close(tst[k], st[k], f"step {step} {k}")
            for b in np.nonzero(~active)[0]:
                assert torch.equal(tst[k][b], before[k][b]), (step, k, b)


def test_decode_steps_continue_the_prefill():
    """Stepping the port's decode over a sequence from a zero state ==
    its chunked train/prefill block (one code path for each)."""
    _, tc, _, tp = _block(2)
    B, L = 2, 16
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, L, 128)).astype(np.float32))
    full = tr.apply_rwkv_block(tp, x, tc)
    st = tr.init_rwkv_state(tc, B, torch.float32)
    act = torch.ones(B, dtype=torch.bool)
    ys = [tr.apply_rwkv_decode(tp, x[:, t:t + 1], st, tc, act)
          for t in range(L)]
    _close(torch.cat(ys, 1), full, "decode steps vs prefill")
