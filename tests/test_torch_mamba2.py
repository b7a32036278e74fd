"""The port's Mamba2 (SSD) layer against the JAX package's, float32 on the
CPU (zamba2-smoke widths: d 128, d_in 256, 4 heads of 64, state 16):
the chunked SSD at several chunk sizes with and without an initial
state, the state carried over two halves against one shot, the
train/prefill layer and the one-token decode step with its in-place
state update (inactive slots byte-identical).

Inputs come from a numpy seed and go through both packages. The zero
inits of ``dt_bias`` and ``conv_b`` are overwritten with seeded nonzero
values (the same arrays on both sides), so every term runs.

Tolerance: 1e-5 relative to the largest |entry| of the output (the ops
match one for one; fp32 sums in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro.models.module import init_tree  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402

torch.set_num_threads(2)
RTOL = 1e-5
ARCH = "zamba2-1.2b"


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= RTOL * scale, f"{what}: max err {err:.3e} vs scale " \
                                f"{scale:.3e}"


def _ssd_inputs(seed, b=2, l=32, h=3, p=8, n=4):
    r = np.random.default_rng(seed)
    f = np.float32
    x = r.standard_normal((b, l, h, p)).astype(f)
    dt = np.log1p(np.exp(r.standard_normal((b, l, h)))).astype(f)
    A = -np.exp(0.5 * r.standard_normal(h)).astype(f)
    B = r.standard_normal((b, l, n)).astype(f)
    C = r.standard_normal((b, l, n)).astype(f)
    h0 = r.standard_normal((b, h, n, p)).astype(f)
    return x, dt, A, B, C, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_ssd_chunked_matches_jax(chunk, with_h0):
    x, dt, A, B, C, h0 = _ssd_inputs(chunk)
    jy, jh = jm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk,
                            h0=jnp.asarray(h0) if with_h0 else None)
    ty, th = tm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), chunk,
                            h0=torch.from_numpy(h0) if with_h0 else None)
    _close(ty, jy, "y")
    _close(th, jh, "h_last")


def test_ssd_state_carry_two_halves():
    """Two halves with the carried state == one shot, and both == JAX's
    one shot."""
    x, dt, A, B, C, _ = _ssd_inputs(7, b=1, h=2)
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    y_all, h_all = tm.ssd_chunked(*t, 8)
    y1, h1 = tm.ssd_chunked(t[0][:, :16], t[1][:, :16], t[2], t[3][:, :16],
                            t[4][:, :16], 8)
    y2, h2 = tm.ssd_chunked(t[0][:, 16:], t[1][:, 16:], t[2], t[3][:, 16:],
                            t[4][:, 16:], 8, h0=h1)
    jy, jh = jm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), 8)
    _close(torch.cat([y1, y2], 1), y_all, "halves y")
    _close(h2, h_all, "halves h")
    _close(y_all, jy, "y vs jax")
    _close(h_all, jh, "h vs jax")


def test_ssd_chunk_must_divide_the_sequence():
    x, dt, A, B, C, _ = _ssd_inputs(0, l=24)
    with pytest.raises(ValueError, match="divide"):
        tm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), 16)


def _layer(seed=0):
    """zamba2-smoke's cfg in both packages and one Mamba2 layer's params
    (JAX's seeded init, dt_bias and conv_b seeded nonzero)."""
    jc = jax_smoke(jax_get_config(ARCH)).replace(dtype=jnp.float32)
    tc = smoke_config(get_config(ARCH)).replace(dtype=torch.float32)
    p = jax.tree.map(np.asarray, init_tree(jax.random.PRNGKey(seed),
                                           jm.mamba_spec(jc)))
    r = np.random.default_rng(seed + 100)
    p = dict(p, dt_bias=r.standard_normal(p["dt_bias"].shape)
             .astype(np.float32),
             conv_b=0.3 * r.standard_normal(p["conv_b"].shape)
             .astype(np.float32))
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return jc, tc, jp, tp


def test_mamba_spec_matches_jax():
    jc, tc, _, _ = _layer()
    js, ts = jm.mamba_spec(jc), tm.mamba_spec(tc)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert (js[k].shape, js[k].init, js[k].axes) == \
            (ts[k].shape, ts[k].init, ts[k].axes), k
    assert ts["in_proj"].shape == (128, 2 * 256 + 2 * 16 + 4)


@pytest.mark.parametrize("L,chunk", [(32, 64), (32, 8), (64, 16)])
def test_apply_mamba_matches_jax(L, chunk):
    jc, tc, jp, tp = _layer()
    x = np.random.default_rng(L).standard_normal((2, L, 128)).astype(
        np.float32)
    want = jm.apply_mamba(jp, jnp.asarray(x), jc, chunk=chunk)
    got = tm.apply_mamba(tp, torch.from_numpy(x), tc, chunk=chunk)
    _close(got, want, "apply_mamba")


def test_decode_steps_match_jax_and_freeze_inactive_slots():
    """Six decode steps from a seeded state: outputs and both state
    leaves track JAX's; a slot inactive at a step keeps its state bytes
    (JAX's ``_sel_state``)."""
    jc, tc, jp, tp = _layer(1)
    B = 3
    r = np.random.default_rng(5)
    jcache = jm.init_mamba_cache(jc, B, jnp.float32)
    jcache = {"conv": jnp.asarray(r.standard_normal(jcache["conv"].shape)
                                  .astype(np.float32)),
              "ssm": jnp.asarray(r.standard_normal(jcache["ssm"].shape)
                                 .astype(np.float32))}
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    for step in range(6):
        x = r.standard_normal((B, 1, 128)).astype(np.float32)
        active = np.array([True, step % 2 == 0, step != 3])
        jy, jnew = jm.apply_mamba_decode(jp, jnp.asarray(x), jcache, jc)
        jcache = {k: jnp.where(jnp.asarray(active).reshape(
            (-1,) + (1,) * (v.ndim - 1)), jnew[k], v)
            for k, v in jcache.items()}
        before = {k: v.clone() for k, v in tcache.items()}
        ty = tm.apply_mamba_decode(tp, torch.from_numpy(x), tcache, tc,
                                   torch.from_numpy(active))
        _close(ty, jy, f"step {step} y")
        for k in tcache:
            _close(tcache[k], jcache[k], f"step {step} {k}")
            for b in np.nonzero(~active)[0]:
                assert torch.equal(tcache[k][b], before[k][b]), (step, k, b)


def test_decode_continues_the_prefill():
    """The port's prefill (chunked SSD) then one decode step from its
    state == JAX's decode_matches_prefill check, done on the port: the
    last position of a prefill of L + 1 tokens equals a decode step
    after a prefill of L (conv window and SSM state taken from the
    first L tokens by stepping)."""
    _, tc, _, tp = _layer(2)
    B, L = 2, 16
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, L, 128)).astype(np.float32))
    full = tm.apply_mamba(tp, x, tc, chunk=8)
    cache = tm.init_mamba_cache(tc, B, torch.float32)
    act = torch.ones(B, dtype=torch.bool)
    ys = [tm.apply_mamba_decode(tp, x[:, t:t + 1], cache, tc, act)
          for t in range(L)]
    _close(torch.cat(ys, 1), full, "decode steps vs prefill")
