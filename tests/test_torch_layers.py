"""The port's shared layers against the JAX package's, on the same
numpy inputs (float32, tolerance 1e-5)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("shape", [(3, 1, 64), (2, 5, 128)])
def test_norm_matches_jax(kind, shape):
    r = _rng(0)
    x = r.normal(size=shape).astype(np.float32) * 3
    p = {"scale": r.normal(size=shape[-1]).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = r.normal(size=shape[-1]).astype(np.float32)
    want = np.asarray(jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x), kind))
    got = tl.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), kind)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_norm_keeps_input_dtype():
    x = torch.randn(2, 1, 32).to(torch.bfloat16)
    y = tl.apply_norm({"scale": torch.ones(32)}, x)
    assert y.dtype == torch.bfloat16


def test_embed_matches_jax():
    r = _rng(1)
    table = r.normal(size=(50, 16)).astype(np.float32)
    ids = r.integers(0, 50, size=(4, 1)).astype(np.int32)
    want = np.asarray(jl.apply_embed({"table": jnp.asarray(table)},
                                     jnp.asarray(ids), jnp.float32))
    got = tl.apply_embed({"table": _t(table)}, _t(ids).long(), torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lead", [(4, 1), (3,)])
def test_unembed_matches_jax(lead):
    r = _rng(2)
    table = r.normal(size=(97, 32)).astype(np.float32)
    x = r.normal(size=lead + (32,)).astype(np.float32)
    want = np.asarray(jl.apply_unembed({"table": jnp.asarray(table)},
                                       jnp.asarray(x)))
    got = tl.apply_unembed({"table": _t(table)}, _t(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_unembed_bf16_input_is_fp32_product():
    """A bf16 activation against the fp32 head table promotes to an fp32
    product, as JAX does; only the result is cast."""
    r = _rng(3)
    table = r.normal(size=(40, 16)).astype(np.float32)
    x = r.normal(size=(2, 1, 16)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jl.apply_unembed({"table": jnp.asarray(table)}, xb,
                                       dtype=jnp.bfloat16).astype(jnp.float32))
    got = tl.apply_unembed({"table": _t(table)},
                           _t(x).to(torch.bfloat16), dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                               atol=1e-6)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("hd", [32, 128])
def test_rope_matches_jax(theta, hd):
    r = _rng(4)
    x = r.normal(size=(3, 1, 4, hd)).astype(np.float32)
    pos = np.array([[0], [17], [300]], np.int32)
    want = np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = tl.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_rope_freqs_match_jax():
    want = np.asarray(jl.rope_freqs(128, 500000.0))
    np.testing.assert_allclose(tl.rope_freqs(128, 500000.0).numpy(), want,
                               rtol=1e-6)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_decode_matches_jax(act):
    jcfg = jax_smoke(jax_get_config("llama3-8b")).replace(
        act=act, dtype=jnp.float32)
    tcfg = smoke_config(get_config("llama3-8b")).replace(
        act=act, dtype=torch.float32)
    r = _rng(5)
    spec = tmlp.mlp_spec(tcfg)
    p = {k: (r.normal(size=v.shape) / np.sqrt(v.shape[0])).astype(np.float32)
         for k, v in spec.items()}
    x = r.normal(size=(4, 1, tcfg.d_model)).astype(np.float32)
    want = np.asarray(jmlp.apply_mlp_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg))
    got = tmlp.apply_mlp_decode({k: _t(v) for k, v in p.items()}, _t(x),
                                tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_configs_mirror_jax_fields():
    """Every registry entry carries the JAX config's fields, dtypes
    mapped to torch."""
    from repro.configs.registry import REGISTRY as JREG
    from repro_torch.configs.registry import REGISTRY as TREG
    assert set(JREG) == set(TREG)
    skip = {"dtype", "param_dtype"}
    for name, jc in JREG.items():
        tc = TREG[name]
        for f in jc.__dataclass_fields__:
            if f not in skip:
                assert getattr(tc, f) == getattr(jc, f), (name, f)
        assert tc.dtype is torch.bfloat16
        assert smoke_config(tc).n_kv_heads == jax_smoke(jc).n_kv_heads
