"""The port's sampler (``repro_torch.serving.sampler``) against
``jax.random`` and the JAX package's samplers: PRNG keys, fold_in and
32-bit random bits bit for bit, uniforms bit for bit, Gumbel noise
within 2 ulps at the scale of max(|g|, 1) (the port's float32 log
against XLA's), and the sampled ids of ``sample_batch`` and
``temperature`` equal to JAX's on seeded logits."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving import sampler as jsampler  # noqa: E402
from repro_torch.serving import sampler as tsampler  # noqa: E402

torch.set_num_threads(2)

KEYS = [(0, 0, 0), (0, 3, 5), (1, 1000, 77), (7, 2 ** 31 - 1, 1),
        (2 ** 31 - 1, 12, 4095), (-1, 5, 0), (12345, 0, 100000)]


def _jkey(seed, rid, step):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 rid), step)


def _tkey(seed, rid, step):
    return tsampler.fold_in(tsampler.fold_in(tsampler.prng_key(seed), rid),
                            step)


def _words(jkey):
    return np.asarray(jkey).astype(np.int64)


def test_pinned_key():
    """A value to pin, independent of JAX."""
    assert _tkey(0, 3, 5).tolist() == [1244721678, 2594860169]


@pytest.mark.parametrize("seed,rid,step", KEYS)
def test_keys_match_jax(seed, rid, step):
    np.testing.assert_array_equal(tsampler.prng_key(seed).numpy(),
                                  _words(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(_tkey(seed, rid, step).numpy(),
                                  _words(_jkey(seed, rid, step)))


def test_fold_in_batched_matches_jax():
    """Folding a batch of rids and steps into one base key (what the
    engine's sampler does per slot)."""
    rids = np.array([0, 3, 1000, 7, 2 ** 31 - 1], np.int32)
    steps = np.array([5, 0, 77, 4095, 1], np.int32)
    base = tsampler.prng_key(11)
    got = tsampler.fold_in(tsampler.fold_in(base.expand(5, 2),
                                            torch.from_numpy(rids)),
                           torch.from_numpy(steps)).numpy()
    want = np.stack([_words(_jkey(11, int(r), int(s)))
                     for r, s in zip(rids, steps)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1,), (7,), (512,), (3, 5), (2, 3, 4)])
@pytest.mark.parametrize("seed,rid,step", KEYS[:3])
def test_random_bits_match_jax(shape, seed, rid, step):
    want = np.asarray(jax.random.bits(_jkey(seed, rid, step), shape,
                                      jnp.uint32)).astype(np.int64)
    got = tsampler.random_bits(_tkey(seed, rid, step), shape).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,rid,step", KEYS)
def test_uniform_bit_exact(seed, rid, step):
    want = np.asarray(jax.random.uniform(
        _jkey(seed, rid, step), (4096,), minval=jnp.finfo(jnp.float32).tiny,
        maxval=1.0))
    got = tsampler.uniform(_tkey(seed, rid, step), (4096,)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_log_within_one_ulp_of_xla():
    """The port's float32 log against XLA's over the range the Gumbel
    noise feeds it ([tiny, 1) and (0, 88]): bit-exact (the multiply-adds
    fused as XLA fuses them), so within one ulp a fortiori."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1e-30, 1, 200_000),
                        np.exp(-rng.uniform(0, 87, 200_000)),
                        rng.uniform(1e-7, 88, 200_000)]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(x)).view(np.int32)
    got = tsampler.log_f32(torch.from_numpy(x)).numpy().view(np.int32)
    np.testing.assert_array_equal(got, want)


def test_log_bit_exact_on_every_mantissa():
    """Every float32 in [0.5, 1) (each mantissa, both sides of the
    sqrt(1/2) split) and a sweep of random normal floats of every
    exponent: the port's log gives XLA's bits."""
    every = np.arange(0x3F000000, 0x3F800000, dtype=np.uint32)
    normals = np.random.default_rng(1).integers(
        0x00800000, 0x7F800000, 1_000_000, dtype=np.uint32)
    x = np.concatenate([every, normals]).view(np.float32)
    want = np.asarray(jax.jit(jnp.log)(x)).view(np.int32)
    got = tsampler.log_f32(torch.from_numpy(x)).numpy().view(np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,rid,step", KEYS[:4])
def test_gumbel_within_two_ulp(seed, rid, step):
    want = np.asarray(jax.random.gumbel(_jkey(seed, rid, step), (50_000,)))
    got = tsampler.gumbel(_tkey(seed, rid, step), (50_000,)).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert (np.abs(got - want) <= 2 * ulp).all()


def _logits(seed, B, V, spread=3.0):
    return np.random.default_rng(seed).normal(0, spread, (B, 1, V)) \
        .astype(np.float32)


# (temps, top_ks) per row: greedy rows, no truncation, top_k 1, V and > V,
# and mixed batches
ROWS = {
    "greedy_rows": ([0.0] * 4, [0, 1, 5, 0]),
    "full_vocab": ([1.0, 0.7, 1.3, 2.0], [0] * 4),
    "top_k_1": ([1.0, 0.5, 1.5, 1.0], [1] * 4),
    "top_k_V": ([1.0, 0.5, 1.5, 1.0], [512] * 4),
    "top_k_over_V": ([1.0, 0.5, 1.5, 1.0], [600, 10 ** 6, 513, 512]),
    "mixed": ([0.0, 1.0, 0.3, 2.5, 1.0, 0.0, 0.9, 1e-6],
              [0, 0, 5, 1, 512, 7, 600, 3]),
}


@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("trial", range(3))
def test_sample_batch_matches_jax(rows, trial):
    temps, top_ks = (np.array(v) for v in ROWS[rows])
    B, V = len(temps), 512
    lg = _logits(100 * trial + len(rows), B, V)
    rng = np.random.default_rng(trial)
    rids = rng.integers(0, 10_000, B).astype(np.int32)
    steps = rng.integers(0, 300, B).astype(np.int32)
    temps = temps.astype(np.float32)
    top_ks = top_ks.astype(np.int32)
    want = np.asarray(jsampler.sample_batch(
        jnp.asarray(lg), jax.random.PRNGKey(trial), jnp.asarray(rids),
        jnp.asarray(steps), jnp.asarray(temps), jnp.asarray(top_ks)))
    got = tsampler.sample_batch(
        torch.from_numpy(lg), tsampler.prng_key(trial),
        torch.from_numpy(rids), torch.from_numpy(steps),
        torch.from_numpy(temps), torch.from_numpy(top_ks)).numpy()
    assert got.dtype == np.int32 and got.shape == (B, 1)
    np.testing.assert_array_equal(got, want)


def test_sample_batch_bf16_logits_and_ties():
    """bf16 logits (what the decode step returns) with tied maxima:
    greedy rows take the first index, as JAX's argmax does."""
    lg = np.zeros((4, 1, 256), np.float32)
    lg[:, 0, [3, 9, 200]] = 2.0
    lt = torch.from_numpy(lg).to(torch.bfloat16)
    lj = jnp.asarray(lg).astype(jnp.bfloat16)
    args = (np.array([1, 2, 3, 4], np.int32), np.array([0, 1, 2, 3], np.int32),
            np.array([0.0, 1.0, 0.0, 0.5], np.float32),
            np.array([0, 2, 0, 3], np.int32))
    want = np.asarray(jsampler.sample_batch(lj, jax.random.PRNGKey(5),
                                            *map(jnp.asarray, args)))
    got = tsampler.sample_batch(lt, tsampler.prng_key(5),
                                *map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 3 and got[2, 0] == 3


@pytest.mark.parametrize("temp,top_k", [(1.0, 0), (0.7, 5), (2.0, 1),
                                        (1.0, 512), (0.5, 700), (0.0, 0)])
def test_temperature_matches_jax(temp, top_k):
    lg = _logits(7, 4, 512)
    want = np.asarray(jsampler.temperature(jnp.asarray(lg),
                                           jax.random.PRNGKey(3), temp,
                                           top_k))
    got = tsampler.temperature(torch.from_numpy(lg), tsampler.prng_key(3),
                               temp, top_k).numpy()
    np.testing.assert_array_equal(got, want)


def test_greedy_matches_jax():
    lg = _logits(9, 6, 512)
    np.testing.assert_array_equal(
        tsampler.greedy(torch.from_numpy(lg)).numpy(),
        np.asarray(jsampler.greedy(jnp.asarray(lg))))
