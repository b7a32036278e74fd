"""Token samplers (port of ``repro.serving.sampler``).

``greedy`` and ``temperature`` are the single-policy primitives;
``sample_batch`` is what the engine uses: one call samples the whole
batch with per-slot keys folded from (seed, request id, token index)
and per-slot ``temp``/``top_k`` (a ``temp`` of 0 makes the row greedy).

The keys and random bits are JAX's, bit for bit, in torch integer ops
(uint32 words held in int64 tensors and masked), so a request's stream
is the JAX engine's:

* ``prng_key(seed)`` is ``jax.random.PRNGKey`` (threefry2x32, a 32-bit
  seed: key ``[0, seed]``); ``fold_in`` hashes ``[0, data]`` under the
  key;
* ``random_bits`` is the 32-bit draw of ``jax_threefry_partitionable``
  mode (jax's default): ``bits1 ^ bits2`` of threefry2x32 over the
  64-bit row-major element index split into (hi, lo) words;
* ``uniform`` is ``jax.random.uniform(minval=finfo.tiny, maxval=1)`` by
  the mantissa trick, ``gumbel`` the "low" mode ``-log(-log(u))``, and a
  categorical draw ``argmax(gumbel + logits)``.

Everything is vectorised over the batch with no host sync, so the
engine's megatick runs the sampler inside a CUDA graph. The Gumbel
noise's ``log`` is Cephes' single-precision polynomial with its
multiply-adds fused as XLA's CPU ``log`` fuses them (:func:`log_f32`),
each fused multiply-add computed in float64 and rounded once to
float32: the CPU and the card give the same bits, and they are XLA's
(every float32 in [0.5, 1) and tests/test_torch_sampler.py's range), so
the Gumbel noise, and the sampled ids, are JAX's.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 hash of counter words (x0, x1) under
    key words (k0, k1); every argument an int64 tensor (or int) of
    uint32 values, broadcast together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 (2,) tensor of uint32
    words (a 32-bit seed: the high word is 0)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` for a (..., 2) batch of keys and data of
    the batch's shape (or a scalar): the key hashes the counter words
    ``[0, data]``. Returns (..., 2) int64."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits`` of ``shape`` per key, partitionable
    mode: keys (..., 2) -> (..., *shape) int64 words."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(keys[..., :1], keys[..., 1:], idx >> 32,
                          idx & MASK32)
    return (b0 ^ b1).reshape(*keys.shape[:-1], *shape)


def uniform(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval=tiny, maxval=1)``
    per key (bit-exact): 23 random mantissa bits under exponent 0, minus
    1, floored at the smallest normal."""
    bits = (random_bits(keys, shape) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * (1.0 - _TINY) + _TINY, _TINY)


def _f32(v: float) -> float:
    """``v`` rounded to the nearest float32 (held as a Python float)."""
    return torch.tensor(v, dtype=torch.float32).item()


# Cephes logf: log(1 + x) ~ x - x^2 / 2 + x^3 P(x) on [sqrt(1/2) - 1,
# sqrt(2) - 1], and ln 2 = Q2 - Q1 split for the exponent's term; the
# constants as float32 values
_LOG_P = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add, in two
    kernels: the float64 product of two float32 values is exact (a
    float32 ``a`` widens inside the multiply, as ``b`` or ``a`` is
    float64), and the float64 sum is rounded to float32 as it is
    written."""
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    return torch.add(a * b, c, out=out)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal float32 ``x``: Cephes' polynomial
    as XLA's CPU ``log`` evaluates it, with every multiply-add of the
    polynomial, and the product ``y * t^3`` with the exponent's ``e *
    Q1`` term, fused (found by search over every float32 in [0.5, 1));
    the other products and sums round to float32 on their own. The CPU
    and the card agree bit for bit."""
    bits = x.view(torch.int32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < 0.707106781186547524
    e = ((bits >> 23) - 126).to(torch.float32) - small.to(torch.float32)
    t = (m - 1.0) + torch.where(small, m, 0.0)
    t2 = t * t
    t3 = t2 * t
    td, t3d = t.double(), t3.double()   # widened once for every product
    p = _LOG_P
    y = _fma(_fma(td, p[0], p[1]), td, p[2])
    y1 = _fma(_fma(td, p[3], p[4]), td, p[5])
    y2 = _fma(_fma(td, p[6], p[7]), td, p[8])
    y = _fma(_fma(y, t3d, y1), t3d, y2)
    y = _fma(y, t3d, e * _LOG_Q1)
    t = (t - t2 * 0.5) + y
    return t + e * _LOG_Q2


def gumbel(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in its "low" mode: ``-log(-log(u))``."""
    return -log_f32(-log_f32(uniform(keys, shape)))


def greedy(logits):
    """logits: (B, 1, V) -> (B, 1) int32 (first index on ties)."""
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


def temperature(logits, key, temp: float = 1.0, top_k: int = 0):
    """logits: (B, 1, V); ``key`` one (2,) key for the whole (B, V)
    draw -> (B, 1) int32. ``top_k`` is clamped to the vocab size."""
    lf = logits[:, -1].float() / torch.tensor(max(temp, 1e-4),
                                              dtype=torch.float32)
    if top_k:
        k = min(int(top_k), lf.shape[-1])
        kth = torch.sort(lf, dim=-1).values[:, -k][:, None]
        lf = torch.where(lf < kth, float("-inf"), lf)
    g = gumbel(key.to(lf.device), tuple(lf.shape))
    return torch.argmax(g + lf, dim=-1)[:, None].to(torch.int32)


def sample_batch(logits, key, rids, steps, temps, top_ks):
    """Per-slot sampling in one call, JAX's ``sample_batch``.

    logits: (B, 1, V); key: the engine's base (2,) key; rids/steps: (B,)
    ints -- row b's key is fold_in(fold_in(key, rid), step); temps: (B,)
    float32; top_ks: (B,) ints (0 = no truncation; clamped to V). Rows
    with temp <= 0 are greedy. Returns (B, 1) int32."""
    lf = logits[:, -1].float()
    B, V = lf.shape
    keys = fold_in(fold_in(key.to(lf.device).expand(B, 2), rids), steps)
    temps = temps.to(torch.float32)
    scaled = lf / torch.clamp_min(temps, 1e-4)[:, None]
    top_ks = top_ks.to(torch.int64)
    k_eff = torch.where(top_ks <= 0, V, top_ks).clamp(1, V)
    kth = torch.sort(scaled, dim=-1).values.gather(1, (V - k_eff)[:, None])
    masked = torch.where(scaled < kth, float("-inf"), scaled)
    samp = torch.argmax(gumbel(keys, (V,)) + masked, dim=-1)
    out = torch.where(temps <= 0.0, torch.argmax(lf, dim=-1), samp)
    return out[:, None].to(torch.int32)
