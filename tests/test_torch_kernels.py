"""The port's kernel modules on the CPU: the plain versions of both
kernels against the Pallas TPU kernels run in interpret mode and against
the JAX package's jnp references, plus the paged KV write. (The CUDA
kernels themselves are checked on the card by tests/test_torch_cuda.py
and chip_smoke.py.)"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import flash_decode as jfd  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.kernels.matmul import matmul as pallas_matmul  # noqa: E402
from repro_torch.core import flash_decode as tfd  # noqa: E402
from repro_torch.kernels.flash_decode import (  # noqa: E402
    flash_decode_paged, paged_decode_plain)
from repro_torch.kernels.matmul import (  # noqa: E402
    matmul, matmul_group, matmul_plain)

torch.set_num_threads(2)


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _bf16_np(x):
    """Round an f32 array to bf16 values (kept in f32 storage)."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------- GEMM
@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (256, 256, 128),
                                   (128, 512, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_matches_pallas_interpret(M, K, N, dtype):
    a, b = _normal(0, (M, K)), _normal(1, (K, N))
    if dtype == "bfloat16":
        a, b = _bf16_np(a), _bf16_np(b)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(pallas_matmul(
        jnp.asarray(a).astype(jt), jnp.asarray(b).astype(jt),
        bm=128, bk=128, bn=128).astype(jnp.float32))
    got = matmul_plain(torch.from_numpy(a).to(tt),
                       torch.from_numpy(b).to(tt)).float().numpy()
    scale = np.abs(want).max()
    if dtype == "float32":
        # fp32 sums in another order: 1e-5 of the largest |C|
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        # both round an fp32 sum to bf16: at most one bf16 ulp apart
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5 * scale)


@pytest.mark.parametrize("M,K,N", [(1, 100, 77), (5, 33, 129), (3, 64, 1)])
@pytest.mark.parametrize("trans_b", [False, True])
def test_matmul_ragged_matches_ref(M, K, N, trans_b):
    """Shapes the Pallas tiling cannot take (decode M = batch, ragged
    K and N) against the jnp oracle."""
    a, b = _normal(2, (M, K)), _normal(3, (K, N))
    want = np.asarray(ref.matmul_ref(jnp.asarray(a), jnp.asarray(b)))
    bt = torch.from_numpy(np.ascontiguousarray(b.T) if trans_b else b)
    got = matmul(torch.from_numpy(a), bt, trans_b=trans_b).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_matmul_cpu_uses_plain_version_and_counts():
    a, b = torch.randn(3, 8), torch.randn(8, 5)
    l0, p0 = matmul.launches, matmul.plain_calls
    out = matmul(a, b)
    assert (matmul.launches, matmul.plain_calls) == (l0, p0 + 1)
    torch.testing.assert_close(out, a @ b)
    with pytest.raises(ValueError):
        matmul(a, torch.randn(7, 5))
    with pytest.raises(ValueError):
        matmul(a[0], b)


@pytest.mark.parametrize("M", [1, 3, 8, 16])
@pytest.mark.parametrize("Ns", [(48, 16, 16), (40, 40), (77,)])
def test_matmul_group_cpu_matches_ref_per_product_and_counts(M, Ns):
    """The grouped call on CPU tensors: each product equals the jnp
    oracle's, and the group counts one plain call and no launch."""
    K = 32
    a = _normal(10 + M, (M, K))
    bs = [_normal(20 + i, (K, N)) for i, N in enumerate(Ns)]
    l0, p0 = matmul.launches, matmul.plain_calls
    got = matmul_group(torch.from_numpy(a), [torch.from_numpy(b)
                                             for b in bs])
    assert (matmul.launches, matmul.plain_calls) == (l0, p0 + 1)
    assert [tuple(g.shape) for g in got] == [(M, N) for N in Ns]
    for g, b in zip(got, bs):
        want = np.asarray(ref.matmul_ref(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        matmul_group(torch.from_numpy(a), [torch.zeros(K + 1, 4)])
    with pytest.raises(ValueError):
        matmul_group(torch.from_numpy(a), [])


# ------------------------------------------------------ paged decode
def _paged_case(seed, B=3, H=4, KVH=2, D=32, bs=4, n_blocks=10):
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, H, D)).astype(np.float32)
    kp = r.normal(size=(n_blocks, bs, KVH, D)).astype(np.float32)
    vp = r.normal(size=(n_blocks, bs, KVH, D)).astype(np.float32)
    return q, kp, vp


def _to_t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_pallas_kernel_interpret(dtype):
    """The Pallas paged kernel (interpret mode, one-axis mesh, W=1) and
    the plain version agree on every row: -1 holes, cur_len of 1,
    block_size, block_size + 1 and a full table."""
    bs = 4
    q, kp, vp = _paged_case(0, B=4, bs=bs)
    tables = np.array([[3, -1, 5, 1], [7, 2, 0, 9], [4, 6, -1, -1],
                       [8, 1, 2, 3]], np.int32)
    cur = np.array([14, 16, 5, 1], np.int32)    # hole, full, bs+1, 1
    if dtype == "bfloat16":
        q, kp, vp = _bf16_np(q), _bf16_np(kp), _bf16_np(vp)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    mesh = jax.make_mesh((1,), ("model",))
    want = np.asarray(ops.flash_decode_paged(
        jnp.asarray(q).astype(jt), jnp.asarray(kp).astype(jt),
        jnp.asarray(vp).astype(jt), jnp.asarray(cur), jnp.asarray(tables),
        mesh, scale=0.25).astype(jnp.float32))
    tq, tk, tv, tc, ttb = _to_t(q, kp, vp, cur, tables)
    got = paged_decode_plain(tq.to(tt), tk.to(tt), tv.to(tt), tc, ttb,
                             0.25).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [None, 6, 32])
@pytest.mark.parametrize("width", [4, 6])
def test_paged_plain_matches_reference(window, width):
    """Against the JAX dense reference, with windows, a -1 hole that the
    window has passed, and a gather-width slice of a wider table (a
    non-contiguous view on the torch side). Active rows only: a slot
    with nothing to attend is 0 here and an average in the reference."""
    bs = 4
    q, kp, vp = _paged_case(1, B=3, bs=bs)
    full = np.array([[-1, 2, 5, 7, -1, -1], [1, 3, 4, 6, -1, -1],
                     [8, 9, -1, -1, -1, -1]], np.int32)
    cur = np.array([15, 13, 6], np.int32)
    if window is None or window > 15 - 4:
        full[0, 0] = 0                 # the window reaches block 0: fill it
    tb = full[:, :width]
    want = np.asarray(jfd.reference_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(cur),
        jnp.asarray(tb), 0.25, window=window))
    tq, tk, tv, tc, tfull = _to_t(q, kp, vp, cur, full)
    got = paged_decode_plain(tq, tk, tv, tc, tfull[:, :width], 0.25,
                             window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_paged_wrapper_cpu_uses_plain_version_and_counts():
    q, kp, vp = _paged_case(2)
    tables = np.array([[0, 1, -1], [2, 3, 4], [5, -1, -1]], np.int32)
    cur = np.array([7, 12, 0], np.int32)
    tq, tk, tv, tc, ttb = _to_t(q, kp, vp, cur, tables)
    p0, l0 = flash_decode_paged.plain_calls, flash_decode_paged.launches
    out = flash_decode_paged(tq, tk, tv, tc, ttb, 0.25)
    assert flash_decode_paged.plain_calls == p0 + 1
    assert flash_decode_paged.launches == l0
    torch.testing.assert_close(
        out, paged_decode_plain(tq, tk, tv, tc, ttb, 0.25))
    # a slot with cur_len 0 attends nothing and returns zeros
    assert torch.count_nonzero(out[2]) == 0


@pytest.mark.parametrize("window", [None, 5])
def test_torch_reference_matches_jax_reference(window):
    q, kp, vp = _paged_case(3)
    tables = np.array([[4, 1, 7], [0, 2, 3], [9, 8, 6]], np.int32)
    cur = np.array([9, 12, 2], np.int32)
    want = np.asarray(jfd.reference_paged_decode_attention(
        *[jnp.asarray(x) for x in (q, kp, vp, cur, tables)], 0.25,
        window=window))
    got = tfd.reference_paged_decode_attention(
        *_to_t(q, kp, vp, cur, tables), 0.25, window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gather_paged_view_matches_jax():
    _, kp, _ = _paged_case(4)
    tables = np.array([[3, -1, 2], [0, 9, 1], [5, 5, -1]], np.int32)
    want = np.asarray(jfd.gather_paged_view(jnp.asarray(kp),
                                            jnp.asarray(tables)))
    got = tfd.gather_paged_view(*_to_t(kp, tables)).numpy()
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------- paged write
@pytest.mark.parametrize("case", ["mixed", "none_active", "all_active"])
def test_paged_write_matches_jax(case):
    """In-place write vs JAX's functional one: inactive slots, -1
    entries and positions past the table slice are dropped; the pool
    comes out byte-identical."""
    bs, n_blocks, KVH, D = 4, 8, 2, 8
    r = np.random.default_rng(5)
    pool = r.normal(size=(n_blocks, bs, KVH, D)).astype(np.float32)
    new = r.normal(size=(5, KVH, D)).astype(np.float32)
    tables = np.array([[1, 4], [2, -1], [5, 6], [0, 3], [7, -1]], np.int32)
    cur = np.array([6, 5, 2, 9, 1], np.int32)  # slot 3 runs past the slice
    active = {"mixed": [True, True, False, True, True],
              "none_active": [False] * 5,
              "all_active": [True, False, True, False, True]}[case]
    active = np.array(active)
    want = np.asarray(jfd.paged_write(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(tables),
        jnp.asarray(cur), jnp.asarray(active)))
    tp, tn, ttb, tc = _to_t(pool, new, tables, cur)
    got = tfd.paged_write(tp, tn, ttb, tc, torch.from_numpy(active))
    assert got is tp                                   # in place
    np.testing.assert_array_equal(tp.numpy(), want)
