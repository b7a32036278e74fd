"""The port's training forward and backward against the JAX package's,
on the same numpy inputs, at ``smoke_config("llama3-8b")`` (float32
unless a test says otherwise), and the GEMM's gradient against autograd
through its plain version.

Tolerances, with their reasons:
* attention, float32: 1e-5 (rtol and atol; the same fp32 ops, summed in
  another order);
* the GEMM Function's backward: 1e-6 relative to the largest |grad|
  (the same fp32 products, another BLAS call order);
* the model, float32: logits within one bf16 ulp (both packages cast
  the fp32 unembed to bf16 logits: 2**-7 relative, 1e-4 absolute); the
  loss within 1e-5 relative; every gradient leaf within 1e-3 of its
  largest |entry| (the logits' gradient is bf16 too, so an element on a
  rounding boundary moves by one bf16 ulp, 2**-8, and spreads through
  the backward's sums);
* the model, bf16 compute: the loss within 1e-3 relative, and every
  gradient leaf within half the bf16 model's own distance from its
  float32 run (relative norms, both from JAX): bf16 rounds at other
  places in the two frameworks, and the smoke init's stacked fan-in
  (layer weights of std 0.5) makes the bf16 gradients move by ~100%
  against float32 in JAX itself.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import matmul as kmm  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.module import tree_items  # noqa: E402

torch.set_num_threads(2)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaf_close(got, want, frac, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= frac * scale, f"{what}: max err {err:.3e} > {frac} x " \
                                f"{scale:.3e}"


# ------------------------------------------------------------ attention
ATTN_CASES = [
    # (S, causal, window, prefix_len, chunk_q, chunk_kv)
    (32, True, None, None, 8, 16),
    (32, True, 9, None, 8, 8),         # sliding window: pairs skipped
    (30, True, None, 5, 8, 16),        # prefix-LM; S not a multiple of
]                                      # the chunks


def _qkv(S, seed, B=2, H=4, D=8):
    r = np.random.default_rng(seed)
    return [r.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("S,causal,window,prefix,cq,ck", ATTN_CASES)
def test_attention_forward_and_grad_match_jax(S, causal, window, prefix, cq,
                                              ck):
    q, k, v = _qkv(S, S)
    do = np.random.default_rng(7).normal(size=q.shape).astype(np.float32)
    scale = 8 ** -0.5
    mask = dict(causal=causal, window=window, prefix_len=prefix)
    for jfn, tfn, kw in (
            (jattn.dense_attention, tattn.dense_attention, {}),
            (jattn.blockwise_attention, tattn.blockwise_attention,
             dict(chunk_q=cq, chunk_kv=ck))):
        def jloss(q, k, v):
            o = jfn(q, k, v, scale=scale, **mask, **kw)
            return jnp.sum(o * do), o
        (_, jo), jg = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
        to = tfn(tq, tk, tv, scale=scale, **mask, **kw)
        (to * _t(do)).sum().backward()
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                                   **ATTN_TOL)
        for name, tt, jj in zip("qkv", (tq, tk, tv), jg):
            np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jj),
                                       err_msg=f"{tfn.__name__} d{name}",
                                       **ATTN_TOL)


def test_blockwise_equals_dense_in_the_port():
    q, k, v = (_t(x) for x in _qkv(30, 3))
    kw = dict(scale=0.3, causal=True, window=11, prefix_len=None)
    np.testing.assert_allclose(
        tattn.blockwise_attention(q, k, v, chunk_q=8, chunk_kv=16,
                                  **kw).numpy(),
        tattn.dense_attention(q, k, v, **kw).numpy(), **ATTN_TOL)


def _cfgs(**kw):
    jc = jax_smoke(jax_get_config("llama3-8b")).replace(dtype=jnp.float32,
                                                       **kw)
    tc = smoke_config(get_config("llama3-8b")).replace(dtype=torch.float32,
                                                       **kw)
    return jc, tc


@pytest.mark.parametrize("S,threshold", [(24, 2048), (24, 8)])
def test_apply_attn_matches_jax(S, threshold):
    """The train/prefill attention with its projections, forward and
    gradients (x and every weight), dense and blockwise."""
    jc, tc = _cfgs(attn_chunk_q=8, attn_chunk_kv=8)
    r = np.random.default_rng(S + threshold)
    d, H, KVH, hd = tc.d_model, tc.n_heads, tc.n_kv_heads, tc.hd
    p = {"wq": r.normal(size=(d, H * hd)), "wk": r.normal(size=(d, KVH * hd)),
         "wv": r.normal(size=(d, KVH * hd)), "wo": r.normal(size=(H * hd, d))}
    p = {k: (v / np.sqrt(d)).astype(np.float32) for k, v in p.items()}
    x = r.normal(size=(2, S, d)).astype(np.float32)
    dy = r.normal(size=(2, S, d)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jattn.apply_attn(p, x, jc, dense_threshold=threshold)
                       * dy)
    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        p, x)
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tx = _t(x).requires_grad_()
    tl = (tattn.apply_attn(tp, tx, tc, dense_threshold=threshold)
          * _t(dy)).sum()
    tl.backward()
    # a sum of 2 x 24 x 128 terms of size ~1 that nearly cancel
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5, atol=1e-4)
    _leaf_close(tx.grad.numpy(), jgx, 1e-5, "dx")
    for k in p:
        _leaf_close(tp[k].grad.numpy(), jgp[k], 1e-5, f"d{k}")


# ------------------------------------------------------ the GEMM's grad
def _gemm_inputs(M, K, Ns, seed, trans_b=False):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((M, K), generator=g).requires_grad_()
    bs = [torch.randn((N, K) if trans_b else (K, N), generator=g)
          .requires_grad_() for N in Ns]
    dcs = [torch.randn((M, N), generator=g) for N in Ns]
    return a, bs, dcs


def _plain_grads(a, bs, dcs, trans_b):
    a2 = a.detach().clone().requires_grad_()
    b2 = [b.detach().clone().requires_grad_() for b in bs]
    outs = [kmm.matmul_plain(a2, b, trans_b) for b in b2]
    torch.autograd.backward(outs, dcs)
    return outs, a2.grad, [b.grad for b in b2]


def _close(got, want, what):
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-6 * scale, what


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,K,N", [(6, 16, 24), (1, 32, 8), (40, 24, 7)])
def test_matmul_backward_matches_autograd_through_plain(M, K, N, trans_b):
    a, (b,), (dc,) = _gemm_inputs(M, K, [N], M + K + N, trans_b)
    n0 = kmm.matmul.plain_calls
    c = kmm.matmul(a, b, trans_b=trans_b)
    c.backward(dc)
    assert kmm.matmul.plain_calls == n0 + 3     # forward, dA, dB
    (want_c,), want_da, (want_db,) = _plain_grads(a, [b], [dc], trans_b)
    assert torch.equal(c, want_c)
    _close(a.grad, want_da, "dA")
    _close(b.grad, want_db, "dB")


@pytest.mark.parametrize("Ns", [[16, 8, 8], [24, 24], [5]])
def test_matmul_group_backward_matches_autograd_through_plain(Ns):
    """dB of every product in one grouped call; dA summed over the
    products in product order."""
    a, bs, dcs = _gemm_inputs(12, 16, Ns, len(Ns))
    n0 = kmm.matmul.plain_calls
    cs = kmm.matmul_group(a, bs)
    torch.autograd.backward(cs, dcs)
    assert kmm.matmul.plain_calls == n0 + 2 + len(Ns)
    want_cs, want_da, want_dbs = _plain_grads(a, bs, dcs, False)
    for c, w in zip(cs, want_cs):
        assert torch.equal(c, w)
    _close(a.grad, want_da, "dA")
    for b, w in zip(bs, want_dbs):
        _close(b.grad, w, "dB")


def test_matmul_records_nothing_without_grad():
    """Under no_grad / inference_mode, and for inputs that need no
    gradient, the wrappers run the product alone (one call, no graph)."""
    a, bs, _ = _gemm_inputs(4, 8, [8, 8], 0)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            n0 = kmm.matmul.plain_calls
            assert kmm.matmul(a, bs[0]).grad_fn is None
            assert all(c.grad_fn is None for c in kmm.matmul_group(a, bs))
            assert kmm.matmul.plain_calls == n0 + 2
    c = kmm.matmul(a.detach(), bs[0].detach())
    assert c.grad_fn is None and not c.requires_grad


# ------------------------------------------------------------- the model
def _models(**kw):
    jc, tc = _cfgs(**kw)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu",
                           trainable=True)
    return jc, jp, tc, tp


def _batch(vocab, B=2, S=16, seed=0):
    r = np.random.default_rng(seed)
    tokens = r.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = r.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels[0, :3] = -100                   # ignored positions
    return tokens, labels


def _jax_loss_and_grads(jc, jp, tokens, labels):
    (jl, jm), jg = jax.jit(jax.value_and_grad(jlm.loss_fn, has_aux=True),
                           static_argnums=2)(
        jp, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
        jc)
    return jl, jm, dict(tree_items(jax.tree.map(np.asarray, jg)))


def _port_loss_and_grads(tc, tp, tokens, labels, loss_rtol, jl, jm):
    tl, tm = tlm.loss_fn(tp, {"tokens": _t(tokens), "labels": _t(labels)},
                         tc)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=loss_rtol)
    np.testing.assert_allclose(tm["ce"].item(), float(jm["ce"]),
                               rtol=loss_rtol)
    assert tm["aux"].item() == 0.0
    got = {n: t.grad for n, t in tp.named_parameters()}
    assert all(g is not None and g.dtype == torch.float32
               for g in got.values())
    return {n: g.numpy().astype(np.float64) for n, g in got.items()}


def test_forward_logits_match_jax():
    jc, jp, tc, tp = _models()
    tokens, _ = _batch(tc.vocab_size)
    jlog, _ = jlm.forward(jp, {"tokens": jnp.asarray(tokens)}, jc)
    with torch.no_grad():
        tlog, aux = tlm.forward(tp, {"tokens": _t(tokens)}, tc)
    assert tlog.dtype == torch.bfloat16 and aux.item() == 0.0
    np.testing.assert_allclose(tlog.float().numpy(),
                               np.asarray(jlog.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-4)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    jc, jp, tc, tp = _models(remat=remat)
    tokens, labels = _batch(tc.vocab_size)
    jl, jm, jg = _jax_loss_and_grads(jc, jp, tokens, labels)
    got = _port_loss_and_grads(tc, tp, tokens, labels, 1e-5, jl, jm)
    assert set(got) == set(jg)
    for name, g in got.items():
        _leaf_close(g, jg[name], 1e-3, name)


def test_loss_and_grads_match_jax_bf16():
    jc32, jp, tc, tp = _models(remat=True)
    jc, tc = jc32.replace(dtype=jnp.bfloat16), tc.replace(dtype=torch.bfloat16)
    tokens, labels = _batch(tc.vocab_size)
    jl, jm, jg = _jax_loss_and_grads(jc, jp, tokens, labels)
    _, _, jg32 = _jax_loss_and_grads(jc32, jp, tokens, labels)
    got = _port_loss_and_grads(tc, tp, tokens, labels, 1e-3, jl, jm)
    for name, g in got.items():
        own = np.linalg.norm(jg[name] - jg32[name])
        assert np.linalg.norm(g - jg[name]) <= 0.5 * own, name


def test_trainable_params_are_fp32_masters():
    _, tc = _cfgs()
    tp = tlm.init_params(tc.replace(dtype=torch.bfloat16), seed=0,
                         device="cpu", trainable=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in tp.parameters())
    served = tlm.init_params(tc.replace(dtype=torch.bfloat16), seed=0,
                             device="cpu")
    assert not any(p.requires_grad for p in served.parameters())
    assert served["embed"]["table"].dtype == torch.bfloat16


def test_cross_entropy_matches_jax_with_mask_and_ignored_labels():
    r = np.random.default_rng(5)
    logits = (r.normal(size=(2, 6, 11)) * 3).astype(np.float32)
    labels = r.integers(0, 11, size=(2, 6)).astype(np.int32)
    labels[1, 2] = -100
    mask = (r.random((2, 6)) > 0.3).astype(np.int32)
    for m in (None, mask):
        want = jlm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if m is None else jnp.asarray(m))
        got = tlm.cross_entropy(_t(logits), _t(labels),
                                None if m is None else _t(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_remat_dots_and_other_families_raise():
    """``remat_policy="dots"`` trains (its checks against JAX and
    ``"full"``: tests/test_torch_remat_dots.py): the loss and every
    gradient as ``"full"``'s, bit for bit. The frontends' inputs keep
    JAX's rules, an audio batch without frames raising."""
    jc, tc = _cfgs(remat=True, remat_policy="dots")
    tokens, labels = _batch(tc.vocab_size)
    batch = {"tokens": _t(tokens), "labels": _t(labels)}
    out = []
    for cfg in (tc, tc.replace(remat_policy="full")):
        tp = tlm.init_params(cfg, seed=0, device="cpu", trainable=True)
        loss, _ = tlm.loss_fn(tp, batch, cfg)
        loss.backward()
        out.append([loss.detach()] + [t.grad for t in tp.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*out))
    # the frontends are ported (tests/test_torch_frontends.py): a vlm
    # batch without patches embeds its tokens alone (label offset 0), as
    # in JAX; an audio batch must hold frames (JAX's KeyError too)
    x, pos, prefix = tlm.embed_inputs(tp, {"tokens": _t(tokens)},
                                      tc.replace(family="vlm"))
    assert prefix == 0 and x.shape[1] == pos.shape[1] == tokens.shape[1]
    with pytest.raises(KeyError, match="frames"):
        tlm.embed_inputs(tp, {"tokens": _t(tokens)},
                         tc.replace(family="audio"))
