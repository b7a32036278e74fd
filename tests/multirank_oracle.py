"""The JAX package's W-rank functions on fake CPU devices: the oracle of
tests/test_torch_multirank_*.py.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
        PYTHONPATH=src python tests/multirank_oracle.py GROUP OUT.npz

GROUP is ``kernels``, ``contiguous`` or ``paged``, one per test file.

Inputs come from a numpy seed; every input and output is written to
OUT.npz under "<case>/<name>". The port's tests run the same inputs
through the port and compare. Kept out of the test processes because
the fake-device count must be set before JAX starts.
"""
from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.core import collective_matmul as cm
from repro.core import flash_decode as fd
from repro.kernels import ops

WS = (2, 4)


def normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def strided(x, W):
    """Global position order -> the strided layout."""
    B, S = x.shape[:2]
    return (x.reshape(B, S // W, W, *x.shape[2:]).swapaxes(1, 2)
            .reshape(x.shape))


def mesh1(W):
    return jax.make_mesh((W,), ("model",), devices=jax.devices()[:W])


def mesh2(W):
    return jax.make_mesh((1, W), ("data", "model"),
                         devices=jax.devices()[:W])


def put(x, mesh, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


SEQ = P(None, "model", None, None)
POOL = P("model", None, None, None)


# ------------------------------------------------------------- kernels
def ag_gemm_cases(out):
    for W in WS:
        mesh = mesh1(W)
        a, b = normal(0, (16, 64)), normal(1, (64, 48))
        c = f"ag{W}"
        out[f"{c}/a"], out[f"{c}/b"] = a, b
        a_sh = put(a, mesh, P(None, "model"))
        for mode in ("bsp", "ring", "ring_bidir"):
            out[f"{c}/{mode}"] = np.asarray(jax.jit(
                lambda a, b, m=mode: cm.ag_gemm_k_sharded_sm(
                    a, b, mesh, mode=m))(a_sh, jnp.asarray(b)))
        out[f"{c}/pallas"] = np.asarray(jax.jit(
            lambda a, b: ops.ag_gemm(a, b, mesh, bn=16))(a_sh,
                                                         jnp.asarray(b)))
        # bf16 Pallas AG+GEMM (values rounded to bf16 on the way in)
        ab = np.asarray(jnp.asarray(normal(2, (8, 128))).astype(jnp.bfloat16)
                        .astype(jnp.float32))
        bb = np.asarray(jnp.asarray(normal(3, (128, 64))).astype(jnp.bfloat16)
                        .astype(jnp.float32))
        out[f"{c}/a_bf16"], out[f"{c}/b_bf16"] = ab, bb
        got = jax.jit(lambda a, b: ops.ag_gemm(a, b, mesh, bn=32))(
            put(jnp.asarray(ab).astype(jnp.bfloat16), mesh, P(None, "model")),
            jnp.asarray(bb).astype(jnp.bfloat16))
        out[f"{c}/pallas_bf16"] = np.asarray(got.astype(jnp.float32))
        # the validation errors: ragged K, odd ring_bidir shard
        for name, (K, mode) in {"err_ragged": (4 * W + 1, "ring"),
                                "err_bidir": (3 * W, "ring_bidir")}.items():
            aa, bb_ = normal(4, (8, K)), normal(5, (K, 8))
            try:
                cm.ag_gemm_k_sharded_sm(jnp.asarray(aa), jnp.asarray(bb_),
                                        mesh, mode=mode)
                msg = ""
            except ValueError as e:
                msg = str(e)
            out[f"{c}/{name}_a"], out[f"{c}/{name}_b"] = aa, bb_
            out[f"{c}/{name}"] = np.array(msg)


def flash_decode_cases(out):
    B, H, KVH, D, S = 2, 8, 4, 32, 64
    q, k, v = normal(10, (B, H, D)), normal(11, (B, S, KVH, D)), \
        normal(12, (B, S, KVH, D))
    out["fd/q"], out["fd/k"], out["fd/v"] = q, k, v
    for W in WS:
        mesh = mesh1(W)
        out[f"fd{W}/pallas"] = np.asarray(jax.jit(
            lambda q, k, v, c: ops.flash_decode(q, k, v, c, mesh, scale=0.25,
                                                blk=16))(
            jnp.asarray(q), put(strided(k, W), mesh, SEQ),
            put(strided(v, W), mesh, SEQ), 41))


def paged_kernel_cases(out):
    B, H, KVH, D, bs, n_blocks = 2, 8, 4, 32, 8, 16
    q = normal(20, (B, H, D))
    kp, vp = normal(21, (n_blocks, bs, KVH, D)), normal(22, (n_blocks, bs,
                                                            KVH, D))
    # blocks on every rank at W = 2 and 4; a shared first block; holes
    tables = np.array([[3, 12, 6, 9], [3, 0, -1, -1]], np.int32)
    cur = np.array([27, 13], np.int32)
    out["fdp/q"], out["fdp/kp"], out["fdp/vp"] = q, kp, vp
    out["fdp/tables"], out["fdp/cur"] = tables, cur
    for W in WS:
        mesh = mesh1(W)
        out[f"fdp{W}/pallas"] = np.asarray(jax.jit(
            lambda q, k, v, c, t: ops.flash_decode_paged(
                q, k, v, c, t, mesh, scale=0.25))(
            jnp.asarray(q), put(kp, mesh, POOL), put(vp, mesh, POOL),
            jnp.asarray(cur), jnp.asarray(tables)))


# -------------------------------------------------------------- decode
def contiguous_cases(out):
    B, H, KVH, D, S = 2, 8, 4, 16, 64
    q, k, v = normal(30, (B, H, D)), normal(31, (B, S, KVH, D)), \
        normal(32, (B, S, KVH, D))
    k_new, v_new = normal(33, (B, KVH, D)), normal(34, (B, KVH, D))
    out.update({"cd/q": q, "cd/k": k, "cd/v": v, "cd/k_new": k_new,
                "cd/v_new": v_new})
    curs = {"scalar": np.int32(38), "slots": np.array([17, 54], np.int32)}
    for W in WS:
        mesh = mesh2(W)
        ks, vs = put(strided(k, W), mesh, SEQ), put(strided(v, W), mesh, SEQ)
        for cname, cur in curs.items():
            out[f"cd/cur_{cname}"] = np.asarray(cur)
            for mode in ("bsp", "ring", "rs_ag"):
                c = f"cd{W}/{cname}/{mode}"
                o, ck, cv = jax.jit(
                    lambda q, kn, vn, kc, vc, cl, m=mode:
                    fd.decode_attention_fused_sm(
                        q, kn, vn, kc, vc, cl, mesh, scale=0.25, mode=m))(
                    jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
                    ks, vs, jnp.asarray(cur))
                out[f"{c}/fused"] = np.asarray(o)
                out[f"{c}/ck"], out[f"{c}/cv"] = np.asarray(ck), \
                    np.asarray(cv)
        out[f"cd{W}/window"] = np.asarray(jax.jit(
            lambda q, k, v, cl: fd.decode_attention_sm(
                q, k, v, cl, mesh, scale=0.25, mode="ring", window=16))(
            jnp.asarray(q), ks, vs, jnp.int32(49)))
        # per-slot lengths with one inactive slot
        act = np.array([True, False])
        out["cd/active"] = act
        o, ck, _ = jax.jit(
            lambda q, kn, vn, kc, vc, cl, a: fd.decode_attention_fused_sm(
                q, kn, vn, kc, vc, cl, mesh, scale=0.25, mode="ring",
                active=a))(
            jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), ks, vs,
            jnp.asarray(curs["slots"]), jnp.asarray(act))
        out[f"cd{W}/active/fused"], out[f"cd{W}/active/ck"] = \
            np.asarray(o), np.asarray(ck)
    # rolling: cache = window = 32, cur_len 45 > S (check_fused_decode_rolling)
    S_r = 32
    kr, vr = normal(35, (1, S_r, KVH, D)), normal(36, (1, S_r, KVH, D))
    qr = normal(37, (1, H, D))
    knr, vnr = normal(38, (1, KVH, D)), normal(39, (1, KVH, D))
    out.update({"roll/q": qr, "roll/k": kr, "roll/v": vr, "roll/k_new": knr,
                "roll/v_new": vnr})
    for W in WS:
        mesh = mesh2(W)
        o, _, _ = jax.jit(
            lambda q, kn, vn, kc, vc, c: fd.decode_attention_fused_sm(
                q, kn, vn, kc, vc, c, mesh, scale=0.25, mode="ring",
                rolling_len=S_r))(
            jnp.asarray(qr), jnp.asarray(knr), jnp.asarray(vnr),
            put(strided(kr, W), mesh, SEQ), put(strided(vr, W), mesh, SEQ),
            jnp.int32(45))
        out[f"roll{W}/fused"] = np.asarray(o)


def paged_cases(out):
    B, H, KVH, D, bs, n_blocks = 2, 8, 4, 16, 4, 16
    q = normal(40, (B, H, D))
    kp, vp = normal(41, (n_blocks, bs, KVH, D)), normal(42, (n_blocks, bs,
                                                            KVH, D))
    k_new, v_new = normal(43, (B, KVH, D)), normal(44, (B, KVH, D))
    # slot 0: a reclaim hole at chunk 1 (out of the window's reach), blocks
    # on every rank; slot 1 shares block 9 with slot 0
    tables = np.array([[9, -1, 14, 5, -1, -1], [9, 7, 1, -1, -1, -1]],
                      np.int32)
    cur = np.array([15, 10], np.int32)
    out.update({"pd/q": q, "pd/kp": kp, "pd/vp": vp, "pd/k_new": k_new,
                "pd/v_new": v_new, "pd/tables": tables, "pd/cur": cur})
    for W in WS:
        mesh = mesh2(W)
        # every schedule on the full table; the ring on a gather-width
        # slice, with and without a window
        for width, window, modes in ((6, None, ("bsp", "ring", "rs_ag")),
                                     (4, None, ("ring",)), (4, 6, ("ring",))):
            tb = jnp.asarray(tables[:, :width])
            for mode in modes:
                for bounded in (True, False):
                        c = f"pd{W}/{width}/{window}/{mode}/{bounded}"
                        o, ck, cv = jax.jit(
                            lambda q, kn, vn, k, v, cl, t, m=mode,
                            bd=bounded, w=window:
                            fd.decode_paged_attention_fused_sm(
                                q, kn, vn, k, v, cl, t, mesh, scale=0.25,
                                mode=m, window=w, bounded=bd))(
                            jnp.asarray(q), jnp.asarray(k_new),
                            jnp.asarray(v_new), put(kp, mesh, POOL),
                            put(vp, mesh, POOL), jnp.asarray(cur), tb)
                        out[f"{c}/out"] = np.asarray(o)
                        out[f"{c}/ck"], out[f"{c}/cv"] = np.asarray(ck), \
                            np.asarray(cv)


GROUPS = {"kernels": (ag_gemm_cases, flash_decode_cases, paged_kernel_cases),
          "contiguous": (contiguous_cases,), "paged": (paged_cases,)}


def main():
    group, path = sys.argv[1], sys.argv[2]
    if len(jax.devices()) < max(WS):
        raise SystemExit(f"needs {max(WS)} devices (XLA_FLAGS="
                         f"--xla_force_host_platform_device_count)")
    out: dict = {}
    for fn in GROUPS[group]:
        fn(out)
    np.savez(path, **out)


if __name__ == "__main__":
    main()
