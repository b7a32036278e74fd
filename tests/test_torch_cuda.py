"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (and nvcc to build the kernels) and skip
without one. On a GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

They import neither JAX nor the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("M,K,N", [(1, 4096, 1024), (8, 512, 1000),
                                   (3, 14336, 256), (20, 200, 136),
                                   (5, 100, 77), (33, 64, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trans_b", [False, True])
def test_matmul_kernel_matches_plain(cuda, M, K, N, dtype, trans_b):
    from repro_torch.kernels.matmul import matmul, matmul_plain
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(M * K + N)
    a = torch.randn((M, K), generator=g, device=cuda).to(dt)
    b = (torch.randn((N, K) if trans_b else (K, N), generator=g,
                     device=cuda) / K ** 0.5).to(dt)
    n0 = matmul.launches
    got = matmul(a, b, trans_b=trans_b).float()
    want = matmul_plain(a, b, trans_b).float()
    assert matmul.launches == n0 + 1
    scale = want.abs().max()
    if dt == torch.float32:      # fp32 sums in another order
        assert (got - want).abs().max() <= 1e-4 * scale
    else:                        # one bf16 ulp of an fp32 sum
        assert ((got - want).abs() <= 1e-2 * want.abs() + 1e-4 * scale).all()


def _gemm_tol_ok(got, want, dt):
    """The GEMM's tolerance: fp32 sums in another order (1e-4 of the
    largest |C|); bf16 one ulp of an fp32 sum (rtol 1e-2) plus 1e-4 of
    the largest |C| for sums near zero."""
    got, want = got.float(), want.float()
    scale = want.abs().max()
    if dt == torch.float32:
        return bool((got - want).abs().max() <= 1e-4 * scale)
    return bool(((got - want).abs() <= 1e-2 * want.abs()
                 + 1e-4 * scale).all())


@pytest.mark.parametrize("M", [1, 3, 8, 16])
@pytest.mark.parametrize("K,Ns", [(4096, (4096, 1024, 1024)),
                                  (4096, (14336, 14336)),
                                  (136, (1000, 64, 8))])
def test_matmul_group_is_bit_equal_to_single_calls(cuda, M, K, Ns):
    """wq/wk/wv and wg/wu in one launch: each output bit-equal to the
    product launched alone, and within the GEMM's tolerance of the plain
    version."""
    from repro_torch.kernels.matmul import matmul, matmul_group, matmul_plain
    g = torch.Generator(device=cuda).manual_seed(M * K)
    a = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    bs = [(torch.randn((K, N), generator=g, device=cuda) / K ** 0.5)
          .to(torch.bfloat16) for N in Ns]
    n0 = matmul.launches
    got = matmul_group(a, bs)
    assert matmul.launches == n0 + 1
    for c, b in zip(got, bs):
        assert torch.equal(c, matmul(a, b))
        assert _gemm_tol_ok(c, matmul_plain(a, b), torch.bfloat16)


def test_unembed_streams_the_transposed_fp32_table(cuda):
    """The fp32 unembed's shape: x (8, 4096) against the (128256, 4096)
    table read transposed."""
    from repro_torch.kernels.matmul import matmul, matmul_plain
    g = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randn((8, 4096), generator=g, device=cuda)
    b = torch.randn((128256, 4096), generator=g, device=cuda) * 0.02
    got = matmul(a, b, trans_b=True)
    assert _gemm_tol_ok(got, matmul_plain(a, b, True), torch.float32)


@pytest.mark.parametrize("D,H,KVH", [(32, 4, 1), (64, 8, 2), (128, 32, 8),
                                     (256, 8, 1)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("window", [None, 9])
def test_paged_decode_kernel_matches_plain(cuda, D, H, KVH, dtype, tol,
                                           window):
    from repro_torch.kernels.flash_decode import (flash_decode_paged,
                                                  paged_decode_plain)
    dt = getattr(torch, dtype)
    B, bs, n_blocks = 5, 8, 40
    g = torch.Generator(device=cuda).manual_seed(D + H)
    q = torch.randn((B, H, D), generator=g, device=cuda).to(dt)
    kp = torch.randn((n_blocks, bs, KVH, D), generator=g, device=cuda).to(dt)
    vp = torch.randn((n_blocks, bs, KVH, D), generator=g, device=cuda).to(dt)
    full = torch.randperm(n_blocks, generator=g, device=cuda)[:B * 8] \
        .reshape(B, 8).to(torch.int32)
    full[1, 0] = -1                          # a reclaim hole
    tables = full[:, :6]                     # gather-width slice (strided)
    cur = torch.tensor([1, 30, 8, 9, 48], dtype=torch.int32, device=cuda)
    n0 = flash_decode_paged.launches
    got = flash_decode_paged(q, kp, vp, cur, tables, D ** -0.5,
                             window=window).float()
    want = paged_decode_plain(q, kp, vp, cur, tables, D ** -0.5,
                              window=window).float()
    assert flash_decode_paged.launches == n0 + 1
    assert (got - want).abs().max() <= tol


@pytest.mark.parametrize("M,K,Ns,dtype,trans_b", [
    (512, 1152, (2048,), "bfloat16", False),   # paligemma's patches
    (2048, 512, (1280,), "bfloat16", False),   # hubert's frames
    (8, 2048, (2048, 256, 256), "bfloat16", False),   # paligemma wq/wk/wv
    (8, 2048, (16384, 16384), "bfloat16", False),     # its wg/wu
    (8, 16384, (2048,), "bfloat16", False),           # its wd
    (8, 2048, (257216,), "float32", True),    # its tied fp32 unembed
    (2048, 1280, (504,), "float32", True),    # hubert's head, N 504
    (2048, 2048, (16384,), "bfloat16", False),        # training wg
])
def test_matmul_at_the_frontend_shapes(cuda, M, K, Ns, dtype, trans_b):
    """The GEMM at the vlm and audio models' shapes (the frontend
    projections, paligemma's decode products and hubert's 504-row head)
    against its plain version, one launch a call, a group bit-equal to
    single calls."""
    from repro_torch.kernels.matmul import matmul, matmul_group, matmul_plain
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(M + K)
    a = torch.randn((M, K), generator=g, device=cuda).to(dt)
    ws = [(torch.randn((N, K) if trans_b else (K, N), generator=g,
                       device=cuda) / K ** 0.5).to(dt) for N in Ns]
    n0 = matmul.launches
    got = ([matmul(a, ws[0], trans_b=True)] if trans_b else
           matmul_group(a, ws) if len(ws) > 1 else [matmul(a, ws[0])])
    assert matmul.launches == n0 + 1
    for w, c in zip(ws, got):
        assert _gemm_tol_ok(c, matmul_plain(a, w, trans_b), dt)
        if len(ws) > 1:
            assert torch.equal(c, matmul(a, w))


def test_wrappers_raise_on_inputs_the_kernels_do_not_take(cuda):
    from repro_torch.kernels.flash_decode import flash_decode_paged
    from repro_torch.kernels.matmul import matmul
    a = torch.randn(4, 8, device=cuda)
    with pytest.raises(TypeError):
        matmul(a, torch.randn(8, 3, device=cuda).half())
    with pytest.raises(ValueError):
        matmul(a, torch.randn(3, 8, device=cuda).T)     # not contiguous
    with pytest.raises(ValueError):
        matmul(a, torch.randn(8, 3))                    # mixed devices
    q = torch.randn(2, 4, 48, device=cuda)              # D=48 not built
    pool = torch.randn(4, 4, 2, 48, device=cuda)
    with pytest.raises(ValueError):
        flash_decode_paged(q, pool, pool,
                           torch.ones(2, dtype=torch.int32, device=cuda),
                           torch.zeros(2, 2, dtype=torch.int32, device=cuda),
                           1.0)


def test_engine_on_cuda_matches_cpu(cuda):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, Request
    cfg = smoke_config(get_config("llama3-8b")).replace(
        n_layers=2, dtype=torch.float32)
    p_cpu = lm.init_params(cfg, seed=0, device="cpu")
    p_gpu = lm.from_tree(cfg, {k: v for k, v in _tree(p_cpu, cuda).items()})
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 512, n)] for n in (3, 9, 17)]
    outs = []
    for params, dev in ((p_gpu, "cuda"), (p_cpu, "cpu")):
        eng = Engine(params, cfg, batch=2, max_len=64, prefill_chunk=4,
                     block_size=8, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6),
                       at_tick=i)
        outs.append({r.rid: r.out_tokens for r in eng.run()})
    assert outs[0] == outs[1]


def _tree(params, device):
    """Nested dict of the parameters, moved to ``device``."""
    out = {}
    for name, t in params.named_parameters():
        node = out
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t.detach().to(device)
    return out


# ------------------------------------------------------ W-rank kernels
def _mesh(devices):
    from repro_torch.distributed.context import Mesh
    return Mesh(devices)


def _gemm_ok(got, want, dt):
    got, want = got.float(), want.float()
    scale = want.abs().max()
    if dt == torch.float32:      # fp32 sums in another order
        return bool((got - want).abs().max() <= 1e-4 * scale)
    return bool(((got - want).abs() <= 1e-2 * want.abs() + 1e-4 * scale)
                .all())          # one bf16 ulp of an fp32 sum


def _ag_gemm_case(devices, M, k, N, dt, seed, shared=False):
    """One fused AG+GEMM call vs plain; ``shared``: the ranks of a card
    pass one B tensor (the replicated weight: one product per card),
    else a copy each (one product per rank). Outputs must be
    bit-identical on every rank either way."""
    from repro_torch.kernels.ag_gemm import ag_gemm_fused, ag_gemm_plain
    W = len(devices)
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((M, W * k), generator=g).to(dt)
    b = (torch.randn((W * k, N), generator=g) / (W * k) ** 0.5).to(dt)
    shards = [a[:, r * k:(r + 1) * k].contiguous().to(d)
              for r, d in enumerate(devices)]
    per_card = {d: b.to(d) for d in devices}
    bs = [per_card[d] if shared else b.to(d) for d in devices]
    n0 = ag_gemm_fused.launches
    got = ag_gemm_fused(shards, bs, _mesh(devices))
    want = ag_gemm_plain([s.cpu() for s in shards], [b])[0]
    torch.cuda.synchronize()
    assert ag_gemm_fused.launches == n0 + len(set(devices))
    for o in got:
        assert torch.equal(o.cpu(), got[0].cpu())   # identical on every rank
        assert _gemm_ok(o.cpu(), want, dt)


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("M,k,N", [(8, 1024, 4096), (5, 37, 77),
                                   (20, 48, 136), (1, 8, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ag_gemm_kernel_matches_plain_on_virtual_ranks(cuda, W, M, k, N,
                                                       dtype):
    for epoch in range(3):            # flag reuse, both inbox parities
        _ag_gemm_case(["cuda:0"] * W, M, k, N, getattr(torch, dtype),
                      epoch + M * k, shared=bool(epoch % 2))


def _paged_case(devices, dt, window, seed, B=5, H=8, KVH=2, D=64, bs=8,
                n_blocks=32, C=6):
    """The fused and partial paged decodes over ``devices`` (one rank
    each) against the plain versions."""
    from repro_torch.kernels import flash_decode as kfd
    W = len(devices)
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, D), generator=g).to(dt)
    kp = torch.randn((n_blocks, bs, KVH, D), generator=g).to(dt)
    vp = torch.randn((n_blocks, bs, KVH, D), generator=g).to(dt)
    tb = torch.randperm(n_blocks, generator=g)[:B * C].reshape(B, C) \
        .to(torch.int32)
    tb[1, 0] = -1                            # a reclaim hole
    cur = torch.tensor([1, 30, 8, 9, 48], dtype=torch.int32)
    n_loc = n_blocks // W
    kps = [kp[r * n_loc:(r + 1) * n_loc] for r in range(W)]
    vps = [vp[r * n_loc:(r + 1) * n_loc] for r in range(W)]
    scale = D ** -0.5
    parts = [kfd.paged_partial_plain(q, kps[r], vps[r], cur, tb, scale,
                                     window, base=r * n_loc)
             for r in range(W)]
    want = kfd.fused_plain(parts, dt)[0]
    on = [(q.to(d), kps[r].contiguous().to(d), vps[r].contiguous().to(d),
           cur.to(d), tb.to(d)) for r, d in enumerate(devices)]
    args = [[x[i] for x in on] for i in range(5)] + [scale]
    n0 = kfd.flash_decode_paged_fused.launches
    got = kfd.flash_decode_paged_fused(*args, window=window,
                                       mesh=_mesh(devices))
    got_p = kfd.flash_decode_paged_partial(*args, window=window)
    torch.cuda.synchronize()
    assert kfd.flash_decode_paged_fused.launches == n0 + len(set(devices))
    tol = 1e-5 if dt == torch.float32 else 2e-2
    for o in got:
        assert torch.equal(o.cpu(), got[0].cpu())   # identical on every rank
        assert (o.float().cpu() - want.float()).abs().max() <= tol
    for r, (o, m, l) in enumerate(got_p):
        wo, wm, wl = parts[r]
        assert (m.cpu() - wm).abs().max() <= 1e-4
        assert (l.cpu() - wl).abs().max() <= 1e-3 * max(1.0, wl.max())


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 9])
def test_paged_fused_kernel_matches_plain_on_virtual_ranks(cuda, W, dtype,
                                                           window):
    for epoch in range(3):
        _paged_case(["cuda:0"] * W, getattr(torch, dtype), window, epoch)


def _strided_case(devices, dt, window, seed, B=4, H=8, KVH=2, D=64,
                  S_max=96):
    """The fused and partial strided decodes over ``devices`` (one rank
    each; W = 1 is NORMAL) against the plain versions."""
    from repro_torch.kernels import flash_decode as kfd
    W = len(devices)
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, D), generator=g).to(dt)
    S = S_max // W
    ks = [torch.randn((B, S, KVH, D), generator=g).to(dt) for _ in range(W)]
    vs = [torch.randn((B, S, KVH, D), generator=g).to(dt) for _ in range(W)]
    cur = torch.tensor([1, W + 1, 50, S_max], dtype=torch.int32)
    scale = D ** -0.5
    parts = [kfd.strided_partial_plain(q, ks[r], vs[r], cur, scale, window,
                                       r, W) for r in range(W)]
    want = kfd.fused_plain(parts, dt)[0]
    args = ([q.to(d) for d in devices], [x.to(d) for x, d in
                                         zip(ks, devices)],
            [x.to(d) for x, d in zip(vs, devices)],
            [cur.to(d) for d in devices], scale)
    got = kfd.flash_decode_fused(*args, window=window, mesh=_mesh(devices))
    got_p = kfd.flash_decode_partial(*args, window=window)
    torch.cuda.synchronize()
    tol = 1e-5 if dt == torch.float32 else 2e-2
    for o in got:
        assert torch.equal(o.cpu(), got[0].cpu())
        assert (o.float().cpu() - want.float()).abs().max() <= tol
    for (o, m, l), (wo, wm, wl) in zip(got_p, parts):
        assert (m.cpu() - wm).abs().max() <= 1e-4
        assert (l.cpu() - wl).abs().max() <= 1e-3 * max(1.0, wl.max())


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 20])
def test_strided_fused_kernel_matches_plain_on_virtual_ranks(cuda, W, dtype,
                                                             window):
    for epoch in range(3):
        _strided_case(["cuda:0"] * W, getattr(torch, dtype), window, epoch)


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_256_decodes_match_plain(cuda, W, dtype):
    """paligemma's heads (8 query heads per KV head of 256: two units of
    4 heads each, ``kernels.flash_decode.heads_per_unit``): the paged
    decode (W = 1; fused and partial over W virtual ranks) and the
    strided one, each over three calls in a row, against the plain
    versions at phase 2's tolerances."""
    from repro_torch.kernels import flash_decode as kfd
    dt = getattr(torch, dtype)
    devices = ["cuda:0"] * W
    for epoch in range(3):
        if W > 1:
            _paged_case(devices, dt, None if epoch else 9, epoch, H=8,
                        KVH=1, D=256)
        _strided_case(devices, dt, None if epoch else 20, epoch, H=8, KVH=1,
                      D=256, S_max=96 * W)
    assert kfd.heads_per_unit(8, 256) == 4


def _traced_launches(call, name, traces=3):
    """(launches of csrc kernel ``name`` in one traced ``call()``, calls
    made). A trace holding no kernel of the port at all lost its device
    records (seen on the H100 once in a run, of a call the wrapper
    counted): the call is traced again, up to ``traces`` times, as
    ``chip_smoke.py``'s ``_kernel_launches`` does."""
    from torch.profiler import ProfilerActivity, profile
    port = ("::gemm_stream<", "::mm_kernel<", "::fd_paged<",
            "::fd_strided<", "::ag_gemm_kernel<")
    for t in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = call()
            torch.cuda.synchronize()
        # device events only: a host-side range of the same name would
        # count the launch twice
        kernels = [(e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if any(p in k for k, _ in kernels for p in port):
            break
    return sum(c for k, c in kernels if f"::{name}<" in k), t + 1, out


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("S_max", [96, 600])
def test_strided_kernel_is_one_launch_per_card_per_call(cuda, W, S_max):
    """NORMAL (W = 1), FUSED and PARTIAL: the wrapper counts one launch
    per card per call, and the profiler's device trace shows one
    ``fd_strided`` kernel; shards of S_max / W rows need not be whole
    tiles (600 / 4 = 150)."""
    from repro_torch.kernels import flash_decode as kfd
    B, H, KVH, D = 4, 8, 2, 64
    g = torch.Generator(device=cuda).manual_seed(S_max + W)
    q = torch.randn((B, H, D), generator=g, device=cuda)
    ks = [torch.randn((B, S_max // W, KVH, D), generator=g, device=cuda)
          for _ in range(W)]
    vs = [torch.randn((B, S_max // W, KVH, D), generator=g, device=cuda)
          for _ in range(W)]
    cur = torch.tensor([1, W + 1, 50, S_max], dtype=torch.int32,
                       device=cuda)
    args = ([q] * W, ks, vs, [cur] * W, D ** -0.5)
    mesh = _mesh(["cuda:0"] * W)
    want = kfd.fused_plain([kfd.strided_partial_plain(
        q, ks[r], vs[r], cur, D ** -0.5, None, r, W) for r in range(W)],
        torch.float32)[0]
    for wrapper, call in (
            (kfd.flash_decode_fused,
             lambda: kfd.flash_decode_fused(*args, mesh=mesh)),
            (kfd.flash_decode_partial,
             lambda: kfd.flash_decode_partial(*args))):
        call()                              # buffers sized
        torch.cuda.synchronize()
        n0 = wrapper.launches
        launched, calls, out = _traced_launches(call, "fd_strided")
        assert wrapper.launches == n0 + calls
        assert launched == 1
        if wrapper is kfd.flash_decode_fused:
            for o in out:
                assert torch.equal(o, out[0])
                assert (o - want).abs().max() <= 1e-5


def test_fused_kernels_share_one_communicator_call_after_call(cuda):
    """The three fused kernels take turns on one mesh (one epoch
    counter, one set of flags and inboxes, grown on demand)."""
    for seed in range(4):
        _ag_gemm_case(["cuda:0"] * 4, 8, 256, 512, torch.bfloat16, seed)
        _paged_case(["cuda:0"] * 4, torch.float32, None, seed)
        _strided_case(["cuda:0"] * 4, torch.bfloat16, 20, seed)


def _paged_inputs(g, dt, B, H, KVH, D, bs, n_blocks, C, cur):
    q = torch.randn((B, H, D), generator=g).to(dt)
    kp = torch.randn((n_blocks, bs, KVH, D), generator=g).to(dt)
    vp = torch.randn((n_blocks, bs, KVH, D), generator=g).to(dt)
    tb = torch.randperm(n_blocks, generator=g)[:B * C].reshape(B, C) \
        .to(torch.int32)
    tb[0, 0] = -1                            # a reclaim hole
    return q, kp, vp, torch.tensor(cur, dtype=torch.int32), tb


@pytest.mark.parametrize("W,B,H,KVH,D,bs,C,cur", [
    (1, 3, 8, 2, 128, 32, 40, [1, 700, 1280]),     # 2 tiles per block,
    (4, 3, 8, 2, 128, 32, 40, [1, 700, 1280]),     # many splits
    (4, 48, 32, 8, 128, 16, 4, [64] * 48),         # more units than fit
    (1, 1, 4, 1, 64, 16, 200, [3000]),             # splits that cross a
    (4, 1, 4, 1, 64, 16, 200, [3000]),             # run of 32 entries
])
@pytest.mark.parametrize("window", [None, 300])
def test_paged_kernel_long_blocks_splits_and_many_units(cuda, W, B, H, KVH,
                                                        D, bs, C, cur,
                                                        window):
    """Blocks longer than a staged tile, tables long enough to split,
    splits whose entries cross a run of 32 table columns (compacted
    through shared memory), and a fused grid with more units than the
    card holds at once (each block then walks several)."""
    from repro_torch.kernels import flash_decode as kfd
    g = torch.Generator().manual_seed(B * C)
    n_blocks = max(4 * B * C, 64)
    q, kp, vp, cl, tb = _paged_inputs(g, torch.float32, B, H, KVH, D, bs,
                                      n_blocks, C, cur)
    scale = D ** -0.5
    if W == 1:
        got = kfd.flash_decode_paged(q.to(cuda), kp.to(cuda), vp.to(cuda),
                                     cl.to(cuda), tb.to(cuda), scale,
                                     window=window)
        want = kfd.paged_decode_plain(q, kp, vp, cl, tb, scale, window)
        assert (got.cpu() - want).abs().max() <= 1e-5
        return
    n_loc = n_blocks // W
    kps = [kp[r * n_loc:(r + 1) * n_loc] for r in range(W)]
    vps = [vp[r * n_loc:(r + 1) * n_loc] for r in range(W)]
    parts = [kfd.paged_partial_plain(q, kps[r], vps[r], cl, tb, scale,
                                     window, base=r * n_loc)
             for r in range(W)]
    want = kfd.fused_plain(parts, torch.float32)[0]
    args = ([q.to(cuda)] * W, [x.to(cuda) for x in kps],
            [x.to(cuda) for x in vps], [cl.to(cuda)] * W,
            [tb.to(cuda)] * W, scale)
    got = kfd.flash_decode_paged_fused(*args, window=window,
                                       mesh=_mesh(["cuda:0"] * W))
    got_p = kfd.flash_decode_paged_partial(*args, window=window)
    for o in got:
        assert torch.equal(o, got[0])
        assert (o.cpu() - want).abs().max() <= 1e-5
    for (o, m, l), (wo, wm, wl) in zip(got_p, parts):
        assert (m.cpu() - wm).abs().max() <= 1e-4
        assert (l.cpu() - wl).abs().max() <= 1e-3 * max(1.0, wl.max())


def _epoch(mesh) -> int:
    """The card's device-resident epoch word (one card)."""
    torch.cuda.synchronize()
    return mesh.symm.epoch()


class _Replayable:
    """Static CUDA inputs of one fused kernel, refilled in place with
    fresh values (``fill(seed)`` returns the plain version's output),
    and the call a CUDA graph captures (``call()``)."""

    def __init__(self, kind, W, dt):
        self.kind, self.W, self.dt = kind, W, dt
        self.mesh = None
        if kind == "ag_gemm":
            self.M, self.k, self.N = 8, 256, 512
            self.a = [torch.empty((self.M, self.k), dtype=dt, device="cuda")
                      for _ in range(W)]
            self.b = torch.empty((W * self.k, self.N), dtype=dt,
                                 device="cuda")
        elif kind == "paged":
            self.dims = dict(B=5, H=8, KVH=2, D=64, bs=8, n_blocks=32, C=6)
            self.cur = [1, 30, 8, 9, 48]
            self.static = None
        else:
            self.B, self.H, self.KVH, self.D, self.S = 4, 8, 2, 64, 96 // W
            self.static = None

    def fill(self, seed):
        from repro_torch.kernels import flash_decode as kfd
        from repro_torch.kernels.ag_gemm import ag_gemm_plain
        W, dt = self.W, self.dt
        g = torch.Generator().manual_seed(seed)
        if self.kind == "ag_gemm":
            a = torch.randn((self.M, W * self.k), generator=g).to(dt)
            b = (torch.randn((W * self.k, self.N), generator=g)
                 / (W * self.k) ** 0.5).to(dt)
            for r in range(W):
                self.a[r].copy_(a[:, r * self.k:(r + 1) * self.k])
            self.b.copy_(b)
            return ag_gemm_plain([x.cpu() for x in self.a], [b])[0]
        if self.kind == "paged":
            d = self.dims
            q, kp, vp, cl, tb = _paged_inputs(
                g, dt, d["B"], d["H"], d["KVH"], d["D"], d["bs"],
                d["n_blocks"], d["C"], self.cur)
            n_loc = d["n_blocks"] // W
            kps = [kp[r * n_loc:(r + 1) * n_loc] for r in range(W)]
            vps = [vp[r * n_loc:(r + 1) * n_loc] for r in range(W)]
            new = (q, kps, vps, cl, tb)
            want = kfd.fused_plain(
                [kfd.paged_partial_plain(q, kps[r], vps[r], cl, tb,
                                         d["D"] ** -0.5, None,
                                         base=r * n_loc)
                 for r in range(W)], dt)[0]
        else:
            q = torch.randn((self.B, self.H, self.D), generator=g).to(dt)
            ks = [torch.randn((self.B, self.S, self.KVH, self.D),
                              generator=g).to(dt) for _ in range(W)]
            vs = [torch.randn((self.B, self.S, self.KVH, self.D),
                              generator=g).to(dt) for _ in range(W)]
            cl = torch.tensor([1, W + 1, 50, 96], dtype=torch.int32)
            new = (q, ks, vs, cl)
            want = kfd.fused_plain(
                [kfd.strided_partial_plain(q, ks[r], vs[r], cl,
                                           self.D ** -0.5, None, r, W)
                 for r in range(W)], dt)[0]
        if self.static is None:
            self.static = tuple(
                [x.cuda() for x in t] if isinstance(t, list) else t.cuda()
                for t in new)
        else:
            for dst, src in zip(self.static, new):
                for d_, s_ in zip(dst if isinstance(dst, list) else [dst],
                                  src if isinstance(src, list) else [src]):
                    d_.copy_(s_)
        return want

    def call(self):
        from repro_torch.kernels import flash_decode as kfd
        from repro_torch.kernels.ag_gemm import ag_gemm_fused
        W = self.W
        if self.kind == "ag_gemm":
            return ag_gemm_fused(self.a, [self.b] * W, self.mesh)
        if self.kind == "paged":
            q, kps, vps, cl, tb = self.static
            return kfd.flash_decode_paged_fused(
                [q] * W, kps, vps, [cl] * W, [tb] * W,
                self.dims["D"] ** -0.5, mesh=self.mesh)
        q, ks, vs, cl = self.static
        return kfd.flash_decode_fused([q] * W, ks, vs, [cl] * W,
                                      self.D ** -0.5, mesh=self.mesh)

    def check(self, got, want):
        for o in got:
            assert torch.equal(o, got[0])      # identical on every rank
        if self.kind == "ag_gemm":
            assert _gemm_ok(got[0].cpu(), want, self.dt)
        else:
            tol = 1e-5 if self.dt == torch.float32 else 2e-2
            assert (got[0].float().cpu() - want.float()).abs().max() <= tol


def _capture(cases, mesh):
    """Warm every case up (sizes the mesh's buffers), then capture one
    call of each, in order, in one CUDA graph."""
    for c in cases:
        c.mesh = mesh
        c.fill(0)
        c.call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c.call() for c in cases]
    return graph, outs


@pytest.mark.parametrize("kind", ["ag_gemm", "paged", "strided"])
@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_kernel_replays_from_a_cuda_graph(cuda, kind, W, dtype):
    """One call captured in a CUDA graph, replayed three times with
    fresh inputs copied in: every replay matches the plain version, and
    the card's epoch word advances once per replay (a replayed call
    waits for this replay's pushes, not the capture's)."""
    case = _Replayable(kind, W, getattr(torch, dtype))
    mesh = _mesh(["cuda:0"] * W)
    graph, (out,) = _capture([case], mesh)
    e0 = _epoch(mesh)
    for rep in range(3):
        want = case.fill(rep + 1)
        graph.replay()
        torch.cuda.synchronize()
        case.check(out, want)
        assert _epoch(mesh) == e0 + rep + 1
    del graph


@pytest.mark.parametrize("W", [2, 4])
def test_one_graph_mixes_ag_gemm_and_fused_paged_decode(cuda, W):
    """The fused AG+GEMM and the fused paged decode of one layer, in one
    graph on one mesh, replayed three times with fresh inputs."""
    cases = [_Replayable("ag_gemm", W, torch.bfloat16),
             _Replayable("paged", W, torch.bfloat16),
             _Replayable("ag_gemm", W, torch.bfloat16)]
    mesh = _mesh(["cuda:0"] * W)
    graph, outs = _capture(cases, mesh)
    e0 = _epoch(mesh)
    for rep in range(3):
        wants = [c.fill(10 * rep + i + 1) for i, c in enumerate(cases)]
        graph.replay()
        torch.cuda.synchronize()
        for c, o, w in zip(cases, outs, wants):
            c.check(o, w)
        assert _epoch(mesh) == e0 + 3 * (rep + 1)
    del graph


@pytest.fixture
def two_gpus(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("real-peer case: needs two or more GPUs (this machine "
                    f"has {torch.cuda.device_count()})")
    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(min(n, 4))]


def test_ag_gemm_kernel_across_real_peers(two_gpus):
    for epoch in range(3):
        _ag_gemm_case(two_gpus, 8, 1024, 4096, torch.bfloat16, epoch)
        _ag_gemm_case(two_gpus, 5, 37, 77, torch.float32, epoch)


def test_flash_decode_kernels_across_real_peers(two_gpus):
    for epoch in range(3):
        _paged_case(two_gpus, torch.bfloat16, None, epoch)
        _strided_case(two_gpus, torch.float32, 20, epoch)


def test_virtual_and_real_ranks_mixed(two_gpus):
    """Two ranks on each of two cards."""
    devs = [two_gpus[0], two_gpus[0], two_gpus[1], two_gpus[1]]
    _ag_gemm_case(devs, 8, 256, 512, torch.bfloat16, 0)
    _paged_case(devs, torch.float32, 9, 0)


def test_serve_over_real_peers(two_gpus):
    from repro_torch.launch import serve
    stats = serve.main(["--arch", "llama3-8b", "--smoke", "--requests", "2",
                        "--batch", "2", "--max-new", "3", "--tp",
                        str(len(two_gpus)), "--devices", ",".join(two_gpus),
                        "--fusion-mode", "pallas"])
    assert stats["new_tokens"] == 6


_MISSING_RANK = r"""
import sys, time, torch
from repro_torch.distributed.context import Mesh
from repro_torch.kernels.ag_gemm import launch_card
W, M, k, N = 2, 4, 64, 64
mesh = Mesh(["cuda:0"] * W)
a = torch.randn(M, k, device="cuda")
b = torch.randn(W * k, N, device="cuda")
c = torch.empty(M, N, device="cuda")
t0 = time.time()
# launch rank 0 alone: rank 1 never pushes its shard
launch_card([a], [b], [c], [0], mesh)
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print(f"CUDA_ERROR after {time.time() - t0:.2f} s: {e}")
    sys.exit(0)
print("NO_ERROR")
sys.exit(1)
"""


def test_a_rank_that_never_arrives_ends_in_a_cuda_error(cuda):
    """The spin on a missing peer's flag is bounded (~1 s, globaltimer)
    and traps: a CUDA error, not a hang. Run in a subprocess, since the
    trap leaves its CUDA context unusable."""
    import os
    import pathlib
    import subprocess
    import sys
    from repro_torch.kernels import _build
    _build.build_all(["ag_gemm"])
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    r = subprocess.run([sys.executable, "-c", _MISSING_RANK], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "CUDA_ERROR" in r.stdout


@pytest.mark.parametrize("tp,mode,paged", [(1, "auto", True),
                                           (1, "auto", False),
                                           (4, "pallas", True),
                                           (4, "pallas", False),
                                           (4, "ring", True)])
def test_decode_step_makes_no_host_sync(cuda, tp, mode, paged):
    """One decode step, paged or contiguous, at W = 1 and over 4
    virtual ranks, under ``torch.cuda.set_sync_debug_mode("error")``:
    any operation that waits for the card raises."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.distributed import context as dctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    cfg = smoke_config(get_config("llama3-8b")).replace(
        n_layers=2, dtype=torch.float32)
    params = lm.init_params(cfg, seed=0, device="cuda")
    mesh = make_mesh(tp, device="cuda") if tp > 1 else None
    with dctx.use(dctx.DistContext(mesh, mode)), torch.inference_mode():
        if paged:
            st = lm.init_paged_decode_state(params, cfg, 4, 16, 8, 4)
            bt = st["block_tables"]
            for t in bt if isinstance(bt, list) else [bt]:
                t.copy_(torch.arange(16, dtype=torch.int32).reshape(4, 4))
        else:
            st = lm.init_decode_state(params, cfg, 4, 32)
        tok = torch.ones((4, 1), dtype=torch.int64, device=cuda)
        act = torch.tensor([True, False, True, True], device=cuda)
        lm.decode_step(params, tok, st, cfg, active=act)   # buffers grow
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            lg, _ = lm.decode_step(params, tok, st, cfg, active=act)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(lg).all())


@pytest.mark.parametrize("tp", [1, 4])
def test_admission_and_buffer_growth_make_no_host_sync(cuda, tp):
    """What ``chip_smoke.py`` phase 19 found and the lint cannot see: an
    admission (``lm.reset_slot_paged`` stored a Python int into the
    card's ``cur_len``) and a growth of the symmetric buffers (the
    warm-up before a tp 4 capture uploaded its pointer tables from
    pageable memory) each synchronised. Under
    ``set_sync_debug_mode("error")`` neither may now."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.distributed import context as dctx
    from repro_torch.kernels import symm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    cfg = smoke_config(get_config("llama3-8b")).replace(
        n_layers=2, dtype=torch.float32)
    params = lm.init_params(cfg, seed=0, device="cuda")
    mesh = make_mesh(tp, device="cuda") if tp > 1 else None
    with dctx.use(dctx.DistContext(mesh, "pallas")), torch.inference_mode():
        st = lm.init_paged_decode_state(params, cfg, 4, 16, 8, 4)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            lm.reset_slot_paged(st, cfg, 1)
            lm.set_slot_len(st, 2, 5)
            lm.release_slot_paged(st, 3)
            if mesh is not None:
                symm.communicator(mesh).call(4096, 8)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        cl = st["cur_len"]
        for c in cl if isinstance(cl, list) else [cl]:
            assert c.tolist() == [0, 0, 5, 0]


# ------------------------------------------------------------- megaticks
def _smoke_cuda():
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm
    cfg = smoke_config(get_config("llama3-8b")).replace(
        n_layers=2, dtype=torch.float32)
    return cfg, lm.init_params(cfg, seed=0, device="cuda")


def _lockstep(engines, reqs, between=None):
    """Submit ``reqs`` to every engine and tick them in lockstep; after
    every tick the emitted tokens, ``cur_len``, block tables and the
    bytes of every cache leaf (KV pools, recurrent state) must be
    identical across the engines. ``between(tick)`` runs after each
    tick. Returns the finished requests of the first."""
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.serving.engine import Request
    for eng in engines:
        for rid, (prompt, max_new, at, temp, top_k) in enumerate(reqs):
            eng.submit(Request(rid=rid, prompt=list(prompt),
                               max_new_tokens=max_new, temp=temp,
                               top_k=top_k), at_tick=at)
    done = [[] for _ in engines]

    def flat(x):
        return x if isinstance(x, list) else [x]
    while any(e.queue or e.active for e in engines):
        for d, eng in zip(done, engines):
            d += eng.tick()
        streams = [{r.rid: list(r.out_tokens)
                    for r in list(e.active.values()) + d}
                   for e, d in zip(engines, done)]
        states = [e.pool.state for e in engines]
        for st, s in zip(states[1:], streams[1:]):
            assert s == streams[0]
            for key in ("cur_len", "block_tables"):
                for a, b in zip(flat(states[0][key]), flat(st[key])):
                    assert torch.equal(a, b), key
            ref = flatten(states[0]["caches"])
            for key, leaf in flatten(st["caches"]).items():
                assert torch.equal(ref[key].view(torch.uint8),
                                   leaf.view(torch.uint8)), key
        if between is not None:
            between(engines[0].tick_count)
    return done[0]


_MEGA_REQS = [([1, 2, 3, 4, 5, 6, 7], 9, 0, 1.0, 0), ([3, 4], 11, 0, 0.7, 5),
              ([5, 6, 9, 11, 13, 2, 8, 8, 1, 4, 6], 6, 1, 0.0, 0),
              ([9, 8, 7], 10, 3, 1.3, 512)]


@pytest.mark.parametrize("tp", [1, 4])
@pytest.mark.parametrize("sampler", ["greedy", "temperature"])
def test_megatick_graph_replay_matches_eager_loop(cuda, tp, sampler):
    """A K = 4 engine replaying one CUDA graph per megatick against the
    same engine running the megatick loop eagerly, in lockstep: tokens,
    ``cur_len``, tables and KV pool bytes identical after every tick,
    pure and mixed megaticks, at W = 1 and on 4 virtual ranks under
    ``pallas``. Launches are counted per replay: every decode step the
    two engines ran (scan lengths + the graphs' warm-up steps) launched
    the GEMM 4 times a layer + once for the unembed (3 + 1 over ranks
    under ``pallas``, where ``wo`` is the AG+GEMM)."""
    from repro_torch.distributed import context as dctx
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import Engine
    cfg, params = _smoke_cuda()
    mesh = make_mesh(tp, device="cuda") if tp > 1 else None
    with dctx.use(dctx.DistContext(mesh, "pallas")):
        engs = [Engine(params, cfg, batch=3, max_len=64, prefill_chunk=4,
                       block_size=8, decode_steps=4, sampler=sampler,
                       device="cuda") for _ in range(2)]
    engs[1]._runner.use_graphs = False
    n0 = matmul.launches
    done = _lockstep(engs, _MEGA_REQS)
    launched = matmul.launches - n0
    assert len(done) == len(_MEGA_REQS)
    m = engs[0].metrics(done)
    assert m["graphs"] and m["graph_replays"] == m["dispatches"]
    assert m["mixed_dispatches"] > 0 and m["decode_dispatches"] > 0
    assert not engs[1].metrics([])["graph_replays"]
    # both engines ran the same steps; the graph engine also its warm-ups
    steps = 2 * engs[0].scan_steps + m["graph_warmup_steps"]
    per_step = (4 if tp == 1 else 3) * cfg.n_layers + 1
    assert engs[1].scan_steps == engs[0].scan_steps
    assert launched == steps * per_step


def test_graph_captured_before_symm_growth_still_replays(cuda):
    """Graphs captured on 4 virtual ranks, then the symmetric buffers and
    the arrival counters grow (the old ones stay alive): the old graphs
    replay into the old buffers and stay identical to the eager loop,
    which takes the new ones. Growing inside a capture raises."""
    from repro_torch.distributed import context as dctx
    from repro_torch.kernels import symm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import Engine
    cfg, params = _smoke_cuda()
    mesh = make_mesh(4, device="cuda")
    with dctx.use(dctx.DistContext(mesh, "pallas")):
        engs = [Engine(params, cfg, batch=3, max_len=64, prefill_chunk=4,
                       block_size=8, decode_steps=4, device="cuda")
                for _ in range(2)]
    engs[1]._runner.use_graphs = False
    grown = []

    def grow(tick):
        if tick == 2:
            comm = symm.communicator(mesh)
            comm.call(4 * comm.half, 4 * comm.n_chunk)
            symm.counters("cuda:0", 8 * symm.counters("cuda:0", 1).numel())
            grown.append(len(comm.retired))
    _lockstep(engs, _MEGA_REQS, between=grow)
    assert grown and grown[0] >= 1
    assert engs[0].metrics([])["graph_replays"] > engs[0].metrics(
        [])["graph_captures"]
    graph = torch.cuda.CUDAGraph()
    x = torch.zeros(1, device=cuda)
    err = ""
    with torch.cuda.graph(graph):
        x += 1
        try:
            symm.counters("cuda:0", 8 * symm.counters("cuda:0", 1).numel())
        except RuntimeError as e:
            err = str(e)
    assert "cannot grow inside a CUDA graph capture" in err


def test_graph_count_within_bucket_bound(cuda):
    """A serve with ragged lengths at K = 8: one graph per (path, S, gw)
    key, captured once each, and no more keys than 2 paths x (log2 K +
    1) scan lengths x (log2 max_blocks + 1) gather widths."""
    import math
    from repro_torch.serving.engine import Engine, Request
    cfg, params = _smoke_cuda()
    K = 8
    eng = Engine(params, cfg, batch=4, max_len=128, prefill_chunk=8,
                 block_size=8, decode_steps=K, device="cuda")
    rng = np.random.default_rng(0)
    for rid, (n, new) in enumerate(((5, 40), (30, 9), (61, 20), (2, 3),
                                    (17, 50), (9, 1))):
        eng.submit(Request(rid=rid, prompt=[int(t) for t in rng.integers(
            1, cfg.vocab_size, n)], max_new_tokens=new), at_tick=rid)
    done = eng.run()
    m = eng.metrics(done)
    assert len(done) == 6
    bound = 2 * (int(math.log2(K)) + 1) * (
        int(math.log2(eng.pool.max_blocks)) + 1)
    assert m["graph_count"] == m["graph_captures"] <= bound
    assert m["graph_replays"] == m["dispatches"] > m["graph_count"]


_P8 = [5, 6, 7, 8, 9, 10, 11, 12]
# (sliding window, n_blocks, requests): preemption at a pure-megatick
# boundary with window reclaim in a pool of 2 blocks (and re-admission
# as a prefix hit); in 3 blocks also copy-on-write of a shared block
_PRESSURE = {
    "two_blocks": (8, 2, [([1, 2, 3], 14, 0, 1.0, 0), (_P8, 12, 0, 1.0, 0),
                          (_P8, 9, 4, 1.0, 0)]),
    "three_blocks": (12, 3, [(_P8, 14, 0, 1.0, 0),
                             ([9, 8, 7, 6, 5], 12, 0, 1.0, 0),
                             (_P8, 10, 3, 1.0, 0)]),
}


def _pressure_engines(case, n=2, **kw):
    from repro_torch.serving.engine import Engine
    cfg, params = _smoke_cuda()
    window, n_blocks, reqs = _PRESSURE[case]
    cfg = cfg.replace(sliding_window=window)
    engs = [Engine(params, cfg, batch=2, max_len=64, prefill_chunk=4,
                   block_size=8, n_blocks=n_blocks, decode_steps=4,
                   device="cuda", **kw) for _ in range(n)]
    return engs, reqs


@pytest.mark.parametrize("case", sorted(_PRESSURE))
def test_graph_replay_through_preemption_reclaim_and_cow(cuda, case):
    """K = 4 graph replays against the eager loop in lockstep under block
    pressure and a sliding window: a pure megatick stalls and preempts,
    the victim comes back as a prefix hit, blocks roll out of the window
    (and, in 3 blocks, a shared block is copied on write), with tokens,
    cur_len, tables and KV bytes identical after every tick."""
    engs, reqs = _pressure_engines(case)
    engs[1]._runner.use_graphs = False
    pure_preempts = []
    orig = engs[0]._preempt_one

    def preempt():
        pure_preempts.append(not any(r.prefilling
                                     for r in engs[0].active.values()))
        orig()
    engs[0]._preempt_one = preempt
    try:
        done = _lockstep(engs, reqs)
    finally:
        del engs[0]._preempt_one      # no engine <-> closure cycle
    assert len(done) == len(reqs)
    m = engs[0].metrics(done)
    assert m["graphs"] and m["graph_replays"] == m["dispatches"]
    assert any(pure_preempts) and m["preemptions"] >= 1
    assert m["prefix_hits"] >= 1 and m["kv_blocks_reclaimed"] >= 1
    if case == "three_blocks":
        assert m["cow_copies"] >= 1


def test_retried_dispatch_leaves_the_state_byte_identical(cuda):
    """Injected transient dispatch faults (two failed attempts each) at a
    capture tick and at replay ticks, against a fault-free engine in
    lockstep: every retry trips before anything is launched, so tokens,
    cur_len, tables and KV bytes stay identical after every tick."""
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    # tick 1 captures its graph, ticks 4 and 9 replay graphs of ticks 3
    # and 8 (as the same engine schedules them on the CPU)
    (clean,), reqs = _pressure_engines("three_blocks", n=1)
    plan = FaultPlan([FaultSpec("dispatch", t, count=2) for t in (1, 4, 9)])
    faulty, _ = _pressure_engines("three_blocks", n=1, fault_plan=plan)
    done = _lockstep([clean, faulty[0]], reqs)
    assert len(done) == len(reqs)
    m = faulty[0].metrics([])
    assert m["dispatch_retries"] == 6 and m["dispatch_failures"] == 0
    assert m["graph_replays"] == m["dispatches"]
    assert m["graph_capture_ticks"] >= 1


def test_restore_into_an_engine_holding_graphs(cuda, tmp_path):
    """A snapshot restored into an engine that already captured and
    replayed graphs (restore writes the state in place, the graphs keep
    their addresses) replays on identically to a fresh engine."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.serving.engine import Request
    engs, reqs = _pressure_engines("three_blocks", n=3)
    src, warm, fresh = engs
    _lockstep([warm], [(p[::-1], n, at, t, k) for p, n, at, t, k in reqs])
    keys = set(warm._runner.graphs)
    assert keys and warm._runner.replays > 0
    for rid, (prompt, max_new, _, _, _) in enumerate(reqs):
        src.submit(Request(rid=rid, prompt=list(prompt),
                           max_new_tokens=max_new))
    for _ in range(3):
        src.tick()
    step = src.snapshot(Checkpointer(str(tmp_path)))
    for eng in (warm, fresh):
        assert eng.restore(Checkpointer(str(tmp_path)), step)
    used = []
    run = warm._runner.run

    def record(path, S, gw, **arrays):
        used.append((path, S, gw))
        return run(path, S, gw, **arrays)
    warm._runner.run = record
    try:
        done = _lockstep([warm, fresh], [])
    finally:
        del warm._runner.run
    assert len(done) == len(reqs)
    assert set(used) & keys            # graphs captured before the restore


def test_non_transient_dispatch_error_propagates(cuda):
    """An exception raised inside a graph replay (as a real CUDA error
    would be) leaves the tick at once: the injected transient fault of
    the same tick was retried before the replay, the error itself never
    is, and no DispatchFailedError replaces it."""
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    (eng,), reqs = _pressure_engines(
        "three_blocks", n=1,
        fault_plan=FaultPlan([FaultSpec("dispatch", 4, count=1)]))
    from repro_torch.serving.engine import Request
    for rid, (prompt, max_new, _, _, _) in enumerate(reqs):
        eng.submit(Request(rid=rid, prompt=list(prompt),
                           max_new_tokens=max_new))
    for _ in range(3):
        eng.tick()
    assert ("pure", 4, 2) in eng._runner.graphs   # tick 4 replays it

    def boom(graph):
        raise RuntimeError("simulated CUDA error")
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.cuda.CUDAGraph, "replay", boom)
    try:
        with pytest.raises(RuntimeError, match="simulated CUDA error"):
            eng.tick()
    finally:
        mp.undo()
    m = eng.metrics([])
    assert (m["dispatch_retries"], m["dispatch_failures"]) == (1, 0)


# ------------------------------------------------------ the training path
@pytest.mark.parametrize("M,K,N,dtype", [
    (2048, 4096, 1024, "bfloat16"),       # wk at training M
    (2048, 14336, 4096, "bfloat16"),      # wd
    (14336, 2048, 4096, "bfloat16"),      # wd's dB
    (4096, 2048, 1000, "float32"),        # an fp32 dB, ragged N
    (3000, 520, 256, "bfloat16"),         # M chunks of uneven length
])
def test_matmul_splits_m_at_training_shapes(cuda, M, K, N, dtype):
    """Where the M tiles fill the grid the kernel splits M (no split-K
    workspace) and matches the plain version; a group of such products
    is bit-equal to its single calls."""
    from repro_torch.kernels import matmul as kmm
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    a = torch.randn((M, K), generator=g, device=cuda).to(dt)
    bs = [(torch.randn((K, n), generator=g, device=cuda) / K ** 0.5).to(dt)
          for n in (N, N // 2)]
    got = kmm.matmul(a, bs[0])
    assert _gemm_tol_ok(got, kmm.matmul_plain(a, bs[0]), dt)
    for c, b in zip(kmm.matmul_group(a, bs), bs):
        assert torch.equal(c, kmm.matmul(a, b))
    key = next(k for k in kmm._LAUNCHES if k[2] == M and k[3] == K
               and k[5] == (N,))
    assert kmm._LAUNCHES[key].bufs == (None, None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_backward_on_the_card_matches_plain_autograd(cuda, dtype):
    """The GEMM's autograd Functions on CUDA tensors launch the kernel
    for the forward and both gradient products, and match autograd
    through the plain version (single, trans_b, and a group)."""
    from repro_torch.kernels import matmul as kmm
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dt)
    M, K, Ns = 96, 256, (128, 64, 64)
    for trans_b in (False, True):
        a, b = rnd(M, K).requires_grad_(), (
            rnd(Ns[0], K) if trans_b else rnd(K, Ns[0])).requires_grad_()
        dc = rnd(M, Ns[0])
        n0, p0 = kmm.matmul.launches, kmm.matmul.plain_calls
        kmm.matmul(a, b, trans_b=trans_b).backward(dc)
        assert kmm.matmul.launches == n0 + 3
        assert kmm.matmul.plain_calls == p0
        a2, b2 = a.detach().requires_grad_(), b.detach().requires_grad_()
        kmm.matmul_plain(a2, b2, trans_b).backward(dc)
        assert _gemm_tol_ok(a.grad, a2.grad, dt)
        assert _gemm_tol_ok(b.grad, b2.grad, dt)
    a = rnd(M, K).requires_grad_()
    bs = [rnd(K, n).requires_grad_() for n in Ns]
    dcs = [rnd(M, n) for n in Ns]
    n0 = kmm.matmul.launches
    torch.autograd.backward(kmm.matmul_group(a, bs), dcs)
    assert kmm.matmul.launches == n0 + 1 + len(Ns) + 1
    a2 = a.detach().requires_grad_()
    b2 = [b.detach().requires_grad_() for b in bs]
    torch.autograd.backward([kmm.matmul_plain(a2, b) for b in b2], dcs)
    # dA sums three products: bf16 rounds each term before the sum
    tol = 1e-5 if dt == torch.float32 else 2e-2
    assert ((a.grad.float() - a2.grad.float()).abs().max()
            <= tol * a2.grad.float().abs().max())
    for b, w in zip(bs, b2):
        assert _gemm_tol_ok(b.grad, w.grad, dt)


def _smoke_train(device, params, tmp=None, steps=2, resume=False,
                 on_step=None, extra=()):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import train as tr
    cfg = smoke_config(get_config("llama3-8b")).replace(dtype=torch.float32)
    argv = ["--arch", "llama3-8b", "--smoke", "--steps", str(steps),
            "--batch", "2", "--seq", "16", "--log-every", "1", "--lr",
            "1e-4", "--warmup", str(steps), "--device", device]
    if tmp is not None:
        argv += ["--ckpt-dir", str(tmp), "--ckpt-every", "2"]
    if resume:
        argv += ["--resume"]
    argv += list(extra)
    return tr.train(cfg, tr.parse_args(argv), params=params,
                    on_step=on_step)


def _smoke_params(device):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm
    from repro_torch.models.module import tree_map
    cfg = smoke_config(get_config("llama3-8b")).replace(dtype=torch.float32)
    cpu = lm.init_params(cfg, seed=0, device="cpu", trainable=True)
    return cpu, lm.from_tree(cfg, tree_map(
        lambda _, t: t.detach().to(device, copy=True), lm.param_tree(cpu)),
        trainable=True)


def test_training_step_on_the_card_matches_the_cpu(cuda):
    """The float32 smoke model's first step: every leaf's gradient within
    1e-3 of its largest entry of the CPU's (the bf16 logits of
    ``lm.logits_fn`` move by one ulp where an fp32 sum in another order
    crosses a rounding boundary), and nonzero; the projections went
    through the kernel (launches rose, no plain call)."""
    from repro_torch.kernels import matmul as kmm
    cpu_p, card_p = _smoke_params(cuda)
    grads = {}

    def keep(step, params, metrics):
        grads[params.device.type] = {n: p.grad.detach().cpu().clone()
                                     for n, p in params.named_parameters()}
    want = _smoke_train("cpu", cpu_p, steps=1, on_step=keep)
    n0, p0 = kmm.matmul.launches, kmm.matmul.plain_calls
    got = _smoke_train("cuda", card_p, steps=1, on_step=keep)
    assert kmm.matmul.launches > n0 and kmm.matmul.plain_calls == p0
    np.testing.assert_allclose(got["log"][0]["loss"], want["log"][0]["loss"],
                               rtol=1e-5)
    for n, g in grads["cpu"].items():
        gc = grads["cuda"][n]
        assert gc.abs().max() > 0, n
        assert (gc - g).abs().max() <= 1e-3 * g.abs().max(), n


def test_training_resume_on_the_card_equals_the_uninterrupted_run(
        cuda, tmp_path):
    import shutil
    _, p1 = _smoke_params(cuda)
    _, p2 = _smoke_params(cuda)
    full = _smoke_train("cuda", p1, tmp_path / "a", steps=4)
    os_dir = tmp_path / "b"
    os_dir.mkdir()
    shutil.copytree(tmp_path / "a" / "step_00000002",
                    os_dir / "step_00000002")
    res = _smoke_train("cuda", p2, os_dir, steps=4, resume=True)
    assert res["start_step"] == 2
    np.testing.assert_allclose([m["loss"] for m in res["log"]],
                               [m["loss"] for m in full["log"][2:]],
                               rtol=1e-6)
    for (n, x), (_, y) in zip(res["params"].named_parameters(),
                              full["params"].named_parameters()):
        assert (x - y).abs().max() <= 1e-6 * y.abs().max(), n


# --------------------------------------------------- training over W ranks
@pytest.mark.parametrize("fn", ["ag", "rs"])
@pytest.mark.parametrize("mode", ["bsp", "ring_bidir"])
def test_train_sites_on_virtual_ranks_match_one_product(cuda, fn, mode):
    """The sequence-parallel AG+GEMM and the GEMM+RS over 4 virtual ranks
    of the card, forward and both gradients (autograd through every
    per-rank kernel launch), against one product and its gradients in
    plain fp32 on the card: float32 within 1e-4 of the largest |entry|
    (sums in another order)."""
    from repro_torch.core import collective_matmul as cm
    from repro_torch.kernels.matmul import matmul, matmul_plain
    W, B, S, K, N = 4, 2, 64, 256, 192
    g = torch.Generator(device=cuda).manual_seed(W + len(mode))
    a = torch.randn((B, S, K), generator=g, device=cuda)
    b = torch.randn((K, N), generator=g, device=cuda) / K ** 0.5
    dy = torch.randn((B, S, N), generator=g, device=cuda)
    want = matmul_plain(a.reshape(-1, K), b).reshape(B, S, N)
    want_da = matmul_plain(dy.reshape(-1, N), b, True).reshape(B, S, K)
    want_db = matmul_plain(a.reshape(-1, K).t().contiguous(),
                           dy.reshape(-1, N))
    dims = (1, 1, -1) if fn == "ag" else (-1, 0, 1)

    def shards(x, dim):
        n = x.shape[dim] // W
        return [x.narrow(dim, r * n, n).contiguous().requires_grad_()
                for r in range(W)]
    a_s, b_s = shards(a, dims[0]), shards(b, dims[1])
    body = cm.ag_gemm_m_sharded if fn == "ag" else cm.gemm_rs
    n0, p0 = matmul.launches, matmul.plain_calls
    out = body(a_s, b_s, mode=mode)
    torch.autograd.backward(out, [t.detach() for t in shards(dy, dims[2])])
    torch.cuda.synchronize()
    per_site = W if mode == "bsp" else 2 * W * W
    assert matmul.launches - n0 == 3 * per_site
    assert matmul.plain_calls == p0
    for got, w in ((torch.cat(out, dim=dims[2]), want),
                   (torch.cat([t.grad for t in a_s], dim=dims[0]), want_da),
                   (torch.cat([t.grad for t in b_s], dim=dims[1]), want_db)):
        assert (got - w).abs().max() <= 1e-4 * w.abs().max()


def test_training_step_at_tp4_on_the_card_matches_tp1(cuda):
    """The float32 smoke model's first step over 4 virtual ranks
    (``--fusion-mode ring``) against one rank on the card: the loss
    within 1e-5 relative, every leaf's gradient (blocks joined, the
    copies of a replicated leaf summed) within 1e-3 of its largest entry
    (the bf16 logits, as card vs CPU), through the kernel only."""
    from repro_torch.distributed.context import Mesh
    from repro_torch.kernels import matmul as kmm
    from repro_torch.models import lm
    _, p1 = _smoke_params(cuda)
    _, p4 = _smoke_params(cuda)
    grads = {}

    def keep(step, params, metrics):
        ranks = params if isinstance(params, list) else [params]
        dims = lm.shard_dims(ranks[0].cfg, Mesh(["cpu"] * len(ranks)))
        per = [dict(p.named_parameters()) for p in ranks]
        grads[len(ranks)] = {
            n: per[0][n].grad.detach().cpu() if d is None or len(ranks) == 1
            else torch.cat([q[n].grad.detach().cpu() for q in per], dim=d)
            for n, d in dims.items()}
    want = _smoke_train("cuda", p1, steps=1, on_step=keep)
    n0, q0 = kmm.matmul.launches, kmm.matmul.plain_calls
    got = _smoke_train("cuda", p4, steps=1, on_step=keep,
                       extra=["--tp", "4", "--fusion-mode", "ring"])
    assert kmm.matmul.launches > n0 and kmm.matmul.plain_calls == q0
    assert isinstance(got["params"], list) and len(got["params"]) == 4
    np.testing.assert_allclose(got["log"][0]["loss"], want["log"][0]["loss"],
                               rtol=1e-5)
    for n, g in grads[1].items():
        g4 = grads[4][n]
        assert g4.abs().max() > 0, n
        assert (g4 - g).abs().max() <= 1e-3 * g.abs().max(), n


# ------------------------------------------------------------------ MoE
@pytest.mark.parametrize("E,M,K,N", [
    (64, 1, 2048, 1024), (64, 8, 2048, 1024), (64, 16, 1024, 2048),
    (64, 320, 2048, 1024),          # olmoe's decode and training shapes
    (8, 2, 128, 256), (4, 20, 136, 1000),
    (3, 5, 100, 77)])               # rows not whole 16-byte words
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_batched_kernel_matches_plain(cuda, E, M, K, N, dtype):
    """The E expert products in ONE launch, within the GEMM's tolerance
    of the plain version; with autograd recording, dA and dB each one
    batched launch too, against autograd through the plain version."""
    from repro_torch.kernels import matmul as kmm
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(E * M + K + N)
    a = torch.randn((E, M, K), generator=g, device=cuda).to(dt)
    b = (torch.randn((E, K, N), generator=g, device=cuda) / K ** 0.5).to(dt)
    n0, q0 = kmm.matmul.launches, kmm.matmul.plain_calls
    got = kmm.matmul_batched(a, b)
    assert kmm.matmul.launches == n0 + 1 and kmm.matmul.plain_calls == q0
    assert _gemm_tol_ok(got, kmm.matmul_batched_plain(a, b), dt)
    if M * K * N > 2048 * 1024 * 16:
        return
    dc = torch.randn((E, M, N), generator=g, device=cuda).to(dt)
    ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
    kmm.matmul_batched(ta, tb).backward(dc)
    assert kmm.matmul.launches == n0 + 4
    assert _gemm_tol_ok(ta.grad, kmm.matmul_batched_plain(
        dc, b.transpose(1, 2).contiguous()), dt)
    assert _gemm_tol_ok(tb.grad, kmm.matmul_batched_plain(
        a.transpose(1, 2).contiguous(), dc), dt)


def _moe_smoke_cuda():
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm
    cfg = smoke_config(get_config("olmoe-1b-7b")).replace(
        n_layers=2, dtype=torch.float32)
    return cfg, lm.init_params(cfg, seed=0, device="cuda")


@pytest.mark.parametrize("tp", [1, 4])
def test_moe_megatick_replay_matches_eager_and_makes_no_host_sync(cuda, tp):
    """olmoe-smoke (float32) at K = 4: the graph engine against the eager
    loop in lockstep (tokens, ``cur_len``, tables, KV bytes identical),
    launches per step 6 a layer (wq/wk/wv, wo, the fp32 router, the
    three batched expert products; wo is the AG+GEMM over 4 ranks under
    ``pallas``) + 1; then every captured megatick replayed once more
    under ``torch.cuda.set_sync_debug_mode("error")``: the routing (sort,
    argsort, searchsorted, gathers) waits for nothing."""
    from repro_torch.distributed import context as dctx
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import Engine
    cfg, params = _moe_smoke_cuda()
    mesh = make_mesh(tp, device="cuda") if tp > 1 else None
    with dctx.use(dctx.DistContext(mesh, "pallas")):
        engs = [Engine(params, cfg, batch=3, max_len=64, prefill_chunk=4,
                       block_size=8, decode_steps=4, sampler="temperature",
                       device="cuda") for _ in range(2)]
    engs[1]._runner.use_graphs = False
    n0, q0 = matmul.launches, matmul.plain_calls
    done = _lockstep(engs, _MEGA_REQS)
    assert len(done) == len(_MEGA_REQS) and matmul.plain_calls == q0
    steps = 2 * engs[0].scan_steps + engs[0]._runner.warmup_steps
    per_step = (6 if tp == 1 else 5) * cfg.n_layers + 1
    assert matmul.launches - n0 == steps * per_step
    graphs = list(engs[0]._runner.graphs.values())
    assert graphs
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for graph, _, _ in graphs:
            graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_moe_decode_step_makes_no_host_sync(cuda):
    """One eager olmoe-smoke decode step under sync-debug "error"."""
    from repro_torch.models import lm
    cfg, params = _moe_smoke_cuda()
    with torch.inference_mode():
        st = lm.init_paged_decode_state(params, cfg, 4, 16, 8, 4)
        st["block_tables"].copy_(
            torch.arange(16, dtype=torch.int32).reshape(4, 4))
        tok = torch.ones((4, 1), dtype=torch.int64, device=cuda)
        act = torch.tensor([True, False, True, True], device=cuda)
        lm.decode_step(params, tok, st, cfg, active=act)   # plans launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            lg, _ = lm.decode_step(params, tok, st, cfg, active=act)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(lg).all())


# --------------------------------------------------- recurrent families
def _recurrent_smoke_cuda(arch):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm
    cfg = smoke_config(get_config(arch)).replace(dtype=torch.float32)
    params = lm.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():      # the zero inits that would hide a path
        for name, p in params.named_parameters():
            if name.rsplit(".", 1)[-1] in ("dt_bias", "conv_b", "w_lora_b"):
                p.copy_(0.3 * torch.randn(p.shape, generator=g,
                                          device="cuda"))
    return cfg, params


@pytest.mark.parametrize("arch,tp", [("zamba2-1.2b", 1), ("zamba2-1.2b", 4),
                                     ("rwkv6-3b", 1)])
def test_recurrent_megatick_replay_matches_eager_loop(cuda, arch, tp):
    """zamba2-smoke and rwkv6-smoke (float32) at K = 4, seeded
    temperature: the graph engine against the eager loop in lockstep,
    every recurrent-state byte (conv, ssm; x_prev_t, x_prev_c, S)
    identical after every tick besides tokens, ``cur_len``, tables and
    KV; the hybrid's shared attention on 4 virtual ranks under
    ``pallas``. GEMM launches per step: zamba2 2 a Mamba2 layer + 4 a
    shared-block call (3 over ranks, where ``wo`` is the AG+GEMM) + 1;
    rwkv 9 a block + 1."""
    from repro_torch.distributed import context as dctx
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import Engine
    cfg, params = _recurrent_smoke_cuda(arch)
    mesh = make_mesh(tp, device="cuda") if tp > 1 else None
    with dctx.use(dctx.DistContext(mesh, "pallas")):
        engs = [Engine(params, cfg, batch=3, max_len=64, prefill_chunk=4,
                       block_size=8, decode_steps=4, sampler="temperature",
                       device="cuda") for _ in range(2)]
    engs[1]._runner.use_graphs = False
    n0, q0 = matmul.launches, matmul.plain_calls
    done = _lockstep(engs, _MEGA_REQS)
    assert len(done) == len(_MEGA_REQS) and matmul.plain_calls == q0
    m = engs[0].metrics(done)
    assert m["graphs"] and m["graph_replays"] == m["dispatches"]
    assert m["mixed_dispatches"] > 0 and m["decode_dispatches"] > 0
    steps = 2 * engs[0].scan_steps + m["graph_warmup_steps"]
    if cfg.block == "rwkv":
        per_step = 9 * cfg.n_layers + 1
    else:
        groups = cfg.n_layers // cfg.attn_every
        per_step = 2 * cfg.n_layers + (4 if tp == 1 else 3) * groups + 1
    assert matmul.launches - n0 == steps * per_step

