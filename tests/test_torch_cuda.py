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


@pytest.mark.parametrize("D,H,KVH", [(32, 4, 1), (64, 8, 2), (128, 32, 8)])
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


def _ag_gemm_case(devices, M, k, N, dt, seed):
    from repro_torch.kernels.ag_gemm import ag_gemm_fused, ag_gemm_plain
    W = len(devices)
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((M, W * k), generator=g).to(dt)
    b = (torch.randn((W * k, N), generator=g) / (W * k) ** 0.5).to(dt)
    shards = [a[:, r * k:(r + 1) * k].contiguous().to(d)
              for r, d in enumerate(devices)]
    bs = [b.to(d) for d in devices]
    n0 = ag_gemm_fused.launches
    got = ag_gemm_fused(shards, bs, _mesh(devices))
    want = ag_gemm_plain([s.cpu() for s in shards], [b])[0]
    torch.cuda.synchronize()
    assert ag_gemm_fused.launches == n0 + len(set(devices))
    for o in got:
        assert _gemm_ok(o.cpu(), want, dt)


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("M,k,N", [(8, 1024, 4096), (5, 37, 77),
                                   (20, 48, 136), (1, 8, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ag_gemm_kernel_matches_plain_on_virtual_ranks(cuda, W, M, k, N,
                                                       dtype):
    for epoch in range(3):            # flag reuse, both inbox parities
        _ag_gemm_case(["cuda:0"] * W, M, k, N, getattr(torch, dtype),
                      epoch + M * k)


def _paged_case(devices, dt, window, seed, B=5, H=8, KVH=2, D=64, bs=8,
                n_blocks=32, C=6):
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
    torch.cuda.synchronize()
    tol = 1e-5 if dt == torch.float32 else 2e-2
    for o in got:
        assert torch.equal(o.cpu(), got[0].cpu())
        assert (o.float().cpu() - want.float()).abs().max() <= tol


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 20])
def test_strided_fused_kernel_matches_plain_on_virtual_ranks(cuda, W, dtype,
                                                             window):
    for epoch in range(3):
        _strided_case(["cuda:0"] * W, getattr(torch, dtype), window, epoch)


def test_fused_kernels_share_one_communicator_call_after_call(cuda):
    """The three fused kernels take turns on one mesh (one epoch
    counter, one set of flags and inboxes, grown on demand)."""
    for seed in range(4):
        _ag_gemm_case(["cuda:0"] * 4, 8, 256, 512, torch.bfloat16, seed)
        _paged_case(["cuda:0"] * 4, torch.float32, None, seed)
        _strided_case(["cuda:0"] * 4, torch.bfloat16, 20, seed)


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
from repro_torch.kernels import symm
from repro_torch.kernels.ag_gemm import _lib
W, M, k, N = 2, 4, 64, 64
mesh = Mesh(["cuda:0"] * W)
a = torch.randn(M, k, device="cuda")
b = torch.randn(W * k, N, device="cuda")
c = torch.empty(M, N, device="cuda")
call = symm.communicator(mesh).call(M * k * 4, 4)
t0 = time.time()
# launch rank 0 alone: rank 1 never pushes its shard
rc = _lib()(symm.ptrs([a]), symm.ptrs([b]), symm.ptrs([c]), symm.ints([0]),
            1, M, N, k, 0, *call.args(0),
            torch.cuda.current_stream().cuda_stream)
assert rc == 0, rc
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
