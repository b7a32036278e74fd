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
