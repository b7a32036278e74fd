"""The launch plans of the port's redesigned kernels, on the CPU.

``kernels.flash_decode.decode_plan`` sizes the paged flash decode's
grid (units of (local rank, slot, KV head), split over the table walk)
and ``kernels.ag_gemm.ag_gemm_plan`` the fused AG+GEMM's persistent grid
(products x column strips x K chunks). The CUDA kernels walk exactly
these assignments; here every output is checked to be covered once and
every cooperative grid to fit the capacity it was given.
"""
import itertools

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import ag_gemm as kag  # noqa: E402
from repro_torch.kernels import flash_decode as kfd  # noqa: E402

H100_SMS = 132


@pytest.mark.parametrize("B,KVH,n_local,C", [
    (4, 8, 4, 4),          # tp=4 serve: 128 units, no split
    (8, 8, 1, 16),         # W=1 serve: split to fill the card
    (5, 2, 2, 6), (5, 1, 1, 6), (1, 1, 1, 1), (3, 2, 4, 40),
    (48, 8, 4, 4),         # more units than the card holds
    (2, 1, 1, 5000),       # a table longer than one split's list
    (7, 3, 8, 33),
])
@pytest.mark.parametrize("capacity", [None, 64, 528])
def test_decode_plan_covers_every_slot_head_once(B, KVH, n_local, C,
                                                 capacity):
    plan = kfd.decode_plan(B, KVH, n_local, C, H100_SMS, capacity)
    assert plan.n_split >= 1
    assert -(-C // plan.n_split) <= kfd.LIST_CAP
    if capacity is not None:
        assert 1 <= plan.grid <= capacity
    else:
        assert plan.grid == plan.items
    want_units = set(itertools.product(range(n_local), range(B),
                                       range(KVH)))
    items = [it for blk in range(plan.grid) for it in plan.items_of(blk)]
    assert len(items) == len(set(items)) == plan.items
    assert set(items) == {(*u, sp) for u in want_units
                          for sp in range(plan.n_split)}
    units = [u for blk in range(plan.grid) for u in plan.units_of(blk)]
    assert len(units) == len(set(units)) == len(want_units)
    assert set(units) == want_units


@pytest.mark.parametrize("c_lo,c_hi,n_split", [
    (0, 0, 1), (0, 1, 4), (0, 10, 4), (3, 40, 10), (7, 8, 16),
    (0, 512, 1), (5, 5000, 10)])
def test_splits_walk_every_reachable_entry_once(c_lo, c_hi, n_split):
    cols = [c for sp in range(n_split)
            for c in kfd.split_range(c_lo, c_hi, n_split, sp)]
    assert cols == list(range(c_lo, c_hi))


@pytest.mark.parametrize("g,D", [(1, 32), (4, 32), (4, 128), (8, 128),
                                 (3, 64), (32, 32)])
def test_decode_record_is_whole_16_byte_words(g, D):
    n = kfd.rec_floats(g, D)
    assert n % 4 == 0 and g * D + 2 * g <= n < g * D + 2 * g + 4


@pytest.mark.parametrize("M,N,k,W,itemsize", [
    (4, 4096, 1024, 4, 2),     # the tp=4 wo shape
    (8, 4096, 2048, 2, 2),
    (5, 77, 37, 2, 4), (20, 136, 48, 4, 4), (1, 1, 8, 2, 2),
    (3, 200, 64, 4, 2), (8, 14336, 1024, 4, 2), (33, 130, 7, 3, 4),
])
@pytest.mark.parametrize("n_prod", [1, 4])
@pytest.mark.parametrize("capacity", [4, 132, 264])
def test_ag_gemm_plan_covers_every_column_and_k_tile_once(
        M, N, k, W, itemsize, n_prod, capacity):
    plan = kag.ag_gemm_plan(M, N, k, W, itemsize, n_prod, capacity)
    assert 1 <= plan.grid <= capacity
    assert plan.bn * itemsize == 256
    # strips cover the columns once
    cols = [c for s in range(plan.n_strips)
            for c in range(s * plan.bn, min(N, (s + 1) * plan.bn))]
    assert cols == list(range(N))
    # chunks cover every source's K tiles once, none empty
    assert plan.tiles == W * -(-k // kag.BK)
    tiles = [t for kc in range(plan.n_kc) for t in plan.chunk_tiles(kc)]
    assert tiles == list(range(plan.tiles))
    assert all(len(plan.chunk_tiles(kc)) > 0 for kc in range(plan.n_kc))
    # the blocks take every (product, strip, chunk) once
    items = [it for blk in range(plan.grid) for it in plan.items_of(blk)]
    assert len(items) == len(set(items)) == plan.items
    assert set(items) == set(itertools.product(
        range(n_prod), range(plan.n_strips), range(plan.n_kc)))


@pytest.mark.parametrize("M,N,k,W", [(4, 4096, 1024, 4), (5, 77, 37, 2),
                                     (8, 512, 256, 4)])
def test_ag_gemm_chunking_does_not_depend_on_the_products(M, N, k, W):
    """Ranks that share one product and ranks with a product each sum
    the same K chunks: their outputs can be bit-identical."""
    plans = [kag.ag_gemm_plan(M, N, k, W, 2, n, 264) for n in (1, 2, 4)]
    assert len({(p.n_kc, p.tiles, p.n_strips) for p in plans}) == 1


@pytest.mark.parametrize("capacity", [132, 264, 528])
def test_ag_gemm_chunks_fill_the_card_at_the_wo_shape(capacity):
    """At the tp=4 wo shape one product's strips and chunks fill the
    blocks the card holds, within one strip's worth, or reach the
    shortest chunk allowed."""
    plan = kag.ag_gemm_plan(4, 4096, 1024, 4, 2, 1, capacity)
    assert plan.grid == plan.items <= capacity
    assert capacity - plan.items < plan.n_strips or \
        plan.n_kc == plan.tiles // kag.MIN_CHUNK_TILES
