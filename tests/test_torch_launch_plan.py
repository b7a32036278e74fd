"""The launch plans of the port's redesigned kernels, on the CPU.

``kernels.flash_decode.decode_plan`` sizes the paged flash decode's
grid (units of (local rank, slot, KV head), split over the table walk)
and ``kernels.ag_gemm.ag_gemm_plan`` the fused AG+GEMM's persistent grid
(products x column strips x K chunks). The CUDA kernels walk exactly
these assignments; here every output is checked to be covered once and
every cooperative grid to fit the capacity it was given. ``kernels.
matmul.gemm_plan`` chunks the GEMM's strips. Where the walk itself is
device code (the GEMM's item order, the strided decode's tile range),
:func:`group_items` and :func:`strided_tiles` below mirror it: they
check the plans against that arithmetic, and only the card checks
(``tests/test_torch_cuda.py``, ``chip_smoke.py``) hold the kernels to
it.
"""
import itertools

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import ag_gemm as kag  # noqa: E402
from repro_torch.kernels import flash_decode as kfd  # noqa: E402
from repro_torch.kernels import matmul as kmm  # noqa: E402

H100_SMS = 132


def launch_items(plans, with_m: bool = False) -> list[tuple]:
    """(product, strip, K chunk) -- with ``with_m``, (product, strip, M
    chunk, K chunk) -- of a ``gemm_stream`` launch's items in item order:
    the products' items in product order, K chunk fastest, then the M
    chunk (mirrors ``item_at`` of ``csrc/matmul.cu``)."""
    return [(p, s, mc, kc) if with_m else (p, s, kc)
            for p, pl in enumerate(plans) for s in range(pl.n_strips)
            for mc in range(pl.n_mc) for kc in range(pl.n_kc)]


def group_items(plans, grid: int, block: int,
                with_m: bool = False) -> list[tuple]:
    """The items ``block`` of a ``grid``-block launch computes: block i
    takes items i, i + grid, ... (mirrors the item loops of
    ``csrc/matmul.cu``)."""
    return launch_items(plans, with_m)[block::grid]


def strided_tiles(cl: int, rank: int, W: int, S_loc: int,
                  window: int | None = None) -> tuple[int, int]:
    """The tiles ``[c_lo, c_hi)`` of ``kfd.TILE`` local rows of one
    slot's strided shard that hold a position ``cl - window <= j * W +
    rank < cl`` (mirrors ``StridedWalk`` of ``csrc/flash_decode.cu``,
    which then splits them as ``kfd.split_range`` does)."""
    j_hi = min(S_loc, -(-(cl - rank) // W)) if cl > rank else 0
    j_lo = 0
    if window is not None and cl - window > rank:
        j_lo = min(-(-(cl - window - rank) // W), j_hi)
    return j_lo // kfd.TILE, -(-j_hi // kfd.TILE)


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


# ------------------------------------------------------------ the GEMM
_LLAMA_DECODE = [(4096, 4096, False), (4096, 1024, False),
                 (4096, 14336, False), (14336, 4096, False),
                 (4096, 128256, True)]                  # (K, N, trans_b)


@pytest.mark.parametrize("K,N,trans_b", _LLAMA_DECODE + [
    (136, 1000, False), (100, 77, True), (8, 8, False), (64, 1, True),
    (14336, 77, False), (4104, 130, True)])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("capacity", [132, 264, 3])
def test_gemm_plan_covers_every_column_strip_and_k_tile_once(
        K, N, trans_b, itemsize, capacity):
    path = kmm.TRANS if trans_b else None
    plan = kmm.gemm_plan(8, N, K, itemsize, capacity, path)
    # a stage is 16 KB of B: K rows of a strip of whole 256 bytes, or a
    # strip of table rows x 256 K elements
    assert plan.bn * plan.kt * itemsize == kmm.TILE_BYTES
    assert plan.kt == 256 if trans_b else (plan.bn * itemsize) % 256 == 0
    cols = [c for s in range(plan.n_strips)
            for c in range(s * plan.bn, min(N, (s + 1) * plan.bn))]
    assert cols == list(range(N))
    assert plan.tiles == -(-K // plan.kt)
    tiles = [t for kc in range(plan.n_kc) for t in plan.chunk_tiles(kc)]
    assert tiles == list(range(plan.tiles))
    assert all(len(plan.chunk_tiles(kc)) >= min(plan.tiles,
                                                kmm.MIN_CHUNK_TILES)
               for kc in range(plan.n_kc))
    grid = min(plan.items, capacity)
    items = [it for blk in range(grid)
             for it in group_items([plan], grid, blk)]
    assert len(items) == len(set(items)) == plan.items
    assert set(items) == set(itertools.product(
        [0], range(plan.n_strips), range(plan.n_kc)))


@pytest.mark.parametrize("group", [
    [(4096, 4096), (4096, 1024), (4096, 1024)],        # wq, wk, wv
    [(4096, 14336), (4096, 14336)],                    # wg, wu
    [(136, 1000), (136, 64), (136, 8)]])
@pytest.mark.parametrize("capacity", [132, 264])
def test_gemm_chunking_does_not_depend_on_the_group(group, capacity):
    """A product launched in a group sums the same K chunks of the same
    strips as the product launched alone: its output is bit-equal."""
    plans = [kmm.gemm_plan(8, N, K, 2, capacity) for K, N in group]
    grid = min(sum(p.items for p in plans), capacity)
    items = [it for blk in range(grid)
             for it in group_items(plans, grid, blk)]
    assert len(items) == len(set(items)) == sum(p.items for p in plans)
    for p, (K, N) in enumerate(group):
        alone = kmm.gemm_plan(8, N, K, 2, capacity)
        assert alone == plans[p]
        mine = {(s, tuple(alone.chunk_tiles(kc)))
                for q, s, kc in items if q == p}
        want = {(s, tuple(alone.chunk_tiles(kc)))
                for s in range(alone.n_strips) for kc in range(alone.n_kc)}
        assert mine == want


@pytest.mark.parametrize("capacity", [132, 264, 396])
def test_gemm_plan_fills_the_card_at_the_wk_shape(capacity):
    """wk/wv (4096 x 1024 bf16) is 8 strips of 256 bytes: its K is split
    into chunks, and launched with wq as one group (one launch) its items
    give every SM of the card work. Alone it takes fewer blocks than the
    card holds: each chunk costs a partial and its strip a fold, and the
    plan stops splitting within SPAN_SLACK of the shortest span."""
    wq = kmm.gemm_plan(8, 4096, 4096, 2, capacity)
    wk = kmm.gemm_plan(8, 1024, 4096, 2, capacity)
    assert wk.n_strips == 8 and wk.n_kc > 1
    assert all(len(wk.chunk_tiles(kc)) >= kmm.MIN_CHUNK_TILES
               for kc in range(wk.n_kc))
    assert min(wq.items + 2 * wk.items, capacity) >= H100_SMS


# ------------------------------------- the contiguous (strided) decode
@pytest.mark.parametrize("W,S_loc", [(1, 256), (4, 64), (4, 150), (2, 7),
                                     (3, 33), (1, 600)])
@pytest.mark.parametrize("window", [None, 20, 100])
@pytest.mark.parametrize("capacity", [None, 64])
def test_decode_plan_over_a_strided_shard(W, S_loc, window, capacity):
    """Units of (rank, slot, KV head) once each; within a unit, the
    splits walk every local tile that holds a position the slot attends
    exactly once, and no other tile (S_loc need not be whole tiles)."""
    B, KVH = 5, 2
    C = -(-S_loc // kfd.TILE)
    plan = kfd.decode_plan(B, KVH, W, C, H100_SMS, capacity)
    want_units = set(itertools.product(range(W), range(B), range(KVH)))
    units = [u for blk in range(plan.grid) for u in plan.units_of(blk)]
    assert len(units) == len(set(units)) and set(units) == want_units
    for cl in (0, 1, W, W + 1, 37, S_loc * W - 1, S_loc * W):
        for rank in range(W):
            c_lo, c_hi = strided_tiles(cl, rank, W, S_loc, window)
            walked = [c for sp in range(plan.n_split)
                      for c in kfd.split_range(c_lo, c_hi, plan.n_split, sp)]
            attended = {j // kfd.TILE for j in range(S_loc)
                        if j * W + rank < cl and (
                            window is None or j * W + rank >= cl - window)}
            assert len(walked) == len(set(walked))
            assert all(0 <= c < C for c in walked)
            if attended:
                assert set(walked) == attended
            else:       # a window narrower than W may leave a rank one
                assert len(walked) <= 1     # tile of masked rows


# ------------------------------------------ the GEMM at training shapes
_LLAMA_TRAIN = [   # (M, K, N, itemsize, trans_b) of one training step
    (2048, 4096, 4096, 2, False), (2048, 4096, 1024, 2, False),
    (2048, 4096, 14336, 2, False), (2048, 14336, 4096, 2, False),
    (2048, 4096, 128256, 4, True),                       # fp32 unembed
    (4096, 2048, 4096, 2, False), (4096, 2048, 14336, 2, False),  # dB
    (14336, 2048, 4096, 2, False),
    (2048, 128256, 4096, 4, False), (128256, 2048, 4096, 4, False)]


@pytest.mark.parametrize("M,K,N,itemsize,trans_b", _LLAMA_TRAIN)
@pytest.mark.parametrize("capacity", [132, 264])
def test_gemm_plan_splits_m_not_k_at_training_shapes(M, K, N, itemsize,
                                                     trans_b, capacity):
    """Where the strips' M tiles alone fill the grid, the plan splits M
    and never K: every (strip, M tile, K tile) is computed by exactly one
    item, and the launch holds no split-K workspace (at M = 2048 a K
    split of wd would have held ~268 MB for the life of the process)."""
    path = kmm.TRANS if trans_b else None
    plan = kmm.gemm_plan(M, N, K, itemsize, capacity, path)
    assert plan.n_kc == 1 and plan.n_mc >= 1
    assert plan.n_strips * plan.m_tiles >= capacity
    assert plan.work_floats == 0
    assert plan.mt == (16 if itemsize == 2 and not trans_b else 8)
    m_tiles = [t for mc in range(plan.n_mc) for t in plan.m_chunk(mc)]
    assert m_tiles == list(range(plan.m_tiles))
    assert all(len(plan.m_chunk(mc)) > 0 for mc in range(plan.n_mc))
    # the M chunks fill the card within one chunk of every strip
    assert plan.items >= capacity - plan.n_strips
    grid = min(plan.items, capacity)
    flat = launch_items([plan], with_m=True)
    items = [it for blk in range(grid) for it in flat[blk::grid]]
    assert len(items) == len(set(items)) == plan.items
    assert set(items) == set(itertools.product(
        [0], range(plan.n_strips), range(plan.n_mc), [0]))
    # the fewest M chunks that finish soonest: one fewer takes longer
    def span(n):
        return -(-plan.n_strips * n // capacity) * -(-plan.m_tiles // n)
    assert all(span(n) > span(plan.n_mc) for n in range(1, plan.n_mc))


@pytest.mark.parametrize("capacity", [132, 264])
def test_gemm_workspace_stays_at_decode_shapes(capacity):
    """At the decode shapes (M = batch) the plan is the K split it was:
    the workspace is the split strips' fp32 partials, a few MB."""
    for M in (1, 8, 16):
        plans = [kmm.gemm_plan(M, N, K, 2, capacity) for K, N in
                 ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))]
        assert all(p.n_mc == 1 for p in plans)
        assert any(p.n_kc > 1 for p in plans)
        held = 4 * sum(p.work_floats for p in plans)      # bytes
        assert held == sum(4 * p.n_strips * p.n_kc * M * p.bn
                           for p in plans if p.n_kc > 1) < 16 * 2 ** 20


def test_gemm_group_at_training_shapes_keeps_each_products_plan():
    """wq/wk/wv at M = 2048 in one launch: each product's M chunks are
    its plan alone, so its output is bit-equal to the single call."""
    plans = [kmm.gemm_plan(2048, N, 4096, 2, 264) for N in (4096, 1024,
                                                            1024)]
    grid = min(sum(p.items for p in plans), 264)
    flat = launch_items(plans, with_m=True)
    items = [it for blk in range(grid) for it in flat[blk::grid]]
    assert len(items) == len(set(items)) == sum(p.items for p in plans)
    for p, plan in enumerate(plans):
        assert {it[1:] for it in items if it[0] == p} == set(
            itertools.product(range(plan.n_strips), range(plan.n_mc), [0]))
