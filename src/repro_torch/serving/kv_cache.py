"""Serving-side KV cache management: a paged, block-granular allocator
(port of ``repro.serving.kv_cache``).

KV memory is a shared pool of fixed-size blocks — ``(n_blocks,
block_size, KVH, hd)`` per layer — and every slot indexes it through a
per-slot **block table** carried in the decode state
(``lm.init_paged_decode_state``). A slot grows one block at a time.

Layout contract (shared with models.attention / core.flash_decode):
logical position ``p`` of slot ``b`` lives at pool block
``table[b, p // block_size]``, offset ``p % block_size``.

The host bookkeeping is the JAX package's, unchanged (numpy): refcounted
blocks, prefix caching under chained ``(parent_block, chunk_tokens)``
keys with an LRU of resident ref-0 blocks, copy-on-write of registered
or shared blocks, preemption/abort (register the written chunks, drop
every reference), sliding-window reclaim that leaves ``-1`` holes the
paged attention skips, the fault plane's block seizure, and the
snapshot/restore of all of it as JSON. The device half differs only in being in
place: ``sync()`` copies the host table into the state's table tensor
(one per device over a mesh), and copy-on-write clones a block inside
the existing pools (across ranks when the two blocks live on different
ones).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.distributed import context as dctx
from repro_torch.models import lm


def blocks_for(n_tokens: int, block_size: int) -> int:
    return -(-n_tokens // block_size)


def pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= max(n, 1), clamped to ``cap``: the
    bucketing rule for the paged gather width and the prefill chunk
    length. ``n <= 0`` -> 1; ``n > cap`` -> ``cap`` (a non-power-of-two
    cap is returned as is); monotone in ``n``; ``cap < 1`` raises."""
    if cap < 1:
        raise ValueError(
            f"pow2_bucket: cap must be >= 1, got {cap} — a width/length "
            f"bucket of zero can never be dispatched")
    w = 1
    while w < max(n, 1):
        w *= 2
    return min(w, cap)


# eq/repr off: the pool holds the parameters and the decode state
@dataclasses.dataclass(eq=False, repr=False)
class CachePool:
    """Paged block pool + slot table for continuous batching, on the
    parameters' device (``params``: an LM, or the per-rank list the
    engine decodes with).

    ``n_blocks`` defaults to contiguous parity (batch * max_len worth of
    blocks); size it smaller to serve mixed-length traffic — admission
    then gates on block availability, not slot count. Over the W ranks
    of the ambient mesh it is rounded up to a multiple of W, so that the
    pool shards evenly on the block dim (global block t on rank
    t // (n_blocks / W)).
    """
    params: object
    cfg: object
    batch: int
    max_len: int
    block_size: int = 16
    n_blocks: int | None = None

    def __repr__(self):
        return (f"CachePool(batch={self.batch}, max_len={self.max_len}, "
                f"block_size={self.block_size}, "
                f"blocks={self.blocks_in_use}/{self.n_blocks}, "
                f"active={self.n_active}/{self.batch})")

    def __post_init__(self):
        bs = self.block_size
        self.max_blocks = blocks_for(self.max_len, bs)
        if self.n_blocks is None:
            self.n_blocks = self.batch * self.max_blocks
        W = dctx.current().model_axis_size
        self.n_blocks += (-self.n_blocks) % W
        # the JAX pool's flags: rwkv has no KV cache (the block pool is
        # bookkeeping only there); prefix reuse seeds KV blocks only, and
        # recurrent state (mamba) cannot be rebuilt from them, so only
        # the attention families (attn_mlp, attn_moe) share prefixes
        self._needs_blocks = self.cfg.block != "rwkv"
        self._can_share = self.cfg.block in ("attn_mlp", "attn_moe")
        self.state = lm.init_paged_decode_state(
            self.params, self.cfg, self.batch, self.n_blocks, bs,
            self.max_blocks)
        # host mirrors: the scheduler reads/updates these synchronously;
        # the device cur_len advances inside the decode step and the
        # block table is copied in by sync() when dirty
        self.tables = np.full((self.batch, self.max_blocks), -1, np.int32)
        self.lengths = np.zeros(self.batch, np.int32)
        self.active = np.zeros(self.batch, bool)
        self.ref = np.zeros(self.n_blocks, np.int32)
        self._free = list(range(self.n_blocks - 1, -1, -1))  # pop -> low ids
        self._lru = OrderedDict()      # ref-0 registered blocks (evictable)
        self._key_of: dict[int, tuple] = {}   # block -> chain key
        self._index: dict[tuple, int] = {}    # chain key -> block
        self._children: dict[int, set] = {}   # block -> registered children
        self._dirty = True
        # sync()'s staging buffer, pinned on the card: the table goes up
        # with non_blocking=True and does not synchronize. Only sync()
        # writes it, and the engine runs sync() right before a dispatch
        # whose readback synchronizes the stream, so the previous copy
        # out of it has landed before it is written again
        self._stage = torch.zeros(
            self.tables.shape, dtype=torch.int32,
            pin_memory=lm.device_of(self.params).type == "cuda")
        self._stage_np = self._stage.numpy()
        # counters
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.cow_copies = 0
        self.evictions = 0
        self.admitted = 0
        self.blocks_hwm = 0
        self.preempted_slots = 0
        self.aborted_slots = 0
        self.blocks_reclaimed = 0
        self._seized: list[int] = []   # fault injection: held-back blocks
        self.blocks_seized = 0         # cumulative seize count

    # ----------------------------------------------------------- block layer
    def _pop_block(self) -> int | None:
        if self._free:
            return self._free.pop()
        if self._lru:                      # evict the LRU resident prefix
            b, _ = next(iter(self._lru.items()))
            self._evict(b)
            self.evictions += 1
            return self._free.pop() if self._free else None
        return None

    def _evict(self, b: int):
        """Unregister block b and cascade to registered descendants."""
        self._lru.pop(b, None)
        key = self._key_of.pop(b, None)
        if key is not None:
            self._index.pop(key, None)
            parent = key[0]
            if parent in self._children:
                self._children[parent].discard(b)
        for child in sorted(self._children.pop(b, ())):
            if self.ref[child] == 0:
                self._evict(child)
            else:                          # defensive: orphan but live
                ck = self._key_of.pop(child, None)
                if ck is not None:
                    self._index.pop(ck, None)
        if self.ref[b] == 0:
            self._free.append(b)

    def _deref(self, b: int):
        self.ref[b] -= 1
        assert self.ref[b] >= 0, f"block {b} refcount underflow"
        if self.ref[b] == 0:
            if b in self._key_of:
                self._lru[b] = True        # resident prefix, evict-on-demand
                self._lru.move_to_end(b)
            else:
                self._free.append(b)

    def _ref_inc(self, b: int):
        if self.ref[b] == 0:
            self._lru.pop(b, None)         # revive from the resident cache
        self.ref[b] += 1

    @property
    def blocks_in_use(self) -> int:
        return self.n_blocks - len(self._free) - len(self._lru)

    @property
    def max_blocks_in_use(self) -> int:
        """Highest table column holding an allocated block across all
        slots, plus one (0 when nothing is allocated)."""
        used = np.nonzero((self.tables >= 0).any(axis=0))[0]
        return int(used[-1]) + 1 if len(used) else 0

    def gather_width(self) -> int:
        """Table columns the decode step reads: the next power of two >=
        ``max_blocks_in_use``, clamped to [1, max_blocks]."""
        return pow2_bucket(self.max_blocks_in_use, self.max_blocks)

    @property
    def blocks_resident(self) -> int:
        return self.n_blocks - len(self._free)

    def block_occupancy(self) -> float:
        return self.blocks_in_use / self.n_blocks

    def admissible(self, prompt_len: int) -> bool:
        """Whether a prompt of this length can EVER be admitted: its
        prompt plus one generated token must fit the whole pool."""
        if not self._needs_blocks:
            return True
        return blocks_for(prompt_len + 1, self.block_size) <= self.n_blocks

    def hbm_fraction_vs_contiguous(self) -> float:
        return ((self.n_blocks * self.block_size)
                / float(self.batch * self.max_len))

    # ---------------------------------------------------------- prefix cache
    def _match_prefix(self, prompt) -> tuple[list[int], int]:
        """Longest chain of registered full-chunk blocks matching the
        prompt; reuse is capped at len(prompt)-1."""
        if not self._can_share or not prompt:
            return [], 0
        bs = self.block_size
        blocks, parent = [], -1
        for c in range(len(prompt) // bs):
            b = self._index.get((parent, tuple(prompt[c * bs:(c + 1) * bs])))
            if b is None:
                break
            blocks.append(b)
            parent = b
        reuse = min(len(blocks) * bs, len(prompt) - 1)
        return blocks, reuse

    def register_prompt_chunks(self, slot: int, prompt):
        """Register the slot's fully-written full-prompt chunks as
        shareable prefix blocks (idempotent)."""
        if not self._can_share:
            return
        bs = self.block_size
        n_full = min(int(self.lengths[slot]), len(prompt)) // bs
        parent = -1
        for c in range(n_full):
            b = int(self.tables[slot, c])
            if b < 0:
                break    # window-reclaim hole: the chain is unreachable
            if b in self._key_of:
                parent = b
                continue
            key = (parent, tuple(prompt[c * bs:(c + 1) * bs]))
            cur = self._index.get(key)
            if cur is None:
                self._index[key] = b
                self._key_of[b] = key
                if parent >= 0:
                    self._children.setdefault(parent, set()).add(b)
                cur = b
            parent = cur

    # ------------------------------------------------------------- slot layer
    def alloc(self, prompt=None) -> tuple[int, int] | None:
        """Claim a free slot, seeding its block table from the prefix
        cache. Returns (slot, reused_tokens), or None when no slot is
        free OR the pool cannot cover the prompt + first generated
        token."""
        free_slots = np.nonzero(~self.active)[0]
        if len(free_slots) == 0:
            return None
        slot = int(free_slots[0])
        prompt = list(prompt) if prompt is not None else []
        blocks, reuse = self._match_prefix(prompt)
        bs = self.block_size
        cow = 1 if (blocks and reuse < len(blocks) * bs) else 0
        if self._needs_blocks:
            total = blocks_for(len(prompt) + 1, bs)
            need = total - len(blocks) + cow
            avail = (len(self._free) + len(self._lru)
                     - sum(1 for b in blocks if b in self._lru))
            if need > avail:
                return None
        for b in blocks:
            self._ref_inc(b)
        self.tables[slot, :len(blocks)] = blocks
        self.tables[slot, len(blocks):] = -1
        self.active[slot] = True
        self.lengths[slot] = reuse
        lm.reset_slot_paged(self.state, self.cfg, slot)
        if reuse:
            lm.set_slot_len(self.state, slot, reuse)
            self.prefix_hits += 1
            self.prefix_hit_tokens += reuse
        if cow:
            copied = self._cow(slot, len(blocks) - 1)
            assert copied is not None, \
                "COW block was reserved by admission accounting"
        self.admitted += 1
        self._dirty = True
        self.blocks_hwm = max(self.blocks_hwm, self.blocks_in_use)
        return slot, reuse

    def _cow(self, slot: int, chunk: int) -> int | None:
        """Clone the shared/immutable block at ``chunk`` into a private
        copy before the slot writes into it."""
        old = int(self.tables[slot, chunk])
        new = self._pop_block()
        if new is None:
            return None
        lm.copy_cache_block(self.state, self.cfg, old, new)
        self.ref[new] = 1
        self.tables[slot, chunk] = new
        self._deref(old)
        self.cow_copies += 1
        self._dirty = True
        return new

    def writable(self, slot: int, n: int) -> int:
        """Make the blocks covering the next ``n`` positions of ``slot``
        writable (allocate at chunk boundaries, copy-on-write shared
        blocks). Returns how many of the ``n`` can be written now."""
        if not self._needs_blocks:
            return n
        bs = self.block_size
        start = int(self.lengths[slot])
        ok = 0
        for p in range(start, start + n):
            c = p // bs
            if c >= self.max_blocks:
                break
            b = int(self.tables[slot, c])
            if b < 0:
                nb = self._pop_block()
                if nb is None:
                    break
                self.ref[nb] = 1
                self.tables[slot, c] = nb
                self._dirty = True
            elif self.ref[b] > 1 or b in self._key_of:
                if self._cow(slot, c) is None:
                    break
            ok += 1
        self.blocks_hwm = max(self.blocks_hwm, self.blocks_in_use)
        return ok

    def reserve(self, slot: int, k: int) -> int:
        """Pre-allocate the blocks covering the slot's next ``k`` write
        positions (same mechanics as :meth:`writable`)."""
        return self.writable(slot, k)

    def free(self, slot: int):
        """Release the slot; chunks deref in reverse so registered blocks
        enter the LRU deepest-first."""
        for c in reversed(range(self.max_blocks)):
            b = int(self.tables[slot, c])
            if b < 0:
                continue
            self._deref(b)
        self.tables[slot] = -1
        self.active[slot] = False
        self.lengths[slot] = 0
        self._dirty = True

    def _release_slot(self, slot: int, tokens=None):
        if tokens is not None:
            self.register_prompt_chunks(slot, tokens)
        self.free(slot)
        lm.release_slot_paged(self.state, slot)

    def preempt(self, slot: int, tokens=None):
        """Evict the slot so its blocks can back other requests; its
        fully-written chunks are registered first (resume = prefix hit)."""
        self._release_slot(slot, tokens)
        self.preempted_slots += 1

    def abort(self, slot: int, tokens=None) -> int:
        """Cancellation: drop the slot mid-stream. Returns the number of
        blocks the abort made re-allocatable."""
        before = self.blocks_in_use
        self._release_slot(slot, tokens)
        self.aborted_slots += 1
        return before - self.blocks_in_use

    def reclaim_out_of_window(self, slot: int, window: int) -> int:
        """Free the slot's blocks whose positions all rolled out of the
        attention window for good, leaving ``-1`` holes."""
        if not self._needs_blocks:
            return 0
        dead_chunks = (int(self.lengths[slot]) - window) // self.block_size
        freed = 0
        for c in range(min(dead_chunks, self.max_blocks)):
            b = int(self.tables[slot, c])
            if b < 0:
                continue
            self._deref(b)
            self.tables[slot, c] = -1
            freed += 1
        if freed:
            self.blocks_reclaimed += freed
            self._dirty = True
        return freed

    # ---------------------------------------------------- fault injection
    def seize_blocks(self, n: int) -> int:
        """Fault injection: pull up to ``n`` blocks out of the FREE list
        so they back nothing until :meth:`release_seized` (a
        deterministic pool-exhaustion spike; residents and referenced
        blocks are never seized). Returns how many were taken."""
        taken = []
        while self._free and len(taken) < n:
            taken.append(self._free.pop())
        self._seized.extend(taken)
        self.blocks_seized += len(taken)
        return len(taken)

    def release_seized(self) -> int:
        """Return every seized block to the free list (spike over)."""
        n = len(self._seized)
        self._free.extend(reversed(self._seized))
        self._seized = []
        return n

    # ------------------------------------------------- snapshot / restore
    def snapshot_meta(self) -> dict:
        """The JSON-able host bookkeeping (the device state travels
        through the checkpointer): tables, lengths, refcounts, the
        free-list order, the LRU order and the prefix-chain registry
        (``_index``/``_children`` derive from ``_key_of``)."""
        return {
            "geometry": {"batch": self.batch, "max_len": self.max_len,
                         "block_size": self.block_size,
                         "n_blocks": self.n_blocks},
            "tables": self.tables.tolist(),
            "lengths": self.lengths.tolist(),
            "active": self.active.tolist(),
            "ref": self.ref.tolist(),
            "free": list(self._free),
            "lru": list(self._lru.keys()),
            "key_of": [[b, key[0], list(key[1])]
                       for b, key in self._key_of.items()],
        }

    def check_geometry(self, g: dict):
        """Raise unless :meth:`snapshot_meta`'s ``geometry`` is this
        pool's (block ids are geometry-relative)."""
        mine = {"batch": self.batch, "max_len": self.max_len,
                "block_size": self.block_size, "n_blocks": self.n_blocks}
        if g != mine:
            raise ValueError(
                f"pool geometry mismatch: snapshot {g} vs engine {mine}")

    def restore_meta(self, meta: dict):
        """Rebuild the host bookkeeping from :meth:`snapshot_meta`. The
        geometry must match; the device table follows at the next
        :meth:`sync`."""
        self.check_geometry(meta["geometry"])
        self.tables = np.asarray(meta["tables"], np.int32)
        self.lengths = np.asarray(meta["lengths"], np.int32)
        self.active = np.asarray(meta["active"], bool)
        self.ref = np.asarray(meta["ref"], np.int32)
        self._free = [int(b) for b in meta["free"]]
        self._lru = OrderedDict((int(b), True) for b in meta["lru"])
        self._seized = []
        self._key_of = {int(b): (int(parent), tuple(toks))
                        for b, parent, toks in meta["key_of"]}
        self._index = {key: b for b, key in self._key_of.items()}
        self._children = {}
        for b, (parent, _) in self._key_of.items():
            if parent >= 0:
                self._children.setdefault(parent, set()).add(b)
        self._dirty = True

    def advance(self, slot: int, n: int):
        """Record that `slot` consumed n tokens this tick (host mirror;
        the device cur_len advanced inside the decode step)."""
        self.lengths[slot] += n

    def sync(self):
        """Copy the host block table into the state's table tensors (one
        per rank), in place (no-op when unchanged), through the pinned
        staging buffer with ``non_blocking=True``: no synchronize."""
        if self._dirty:
            self._stage_np[...] = self.tables
            tables = self.state["block_tables"]
            for t in tables if isinstance(tables, list) else [tables]:
                t.copy_(self._stage, non_blocking=True)
            self._dirty = False

    # --------------------------------------------------------------- metrics
    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def n_free(self) -> int:
        return self.batch - self.n_active

    def occupancy(self) -> float:
        return self.n_active / self.batch

    def metrics(self) -> dict:
        return {
            "kv_blocks": self.n_blocks,
            "kv_blocks_in_use": self.blocks_in_use,
            "kv_blocks_resident": self.blocks_resident,
            "kv_block_occupancy": round(self.block_occupancy(), 4),
            "kv_blocks_hwm": self.blocks_hwm,
            "kv_max_blocks_in_use": self.max_blocks_in_use,
            "kv_gather_width": self.gather_width(),
            "kv_hbm_vs_contiguous": round(self.hbm_fraction_vs_contiguous(),
                                          4),
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hit_rate": round(self.prefix_hits
                                     / max(self.admitted, 1), 4),
            "cow_copies": self.cow_copies,
            "block_evictions": self.evictions,
            "kv_blocks_reclaimed": self.blocks_reclaimed,
            "kv_slots_aborted": self.aborted_slots,
            "kv_blocks_seized": self.blocks_seized,
        }
