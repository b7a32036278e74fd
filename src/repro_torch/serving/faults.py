"""Deterministic, seeded fault-injection plane for the serving stack
(the port's copy of ``repro.serving.faults``, which imports no JAX; the
port keeps its own so that it never imports the JAX package).

The paper's fine-grained pipelines remove the BSP safety net: once the
global barrier is gone there is no clean step boundary where a failed
dispatch, a poisoned slot, or a hung tick gets caught for free.  This
module makes those failures *injectable, deterministic, and
replayable* so recovery paths can be tested against a token-identical
reference.

A :class:`FaultPlan` is a set of :class:`FaultSpec` injection points
keyed by ``(tick, site)``.  Sites:

``dispatch``
    The megatick dispatch raises
    :class:`TransientDispatchError` for ``count`` consecutive
    attempts.  The engine's bounded retry-with-backoff absorbs up to
    ``DISPATCH_ATTEMPTS - 1`` of them; more exhausts the retry budget
    and surfaces :class:`DispatchFailedError`.
``tokens``
    The sampled token ids read back for one slot are overwritten with
    an out-of-range id — the host-visible signature of NaN/Inf logits
    (a NaN argmax/categorical is garbage).  The engine's token guard
    retires exactly that slot with ``finish_reason="error"``;
    survivors stay token-identical.
``pool``
    ``blocks`` free KV blocks are seized from the pool for
    ``hold_ticks`` ticks — an exhaustion spike.  Admission stalls and
    the existing preemption path engages; both are token-identical by
    construction.
``slow``
    The tick sleeps ``delay_s`` before dispatching, feeding the
    megatick wall-clock watchdog (a straggler, not an error).
``socket``
    The server force-closes one live SSE connection at the next flush
    (a client-visible drop; engine-side it is just a hangup cancel).

Every spec fires at most once (``dispatch`` specs fail ``count``
attempts within their one firing), and the plan records what actually
fired, so a chaos run is replayable bit-for-bit from
``(seed, n_ticks)`` or from the JSON round-trip.
"""
from __future__ import annotations

import dataclasses
import json
import random

SITES = ("dispatch", "tokens", "pool", "slow", "socket")

# Total dispatch attempts per tick = 1 fault-free try + bounded
# retries: a static trip count, so the worst-case dispatches per tick
# stay bounded.
DISPATCH_ATTEMPTS = 3


class TransientDispatchError(RuntimeError):
    """A dispatch failed in a way worth retrying (injected or real)."""


class DispatchFailedError(RuntimeError):
    """The bounded retry budget is exhausted; the tick fails loudly."""


def backoff_s(attempt: int, base_s: float = 0.05, cap_s: float = 2.0,
              rng: random.Random | None = None) -> float:
    """Deterministic exponential backoff, optionally full-jittered.

    Without ``rng`` the schedule is the pure exponential
    ``min(cap, base * 2**(attempt-1))`` — what the engine uses, so a
    chaos run's timing is replayable.  With a seeded ``rng`` it is
    AWS-style full jitter ``uniform(0, min(cap, base * 2**(attempt-1)))``
    — what the client uses, so a thundering herd of retries decorrelates
    while any single schedule stays reproducible from its seed.
    ``attempt`` is 1-based: the delay *before* retry #attempt.
    """
    if attempt < 1:
        return 0.0
    ceiling = min(cap_s, base_s * (2.0 ** (attempt - 1)))
    if rng is None:
        return ceiling
    return rng.uniform(0.0, ceiling)


@dataclasses.dataclass
class FaultSpec:
    """One injection point.  ``site`` selects the mechanism; the rest
    are per-site parameters (unused ones are ignored)."""
    site: str
    tick: int
    slot: int = 0          # tokens: victim slot
    count: int = 1         # dispatch: consecutive failing attempts
    blocks: int = 0        # pool: free blocks to seize
    hold_ticks: int = 1    # pool: ticks before the seized blocks return
    delay_s: float = 0.0   # slow: added wall-clock per tick
    rid: int | None = None  # socket: victim request (None = oldest live)
    _armed: int = dataclasses.field(default=0, repr=False, compare=False)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}")
        self._armed = self.count if self.site == "dispatch" else 1

    def trip(self):
        """dispatch site: raise while armed attempts remain."""
        if self._armed > 0:
            self._armed -= 1
            raise TransientDispatchError(
                f"injected dispatch fault @tick={self.tick} "
                f"({self._armed} more armed)")

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("_armed")
        return d


class FaultPlan:
    """A replayable set of injection points keyed by ``(tick, site)``.

    ``poll(site, tick)`` returns the spec for that key exactly once
    (and records it in ``fired``); later polls of the same key return
    None.  One spec per key — colliding specs raise at construction so
    a plan is unambiguous.
    """

    def __init__(self, faults: list[FaultSpec] | None = None):
        self.faults: list[FaultSpec] = list(faults or [])
        self._by_key: dict[tuple[int, str], FaultSpec] = {}
        for f in self.faults:
            key = (f.tick, f.site)
            if key in self._by_key:
                raise ValueError(f"duplicate fault for {key}")
            self._by_key[key] = f
        self.fired: list[tuple[int, str]] = []

    def __len__(self) -> int:
        return len(self.faults)

    @property
    def injected(self) -> int:
        return len(self.fired)

    def poll(self, site: str, tick: int) -> FaultSpec | None:
        spec = self._by_key.get((tick, site))
        if spec is None or (tick, site) in self.fired:
            return None
        self.fired.append((tick, site))
        return spec

    def pending(self) -> list[FaultSpec]:
        return [f for f in self.faults
                if (f.tick, f.site) not in self.fired]

    # -- serialization: a chaos run is replayable from JSON -----------
    def to_json(self) -> str:
        return json.dumps({"faults": [f.to_json() for f in self.faults]})

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls([FaultSpec(**d) for d in json.loads(s)["faults"]])

    @classmethod
    def seeded(cls, seed: int, n_ticks: int, sites=SITES,
               rate: float = 0.1, batch: int = 4,
               pool_blocks: int = 4) -> "FaultPlan":
        """Generate a random-but-replayable plan: same ``(seed,
        n_ticks, ...)`` -> bit-identical plan, every run."""
        rng = random.Random(seed)
        faults: list[FaultSpec] = []
        for tick in range(1, n_ticks):
            for site in sites:
                if rng.random() >= rate:
                    continue
                if site == "dispatch":
                    faults.append(FaultSpec(
                        site, tick, count=rng.randint(1, 2)))
                elif site == "tokens":
                    faults.append(FaultSpec(
                        site, tick, slot=rng.randrange(batch)))
                elif site == "pool":
                    faults.append(FaultSpec(
                        site, tick, blocks=rng.randint(1, pool_blocks),
                        hold_ticks=rng.randint(1, 3)))
                elif site == "slow":
                    faults.append(FaultSpec(
                        site, tick, delay_s=rng.uniform(0.01, 0.05)))
                elif site == "socket":
                    faults.append(FaultSpec(site, tick))
        return cls(faults)


class DegradedModeController:
    """Pressure ladder: sustained adverse ticks step the engine down,
    sustained clean ticks step it back up.

    Levels (the engine maps them; this class only counts):

    0. nominal — configured K and gather mode
    1. halve the effective megatick K (smaller blast radius per
       dispatch, faster boundaries for cancel/drain)
    2. K=1 and, on the CPU, ``bounded_gather=False`` (the masked-pool
       oracle path: slowest, simplest, fewest moving parts); on the card
       the gather mode stays, since the masked path has no kernel there
    3. shed — additionally refuse new intake (the server's existing
       429 path)

    Every level is token-identical to level 0 by the engine's own
    gated invariants (K-variation and gather-mode-variation identity),
    so degrading never corrupts a stream — it only trades throughput
    for stability.
    """

    def __init__(self, trip_after: int = 3, recover_after: int = 8,
                 max_level: int = 3):
        self.trip_after = int(trip_after)
        self.recover_after = int(recover_after)
        self.max_level = int(max_level)
        self.level = 0
        self.transitions = 0
        self._adverse_streak = 0
        self._clean_streak = 0

    def observe(self, adverse: bool) -> int:
        """Record one tick's health; returns the (possibly new) level."""
        if adverse:
            self._adverse_streak += 1
            self._clean_streak = 0
            if (self._adverse_streak >= self.trip_after
                    and self.level < self.max_level):
                self.level += 1
                self.transitions += 1
                self._adverse_streak = 0
        else:
            self._clean_streak += 1
            self._adverse_streak = 0
            if (self._clean_streak >= self.recover_after
                    and self.level > 0):
                self.level -= 1
                self.transitions += 1
                self._clean_streak = 0
        return self.level
