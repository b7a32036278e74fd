"""Pluggable scheduling policies for the serving engine.

The engine's tick loop owns the *mechanism* (slot allocation, chunked
prefill, preemption bookkeeping); a ``SchedulerPolicy`` owns the
*decisions*: which queued requests to try admitting first, and which
active request to evict when the KV block pool is exhausted. This is
the serving analogue of the paper's thesis — rigid globally-ordered
execution (FCFS admission) leaves latency on the table exactly the way
rigid bulk-synchronous collectives do; a policy layer lets short or
urgent work overtake long prompts without touching the data path.

Interface (all hooks are host-side; nothing here is traced):

* ``select_admissions(queue, pool, tick)`` — order the *eligible*
  queued requests (arrival tick already passed) by admission
  preference. The engine walks the order and stops at the first
  request the pool cannot back with blocks — skipping ahead would
  starve long prompts, so every policy gets head-of-line semantics
  *within its own ordering*.
* ``select_victim(active, pool)`` — pick the active request to preempt
  when every slot is stalled on block availability. Preemption frees
  the victim's private blocks and re-queues it (see
  ``Engine._preempt_one``); the policy only names the victim.
* ``on_tick_end(queue, active, tick)`` — bookkeeping hook, called once
  per engine tick after retirement; policies may age priorities or
  track deadline slack here. The built-ins compute both lazily from
  request timestamps, so their hook is a no-op.

Built-in policies (``get_scheduler(name)``):

* ``fcfs``     — submission order; byte-identical admission decisions
  (and therefore token streams and tick/dispatch counts) to the
  pre-policy engine. Victim: the most recently admitted request, so
  the oldest work keeps its slot.
* ``priority`` — highest ``Request.priority`` first, FIFO within a
  level, with *aging*: a request's effective priority rises by one
  level every ``aging_ticks`` ticks it waits, so sustained
  high-priority traffic cannot starve low-priority requests forever.
  Victim: lowest raw priority, most recently admitted among ties.
* ``slo``      — earliest-deadline-first on the absolute deadline
  ``submitted_t + deadline_ms/1e3`` (a per-request TTFT target).
  Requests without a deadline sort after all deadline-tagged ones, in
  FIFO order. Victim: latest deadline (deadline-less first).
"""
from __future__ import annotations


class SchedulerPolicy:
    """Base policy: FIFO admission, preempt the youngest admission.

    Subclasses override the ordering hooks; the engine supplies the
    mechanism. ``queue`` is a list of eligible Requests in submission
    order, ``active`` the slot->Request dict, ``pool`` the CachePool
    (read-only here: policies may inspect occupancy, never mutate)."""

    name = "base"

    def select_admissions(self, queue, pool, tick):
        """Return eligible requests in admission-preference order."""
        return list(queue)

    def select_victim(self, active, pool):
        """Return the active Request to preempt (never None for a
        non-empty ``active``)."""
        return max(active.values(), key=lambda r: (r.admitted_t, r.seq))

    def on_tick_end(self, queue, active, tick):
        """Per-tick bookkeeping hook (aging, slack tracking). No-op for
        the built-ins — their orderings derive from timestamps."""


class FCFSScheduler(SchedulerPolicy):
    """Submission order among eligible requests — the regression-anchored
    default. Admission decisions are byte-identical to the pre-policy
    engine; the only new behavior is preemption *instead of* the old
    pool-exhaustion RuntimeError, which the anchored suites never hit."""

    name = "fcfs"

    def select_admissions(self, queue, pool, tick):
        return list(queue)


class PriorityScheduler(SchedulerPolicy):
    """Strict priority with aging. ``Request.priority``: higher runs
    first; equal levels are FIFO. Effective priority grows by one level
    per ``aging_ticks`` ticks spent waiting past the arrival tick, so a
    priority-0 request stuck behind a stream of priority-p arrivals is
    guaranteed the head of the order after ~``p * aging_ticks`` ticks."""

    name = "priority"

    def __init__(self, aging_ticks: int = 16):
        if aging_ticks < 1:
            raise ValueError(f"aging_ticks must be >= 1, got {aging_ticks}")
        self.aging_ticks = aging_ticks
        self._tick = 0            # kept fresh by on_tick_end

    def effective_priority(self, req, tick) -> int:
        waited = max(tick - req.arrival_tick, 0)
        return req.priority + waited // self.aging_ticks

    def select_admissions(self, queue, pool, tick):
        return sorted(queue, key=lambda r:
                      (-self.effective_priority(r, tick), r.seq))

    def on_tick_end(self, queue, active, tick):
        self._tick = tick         # select_victim has no tick parameter

    def select_victim(self, active, pool):
        # lowest AGED priority loses its slot — the same scale admission
        # uses, so a request that aged its way in is not automatically
        # the victim of every stall (which would undo the starvation
        # guarantee); youngest admission among ties (least sunk prefill
        # work to redo)
        return min(active.values(),
                   key=lambda r: (self.effective_priority(r, self._tick),
                                  -r.admitted_t, -r.seq))


class SLOScheduler(SchedulerPolicy):
    """Earliest-deadline-first on ``Request.deadline_ms`` (a TTFT target
    relative to submission). Deadline-tagged requests overtake untagged
    ones; untagged traffic is FIFO among itself, so a pure best-effort
    workload degrades to plain FCFS."""

    name = "slo"

    @staticmethod
    def _deadline(req) -> float:
        if req.deadline_ms is None:
            return float("inf")
        return req.submitted_t + req.deadline_ms * 1e-3

    def select_admissions(self, queue, pool, tick):
        return sorted(queue, key=lambda r: (self._deadline(r), r.seq))

    def select_victim(self, active, pool):
        # the slackest deadline (or no deadline at all) yields its slot
        return max(active.values(),
                   key=lambda r: (self._deadline(r), r.admitted_t, r.seq))


_POLICIES = {
    "fcfs": FCFSScheduler,
    "priority": PriorityScheduler,
    "slo": SLOScheduler,
}


def get_scheduler(policy, **kwargs) -> SchedulerPolicy:
    """Resolve a policy name (or pass through an instance). ``kwargs``
    go to the policy constructor (e.g. ``aging_ticks`` for priority)."""
    if isinstance(policy, SchedulerPolicy):
        return policy
    if policy not in _POLICIES:
        raise ValueError(f"unknown scheduler {policy!r}: expected one of "
                         f"{sorted(_POLICIES)} or a SchedulerPolicy instance")
    return _POLICIES[policy](**kwargs)
