"""Continuous-batching serving engine over paged KV (port of
``repro.serving.engine``).

Scheduling per tick, as in the JAX engine. With ``decode_steps=1``:

1. admit queued requests whose arrival tick has passed, in the policy's
   order, while the pool has a free slot AND blocks for the prompt plus
   one generated token (admission stops at the first request the pool
   cannot back);
2. build a (B, C) token block: prefilling slots take their next
   ``min(C, remaining)`` prompt tokens, decoding slots their last
   sampled token, idle slots nothing; counts are clamped to what the
   pool can back with blocks this tick. If every active slot stalls,
   the policy's victim is preempted (its generated tokens fold into an
   effective prompt; resuming is a prefix hit);
3. one dispatch — ``lm.decode_step`` (all counts <= 1) or
   ``lm.decode_chunk`` — then sampling on the card and ONE readback of
   the (B, 1) token ids; finished requests retire.

With ``decode_steps=K > 1`` every tick with an active slot is a
megatick: K decode steps with the sampler inside the loop
(``lm.decode_multi``), or, while any slot is prefilling, the mixed
program in which prompt chunks ride the same loop (``lm.decode_mixed``);
one readback of the (B, S) ids per megatick. On the card, when every
rank is on one card, a megatick is one CUDA-graph replay
(``serving.graphs``). Preemption and sliding-window reclaim happen at
megatick boundaries; streams stay token-identical to K = 1.

Sampling is greedy or the seeded temperature/top-k sampler, whose keys
fold (seed, request id, token index) with JAX's threefry
(``serving.sampler``), so a stream does not depend on scheduling.

Everything on the card runs under ``torch.inference_mode()``. The decode
state (KV pools, the recurrent families' per-slot state, ``cur_len``,
block table) is updated in place.

The engine takes the ambient distribution context
(``distributed.context.current()``) when it is built and runs every
dispatch under it: over the W ranks of its mesh the pool is sharded on
the block dim and the decode step goes through the fusion mode's
patterns (``core.patterns``); nothing in the scheduling changes.

ROBUSTNESS, as in the JAX engine: a seeded ``serving.faults.FaultPlan``
keyed by (tick, site) injects faults, and the engine recovers:

* ``dispatch``: an injected transient failure trips BEFORE anything is
  launched (before the eager step, the graph replay, or a graph's
  warm-up and capture). The state is written in place, so only a
  dispatch that launched nothing can be retried: the bounded retry
  (``DISPATCH_ATTEMPTS``, deterministic backoff) wraps the trip alone
  and catches only ``TransientDispatchError``. Any other exception
  raised by a dispatch (a CUDA error is sticky on the context) leaves
  the engine at once, with ``dispatch_retries`` unchanged.
* ``tokens``: one slot's read-back ids are overwritten with an
  out-of-vocab id (the signature of NaN/Inf logits); the guard retires
  that slot with ``finish_reason="error"`` through ``CachePool.abort``,
  and only its clean history enters the prefix cache.
* ``pool``: free blocks are seized for a few ticks (preemption absorbs
  the spike); ``slow``: the tick sleeps.

A monotonic-clock ``StragglerWatchdog`` times every tick, readback
included, so it covers the device work. A tick that captured a CUDA
graph (about a second, against ~0.1 s for a steady megatick) is not fed
to it; it counts as ``graph_capture_ticks``. An optional
``DegradedModeController`` (``degraded=True``) steps the engine down
under sustained adverse ticks (slow, retried, or poisoned) and back up
after sustained clean ones: level 1 halves K (new graph keys are
captured on first use); level 2 runs K = 1, and on the CPU also sets
``bounded_gather=False`` as JAX does, while on the card the gather mode
stays (the masked path is the CPU oracle and raises on the card at
W > 1; at W = 1 the flag changes nothing); level 3 also sheds intake
(``shedding``). Every level is token-identical.

``drain()`` parks every active request through the preemption path;
``snapshot()`` drains and saves the decode state through the port's
``checkpoint.Checkpointer`` with the queue and the pool's bookkeeping in
the manifest; ``restore()`` copies a snapshot IN PLACE into this
engine's existing state tensors (captured graphs hold their addresses,
so they replay on correctly) and re-queues the requests, which resume
as prefix hits.

The paths that write state tensors (ticks, cancel, drain, restore) run
under ``torch.inference_mode()`` on tensors made outside it, so any
thread may drive the engine (the server ticks on an executor thread).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import context as dctx
from repro_torch.distributed.fault_tolerance import StragglerWatchdog
from repro_torch.models import lm
from repro_torch.serving import sampler as sampler_lib
from repro_torch.serving.faults import (DISPATCH_ATTEMPTS,
                                        DegradedModeController,
                                        DispatchFailedError, FaultPlan,
                                        TransientDispatchError, backoff_s)
from repro_torch.serving.graphs import MIXED, PURE, MegatickRunner
from repro_torch.serving.kv_cache import CachePool, pow2_bucket
from repro_torch.serving.metrics import latency_summary
from repro_torch.serving.scheduler import SchedulerPolicy, get_scheduler


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    arrival_tick: int = 0            # earliest tick it may be admitted
    temp: float = 1.0                # per-request sampling temperature
    top_k: int = 0                   # per-request top-k (0 = full vocab)
    priority: int = 0                # higher = sooner ("priority" policy)
    deadline_ms: float | None = None  # TTFT target ("slo" policy)
    out_tokens: list = dataclasses.field(default_factory=list)
    slot: int = -1
    consumed: int = 0                # effective-prompt tokens written
    reused_tokens: int = 0           # prompt tokens served by a prefix hit
    preemptions: int = 0             # times evicted and re-queued
    seq: int = 0                     # submission order (engine-stamped)
    done: bool = False
    cancelled: bool = False
    finish_reason: str | None = None  # "length" | "cancelled" | "error"
    error: str | None = None
    submitted_t: float = 0.0
    admitted_t: float = 0.0
    first_token_t: float = 0.0
    finished_t: float = 0.0

    def __post_init__(self):
        # what a (re)admission prefills: the prompt plus, after a
        # preemption, the tokens generated before eviction
        self.eff_prompt: list[int] = list(self.prompt)

    @property
    def prefilling(self) -> bool:
        return self.consumed < len(self.eff_prompt)

    @property
    def ttft_s(self) -> float:
        return max(self.first_token_t - self.submitted_t, 0.0)

    @property
    def tpot_s(self) -> float:
        n = len(self.out_tokens)
        if n <= 1 or self.finished_t == 0.0:
            return 0.0
        return max(self.finished_t - self.first_token_t, 0.0) / (n - 1)


class Engine:
    """Continuous-batching scheduler over a paged ``CachePool``.

    ``params`` is a :class:`repro_torch.models.lm.LM` on ``device``
    (default ``"cuda"``; ``"cpu"`` runs the kernels' plain versions).
    ``prefill_chunk`` is the most prompt tokens a slot consumes per
    tick; ``block_size``/``n_blocks`` size the paged pool;
    ``scheduler`` is "fcfs", "priority", "slo" or a policy instance.
    ``sampler`` is "greedy" or "temperature" (``Request.temp`` /
    ``Request.top_k``, keys from ``seed``; ``temp=0`` is greedy).
    ``decode_steps`` is the megatick length K; ``megatick_token_budget``
    the per-slot token quota M of a mixed megatick (default
    ``max(K, prefill_chunk)``, at least K).
    ``bounded_gather`` (W > 1): paged attention walks each slot's table
    (default) or scores the masked whole pool shard (the CPU oracle).
    ``fault_plan``, ``watchdog`` and ``degraded`` are the robustness
    plane (module docstring); ``retry_backoff_s`` and
    ``retry_backoff_cap_s`` set the retry's deterministic backoff, as
    the JAX engine's do. A config without a decode step
    (``cfg.has_decode``: an encoder such as hubert-xlarge) is refused.
    """

    def __init__(self, params, cfg, *, batch: int = 8, max_len: int = 512,
                 prefill_chunk: int = 8, sampler: str = "greedy",
                 seed: int = 0, block_size: int = 16,
                 n_blocks: int | None = None,
                 scheduler: str | SchedulerPolicy = "fcfs",
                 decode_steps: int = 1,
                 megatick_token_budget: int | None = None,
                 fault_plan: FaultPlan | None = None,
                 watchdog: StragglerWatchdog | None = None,
                 degraded: DegradedModeController | bool | None = None,
                 bounded_gather: bool = True, device="cuda",
                 retry_backoff_s: float = 0.02,
                 retry_backoff_cap_s: float = 0.5):
        if not cfg.has_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode "
                             f"serving")
        if sampler not in ("greedy", "temperature"):
            raise ValueError(f"unknown sampler {sampler!r}: "
                             f"expected 'greedy' or 'temperature'")
        if decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, "
                             f"got {decode_steps}")
        if (megatick_token_budget is not None
                and megatick_token_budget < decode_steps):
            raise ValueError(
                f"megatick_token_budget {megatick_token_budget} < "
                f"decode_steps {decode_steps}: the per-slot quota must "
                f"at least cover a full decode megatick, or the 1/K "
                f"dispatch bound cannot hold")
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params live on {params.device}, engine "
                             f"device is {self.device}")
        self.policy = get_scheduler(scheduler)   # fail fast, pre-pool-init
        self.ctx = dctx.current()
        mesh = self.ctx.mesh if self.ctx.model_axis_size > 1 else None
        if mesh is not None and mesh.distinct[0] != params.device:
            raise ValueError(f"params live on {params.device}, the mesh's "
                             f"first rank on {mesh.distinct[0]}")
        self.params = params
        # what the decode step takes: one replica per distinct device
        self.step_params = (params if mesh is None
                            else lm.replicate(params, mesh))
        self.bounded_gather = bool(bounded_gather)
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}   # slot -> request
        self.pool = CachePool(params, cfg, batch, max_len,
                              block_size=block_size, n_blocks=n_blocks)
        self.sampler = sampler
        self.seed = int(seed)
        self._base_key = sampler_lib.prng_key(seed, params.device)
        self.decode_steps = int(decode_steps)
        self.megatick_tokens = (int(megatick_token_budget)
                                if megatick_token_budget is not None
                                else max(self.decode_steps,
                                         self.prefill_chunk))
        # a megatick is one CUDA-graph replay when every rank is on one
        # card; over distinct cards (and on the CPU) the loop runs eagerly
        one_card = mesh is None or len(mesh.distinct) == 1
        self._runner = None
        if self.decode_steps > 1:
            self._runner = MegatickRunner(
                self.step_params, self.pool.state, cfg, batch=batch,
                width=self.megatick_tokens, sampler=sampler,
                key=self._base_key, bounded=self.bounded_gather,
                device=params.device,
                graphs=self.device.type == "cuda" and one_card)
        # the single-step tick's host inputs go up through pinned host
        # buffers with non_blocking=True (:meth:`_upload`): no
        # synchronize. Each tick writes them before its one readback,
        # which synchronizes the stream, so a copy has landed before the
        # next tick writes its buffer again
        B, C = batch, self.prefill_chunk
        pin = self.device.type == "cuda"
        shapes = {"tok": ((B, C), torch.int32), "cnt": ((B,), torch.int32),
                  "active": ((B,), torch.bool), "rids": ((B,), torch.int32),
                  "steps": ((B,), torch.int32),
                  "temps": ((B,), torch.float32),
                  "topks": ((B,), torch.int32)}
        self._host_in = {k: torch.zeros(shape, dtype=dt, pin_memory=pin)
                         for k, (shape, dt) in shapes.items()}
        self._host_np = {k: t.numpy() for k, t in self._host_in.items()}
        self._dev_in = {k: torch.zeros(shape, dtype=dt, device=self.device)
                        for k, (shape, dt) in shapes.items()}
        self.tick_count = 0
        self.dispatch_count = 0     # ticks that actually ran a decode step
        self.preempt_count = 0
        self.cancel_count = 0
        self.blocks_freed_on_abort = 0
        self.decode_dispatch_count = 0   # dispatches with no slot prefilling
        self.decode_token_count = 0      # tokens those dispatches produced
        # mixed megaticks: dispatches carrying prompt chunks, the prompt
        # tokens they consumed and the decode tokens they emitted
        self.mixed_dispatch_count = 0
        self.mixed_prompt_token_count = 0
        self.mixed_decode_token_count = 0
        self.scan_steps = 0              # decode steps the dispatches ran
        self._seq = 0
        # -------- robustness plane
        # faults: keyed by (tick, site); ticks are 1-based, a spec with
        # tick=t fires during the t-th tick()
        self.faults = fault_plan
        self.watchdog = (watchdog if watchdog is not None
                         else StragglerWatchdog())
        if degraded is True:
            degraded = DegradedModeController()
        self.degraded = degraded or None
        self._cfg_bounded = self.bounded_gather  # configured gather mode
        self._spike_until = None    # tick the seized pool blocks return
        # the retry's deterministic backoff: retry_backoff_s * 2 **
        # (attempt - 1), capped (faults.backoff_s)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_cap_s = float(retry_backoff_cap_s)
        self.dispatch_retry_count = 0    # retried dispatches
        self.dispatch_failure_count = 0  # retry budgets exhausted
        self.error_count = 0             # slots retired finish_reason=error
        self.slow_tick_count = 0         # watchdog-flagged ticks
        self.drain_count = 0             # requests parked by drain()
        self.graph_capture_ticks = 0     # ticks that captured a graph

    # ------------------------------------------------------------- queueing
    def submit(self, req: Request, at_tick: int | None = None):
        """Queue a request; ``at_tick`` (or ``req.arrival_tick``) delays
        admission until that scheduler tick."""
        if not req.prompt:
            raise ValueError(
                f"request {req.rid}: empty prompt — a request must carry "
                f"at least one token to produce logits")
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} "
                f">= max_len {self.max_len} — the cache cannot hold the "
                f"prompt plus one generated token")
        if not self.pool.admissible(len(req.prompt)):
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} "
                f"needs more KV blocks than the whole pool holds "
                f"(n_blocks={self.pool.n_blocks}, block_size="
                f"{self.pool.block_size}); raise n_blocks")
        req.submitted_t = time.time()
        req.seq = self._seq
        self._seq += 1
        if at_tick is not None:
            req.arrival_tick = at_tick
        self.queue.append(req)

    def _admit(self):
        """Admit eligible requests in policy order, gated on block
        availability; stop at the first one the pool cannot back."""
        admitted = []
        if not self.queue:
            return admitted
        eligible = [r for r in self.queue
                    if r.arrival_tick <= self.tick_count]
        if not eligible:
            return admitted
        taken = set()
        for req in self.policy.select_admissions(eligible, self.pool,
                                                 self.tick_count):
            if not self.pool.n_free:
                break
            res = self.pool.alloc(req.eff_prompt)
            if res is None:
                break
            slot, reused = res
            req.slot = slot
            req.consumed = req.reused_tokens = reused
            req.admitted_t = time.time()
            self.active[slot] = req
            taken.add(id(req))
            admitted.append(req)
        if taken:
            self.queue = deque(r for r in self.queue
                               if id(r) not in taken)
        return admitted

    def _preempt_one(self):
        """Every active slot is stalled on blocks: evict the policy's
        victim (its history becomes its effective prompt) and put it at
        the queue head. Raises when the victim's history has outgrown the
        whole pool."""
        victim = self.policy.select_victim(self.active, self.pool)
        victim.eff_prompt = list(victim.prompt) + list(victim.out_tokens)
        if not self.pool.admissible(len(victim.eff_prompt)):
            raise RuntimeError(
                f"KV block pool exhausted and request {victim.rid} has "
                f"grown past what the whole pool can hold (effective "
                f"prompt {len(victim.eff_prompt)} tokens, n_blocks="
                f"{self.pool.n_blocks}, block_size="
                f"{self.pool.block_size}): preemption cannot make "
                f"progress; raise n_blocks or lower max_new_tokens")
        slot = victim.slot
        self.pool.preempt(slot, victim.eff_prompt)
        del self.active[slot]
        victim.slot = -1
        victim.consumed = 0
        victim.reused_tokens = 0
        victim.preemptions += 1
        self.preempt_count += 1
        self.queue.appendleft(victim)

    @torch.inference_mode()
    def cancel(self, rid: int) -> bool:
        """Abort request ``rid`` between ticks. Returns True when it was
        found queued or active."""
        for req in self.queue:
            if req.rid == rid and not req.done:
                self.queue.remove(req)
                req.done = True
                req.cancelled = True
                req.finish_reason = req.finish_reason or "cancelled"
                self.cancel_count += 1
                return True
        for slot, req in list(self.active.items()):
            if req.rid != rid:
                continue
            history = list(req.eff_prompt) + list(req.out_tokens)
            self.blocks_freed_on_abort += self.pool.abort(slot, history)
            del self.active[slot]
            req.slot = -1
            req.done = True
            req.cancelled = True
            req.finish_reason = req.finish_reason or "cancelled"
            self.cancel_count += 1
            return True
        return False

    def _retire(self, slot: int, req: Request, now: float, finished):
        req.done = True
        req.finish_reason = req.finish_reason or "length"
        req.finished_t = now
        finished.append(req)
        del self.active[slot]
        self.pool.free(slot)

    def _retire_error(self, slot: int, req: Request, now: float,
                      finished, reason: str):
        """Retire a poisoned slot through the abort path with
        ``finish_reason="error"``; only its clean history is registered
        in the prefix cache."""
        history = (list(req.eff_prompt[:req.consumed])
                   + list(req.out_tokens))
        self.pool.abort(slot, history)
        del self.active[slot]
        req.slot = -1
        req.done = True
        req.error = reason
        req.finish_reason = "error"
        req.finished_t = now
        self.error_count += 1
        finished.append(req)

    # ------------------------------------------------------- fault plane
    @property
    def eff_decode_steps(self) -> int:
        """Megatick length after the degraded ladder: level 1 halves K,
        level >= 2 runs the single-step path."""
        if self.degraded is None or self.degraded.level == 0:
            return self.decode_steps
        if self.degraded.level == 1:
            return max(self.decode_steps // 2, 1)
        return 1

    @property
    def shedding(self) -> bool:
        """Level 3: the front end should refuse new intake (429)."""
        return self.degraded is not None and self.degraded.level >= 3

    def _poll_fault(self, site: str):
        """The (tick, site)-keyed injection lookup; None when no plan is
        armed or the key already fired."""
        if self.faults is None:
            return None
        return self.faults.poll(site, self.tick_count)

    def _apply_faults(self):
        """Tick-boundary faults: pool-exhaustion spikes (seize free
        blocks now, release them when the hold expires) and slow ticks.
        Dispatch and token faults apply at their own sites."""
        if self._spike_until is not None \
                and self.tick_count >= self._spike_until:
            self.pool.release_seized()
            self._spike_until = None
        if self.faults is None:
            return
        spec = self.faults.poll("pool", self.tick_count)
        if spec is not None:
            self.pool.seize_blocks(spec.blocks)
            self._spike_until = self.tick_count + max(spec.hold_ticks, 1)
        spec = self.faults.poll("slow", self.tick_count)
        if spec is not None:
            time.sleep(spec.delay_s)

    def _dispatch_gate(self, what: str):
        """The bounded retry of one dispatch, run BEFORE it launches
        anything: an injected transient fault trips here and is retried
        with deterministic backoff; once ``DISPATCH_ATTEMPTS`` attempts
        have failed the tick raises ``DispatchFailedError``. The
        dispatch itself is never retried (it writes the state in place),
        so an exception it raises propagates unretried."""
        fault = self._poll_fault("dispatch")
        if fault is None:
            return
        for attempt in range(DISPATCH_ATTEMPTS):
            if attempt:
                self.dispatch_retry_count += 1
                time.sleep(backoff_s(attempt, self.retry_backoff_s,
                                     self.retry_backoff_cap_s))
            try:
                fault.trip()
                return
            except TransientDispatchError as err:
                last_err = err
        self.dispatch_failure_count += 1
        raise DispatchFailedError(
            f"{what} failed after {DISPATCH_ATTEMPTS} attempts at tick "
            f"{self.tick_count}") from last_err

    def _upload(self, name: str, array: np.ndarray) -> torch.Tensor:
        """``array`` in the device buffer ``name``, copied from its pinned
        host buffer with ``non_blocking=True`` (plain copies on the
        CPU)."""
        self._host_np[name][...] = array
        dev = self._dev_in[name]
        dev.copy_(self._host_in[name], non_blocking=True)
        return dev

    def _poison(self, ids: np.ndarray) -> np.ndarray:
        """The ``tokens`` fault: one slot's read-back ids become -1."""
        spec = self._poll_fault("tokens")
        if spec is not None:
            ids = ids.copy()
            ids[spec.slot % self.batch, :] = -1
        return ids

    # ----------------------------------------------------------- scheduling
    @torch.inference_mode()
    def tick(self) -> list[Request]:
        """One scheduler step. Returns requests that finished this tick.

        Around the dispatch path: the watchdog on the monotonic clock
        (the readback is inside the tick, so the time covers the device
        work; a tick that captured a graph is counted, not timed) and
        the degraded ladder, fed whether the tick was slow, retried a
        dispatch or retired a poisoned slot."""
        r0, e0 = self.dispatch_retry_count, self.error_count
        c0 = self._runner.captures if self._runner is not None else 0
        t0 = time.monotonic()
        with dctx.use(self.ctx):
            finished = self._tick()
        if self._runner is not None and self._runner.captures > c0:
            self.graph_capture_ticks += 1
            slow = False
        else:
            slow = self.watchdog.timed(self.tick_count, t0)
        if slow:
            self.slow_tick_count += 1
        if self.degraded is not None:
            adverse = (slow or self.dispatch_retry_count > r0
                       or self.error_count > e0)
            lvl = self.degraded.observe(adverse)
            # rung 2's masked gather is the CPU oracle only: on the card
            # the gather mode stays (K = 1 is the rung there)
            self.bounded_gather = self._cfg_bounded and (
                lvl < 2 or self.device.type == "cuda")
        self.policy.on_tick_end(self.queue, self.active, self.tick_count)
        return finished

    def _tick(self) -> list[Request]:
        self._admit()
        self.tick_count += 1
        self._apply_faults()
        if not self.active:
            return []
        if self.eff_decode_steps > 1:
            # a batch with prefill in flight runs the mixed program,
            # a pure-decode batch the K-step one
            if any(r.prefilling for r in self.active.values()):
                return self._megatick_mixed()
            return self._megatick()
        C = self.prefill_chunk
        tok = np.zeros((self.batch, C), np.int32)
        cnt = np.zeros((self.batch,), np.int32)
        emit = np.zeros((self.batch,), bool)
        any_prefill = False
        for slot, req in self.active.items():
            want = (min(C, len(req.eff_prompt) - req.consumed)
                    if req.prefilling else 1)
            # clamp to what the pool can back with blocks this tick
            n = self.pool.writable(slot, want)
            if n == 0:
                continue                    # stalled: no KV block free
            if req.prefilling:
                any_prefill = True
                tok[slot, :n] = req.eff_prompt[req.consumed:req.consumed + n]
                cnt[slot] = n
                emit[slot] = req.consumed + n >= len(req.eff_prompt)
            else:
                tok[slot, 0] = (req.out_tokens[-1] if req.out_tokens
                                else req.eff_prompt[-1])
                cnt[slot] = 1
                emit[slot] = True

        cmax = int(cnt.max(initial=0))
        if cmax == 0:
            self._preempt_one()
            return []
        # gather width AFTER the writable() loop: this tick's allocations
        # are in the table, so the slice covers every position touched
        gw = self.pool.gather_width()
        self.dispatch_count += 1
        if not any_prefill:
            self.decode_dispatch_count += 1
        self._dispatch_gate("dispatch")
        # the table goes up after the gate: every copy is followed by
        # this tick's readback (CachePool.sync)
        self.pool.sync()
        tok_d = self._upload("tok", tok)
        if cmax <= 1:
            self.scan_steps += 1
            logits, _ = lm.decode_step(
                self.step_params, tok_d[:, :1], self.pool.state, self.cfg,
                active=self._upload("active", cnt > 0),
                gather_width=gw, bounded=self.bounded_gather)
        else:
            cw = pow2_bucket(cmax, C)
            self.scan_steps += cw
            logits, _ = lm.decode_chunk(
                self.step_params, tok_d[:, :cw], self._upload("cnt", cnt),
                self.pool.state, self.cfg, gather_width=gw,
                bounded=self.bounded_gather)
        nxt = self._poison(self._next_tokens(logits, emit))

        finished = []
        now = time.time()
        for slot, req in list(self.active.items()):
            n = int(cnt[slot])
            if n == 0:
                continue
            self.pool.advance(slot, n)
            cache_full = int(self.pool.lengths[slot]) + 1 >= self.max_len
            if req.prefilling:
                req.consumed += n
                self.pool.register_prompt_chunks(slot, req.eff_prompt)
            if self.cfg.sliding_window is not None:
                self.pool.reclaim_out_of_window(slot,
                                                self.cfg.sliding_window)
            if req.prefilling and not cache_full:   # still mid-prompt
                continue
            if not req.prefilling:
                t = int(nxt[slot, 0])
                if not 0 <= t < self.cfg.vocab_size:
                    # NaN/Inf guard: an out-of-vocab id is the readback
                    # signature of bad logits — retire THIS slot only
                    self._retire_error(
                        slot, req, now, finished,
                        f"non-finite logits: sampled token id {t}")
                    continue
                req.out_tokens.append(t)
                if not any_prefill:
                    self.decode_token_count += 1
                if len(req.out_tokens) == 1:
                    req.first_token_t = now
            if (len(req.out_tokens) >= req.max_new_tokens
                    or cache_full):
                self._retire(slot, req, now, finished)
        return finished

    def _megatick(self) -> list[Request]:
        """One K-step decode megatick (``lm.decode_multi``); runs only
        when every active slot decodes. Each slot's step budget is
        clamped by its remaining ``max_new_tokens``, its ``max_len``
        headroom and the blocks ``CachePool.reserve`` can back for the
        whole megatick; a slot past its budget is frozen in the loop.
        Sampling stays on the card: (B, S) ids come back."""
        K = self.eff_decode_steps
        tok = np.zeros((self.batch, 1), np.int32)
        budgets = np.zeros((self.batch,), np.int32)
        rids = np.zeros((self.batch,), np.int32)
        steps0 = np.zeros((self.batch,), np.int32)
        temps = np.zeros((self.batch,), np.float32)
        topks = np.zeros((self.batch,), np.int32)
        for slot, req in self.active.items():
            want = min(K, req.max_new_tokens - len(req.out_tokens),
                       self.max_len - 1 - int(self.pool.lengths[slot]))
            budgets[slot] = self.pool.reserve(slot, want)
            tok[slot, 0] = (req.out_tokens[-1] if req.out_tokens
                            else req.eff_prompt[-1])
            rids[slot] = req.rid
            steps0[slot] = len(req.out_tokens)
            temps[slot] = req.temp
            topks[slot] = req.top_k
        kmax = int(budgets.max(initial=0))
        if kmax == 0:
            # every slot stalled on blocks at the megatick boundary
            self._preempt_one()
            return []
        # gather width AFTER the reserve() loop: it must cover every
        # block the whole megatick writes
        gw = self.pool.gather_width()
        # scan length bucketed to a power of two (at most K): graphs stay
        # bounded at log2(K) + 1 lengths per gather width
        kb = pow2_bucket(kmax, K)
        self.dispatch_count += 1
        self.decode_dispatch_count += 1
        self._dispatch_gate("megatick dispatch")
        self.pool.sync()
        self.scan_steps += kb
        out = self._poison(self._runner.run(
            PURE, kb, gw, tok=tok, budgets=budgets, rids=rids,
            steps0=steps0, temps=temps, topks=topks))

        finished = []
        now = time.time()
        for slot, req in list(self.active.items()):
            n = int(budgets[slot])
            if n == 0:
                continue
            row = out[slot, :n]
            bad = np.nonzero((row < 0) | (row >= self.cfg.vocab_size))[0]
            if bad.size:
                # NaN/Inf guard: keep the tokens sampled before the first
                # out-of-vocab id, advance the host length only that far
                # (the prefix registry never serves poisoned KV), and
                # retire THIS slot as an error
                good = int(bad[0])
                self.pool.advance(slot, good)
                req.out_tokens.extend(int(t) for t in row[:good])
                self.decode_token_count += good
                self._retire_error(
                    slot, req, now, finished,
                    f"non-finite logits: sampled token id "
                    f"{int(row[good])}")
                continue
            self.pool.advance(slot, n)
            req.out_tokens.extend(int(t) for t in row)
            self.decode_token_count += n
            if self.cfg.sliding_window is not None:
                self.pool.reclaim_out_of_window(slot,
                                                self.cfg.sliding_window)
            cache_full = int(self.pool.lengths[slot]) + 1 >= self.max_len
            if (len(req.out_tokens) >= req.max_new_tokens
                    or cache_full):
                self._retire(slot, req, now, finished)
        return finished

    def _megatick_mixed(self) -> list[Request]:
        """One mixed prefill+decode megatick (``lm.decode_mixed``): runs
        when any slot of a K-step engine is mid-prompt. Each slot gets a
        quota of ``megatick_tokens`` (M) steps: a prefilling slot
        consumes ``p = min(M, remaining prompt)`` prompt tokens and, if
        that completes its prompt, samples its first token at the step
        that consumed the last one and piggybacks up to ``min(M - p, K,
        remaining max_new - 1, headroom)`` decode steps; a decoding slot
        runs its usual ``min(K, remaining max_new, headroom)``. One
        ``reserve`` per slot backs every write; a short reservation
        shrinks the prefill span first. If every reservation is 0, the
        policy's victim is preempted."""
        K = self.eff_decode_steps
        M = self.megatick_tokens
        toks = np.zeros((self.batch, M), np.int32)
        tok0 = np.zeros((self.batch, 1), np.int32)
        pl = np.zeros((self.batch,), np.int32)     # prefill role steps
        e0 = np.zeros((self.batch,), np.int32)     # first emitting step
        tot = np.zeros((self.batch,), np.int32)    # total active steps
        rids = np.zeros((self.batch,), np.int32)
        steps0 = np.zeros((self.batch,), np.int32)
        temps = np.zeros((self.batch,), np.float32)
        topks = np.zeros((self.batch,), np.int32)
        for slot, req in self.active.items():
            headroom = self.max_len - 1 - int(self.pool.lengths[slot])
            rem_new = req.max_new_tokens - len(req.out_tokens)
            if req.prefilling:
                rem_p = len(req.eff_prompt) - req.consumed
                p_want = min(M, rem_p)
                # decode steps ride along only when the prompt completes
                # here; the first sampled token is written when it is
                # consumed, so the span is remaining max_new minus one
                d_want = (max(0, min(M - p_want, K, rem_new - 1,
                                     headroom - p_want))
                          if p_want == rem_p else 0)
            else:
                rem_p = 0
                p_want = 0
                d_want = min(K, rem_new, headroom)
            n = self.pool.reserve(slot, p_want + d_want)
            p = min(n, p_want)
            tot[slot] = n
            pl[slot] = p
            # emission starts at the step consuming the last prompt token
            # (or at 0 for a decoding slot); a slot whose prompt does not
            # complete this megatick never emits (e0 == n)
            e0[slot] = max(p - 1, 0) if p == rem_p else n
            toks[slot, :p] = req.eff_prompt[req.consumed:req.consumed + p]
            tok0[slot, 0] = (req.out_tokens[-1] if req.out_tokens
                             else req.eff_prompt[-1])
            rids[slot] = req.rid
            steps0[slot] = len(req.out_tokens)
            temps[slot] = req.temp
            topks[slot] = req.top_k
        nmax = int(tot.max(initial=0))
        if nmax == 0:
            self._preempt_one()
            return []
        gw = self.pool.gather_width()
        # scan length bucketed to a power of two, capped at the quota M
        S = pow2_bucket(nmax, M)
        self.dispatch_count += 1
        self.mixed_dispatch_count += 1
        self.mixed_prompt_token_count += int(pl.sum())
        self._dispatch_gate("mixed megatick dispatch")
        self.pool.sync()
        self.scan_steps += S
        out = self._poison(self._runner.run(
            MIXED, S, gw, tok=tok0, toks=toks, pl=pl, e0=e0, tot=tot,
            rids=rids, steps0=steps0, temps=temps, topks=topks))

        finished = []
        now = time.time()
        for slot, req in list(self.active.items()):
            n = int(tot[slot])
            if n == 0:
                continue
            p = int(pl[slot])
            first_emit = int(e0[slot])
            emitted = n - first_emit
            span = out[slot, first_emit:n] if emitted > 0 \
                else out[slot, :0]
            bad = np.nonzero((span < 0)
                             | (span >= self.cfg.vocab_size))[0]
            if bad.size:
                # NaN/Inf guard: prompt writes are clean; of the sampled
                # span keep the ids before the first bad one
                good = int(bad[0])
                self.pool.advance(slot, min(n, p + good))
                req.consumed += p
                req.out_tokens.extend(int(t) for t in span[:good])
                self.mixed_decode_token_count += good
                self._retire_error(
                    slot, req, now, finished,
                    f"non-finite logits: sampled token id "
                    f"{int(span[good])}")
                continue
            self.pool.advance(slot, n)
            if p:
                req.consumed += p
                self.pool.register_prompt_chunks(slot, req.eff_prompt)
            if self.cfg.sliding_window is not None:
                self.pool.reclaim_out_of_window(slot,
                                                self.cfg.sliding_window)
            if emitted > 0:
                first = not req.out_tokens
                req.out_tokens.extend(int(t) for t in span)
                self.mixed_decode_token_count += emitted
                if first:
                    req.first_token_t = now
            cache_full = int(self.pool.lengths[slot]) + 1 >= self.max_len
            if req.prefilling and not cache_full:
                continue
            if (len(req.out_tokens) >= req.max_new_tokens
                    or cache_full):
                self._retire(slot, req, now, finished)
        return finished

    def _next_tokens(self, logits, emit):
        """Each emitting slot's next token, sampled on the card: greedy,
        or the seeded sampler with keys folded from (seed, rid, token
        index), so the ids do not depend on the batch."""
        if self.sampler == "greedy":
            ids = sampler_lib.greedy(logits)
        else:
            rids = np.zeros((self.batch,), np.int32)
            steps = np.zeros((self.batch,), np.int32)
            temps = np.zeros((self.batch,), np.float32)
            topks = np.zeros((self.batch,), np.int32)
            for slot, req in self.active.items():
                if not emit[slot]:
                    continue
                rids[slot] = req.rid
                steps[slot] = len(req.out_tokens)
                temps[slot] = req.temp
                topks[slot] = req.top_k
            ids = sampler_lib.sample_batch(
                logits, self._base_key, self._upload("rids", rids),
                self._upload("steps", steps), self._upload("temps", temps),
                self._upload("topks", topks))
        # torchlint: ignore[TAX001] single-step ticks need the sampled
        # (B, 1) ids on the host for scheduling; the logits stay put
        return ids.cpu().numpy()

    def run(self, max_ticks: int = 10_000) -> list[Request]:
        """Run until all submitted requests finish (or ``max_ticks``
        ticks elapse in this call)."""
        finished = []
        start = self.tick_count
        while ((self.queue or self.active)
               and self.tick_count - start < max_ticks):
            finished.extend(self.tick())
        return finished

    # --------------------------------------------- drain / snapshot / restore
    @torch.inference_mode()
    def drain(self) -> list[Request]:
        """Park every active request at a clean boundary through the
        preemption path (generated tokens fold into the effective
        prompt, written chunks register as prefix blocks, private blocks
        free), ahead of the never-started ones in slot order; seized
        fault blocks return. Returns the queue."""
        if self._spike_until is not None:
            self.pool.release_seized()
            self._spike_until = None
        parked = []
        for slot in sorted(self.active):
            req = self.active[slot]
            req.eff_prompt = list(req.prompt) + list(req.out_tokens)
            self.pool.preempt(slot, req.eff_prompt)
            req.slot = -1
            req.consumed = 0
            req.reused_tokens = 0
            parked.append(req)
        self.active.clear()
        for req in reversed(parked):
            self.queue.appendleft(req)
        self.drain_count += len(parked)
        return list(self.queue)

    def _req_payload(self, req: Request) -> dict:
        return {"rid": req.rid, "prompt": list(req.prompt),
                "max_new_tokens": req.max_new_tokens,
                "temp": req.temp, "top_k": req.top_k,
                "priority": req.priority, "deadline_ms": req.deadline_ms,
                "out_tokens": list(req.out_tokens),
                "preemptions": req.preemptions, "seq": req.seq,
                "submitted_t": req.submitted_t,
                "first_token_t": req.first_token_t}

    def snapshot(self, ckpt, step: int | None = None,
                 block: bool = True) -> int:
        """Drain, then save the decode state (KV pools, ``cur_len``,
        tables) through ``ckpt`` (a ``checkpoint.Checkpointer``: bf16
        leaves exactly, as their bits), with the queued requests, the
        pool's bookkeeping, the sampler and the seed in the manifest's
        ``extra["serving"]``. Returns the step written."""
        self.drain()
        step = self.tick_count if step is None else step
        extra = {"serving": {
            "sampler": self.sampler, "seed": self.seed,
            "requests": [self._req_payload(r) for r in self.queue],
            "pool": self.pool.snapshot_meta(),
        }}
        ckpt.save(step, self.pool.state, extra=extra, block=block)
        return step

    @torch.inference_mode()
    def restore(self, ckpt, step: int | None = None) -> list[Request]:
        """Load a :meth:`snapshot` into THIS engine (same pool geometry,
        sampler and seed; a different (sampler, seed) would change every
        resumed stream). Every check (identity, geometry, each leaf's
        shape and dtype) runs before anything is written. The state is
        copied into the existing tensors in place, never rebound: graphs
        captured before the restore replay on it. Returns the re-queued
        requests, which resume as prefix hits."""
        manifest = ckpt.manifest(step)
        meta = manifest["extra"]["serving"]
        if (meta["sampler"], meta["seed"]) != (self.sampler, self.seed):
            raise ValueError(
                f"snapshot sampler/seed ({meta['sampler']!r}, "
                f"{meta['seed']}) != engine ({self.sampler!r}, "
                f"{self.seed}): restored streams would diverge")
        self.pool.check_geometry(meta["pool"]["geometry"])
        ckpt.restore(manifest["step"], self.pool.state)
        self.pool.restore_meta(meta["pool"])
        self.queue.clear()
        restored = []
        for d in meta["requests"]:
            r = Request(rid=d["rid"], prompt=list(d["prompt"]),
                        max_new_tokens=d["max_new_tokens"],
                        temp=d["temp"], top_k=d["top_k"],
                        priority=d["priority"],
                        deadline_ms=d["deadline_ms"])
            r.out_tokens = list(d["out_tokens"])
            r.eff_prompt = list(r.prompt) + list(r.out_tokens)
            r.preemptions = d["preemptions"]
            r.seq = d["seq"]
            r.submitted_t = d["submitted_t"]
            r.first_token_t = d["first_token_t"]
            r.arrival_tick = 0          # admissible immediately
            self.queue.append(r)
            restored.append(r)
        self._seq = max([r.seq for r in restored], default=-1) + 1
        return restored

    # -------------------------------------------------------------- metrics
    def metrics(self, done: list[Request]) -> dict:
        toks = sum(len(r.out_tokens) for r in done)
        ttfts = [r.ttft_s for r in done if r.out_tokens]
        tpots = [r.tpot_s for r in done if len(r.out_tokens) > 1]
        return {
            "requests": len(done),
            "new_tokens": toks,
            "ticks": self.tick_count,
            "dispatches": self.dispatch_count,
            "decode_steps": self.decode_steps,
            "decode_dispatches": self.decode_dispatch_count,
            "decode_tokens": self.decode_token_count,
            "tokens_per_dispatch": round(
                self.decode_token_count
                / max(self.decode_dispatch_count, 1), 2),
            "mixed_dispatches": self.mixed_dispatch_count,
            "mixed_prompt_tokens": self.mixed_prompt_token_count,
            "mixed_decode_tokens": self.mixed_decode_token_count,
            # pure + mixed megaticks per decode token: <= 1/K at steady
            # state, prefill in flight or not
            "decode_dispatches_per_token": round(
                (self.decode_dispatch_count + self.mixed_dispatch_count)
                / max(self.decode_token_count
                      + self.mixed_decode_token_count, 1), 4),
            "scan_steps": self.scan_steps,
            **(self._runner.metrics() if self._runner is not None
               else {"graphs": False}),
            "scheduler": self.policy.name,
            "preemptions": self.preempt_count,
            "cancellations": self.cancel_count,
            "blocks_freed_on_abort": self.blocks_freed_on_abort,
            # the robustness counters, keyed as in the JAX engine
            "faults_injected": (self.faults.injected
                                if self.faults is not None else 0),
            "dispatch_retries": self.dispatch_retry_count,
            "dispatch_failures": self.dispatch_failure_count,
            "errors": self.error_count,
            "slow_ticks": self.slow_tick_count,
            "degraded_mode": (self.degraded.level
                              if self.degraded is not None else 0),
            "degraded_transitions": (self.degraded.transitions
                                     if self.degraded is not None else 0),
            "drained_requests": self.drain_count,
            "graph_capture_ticks": self.graph_capture_ticks,
            **latency_summary(ttfts, "ttft"),
            **latency_summary(tpots, "tpot"),
            **self.pool.metrics(),
        }
