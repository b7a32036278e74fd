"""Continuous-batching serving engine over paged KV (port of
``repro.serving.engine``, single-step path).

Scheduling per tick, as in the JAX engine with ``decode_steps=1``:

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
   ``lm.decode_chunk`` — then greedy sampling on the card and ONE
   readback of the (B, 1) token ids; finished requests retire.

Everything on the card runs under ``torch.inference_mode()``. The decode
state (KV pools, ``cur_len``, block table) is updated in place.

Not in this slice (each raises ``NotImplementedError``): megaticks
(``decode_steps > 1``), the seeded temperature sampler, the robustness
plane (fault plans, watchdog, degraded ladder, drain, snapshot/restore).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving import sampler as sampler_lib
from repro_torch.serving.kv_cache import CachePool, pow2_bucket
from repro_torch.serving.metrics import latency_summary
from repro_torch.serving.scheduler import SchedulerPolicy, get_scheduler


def _later(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch engine yet ({slice_name} "
        f"slice); this slice serves decode_steps=1 with greedy sampling")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    arrival_tick: int = 0            # earliest tick it may be admitted
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
    """

    def __init__(self, params, cfg, *, batch: int = 8, max_len: int = 512,
                 prefill_chunk: int = 8, sampler: str = "greedy",
                 block_size: int = 16,
                 n_blocks: int | None = None,
                 scheduler: str | SchedulerPolicy = "fcfs",
                 decode_steps: int = 1, fault_plan=None, watchdog=None,
                 degraded=None, device="cuda"):
        if sampler == "temperature":
            raise _later("sampler='temperature' (bit-exact threefry)",
                         "sampler")
        if sampler != "greedy":
            raise ValueError(f"unknown sampler {sampler!r}: "
                             f"expected 'greedy' or 'temperature'")
        if decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, "
                             f"got {decode_steps}")
        if decode_steps > 1:
            raise _later("decode_steps > 1 (megaticks)", "megatick")
        if fault_plan is not None or watchdog is not None or degraded:
            raise _later("the robustness plane (fault_plan / watchdog / "
                         "degraded)", "robustness")
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params live on {params.device}, engine "
                             f"device is {self.device}")
        self.policy = get_scheduler(scheduler)   # fail fast, pre-pool-init
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}   # slot -> request
        self.pool = CachePool(params, cfg, batch, max_len,
                              block_size=block_size, n_blocks=n_blocks)
        self.decode_steps = 1
        self.tick_count = 0
        self.dispatch_count = 0     # ticks that actually ran a decode step
        self.preempt_count = 0
        self.cancel_count = 0
        self.blocks_freed_on_abort = 0
        self.decode_dispatch_count = 0   # dispatches with no slot prefilling
        self.decode_token_count = 0      # tokens those dispatches produced
        self.error_count = 0             # slots retired finish_reason=error
        self._seq = 0

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

    # ----------------------------------------------------------- scheduling
    def tick(self) -> list[Request]:
        """One scheduler step. Returns requests that finished this tick."""
        finished = self._tick()
        self.policy.on_tick_end(self.queue, self.active, self.tick_count)
        return finished

    def _tick(self) -> list[Request]:
        self._admit()
        self.tick_count += 1
        if not self.active:
            return []
        C = self.prefill_chunk
        tok = np.zeros((self.batch, C), np.int32)
        cnt = np.zeros((self.batch,), np.int32)
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
            else:
                tok[slot, 0] = (req.out_tokens[-1] if req.out_tokens
                                else req.eff_prompt[-1])
                cnt[slot] = 1

        cmax = int(cnt.max(initial=0))
        if cmax == 0:
            self._preempt_one()
            return []
        self.pool.sync()
        # gather width AFTER the writable() loop: this tick's allocations
        # are in the table, so the slice covers every position touched
        gw = self.pool.gather_width()
        self.dispatch_count += 1
        if not any_prefill:
            self.decode_dispatch_count += 1
        dev = self.device
        with torch.inference_mode():
            if cmax <= 1:
                logits, _ = lm.decode_step(
                    self.params, torch.from_numpy(tok[:, :1]).to(dev),
                    self.pool.state, self.cfg,
                    active=torch.from_numpy(cnt > 0).to(dev),
                    gather_width=gw)
            else:
                cw = pow2_bucket(cmax, C)
                logits, _ = lm.decode_chunk(
                    self.params, torch.from_numpy(tok[:, :cw]).to(dev),
                    torch.from_numpy(cnt).to(dev), self.pool.state,
                    self.cfg, gather_width=gw)
            nxt = self._next_tokens(logits)

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

    def _next_tokens(self, logits):
        """Greedy ids for every slot, sampled on the card."""
        ids = sampler_lib.greedy(logits)
        # (B, 1) ids drive the host-side scheduling; the logits stay put
        return ids.cpu().numpy()  # the once-per-dispatch readback

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
    def drain(self):
        raise _later("drain()", "robustness")

    def snapshot(self, ckpt, step=None, block=True):
        raise _later("snapshot()", "robustness")

    def restore(self, ckpt, step=None):
        raise _later("restore()", "robustness")

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
            "scheduler": self.policy.name,
            "preemptions": self.preempt_count,
            "cancellations": self.cancel_count,
            "blocks_freed_on_abort": self.blocks_freed_on_abort,
            "errors": self.error_count,
            **latency_summary(ttfts, "ttft"),
            **latency_summary(tpots, "tpot"),
            **self.pool.metrics(),
        }
