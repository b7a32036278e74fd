"""Async streaming serving front end over the port's continuous-batching
engine (port of ``repro.launch.server``; the same ``Server`` and wire
protocol).

The engine runs behind an asyncio intake loop with OpenAI-style
server-sent events (SSE), per-request cancellation, request timeouts and
admission backpressure.

Architecture (one process, two threads):

* the EVENT-LOOP thread owns every Python-side structure: HTTP handlers
  validate and enqueue work, the drive loop applies intake,
  cancellations and timeouts between dispatches and flushes tokens to
  the per-request stream queues;
* ``Engine.tick`` (the dispatch, and on the card the graph captures
  and replays) runs on a dedicated single-worker EXECUTOR thread, which
  makes the engine's CUDA device its current one first (``--devices
  cuda:1`` is not the thread's default). The two threads never touch the
  engine concurrently: the event loop only mutates it between awaited
  ticks, so it issues no CUDA call while a tick is in flight (the
  metrics it serves are host-side counters; cancel, snapshot and the
  drain's checkpoint run between ticks). The engine's state-writing
  paths run under ``torch.inference_mode()`` on whichever thread calls
  them.

The wire protocol is stdlib-only (asyncio streams and a minimal
HTTP/1.1 parser).

Endpoints:

* ``POST /v1/completions``: body ``{"prompt": [ints],
  "max_new_tokens": N, "stream": true, "temp": t, "top_k": k,
  "timeout_s": s, "priority": p, "deadline_ms": d}``. With ``stream:
  true`` (default) the response is an SSE stream flushed at MEGATICK
  BOUNDARIES: the tokens one ``Engine.tick`` generated for a request go
  out as ONE ``completion.chunk`` event with ``delta.token_ids`` (a
  K-step megatick gives one event per up to K tokens). The final event
  carries ``finish_reason`` ("length", "cancelled" or "timeout") and a
  ``usage`` block, then the ``data: [DONE]`` sentinel. With ``stream:
  false`` the response is one JSON body after completion.
* ``DELETE /v1/completions/{id}``: cancel a live request at the next
  megatick boundary through ``Engine.cancel`` -> ``CachePool.abort``
  (the victim's blocks are re-allocatable at once; registered prefix
  chunks stay LRU-resident). Closing the SSE socket mid-stream cancels
  the same way.
* ``GET /v1/metrics``: the engine metrics taken at the last megatick
  boundary, with the server's ``server_tick_failures``, ``draining``
  and ``broken``.
* ``GET /healthz``: liveness and queue depth (200 while the process is
  up).
* ``GET /readyz``: 200 while accepting work, 503 once the server is
  DRAINING, the degraded ladder has reached load-shed, or a tick broke
  the engine (``broken`` names the error).
* ``POST /admin/drain``: intake stops (503 + ``Retry-After``),
  in-flight requests get ``drain_grace_s`` to finish, then what is
  still unfinished is checkpointed through ``Engine.snapshot``
  (``--checkpoint-dir``) and its streams end with an ``error`` event
  naming the step. A server started with ``--resume`` re-admits every
  checkpointed request as a PREFIX HIT. SIGTERM takes the same path
  (:class:`repro_torch.distributed.fault_tolerance.PreemptionGuard`).

Failure containment: a tick that raises ``DispatchFailedError`` (the
bounded retry gave up before anything launched, so the state is
intact) fails the REQUESTS, not the server: every live stream gets an
SSE ``error`` event and the drive loop keeps serving. Any other
exception from a tick (on the card, for example a sticky CUDA error)
may have left the in-place decode state or the CUDA context broken:
every stream gets an ``error`` event, ``/readyz`` and new requests get
503 and the drive loop stops, so an orchestrator replaces the process.
A request the engine retires with ``finish_reason="error"`` (poisoned
logits) ends its own stream with an ``error`` event; co-batched streams
go on token-identically. The ``socket`` fault site force-closes one
live stream.

Error mapping at the API edge: empty or malformed prompt -> 400, prompt
too long for ``max_len`` or for the whole block pool -> 400, malformed
JSON -> 400, admission queue full or shedding -> 429, draining or a
broken engine -> 503, unknown route -> 404.

The mesh is JAX's (``launch.mesh.make_mesh``): the ranks ``--devices``
lists as (data = n // tp, model = tp); on every mesh of more than one
rank the engine serves each rank's shards, born sharded, as
``launch.serve`` does (``launch.serve.serving_params``).

    PYTHONPATH=src python -m repro_torch.launch.server --arch llama3-8b \
        --port 8008 --decode-steps 8                  # on the card
    PYTHONPATH=src python -m repro_torch.launch.server --arch llama3-8b \
        --smoke --device cpu --port 8008 --chaos-seed 1 --degraded \
        --checkpoint-dir /tmp/ckpt                    # then --resume
"""
from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import dataclasses
import json
import os
import sys
import time
import traceback
from collections import deque

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.distributed.fault_tolerance import PreemptionGuard
from repro_torch.serving.engine import Request
from repro_torch.serving.faults import DispatchFailedError

SSE_HEADERS = (b"HTTP/1.1 200 OK\r\n"
               b"Content-Type: text/event-stream\r\n"
               b"Cache-Control: no-cache\r\n"
               b"Connection: close\r\n\r\n")

FINISH_LENGTH = "length"          # max_new_tokens reached / cache full
FINISH_CANCELLED = "cancelled"    # user hung up or DELETE'd the stream
FINISH_TIMEOUT = "timeout"        # server-side request timeout fired
FINISH_ERROR = "error"            # engine retired the slot (see faults)


@dataclasses.dataclass
class StreamHandle:
    """Event-loop-side view of one in-flight request: the engine's
    ``Request`` plus the SSE event queue and flush watermark."""
    rid: int
    req: object                       # repro_torch.serving.engine.Request
    events: asyncio.Queue
    deadline: float | None = None     # monotonic cancel-by time
    sent: int = 0                     # out_tokens already flushed
    finished: bool = False

    def push(self, kind: str, payload) -> None:
        self.events.put_nowait((kind, payload))


class Server:
    """Asyncio front end over one
    :class:`repro_torch.serving.engine.Engine`.

    ``max_queue`` bounds the ADMISSION queue (requests accepted but not
    yet running): intake beyond it is refused with HTTP 429 so bursty
    open-loop traffic sheds load instead of growing an unbounded deque
    (running requests are already bounded by the engine's slot count).

    ``timeout_s`` is the default per-request wall-clock budget from
    accept to finish; a request body may override it (``timeout_s``
    field, ``null`` disables). Expiry cancels through the same abort
    path as a hang-up and ends the stream with ``finish_reason:
    "timeout"``.

    ``idle_poll_s`` is the drive loop's sleep granularity when the
    engine is empty — it bounds how stale a timeout check can go while
    idle, and nothing else (intake wakes the loop immediately).
    """

    def __init__(self, engine, *, host: str = "127.0.0.1", port: int = 0,
                 max_queue: int = 64, timeout_s: float | None = None,
                 idle_poll_s: float = 0.05, guard=None,
                 ckpt_dir: str | None = None, drain_grace_s: float = 5.0):
        self.engine = engine
        self.host = host
        self.port = port
        self.max_queue = int(max_queue)
        self.timeout_s = timeout_s
        self.idle_poll_s = idle_poll_s
        self.guard = guard                  # PreemptionGuard (or None)
        self.ckpt_dir = ckpt_dir            # drain checkpoints land here
        self.drain_grace_s = float(drain_grace_s)
        self._intake: deque = deque()       # handles awaiting submit
        self._cancels: deque = deque()      # (rid, finish_reason)
        self._inflight: dict[int, StreamHandle] = {}
        self._done: list = []               # finished (not aborted) reqs
        # a restored engine already holds requests with live rids: new
        # accepts must not collide with resumed streams
        self._next_rid = max((r.rid for r in engine.queue), default=-1) + 1
        self._queued = 0                    # engine-queue depth snapshot
        self._metrics: dict = {}
        self._wake = asyncio.Event()
        self._stopping = False
        self._draining = False
        self._drain_deadline = 0.0
        self._drained_step: int | None = None
        self.tick_failures = 0              # megaticks that raised
        self._broken: str | None = None     # why the engine is unusable
        self._server: asyncio.AbstractServer | None = None
        self._drive_task: asyncio.Task | None = None
        # ONE worker: the engine is single-owner — the executor thread
        # runs at most one tick at a time, and the event loop only
        # touches the engine between awaited ticks
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, initializer=_use_device,
            initargs=(engine.device,))

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._drive_task = asyncio.create_task(self._drive())

    async def stop(self) -> None:
        self._stopping = True
        self._wake.set()
        if self._drive_task is not None:
            await self._drive_task
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self._exec.shutdown(wait=True)

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # ----------------------------------------------------------- drive loop
    async def _drive(self) -> None:
        """Pump the engine: apply queued intake/cancels/timeouts between
        dispatches, run ``Engine.tick`` on the executor thread, flush
        new tokens to the streams. One iteration == one megatick."""
        loop = asyncio.get_running_loop()
        while not self._stopping:
            if not self._draining and self.guard is not None \
                    and self.guard.preempted:
                self._begin_drain()
            busy = self._drive_once_host()
            if self._draining and (not busy or time.monotonic()
                                   >= self._drain_deadline):
                self._finish_drain()
                return
            if busy:
                try:
                    await self._tick(loop)
                except Exception as e:      # noqa: BLE001 — containment
                    traceback.print_exception(e, file=sys.stderr)
                    self._break(e)
                    return
            else:
                self._wake.clear()
                if not (self._intake or self._cancels):
                    try:
                        await asyncio.wait_for(self._wake.wait(),
                                               self.idle_poll_s)
                    except asyncio.TimeoutError:
                        pass

    async def _tick(self, loop) -> None:
        """One ``Engine.tick`` on the executor thread, then the flush. A
        ``DispatchFailedError`` (the retry budget ran out before
        anything launched, so the state is intact) fails the REQUESTS
        and the server serves on; any other exception propagates to
        :meth:`_drive`."""
        try:
            finished = await loop.run_in_executor(self._exec,
                                                  self.engine.tick)
        except DispatchFailedError as e:
            traceback.print_exception(e, file=sys.stderr)
            self._fail_tick(e)
            return
        self._flush(finished)

    def _drive_once_host(self) -> bool:
        """The host-side half of one drive iteration, BETWEEN ticks:
        submit accepted requests, apply cancellations and expired
        timeouts, refresh the queue-depth snapshot. Returns whether the
        engine has work for a tick. The async layer itself never
        dispatches or reads the device back."""
        self._apply_intake()
        aborted = self._apply_timeouts() + self._apply_cancels()
        if aborted:
            # no tick may follow (the abort can drain the engine), so
            # the metrics snapshot must pick up the abort counters here
            self._refresh_metrics()
        self._queued = len(self.engine.queue)
        return bool(self.engine.queue or self.engine.active)

    def _refresh_metrics(self) -> None:
        self._metrics = dict(self.engine.metrics(self._done))
        self._metrics["server_tick_failures"] = self.tick_failures
        self._metrics["draining"] = self._draining
        self._metrics["broken"] = self._broken

    # ------------------------------------------------------ drain / failure
    def _begin_drain(self) -> None:
        """Stop intake, start the grace clock. In-flight requests keep
        ticking until they finish or the clock expires."""
        self._draining = True
        self._drain_deadline = time.monotonic() + self.drain_grace_s
        self._wake.set()

    def _finish_drain(self) -> None:
        """End of grace: checkpoint whatever is still unfinished (so a
        restarted server resumes it as prefix hits), then end the
        surviving streams with an error event naming the step."""
        step = None
        if self.ckpt_dir is not None \
                and (self.engine.queue or self.engine.active):
            step = self.engine.snapshot(
                Checkpointer(self.ckpt_dir), block=True)
        self._drained_step = step
        msg = "server draining"
        if step is not None:
            msg += (f"; state checkpointed at step {step} — resubmit "
                    f"after restart to resume as a prefix hit")
        for h in list(self._inflight.values()):
            if not h.finished:
                self._fail(h, msg)
        self._refresh_metrics()

    def _fail_tick(self, err: Exception) -> None:
        """A megatick gave up before launching anything: retire every
        live request with an SSE error event (through the engine's
        abort path, so their blocks free) and keep the drive loop
        alive. An exception from the abort path propagates."""
        self.tick_failures += 1
        for h in list(self._inflight.values()):
            if h.finished:
                continue
            self.engine.cancel(h.rid)
            self._fail(h, f"megatick failed: {err}")
        self._refresh_metrics()

    def _break(self, err: Exception) -> None:
        """A tick raised something other than ``DispatchFailedError``
        (on the card, for example a sticky CUDA error), or failing its
        requests did. The engine writes its state in place, so that
        state can no longer be trusted: end every stream with an SSE
        error event without touching the engine, answer ``/readyz`` and
        new requests with 503 and stop ticking."""
        self.tick_failures += 1
        self._broken = f"{type(err).__name__}: {err}"
        for h in list(self._intake) + list(self._inflight.values()):
            if not h.finished:
                self._fail(h, f"engine failed: {self._broken}")
        self._intake.clear()
        self._metrics.update(server_tick_failures=self.tick_failures,
                             broken=self._broken)

    def _fail(self, h: StreamHandle, msg: str) -> None:
        h.finished = True
        h.push("error", msg)
        self._inflight.pop(h.rid, None)

    def _apply_intake(self) -> None:
        while self._intake:
            h = self._intake.popleft()
            try:
                self.engine.submit(h.req)
            except ValueError as e:
                # validation raced past the edge checks (shouldn't
                # happen — the handler pre-validates); surface as an
                # error event, never a crashed drive loop
                h.finished = True
                h.push("error", str(e))
                continue
            self._inflight[h.rid] = h

    def _apply_cancels(self) -> int:
        n = 0
        while self._cancels:
            rid, reason = self._cancels.popleft()
            h = self._inflight.get(rid)
            if h is None or h.finished:
                continue
            self.engine.cancel(rid)
            self._finish(h, reason)
            n += 1
        return n

    def _apply_timeouts(self) -> int:
        now = time.monotonic()
        expired = [h for h in self._inflight.values()
                   if h.deadline is not None and now >= h.deadline
                   and not h.finished]
        for h in expired:
            self.engine.cancel(h.rid)
            self._finish(h, FINISH_TIMEOUT)
        return len(expired)

    def _flush(self, finished) -> None:
        """Megatick-boundary flush: every token the tick produced goes
        out NOW, one event per request per tick (tokens are buffered
        per-request between ticks by construction — the wire chunking
        mirrors the megatick, not a fake per-token stream)."""
        for h in self._inflight.values():
            new = h.req.out_tokens[h.sent:]
            if new:
                h.sent = len(h.req.out_tokens)
                h.push("tokens", list(new))
        for req in finished:
            h = self._inflight.get(req.rid)
            if h is None:
                # orphan: a dropped-socket victim or a restored request
                # with no reconnected stream — the work still counts
                self._done.append(req)
            elif not h.finished:
                self._done.append(req)
                if req.finish_reason == FINISH_ERROR:
                    # poisoned slot: the engine retired THIS request
                    # through the abort path; its co-batched neighbours
                    # stream on token-identically
                    self._fail(h, req.error or "request failed")
                else:
                    self._finish(h, req.finish_reason or FINISH_LENGTH)
        self._drop_socket_fault()
        self._refresh_metrics()

    def _drop_socket_fault(self) -> None:
        """The one fault site the ENGINE cannot inject: a mid-stream
        socket drop. When the engine's FaultPlan schedules one for this
        tick, force-close a live SSE connection without the [DONE]
        sentinel — the client sees a reset and retries; the request
        itself keeps running and finishes as an orphan (its KV stays
        prefix-registered, so the retry is a hit, not a recompute)."""
        faults = getattr(self.engine, "faults", None)
        if faults is None or not self._inflight:
            return
        spec = faults.poll("socket", self.engine.tick_count)
        if spec is None:
            return
        rid = spec.rid if spec.rid is not None \
            else min(self._inflight)
        h = self._inflight.get(rid)
        if h is not None and not h.finished:
            h.finished = True
            h.push("drop", None)
            self._inflight.pop(h.rid, None)

    def _finish(self, h: StreamHandle, reason: str) -> None:
        h.finished = True
        h.push("done", reason)
        self._inflight.pop(h.rid, None)

    # -------------------------------------------------------- handler edge
    def _accept(self, body: dict) -> StreamHandle | tuple[int, str]:
        """Validate + enqueue one completion request on the event-loop
        thread. Returns a StreamHandle, or (http_status, message) on
        refusal. Validation happens HERE, at the API edge, so the
        engine's loud ValueErrors surface as 4xx instead of a broken
        stream (and never reach the drive loop at all)."""
        if self._draining or self._broken:
            why = "draining" if self._draining else "engine failed"
            return 503, (f"server {why}; retry against a fresh "
                         f"instance")
        if getattr(self.engine, "shedding", False):
            # degraded-mode ladder hit load-shed: refuse with the same
            # retryable status as a full queue
            return 429, "server overloaded (degraded mode); retry later"
        prompt = body.get("prompt")
        if not isinstance(prompt, list) or not prompt \
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in prompt):
            return 400, "prompt must be a non-empty list of token ids"
        eng = self.engine
        if len(prompt) >= eng.max_len:
            return 400, (f"prompt length {len(prompt)} >= max_len "
                         f"{eng.max_len}")
        if not eng.pool.admissible(len(prompt)):
            return 400, (f"prompt length {len(prompt)} needs more KV "
                         f"blocks than the whole pool holds")
        if len(self._intake) + self._queued >= self.max_queue:
            return 429, (f"admission queue full "
                         f"({self.max_queue} waiting); retry later")
        max_new = int(body.get("max_new_tokens", 16))
        if max_new < 1:
            return 400, "max_new_tokens must be >= 1"
        timeout = body.get("timeout_s", self.timeout_s)
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=[int(t) for t in prompt],
                      max_new_tokens=max_new,
                      temp=float(body.get("temp", 1.0)),
                      top_k=int(body.get("top_k", 0)),
                      priority=int(body.get("priority", 0)),
                      deadline_ms=body.get("deadline_ms"))
        h = StreamHandle(rid=rid, req=req, events=asyncio.Queue(),
                         deadline=(time.monotonic() + float(timeout)
                                   if timeout is not None else None))
        self._intake.append(h)
        self._wake.set()
        return h

    def request_cancel(self, rid: int,
                       reason: str = FINISH_CANCELLED) -> bool:
        """Queue a cancellation; applied at the next megatick boundary.
        True if the rid is currently live (queued-for-intake or
        in-flight)."""
        for h in self._intake:
            if h.rid == rid and not h.finished:
                h.finished = True
                h.push("done", reason)
                try:
                    self._intake.remove(h)
                except ValueError:
                    pass
                return True
        h = self._inflight.get(rid)
        if h is None or h.finished:
            return False
        self._cancels.append((rid, reason))
        self._wake.set()
        return True

    # ------------------------------------------------------------- protocol
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            method, target, headers = await _read_request_head(reader)
            if method is None:
                return
            body = b""
            n = int(headers.get("content-length", "0") or 0)
            if n:
                body = await reader.readexactly(n)
            await self._route(method, target, body, reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _route(self, method, target, body, reader, writer) -> None:
        path = target.split("?", 1)[0]
        if method == "POST" and path == "/v1/completions":
            await self._handle_completion(body, reader, writer)
        elif method == "DELETE" \
                and path.startswith("/v1/completions/"):
            await self._handle_cancel(path, writer)
        elif method == "GET" and path == "/v1/metrics":
            await _send_json(writer, 200, dict(self._metrics))
        elif method == "GET" and path == "/healthz":
            await _send_json(writer, 200, {
                "ok": True,
                "queued": self._queued + len(self._intake),
                "inflight": len(self._inflight),
                "max_queue": self.max_queue,
            })
        elif method == "GET" and path == "/readyz":
            shedding = bool(getattr(self.engine, "shedding", False))
            ready = not (self._draining or shedding or self._broken)
            await _send_json(writer, 200 if ready else 503, {
                "ready": ready,
                "draining": self._draining,
                "broken": self._broken,
                "shedding": shedding,
                "drained_step": self._drained_step,
            })
        elif method == "POST" and path == "/admin/drain":
            if self.guard is not None:
                self.guard.trigger()        # same path as SIGTERM
            elif not self._draining:
                self._begin_drain()
            self._wake.set()
            await _send_json(writer, 200, {
                "draining": True,
                "grace_s": self.drain_grace_s,
                "checkpoint_dir": self.ckpt_dir,
            })
        else:
            await _send_json(writer, 404,
                             {"error": f"no route {method} {path}"})

    async def _handle_cancel(self, path: str, writer) -> None:
        tail = path.rsplit("/", 1)[-1]
        try:
            rid = int(tail)
        except ValueError:
            await _send_json(writer, 400,
                             {"error": f"bad request id {tail!r}"})
            return
        if self.request_cancel(rid):
            await _send_json(writer, 200,
                             {"id": rid, "status": "cancelling"})
        else:
            await _send_json(writer, 404,
                             {"error": f"no live request {rid}"})

    async def _handle_completion(self, body, reader, writer) -> None:
        try:
            payload = json.loads(body.decode() or "{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, UnicodeDecodeError) as e:
            await _send_json(writer, 400, {"error": f"bad JSON body: {e}"})
            return
        got = self._accept(payload)
        if isinstance(got, tuple):
            status, msg = got
            # shed responses carry Retry-After so well-behaved clients
            # (serving/client.py) back off instead of hammering
            hdrs = {"Retry-After": "1"} if status in (429, 503) else None
            await _send_json(writer, status, {"error": msg},
                             headers=hdrs)
            return
        h = got
        if payload.get("stream", True):
            await self._stream_response(h, reader, writer)
        else:
            await self._json_response(h, writer)

    async def _stream_response(self, h: StreamHandle, reader,
                               writer) -> None:
        """SSE loop: one ``completion.chunk`` event per megatick that
        produced tokens for this request, then the finish event and the
        ``[DONE]`` sentinel. A client that goes away mid-stream (socket
        EOF / reset) cancels the request through the same abort path as
        an explicit DELETE."""
        writer.write(SSE_HEADERS)
        await writer.drain()
        # the request head is fully consumed: any read completing now
        # means the client hung up (EOF or reset)
        hangup = asyncio.create_task(reader.read(1))
        try:
            while True:
                getter = asyncio.create_task(h.events.get())
                done, _ = await asyncio.wait(
                    {getter, hangup},
                    return_when=asyncio.FIRST_COMPLETED)
                if getter not in done:       # client hung up first
                    getter.cancel()
                    self.request_cancel(h.rid)
                    return
                kind, payload = getter.result()
                if kind == "tokens":
                    await _send_event(writer, _chunk_event(h, payload))
                elif kind == "drop":
                    # injected socket fault: force-close mid-stream,
                    # no finish event, no [DONE] — the client's retry
                    # path owns recovery from here
                    return
                elif kind == "error":
                    await _send_event(writer, {"id": f"cmpl-{h.rid}",
                                               "error": payload})
                    await _send_done(writer)
                    return
                else:                        # ("done", finish_reason)
                    await _send_event(writer, _finish_event(h, payload))
                    await _send_done(writer)
                    return
        except (ConnectionError, OSError):
            self.request_cancel(h.rid)
        finally:
            if not hangup.done():
                hangup.cancel()

    async def _json_response(self, h: StreamHandle, writer) -> None:
        """stream=false: wait for the request to finish, answer once."""
        finish = None
        while finish is None:
            kind, payload = await h.events.get()
            if kind == "drop":               # injected socket fault
                return
            if kind in ("done", "error"):
                finish = payload if kind == "done" else "error"
        await _send_json(writer, 200, {
            "id": f"cmpl-{h.rid}",
            "object": "completion",
            "token_ids": list(h.req.out_tokens),
            "finish_reason": finish,
            "usage": _usage(h),
        })


def _use_device(device) -> None:
    """The executor thread's initializer: the engine's CUDA device becomes
    the thread's current one."""
    if device.type == "cuda":
        torch.cuda.set_device(device)


# ------------------------------------------------------------- wire helpers
async def _read_request_head(reader):
    line = await reader.readline()
    if not line:
        return None, None, None
    try:
        method, target, _ = line.decode("latin-1").split(" ", 2)
    except ValueError:
        return None, None, None
    headers = {}
    while True:
        hline = await reader.readline()
        if hline in (b"\r\n", b"\n", b""):
            break
        k, _, v = hline.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return method, target, headers


def _usage(h: StreamHandle) -> dict:
    return {"prompt_tokens": len(h.req.prompt),
            "completion_tokens": len(h.req.out_tokens)}


def _chunk_event(h: StreamHandle, token_ids) -> dict:
    return {"id": f"cmpl-{h.rid}", "object": "completion.chunk",
            "choices": [{"index": 0,
                         "delta": {"token_ids": list(token_ids)},
                         "finish_reason": None}]}


def _finish_event(h: StreamHandle, reason: str) -> dict:
    return {"id": f"cmpl-{h.rid}", "object": "completion.chunk",
            "choices": [{"index": 0, "delta": {"token_ids": []},
                         "finish_reason": reason}],
            "usage": _usage(h)}


async def _send_event(writer, obj: dict) -> None:
    writer.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
    await writer.drain()


async def _send_done(writer) -> None:
    writer.write(b"data: [DONE]\n\n")
    await writer.drain()


async def _send_json(writer, status: int, obj: dict,
                     headers: dict | None = None) -> None:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              429: "Too Many Requests",
              503: "Service Unavailable"}.get(status, "Error")
    body = json.dumps(obj).encode()
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    writer.write(f"HTTP/1.1 {status} {reason}\r\n"
                 f"Content-Type: application/json\r\n"
                 f"Content-Length: {len(body)}\r\n{extra}"
                 f"Connection: close\r\n\r\n".encode() + body)
    await writer.drain()


# --------------------------------------------------------------------- CLI
def build_engine(args):
    """Model, mesh and Engine from the CLI args, as
    ``repro_torch.launch.serve`` builds them (seeded random weights),
    with the fault plan, the degraded ladder and ``--resume``. Under
    torchrun (``WORLD_SIZE`` > 1) it refuses before any parameter is
    drawn: the server does not join the job yet."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.distributed import context as dctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serving_params
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.faults import FaultPlan

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise NotImplementedError(
            f"the server under torchrun ({world} processes): each process "
            f"would serve alone; not yet (ROADMAP queue 1, item 4: the "
            f"server joins the job); serve over processes with "
            f"repro_torch.launch.serve")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    mesh = make_mesh(args.tp, args.devices, args.device)
    ctx = dctx.DistContext(mesh if mesh.size > 1 else None,
                           args.fusion_mode)
    params, _ = serving_params(cfg, mesh, args.seed)
    fault_plan = None
    if args.chaos_plan:
        with open(args.chaos_plan) as f:
            fault_plan = FaultPlan.from_json(f.read())
    elif args.chaos_seed is not None:
        fault_plan = FaultPlan.seeded(args.chaos_seed, args.chaos_ticks,
                                      batch=args.batch)
    with dctx.use(ctx):
        engine = Engine(params, cfg, batch=args.batch, max_len=args.max_len,
                        prefill_chunk=args.prefill_chunk,
                        sampler=args.sampler, seed=args.seed,
                        block_size=args.block_size, n_blocks=args.kv_blocks,
                        scheduler=args.scheduler,
                        decode_steps=args.decode_steps,
                        megatick_token_budget=args.megatick_token_budget,
                        bounded_gather=args.paged_gather == "bounded",
                        fault_plan=fault_plan, degraded=args.degraded,
                        device=mesh.devices[0])
    if args.resume and args.checkpoint_dir:
        ckpt = Checkpointer(args.checkpoint_dir)
        if ckpt.latest_step() is not None:
            restored = engine.restore(ckpt)
            print(f"[server] restored {len(restored)} request(s) from "
                  f"{args.checkpoint_dir} step {ckpt.latest_step()} — "
                  f"resuming as prefix hits", flush=True)
    return engine


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="async SSE serving front-end over the "
                    "continuous-batching engine")
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the model runs; cpu runs the kernels' "
                        "plain PyTorch versions")
    p.add_argument("--devices", default=None,
                   help="comma-separated device per rank (default: every "
                        "rank on --device, i.e. virtual ranks)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8008,
                   help="TCP port (0 = ephemeral; printed on boot)")
    p.add_argument("--max-queue", type=int, default=64,
                   help="admission-queue bound: intake beyond this is "
                        "refused with HTTP 429 (backpressure instead "
                        "of unbounded growth)")
    p.add_argument("--timeout-s", type=float, default=None,
                   help="default per-request wall-clock budget; expiry "
                        "cancels through the abort path "
                        "(finish_reason: timeout)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--prefill-chunk", type=int, default=8)
    p.add_argument("--decode-steps", type=int, default=4,
                   help="decode megatick length K — SSE chunks flush "
                        "at megatick boundaries, so this is also the "
                        "streaming granularity")
    p.add_argument("--megatick-token-budget", type=int, default=None)
    p.add_argument("--sampler", default="greedy",
                   choices=("greedy", "temperature"))
    p.add_argument("--scheduler", default="fcfs",
                   choices=("fcfs", "priority", "slo"))
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--kv-blocks", type=int, default=None)
    p.add_argument("--paged-gather", default="bounded",
                   choices=("bounded", "masked"),
                   help="W > 1 paged decode: walk each slot's table "
                        "(bounded) or score the masked pool shard "
                        "(masked; the CPU oracle, raises on the card)")
    p.add_argument("--fusion-mode", default="auto",
                   choices=("auto", "bsp", "ring", "pallas"))
    p.add_argument("--tp", type=int, default=1,
                   help="ranks of the model axis")
    p.add_argument("--seed", type=int, default=0)
    # ------------------------------------------------------- robustness
    p.add_argument("--chaos-seed", type=int, default=None,
                   help="seed a deterministic FaultPlan (replayable "
                        "chaos: dispatch/tokens/pool/slow/socket "
                        "faults)")
    p.add_argument("--chaos-ticks", type=int, default=64,
                   help="tick horizon for --chaos-seed plans")
    p.add_argument("--chaos-plan", default=None,
                   help="JSON FaultPlan file (FaultPlan.to_json) — "
                        "overrides --chaos-seed")
    p.add_argument("--checkpoint-dir", default=None,
                   help="where a graceful drain snapshots unfinished "
                        "serving state (and --resume restores it)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest serving snapshot from "
                        "--checkpoint-dir on boot: unfinished requests "
                        "re-run as prefix hits")
    p.add_argument("--drain-grace-s", type=float, default=5.0,
                   help="grace window after SIGTERM / POST "
                        "/admin/drain before unfinished requests are "
                        "checkpointed and their streams errored out")
    p.add_argument("--degraded", action="store_true",
                   help="enable the degraded-mode ladder (halve K, "
                        "K = 1, shed) on sustained slow-tick/retry/error "
                        "streaks")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    engine = build_engine(args)
    guard = PreemptionGuard().install()

    async def _run():
        server = Server(engine, host=args.host, port=args.port,
                        max_queue=args.max_queue,
                        timeout_s=args.timeout_s, guard=guard,
                        ckpt_dir=args.checkpoint_dir,
                        drain_grace_s=args.drain_grace_s)
        await server.start()
        print(f"[server] listening on http://{server.host}:{server.port} "
              f"(arch={args.arch}, K={args.decode_steps}, "
              f"batch={args.batch}, max_queue={args.max_queue})",
              flush=True)
        assert server._server is not None
        async with server._server:
            # the drive task ends itself when a drain completes; keep
            # serving /readyz 503s until the orchestrator reaps us
            await server._server.serve_forever()

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
