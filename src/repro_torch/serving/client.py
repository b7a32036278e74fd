"""Minimal asyncio client for the SSE serving front end (the port's copy
of ``repro.serving.client``, over ``repro_torch.launch.server``).

Stdlib-only (asyncio streams). The streaming path records per-event
wall-clock timestamps, so TTFT (submit -> first token event) and TPOT
(mean inter-token interval) come from what crossed the wire, not from
engine-internal stamps.

Retries: ``complete(..., retries=N)`` re-submits on exactly the
RETRYABLE outcomes (shed load, HTTP 429/503, honouring the server's
``Retry-After`` as a floor; a connection that failed or reset before the
stream finished; a per-attempt timeout) with capped exponential backoff
and FULL JITTER drawn from a seeded ``random.Random``, so a chaos run
replays the same wire schedule every time. A stream the CLIENT chose to
abandon (``hangup_after_tokens``) never retries, and ``retries=N`` means
at most N+1 submissions. Because a dropped request's KV stays
prefix-registered on the server, a retry re-streams as a prefix hit
rather than recomputing."""
from __future__ import annotations

import asyncio
import dataclasses
import json
import random
import time

from repro_torch.serving.faults import backoff_s


@dataclasses.dataclass
class Completion:
    """One completed (or refused/aborted) request as the client saw it."""
    status: int                       # HTTP status of the response
    id: int | None = None             # server-assigned request id
    token_ids: list = dataclasses.field(default_factory=list)
    finish_reason: str | None = None  # length / cancelled / timeout
    error: str | None = None
    events: list = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float | None = None      # first token event on the wire
    t_done: float | None = None
    retries: int = 0                  # re-submissions before this result
    retry_after: float | None = None  # server's Retry-After, if any

    @property
    def ok(self) -> bool:
        return self.status == 200 and self.error is None

    @property
    def ttft_s(self) -> float | None:
        if self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def tpot_s(self) -> float | None:
        """Mean inter-token time after the first token, from wire
        timestamps. None until >= 2 tokens arrived."""
        if self.t_first is None or self.t_done is None \
                or len(self.token_ids) <= 1:
            return None
        return (self.t_done - self.t_first) / (len(self.token_ids) - 1)


async def _open(host: str, port: int):
    return await asyncio.open_connection(host, port)


def _request_bytes(method: str, path: str, payload=None) -> bytes:
    body = b"" if payload is None else json.dumps(payload).encode()
    head = (f"{method} {path} HTTP/1.1\r\n"
            f"Host: localhost\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n")
    return head.encode() + body


async def _read_status_and_headers(reader) -> tuple[int, dict]:
    line = await reader.readline()
    status = int(line.decode("latin-1").split(" ", 2)[1])
    headers = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers


async def request_json(host: str, port: int, method: str, path: str,
                       payload=None) -> tuple[int, dict]:
    """One non-streaming HTTP exchange; returns (status, parsed body)."""
    reader, writer = await _open(host, port)
    try:
        writer.write(_request_bytes(method, path, payload))
        await writer.drain()
        status, headers = await _read_status_and_headers(reader)
        n = int(headers.get("content-length", "0") or 0)
        raw = await (reader.readexactly(n) if n else reader.read())
        body = json.loads(raw.decode() or "{}") if raw else {}
        return status, body
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def cancel(host: str, port: int, rid: int) -> tuple[int, dict]:
    """Explicit server-side cancel (DELETE /v1/completions/{rid})."""
    return await request_json(host, port, "DELETE",
                              f"/v1/completions/{rid}")


async def metrics(host: str, port: int) -> dict:
    _, body = await request_json(host, port, "GET", "/v1/metrics")
    return body


async def complete(host: str, port: int, prompt, *,
                   max_new_tokens: int = 16, stream: bool = True,
                   temp: float | None = None, top_k: int | None = None,
                   timeout_s: float | None = ...,
                   priority: int | None = None,
                   deadline_ms: float | None = None,
                   hangup_after_tokens: int | None = None,
                   on_event=None, retries: int = 0,
                   retry_base_s: float = 0.05, retry_cap_s: float = 2.0,
                   retry_seed: int = 0,
                   attempt_timeout_s: float | None = None) -> Completion:
    """POST /v1/completions and (by default) consume the SSE stream,
    re-submitting retryable failures up to ``retries`` times.

    ``timeout_s`` — pass ``None`` explicitly to disable the server's
    default; the ``...`` sentinel omits the field (server default
    applies). ``hangup_after_tokens`` — close the socket mid-stream
    after that many tokens have arrived, simulating a user hang-up
    (the server must cancel the request through the abort path).
    ``on_event`` — optional callback(event_dict) per SSE event.

    ``retries`` — max RE-submissions (total attempts = retries + 1) on
    HTTP 429/503 (``Retry-After`` honoured as the backoff floor),
    connect failure/reset, a stream severed before its finish event,
    or an ``attempt_timeout_s`` expiry. Backoff is capped exponential
    (``retry_base_s``/``retry_cap_s``) with full jitter from
    ``random.Random(retry_seed)`` — deterministic per seed, decorrelated
    across clients. The result's ``retries`` field reports how many
    re-submissions it took.
    """
    rng = random.Random(retry_seed)
    t0 = time.monotonic()
    attempts = max(1, int(retries) + 1)
    out = None
    for attempt in range(1, attempts + 1):
        try:
            coro = _complete_once(
                host, port, prompt, max_new_tokens=max_new_tokens,
                stream=stream, temp=temp, top_k=top_k,
                timeout_s=timeout_s, priority=priority,
                deadline_ms=deadline_ms,
                hangup_after_tokens=hangup_after_tokens,
                on_event=on_event)
            out = await (asyncio.wait_for(coro, attempt_timeout_s)
                         if attempt_timeout_s is not None else coro)
        except (ConnectionError, OSError, asyncio.IncompleteReadError,
                IndexError, ValueError) as e:
            out = Completion(status=0, error=f"connection failed: {e}")
        except asyncio.TimeoutError:
            out = Completion(
                status=0, error=f"attempt timed out after "
                                f"{attempt_timeout_s}s")
        out.retries = attempt - 1
        out.t_submit = t0               # TTFT spans retries truthfully
        if attempt == attempts \
                or not _retryable(out, hangup_after_tokens):
            return out
        floor = out.retry_after or 0.0
        await asyncio.sleep(max(
            floor, backoff_s(attempt, retry_base_s, retry_cap_s,
                             rng=rng)))
    return out


def _retryable(out: Completion,
               hangup_after_tokens: int | None) -> bool:
    """True for outcomes a re-submission can fix: shed load, a failed
    connection, or a stream severed before its finish event. A stream
    the client abandoned on purpose is not one of them."""
    if out.status in (429, 503):
        return True
    if out.status == 0:                 # connect failure / timeout
        return True
    if out.status == 200 and out.error is None \
            and out.finish_reason is None \
            and hangup_after_tokens is None:
        return True                     # severed mid-stream (EOF/reset)
    return False


async def _complete_once(host: str, port: int, prompt, *,
                         max_new_tokens: int = 16, stream: bool = True,
                         temp: float | None = None,
                         top_k: int | None = None,
                         timeout_s: float | None = ...,
                         priority: int | None = None,
                         deadline_ms: float | None = None,
                         hangup_after_tokens: int | None = None,
                         on_event=None) -> Completion:
    """One submission attempt — the pre-retry body of :func:`complete`."""
    payload = {"prompt": list(prompt), "max_new_tokens": max_new_tokens,
               "stream": stream}
    if temp is not None:
        payload["temp"] = temp
    if top_k is not None:
        payload["top_k"] = top_k
    if timeout_s is not ...:
        payload["timeout_s"] = timeout_s
    if priority is not None:
        payload["priority"] = priority
    if deadline_ms is not None:
        payload["deadline_ms"] = deadline_ms

    out = Completion(status=0, t_submit=time.monotonic())
    reader, writer = await _open(host, port)
    try:
        writer.write(_request_bytes("POST", "/v1/completions", payload))
        await writer.drain()
        out.status, headers = await _read_status_and_headers(reader)
        ra = headers.get("retry-after")
        if ra is not None:
            try:
                out.retry_after = float(ra)
            except ValueError:
                pass
        ctype = headers.get("content-type", "")
        if out.status != 200 or "text/event-stream" not in ctype:
            n = int(headers.get("content-length", "0") or 0)
            raw = await (reader.readexactly(n) if n else reader.read())
            body = json.loads(raw.decode() or "{}") if raw else {}
            out.error = body.get("error")
            if out.status == 200:          # stream=false JSON response
                out.token_ids = list(body.get("token_ids", []))
                out.finish_reason = body.get("finish_reason")
                out.id = _parse_id(body.get("id"))
                out.t_done = time.monotonic()
            return out
        async for ev in _sse_events(reader):
            out.events.append(ev)
            if on_event is not None:
                on_event(ev)
            if "error" in ev:
                out.error = ev["error"]
                break
            out.id = _parse_id(ev.get("id"), out.id)
            choice = (ev.get("choices") or [{}])[0]
            toks = (choice.get("delta") or {}).get("token_ids") or []
            if toks:
                if out.t_first is None:
                    out.t_first = time.monotonic()
                out.token_ids.extend(toks)
            if choice.get("finish_reason"):
                out.finish_reason = choice["finish_reason"]
                break
            if hangup_after_tokens is not None \
                    and len(out.token_ids) >= hangup_after_tokens:
                break                       # hang up: just stop reading
        out.t_done = time.monotonic()
        return out
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


def _parse_id(raw, default=None):
    if isinstance(raw, str) and raw.startswith("cmpl-"):
        try:
            return int(raw.split("-", 1)[1])
        except ValueError:
            return default
    return default


async def _sse_events(reader):
    """Yield parsed JSON SSE events until [DONE], EOF, or error."""
    data_lines = []
    while True:
        line = await reader.readline()
        if not line:
            return
        line = line.rstrip(b"\r\n")
        if line.startswith(b"data: "):
            data_lines.append(line[len(b"data: "):])
            continue
        if line:                           # comment/other field: skip
            continue
        if not data_lines:                 # blank keep-alive
            continue
        data = b"\n".join(data_lines)
        data_lines = []
        if data == b"[DONE]":
            return
        yield json.loads(data.decode())
