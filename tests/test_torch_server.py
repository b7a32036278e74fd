"""The port's SSE front end (``repro_torch.launch.server``) over the
port's engine on the CPU: the cases of tests/test_server.py and the
server cases of tests/test_faults.py. ``Server`` boots in-process on an
ephemeral localhost port and is driven through the port's client over
real sockets; streams are held against solo runs of the same engine
(which tests/test_torch_engine.py holds against the JAX engine).
"""
import asyncio
import functools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import server as server_mod  # noqa: E402
from repro_torch.launch.server import Server  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import client as cl  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.faults import (DISPATCH_ATTEMPTS,  # noqa: E402
                                        FaultPlan, FaultSpec)

torch.set_num_threads(2)


@functools.lru_cache(maxsize=1)
def _setup():
    cfg = smoke_config(get_config("llama3-8b")).replace(
        n_layers=1, dtype=torch.float32)
    return cfg, lm.init_params(cfg, seed=0, device="cpu")


def _engine(batch=2, **kw):
    cfg, params = _setup()
    kw.setdefault("decode_steps", 4)
    kw.setdefault("block_size", 16)
    kw.setdefault("n_blocks", 12)
    return Engine(params, cfg, batch=batch, max_len=64, prefill_chunk=8,
                  device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _solo_cached(prompt, n_new, block_size, n_blocks):
    eng = _engine(batch=1, block_size=block_size, n_blocks=n_blocks)
    req = Request(rid=0, prompt=list(prompt), max_new_tokens=n_new)
    eng.submit(req)
    eng.run()
    return tuple(req.out_tokens)


def _solo(prompt, n_new, block_size=16, n_blocks=12):
    return list(_solo_cached(tuple(prompt), n_new, block_size, n_blocks))


async def _poll(host, port, pred, timeout_s=30.0):
    for _ in range(int(timeout_s / 0.1)):
        m = await cl.metrics(host, port)
        if pred(m):
            return m
        await asyncio.sleep(0.1)
    return await cl.metrics(host, port)


async def _poll_ready(host, port, want: bool, timeout_s=10.0):
    for _ in range(int(timeout_s / 0.1)):
        status, body = await cl.request_json(host, port, "GET", "/readyz")
        if body.get("ready") is want:
            return status, body
        await asyncio.sleep(0.1)
    return await cl.request_json(host, port, "GET", "/readyz")


@functools.lru_cache(maxsize=1)
def _reference():
    """Solo streams of the two fault-test prompts, 8 new tokens each."""
    return tuple(tuple(_solo(p, 8)) for p in PROMPTS)


PROMPTS = ([11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
            21, 22, 23, 24, 25, 26, 27, 28],
           [31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
            41, 42, 43, 44, 45, 46])


# ------------------------------------------------------- wire-level server
def test_server_stream_identity_and_chunking():
    """Two concurrent SSE streams decode exactly what solo engine runs
    produce, and tokens arrive chunked at megatick boundaries (one
    event per tick, not per token)."""
    async def run():
        srv = Server(_engine(), port=0)
        await srv.start()
        try:
            a, b = await asyncio.gather(
                cl.complete(srv.host, srv.port, [1, 2, 3],
                            max_new_tokens=8),
                cl.complete(srv.host, srv.port, [7, 8, 9, 10],
                            max_new_tokens=8))
        finally:
            await srv.stop()
        return a, b

    a, b = asyncio.run(run())
    assert a.finish_reason == "length" and b.finish_reason == "length"
    assert a.token_ids == _solo([1, 2, 3], 8)
    assert b.token_ids == _solo([7, 8, 9, 10], 8)
    for c in (a, b):
        token_events = [e for e in c.events
                        if (e.get("choices") or [{}])[0]
                        .get("delta", {}).get("token_ids")]
        # megatick-boundary flush: at most 1 prefill event + ceil(7/K)
        # megatick events for 8 tokens at K=4 — never 8 per-token events
        assert 1 <= len(token_events) <= 3, c.events


def test_server_cancel_frees_blocks_and_survivor_unharmed():
    """DELETE mid-stream: victim ends ``cancelled`` with its blocks
    freed (visible in /v1/metrics), survivor stays byte-identical, and
    a post-cancel admission completes (blocks re-allocatable)."""
    async def run():
        srv = Server(_engine(), port=0)
        await srv.start()
        host, port = srv.host, srv.port
        try:
            streamed = asyncio.Event()

            def on_ev(ev):
                ch = (ev.get("choices") or [{}])[0]
                if (ch.get("delta") or {}).get("token_ids"):
                    streamed.set()

            async def canceller():
                await streamed.wait()
                return await cl.cancel(host, port, 1)

            surv, vict, (cstat, _) = await asyncio.gather(
                cl.complete(host, port, [1, 2, 3], max_new_tokens=8),
                cl.complete(host, port, [7, 8, 9], max_new_tokens=48,
                            on_event=on_ev),
                canceller())
            m = await _poll(host, port,
                            lambda m: m.get("cancellations", 0) >= 1)
            extra = await cl.complete(host, port, [4, 5, 6],
                                      max_new_tokens=6)
        finally:
            await srv.stop()
        return surv, vict, cstat, m, extra

    surv, vict, cstat, m, extra = asyncio.run(run())
    assert cstat == 200
    assert vict.finish_reason == "cancelled"
    assert len(vict.token_ids) < 48
    assert surv.finish_reason == "length"
    assert surv.token_ids == _solo([1, 2, 3], 8)
    assert m["cancellations"] == 1
    assert m["blocks_freed_on_abort"] > 0
    assert extra.finish_reason == "length"
    assert extra.token_ids == _solo([4, 5, 6], 6)


def test_server_timeout_cancels_through_abort_path():
    """timeout_s=0 expires immediately: the stream ends with
    ``finish_reason: "timeout"`` via the same abort path."""
    async def run():
        srv = Server(_engine(), port=0)
        await srv.start()
        try:
            c = await cl.complete(srv.host, srv.port, [1, 2, 3],
                                  max_new_tokens=32, timeout_s=0.0)
        finally:
            await srv.stop()
        return c

    c = asyncio.run(run())
    assert c.finish_reason == "timeout"


def test_server_backpressure_429_on_full_queue():
    """max_queue=1 with the single slot busy: once one request waits in
    the engine queue, the next admission is refused with 429 — and the
    shed request never perturbs the ones already running."""
    async def run():
        srv = Server(_engine(batch=1), port=0, max_queue=1)
        await srv.start()
        host, port = srv.host, srv.port

        async def wait_health(pred):
            for _ in range(600):
                _, h = await cl.request_json(host, port, "GET",
                                             "/healthz")
                if pred(h):
                    return h
                await asyncio.sleep(0.01)
            return h

        try:
            t_a = asyncio.create_task(cl.complete(
                host, port, [1, 2, 3], max_new_tokens=60))
            # a drains from intake into the single slot: running
            # requests don't count against the admission bound
            await wait_health(lambda h: h["inflight"] == 1
                              and h["queued"] == 0)
            t_b = asyncio.create_task(cl.complete(
                host, port, [7, 8, 9], max_new_tokens=60))
            # b sits in the engine queue (slot busy) -> bound reached
            await wait_health(lambda h: h["queued"] >= 1)
            shed = await cl.complete(host, port, [4, 5],
                                     max_new_tokens=4)
            await cl.cancel(host, port, 0)
            await cl.cancel(host, port, 1)
            a, b = await asyncio.gather(t_a, t_b)
        finally:
            await srv.stop()
        return shed, a, b

    shed, a, b = asyncio.run(run())
    assert shed.status == 429
    assert "queue full" in (shed.error or "")
    assert a.finish_reason == "cancelled"
    assert b.finish_reason == "cancelled"


def test_server_rejects_bad_requests_as_4xx():
    """The engine's loud ValueErrors surface as 4xx at the API edge,
    never as a broken stream or a crashed drive loop."""
    async def run():
        srv = Server(_engine(), port=0)
        await srv.start()
        host, port = srv.host, srv.port
        try:
            empty = await cl.complete(host, port, [],
                                      max_new_tokens=4)
            s1, b1 = await cl.request_json(
                host, port, "POST", "/v1/completions",
                {"prompt": "not a list"})
            s2, b2 = await cl.request_json(
                host, port, "POST", "/v1/completions",
                {"prompt": [1, 2], "max_new_tokens": 0})
            toolong = await cl.complete(host, port, list(range(1, 70)),
                                        max_new_tokens=4)
            s3, _ = await cl.request_json(host, port, "GET", "/nope")
            s4, _ = await cl.request_json(host, port, "DELETE",
                                          "/v1/completions/777")
            # after all the refusals a normal request still works
            okc = await cl.complete(host, port, [1, 2, 3],
                                    max_new_tokens=4)
        finally:
            await srv.stop()
        return empty, s1, b1, s2, b2, toolong, s3, s4, okc

    empty, s1, b1, s2, b2, toolong, s3, s4, okc = asyncio.run(run())
    assert empty.status == 400 and "prompt" in empty.error
    assert s1 == 400 and "prompt" in b1["error"]
    assert s2 == 400 and "max_new_tokens" in b2["error"]
    assert toolong.status == 400 and "max_len" in toolong.error
    assert s3 == 404
    assert s4 == 404                # cancel of unknown rid
    assert okc.finish_reason == "length"
    assert okc.token_ids == _solo([1, 2, 3], 4)


def test_server_nonstreaming_json_response():
    """stream=false returns one JSON body with the full completion,
    identical to the streamed tokens."""
    async def run():
        srv = Server(_engine(), port=0)
        await srv.start()
        try:
            c = await cl.complete(srv.host, srv.port, [2, 4, 6],
                                  max_new_tokens=6, stream=False)
        finally:
            await srv.stop()
        return c

    c = asyncio.run(run())
    assert c.ok and c.finish_reason == "length"
    assert c.token_ids == _solo([2, 4, 6], 6)


# ------------------------------------------------------------ faults
def test_server_tick_failure_becomes_sse_error_and_survives():
    """A megatick that raises out of the engine (retry budget
    exhausted) fails the REQUESTS — per-request SSE error events —
    while the drive loop keeps serving the next submission."""
    async def run():
        plan = FaultPlan([FaultSpec("dispatch", tick=1,
                                    count=DISPATCH_ATTEMPTS)])
        srv = Server(_engine(fault_plan=plan), port=0)
        await srv.start()
        try:
            bad = await cl.complete(srv.host, srv.port, [1, 2, 3],
                                    max_new_tokens=4)
            assert bad.error is not None
            assert "megatick failed" in bad.error
            ok = await cl.complete(srv.host, srv.port, [1, 2, 3],
                                   max_new_tokens=4)
            assert ok.ok and ok.finish_reason == "length"
            m = await cl.metrics(srv.host, srv.port)
            assert m["server_tick_failures"] == 1
            assert m["dispatch_failures"] == 1
        finally:
            await srv.stop()
    asyncio.run(run())


def test_server_non_transient_tick_error_breaks_the_server():
    """An exception other than DispatchFailedError inside a tick (on the
    card: a sticky CUDA error) leaves the in-place state untrusted: the
    stream ends with an error event, the engine is not touched again
    (no cancel), /readyz and new requests answer 503 and the drive loop
    stops."""
    async def run():
        eng = _engine()
        cancels = []
        eng.cancel = cancels.append

        def boom(*args, **kwargs):
            raise RuntimeError("simulated device fault")
        eng._runner.run = boom
        srv = Server(eng, port=0)
        await srv.start()
        try:
            bad = await cl.complete(srv.host, srv.port, [1, 2, 3],
                                    max_new_tokens=4)
            assert bad.error is not None
            assert "engine failed" in bad.error
            assert "simulated device fault" in bad.error
            status, ready = await cl.request_json(srv.host, srv.port,
                                                  "GET", "/readyz")
            assert status == 503 and not ready["ready"]
            assert "simulated device fault" in ready["broken"]
            again = await cl.complete(srv.host, srv.port, [1, 2, 3],
                                      max_new_tokens=4)
            assert again.status == 503
            assert srv._drive_task.done()
            assert cancels == [] and eng.tick_count == 1
            assert eng.dispatch_retry_count == 0
            m = await cl.metrics(srv.host, srv.port)
            assert m["server_tick_failures"] == 1 and m["broken"]
        finally:
            await srv.stop()
    asyncio.run(run())


def test_server_poisoned_slot_errors_one_stream_only():
    async def run():
        # poison several ticks (slot 0 only retires once, extra pokes
        # on a freed slot are no-ops) so wire-arrival jitter cannot
        # miss the emission window
        plan = FaultPlan([FaultSpec("tokens", tick=t, slot=0)
                          for t in (3, 4, 5)])
        srv = Server(_engine(fault_plan=plan), port=0)
        await srv.start()
        try:
            a, b = await asyncio.gather(
                cl.complete(srv.host, srv.port, list(PROMPTS[0]),
                            max_new_tokens=8),
                cl.complete(srv.host, srv.port, list(PROMPTS[1]),
                            max_new_tokens=8))
            failed = [c for c in (a, b) if c.error is not None]
            finished = [c for c in (a, b) if c.finish_reason == "length"]
            assert len(failed) == 1 and len(finished) == 1
            assert tuple(finished[0].token_ids) in _reference()
        finally:
            await srv.stop()
    asyncio.run(run())


def test_server_socket_drop_recovered_by_client_retry():
    """Injected socket drop severs the SSE stream mid-flight; the
    client's retry resubmits and — because the dropped request's KV
    stays prefix-registered — completes with the full token stream."""
    async def run():
        plan = FaultPlan([FaultSpec("socket", tick=2)])
        srv = Server(_engine(fault_plan=plan), port=0)
        await srv.start()
        try:
            out = await cl.complete(srv.host, srv.port, list(PROMPTS[0]),
                                    max_new_tokens=8, retries=2)
            assert out.ok and out.finish_reason == "length"
            assert out.retries >= 1
            assert tuple(out.token_ids) == _reference()[0]
            m = await cl.metrics(srv.host, srv.port)
            assert m["faults_injected"] >= 1
        finally:
            await srv.stop()
    asyncio.run(run())


def test_server_drain_checkpoints_and_goes_unready(tmp_path):
    """POST /admin/drain: intake stops (503 + Retry-After), in-flight
    work past the grace window is checkpointed, streams end with an
    error naming the step, /readyz flips to 503."""
    async def run():
        srv = Server(_engine(), port=0, ckpt_dir=str(tmp_path),
                     drain_grace_s=0.0)
        await srv.start()
        try:
            # drain once the first token is out: the prompt's full
            # chunk is written and registered by then, so the resume
            # below is a prefix hit however slowly the ticks run
            streamed = asyncio.Event()

            def on_ev(ev):
                if ((ev.get("choices") or [{}])[0].get("delta")
                        or {}).get("token_ids"):
                    streamed.set()
            stream = asyncio.create_task(cl.complete(
                srv.host, srv.port, list(PROMPTS[0]),
                max_new_tokens=40, on_event=on_ev))
            await streamed.wait()
            status, body = await cl.request_json(
                srv.host, srv.port, "POST", "/admin/drain")
            assert status == 200 and body["draining"]
            out = await stream
            assert out.error is not None and "checkpoint" in out.error
            status, body = await _poll_ready(srv.host, srv.port, False)
            assert status == 503 and not body["ready"]
            refused = await cl.complete(srv.host, srv.port, [1, 2, 3])
            assert refused.status == 503
            assert refused.retry_after is not None
        finally:
            await srv.stop()
        ckpt = Checkpointer(str(tmp_path))
        assert ckpt.latest_step() is not None
        fresh = _engine()
        restored = fresh.restore(ckpt)
        assert len(restored) == 1
        fresh.run()
        assert len(restored[0].out_tokens) == 40
        assert restored[0].reused_tokens > 0
    asyncio.run(run())


def test_server_drain_then_resume_through_build_engine(tmp_path):
    """The CLI's path end to end: a server built by ``build_engine``
    drains into ``--checkpoint-dir`` (its stream ends with an error
    naming the step, /readyz 503); a second one built with ``--resume``
    restores the request, which finishes as a prefix hit with the
    stream an uninterrupted engine gives."""
    common = ["--arch", "llama3-8b", "--smoke", "--device", "cpu",
              "--batch", "2", "--max-len", "64", "--block-size", "8",
              "--kv-blocks", "24", "--checkpoint-dir", str(tmp_path)]
    prompt = list(PROMPTS[0])

    async def first():
        args = server_mod.make_parser().parse_args(common)
        srv = Server(server_mod.build_engine(args), port=0,
                     ckpt_dir=str(tmp_path), drain_grace_s=0.0)
        await srv.start()
        try:
            seen = asyncio.Event()

            def on_ev(ev):
                if ((ev.get("choices") or [{}])[0].get("delta") or {}).get(
                        "token_ids"):
                    seen.set()
            stream = asyncio.create_task(cl.complete(
                srv.host, srv.port, prompt, max_new_tokens=40,
                on_event=on_ev))
            await seen.wait()
            await cl.request_json(srv.host, srv.port, "POST",
                                  "/admin/drain")
            out = await stream
            status, _ = await _poll_ready(srv.host, srv.port, False)
            return out, status
        finally:
            await srv.stop()

    out, status = asyncio.run(first())
    assert out.error is not None and "checkpoint" in out.error
    assert status == 503 and 0 < len(out.token_ids) < 40
    assert Checkpointer(str(tmp_path)).latest_step() is not None

    async def second():
        args = server_mod.make_parser().parse_args(common + ["--resume"])
        eng = server_mod.build_engine(args)
        (resumed,) = list(eng.queue)
        srv = Server(eng, port=0)
        await srv.start()
        try:
            m = await _poll(srv.host, srv.port,
                            lambda m: m.get("requests", 0) >= 1)
            return resumed, m
        finally:
            await srv.stop()

    resumed, m = asyncio.run(second())
    assert resumed.done and resumed.reused_tokens > 0
    assert m["prefix_hits"] >= 1
    args = server_mod.make_parser().parse_args(common)
    ref = server_mod.build_engine(args)
    req = Request(rid=0, prompt=prompt, max_new_tokens=40)
    ref.submit(req)
    ref.run()
    assert resumed.out_tokens == req.out_tokens
    assert resumed.out_tokens[:len(out.token_ids)] == out.token_ids


def test_server_cli_builds_on_the_card_by_default():
    """``--device`` defaults to cuda, and without a GPU the build raises
    instead of serving from the CPU."""
    args = server_mod.make_parser().parse_args(["--arch", "llama3-8b",
                                                "--smoke"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            server_mod.build_engine(args)
