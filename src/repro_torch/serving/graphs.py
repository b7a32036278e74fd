"""The engine's megaticks, one CUDA graph each (the port's counterpart of
the JAX engine's ``jax.jit`` of its megatick functions).

:class:`MegatickRunner` runs the two megatick programs -- ``"pure"``,
``lm.decode_multi`` for batches where every slot decodes, and
``"mixed"``, ``lm.decode_mixed`` when a slot is prefilling -- with the
sampler inside the step loop, and returns the (B, S) sampled ids: one
readback per megatick.

On the card, when every rank of the engine's mesh is on one card, each
``(path, S, gw)`` key (S the pow2 scan length, gw the pow2 gather
width: as many graphs as JAX's jit specialisations) is captured once
into a ``torch.cuda.CUDAGraph`` and replayed from then on:

* every per-megatick input lives in one static int32 device buffer
  (the temperatures as their float32 bits), filled by one host-to-device
  copy before the replay, from a pinned host buffer with
  ``non_blocking=True`` (no synchronize: the previous megatick's
  readback synchronized the stream, so its copy has landed before the
  host buffer is written again); the decode state's tensors (KV pools, the
  recurrent families' per-slot state, ``cur_len``, block tables) are
  captured at their fixed addresses, which the engine only ever writes
  in place;
* before a key's capture, its program runs once for one step with every
  slot frozen: the state stays byte-identical, and every kernel's launch
  is planned (workspaces, symmetric buffers, counters) outside the
  capture;
* all graphs share one memory pool; replays are serialised on the
  current stream, and each output is copied to the host before the
  next replay;
* a capture that fails raises; it never falls back to the eager loop;
  no garbage collection runs during a capture.

Over ranks on distinct cards, and on the CPU, the same programs run
eagerly (a graph across cards is later work).

Launch counters: a wrapper counts a launch when it issues one, and a
captured launch is issued by each replay, so the runner takes the
counts recorded during a capture back out and adds them again per
replay.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from repro_torch.distributed import context as dctx
from repro_torch.distributed import processes
from repro_torch.models import lm
from repro_torch.serving import sampler as sampler_lib

PURE, MIXED = "pure", "mixed"


def launch_counted() -> tuple:
    """The kernel wrappers that count their launches."""
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import symm
    from repro_torch.kernels.ag_gemm import ag_gemm_fused
    from repro_torch.kernels.matmul import matmul, matmul_batched
    return (matmul, matmul_batched, kfd.flash_decode_paged,
            kfd.flash_decode_paged_partial,
            kfd.flash_decode_paged_fused, kfd.flash_decode_partial,
            kfd.flash_decode_fused, ag_gemm_fused, symm.exchange)


class MegatickRunner:
    """The megatick programs of one engine.

    ``params``: what ``lm.decode_step`` takes (over a mesh one replica
    per distinct device, or per-rank shards); ``state``: the pool's decode state; ``width``:
    the columns of the prompt-token input (the engine's per-slot token
    quota M); ``sampler``: "greedy" or "temperature" with base ``key``;
    ``graphs``: capture and replay (CUDA, every rank on one card) or
    run the loop eagerly."""

    def __init__(self, params, state, cfg, *, batch: int, width: int,
                 sampler: str, key: torch.Tensor, bounded: bool,
                 device: torch.device, graphs: bool):
        self.params, self.state, self.cfg = params, state, cfg
        self.sampler, self.key, self.bounded = sampler, key, bounded
        self.device = device
        self.use_graphs = graphs
        B = batch
        shapes = {"tok": (B, 1), "budgets": (B,), "rids": (B,),
                  "steps0": (B,), "temps": (B,), "topks": (B,),
                  "toks": (B, width), "pl": (B,), "e0": (B,), "tot": (B,)}
        n = sum(int(np.prod(s)) for s in shapes.values())
        self.host_t = torch.zeros(n, dtype=torch.int32,
                                  pin_memory=device.type == "cuda")
        self.host = self.host_t.numpy()
        self.buf = torch.zeros(n, dtype=torch.int32, device=device)
        self.host_in, self.inputs, at = {}, {}, 0
        for name, shape in shapes.items():
            size = int(np.prod(shape))
            h = self.host[at:at + size]
            d = self.buf[at:at + size]
            if name == "temps":
                h, d = h.view(np.float32), d.view(torch.float32)
            self.host_in[name] = h.reshape(shape)
            self.inputs[name] = d.reshape(shape)
            at += size
        self.graphs: dict = {}   # (path, S, gw) -> (graph, out, launches)
        self.pool = None
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.warmup_steps = 0

    def _sample_fn(self, path: str):
        x = self.inputs
        if self.sampler == "greedy":
            return lambda logits, j: sampler_lib.greedy(logits)
        # the token index of step j: the slot's emitted count when the
        # megatick started plus the steps it has been emitting
        first = x["steps0"] if path == PURE else x["steps0"] - x["e0"]
        return lambda logits, j: sampler_lib.sample_batch(
            logits, self.key, x["rids"], first + j, x["temps"], x["topks"])

    def _program(self, path: str, S: int, gw: int) -> torch.Tensor:
        x = self.inputs
        kw = dict(sample_fn=self._sample_fn(path), gather_width=gw,
                  bounded=self.bounded)
        if path == PURE:
            out, _ = lm.decode_multi(self.params, x["tok"], self.state,
                                     self.cfg, steps=S,
                                     budgets=x["budgets"], **kw)
        else:
            out, _ = lm.decode_mixed(self.params, x["toks"][:, :S], x["tok"],
                                     x["pl"], x["e0"], x["tot"], self.state,
                                     self.cfg, steps=S, **kw)
        return out

    def run(self, path: str, S: int, gw: int, **arrays) -> np.ndarray:
        """One megatick of ``path`` over ``S`` steps at gather width
        ``gw``; ``arrays`` are the host inputs by name (absent ones are
        zero). Returns the (B, S) sampled ids on the host."""
        self.host[:] = 0
        for name, value in arrays.items():
            self.host_in[name][...] = value
        with torch.inference_mode():
            if not self.use_graphs:
                self.buf.copy_(self.host_t, non_blocking=True)
                out = self._program(path, S, gw)
            else:
                key = (path, S, gw)
                if key not in self.graphs:
                    self.graphs[key] = self._capture(*key)
                self.buf.copy_(self.host_t, non_blocking=True)
                graph, out, launches = self.graphs[key]
                graph.replay()
                for fn, n in launches:
                    fn.launches += n
                self.replays += 1
            # torchlint: ignore[TAX001] the megatick's ONE designed sync:
            # the (B, S) sampled ids drive the host's scheduling
            return out.cpu().numpy()

    def _capture(self, path: str, S: int, gw: int):
        t0 = time.perf_counter()
        counted = launch_counted()
        with torch.cuda.device(self.device):
            # warm-up: one step with every slot frozen (zero budgets and
            # totals) leaves the state byte-identical and plans every
            # launch of this gather width outside the capture
            self.buf.zero_()
            self._program(path, 1, gw)
            self.warmup_steps += 1
            before = [fn.launches for fn in counted]
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            # no garbage collection inside the capture: a collected
            # CUDAGraph's destructor is a CUDA call that would invalidate
            # it (this process may hold unreachable graphs in cycles)
            collect = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.pool):
                    out = self._program(path, S, gw)
            finally:
                if collect:
                    gc.enable()
        # a capture takes seconds of host time: no replay's first
        # cross-process call may spin on a peer still capturing
        processes.align(dctx.current().mesh, "captured")
        launches = [(fn, fn.launches - n0)
                    for fn, n0 in zip(counted, before) if fn.launches != n0]
        for fn, n in launches:            # recorded, not launched
            fn.launches -= n
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return graph, out, launches

    def metrics(self) -> dict:
        return {"graphs": self.use_graphs, "graph_count": len(self.graphs),
                "graph_captures": self.captures,
                "graph_replays": self.replays,
                "graph_capture_s": round(self.capture_s, 3),
                "graph_warmup_steps": self.warmup_steps}
