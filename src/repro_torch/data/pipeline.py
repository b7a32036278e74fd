"""Data pipeline: deterministic synthetic LM data + byte-corpus loader
(the port's copy of ``repro.data.pipeline``, without JAX: the same numpy
seeding, so the batches are byte-identical).

Production shape: an infinite, seekable stream of fixed-length token
batches, sharded by host (each host materializes only its slice of the
global batch). Deterministic in (seed, step) so checkpoint/restart and
elastic re-sharding reproduce the exact token stream — the data position
is just the step counter in the checkpoint manifest.

Two sources:
* ``SyntheticLM``  — structured pseudo-text (Markov-ish integer stream),
  enough signal that a ~100M model visibly learns (used by examples).
* ``ByteCorpus``   — any local file as a byte-level LM corpus.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.distributed import sharding_rules as sr


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1

    def __post_init__(self):
        assert self.global_batch % self.n_hosts == 0
        self.host_batch = self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Deterministic batch for a step (host-local slice).

        Additive-drift stream: x_{t+1} = (x_t + delta_b) % V with a
        per-sequence delta in {1..4} and occasional jumps. A bigram model
        already reaches ~ln(4); inferring delta in-context goes lower —
        learnable within tens of steps by a tiny model, with headroom.
        """
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)
        B, S, V = self.host_batch, self.seq_len, self.vocab_size
        x = rng.integers(0, V, size=(B, 1), dtype=np.int64)
        delta = rng.integers(1, 5, size=(B, 1))
        toks = [x]
        for t in range(S):
            jump = (rng.random((B, 1)) < 0.02) * rng.integers(
                0, V, size=(B, 1))
            nxt = (toks[-1] + delta + jump) % V
            toks.append(nxt)
        seq = np.concatenate(toks, axis=1)          # (B, S+1)
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class ByteCorpus:
    path: str
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    vocab_size: int = 256

    def __post_init__(self):
        with open(self.path, "rb") as f:
            self.data = np.frombuffer(f.read(), dtype=np.uint8)
        assert len(self.data) > self.seq_len + 1, "corpus too small"
        self.host_batch = self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)
        B, S = self.host_batch, self.seq_len
        starts = rng.integers(0, len(self.data) - S - 1, size=B)
        seq = np.stack([self.data[s:s + S + 1] for s in starts]).astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def shard_batch(batch: dict, device, mesh=None):
    """A host batch (numpy arrays or tensors) placed as JAX's
    ``batch_sharding`` places it: on a model-only mesh (or none) the
    whole global batch on ``device``; over a mesh with data groups
    (``pod`` x ``data`` = G > 1) a list of G batches, group g's block
    of each leaf (``sharding_rules.batch_spec``: its rows, or the whole
    batch where they do not divide by G) on the group's first rank's
    device (``device`` is then ignored), which ``models.lm.loss_fn``
    takes. Over processes (``distributed.processes``) the list holds this
    process's groups (``Mesh.local_groups``) alone: each process cuts its
    rows out of the same global batch, with no communication."""
    if mesh is None or mesh.dp == 1:
        return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    first = [g * mesh.model for g in mesh.local_groups]
    return [{k: sr.cut(torch.as_tensor(v), sr.batch_spec(v.shape, mesh.shape),
                       mesh.coords(r), mesh.shape).to(
                           mesh.devices[r - mesh.first])
             for k, v in batch.items()} for r in first]
