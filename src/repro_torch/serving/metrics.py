"""Shared latency-metric helpers for the engine, launcher and benches.

One percentile implementation so ``p50``/``p99`` mean the same thing in
``Engine.metrics``, the serve CLI summary and the scheduler benches
(the old per-call-site ``xs[len(xs)//2]`` index-median disagreed with
itself at even lengths and could not express tails at all — and SLO
policy evaluation lives in the tail).
"""
from __future__ import annotations

import numpy as np


def percentile(xs, q: float) -> float:
    """numpy's default linear-interpolation percentile, with an
    empty-sample guard so metric dicts stay total."""
    xs = list(xs)
    if not xs:
        return 0.0
    return float(np.percentile(xs, q))


def latency_summary(xs, prefix: str, digits: int = 4) -> dict:
    """p50/p99/max summary of a latency sample under ``prefix_``-keys."""
    return {
        f"p50_{prefix}_s": round(percentile(xs, 50), digits),
        f"p99_{prefix}_s": round(percentile(xs, 99), digits),
        f"max_{prefix}_s": round(max(xs), digits) if xs else 0.0,
    }
