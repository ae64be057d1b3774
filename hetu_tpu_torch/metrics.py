"""Serving latency statistics (port of the serving part of
``hetu_tpu/metrics.py``).

The engine's request records (``InferenceEngine.records``) become TTFT,
TPOT and queue-wait percentiles here.  Linear interpolation over the
sorted sample (numpy's default), as in the JAX package.  The rest of
``metrics.py`` (accuracy, AUC, F1, ...) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np


def percentile(values, q):
    """q-th percentile (0..100) of a 1-D sample; nan on empty input."""
    values = np.asarray(list(values), np.float64).reshape(-1)
    if values.size == 0:
        return float("nan")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    return float(np.percentile(values, q))


def latency_stats(values, percentiles=(50, 95, 99)):
    """Summary of one latency series: ``{"p50": .., "p95": .., "p99": ..,
    "mean": .., "max": .., "count": n}`` (seconds in, seconds out).
    None entries are dropped (a request that never reached the edge)."""
    values = [v for v in values if v is not None]
    out = {f"p{int(q)}": percentile(values, q) for q in percentiles}
    if values:
        arr = np.asarray(values, np.float64)
        out["mean"] = float(arr.mean())
        out["max"] = float(arr.max())
    else:
        out["mean"] = float("nan")
        out["max"] = float("nan")
    out["count"] = len(values)
    return out


def request_latency_summary(records, keys=("ttft", "tpot", "queue_wait"),
                            percentiles=(50, 95, 99)):
    """Per-key :func:`latency_stats` over serving request records (the
    dicts ``InferenceEngine.records`` accumulates)."""
    return {k: latency_stats((r.get(k) for r in records),
                             percentiles=percentiles) for k in keys}
