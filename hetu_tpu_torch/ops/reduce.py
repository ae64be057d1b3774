"""Reductions on the BERT path (port of ``hetu_tpu/ops/reduce.py``)."""

from __future__ import annotations

from .base import simple_op


def _mean(a, axes=None, keepdims=False):
    if axes is None:
        return a.mean(dim=tuple(range(a.dim())), keepdim=keepdims)
    if isinstance(axes, int):
        axes = (axes,)
    return a.mean(dim=tuple(axes), keepdim=keepdims)


reduce_mean_op = simple_op(_mean, "reduce_mean")
