"""Reductions on the BERT and CTR paths (port of
``hetu_tpu/ops/reduce.py``)."""

from __future__ import annotations

from .base import simple_op


def _dims(a, axes):
    if axes is None:
        return tuple(range(a.dim()))
    if isinstance(axes, int):
        return (axes,)
    return tuple(axes)


reduce_mean_op = simple_op(
    lambda a, axes=None, keepdims=False:
        a.mean(dim=_dims(a, axes), keepdim=keepdims),
    "reduce_mean")
reduce_sum_op = simple_op(
    lambda a, axes=None, keepdims=False:
        a.sum(dim=_dims(a, axes), keepdim=keepdims),
    "reduce_sum")
