"""Shape/layout transforms on the BERT and CTR paths (port of
``hetu_tpu/ops/transform.py``)."""

from __future__ import annotations

import torch

from .base import simple_op

array_reshape_op = simple_op(
    lambda a, output_shape=None: a.reshape(output_shape), "array_reshape")
broadcastto_op = simple_op(lambda a, b: a.expand(b.shape), "broadcastto")


def _slice(a, begin_pos=None, output_shape=None):
    # size -1 = "to the end of the dim"
    idx = tuple(slice(b, d if s == -1 else b + s)
                for b, s, d in zip(begin_pos, output_shape, a.shape))
    return a[idx]


slice_op = simple_op(_slice, "slice")


concat_op = simple_op(
    lambda a, b, axis=0: torch.cat([a, b], dim=axis), "concat")
