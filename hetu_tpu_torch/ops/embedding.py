"""Embedding lookup (port of ``hetu_tpu/ops/embedding.py``, unpacked path).

The packed-table lookup and its write kernel arrive with slice B.
"""

from __future__ import annotations

from .base import simple_op


def _embedding_lookup(table, ids):
    rows = table.index_select(0, ids.reshape(-1).long())
    return rows.reshape(tuple(ids.shape) + tuple(table.shape[1:]))


embedding_lookup_op = simple_op(_embedding_lookup, "embedding_lookup")
