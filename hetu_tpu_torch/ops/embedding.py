"""Embedding lookups (port of ``hetu_tpu/ops/embedding.py``): the row
lookup of a standard [num_rows, dim] table and the lookup of a packed
[p_rows, 128] table, whose gradient goes through the ``pack_write``
kernel (ops/kernels/sparse_densify.py).

The sharded packed lookup (``sharded_packed_lookup``) arrives with slice
F, and the parameter-server path with slice B2 (ROADMAP.md).
"""

from __future__ import annotations

from ..graph.node import Op
from .base import simple_op, _peek_id


def _embedding_lookup(table, ids):
    rows = table.index_select(0, ids.reshape(-1).long())
    return rows.reshape(tuple(ids.shape) + tuple(table.shape[1:]))


embedding_lookup_op = simple_op(_embedding_lookup, "embedding_lookup")


class _PackedLookupOp(Op):
    """Lookup from a PACKED [p_rows, 128] embedding table; its backward
    writes the dense packed gradient with the ``pack_write`` kernel on the
    card, also inside a meshed executor.  The JAX op engages its Pallas
    kernel only off-mesh, because ``pallas_call`` does not partition under
    GSPMD; the port's mesh places every position on the executor's one
    device, so the kernel runs there too, with the same values."""

    def _compute(self, input_vals, ctx):
        from .kernels.sparse_densify import packed_lookup
        table, ids = input_vals
        return packed_lookup(table, ids, self.attrs["dim"])


def packed_embedding_lookup_op(table, ids, dim, name=None):
    """Graph op: rows [..., dim] from a packed [p_rows, 128] table."""
    return _PackedLookupOp(table, ids,
                           name=name or f"packed_lookup_{_peek_id()}",
                           dim=dim)
