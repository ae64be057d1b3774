"""Embedding lookups (port of ``hetu_tpu/ops/embedding.py``): the row
lookup of a standard [num_rows, dim] table and the lookup of a packed
[p_rows, 128] table, whose gradient goes through the ``pack_write``
kernel (ops/kernels/sparse_densify.py).

The sharded packed lookup (``sharded_packed_lookup``) arrives with slice
F, and the parameter-server path with slice B2 (ROADMAP.md).
"""

from __future__ import annotations

import torch

from ..graph.node import Op
from .base import simple_op, _peek_id


# positions a block of ``_run_sums`` scans at each level
_BLOCK = 8


def _scan(x, keys):
    """Inclusive sums over runs of equal sorted ``keys`` along dim -2 of
    ``x`` [..., W, D] (keys [..., W]): Hillis-Steele steps, position i
    adding position i - 1, 2, 4, ... while its key is the same."""
    w, off = x.shape[-2], 1
    while off < w:
        same = (keys[..., off:] == keys[..., :-off]).unsqueeze(-1)
        x = torch.cat([x[..., :off, :], x[..., off:, :] + torch.where(
            same, x[..., :-off, :], x.new_zeros(()))], dim=-2)
        off *= 2
    return x


def _run_sums(x, keys):
    """out[i] = the sum of x[j] [N, D] over the positions j <= i of i's run
    of equal sorted ``keys`` [N], in a fixed order whatever the ids: each
    block of ``_BLOCK`` positions is scanned, the blocks' last sums are
    summed the same way one level up, and each block adds the sum its run
    carried in from the blocks before it."""
    n = x.shape[0]
    if n <= _BLOCK:
        return _scan(x, keys)
    pad = -n % _BLOCK
    if pad:  # a key above every id ends the last run
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
        keys = torch.cat([keys, keys[-1:].add(1).expand(pad)])
    xb = _scan(x.view(-1, _BLOCK, x.shape[1]), keys.view(-1, _BLOCK))
    kb = keys.view(-1, _BLOCK)
    carry = _run_sums(xb[:, -1], kb[:, -1])  # through the end of each block
    xb[1:] += torch.where((kb[1:] == kb[:-1, -1:]).unsqueeze(-1),
                          carry[:-1].unsqueeze(1), x.new_zeros(()))
    return xb.view(-1, x.shape[1])[:n]


class _RowLookup(torch.autograd.Function):
    """``table[ids]`` for flat int64 ids, whose backward sums each row's
    gradients in one fixed order, so that a step's bits repeat whatever the
    ids: the ids sorted, each run of equal ids summed by ``_run_sums`` (a
    tree of depth log2 of its length, as ``pack_write`` sums the packed
    table's runs), and each row given its run's sum.  ``index_select``'s
    backward (``index_add_``) adds with float atomics, in another order at
    every run; ``index_put_(accumulate=True)`` sums a run one id after
    another, which a row as common as BERT's [PAD] (a quarter of a batch's
    ids) or a token type makes slow."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        shape = (ctx.rows,) + tuple(g.shape[1:])
        if not len(ids):
            return g.new_zeros(shape), None
        keys, order = torch.sort(ids, stable=True)
        sums = _run_sums(g.reshape(len(ids), -1).index_select(0, order),
                         keys)
        rows = torch.arange(ctx.rows, device=ids.device)
        last = (torch.searchsorted(keys, rows, right=True) - 1).clamp_(min=0)
        hit = (keys[last] == rows).unsqueeze(-1)
        return torch.where(hit, sums[last], g.new_zeros(())).view(shape), None


def _embedding_lookup(table, ids):
    rows = _RowLookup.apply(table, ids.reshape(-1).long())
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
