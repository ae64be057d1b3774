"""Sparse softmax cross-entropy (port of ``hetu_tpu/ops/losses.py``,
BERT subset)."""

from __future__ import annotations

import torch

from .base import simple_op


def _softmax_cross_entropy_sparse(y, labels, dim=-1, ignored_index=-1):
    if dim in (-1, y.dim() - 1):
        # the fused kernels (SoftmaxCEFn: forward and backward) stream the
        # vocab once each; they decline (None) shapes too small to be
        # worth it, as in the JAX package
        from .kernels.softmax_ce import fused_softmax_ce_sparse
        out = fused_softmax_ce_sparse(y, labels, ignored_index=ignored_index)
        if out is not None:
            return out
    y = y.float()  # stable under bf16 compute policies
    lse = torch.logsumexp(y, dim=dim)
    labels = labels.long()
    picked = torch.gather(
        y, dim, labels.clamp_min(0).unsqueeze(dim)).squeeze(dim)
    loss = lse - picked
    return torch.where(labels == ignored_index, torch.zeros_like(loss), loss)


softmax_cross_entropy_sparse_op = simple_op(
    _softmax_cross_entropy_sparse, "softmax_cross_entropy_sparse")
