"""Layer norm and dropout (port of ``hetu_tpu/ops/nn.py``, BERT subset)."""

from __future__ import annotations

import torch

from ..graph.node import Op
from .base import simple_op


def _layer_norm(x, scale, bias, eps=1e-5):
    # moments in f32 (bf16 mean/variance loses too much precision)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


layer_normalization_op = simple_op(_layer_norm, "layer_normalization")


class DropoutOp(Op):
    """Inverted dropout: in training, keep each element with probability
    ``keep_prob`` (a uniform draw from the executor's generator) and scale
    it by 1/keep_prob, in x's dtype; the identity in evaluation."""

    def __init__(self, x, keep_prob=0.9, name=None):
        super().__init__(x, name=name)
        self.keep_prob = keep_prob

    def _compute(self, input_vals, ctx):
        (x,) = input_vals
        if not ctx.training or self.keep_prob >= 1.0:
            return x
        keep = torch.rand(x.shape, generator=ctx.rng_for(self),
                          device=x.device) < self.keep_prob
        return torch.where(keep, x / self.keep_prob, torch.zeros_like(x))


def dropout_op(x, keep_prob=0.9, name=None):
    return DropoutOp(x, keep_prob=keep_prob, name=name)
