"""Scaled dot-product attention op (port of ``hetu_tpu/ops/attention.py``).

On a CUDA tensor inside the flash envelope the op runs the hand-written
Hopper flash-attention forward (ops/kernels/flash_attention.py); elsewhere
it runs the same composition as the JAX package, which is the JAX
semantics for those shapes and not a fallback on failure.
"""

from __future__ import annotations

import torch

from ..graph.node import Op

_FLASH_MIN_SEQ = 256  # the JAX package's gate: below it the composition runs


def _use_flash(q):
    return (q.is_cuda and q.dim() == 4
            and q.shape[-2] >= _FLASH_MIN_SEQ
            and 32 <= q.shape[-1] <= 512 and q.shape[-1] % 8 == 0)


class ScaledDotProductAttentionOp(Op):
    def __init__(self, q, k, v, mask=None, causal=False, scale=None,
                 dropout_keep=1.0, name=None):
        inputs = [q, k, v] + ([mask] if mask is not None else [])
        super().__init__(*inputs, name=name)
        self.has_mask = mask is not None
        self.causal = causal
        self.scale = scale
        self.dropout_keep = dropout_keep

    def _compute(self, input_vals, ctx):
        q, k, v = input_vals[:3]
        mask = input_vals[3] if self.has_mask else None
        if self.dropout_keep < 1.0 and ctx.training:
            raise NotImplementedError(
                "attention dropout in training arrives with slice A2 of the "
                "port (ROADMAP.md)")
        d = q.shape[-1]
        scale = self.scale if self.scale is not None else 1.0 / (d ** 0.5)
        if _use_flash(q):
            from .kernels.flash_attention import flash_attention_fwd
            out = flash_attention_fwd(q, k, v, mask=mask, causal=self.causal,
                                      scale=scale)
            if out is not None:
                return out[0]
        # scores in f32, as the JAX composition's preferred_element_type
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if self.causal:
            s_q, s_k = scores.shape[-2], scores.shape[-1]
            iq = torch.arange(s_q, device=q.device)[:, None]
            ik = torch.arange(s_k, device=q.device)[None, :]
            scores = torch.where(iq >= ik - (s_k - s_q), scores,
                                 torch.full_like(scores, -1e9))
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1)
        return torch.matmul(probs.to(v.dtype), v)


def scaled_dot_product_attention_op(q, k, v, mask=None, causal=False,
                                    scale=None, dropout_keep=1.0, name=None):
    return ScaledDotProductAttentionOp(q, k, v, mask=mask, causal=causal,
                                       scale=scale, dropout_keep=dropout_keep,
                                       name=name)
