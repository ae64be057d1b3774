"""Scaled dot-product attention op (port of ``hetu_tpu/ops/attention.py``).

On a CUDA tensor inside the flash envelope the op runs the hand-written
Hopper flash-attention kernels (ops/kernels/flash_attention.py): the
forward, and the dQ and dK/dV kernels as its backward.  Elsewhere (S < 256,
or the CPU) it runs the same composition as the JAX package, which is the
JAX semantics for those shapes and not a fallback on failure.  Attention
dropout in training: the kernels drop by the keep bits of a seed drawn as
an int32 tensor on the device from the executor's generator (no host sync
per layer); the composition drops the probabilities by a uniform draw from
the same generator, as the JAX composition does with a Bernoulli mask
(the JAX package also takes the composition for dropout on the CPU).

Long context: when the executor's mesh has a ``cp`` axis larger than 1,
causal, mask-free, dropout-free attention lowers to ring attention
(parallel/context_parallel.py; the blockwise flash kernels on the card), or
to Ulysses attention with ``cp_impl="ulysses"`` when the heads divide the
axis, under exactly the JAX package's conditions.
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
        keep = self.dropout_keep if ctx.training else 1.0
        d = q.shape[-1]
        scale = self.scale if self.scale is not None else 1.0 / (d ** 0.5)
        mesh = ctx.mesh
        # the sequence dim is context-sharded over the mesh's 'cp' axis;
        # dropout and masks stay on the single-device paths below
        if (mesh is not None and "cp" in mesh.shape
                and mesh.shape["cp"] > 1 and mask is None
                and self.dropout_keep >= 1.0 and q.dim() == 4
                and q.shape == k.shape == v.shape
                and q.shape[2] % mesh.shape["cp"] == 0
                and ("dp" not in mesh.shape
                     or q.shape[0] % mesh.shape["dp"] == 0)):
            from ..parallel.context_parallel import (ring_attention,
                                                     ulysses_attention)
            if (ctx.cp_impl == "ulysses"
                    and q.shape[1] % mesh.shape["cp"] == 0):
                return ulysses_attention(mesh, q, k, v, causal=self.causal,
                                         scale=scale)
            return ring_attention(mesh, q, k, v, causal=self.causal,
                                  scale=scale)
        if _use_flash(q):
            from .kernels.flash_attention import flash_attention
            seed = None
            if keep < 1.0:
                seed = torch.randint(-2**31, 2**31 - 1, (1,),
                                     generator=ctx.rng_for(self),
                                     device=q.device, dtype=torch.int32)
            out = flash_attention(q, k, v, mask=mask, causal=self.causal,
                                  scale=scale, dropout_keep=keep, seed=seed)
            if out is not None:
                return out
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
        if keep < 1.0:
            drop = torch.rand(probs.shape, generator=ctx.rng_for(self),
                              device=probs.device) >= keep
            probs = torch.where(drop, 0.0, probs / keep)
        return torch.matmul(probs.to(v.dtype), v)


def scaled_dot_product_attention_op(q, k, v, mask=None, causal=False,
                                    scale=None, dropout_keep=1.0, name=None):
    return ScaledDotProductAttentionOp(q, k, v, mask=mask, causal=causal,
                                       scale=scale, dropout_keep=dropout_keep,
                                       name=name)
