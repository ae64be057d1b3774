"""Rotary position embeddings (RoPE) and the grouped-query head repeat
(port of ``hetu_tpu/ops/rotary.py``).

RoPE follows huggingface's ``rotate_half`` convention (non-interleaved
halves) with f32 tables, as the JAX package does.  ALiBi biases
(``alibi_bias_op``) arrive with the rest of slice C (ROADMAP.md).
"""

from __future__ import annotations

import torch

from .base import simple_op


def _rope_tables(seq_len, dim, theta, pos_offset=0, device=None):
    # always f32 tables: bf16 positions past ~256 lose the low rotation
    # frequencies entirely
    pos = torch.arange(pos_offset, pos_offset + seq_len, dtype=torch.float32,
                       device=device)
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    freqs = torch.outer(pos, inv)                     # [S, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)           # [S, D]
    return torch.cos(emb), torch.sin(emb)


def _rotary(x, theta=10000.0, pos_offset=0):
    """Apply RoPE to [B, H, S, D] (HF rotate_half convention)."""
    d, s = x.shape[-1], x.shape[-2]
    cos, sin = _rope_tables(s, d, theta, pos_offset, x.device)
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)


rotary_embedding_op = simple_op(_rotary, "rotary_embedding")


def _repeat_kv(x, n_rep):
    """[B, KV, S, D] -> [B, KV*n_rep, S, D] for grouped-query attention.

    ``expand`` then ``reshape`` materialises the repeated K/V (n_rep
    copies of each head) where XLA fuses the broadcast into the attention
    einsum: the kernels read contiguous [B, H, S, D] tensors."""
    if n_rep == 1:
        return x
    b, kv, s, d = x.shape
    x = x[:, :, None, :, :].expand(b, kv, n_rep, s, d)
    return x.reshape(b, kv * n_rep, s, d)


repeat_kv_op = simple_op(_repeat_kv, "repeat_kv")
