"""Multi-head attention layer (port of ``hetu_tpu/layers/attention.py``).

Keeps the [B, S, H] layout end to end; the core product is one fused
attention op (ops/attention.py), which runs the Hopper flash kernel on the
card.  RoPE, ALiBi and grouped-query attention arrive with the causal-LM
slice (ROADMAP slice C) and raise here until then.
"""

from __future__ import annotations

from .base import BaseLayer, fresh_name
from .common import Linear
from ..ops import array_reshape_op, transpose_op
from ..ops.attention import scaled_dot_product_attention_op


class MultiHeadAttention(BaseLayer):
    def __init__(self, hidden_size, num_heads, sequence_length=None,
                 dropout_rate=0.0, causal_mask=False, num_kv_heads=None,
                 rope_theta=None, alibi=False, bias=True,
                 fused_head_projection=False, name=None):
        if hidden_size % num_heads:
            raise ValueError("hidden_size must be a multiple of num_heads")
        if (rope_theta is not None or alibi or fused_head_projection
                or (num_kv_heads or num_heads) != num_heads):
            raise NotImplementedError(
                "RoPE, ALiBi, grouped-query attention and the fused head "
                "projection arrive with slice C of the port (ROADMAP.md)")
        name = fresh_name(name or "attn")
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.sequence_length = sequence_length
        self.dropout_keep = 1.0 - dropout_rate
        self.causal = causal_mask
        self.q_proj = Linear(hidden_size, hidden_size, bias=bias,
                             name=f"{name}_q")
        self.k_proj = Linear(hidden_size, hidden_size, bias=bias,
                             name=f"{name}_k")
        self.v_proj = Linear(hidden_size, hidden_size, bias=bias,
                             name=f"{name}_v")
        self.out_proj = Linear(hidden_size, hidden_size, bias=bias,
                               name=f"{name}_out")

    def _split_heads(self, x, seq_len):
        # [B, S, H] (or [B*S, H]) -> [B, heads, S, d]
        x = array_reshape_op(
            x, output_shape=(-1, seq_len, self.num_heads, self.head_dim))
        return transpose_op(x, perm=(0, 2, 1, 3))

    def __call__(self, query, key, value, attention_mask=None, seq_len=None,
                 kv_seq_len=None):
        """Returns [B, S, H]; ``kv_seq_len`` (default ``seq_len``) allows
        non-causal cross-attention over a memory of another length."""
        seq_len = seq_len or self.sequence_length
        if seq_len is None:
            raise ValueError("sequence length required")
        if kv_seq_len is not None and kv_seq_len != seq_len and self.causal:
            raise ValueError(
                "kv_seq_len != seq_len is only supported for non-causal "
                "cross-attention")
        kv_seq_len = kv_seq_len or seq_len
        q = self._split_heads(self.q_proj(query), seq_len)
        k = self._split_heads(self.k_proj(key), kv_seq_len)
        v = self._split_heads(self.v_proj(value), kv_seq_len)
        ctx_ = scaled_dot_product_attention_op(
            q, k, v, mask=attention_mask, causal=self.causal,
            dropout_keep=self.dropout_keep)
        ctx_ = transpose_op(ctx_, perm=(0, 2, 1, 3))
        ctx_ = array_reshape_op(ctx_,
                                output_shape=(-1, seq_len, self.hidden_size))
        return self.out_proj(ctx_)
