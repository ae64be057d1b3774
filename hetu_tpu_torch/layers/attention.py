"""Multi-head attention layer (port of ``hetu_tpu/layers/attention.py``).

Keeps the [B, S, H] layout end to end; the core product is one fused
attention op (ops/attention.py), which runs the Hopper flash kernel on the
card, or ring/Ulysses attention under an executor mesh with a ``cp`` axis.
``rope_theta`` applies rotary embeddings to q and k before the product;
``num_kv_heads`` < num_heads gives grouped-query attention (K/V projected
to the smaller head count and repeated back).  ALiBi and the fused head
projection arrive with the rest of slice C (ROADMAP.md) and raise here.
"""

from __future__ import annotations

from .base import BaseLayer, fresh_name
from .common import Linear
from ..ops import array_reshape_op, transpose_op
from ..ops.attention import scaled_dot_product_attention_op
from ..ops.rotary import rotary_embedding_op, repeat_kv_op


class MultiHeadAttention(BaseLayer):
    def __init__(self, hidden_size, num_heads, sequence_length=None,
                 dropout_rate=0.0, causal_mask=False, num_kv_heads=None,
                 rope_theta=None, alibi=False, bias=True,
                 fused_head_projection=False, name=None):
        if hidden_size % num_heads:
            raise ValueError("hidden_size must be a multiple of num_heads")
        if alibi or fused_head_projection:
            raise NotImplementedError(
                "ALiBi and the fused head projection arrive with the rest "
                "of slice C of the port (ROADMAP.md)")
        name = fresh_name(name or "attn")
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        self.head_dim = hidden_size // num_heads
        self.sequence_length = sequence_length
        self.dropout_keep = 1.0 - dropout_rate
        self.causal = causal_mask
        self.rope_theta = rope_theta
        kv_dim = self.num_kv_heads * self.head_dim
        self.q_proj = Linear(hidden_size, hidden_size, bias=bias,
                             name=f"{name}_q")
        self.k_proj = Linear(hidden_size, kv_dim, bias=bias,
                             name=f"{name}_k")
        self.v_proj = Linear(hidden_size, kv_dim, bias=bias,
                             name=f"{name}_v")
        self.out_proj = Linear(hidden_size, hidden_size, bias=bias,
                               name=f"{name}_out")

    def _split_heads(self, x, seq_len, n_heads):
        # [B, S, H] (or [B*S, H]) -> [B, heads, S, d]
        x = array_reshape_op(
            x, output_shape=(-1, seq_len, n_heads, self.head_dim))
        return transpose_op(x, perm=(0, 2, 1, 3))

    def __call__(self, query, key, value, attention_mask=None, seq_len=None,
                 kv_seq_len=None):
        """Returns [B, S, H]; ``kv_seq_len`` (default ``seq_len``) allows
        non-causal, non-rotary cross-attention over a memory of another
        length."""
        seq_len = seq_len or self.sequence_length
        if seq_len is None:
            raise ValueError("sequence length required")
        if kv_seq_len is not None and kv_seq_len != seq_len and (
                self.causal or self.rope_theta is not None):
            raise ValueError(
                "kv_seq_len != seq_len is only supported for non-causal, "
                "non-rotary cross-attention")
        kv_seq_len = kv_seq_len or seq_len
        q = self._split_heads(self.q_proj(query), seq_len, self.num_heads)
        k = self._split_heads(self.k_proj(key), kv_seq_len,
                              self.num_kv_heads)
        v = self._split_heads(self.v_proj(value), kv_seq_len,
                              self.num_kv_heads)
        if self.rope_theta is not None:
            q = rotary_embedding_op(q, theta=self.rope_theta)
            k = rotary_embedding_op(k, theta=self.rope_theta)
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            k = repeat_kv_op(k, n_rep=rep)
            v = repeat_kv_op(v, n_rep=rep)
        ctx_ = scaled_dot_product_attention_op(
            q, k, v, mask=attention_mask, causal=self.causal,
            dropout_keep=self.dropout_keep)
        ctx_ = transpose_op(ctx_, perm=(0, 2, 1, 3))
        ctx_ = array_reshape_op(ctx_,
                                output_shape=(-1, seq_len, self.hidden_size))
        return self.out_proj(ctx_)
