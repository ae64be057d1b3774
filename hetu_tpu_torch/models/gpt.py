"""GPT-style decoder LM (port of ``hetu_tpu/models/gpt.py``).

A pre-norm causal transformer with learned positions and a tied LM head:
the logits are the final hidden states against the token table, so the
table takes gradients from both the lookup and the head.  The loss is the
sparse softmax CE of the next-token labels, its mean over the positions
whose label is not -1.  Variable names and shapes are the JAX package's,
so ``Executor.load_params`` carries its weights across unchanged.

``pipeline_stages`` (the JAX package's ``stage`` scopes) raises, naming
slice F's pipeline parallelism (ROADMAP.md).
"""

from __future__ import annotations

from .. import initializers as init
from ..graph.node import VariableOp, scoped_init
from ..layers import Embedding, LayerNorm, TransformerLayer
from ..ops import (array_reshape_op, dropout_op, matmul_op,
                   softmax_cross_entropy_sparse_op)
from .bert import MaskedMeanOp, PositionIdsOp
from .llama import _no_pipeline


class GPTConfig:
    def __init__(self, vocab_size=50257, hidden_size=768, num_layers=12,
                 num_heads=12, seq_len=1024, intermediate_size=None,
                 dropout_prob=0.1):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.seq_len = seq_len
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.dropout_prob = dropout_prob


# published size presets (the JAX package's, after Galvatron's gpt configs)
GPT_CONFIGS = {
    "gpt-small": dict(hidden_size=768, num_layers=12, num_heads=12),
    "gpt-medium": dict(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt-1.5b": dict(hidden_size=1600, num_layers=48, num_heads=32),
    "gpt-2.7b": dict(hidden_size=2560, num_layers=32, num_heads=32),
    "gpt-6.7b": dict(hidden_size=4096, num_layers=32, num_heads=32),
}


class GPTModel:
    @scoped_init
    def __init__(self, config, name="gpt", pipeline_stages=None):
        _no_pipeline(pipeline_stages)
        c = config
        self.config = c
        self.wte = Embedding(c.vocab_size, c.hidden_size,
                             initializer=init.normal(0.0, 0.02),
                             name=f"{name}_wte")
        self.wpe = VariableOp(f"{name}_wpe", (c.seq_len, c.hidden_size),
                              init.normal(0.0, 0.01))
        self.layers = [
            TransformerLayer(c.hidden_size, c.num_heads,
                             c.intermediate_size, seq_len=c.seq_len,
                             dropout_rate=c.dropout_prob,
                             attn_dropout_rate=c.dropout_prob,
                             causal=True, pre_norm=True,
                             name=f"{name}_h{i}")
            for i in range(c.num_layers)]
        self.ln_f = LayerNorm(c.hidden_size, name=f"{name}_ln_f")

    def __call__(self, input_ids):
        c = self.config
        x = self.wte(input_ids)
        x = x + PositionIdsOp(self.wpe, x, c.seq_len)
        if c.dropout_prob > 0:
            x = dropout_op(x, keep_prob=1.0 - c.dropout_prob)
        for layer in self.layers:
            x = layer(x, seq_len=c.seq_len)
        return self.ln_f(x)


class GPTLMHeadModel:
    @scoped_init
    def __init__(self, config, name="gpt", pipeline_stages=None):
        _no_pipeline(pipeline_stages)
        self.transformer = GPTModel(config, name=name)
        self.config = config

    def __call__(self, input_ids):
        h = self.transformer(input_ids)
        h = array_reshape_op(h, output_shape=(-1, self.config.hidden_size))
        return matmul_op(h, self.transformer.wte.weight, trans_B=True)

    def loss(self, input_ids, labels):
        """labels: [B, S] next-token ids with -1 at padded positions."""
        logits = self(input_ids)
        flat = array_reshape_op(labels, output_shape=(-1,))
        ce = softmax_cross_entropy_sparse_op(logits, flat, ignored_index=-1)
        return MaskedMeanOp(ce, flat)
