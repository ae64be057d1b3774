"""Linear, LayerNorm, RMSNorm and Embedding (port of
``hetu_tpu/layers/common.py``, the BERT and Llama subset).  Parameter
names and layouts match the JAX package: a Linear weight is [in, out] and
the graph computes ``x @ w``."""

from __future__ import annotations

from .base import BaseLayer, fresh_name
from .. import initializers as init
from ..graph.node import VariableOp
from ..ops import (matmul_op, linear_op, layer_normalization_op,
                   rms_norm_op, embedding_lookup_op)


class Linear(BaseLayer):
    def __init__(self, in_features, out_features, bias=True,
                 initializer=None, activation=None, name=None):
        name = fresh_name(name or "dense")
        self.weight = VariableOp(
            f"{name}_weight", (in_features, out_features),
            initializer or init.xavier_normal())
        self.bias = VariableOp(f"{name}_bias", (out_features,),
                               init.zeros()) if bias else None
        self.activation = activation

    def __call__(self, x):
        if self.bias is not None:
            out = linear_op(x, self.weight, self.bias)
        else:
            out = matmul_op(x, self.weight)
        if self.activation is not None:
            out = self.activation(out)
        return out


class LayerNorm(BaseLayer):
    def __init__(self, hidden_size, eps=1e-5, name=None):
        name = fresh_name(name or "ln")
        self.scale = VariableOp(f"{name}_scale", (hidden_size,), init.ones())
        self.bias = VariableOp(f"{name}_bias", (hidden_size,), init.zeros())
        self.eps = eps

    def __call__(self, x):
        return layer_normalization_op(x, self.scale, self.bias, eps=self.eps)


class RMSNorm(BaseLayer):
    def __init__(self, hidden_size, eps=1e-6, name=None):
        name = fresh_name(name or "rmsnorm")
        self.scale = VariableOp(f"{name}_scale", (hidden_size,), init.ones())
        self.eps = eps

    def __call__(self, x):
        return rms_norm_op(x, self.scale, eps=self.eps)


class Embedding(BaseLayer):
    def __init__(self, num_embeddings, embedding_dim, initializer=None,
                 name=None):
        name = fresh_name(name or "embedding")
        self.weight = VariableOp(
            f"{name}_table", (num_embeddings, embedding_dim),
            initializer or init.normal(0.0, 0.01))

    def __call__(self, ids):
        return embedding_lookup_op(self.weight, ids)
