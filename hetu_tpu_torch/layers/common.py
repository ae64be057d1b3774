"""Linear, Conv2d, BatchNorm, LayerNorm, RMSNorm, Embedding, the pools and
Reshape (port of ``hetu_tpu/layers/common.py``, the BERT, Llama and ResNet
subset).  Parameter names and layouts match the JAX package: a Linear
weight is [in, out] and the graph computes ``x @ w``; a Conv2d weight is
HWIO."""

from __future__ import annotations

import numpy as np
import torch

from .base import BaseLayer, fresh_name
from .. import initializers as init
from ..graph.node import VariableOp
from ..ops import (matmul_op, linear_op, layer_normalization_op,
                   rms_norm_op, embedding_lookup_op, conv2d_hwio_op,
                   conv2d_hwio_add_bias_op, conv2d_nhwc_op,
                   conv2d_nhwc_add_bias_op, batch_normalization_op,
                   max_pool2d_op, avg_pool2d_op, array_reshape_op)


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


class _HWIOAdapter:
    """Run an OIHW-convention initializer and store the result HWIO, so
    that the fans (``initializers._fans`` reads a 4-D shape as OIHW) are
    the layer's: read on the HWIO shape, fan-in would be ``ci * kw * co``
    instead of ``ci * kh * kw``."""

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, generator, shape, dtype=torch.float32):
        kh, kw, ci, co = shape
        w = self.inner(generator, (co, ci, kh, kw), dtype)
        return w.permute(2, 3, 1, 0).contiguous()


class Conv2d(BaseLayer):
    """2-D convolution (reference layers/conv.py).  The weight is stored
    HWIO, as the JAX package stores it, so checkpoints and
    ``params_from_jax`` carry it as it is; ``load_oihw``/``dump_oihw``
    convert torch/ONNX-convention arrays.  ``channels_last``: activations
    are NHWC end to end; by default NCHW."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, initializer=None, activation=None,
                 channels_last=False, name=None):
        name = fresh_name(name or "conv2d")
        ks = kernel_size if isinstance(kernel_size, tuple) \
            else (kernel_size, kernel_size)
        self.weight = VariableOp(
            f"{name}_weight", ks + (in_channels, out_channels),
            _HWIOAdapter(initializer or init.he_normal()))
        self.bias = VariableOp(f"{name}_bias", (out_channels,),
                               init.zeros()) if bias else None
        self.stride, self.padding = stride, padding
        self.activation = activation
        self.channels_last = channels_last

    @staticmethod
    def load_oihw(w):
        """torch/ONNX-convention (O, I, H, W) array -> the stored layout."""
        return np.transpose(np.asarray(w), (2, 3, 1, 0))

    @staticmethod
    def dump_oihw(w):
        """The stored layout -> torch/ONNX-convention (O, I, H, W)."""
        return np.transpose(np.asarray(w), (3, 2, 0, 1))

    def __call__(self, x):
        if self.channels_last:
            op, op_b = conv2d_nhwc_op, conv2d_nhwc_add_bias_op
        else:
            op, op_b = conv2d_hwio_op, conv2d_hwio_add_bias_op
        if self.bias is not None:
            out = op_b(x, self.weight, self.bias,
                       padding=self.padding, stride=self.stride)
        else:
            out = op(x, self.weight, padding=self.padding,
                     stride=self.stride)
        if self.activation is not None:
            out = self.activation(out)
        return out


class BatchNorm(BaseLayer):
    """BatchNorm over the channel axis (reference
    layers/normalization.py); see ``ops.nn.BatchNormOp`` for the stats,
    and ``precise_stats=True`` for inputs whose per-channel |mean| is far
    above their std."""

    def __init__(self, num_channels, momentum=0.1, eps=1e-5,
                 precise_stats=False, channels_last=False, name=None):
        name = fresh_name(name or "bn")
        self.scale = VariableOp(f"{name}_scale", (num_channels,), init.ones())
        self.bias = VariableOp(f"{name}_bias", (num_channels,), init.zeros())
        self.momentum, self.eps = momentum, eps
        self.precise_stats = precise_stats
        self.channel_axis = -1 if channels_last else 1

    def __call__(self, x):
        return batch_normalization_op(x, self.scale, self.bias,
                                      momentum=self.momentum, eps=self.eps,
                                      precise_stats=self.precise_stats,
                                      channel_axis=self.channel_axis)


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


class MaxPool2d(BaseLayer):
    def __init__(self, kernel_size, stride=None, padding=0):
        self.k = kernel_size
        self.s = stride or kernel_size
        self.p = padding

    def __call__(self, x):
        return max_pool2d_op(x, kernel_H=self.k, kernel_W=self.k,
                             padding=self.p, stride=self.s)


class AvgPool2d(MaxPool2d):
    def __call__(self, x):
        return avg_pool2d_op(x, kernel_H=self.k, kernel_W=self.k,
                             padding=self.p, stride=self.s)


class Reshape(BaseLayer):
    def __init__(self, shape):
        self.shape = tuple(shape)

    def __call__(self, x):
        return array_reshape_op(x, output_shape=self.shape)
