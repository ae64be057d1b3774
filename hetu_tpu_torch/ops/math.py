"""Elementwise math ops on the BERT, CTR and Llama paths (port of
``hetu_tpu/ops/math.py``).

The rest of the JAX package's elementwise set arrives with the slices
that use it (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import simple_op

add_op = simple_op(lambda a, b: a + b, "add")
sub_op = simple_op(lambda a, b: a - b, "minus")
mul_op = simple_op(lambda a, b: a * b, "multiply")
div_op = simple_op(lambda a, b: a / b, "divide")
_addbyconst = simple_op(lambda a, const=0.0: a + const, "add_byconst")
_mulbyconst = simple_op(lambda a, const=1.0: a * const, "mul_byconst")


def addbyconst_op(node, const=0.0, name=None):
    return _addbyconst(node, const=const, name=name)


def mulbyconst_op(node, const=1.0, name=None):
    return _mulbyconst(node, const=const, name=name)


tanh_op = simple_op(torch.tanh, "tanh")
sigmoid_op = simple_op(torch.sigmoid, "sigmoid")
relu_op = simple_op(torch.relu, "relu")
silu_op = simple_op(F.silu, "silu")
# the JAX package's gelu defaults to the tanh approximation
gelu_op = simple_op(
    lambda a, approximate=True:
        F.gelu(a, approximate="tanh" if approximate else "none"),
    "gelu")
