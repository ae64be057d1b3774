"""Dense products (port of ``hetu_tpu/ops/linalg.py``, BERT subset).

The JAX package leaves these products to XLA; the port leaves them to
``torch.matmul`` (cuBLAS on the card).
"""

from __future__ import annotations

import torch

from .base import simple_op


def _mm(a, b, trans_A=False, trans_B=False):
    if trans_A:
        a = a.transpose(-1, -2)
    if trans_B:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


matmul_op = simple_op(_mm, "matmul")
linear_op = simple_op(
    lambda x, w, bias, trans_A=False, trans_B=False:
        _mm(x, w, trans_A, trans_B) + bias,
    "linear")
transpose_op = simple_op(
    lambda a, perm=None:
        a.permute(*perm) if perm is not None else a.permute(
            *reversed(range(a.dim()))),
    "transpose")
