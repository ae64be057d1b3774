"""hetu_tpu_torch — the PyTorch/CUDA port of hetu_tpu for NVIDIA Hopper.

The same define-then-run graph API as ``hetu_tpu`` (placeholders,
Variables, ``*_op`` constructors, layers, models, ``Executor``), evaluated
eagerly with PyTorch on an explicit device: the card unless the caller
passes ``device="cpu"``.  Each Pallas TPU kernel on a ported path is a
hand-written Hopper kernel here (``ops/kernels/``, ``csrc/``).  The port
imports nothing of JAX or of ``hetu_tpu``.

Slice A1 (this package so far): BERT evaluation through the Executor.
Names of later slices raise ``NotImplementedError`` (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

from .graph import (Op, PlaceholderOp, VariableOp, find_topo_sort,
                    graph_variables, gradients, Executor, name_scope,
                    scoped_init)
from . import initializers as init
from .ops import *  # noqa: F401,F403

__version__ = "0.1.0"


def placeholder_op(name, shape=None, dtype=np.float32, trainable=False):
    """Create a fed input node."""
    return PlaceholderOp(name, shape=shape, dtype=dtype)


def Variable(name, value=None, initializer=None, shape=None, trainable=True,
             dtype=np.float32):
    """Create a persistent (optionally trainable) tensor from ``value`` (a
    numpy array) or ``initializer`` + ``shape``."""
    if value is not None:
        value = np.asarray(value)
        initializer = init.NumpyInit(value)
        shape = value.shape
    if initializer is None or shape is None:
        raise ValueError("Variable needs value= or (initializer=, shape=)")
    return VariableOp(name, shape, initializer, trainable=trainable,
                      dtype=dtype)


def _later(name, where):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"{name} arrives with {where} of the port (ROADMAP.md)")
    stub.__name__ = name
    return stub


# optimizers arrive with the training step
for _name in ("SGDOptimizer", "MomentumOptimizer", "AdaGradOptimizer",
              "AdamOptimizer", "AdamWOptimizer", "AMSGradOptimizer",
              "LambOptimizer"):
    globals()[_name] = _later(_name, "slice A2 (the BERT-base training step)")
del _name
