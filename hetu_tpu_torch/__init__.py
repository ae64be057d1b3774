"""hetu_tpu_torch — the PyTorch/CUDA port of hetu_tpu for NVIDIA Hopper.

The same define-then-run graph API as ``hetu_tpu`` (placeholders,
Variables, ``*_op`` constructors, layers, models, ``Executor`` with
``run``, ``run_steps`` and ``profile``), run with PyTorch on an explicit
device: the card unless the caller passes ``device="cpu"``.  On the card
each subgraph's step is captured in a CUDA graph and replayed, as
``jax.jit`` compiles it once; ``disable_capture()`` runs steps eagerly, as
``jax.disable_jit()`` does, and on the CPU every step runs the same step
body eagerly.  Each Pallas TPU kernel on a ported path is a
hand-written Hopper kernel here (``ops/kernels/``, ``csrc/``).  The port
imports nothing of JAX or of ``hetu_tpu``.

Slices A1, A2, B1, C1, E and F1 (this package so far): BERT evaluation,
the single-device BERT training step (autodiff, AdamW, dropout), GPT
causal-LM training (models/gpt.py: learned positions, a tied head),
Wide&Deep/CTR training on a packed embedding table (models/ctr.py), the
single-device MoE FFN training step (layers/moe.py), and Llama training
under context parallelism (models/llama.py, parallel/: ring and Ulysses
attention over a ``cp`` mesh axis); and ResNet-18/CIFAR training
(models/resnet.py: convolution, pooling, BatchNorm with running stats,
SGD and Momentum), all through the Executor; and slice D1, the
continuous-batching Llama serving engine (serving/, models/llama_decode.py)
over an executor's params.  Names of later slices raise
``NotImplementedError`` (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

from .graph import (Op, PlaceholderOp, VariableOp, find_topo_sort,
                    graph_variables, gradients, CaptureError, Executor,
                    disable_capture, name_scope, scoped_init)
from . import initializers as init
from .ops import *  # noqa: F401,F403
from .optim import (SGDOptimizer, MomentumOptimizer, AdamOptimizer,
                    AdamWOptimizer)
from .optim import lr_scheduler
from . import serving

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


# the remaining optimizers arrive with slice A3
for _name in ("AdaGradOptimizer", "AMSGradOptimizer", "LambOptimizer"):
    globals()[_name] = _later(_name, "slice A3")
del _name
