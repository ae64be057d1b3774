"""Op definition helpers (PyTorch port of ``hetu_tpu/ops/base.py``).

An op definition is a plain function of tensors; ``simple_op`` turns it
into a graph-node constructor.  Ops that need RNG, the train/eval mode or
state updates subclass Op directly in their modules.
"""

from __future__ import annotations

from ..graph.node import Op


class SimpleOp(Op):
    """Graph node wrapping a plain tensor function of its inputs + attrs."""

    __slots__ = ("impl", "op_kind")

    def __init__(self, impl, op_kind, *inputs, name=None, **attrs):
        super().__init__(*inputs, name=name or f"{op_kind}_{_peek_id()}",
                         **attrs)
        self.impl = impl
        self.op_kind = op_kind

    def _compute(self, input_vals, ctx):
        return self.impl(*input_vals, **self.attrs)


def _peek_id():
    from ..graph import node as _n
    return _n._node_counter[0] + 1


def simple_op(impl, op_kind):
    """Returns a graph-node constructor for a plain tensor function.

    Non-Op positional arguments are refused (constants go through attrs).
    """

    def ctor(*inputs, name=None, **attrs):
        for i in inputs:
            if not isinstance(i, Op):
                raise TypeError(
                    f"{op_kind}: expected graph nodes as inputs, got "
                    f"{type(i).__name__}; pass constants as keyword attrs")
        return SimpleOp(impl, op_kind, *inputs, name=name, **attrs)

    ctor.__name__ = op_kind
    return ctor
