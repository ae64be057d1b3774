"""Graph node model: the define-then-run op DAG (PyTorch port).

Counterpart of ``hetu_tpu/graph/node.py``.  Each op's ``_compute`` is a
plain function of ``torch.Tensor`` inputs; the executor walks the topo
order eagerly (graph/executor.py).  Names, ids and naming scopes follow the
JAX package exactly, so a model built with either package gets the same
variable names and weights can be carried across by name (weights.py).
"""

from __future__ import annotations

import functools
import threading

import numpy as np

_node_counter = [0]


def _next_id() -> int:
    _node_counter[0] += 1
    return _node_counter[0]


_naming_tls = threading.local()


def _naming_stack():
    # index 0 is the process-global namespace; each `with name_scope():`
    # pushes a fresh one so a model's names do not depend on what was
    # built in the process before it
    stack = getattr(_naming_tls, "stack", None)
    if stack is None:
        stack = _naming_tls.stack = [{"vars": {}, "layers": {}}]
    return stack


class name_scope:
    """Fresh, deterministic naming namespace for variables and layers."""

    def __enter__(self):
        _naming_stack().append({"vars": {}, "layers": {}})
        return self

    def __exit__(self, *exc):
        _naming_stack().pop()
        return False


def scoped_init(init):
    """Decorator: run a model's ``__init__`` inside its own `name_scope`."""

    @functools.wraps(init)
    def wrapper(self, *args, **kwargs):
        with name_scope():
            return init(self, *args, **kwargs)

    return wrapper


def _unique_var_name(name: str) -> str:
    table = _naming_stack()[-1]["vars"]
    count = table.get(name)
    if count is None:
        table[name] = 1
        return name
    table[name] = count + 1
    name = f"{name}_{count}"
    table[name] = 1
    return name


class Op:
    """A node in the dataflow graph.

    Subclasses implement ``_compute(input_vals, ctx)`` on tensors; ``ctx``
    is a TraceContext (graph/trace.py) with the training flag, the RNG and
    state-update recording.
    """

    __slots__ = ("id", "name", "inputs", "attrs")

    def __init__(self, *inputs, name=None, **attrs):
        self.id = _next_id()
        self.inputs = list(inputs)
        self.name = name or f"{type(self).__name__}_{self.id}"
        self.attrs = attrs

    def _compute(self, input_vals, ctx):
        raise NotImplementedError(type(self).__name__)

    # -- sugar -------------------------------------------------------------
    def __add__(self, other):
        from ..ops.math import add_op, addbyconst_op
        if isinstance(other, Op):
            return add_op(self, other)
        return addbyconst_op(self, other)

    __radd__ = __add__

    def __mul__(self, other):
        from ..ops.math import mul_op, mulbyconst_op
        if isinstance(other, Op):
            return mul_op(self, other)
        return mulbyconst_op(self, other)

    __rmul__ = __mul__

    def __sub__(self, other):
        from ..ops.math import sub_op, addbyconst_op
        if isinstance(other, Op):
            return sub_op(self, other)
        return addbyconst_op(self, -other)

    def __rsub__(self, other):
        from ..ops.math import mulbyconst_op, addbyconst_op
        return addbyconst_op(mulbyconst_op(self, -1.0), other)

    def __neg__(self):
        from ..ops.math import mulbyconst_op
        return mulbyconst_op(self, -1.0)

    def __truediv__(self, other):
        from ..ops.math import div_op, mulbyconst_op
        if isinstance(other, Op):
            return div_op(self, other)
        return mulbyconst_op(self, 1.0 / other)

    def __matmul__(self, other):
        from ..ops.linalg import matmul_op
        return matmul_op(self, other)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name} #{self.id}>"

    def __hash__(self):
        return self.id

    def __eq__(self, other):
        return self is other


class PlaceholderOp(Op):
    """Fed input."""

    __slots__ = ("shape", "dtype")

    def __init__(self, name, shape=None, dtype=np.float32):
        super().__init__(name=name)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = np.dtype(dtype)

    def _compute(self, input_vals, ctx):  # value comes from feed_dict
        raise RuntimeError(f"placeholder {self.name} was not fed")


class VariableOp(Op):
    """Persistent state; values live in the executor's ``params`` dict.

    ``monitor``: optional callable(float) -> warning-or-None that the
    executor polls host-side (the BERT MLM overflow counter).
    """

    __slots__ = ("shape", "dtype", "initializer", "trainable", "monitor")

    def __init__(self, name, shape, initializer, trainable=True,
                 dtype=np.float32):
        name = _unique_var_name(name)
        super().__init__(name=name)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.initializer = initializer
        self.trainable = bool(trainable)
        self.monitor = None

    def _compute(self, input_vals, ctx):
        raise RuntimeError(
            f"variable {self.name} must be bound by the executor")


def find_topo_sort(node_list):
    """Post-order DFS topo sort (iterative, so deep graphs don't recurse)."""
    visited = set()
    order = []
    for node in node_list:
        stack = [(node, False)]
        while stack:
            n, expanded = stack.pop()
            if expanded:
                order.append(n)
                continue
            if n.id in visited:
                continue
            visited.add(n.id)
            stack.append((n, True))
            for inp in reversed(n.inputs):
                if inp.id not in visited:
                    stack.append((inp, False))
    return order


def graph_variables(node_list, trainable_only=False):
    """All VariableOps reachable from node_list, in topo order."""
    return [n for n in find_topo_sort(node_list)
            if isinstance(n, VariableOp) and (n.trainable or not trainable_only)]
