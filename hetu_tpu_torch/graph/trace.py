"""Graph evaluation: walk an op DAG eagerly on tensors.

Counterpart of ``hetu_tpu/graph/trace.py``.  The JAX package traces the
topo order once into one XLA program; here the same walk runs eagerly,
each op dispatching its PyTorch ops (or hand-written kernels) in turn.
The remat and primal-fusion passes belong to the training slice (ROADMAP
slice A2) and are not here.
"""

from __future__ import annotations

import torch

from .node import Op, PlaceholderOp, VariableOp, find_topo_sort


class TraceContext:
    """Per-step services available to op ``_compute`` implementations.

    * ``training`` — train/eval flag (dropout).
    * ``rng_for(op)`` — the executor's ``torch.Generator``; ops that draw
      random numbers take them from it, so a run is reproducible from the
      executor's seed.
    * ``record_update(var, value)`` — stateful ops register new values for
      VariableOps; the executor writes them back into its ``params``.
    """

    def __init__(self, generator: torch.Generator | None = None,
                 training: bool = False):
        self.generator = generator
        self.training = training
        self.updates = {}        # VariableOp -> new value

    def rng_for(self, op: Op) -> torch.Generator:
        if self.generator is None:
            raise RuntimeError(
                f"op {op.name} needs RNG but no generator was provided")
        return self.generator

    def record_update(self, var: VariableOp, value):
        self.updates[var] = value


def evaluate(eval_nodes, bindings, ctx: TraceContext, topo=None):
    """Evaluate ``eval_nodes`` given ``bindings`` {node: tensor}; returns
    their values.

    ``bindings`` must cover every PlaceholderOp/VariableOp reachable.  An
    intermediate value is dropped after its last consumer has run, so a
    forward holds a layer's activations, not the whole network's (XLA's
    buffer assignment does the same for the JAX package).
    """
    env = dict(bindings)
    if topo is None:
        topo = find_topo_sort(eval_nodes)
    last_use = {}
    for i, node in enumerate(topo):
        for inp in node.inputs:
            last_use[inp] = i
    keep = set(eval_nodes)
    for i, node in enumerate(topo):
        if node in env:
            continue
        if isinstance(node, (PlaceholderOp, VariableOp)):
            raise RuntimeError(f"{node} reached evaluation without a binding")
        env[node] = node._compute([env[x] for x in node.inputs], ctx)
        for x in node.inputs:
            if last_use[x] == i and x not in keep:
                env.pop(x, None)
    return [env[n] for n in eval_nodes]
