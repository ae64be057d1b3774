"""Graph evaluation: walk an op DAG on tensors.

Counterpart of ``hetu_tpu/graph/trace.py``.  The JAX package traces the
topo order once into one XLA program; here the same walk runs op by op,
each op dispatching its PyTorch ops (or hand-written kernels) in turn,
eagerly or, on the card, under CUDA graph capture (graph/executor.py).
The JAX primal-fusion pass has no counterpart: the forward runs once with
autograd recording it, and a gradient bundle differentiates that forward
(graph/autodiff.py).  The remat pass arrives with slice A3.
"""

from __future__ import annotations

import torch

from .autodiff import GradientsBundleOp
from .node import Op, PlaceholderOp, VariableOp, find_topo_sort


class TraceContext:
    """Per-step services available to op ``_compute`` implementations.

    * ``training`` — train/eval flag (dropout).
    * ``rng_for(op)`` — the executor's ``torch.Generator``; ops that draw
      random numbers take them from it, so a run is reproducible from the
      executor's seed.
    * ``record_update(var, value)`` — stateful ops register new values for
      VariableOps; ``record_decrement(var, d)`` registers ``var - d``
      (an optimizer's step).  Once the walk is done the executor writes
      them into its ``params`` in place, so every op of the step reads
      the old values.
    * ``opt_state`` — {optimizer_op_name: state}, the executor's; the
      optimizer ops update it in place.
    * ``op`` — the op being evaluated (a failed CUDA graph capture names
      it).
    * ``master_params`` — with a ``compute_dtype``, the executor's
      full-precision {var_name: value}, which optimizers update instead of
      the cast working values bound in the env.
    * ``mesh`` / ``cp_impl`` — the executor's device mesh (or None) and the
      long-context lowering over its ``cp`` axis: ``"ring"`` (K/V rotate
      around the ranks) or ``"ulysses"`` (all-to-all head parallelism);
      ``Executor(mesh=, cp_impl=)`` sets them.
    """

    def __init__(self, generator: torch.Generator | None = None,
                 training: bool = False, master_params=None, mesh=None,
                 cp_impl: str = "ring"):
        self.generator = generator
        self.training = training
        self.mesh = mesh
        self.cp_impl = cp_impl
        self.updates = {}     # VariableOp -> new value
        self.decrements = {}  # VariableOp -> d, the new value var - d
        self.opt_state = {}   # {optimizer_op_name: state}
        self.op = None
        self.master_params = master_params
        # gradient bundle -> keep the autograd graph after its backward
        # (another bundle of the same step differentiates it again)
        self.retain_graph = {}

    def rng_for(self, op: Op) -> torch.Generator:
        if self.generator is None:
            raise RuntimeError(
                f"op {op.name} needs RNG but no generator was provided")
        return self.generator

    def record_update(self, var: VariableOp, value):
        self.updates[var] = value

    def record_decrement(self, var: VariableOp, d):
        self.decrements[var] = d


def evaluate(eval_nodes, bindings, ctx: TraceContext, topo=None):
    """Evaluate ``eval_nodes`` given ``bindings`` {node: tensor}; returns
    their values.

    ``bindings`` must cover every PlaceholderOp/VariableOp reachable.  An
    intermediate value is dropped after its last consumer has run, so an
    evaluation holds a layer's activations, not the whole network's (XLA's
    buffer assignment does the same for the JAX package); what a backward
    needs, autograd keeps.  Variables stay bound for the whole walk.  The
    variables that a gradient bundle differentiates are bound as leaves
    that require grad, so the one forward records the graph that the
    bundle differentiates.  Ops with a
    ``_compute_with_env`` (gradient bundles, optimizers) get the env.
    """
    env = dict(bindings)
    if topo is None:
        topo = find_topo_sort(eval_nodes)
    bundles = [n for n in topo if isinstance(n, GradientsBundleOp)]
    for bundle in bundles:
        ctx.retain_graph[bundle] = bundle is not bundles[-1]
        for x in bundle.xs:
            if not env[x].requires_grad:
                env[x] = env[x].detach().requires_grad_()
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
        ctx.op = node
        if hasattr(node, "_compute_with_env"):
            env[node] = node._compute_with_env(env, ctx)
        else:
            env[node] = node._compute([env[x] for x in node.inputs], ctx)
        for x in node.inputs:
            # variables stay bound: optimizers read them from the env
            if (last_use[x] == i and x not in keep
                    and not isinstance(x, VariableOp)):
                env.pop(x, None)
    return [env[n] for n in eval_nodes]
