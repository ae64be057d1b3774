"""Reverse-mode autodiff over the graph: ``gradients(loss, xs)`` as graph
nodes, on ``torch.autograd``.

Counterpart of ``hetu_tpu/graph/autodiff.py``.  The JAX package rebases the
loss subgraph on ``xs`` and calls ``jax.vjp``, whose primal is the loss
("fused primal": the forward is traced once).  Here the executor's one
forward already records the autograd graph, because ``evaluate`` binds
each x as a leaf that requires grad (graph/trace.py), so the bundle takes
the loss value that forward computed and calls ``torch.autograd.grad`` on
it.  The forward runs once per step, and a stateful op on the loss path
(the BERT MLM overflow counter) records its update once.

Gradients are taken with respect to the values bound for the variables,
which under a ``compute_dtype`` are the cast (e.g. bf16) values, as in JAX
where the cast happens before the vjp; optimizers cast them to their
master's dtype.  Differentiating with respect to interior nodes (the
pipeline partitioner's stage boundaries) is slice F of the port.
"""

from __future__ import annotations

import torch

from .node import Op, VariableOp


class GradientsBundleOp(Op):
    """Internal: all d loss / d xs in one ``torch.autograd.grad`` call.

    Evaluated with env access (``_compute_with_env``): the loss and the xs
    are already in the env, the xs as leaves that require grad.
    """

    def __init__(self, loss, xs, grad_out=None):
        self.xs = list(xs)
        for x in self.xs:
            if not isinstance(x, VariableOp):
                raise NotImplementedError(
                    f"gradients with respect to {x} (not a Variable): "
                    "differentiating interior nodes arrives with slice F "
                    "(pipeline parallelism) of the port (ROADMAP.md)")
        self.grad_out = grad_out
        inputs = [loss] + self.xs + ([grad_out] if grad_out is not None
                                     else [])
        super().__init__(*inputs, name=f"grads_of_{loss.name}")
        self.loss = loss

    def _compute_with_env(self, env, ctx):
        loss = env[self.loss]
        xs = [env[x] for x in self.xs]
        if self.grad_out is not None:
            ct = env[self.grad_out].to(loss.dtype)
        else:
            ct = torch.ones_like(loss)
        grads = torch.autograd.grad(
            loss, xs, grad_outputs=ct, allow_unused=True,
            retain_graph=ctx.retain_graph.get(self, False))
        # a variable the loss does not reach gets a zero gradient, as from
        # jax.vjp
        return tuple(torch.zeros_like(x) if g is None else g
                     for x, g in zip(xs, grads))

    def _compute(self, input_vals, ctx):
        raise RuntimeError("GradientsBundleOp is evaluated with env access")


class GradientSliceOp(Op):
    """Selects one gradient out of a GradientsBundleOp."""

    def __init__(self, bundle, idx, of):
        super().__init__(bundle, name=f"grad_{of.name}")
        self.idx = idx
        self.of = of  # the x this is the gradient of

    def _compute(self, input_vals, ctx):
        return input_vals[0][self.idx]


def gradients(loss, node_list, grad_out=None):
    """Build gradient nodes of ``loss`` w.r.t. each Variable in
    ``node_list`` (``grad_out``: the loss cotangent, default ones).  The
    JAX package's ``return_all`` maps serve its pipeline partitioner and
    arrive with slice F."""
    node_list = list(node_list)
    bundle = GradientsBundleOp(loss, node_list, grad_out=grad_out)
    return [GradientSliceOp(bundle, i, x) for i, x in enumerate(node_list)]
