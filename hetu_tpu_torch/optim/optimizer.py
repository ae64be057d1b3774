"""Optimizers as graph ops (port of ``hetu_tpu/optim/optimizer.py``, the
dense path of ``Optimizer``, ``AdamOptimizer`` and ``AdamWOptimizer``).

``minimize`` builds the gradient nodes and an ``OptimizerOp``; the op reads
the gradients, the parameters (the executor's full-precision masters under
a ``compute_dtype``) and its state from the trace context, and records new
parameter values and state.  The update rules are the JAX package's,
written in plain PyTorch ops: the JAX package has no kernel here, XLA fuses
its jnp.  Updates are functional (new tensors), as in JAX.

Lazy sparse updates (``sparse_vars``, ``apply_sparse``) are slice B of the
port; SGD, Momentum, AdaGrad, AMSGrad and Lamb are slice A3 (ROADMAP.md).
"""

from __future__ import annotations

import torch

from ..graph.autodiff import gradients
from ..graph.node import Op, VariableOp, graph_variables
from .lr_scheduler import as_schedule

_SPARSE = ("lazy sparse updates (sparse_vars, apply_sparse) arrive with "
           "slice B (W&D/CTR) of the port (ROADMAP.md)")


class Optimizer:
    """Base optimizer: subclasses define slot init + dense update rule."""

    slot_names = ()

    def __init__(self, learning_rate=0.01, l2reg=0.0):
        self.lr = as_schedule(learning_rate)
        self.l2reg = l2reg

    # -- functional update rule -------------------------------------------
    def init_slots(self, param):
        return {name: torch.zeros_like(param) for name in self.slot_names}

    def apply_dense(self, param, grad, slots, lr, step):
        raise NotImplementedError

    def apply_sparse(self, param, ids, grad_rows, slots, lr, step):
        raise NotImplementedError(_SPARSE)

    def _regularized(self, param, grad):
        if self.l2reg > 0.0:
            return grad + self.l2reg * param
        return grad

    # -- graph construction ------------------------------------------------
    def minimize(self, loss, var_list=None, sparse_vars=()):
        """Build the gradients of ``loss`` w.r.t. ``var_list`` (default:
        every trainable variable it reaches) and the OptimizerOp."""
        if sparse_vars:
            raise NotImplementedError(_SPARSE)
        if var_list is None:
            var_list = graph_variables([loss], trainable_only=True)
        var_list = list(var_list)
        grads = gradients(loss, var_list) if var_list else []
        return OptimizerOp(grads, var_list, self)

    def apply_gradients(self, grads_and_vars):
        grads, var_list = zip(*grads_and_vars)
        return OptimizerOp(list(grads), list(var_list), self)


class AdamOptimizer(Optimizer):
    slot_names = ("m", "v")

    def __init__(self, learning_rate=0.01, beta1=0.9, beta2=0.999, eps=1e-7,
                 amsgrad=False, l2reg=0.0):
        if amsgrad:
            raise NotImplementedError(
                "AMSGrad arrives with slice A3 of the port (ROADMAP.md)")
        super().__init__(learning_rate, l2reg)
        self.beta1, self.beta2, self.eps = beta1, beta2, eps

    def _moments(self, grad, slots, step):
        # bias correction from the f32 step counter, as in JAX
        t = step.float() + 1.0
        m = self.beta1 * slots["m"] + (1.0 - self.beta1) * grad
        v = self.beta2 * slots["v"] + (1.0 - self.beta2) * grad * grad
        mhat = m / (1.0 - torch.pow(self.beta1, t))
        vhat = v / (1.0 - torch.pow(self.beta2, t))
        return m, v, mhat, vhat

    def apply_dense(self, param, grad, slots, lr, step):
        grad = self._regularized(param, grad)
        m, v, mhat, vhat = self._moments(grad, slots, step)
        return param - lr * mhat / (torch.sqrt(vhat) + self.eps), \
            {"m": m, "v": v}


class AdamWOptimizer(AdamOptimizer):
    def __init__(self, learning_rate=0.01, beta1=0.9, beta2=0.999, eps=1e-7,
                 weight_decay=0.01):
        super().__init__(learning_rate, beta1, beta2, eps)
        self.weight_decay = weight_decay

    def apply_dense(self, param, grad, slots, lr, step):
        m, v, mhat, vhat = self._moments(grad, slots, step)
        update = mhat / (torch.sqrt(vhat) + self.eps) \
            + self.weight_decay * param
        return param - lr * update, {"m": m, "v": v}


class OptimizerOp(Op):
    """Graph node applying the optimizer to (grad, var) pairs.

    Evaluated with env access: reads the gradients bound in the env, the
    parameters (masters under a compute dtype) and its state from the
    TraceContext, records new parameter values and state.  Evaluates to
    None (the reference's train_op).  ``clip_global_norm`` scales every
    gradient by min(1, clip / (global L2 norm + 1e-6)), the norm summed in
    f32.
    """

    def __init__(self, grads, var_list, optimizer, clip_global_norm=None,
                 sparse=None):
        if sparse:
            raise NotImplementedError(_SPARSE)
        if len(grads) != len(var_list):
            raise ValueError("one gradient per variable")
        for v in var_list:
            if not isinstance(v, VariableOp):
                raise TypeError(f"cannot optimize {v}")
        super().__init__(*grads, name=f"optimizer_{_opt_count()}")
        self.var_list = list(var_list)
        self.optimizer = optimizer
        self.clip_global_norm = clip_global_norm

    def init_state(self, params, device):
        """Initial state given the executor's {var_name: value}."""
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "slots": {v.name: self.optimizer.init_slots(params[v.name])
                          for v in self.var_list}}

    def _compute_with_env(self, env, ctx):
        state = ctx.opt_state[self.name]
        step = state["step"]
        master = ctx.master_params
        with torch.no_grad():
            lr = self.optimizer.lr.get(step)
            params = [master[v.name] if master is not None
                      and v.name in master else env[v].detach()
                      for v in self.var_list]
            grads = [env[g].to(p.dtype)
                     for g, p in zip(self.inputs, params)]
            if self.clip_global_norm is not None:
                gnorm = torch.sqrt(sum(g.float().square().sum()
                                       for g in grads))
                scale = (self.clip_global_norm / (gnorm + 1e-6)).clamp(
                    max=1.0)
                grads = [g * scale for g in grads]
            new_slots = {}
            for var, param, grad in zip(self.var_list, params, grads):
                new_p, ns = self.optimizer.apply_dense(
                    param, grad, state["slots"][var.name], lr, step)
                new_slots[var.name] = ns
                ctx.record_update(var, new_p)
            ctx.new_opt_state[self.name] = {"step": step + 1,
                                            "slots": new_slots}
        return None

    def _compute(self, input_vals, ctx):
        raise RuntimeError("OptimizerOp is evaluated with env access")


_opt_counter = [0]


def _opt_count():
    _opt_counter[0] += 1
    return _opt_counter[0]
