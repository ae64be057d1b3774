"""Optimizers as graph ops (port of ``hetu_tpu/optim/optimizer.py``, the
dense path of ``Optimizer``, ``SGDOptimizer``, ``MomentumOptimizer``,
``AdamOptimizer`` and ``AdamWOptimizer``).

``minimize`` builds the gradient nodes and an ``OptimizerOp``; the op reads
the gradients, the parameters (the executor's full-precision masters under
a ``compute_dtype``) and its state from the trace context, and records new
parameter values and state.  The update rules are the JAX package's,
written in plain PyTorch ops: the JAX package has no kernel here, XLA fuses
its jnp.  A rule is ``apply_dense_``: it writes the new moments into the
slot tensors the executor keeps and returns the parameter's step ``d``,
and the executor writes ``param - d`` into the parameter in place once the
step's walk is done (an op later in the walk still reads the old value, as
in JAX).  The executor's tensors therefore keep their storage from step to
step, as a captured CUDA graph needs, and no update copies a new tensor
back (the packed W&D table is 2.16 GB at Criteo's 33.76M rows).  It rounds
as the JAX formula does operation by operation: ``m.mul_(b1)`` gives the
bits of ``b1 * m``, ``param.sub_(d)`` those of ``param - d``.
``apply_dense`` is the functional form (new tensors, as in JAX), made from
it.  Adam's update writes each full-size result into a new tensor and
finishes it in place, so that at most one temporary of a parameter's size
lives beside the parameter, its gradient and the moments.

Lazy sparse updates (``sparse_vars``, ``apply_sparse``) are slice B2 of the
port; AdaGrad, AMSGrad and Lamb are slice A3 (ROADMAP.md).
"""

from __future__ import annotations

import torch

from ..graph.autodiff import gradients
from ..graph.node import Op, VariableOp, graph_variables
from .lr_scheduler import as_schedule

_SPARSE = ("lazy sparse updates (sparse_vars, apply_sparse) arrive with "
           "slice B2 (W&D/CTR) of the port (ROADMAP.md)")


class Optimizer:
    """Base optimizer: subclasses define slot init + dense update rule."""

    slot_names = ()

    def __init__(self, learning_rate=0.01, l2reg=0.0):
        self.lr = as_schedule(learning_rate)
        self.l2reg = l2reg

    # -- functional update rule -------------------------------------------
    def init_slots(self, param):
        return {name: torch.zeros_like(param) for name in self.slot_names}

    def apply_dense_(self, param, grad, slots, lr, step):
        """The update rule: writes the new slots into ``slots`` and returns
        ``d``, the new parameter being ``param - d``."""
        raise NotImplementedError

    def apply_dense(self, param, grad, slots, lr, step):
        """The functional form, as in JAX: (new param, new slots), the
        given slots left as they were."""
        slots = {k: t.clone() for k, t in slots.items()}
        d = self.apply_dense_(param, grad, slots, lr, step)
        return d.neg_().add_(param), slots

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


class SGDOptimizer(Optimizer):
    def apply_dense_(self, param, grad, slots, lr, step):
        # param - lr * grad
        return torch.mul(self._regularized(param, grad), lr)


class MomentumOptimizer(Optimizer):
    """The JAX package's momentum, not ``torch.optim.SGD``'s: ``v <- m v -
    lr g``, then ``p <- p + v`` (with ``nesterov``, ``p + m v - lr g``).
    Plain momentum returns ``d = -v``, so ``p - d`` gives the bits of ``p +
    v``.  Nesterov returns ``d = lr g - m v``; ``p - d`` rounds once where
    JAX's ``(p + m v) - lr g`` rounds twice, so it agrees with JAX to about
    an ulp of ``p`` a step, not bitwise."""

    slot_names = ("velocity",)

    def __init__(self, learning_rate=0.01, momentum=0.9, nesterov=False,
                 l2reg=0.0):
        super().__init__(learning_rate, l2reg)
        self.momentum = momentum
        self.nesterov = nesterov

    def apply_dense_(self, param, grad, slots, lr, step):
        lr_g = torch.mul(self._regularized(param, grad), lr)
        # m * v - lr * g, in place
        v = slots["velocity"].mul_(self.momentum).sub_(lr_g)
        if self.nesterov:
            return lr_g.sub_(torch.mul(v, self.momentum))
        return v.neg()


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
        """(mhat, the denominator sqrt(vhat) + eps), each a new tensor,
        with the slots m and v updated in place; the bias correction from
        the f32 step counter, as in JAX."""
        t = step.float() + 1.0
        # b1 * m + (1 - b1) * g and b2 * v + ((1 - b2) * g) * g
        m = slots["m"].mul_(self.beta1).add_(
            torch.mul(grad, 1.0 - self.beta1))
        v = slots["v"].mul_(self.beta2).add_(
            torch.mul(grad, 1.0 - self.beta2).mul_(grad))
        mhat = torch.div(m, 1.0 - torch.pow(self.beta1, t))
        denom = torch.div(v, 1.0 - torch.pow(self.beta2, t)).sqrt_().add_(
            self.eps)
        return mhat, denom

    def apply_dense_(self, param, grad, slots, lr, step):
        grad = self._regularized(param, grad)
        update, denom = self._moments(grad, slots, step)
        return update.mul_(lr).div_(denom)  # lr * mhat / denom


class AdamWOptimizer(AdamOptimizer):
    def __init__(self, learning_rate=0.01, beta1=0.9, beta2=0.999, eps=1e-7,
                 weight_decay=0.01):
        super().__init__(learning_rate, beta1, beta2, eps)
        self.weight_decay = weight_decay

    def apply_dense_(self, param, grad, slots, lr, step):
        update, denom = self._moments(grad, slots, step)
        update.div_(denom)
        del denom
        # lr * (mhat / denom + wd * param)
        return update.add_(torch.mul(param, self.weight_decay)).mul_(lr)


class OptimizerOp(Op):
    """Graph node applying the optimizer to (grad, var) pairs.

    Evaluated with env access: reads the gradients bound in the env, the
    parameters (masters under a compute dtype) and its state from the
    TraceContext.  It updates its state in place (the slots through
    ``apply_dense_``, then the step counter) and records each parameter's
    step with ``ctx.record_decrement``.  Evaluates to None (the
    reference's train_op).  ``clip_global_norm`` scales every gradient by
    min(1, clip / (global L2 norm + 1e-6)), the norm summed in f32.
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
            for var, param, grad in zip(self.var_list, params, grads):
                ctx.record_decrement(var, self.optimizer.apply_dense_(
                    param, grad, state["slots"][var.name], lr, step))
            step.add_(1)
        return None

    def _compute(self, input_vals, ctx):
        raise RuntimeError("OptimizerOp is evaluated with env access")


_opt_counter = [0]


def _opt_count():
    _opt_counter[0] += 1
    return _opt_counter[0]
