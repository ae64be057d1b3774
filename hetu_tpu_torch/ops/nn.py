"""Convolution, pooling, batch norm, layer norm, RMS norm and dropout (port
of ``hetu_tpu/ops/nn.py``, the BERT, Llama and ResNet subset).

The JAX package's convolutions are ``lax.conv_general_dilated`` outside
any Pallas kernel, so here they are cuDNN's (``F.conv2d``).  Each runs
with cuDNN's algorithm choice fixed (``benchmark=False``) and restricted
to deterministic algorithms, forward and backward (``Conv2dFn``), so that
a step repeats bitwise and no autotuning runs inside a CUDA graph capture;
TF32 follows ``torch.backends.cudnn.allow_tf32``.  Layouts are the JAX
package's: ``conv2d_op`` takes an NCHW input and an OIHW weight,
``conv2d_hwio_op`` an NCHW input and an HWIO weight (what ``Conv2d``
stores; it is permuted to OIHW for cuDNN, one copy of the weight a call),
``conv2d_nhwc_op`` an NHWC input and an HWIO weight: an NHWC tensor
viewed as NCHW (``permute(0, 3, 1, 2)``) is in torch's channels_last
memory format, so the activations are not copied.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..graph.node import Op, VariableOp
from .. import initializers as init
from .base import simple_op


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _cudnn_fixed():
    """cuDNN with a fixed, deterministic algorithm choice."""
    return torch.backends.cudnn.flags(
        enabled=True, benchmark=False, deterministic=True,
        allow_tf32=torch.backends.cudnn.allow_tf32)


class Conv2dFn(torch.autograd.Function):
    """``F.conv2d`` (NCHW input, OIHW weight, no bias) whose forward and
    backward both run under ``_cudnn_fixed()``: the backward runs later,
    in autograd, outside any scope the forward could set."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        with _cudnn_fixed():
            out = F.conv2d(x, w, None, stride, padding, dilation, groups)
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        with _cudnn_fixed():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, list(stride), list(padding), list(dilation),
                False, [0, 0], groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None, None


def _conv2d(x, w, padding=0, stride=1, dilation=1, groups=1):
    # the JAX package sums in f32 and casts to x's dtype; cuDNN sums a
    # bf16 convolution in f32 too
    return Conv2dFn.apply(x, w, _pair(stride), _pair(padding),
                          _pair(dilation), groups)


conv2d_op = simple_op(_conv2d, "conv2d")
conv2d_add_bias_op = simple_op(
    lambda x, w, b, padding=0, stride=1, dilation=1, groups=1:
        _conv2d(x, w, padding, stride, dilation, groups)
        + b.reshape(1, -1, 1, 1),
    "conv2d_add_bias")


def _oihw(w):
    return w.permute(3, 2, 0, 1)  # HWIO -> OIHW


def _conv2d_nhwc(x, w, padding=0, stride=1, dilation=1, groups=1):
    """x NHWC, w HWIO, out NHWC; the activations keep torch's channels_last
    memory format throughout."""
    return _conv2d(x.permute(0, 3, 1, 2), _oihw(w), padding, stride,
                   dilation, groups).permute(0, 2, 3, 1)


def _conv2d_hwio(x, w, padding=0, stride=1, dilation=1, groups=1):
    """x NCHW, w HWIO (the layout ``Conv2d`` stores), out NCHW."""
    return _conv2d(x, _oihw(w), padding, stride, dilation, groups)


conv2d_hwio_op = simple_op(_conv2d_hwio, "conv2d_hwio")
conv2d_hwio_add_bias_op = simple_op(
    lambda x, w, b, padding=0, stride=1, dilation=1, groups=1:
        _conv2d_hwio(x, w, padding, stride, dilation, groups)
        + b.reshape(1, -1, 1, 1),
    "conv2d_hwio_add_bias")
conv2d_nhwc_op = simple_op(_conv2d_nhwc, "conv2d_nhwc")
conv2d_nhwc_add_bias_op = simple_op(
    lambda x, w, b, padding=0, stride=1, dilation=1, groups=1:
        _conv2d_nhwc(x, w, padding, stride, dilation, groups) + b,
    "conv2d_nhwc_add_bias")


# pooling over the last two axes (NCHW), as the JAX package's windows
# (1, 1, kH, kW): max with -inf padding, avg with count_include_pad=True
# (the reference AvgPool.cu), floor output sizes
max_pool2d_op = simple_op(
    lambda x, kernel_H=2, kernel_W=2, padding=0, stride=2:
        F.max_pool2d(x, (kernel_H, kernel_W), _pair(stride), _pair(padding)),
    "max_pool2d")
avg_pool2d_op = simple_op(
    lambda x, kernel_H=2, kernel_W=2, padding=0, stride=2:
        F.avg_pool2d(x, (kernel_H, kernel_W), _pair(stride), _pair(padding),
                     count_include_pad=True),
    "avg_pool2d")
global_avg_pool2d_op = simple_op(
    lambda x, channels_last=False:
        x.mean(dim=(1, 2) if channels_last else (2, 3)),
    "global_avg_pool2d")


def _layer_norm(x, scale, bias, eps=1e-5):
    # moments in f32 (bf16 mean/variance loses too much precision)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


layer_normalization_op = simple_op(_layer_norm, "layer_normalization")


def _rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


rms_norm_op = simple_op(_rms_norm, "rms_norm")


class ShiftedStats(torch.autograd.Function):
    """Shifted one-pass batch stats (the JAX package's ``_shifted_stats``
    and its custom VJP): (mean, var) of f32 ``xf`` over the axes ``red``,
    deviations taken against the per-channel ``shift`` (broadcast by the
    shape ``vec``): ``var = max(E[d^2] - E[d]^2, 0)``.  The backward is the
    distributed form ``x k + broadcast(c)`` with ``k = 2/N ct_var`` and ``c
    = ct_mean/N - k mean``; the clamp's boundary gradient is ignored and
    the shift gets none."""

    @staticmethod
    def forward(ctx, xf, shift, red, vec):
        d = xf - shift.reshape(vec)
        dmean = d.mean(dim=red)
        d2mean = d.square().mean(dim=red)
        var = torch.clamp_min(d2mean - dmean.square(), 0.0)
        mean = shift + dmean
        ctx.save_for_backward(xf, mean)
        ctx.red, ctx.vec = red, vec
        return mean, var

    @staticmethod
    def backward(ctx, ct_mean, ct_var):
        xf, mean = ctx.saved_tensors
        n = 1
        for ax in ctx.red:
            n *= xf.shape[ax]
        inv_n = 1.0 / n
        k = (2.0 * inv_n) * ct_var
        g = xf * k.reshape(ctx.vec) + (inv_n * ct_mean - k * mean).reshape(
            ctx.vec)
        return g.to(xf.dtype), None, None, None


class BatchNormOp(Op):
    """BatchNorm with running-stat state (port of the JAX package's
    ``BatchNormOp``): the running mean and variance are non-trainable
    Variables ``{name}_running_mean`` / ``_running_var`` (``name``
    defaults to ``bn_{scale.name}``), whose new values are recorded with
    ``ctx.record_update`` and written in place once the step's walk is
    done.

    In training the batch stats are f32: by default shifted one-pass
    stats (``ShiftedStats``) with the running mean as the shift, read from
    the f32 master under a ``compute_dtype`` and not differentiated; with
    ``precise_stats`` the two-pass mean, then the mean of squared
    deviations.  The running variance takes the biased batch variance,
    ``(1 - m) rv + m var`` (``F.batch_norm`` takes the unbiased one).  The
    stats are cast to x's dtype before use; ``inv = rsqrt(var + eps) *
    scale`` is formed in f32, then cast.  In evaluation the running stats
    are used as bound.  ``channel_axis`` 1 is NCHW, -1 channels-last."""

    def __init__(self, x, scale, bias, momentum=0.1, eps=1e-5,
                 precise_stats=False, channel_axis=1, name=None):
        if not isinstance(scale, VariableOp):
            raise TypeError("BatchNorm scale must be a Variable")
        base = name or f"bn_{scale.name}"
        c = scale.shape[0]
        self.running_mean = VariableOp(base + "_running_mean", (c,),
                                       init.zeros(), trainable=False)
        self.running_var = VariableOp(base + "_running_var", (c,),
                                      init.ones(), trainable=False)
        super().__init__(x, scale, bias, self.running_mean, self.running_var,
                         name=base)
        self.momentum = momentum
        self.eps = eps
        self.precise_stats = precise_stats
        self.channel_axis = channel_axis

    def _compute(self, input_vals, ctx):
        x, scale, bias, rmean, rvar = input_vals
        ax = self.channel_axis % x.dim()
        vec = [1] * x.dim()
        vec[ax] = -1
        vec = tuple(vec)
        red = tuple(i for i in range(x.dim()) if i != ax)
        if ctx.training:
            xf = x.float()
            m = self.momentum
            master = ctx.master_params
            rm = (master[self.running_mean.name] if master is not None
                  else rmean).float()
            rv = (master[self.running_var.name] if master is not None
                  else rvar).float()
            if self.precise_stats:
                mean = xf.mean(dim=red)
                var = (xf - mean.reshape(vec)).square().mean(dim=red)
            else:
                mean, var = ShiftedStats.apply(xf, rm.detach(), red, vec)
            with torch.no_grad():
                ctx.record_update(self.running_mean, (1 - m) * rm + m * mean)
                ctx.record_update(self.running_var, (1 - m) * rv + m * var)
            mean = mean.to(x.dtype)
            var = var.to(x.dtype)
        else:
            mean, var = rmean, rvar
        inv = (torch.rsqrt(var.float() + self.eps) * scale.float()).to(
            x.dtype)
        return (x - mean.reshape(vec)) * inv.reshape(vec) + bias.reshape(vec)


def batch_normalization_op(x, scale, bias, momentum=0.1, eps=1e-5,
                           precise_stats=False, channel_axis=1, name=None):
    return BatchNormOp(x, scale, bias, momentum=momentum, eps=eps,
                       precise_stats=precise_stats,
                       channel_axis=channel_axis, name=name)


class DropoutOp(Op):
    """Inverted dropout: in training, keep each element with probability
    ``keep_prob`` (a uniform draw from the executor's generator) and scale
    it by 1/keep_prob, in x's dtype; the identity in evaluation."""

    def __init__(self, x, keep_prob=0.9, name=None):
        super().__init__(x, name=name)
        self.keep_prob = keep_prob

    def _compute(self, input_vals, ctx):
        (x,) = input_vals
        if not ctx.training or self.keep_prob >= 1.0:
            return x
        keep = torch.rand(x.shape, generator=ctx.rng_for(self),
                          device=x.device) < self.keep_prob
        return torch.where(keep, x / self.keep_prob, torch.zeros_like(x))


def dropout_op(x, keep_prob=0.9, name=None):
    return DropoutOp(x, keep_prob=keep_prob, name=name)
