"""Fused sparse softmax cross-entropy on Hopper (Triton): the forward and
backward kernels, their plain versions, launch counts, and the autograd
function that joins them.

Forward: replaces the Pallas TPU kernel ``_fwd_kernel`` reached through
``_fwd`` in ``hetu_tpu/ops/pallas/softmax_ce.py`` (``pl.pallas_call`` at
line 109): per-row loss = lse - x[label] with an online max / sum-exp /
target-logit over the vocab, the ragged vocab tail masked, loss 0 on
ignored rows (which still get their lse), and an out-of-range label
picking nothing (loss = lse).  What bounds it on the H100: one read of the
[N, V] logits (N*V*2 bytes in bf16, 500 MB for the BERT-base MLM bucket,
0.149 ms at 3.35 TB/s).  The TPU kernel carries (m, l, x_target) across
its sequential vocab grid axis in VMEM scratch; GPU blocks run in no
order, so here the vocab loop runs inside one program per ``_FWD["rows"]``
rows, which reads each row once in ``_FWD["block_v"]``-wide chunks.  So
that the loop is loads and lane-local arithmetic only, each lane keeps its
own running max and sum of exp2 across the chunks (log2(e) folded into
the logits), updated with one exp2 an element: with d = y - m,
s <- s + 2^-|d| if d <= 0, else s 2^-|d| + 1.  The lanes are reduced
across the program once, at the row's end, and the target logit is one
scalar load of x[row, label], guarded to 0 <= label < V.  The chunk
width, warps, rows per program and pipeline stages were chosen from the
sweep that ``chip_smoke.py`` times (``kernel_times``).

Backward: replaces ``_bwd_kernel`` reached through ``_bwd`` (line 140):
dx = (exp(x - lse) - onehot(label)) * g per row, the ragged tail masked,
zero on ignored rows, dx in the logits' dtype (softmax_ce.py:77-89).  It
is one elementwise pass with per-row scalars, bound by one read and one
write of [N, V] (~1 GB in bf16 at the MLM bucket, 0.3 ms at 3.35 TB/s);
one program per (row, 4096-wide vocab chunk) reads its chunk once and
writes it once, with the row's label, lse and g loaded as scalars.

Each wrapper runs its plain version on a CPU tensor and on a CUDA tensor
launches its kernel or raises.  ``SoftmaxCEFn`` is the differentiable form
(``fused_softmax_ce_sparse`` applies it).
"""

from __future__ import annotations

import math

import torch

# the forward's launch: rows per program, vocab lanes per chunk, warps and
# software-pipeline stages of the vocab loop (from chip_smoke.py's sweep)
_FWD = dict(rows=2, block_v=2048, num_warps=4, num_stages=3)
_BLOCK_V = 4096    # the backward's vocab lanes per program
_NUM_WARPS = 8     # the backward's warps
_kernels = {}


def _build_kernels():
    """Compile the Triton kernels (imported here: the CPU build has
    none); returns {"fwd": ..., "bwd": ...}."""
    if _kernels:
        return _kernels
    import triton
    import triton.language as tl

    @triton.jit
    def _ce_fwd_kernel(x_ptr, lab_ptr, loss_ptr, lse_ptr, N, V, stride_row,
                       ignored, BLOCK_N: tl.constexpr, BLOCK_V: tl.constexpr,
                       NUM_STAGES: tl.constexpr):
        LOG2E: tl.constexpr = 1.4426950408889634
        rows = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
        row_ok = rows < N
        row_ptr = x_ptr + rows.to(tl.int64)[:, None] * stride_row
        # per lane: running max m of y = x log2(e), and s = sum 2^(y - m)
        m = tl.full([BLOCK_N, BLOCK_V], -1e30, tl.float32)
        s = tl.zeros([BLOCK_N, BLOCK_V], tl.float32)
        for start in tl.range(0, V, BLOCK_V, num_stages=NUM_STAGES):
            cols = start + tl.arange(0, BLOCK_V)
            valid = row_ok[:, None] & (cols < V)[None, :]
            y = tl.load(row_ptr + cols[None, :], mask=valid,
                        other=float("-inf")).to(tl.float32) * LOG2E
            d = y - m
            e = tl.math.exp2(-tl.abs(d))
            s = tl.where(d > 0, s * e + 1.0, s + e)
            m = tl.maximum(m, y)
        row_max = tl.max(m, axis=1)
        total = tl.sum(s * tl.math.exp2(m - row_max[:, None]), axis=1)
        lse = (row_max + tl.math.log2(total)) / LOG2E
        lab = tl.load(lab_ptr + rows, mask=row_ok, other=ignored)
        hit = row_ok & (lab >= 0) & (lab < V)
        xt = tl.load(x_ptr + rows.to(tl.int64) * stride_row + lab, mask=hit,
                     other=0.0).to(tl.float32)
        loss = tl.where(lab == ignored, 0.0, lse - xt)
        tl.store(loss_ptr + rows, loss, mask=row_ok)
        tl.store(lse_ptr + rows, lse, mask=row_ok)

    @triton.jit
    def _ce_bwd_kernel(x_ptr, lab_ptr, lse_ptr, g_ptr, dx_ptr, V, stride_x,
                       stride_dx, ignored, BLOCK_V: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK_V + tl.arange(0, BLOCK_V)
        valid = cols < V
        lab = tl.load(lab_ptr + row)
        lse = tl.load(lse_ptr + row)
        g = tl.load(g_ptr + row)
        x = tl.load(x_ptr + row.to(tl.int64) * stride_x + cols, mask=valid,
                    other=0.0).to(tl.float32)
        p = tl.exp(x - lse)
        d = (p - tl.where(cols == lab, 1.0, 0.0)) * g
        d = tl.where(lab == ignored, 0.0, d)
        tl.store(dx_ptr + row.to(tl.int64) * stride_dx + cols,
                 d.to(dx_ptr.dtype.element_ty), mask=valid)

    _kernels.update(fwd=_ce_fwd_kernel, bwd=_ce_bwd_kernel)
    return _kernels


def softmax_ce_plain(logits, labels, ignored_index=-1):
    """The kernel's function in plain PyTorch: (loss, lse), both f32 [N]."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    labels = labels.long()
    in_range = (labels >= 0) & (labels < x.shape[-1])
    picked = torch.gather(
        x, -1, labels.clamp(0, x.shape[-1] - 1).unsqueeze(-1)).squeeze(-1)
    loss = lse - torch.where(in_range, picked, torch.zeros_like(picked))
    loss = torch.where(labels == ignored_index, torch.zeros_like(loss), loss)
    return loss, lse


def softmax_ce_bwd_plain(logits, labels, lse, g, ignored_index=-1):
    """The backward kernel's function in plain PyTorch: dx [N, V] in the
    logits' dtype, (exp(x - lse) - onehot) * g, zero on ignored rows."""
    x = logits.float()
    labels = labels.long()
    onehot = torch.arange(x.shape[-1], device=x.device) == labels[:, None]
    d = (torch.exp(x - lse.float()[:, None]) - onehot.float()) \
        * g.float()[:, None]
    d = torch.where((labels == ignored_index)[:, None], 0.0, d)
    return d.to(logits.dtype)


def _check(name, logits):
    if not logits.is_cuda:
        raise ValueError(f"{name}: unsupported device {logits.device}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported dtype {logits.dtype}")
    return logits if logits.stride(-1) == 1 else logits.contiguous()


def softmax_ce_fwd(logits, labels, ignored_index=-1):
    """Per-row sparse softmax CE of [N, V] logits: (loss, lse) f32 [N].
    Not differentiable: ``SoftmaxCEFn`` is the form with a backward."""
    if torch.is_grad_enabled() and logits.requires_grad:
        raise RuntimeError("softmax_ce_fwd has no gradient; call SoftmaxCEFn "
                           "(fused_softmax_ce_sparse) to train")
    if logits.device.type == "cpu":
        return softmax_ce_plain(logits, labels, ignored_index)
    out = launch_fwd(logits, labels, ignored_index, **_FWD)
    softmax_ce_fwd.launches += 1
    return out


def launch_fwd(logits, labels, ignored_index, rows, block_v, num_warps,
               num_stages):
    """One launch of the forward kernel with the given launch parameters:
    (loss, lse).  ``softmax_ce_fwd`` launches it with ``_FWD``;
    ``chip_smoke.py`` times the others of its sweep through it."""
    n, v = logits.shape
    logits = _check("softmax_ce_fwd", logits)
    labels = labels.to(device=logits.device, dtype=torch.int32).contiguous()
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty(n, dtype=torch.float32, device=logits.device)
    _build_kernels()["fwd"][(math.ceil(n / rows),)](
        logits, labels, loss, lse, n, v, logits.stride(0), int(ignored_index),
        BLOCK_N=rows, BLOCK_V=block_v, NUM_STAGES=num_stages,
        num_warps=num_warps, num_stages=num_stages)
    return loss, lse


softmax_ce_fwd.launches = 0


def softmax_ce_bwd(logits, labels, lse, g, ignored_index=-1):
    """d loss_rows / d logits scaled by the row cotangents ``g`` (f32
    [N]): dx [N, V] in the logits' dtype."""
    n, v = logits.shape
    if logits.device.type == "cpu":
        return softmax_ce_bwd_plain(logits, labels, lse, g, ignored_index)
    logits = _check("softmax_ce_bwd", logits)
    dev = logits.device
    labels = labels.to(device=dev, dtype=torch.int32).contiguous()
    lse, g = (t.to(device=dev, dtype=torch.float32).contiguous()
              for t in (lse, g))
    dx = torch.empty((n, v), dtype=logits.dtype, device=dev)
    _build_kernels()["bwd"][(n, math.ceil(v / _BLOCK_V))](
        logits, labels, lse, g, dx, v, logits.stride(0), dx.stride(0),
        int(ignored_index), BLOCK_V=_BLOCK_V, num_warps=_NUM_WARPS)
    softmax_ce_bwd.launches += 1
    return dx


softmax_ce_bwd.launches = 0


class SoftmaxCEFn(torch.autograd.Function):
    """Per-row losses of [N, V] logits through the forward kernel, with the
    backward kernel as its backward (the JAX package's ``custom_vjp``);
    labels have no gradient."""

    @staticmethod
    def forward(ctx, logits, labels, ignored_index):
        loss, lse = softmax_ce_fwd(logits, labels, ignored_index)
        ctx.save_for_backward(logits, labels, lse)
        ctx.ignored_index = ignored_index
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        dx = softmax_ce_bwd(logits, labels, lse, g.float(),
                            ctx.ignored_index)
        return dx, None, None


def fused_softmax_ce_sparse(y, labels, ignored_index=-1):
    """Per-row CE losses (f32) over the last dim of ``y``; None when the
    shape is not worth the kernel (V < 1024 or N < 8), as in the JAX
    package, so the caller runs the plain form."""
    if y.dim() < 2:
        return None
    v = y.shape[-1]
    n = math.prod(y.shape[:-1])
    if v < 1024 or n < 8:
        return None
    loss = SoftmaxCEFn.apply(y.reshape(n, v), labels.reshape(n),
                             int(ignored_index))
    return loss.reshape(y.shape[:-1])
