"""Fused sparse softmax cross-entropy forward on Hopper (Triton).

Replaces the Pallas TPU kernel ``_fwd_kernel`` reached through ``_fwd`` in
``hetu_tpu/ops/pallas/softmax_ce.py`` (``pl.pallas_call`` at line 109):
per-row loss = lse - x[label] with an online max / sum-exp / target-logit
over the vocab, the ragged vocab tail masked, loss 0 on ignored rows (which
still get their lse), and an out-of-range label picking nothing (loss =
lse).

What bounds it on the H100: one read of the [N, V] logits (N*V*2 bytes in
bf16, ~500 MB for the BERT-base MLM bucket) at 3.35 TB/s; the arithmetic
(one exp, a max and two adds per element) is far below the card's rate.
The TPU kernel carries (m, l, x_target) across its sequential vocab grid
axis in VMEM scratch; GPU blocks run in no order, so here the vocab loop
runs inside one program per row, which reads its row exactly once in
4096-wide chunks.

On a CPU tensor the wrapper runs ``softmax_ce_plain``; on a CUDA tensor it
launches the kernel or raises.  The backward kernel arrives with slice A2.
"""

from __future__ import annotations

import math

import torch

_BLOCK_N = 1       # rows per program
_BLOCK_V = 4096    # vocab lanes per chunk
_NUM_WARPS = 8
_NEG = -1e30
_kernel = None


def _build_kernel():
    """Compile the Triton kernel (imported here: the CPU build has none)."""
    global _kernel
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit
    def _ce_fwd_kernel(x_ptr, lab_ptr, loss_ptr, lse_ptr, N, V, stride_row,
                       ignored, BLOCK_N: tl.constexpr, BLOCK_V: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
        row_ok = rows < N
        lab = tl.load(lab_ptr + rows, mask=row_ok, other=ignored)
        row_ptr = x_ptr + rows.to(tl.int64)[:, None] * stride_row
        m = tl.full([BLOCK_N], -1e30, tl.float32)
        l = tl.zeros([BLOCK_N], tl.float32)
        xt = tl.zeros([BLOCK_N], tl.float32)
        for start in range(0, V, BLOCK_V):
            cols = start + tl.arange(0, BLOCK_V)
            valid = row_ok[:, None] & (cols < V)[None, :]
            x = tl.load(row_ptr + cols[None, :], mask=valid,
                        other=-1e30).to(tl.float32)
            m_new = tl.maximum(m, tl.max(x, axis=1))
            l = l * tl.exp(m - m_new) + tl.sum(tl.exp(x - m_new[:, None]),
                                               axis=1)
            m = m_new
            hit = valid & (cols[None, :] == lab[:, None])
            xt += tl.sum(tl.where(hit, x, 0.0), axis=1)
        lse = m + tl.log(tl.maximum(l, 1e-37))
        loss = tl.where(lab == ignored, 0.0, lse - xt)
        tl.store(loss_ptr + rows, loss, mask=row_ok)
        tl.store(lse_ptr + rows, lse, mask=row_ok)

    _kernel = _ce_fwd_kernel
    return _kernel


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


def softmax_ce_fwd(logits, labels, ignored_index=-1):
    """Per-row sparse softmax CE of [N, V] logits: (loss, lse) f32 [N]."""
    if logits.requires_grad:
        raise NotImplementedError(
            "the softmax-CE backward kernel arrives with slice A2 of the port "
            "(ROADMAP.md)")
    n, v = logits.shape
    if logits.device.type == "cpu":
        return softmax_ce_plain(logits, labels, ignored_index)
    if not logits.is_cuda:
        raise ValueError(f"softmax_ce_fwd: unsupported device {logits.device}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"softmax_ce_fwd: unsupported dtype {logits.dtype}")
    if logits.stride(-1) != 1:
        logits = logits.contiguous()
    labels = labels.to(device=logits.device, dtype=torch.int32).contiguous()
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty(n, dtype=torch.float32, device=logits.device)
    kernel = _build_kernel()
    kernel[(math.ceil(n / _BLOCK_N),)](
        logits, labels, loss, lse, n, v, logits.stride(0), int(ignored_index),
        BLOCK_N=_BLOCK_N, BLOCK_V=_BLOCK_V, num_warps=_NUM_WARPS)
    softmax_ce_fwd.launches += 1
    return loss, lse


softmax_ce_fwd.launches = 0


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
    loss, _ = softmax_ce_fwd(y.reshape(n, v), labels.reshape(n),
                             ignored_index=ignored_index)
    return loss.reshape(y.shape[:-1])
