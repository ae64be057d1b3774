"""The MoE dispatch and combine gather on Hopper (``row_gather``).

Port of ``hetu_tpu/ops/pallas/moe_dispatch.py``.  Once the routing is
known, both directions of the MoE layer's token movement are row gathers:

    dispatch:  expert_in[slot] = tokens[slot_to_token[slot]]
    combine:   out[t]         += gate_c[t] * expert_out[token_to_slot_c[t]]

``row_gather(src, idx)`` gives ``out[i] = src[idx[i]]`` for
``0 <= idx[i] < n`` and a zero row for every other index, negative ones
included.  It replaces the Pallas TPU kernel reached through the JAX
``row_gather`` (``pl.pallas_call`` at line 124) with the CUDA kernel
``hetu_tpu_torch/csrc/row_gather.cu``, whose header says what bounds it.
The kernel's envelope is the reference's (``_supported`` without its
backend check): h % 128 == 0, h <= 16384, f32 or bf16.  Outside it, the
reference runs ``jnp.take`` with a zero fill; the port runs the same
composition, ``row_gather_plain``, on any device.  Inside it, a CUDA
tensor launches the kernel or raises, and a CPU tensor runs
``row_gather_plain``.  The backward is the reference's scatter-add of the
cotangent rows (``_row_gather_bwd``), a plain composition in both packages.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_SOURCE = "row_gather.cu"
_fn = []


def _supported(src_shape, dtype):
    """The reference's kernel envelope (``_supported``, without its TPU
    backend check)."""
    _, h = src_shape
    if h % 128 != 0 or h > 16384:
        return False
    return dtype in (torch.float32, torch.bfloat16)


def row_gather_plain(src, idx):
    """out[i] = src[idx[i]] for 0 <= idx[i] < n, else zeros: the JAX
    package's composition outside its kernel envelope (``jnp.take`` with a
    zero fill after sending negative indices out of range), as an
    ``index_select`` of the clamped index and a mask."""
    n = src.shape[0]
    idx = idx.reshape(-1)
    valid = (idx >= 0) & (idx < n)
    rows = src.index_select(0, idx.clamp(0, n - 1))
    return torch.where(valid[:, None], rows, torch.zeros((), dtype=src.dtype,
                                                         device=src.device))


def _kernel():
    if not _fn:
        fn = build.load(_SOURCE).hetu_row_gather
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def row_gather_kernel(src, idx):
    """The CUDA kernel: ``src`` [n, h] f32 or bf16 and ``idx`` [m] int32,
    contiguous on one CUDA device, inside the envelope; returns a new
    [m, h] tensor."""
    if not (src.is_cuda and idx.device == src.device):
        raise ValueError("row_gather_kernel: src and idx must lie on one "
                         "CUDA device")
    if idx.dtype != torch.int32 or src.dtype not in (torch.float32,
                                                     torch.bfloat16):
        raise TypeError("row_gather_kernel: idx int32, src f32 or bf16")
    if (src.dim() != 2 or idx.dim() != 1
            or not _supported(src.shape, src.dtype)
            or not (src.is_contiguous() and idx.is_contiguous())
            or src.data_ptr() % 16):
        raise ValueError("row_gather_kernel: contiguous src [n, h] with "
                         "h % 128 == 0 and h <= 16384, 16-byte aligned, and "
                         "idx [m]")
    n, h = src.shape
    m = idx.shape[0]
    out = torch.empty(m, h, dtype=src.dtype, device=src.device)
    err = _kernel()(src.data_ptr(), idx.data_ptr(), out.data_ptr(), n, m, h,
                    src.element_size(),
                    torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"row_gather_kernel: launch failed with CUDA error {err}")
    if m:  # no rows launch nothing
        row_gather_kernel.launches += 1
    return out


row_gather_kernel.launches = 0


def _row_gather_fwd(src, idx):
    if src.device.type == "cpu" or not _supported(src.shape, src.dtype):
        return row_gather_plain(src, idx)
    src = src.contiguous()
    if src.data_ptr() % 16:  # the kernel moves 16-byte words
        src = src.clone()
    return row_gather_kernel(src, idx.to(torch.int32).contiguous())


class RowGatherFn(torch.autograd.Function):
    """``row_gather`` with the reference's backward (``_row_gather_bwd``):
    the cotangent rows scatter-added back to their sources, zeros for the
    out-of-range ones."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.n = src.shape[0]
        return _row_gather_fwd(src, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        n = ctx.n
        valid = (idx >= 0) & (idx < n)
        safe = idx.clamp(0, n - 1).long()
        ct = torch.where(valid[:, None], ct, torch.zeros((), dtype=ct.dtype,
                                                         device=ct.device))
        d_src = torch.zeros(n, ct.shape[1], dtype=ct.dtype, device=ct.device)
        return d_src.index_add_(0, safe, ct), None


def row_gather(src, idx):
    """out[i] = src[idx[i]] for 0 <= idx[i] < src.shape[0], else zeros;
    differentiable in ``src``.  src [n, h], idx [m] integer -> [m, h]."""
    return RowGatherFn.apply(src, idx.reshape(-1))
