"""Flash-attention forward on Hopper: wrapper, plain version, launch count.

Replaces the Pallas TPU kernel ``_fwd_kernel`` reached through ``_fwd`` in
``hetu_tpu/ops/pallas/flash_attention.py`` (``pl.pallas_call`` at line
266).  The CUDA source is ``hetu_tpu_torch/csrc/flash_attention_fwd.cu``;
its header says what bounds it on the H100 and what the design does about
that.  The TPU kernel's 512-row blocks were sized for v5e VMEM; the Hopper
kernel uses 64x64 tiles that fit shared memory and masks ragged S and d
inside the kernel instead of padding.

``flash_attention_fwd`` keeps the JAX wrapper's observable contract: it
returns None outside ``_supported`` (the caller then runs the attention
composition), and otherwise the attention of the given shapes, as if S were
padded to the kernel's tiles with masked keys and d with zero columns.  On
a CPU tensor it runs ``flash_attention_plain``; on a CUDA tensor it
launches the kernel or raises.  The dropout and global-offset paths of the
TPU kernel (training, ring attention) arrive with later slices.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_BIG = -1e30      # running-max floor: scores below it carry no weight
EMPTY_LSE = 1e30     # lse of a row with no live key

_SOURCE = "flash_attention_fwd.cu"
_lib = None


def _supported(q, k, v, mask):
    """The JAX wrapper's envelope (hetu_tpu/ops/pallas/flash_attention.py
    ``_supported``)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        return False
    b, h, s, d = q.shape
    if d > 512 or s < 128:
        return False
    if mask is not None and tuple(mask.shape) != (b, 1, 1, s):
        return False
    return True


def flash_attention_plain(q, k, v, mask=None, causal=False, scale=None):
    """The kernel's function in plain PyTorch: the [B,H,S,S] softmax in
    f32 with the kernel's masking and empty-row semantics.  Returns
    (o in q's dtype, lse [B,H,S] f32)."""
    b, h, s, d = q.shape
    if scale is None:
        scale = 1.0 / d ** 0.5
    s2 = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * LOG2E)
    if mask is not None:
        s2 = s2 + mask.float().reshape(b, 1, 1, s) * LOG2E
    if causal:
        above = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        s2 = s2.masked_fill(above, float("-inf"))
    m = s2.amax(dim=-1, keepdim=True).clamp_min(NEG_BIG)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0
    o = torch.matmul(p, v.float()) / torch.where(empty, 1.0, l)
    lse = torch.where(empty, EMPTY_LSE, m * LN2 + torch.log(l))
    return o.to(q.dtype), lse.squeeze(-1)


def _load():
    global _lib
    if _lib is None:
        lib = build.load(_SOURCE)
        fn = lib.hetu_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_attention_fwd(q, k, v, mask=None, causal=False, scale=None,
                        dropout_keep=1.0):
    """Fused attention forward: (o [B,H,S,d] in q's dtype, lse [B,H,S]
    f32), or None for shapes outside the envelope.

    q, k, v: [B,H,S,d] f32 or bf16; mask: additive [B,1,1,S] or None.
    """
    if not _supported(q, k, v, mask):
        return None
    if dropout_keep < 1.0:
        raise NotImplementedError(
            "flash attention dropout arrives with slice A2 of the port "
            "(ROADMAP.md)")
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash attention backward (dQ, dK/dV kernels) arrives with "
            "slice A2 of the port (ROADMAP.md)")
    b, h, s, d = q.shape
    if scale is None:
        scale = 1.0 / d ** 0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, causal, scale)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention_fwd: unsupported dtype {q.dtype}")
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError("flash_attention_fwd: q, k and v must share "
                            "dtype and device")
    q, k, v = (t.contiguous() for t in (q, k, v))
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.float32).reshape(
            b, s).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _load().hetu_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        o.data_ptr(), lse.data_ptr(), b, h, s, d, int(bool(causal)),
        float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_fwd: kernel launch failed with CUDA error {err}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
