"""Flash attention on Hopper: the forward (with dropout), dQ and dK/dV
kernels, their plain versions, launch counts, and the autograd function
that joins them.

Replaces the Pallas TPU kernels of ``hetu_tpu/ops/pallas/flash_attention.py``:
``_fwd_kernel`` reached through ``_fwd`` (``pl.pallas_call`` at line 266),
and ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` reached through
``_bwd_impl`` (lines 448 and 463).  The CUDA sources are
``hetu_tpu_torch/csrc/flash_attention_fwd.cu`` and
``flash_attention_bwd.cu`` (with ``flash_hopper.cuh``); their headers
say what bounds each kernel on the H100 and what the design does about
it.  The TPU kernels' 512-row blocks were sized for v5e VMEM; the Hopper
kernels use tiles that fit shared memory and mask ragged S and d inside
the kernel instead of padding.  Each launch takes the kernel that
``flash_route`` names from its dtype and shape, never another on failure:
the wgmma kernels for bf16 heads of 64, 80 and 128 (the forward and dQ
on 128-row q tiles with TMA-fed K/V stages, dK/dV on 128-key items with
TMA-fed Q/dO stages; a head of 80 in two 64-column halves), the mma.sync
kernels for the other bf16 heads up to 128 and for the shapes the wgmma
kernels do not tile (Sq or Sk below 128, ring groups that are not whole
128-row tiles), the plain-FMA kernels for f32 and the rest.
``route_launches`` counts the launches of each (kernel, route).

Dropout: the TPU kernels reseed the TPU PRNG per (seed, tile).  Here an
element's keep bit is a stateless hash of (seed, bh, row, col) in global
coordinates (``csrc/dropout_hash.cuh``), so the backward kernels replay it
although they tile differently, and ``dropout_keep_mask_plain`` computes
the same bits with int64 tensor arithmetic.  The seed is an int32 tensor on
the device, read by the kernels through a pointer.

``flash_attention_fwd`` keeps the JAX wrapper's observable contract: it
returns None outside ``_supported`` (the caller then runs the attention
composition), and otherwise the attention of the given shapes, as if S were
padded to the kernel's tiles with masked keys and d with zero columns.
Every wrapper runs its plain version on a CPU tensor and on a CUDA tensor
launches its kernel or raises.  ``FlashAttentionFn`` is the differentiable
form (``flash_attention`` applies it).

The blockwise API of ring attention, ``flash_attention_block`` and
``flash_attention_block_bwd`` (the JAX functions at lines 551 and 568, the
same three TPU kernels run with global offsets), attends one q block to one
K/V block of another length at global positions, and gives a row with no
live key in the block lse = -1e30 and o = 0.  With ``ring=(n, r)`` one call
is step r of a ring over n ranks for all of them at once: q and K/V hold
the ranks' blocks in order along the sequence, and the rows of rank g
attend the block of rank (g - r) mod n, the block that r rotations of the
ring bring to rank g.  The offsets are Python ints, computed on the host.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import build

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_BIG = -1e30      # running-max floor: scores below it carry no weight
EMPTY_LSE = 1e30     # lse of a row with no live key
BLOCK_EMPTY_LSE = -1e30  # ... in one block of the blockwise API

_FWD_SOURCE = "flash_attention_fwd.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"
_libs = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: (source, argtypes)
    "hetu_flash_attention_fwd": (
        _FWD_SOURCE, [_P] * 7 + [_I] * 5 + [ctypes.c_float, ctypes.c_uint32,
                                            ctypes.c_float, _I, _I, _P]),
    "hetu_dropout_keep_mask": (
        _FWD_SOURCE, [_P] * 2 + [_I] * 3 + [ctypes.c_uint32, _P]),
    "hetu_flash_attention_bwd_dq": (
        _BWD_SOURCE, [_P] * 9 + [_I] * 5 + [ctypes.c_float, ctypes.c_uint32,
                                            ctypes.c_float, _I, _I, _P]),
    "hetu_flash_attention_bwd_dkv": (
        _BWD_SOURCE, [_P] * 10 + [_I] * 5 + [ctypes.c_float, ctypes.c_uint32,
                                             ctypes.c_float, _I, _I, _P]),
    "hetu_flash_attention_block_fwd": (
        _FWD_SOURCE, [_P] * 5 + [_I] * 10 + [ctypes.c_float, _I, _I, _P]),
    "hetu_flash_attention_block_bwd": (
        _BWD_SOURCE, [_I] + [_P] * 9 + [_I] * 10 + [ctypes.c_float, _I, _I,
                                                     _P]),
}


def _fn(name):
    """The C entry point ``name``, its library built on first use."""
    fn = _libs.get(name)
    if fn is None:
        source, argtypes = _SIGNATURES[name]
        fn = getattr(build.load(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = fn
    return fn


def _launch(name, *args):
    err = _fn(name)(*args)
    if err != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed with CUDA error {err}")


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


# -- routes ------------------------------------------------------------------

_ROUTE_CODE = {"simt": 0, "mma": 1, "wgmma": 2}  # the C entry points' route
WGMMA_ROWS = 128  # rows of a wgmma item, the least Sq and Sk it takes
# the heads the three wgmma kernels take: their 64-column tile halves also
# hold d = 80 (GPT-3 2.7B's heads), the second half in part
WGMMA_HEADS = (64, 80, 128)

# launches of each kernel ("fwd", "dq", "dkv": the self-attention and the
# blockwise entry points together) by route, beside the entry points' own
# counts
route_launches = collections.Counter()


def flash_route(kernel, dtype, d, sq, sk, n=1):
    """The CUDA kernel that a launch of ``kernel`` ("fwd", "dq" or "dkv")
    takes, a pure function of dtype and shape:

    - "wgmma" (Hopper: TMA-fed stages, wgmma products) on bf16 heads of
      d = 64, 80 or 128 (``WGMMA_HEADS``),
      with Sq, Sk >= 128 and, in a ring of n > 1 groups,
      groups of whole 128-row tiles of the rows the kernel tiles by: the
      q rows (Sq / n) for the forward and dQ, whose items are 128-row q
      tiles, and the K/V rows (Sk / n) for dK/dV, whose items are 128-key
      kv tiles;
    - "mma" (mma.sync m16n8k16) for the other bf16 heads with d % 8 == 0
      and d <= 128, and for those three heads where the wgmma rule fails
      (Sq or Sk < 128, ring groups of 64 or 192 rows);
    - "simt" (plain FMA, f32 accumulation) for f32 and the remaining bf16
      heads (d <= 512).
    """
    if dtype == torch.bfloat16:
        group = sk // n if kernel == "dkv" else sq // n
        if (d in WGMMA_HEADS and min(sq, sk) >= WGMMA_ROWS
                and (n == 1 or group % WGMMA_ROWS == 0)):
            return "wgmma"
        if d % 8 == 0 and d <= 128:
            return "mma"
    return "simt"


# -- dropout keep bits -------------------------------------------------------

_M32 = 0xFFFFFFFF


def keep_threshold(keep_prob):
    """uint32 threshold: bits < threshold <=> keep (``_keep_threshold``)."""
    return min(int(keep_prob * 4294967296.0), 4294967295)


def _mul32(a, c):
    """(a * c) mod 2^32 for int64 tensors a in [0, 2^32) and a constant c in
    [0, 2^32): split a into 16-bit halves so no product reaches 2^63."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _mix(h, x):
    return _fmix32(((h ^ x) + 0x9E3779B9) & _M32)


def dropout_keep_mask_plain(seed, bh, sq, sk, keep_prob):
    """The kernels' keep bits as a bool [bh, sq, sk] tensor, computed in
    int64 arithmetic exactly as ``csrc/dropout_hash.cuh`` does in uint32.

    ``seed``: an int or a one-element integer tensor (its int32 bit pattern
    is the seed); the result lies on the seed tensor's device."""
    device = seed.device if isinstance(seed, torch.Tensor) else None
    seed = torch.as_tensor(seed, device=device).reshape(()).long() & _M32
    ar = lambda n: torch.arange(n, device=seed.device)  # noqa: E731
    rk = _mix(_mix(_fmix32(seed), ar(bh)[:, None, None]),
              ar(sq)[None, :, None])
    return _mix(rk, ar(sk)[None, None, :]) < keep_threshold(keep_prob)


def dropout_keep_mask(seed, bh, sq, sk, keep_prob):
    """The keep bits from the CUDA helper kernel (bool [bh, sq, sk]), the
    counterpart of the Pallas test kernel that extracts the TPU kernel's
    masks; ``dropout_keep_mask_plain`` for a CPU seed."""
    if seed.device.type == "cpu":
        return dropout_keep_mask_plain(seed, bh, sq, sk, keep_prob)
    seed = _check_seed(seed, seed.device)
    out = torch.empty((bh, sq, sk), dtype=torch.uint8, device=seed.device)
    _launch("hetu_dropout_keep_mask", seed.data_ptr(), out.data_ptr(), bh,
            sq, sk, keep_threshold(keep_prob),
            torch.cuda.current_stream(seed.device).cuda_stream)
    dropout_keep_mask.launches += 1
    return out.bool()


dropout_keep_mask.launches = 0


def _check_seed(seed, device):
    if (not isinstance(seed, torch.Tensor) or seed.numel() != 1
            or seed.dtype != torch.int32 or seed.device != device):
        raise TypeError("the dropout seed must be a one-element int32 tensor "
                        f"on {device}")
    return seed.contiguous()


# -- plain versions ----------------------------------------------------------

def _scores_log2(q, k, mask, causal, scale, q_off=0, k_off=0):
    """Base-2 scores in f32 with the kernels' key mask and causal
    exclusion by global position (q row i at q_off + i, key j at k_off +
    j): [B, H, Sq, Sk]."""
    b, sq, sk = q.shape[0], q.shape[2], k.shape[2]
    s2 = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * LOG2E)
    if mask is not None:
        s2 = s2 + mask.float().reshape(b, 1, 1, sk) * LOG2E
    if causal:
        rows = q_off + torch.arange(sq, device=q.device)
        keys = k_off + torch.arange(sk, device=q.device)
        s2 = s2.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
    return s2


def _keep_mask(seed, shape, keep_prob):
    b, h, s, _ = shape
    return dropout_keep_mask_plain(seed, b * h, s, s, keep_prob).reshape(
        b, h, s, s)


def flash_attention_plain(q, k, v, mask=None, causal=False, scale=None,
                          dropout_keep=1.0, seed=None):
    """The forward kernel's function in plain PyTorch: the [B,H,S,S]
    softmax in f32 with the kernel's masking, empty-row semantics and
    dropout (the row sums l stay un-dropped).  Returns (o in q's dtype,
    lse [B,H,S] f32)."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    return _attend_plain(q, k, v, mask, causal, scale, dropout_keep, seed,
                         0, 0, EMPTY_LSE)


def _attend_plain(q, k, v, mask, causal, scale, dropout_keep, seed, q_off,
                  k_off, empty_lse):
    """(o, lse) of the forward kernel in plain PyTorch; ``empty_lse`` is
    the lse of a row with no live key."""
    s2 = _scores_log2(q, k, mask, causal, scale, q_off, k_off)
    m = s2.amax(dim=-1, keepdim=True).clamp_min(NEG_BIG)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_keep < 1.0:
        keep = _keep_mask(seed, q.shape, dropout_keep)
        p = torch.where(keep, p / dropout_keep, 0.0)
    empty = l == 0
    o = torch.matmul(p, v.float()) / torch.where(empty, 1.0, l)
    lse = torch.where(empty, empty_lse, m * LN2 + torch.log(l))
    return o.to(q.dtype), lse.squeeze(-1)


def _bwd_plain(q, k, v, do, lse, dsum, mask, causal, scale, dropout_keep,
               seed, q_off=0, k_off=0):
    """dQ, dK, dV in plain PyTorch from D = ``dsum``, as the two backward
    kernels compute them: P recomputed from (q, k, lse) in f32, dP dropped
    by the replayed mask, dS and P~ rounded to the inputs' dtype before
    their products (the TPU kernels' ``.astype``)."""
    s2 = _scores_log2(q, k, mask, causal, scale, q_off, k_off)
    p = torch.exp2(s2 - lse.float()[..., None] * LOG2E)
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    pd = p
    if dropout_keep < 1.0:
        keep = _keep_mask(seed, q.shape, dropout_keep)
        pd = torch.where(keep, p / dropout_keep, 0.0)
        dp = torch.where(keep, dp / dropout_keep, 0.0)
    ds = (p * (dp - dsum.float()[..., None])).to(q.dtype).float()
    pd = pd.to(q.dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(pd.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _dsum(o, do):
    """D = rowsum(dO * O) in f32, [B, H, S] (jnp outside the TPU kernels)."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, mask=None, causal=False,
                              scale=None, dropout_keep=1.0, seed=None):
    """The two backward kernels' function in plain PyTorch: (dq, dk, dv)
    in the inputs' dtypes, with P recomputed from (q, k, lse) in f32."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    return _bwd_plain(q, k, v, do, lse, _dsum(o, do), mask, causal, scale,
                      dropout_keep, seed)


# -- kernel wrappers ---------------------------------------------------------

def _prepare(name, q, k, v, mask, dropout_keep, seed, extra=()):
    """Validate CUDA inputs; returns contiguous (q, k, v, *extra), the mask
    as f32 [B, S] or None, the seed or None, and (thr, 1/keep)."""
    if not q.is_cuda:
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported dtype {q.dtype}")
    for t in (k, v, *extra):
        if t.dtype != q.dtype or t.device != q.device or t.shape != q.shape:
            raise TypeError(f"{name}: q, k, v (and dO) must share shape, "
                            "dtype and device")
    b, h, s, d = q.shape
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.float32).reshape(
            b, s).contiguous()
    if dropout_keep < 1.0:
        seed = _check_seed(seed, q.device)
        drop = (keep_threshold(dropout_keep), 1.0 / dropout_keep)
    else:
        seed, drop = None, (0, 1.0)
    tensors = [t.contiguous() for t in (q, k, v, *extra)]
    return tensors, mask, seed, drop


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd(q, k, v, mask=None, causal=False, scale=None,
                        dropout_keep=1.0, seed=None):
    """Fused attention forward: (o [B,H,S,d] in q's dtype, lse [B,H,S]
    f32), or None for shapes outside the envelope.

    q, k, v: [B,H,S,d] f32 or bf16; mask: additive [B,1,1,S] or None;
    ``dropout_keep`` < 1 drops attention probabilities with the keep bits
    of ``seed`` (a one-element int32 tensor on q's device).  Not
    differentiable: ``flash_attention`` is the form with a backward.
    """
    if not _supported(q, k, v, mask):
        return None
    if dropout_keep < 1.0 and seed is None:
        raise ValueError("flash_attention_fwd: dropout_keep < 1 requires "
                         "seed= (a one-element int32 tensor)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_fwd has no gradient; call "
                           "flash_attention (FlashAttentionFn) to train")
    b, h, s, d = q.shape
    if scale is None:
        scale = 1.0 / d ** 0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, causal, scale,
                                     dropout_keep, seed)
    (q, k, v), mask, seed, (thr, inv_keep) = _prepare(
        "flash_attention_fwd", q, k, v, mask, dropout_keep, seed)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    route = flash_route("fwd", q.dtype, d, s, s)
    _launch("hetu_flash_attention_fwd", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _ptr(mask), _ptr(seed), o.data_ptr(),
            lse.data_ptr(), b, h, s, d, int(bool(causal)), float(scale), thr,
            inv_keep, int(q.dtype == torch.bfloat16), _ROUTE_CODE[route],
            _stream(q))
    flash_attention_fwd.launches += 1
    route_launches["fwd", route] += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, dsum, mask=None, causal=False,
                           scale=None, dropout_keep=1.0, seed=None):
    """dQ [B,H,S,d] in q's dtype from the forward's lse and D = ``dsum``
    (both f32 [B,H,S])."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, dsum, mask, causal, scale,
                          dropout_keep, seed)[0]
    (q, k, v, do), mask, seed, (thr, inv_keep) = _prepare(
        "flash_attention_bwd_dq", q, k, v, mask, dropout_keep, seed, (do,))
    b, h, s, d = q.shape
    lse, dsum = (t.float().contiguous() for t in (lse, dsum))
    dq = torch.empty_like(q)
    route = flash_route("dq", q.dtype, d, s, s)
    _launch("hetu_flash_attention_bwd_dq", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            _ptr(mask), _ptr(seed), dq.data_ptr(), b, h, s, d,
            int(bool(causal)), float(scale), thr, inv_keep,
            int(q.dtype == torch.bfloat16), _ROUTE_CODE[route], _stream(q))
    flash_attention_bwd_dq.launches += 1
    route_launches["dq", route] += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, dsum, mask=None, causal=False,
                            scale=None, dropout_keep=1.0, seed=None):
    """(dK, dV) [B,H,S,d] in the inputs' dtype from the forward's lse and
    D = ``dsum`` (both f32 [B,H,S])."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, dsum, mask, causal, scale,
                          dropout_keep, seed)[1:]
    (q, k, v, do), mask, seed, (thr, inv_keep) = _prepare(
        "flash_attention_bwd_dkv", q, k, v, mask, dropout_keep, seed, (do,))
    b, h, s, d = q.shape
    lse, dsum = (t.float().contiguous() for t in (lse, dsum))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    route = flash_route("dkv", q.dtype, d, s, s)
    _launch("hetu_flash_attention_bwd_dkv", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            _ptr(mask), _ptr(seed), dk.data_ptr(), dv.data_ptr(), b, h, s, d,
            int(bool(causal)), float(scale), thr, inv_keep,
            int(q.dtype == torch.bfloat16), _ROUTE_CODE[route], _stream(q))
    flash_attention_bwd_dkv.launches += 1
    route_launches["dkv", route] += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, mask=None, causal=False,
                        scale=None, dropout_keep=1.0, seed=None):
    """(dq, dk, dv): D = rowsum(dO * O) in plain PyTorch, then the dQ and
    the dK/dV kernels (``flash_attention_bwd_plain`` on the CPU)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, mask, causal,
                                         scale, dropout_keep, seed)
    dsum = _dsum(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, dsum, mask, causal, scale,
                                dropout_keep, seed)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, dsum, mask, causal,
                                     scale, dropout_keep, seed)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """o = attention(q, k, v) through the forward kernel, with the dQ and
    dK/dV kernels as its backward (the JAX package's ``custom_vjp``).  The
    additive mask is data: its gradient is zero, as in JAX; the seed has
    none."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed, causal, scale, dropout_keep):
        o, lse = flash_attention_fwd(q, k, v, mask=mask, causal=causal,
                                     scale=scale, dropout_keep=dropout_keep,
                                     seed=seed)
        ctx.save_for_backward(q, k, v, mask, seed, o, lse)
        ctx.causal, ctx.scale, ctx.dropout_keep = causal, scale, dropout_keep
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, seed, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do, mask=mask, causal=ctx.causal,
            scale=ctx.scale, dropout_keep=ctx.dropout_keep, seed=seed)
        dmask = (torch.zeros_like(mask) if ctx.needs_input_grad[3]
                 else None)
        return dq, dk, dv, dmask, None, None, None, None


def flash_attention(q, k, v, mask=None, causal=False, scale=None,
                    dropout_keep=1.0, seed=None):
    """Differentiable fused attention [B,H,S,d], or None outside the
    envelope (the caller then runs the composition)."""
    if not _supported(q, k, v, mask):
        return None
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    return FlashAttentionFn.apply(q, k, v, mask, seed, bool(causal),
                                  float(scale), float(dropout_keep))


# -- blockwise API (ring / context parallelism) ------------------------------

def _block_sizes(sq, sk):
    """The TPU kernel's block sizes for Sq and Sk (``_block_sizes``)."""
    bq = next((b for b in (512, 256, 128) if sq % b == 0), None)
    bk = next((b for b in (512, 256, 128) if sk % b == 0), None)
    return bq, bk


def blockwise_supported(q_shape, k_shape):
    """The JAX gate of the blockwise kernels: 8-aligned d in [32, 512] and
    Sq, Sk multiples of 128."""
    d = q_shape[3]
    bq, bk = _block_sizes(q_shape[2], k_shape[2])
    return (d <= 512 and d % 8 == 0 and d >= 32
            and bq is not None and bk is not None)


def _ring(ring, sq, sk):
    """(n, r) of ``ring`` (None: one block pair), checked against the
    lengths: n groups that split Sq and Sk into whole 64-row tiles."""
    n, r = (1, 0) if ring is None else (int(ring[0]), int(ring[1]))
    if not 0 <= r < n or (n > 1 and (sq % (64 * n) or sk % (64 * n))):
        raise ValueError(f"ring={ring}: n ranks must split Sq={sq} and "
                         f"Sk={sk} into whole 64-row tiles, 0 <= r < n")
    return n, r


def _ring_pairs(n, r, sq, sk):
    """(rows of q, rows of K/V) of each rank's block pair at ring step r:
    rank g attends the block of rank (g - r) mod n."""
    gq, gk = sq // n, sk // n
    for g in range(n):
        src = (g - r) % n
        yield slice(g * gq, (g + 1) * gq), slice(src * gk, (src + 1) * gk)


def flash_attention_block_plain(q, k, v, q_off, k_off, causal=True,
                                scale=None, ring=None):
    """The blockwise forward kernel's function in plain PyTorch: each
    rank's pair through the forward's plain version at its global offsets,
    empty rows at lse = -1e30.  Returns (o in q's dtype, lse [B,H,Sq])."""
    n, r = _ring(ring, q.shape[2], k.shape[2])
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    o, lse = torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)
    for qs, ks in _ring_pairs(n, r, q.shape[2], k.shape[2]):
        o[:, :, qs], lse[:, :, qs] = _attend_plain(
            q[:, :, qs], k[:, :, ks], v[:, :, ks], None, causal, scale, 1.0,
            None, q_off + qs.start, k_off + ks.start, BLOCK_EMPTY_LSE)
    return o, lse


def flash_attention_block_bwd_plain(q, k, v, do, lse, dsum, q_off, k_off,
                                    causal=True, scale=None, ring=None):
    """The blockwise backward kernels' function in plain PyTorch: (dq, dk,
    dv), each rank's pair through the backward's plain version; dK/dV of a
    block land at that block's rows."""
    n, r = _ring(ring, q.shape[2], k.shape[2])
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for qs, ks in _ring_pairs(n, r, q.shape[2], k.shape[2]):
        dq[:, :, qs], dk[:, :, ks], dv[:, :, ks] = _bwd_plain(
            q[:, :, qs], k[:, :, ks], v[:, :, ks], do[:, :, qs],
            lse[:, :, qs], dsum[:, :, qs], None, causal, scale, 1.0, None,
            q_off + qs.start, k_off + ks.start)
    return dq, dk, dv


def _check_block(name, q, k, v, extra=()):
    """Validate the CUDA inputs of a blockwise kernel; returns them
    contiguous."""
    if not q.is_cuda:
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported dtype {q.dtype}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.dim() != 4 or (k.shape[0], k.shape[1],
                                              k.shape[3]) != (b, h, d):
        raise TypeError(f"{name}: k and v must be [B,H,Sk,d] beside q "
                        f"[B,H,Sq,d]; got {tuple(q.shape)}, "
                        f"{tuple(k.shape)}, {tuple(v.shape)}")
    for t in (k, v, *extra):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name}: inputs must share dtype and device")
    return [t.contiguous() for t in (q, k, v, *extra)]


def flash_attention_block(q, k, v, q_off, k_off, *, causal=True, scale=None,
                          ring=None):
    """Fused attention of q [B,H,Sq,d] against one K/V block [B,H,Sk,d] at
    the global offsets (q_off, k_off), Python ints: returns (o normalised,
    in q's dtype, lse [B,H,Sq] f32), a row with no live key in the block
    at lse = -1e30 and o = 0, weightless under the ring's logaddexp
    combine.  ``ring=(n, r)``: step r of a ring over n ranks whose blocks
    q and K/V hold in order along the sequence (module docstring)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    n, r = _ring(ring, sq, sk)
    if scale is None:
        scale = 1.0 / d ** 0.5
    if q.device.type == "cpu":
        return flash_attention_block_plain(q, k, v, q_off, k_off, causal,
                                           scale, ring)
    q, k, v = _check_block("flash_attention_block", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    route = flash_route("fwd", q.dtype, d, sq, sk, n)
    _launch("hetu_flash_attention_block_fwd", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, sq, sk, d, n,
            r, int(q_off), int(k_off), int(bool(causal)), float(scale),
            int(q.dtype == torch.bfloat16), _ROUTE_CODE[route], _stream(q))
    flash_attention_block.launches += 1
    route_launches["fwd", route] += 1
    return o, lse


flash_attention_block.launches = 0


def _block_bwd_launch(which, q, k, v, do, lse, dsum, q_off, k_off, causal,
                      scale, ring):
    """Launch the blockwise dQ (which = 0) or dK/dV (1) kernel; returns
    dq or (dk, dv)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    n, r = _ring(ring, sq, sk)
    name = ("flash_attention_block_bwd_dq", "flash_attention_block_bwd_dkv")
    q, k, v, do = _check_block(name[which], q, k, v, (do,))
    if do.shape != q.shape:
        raise TypeError(f"{name[which]}: dO must have q's shape")
    lse, dsum = (t.float().contiguous() for t in (lse, dsum))
    dq = torch.empty_like(q) if which == 0 else None
    dk, dv = ((torch.empty_like(k), torch.empty_like(v)) if which == 1
              else (None, None))
    kernel = ("dq", "dkv")[which]
    route = flash_route(kernel, q.dtype, d, sq, sk, n)
    _launch("hetu_flash_attention_block_bwd", which, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dsum.data_ptr(), _ptr(dq), _ptr(dk), _ptr(dv), b, h, sq, sk, d,
            n, r, int(q_off), int(k_off), int(bool(causal)), float(scale),
            int(q.dtype == torch.bfloat16), _ROUTE_CODE[route], _stream(q))
    route_launches[kernel, route] += 1
    return dq if which == 0 else (dk, dv)


def flash_attention_block_bwd_dq(q, k, v, do, lse, dsum, q_off, k_off, *,
                                 causal=True, scale=None, ring=None):
    """dQ [B,H,Sq,d] of one block pair (or one ring step) from the ring's
    combined lse and D = ``dsum`` (both f32 [B,H,Sq])."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if q.device.type == "cpu":
        return flash_attention_block_bwd_plain(
            q, k, v, do, lse, dsum, q_off, k_off, causal, scale, ring)[0]
    dq = _block_bwd_launch(0, q, k, v, do, lse, dsum, q_off, k_off, causal,
                           scale, ring)
    flash_attention_block_bwd_dq.launches += 1
    return dq


flash_attention_block_bwd_dq.launches = 0


def flash_attention_block_bwd_dkv(q, k, v, do, lse, dsum, q_off, k_off, *,
                                  causal=True, scale=None, ring=None):
    """(dK, dV) [B,H,Sk,d] of one block pair (or one ring step, each
    block's at its own rows) from the combined lse and D = ``dsum``."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if q.device.type == "cpu":
        return flash_attention_block_bwd_plain(
            q, k, v, do, lse, dsum, q_off, k_off, causal, scale, ring)[1:]
    dkv = _block_bwd_launch(1, q, k, v, do, lse, dsum, q_off, k_off, causal,
                            scale, ring)
    flash_attention_block_bwd_dkv.launches += 1
    return dkv


flash_attention_block_bwd_dkv.launches = 0


def flash_attention_block_bwd(q, k, v, o, lse, dout, q_off, k_off, *,
                              causal=True, scale=None, ring=None, dsum=None):
    """Gradients (dq, dk, dv) of one block pair given the COMBINED (o, lse)
    of the whole ring forward, lse [B,H,Sq]: p = exp(s - lse) is each
    block's share of the global softmax, so dq sums over the blocks and
    (dk, dv) are exact per block.  D = rowsum(dO * O) is the same at every
    ring step: a ring passes it as ``dsum`` once computed."""
    if dsum is None:
        dsum = _dsum(o, dout)
    kw = dict(causal=causal, scale=scale, ring=ring)
    if q.device.type == "cpu":
        return flash_attention_block_bwd_plain(q, k, v, dout, lse, dsum,
                                               q_off, k_off, **kw)
    dq = flash_attention_block_bwd_dq(q, k, v, dout, lse, dsum, q_off, k_off,
                                      **kw)
    dk, dv = flash_attention_block_bwd_dkv(q, k, v, dout, lse, dsum, q_off,
                                           k_off, **kw)
    return dq, dk, dv
