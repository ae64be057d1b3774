"""Context (sequence) parallelism: ring and Ulysses attention (port of
``hetu_tpu/parallel/context_parallel.py``).

The JAX package runs each rank's body under ``shard_map`` on its own
device and moves K/V with ``ppermute`` (the ring) or ``all_to_all``
(Ulysses).  The port's executor is single-controller and runs a mesh whose
positions share one device (parallel/mesh.py), so every rank's body runs in
this process, rank after rank, on the global [B, H, S, D] tensors, and each
collective becomes a function over the list of per-rank tensors:
``ppermute`` by +1 is a rotation of the list, the tiled ``all_to_all`` a
re-split along the other axis.  Each rank's arithmetic and its order of
accumulation are the per-shard JAX body's.

* ``ring_attention`` with local blocks inside the blockwise kernel gate
  (``blockwise_supported``) runs ``_RingFlash``: each ring step is one
  launch of the blockwise flash forward for all ranks (rank g attends the
  K/V block that r rotations brought it), combined with ``logaddexp`` in
  f32; the backward is a second ring pass with dq summed over the steps and
  each block's dk, dv summed in the order in which the block travels the
  ring, from its home rank.  On one card the rotation is an index: no bytes
  move, so this path measures the block kernels and the ring schedule, not
  communication.
* Outside the gate it runs ``ring_attention_shard``, the plain
  online-softmax ring, under ``torch.autograd``.
* ``ulysses_attention`` re-splits heads against the sequence and runs each
  rank's attention over all tokens of its heads through the single-device
  flash kernel (or the composition outside its envelope).
"""

from __future__ import annotations

import torch

from ..ops.kernels.flash_attention import (blockwise_supported,
                                           flash_attention,
                                           flash_attention_block,
                                           flash_attention_block_bwd, _dsum)
from .mesh import mesh_device, same_device


def _shards(x, n):
    """The n ranks' local blocks of x along the sequence (dim 2)."""
    return list(torch.chunk(x, n, dim=2))


def _ring_rotate(xs):
    """``ppermute`` by +1 over the ranks: rank i receives rank i-1's."""
    return [xs[i - 1] for i in range(len(xs))]


def _on_mesh(mesh, x, what):
    dev = mesh_device(mesh, what)
    if not same_device(dev, x.device):
        raise ValueError(f"{what}: the mesh's device {dev} holds no "
                         f"tensor on {x.device}")


def _block_attend(q, k, v, m, l, o, q_off, k_off, scale, causal):
    """One flash block: update the running (m, l, o) with a K/V block.

    q: [B,H,Sq,D]; k,v: [B,H,Sk,D]; m,l: [B,H,Sq]; o: [B,H,Sq,D] f32.
    q_off/k_off are the global sequence offsets of the local blocks."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        iq = q_off + torch.arange(q.shape[-2], device=q.device)[:, None]
        ik = k_off + torch.arange(k.shape[-2], device=q.device)[None, :]
        s = torch.where(iq >= ik, s, float("-inf"))
    # amax spreads the gradient over ties, as jnp.max does
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows (m_new = -inf): keep them at zero weight
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l_new = alpha * l + p.sum(dim=-1)
    o_new = alpha[..., None] * o + torch.matmul(p.to(v.dtype).float(),
                                                v.float())
    return m_new, l_new, o_new


def ring_attention_shard(q, k, v, n_shards, causal=True, scale=None):
    """The per-rank ring attention body for every rank.

    q, k, v: lists of the n ranks' local [B, H, S/n, D] blocks, in
    sequence order.  Returns the list of their local outputs."""
    seq_block = q[0].shape[-2]
    scale = scale if scale is not None else 1.0 / (q[0].shape[-1] ** 0.5)
    m = [torch.full(x.shape[:-1], float("-inf"), device=x.device)
         for x in q]
    l = [torch.zeros(x.shape[:-1], device=x.device) for x in q]
    o = [torch.zeros(x.shape, device=x.device) for x in q]
    for r in range(n_shards):
        for my in range(n_shards):
            # the K/V block rank `my` holds came from rank (my - r) mod n
            src = (my - r) % n_shards
            m[my], l[my], o[my] = _block_attend(
                q[my], k[my], v[my], m[my], l[my], o[my], my * seq_block,
                src * seq_block, scale, causal)
        k, v = _ring_rotate(k), _ring_rotate(v)
    return [(oi / li.clamp_min(1e-20)[..., None]).to(qi.dtype)
            for oi, li, qi in zip(o, l, q)]


# -- flash ring attention ----------------------------------------------------

def _ring_flash_fwd_impl(q, k, v, n_shards, causal, scale):
    """(o in q's dtype, lse [B,H,S] f32) of the flash ring; q, k, v hold
    the ranks' blocks in order along the sequence."""
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:-1], -1e30, device=q.device)
    for r in range(n_shards):
        o_blk, lse_blk = flash_attention_block(
            q, k, v, 0, 0, causal=causal, scale=scale, ring=(n_shards, r))
        lse_new = torch.logaddexp(lse, lse_blk)
        # o_blk (q's dtype) times an f32 weight computes in f32: the
        # values of JAX's o_blk.astype(f32) * w without a copy
        o = (o * torch.exp(lse - lse_new)[..., None]
             + o_blk * torch.exp(lse_blk - lse_new)[..., None])
        lse = lse_new
    return o.to(q.dtype), lse


def _ring_flash_bwd(q, k, v, o, lse, g, n_shards, causal, scale):
    """(dq, dk, dv) of the flash ring from its combined (o, lse): dq sums
    over the steps in f32; the dk, dv of block b at step r come from the
    rank (b + r) mod n that holds it then, and land at the block's own rows,
    so each block's sum runs in the order the block travels the ring."""
    dsum = _dsum(o, g)  # the same at every step (JAX recomputes it)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for r in range(n_shards):
        dq_c, dk_c, dv_c = flash_attention_block_bwd(
            q, k, v, o, lse, g, 0, 0, causal=causal, scale=scale,
            ring=(n_shards, r), dsum=dsum)
        # an f32 sum plus a part in the inputs' dtype adds in f32
        dq += dq_c
        dk += dk_c
        dv += dv_c
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """Ring attention through the blockwise flash kernels, with the second
    ring pass as its backward (the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, n_shards, causal, scale):
        o, lse = _ring_flash_fwd_impl(q, k, v, n_shards, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.n_shards, ctx.causal, ctx.scale = n_shards, causal, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        grads = _ring_flash_bwd(q, k, v, o, lse, g.contiguous(),
                                ctx.n_shards, ctx.causal, ctx.scale)
        return (*grads, None, None, None)


def ring_attention(mesh, q, k, v, *, axis="cp", causal=True, scale=None,
                   batch_axis="dp"):
    """q, k, v [B, H, S, D] with S sharded over ``axis``.

    Runs the blockwise flash kernels when the local shapes fit their gate
    (128-multiple local seq, 8-aligned d in [32, 512]); otherwise the plain
    online-softmax ring.  Attention is batch-local, so the shards of the
    mesh's ``batch_axis`` pass straight through: every dp group's ring
    runs in the same launches, and ``batch_axis`` (the JAX signature's)
    selects nothing."""
    _on_mesh(mesh, q, "ring_attention")
    n = mesh.shape[axis]
    local_q = (q.shape[0], q.shape[1], q.shape[2] // n, q.shape[3])
    if blockwise_supported(local_q, local_q):
        return _RingFlash.apply(q, k, v, n, bool(causal), scale)
    outs = ring_attention_shard(_shards(q, n), _shards(k, n), _shards(v, n),
                                n, causal=causal, scale=scale)
    return torch.cat(outs, dim=2)


def _all_to_all(xs, split_axis, concat_axis):
    """The tiled ``all_to_all`` over the ranks' list: rank i cuts its
    tensor into n chunks along ``split_axis`` and sends chunk j to rank j,
    which concatenates what it receives along ``concat_axis`` in rank
    order."""
    n = len(xs)
    parts = [torch.chunk(x, n, dim=split_axis) for x in xs]
    return [torch.cat([parts[j][i] for j in range(n)], dim=concat_axis)
            for i in range(n)]


def ulysses_attention_shard(q, k, v, n_shards, causal=True, scale=None):
    """The per-rank Ulysses body for every rank: lists of local
    [B, H, S/n, D] blocks, all_to_all to [B, H/n, S, D] (all tokens, a
    head subset), plain attention, all_to_all back."""
    def seq_to_heads(xs):
        return _all_to_all(xs, split_axis=1, concat_axis=2)

    def heads_to_seq(xs):
        return _all_to_all(xs, split_axis=2, concat_axis=1)

    q, k, v = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    d = q[0].shape[-1]
    scale_ = scale if scale is not None else 1.0 / (d ** 0.5)
    outs = []
    for qi, ki, vi in zip(q, k, v):
        # after the all_to_all the attention is local self-attention over
        # the full sequence: the flash kernel when the shape fits
        o = flash_attention(qi, ki, vi, causal=causal, scale=scale_)
        if o is None:
            s = torch.matmul(qi.float(), ki.float().transpose(-1, -2)) * scale_
            if causal:
                S = s.shape[-1]
                iq = torch.arange(S, device=s.device)[:, None]
                ik = torch.arange(S, device=s.device)[None, :]
                s = torch.where(iq >= ik, s, -1e9)
            p = torch.softmax(s, dim=-1)
            o = torch.matmul(p.to(vi.dtype).float(), vi.float())
        outs.append(o.to(vi.dtype))
    return heads_to_seq(outs)


def ulysses_attention(mesh, q, k, v, *, axis="cp", causal=True, scale=None):
    _on_mesh(mesh, q, "ulysses_attention")
    n = mesh.shape[axis]
    assert q.shape[1] % n == 0, "num heads must divide cp degree"
    outs = ulysses_attention_shard(_shards(q, n), _shards(k, n),
                                   _shards(v, n), n, causal=causal,
                                   scale=scale)
    return torch.cat(outs, dim=2)
