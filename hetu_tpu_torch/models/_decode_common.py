"""Shared pieces of the KV-cache decoders and their executor-facing
wrappers (port of ``hetu_tpu/models/_decode_common.py``).

``make_attend`` keeps the JAX package's numerics: scores and the
probability-weighted sum accumulate in f32 and come out in f32
(``preferred_element_type=jnp.float32`` there), and only the attention
output is cast back to the values' dtype.  A bare ``torch.matmul`` of
bf16 operands would round the scores to bf16, so the products go
through ``_product_f32``.  Grouped-query heads are attended without
repeating the cache: each KV head's keys meet its ``n_rep`` query heads
in one batched product, the same dot products as the JAX package's
broadcast.

Sampling draws from a ``torch.Generator``: JAX's ``categorical`` bits
cannot be reproduced in torch, so a sampled stream is the port's own
(ROADMAP.md §3).  Greedy decoding is ``argmax`` in both packages, ties
going to the first index.  ``make_gather`` (the tensor-parallel engine's)
and ``make_slot_picker`` (the paged engine's) arrive with those engines
(ROADMAP.md §1, slice D).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def param_prefix(executor, suffix):
    """Infer a model's parameter-name prefix from an Executor's params by
    the unique variable ending in ``suffix`` (e.g. ``_embed_table``)."""
    try:
        return next(k for k in executor.params
                    if k.endswith(suffix)).rsplit(suffix, 1)[0]
    except StopIteration:
        raise KeyError(
            f"no executor param ends with {suffix!r} — pass name= "
            "explicitly") from None


def executor_generate(fn, executor, arrays, seed=0):
    """Shared tail of every ``*_generate`` wrapper: call the decode
    program on the executor's params, on the executor's device, with a
    generator seeded by ``seed``, and return the tokens as numpy."""
    dev = executor.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    arrays = [torch.as_tensor(np.asarray(a), device=dev) for a in arrays]
    return fn(executor.params, *arrays, generator=gen).cpu().numpy()


def pad_prompts(prompts, pad_to=None, pad_id=0):
    """Right-pad variable-length prompts into one [B, P] int32 batch.

    Returns ``(ids, lengths)`` with ``lengths`` the true prompt lengths.
    ``pad_to`` fixes P (serving's static prefill bucket); by default P is
    the longest prompt."""
    lens = np.asarray([len(np.asarray(p).reshape(-1)) for p in prompts],
                      np.int32)
    if lens.size and lens.min() < 1:
        raise ValueError("empty prompt")
    p_len = int(pad_to) if pad_to is not None else int(lens.max())
    if lens.size and int(lens.max()) > p_len:
        raise ValueError(
            f"prompt of length {int(lens.max())} exceeds pad_to={p_len}")
    ids = np.full((len(prompts), p_len), pad_id, np.int32)
    for i, p in enumerate(prompts):
        ids[i, :lens[i]] = np.asarray(p).reshape(-1)
    return ids, lens


def make_picker(temperature, top_k):
    """Token selection for decode: greedy argmax at temperature <= 0,
    else a draw from softmax(logits / temperature) restricted to the
    ``top_k`` largest logits (Gumbel-max, the form of JAX's
    ``categorical``).  ``pick(logits [..., V], generator) -> [...]``
    int64."""

    def pick(logits, generator):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        lg = logits.float() / temperature
        if top_k > 0:
            kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
            lg = torch.where(lg < kth, float("-inf"), lg)
        u = torch.rand(lg.shape, generator=generator, device=lg.device)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        return torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)

    return pick


def _product_f32(a, b):
    """Batched ``a @ b`` accumulated in f32 with an f32 result, as
    ``einsum(..., preferred_element_type=float32)`` computes it."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def make_attend(head_dim, n_rep=1):
    """Masked cache attention: q [B, H, Sq, D] against cached keys/vals
    [B, KV, T, D] (query head h reads KV head h // n_rep), with a boolean
    position mask [Sq, T] or [B, Sq, T] (True = attend)."""
    scale = math.sqrt(head_dim)

    def attend(q, keys, vals, pos_mask):
        b, h, sq, d = q.shape
        kv, t = keys.shape[1], keys.shape[2]
        qg = q.reshape(b * kv, n_rep * sq, d)
        s = _product_f32(qg, keys.reshape(b * kv, t, d).transpose(1, 2))
        s = (s / scale).view(b, kv, n_rep, sq, t)
        mask = pos_mask if pos_mask.dim() == 3 else pos_mask[None]
        s = torch.where(mask[:, None, None], s, -1e30)
        p = torch.softmax(s, dim=-1).to(vals.dtype)
        o = _product_f32(p.view(b * kv, n_rep * sq, t),
                         vals.reshape(b * kv, t, d))
        return o.to(vals.dtype).view(b, h, sq, d)

    return attend


def assemble(prompt_ids, first, last, toks, max_new):
    """[prompt | generated] given the decode loop's outputs (``first`` the
    token computed at prefill, ``toks`` [max_new - 1, B] the tokens fed
    to each decode step, ``last`` [B, 1] the final step's token)."""
    del first
    gen = (torch.cat([toks.transpose(0, 1), last], dim=1) if max_new > 1
           else last)
    return torch.cat([prompt_ids, gen.to(prompt_ids.dtype)], dim=1)
