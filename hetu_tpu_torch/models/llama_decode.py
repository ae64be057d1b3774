"""KV-cache autoregressive decoding for the Llama tier (port of
``hetu_tpu/models/llama_decode.py``).

One prompt prefill, then one single-token decode step repeated, over a
preallocated K/V cache (prompt_len + max_new rows, future rows masked).
On the card the decode step is captured in a CUDA graph once per call
and replayed for every later token, as the JAX package's ``lax.scan``
compiles it once; on the CPU it runs eagerly.  The cache is written in
place: each step writes its own row.

It consumes an Executor's params by the canonical variable names
(models/llama.py naming), on the executor's device and in its params'
dtype:

    fn = build_greedy_decode(config, max_new=32, name="llama")
    tokens = fn(ex.params, prompt_ids)     # [B, P+32]

The block (``make_block``) is shared with the serving engine's slot
adapter (serving/adapters.py), which batches slots as rows of each
product.  MoE decode (``num_experts``) arrives with slice C of the port
(ROADMAP.md), and the paged engine's ``make_chunk_embed`` with the paged
pool (slice D).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..graph.capture import Captured
from ..ops.rotary import _rope_tables
from ._decode_common import (make_picker, make_attend, assemble,
                             param_prefix, executor_generate)


def _no_moe(config):
    if config.num_experts:
        raise NotImplementedError(
            "MoE decode (num_experts) arrives with slice C of the port "
            "(ROADMAP.md)")


def _rms(x, g, eps):
    xf = x.float()
    var = torch.mean(torch.square(xf), -1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g


def _rotate(x, cos, sin):
    """x [B, H, S, D] with per-position cos/sin [B or 1, S, D]
    (rotate_half)."""
    d = x.shape[-1]
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    rot = torch.cat([-x2, x1], dim=-1)
    return (xf * cos[:, None] + rot * sin[:, None]).to(x.dtype)


def make_layer_params(config, name):
    """Per-layer param lookup by the canonical models/llama.py naming;
    returns ``layer_params(params, i) -> dict`` (shared with serving)."""
    _no_moe(config)

    def layer_params(params, i):
        our = f"{name}_layer{i}"
        return {
            "in_norm": params[f"{our}_input_norm_scale"],
            "post_norm": params[f"{our}_post_norm_scale"],
            "wq": params[f"{our}_attn_q_weight"],
            "wk": params[f"{our}_attn_k_weight"],
            "wv": params[f"{our}_attn_v_weight"],
            "wo": params[f"{our}_attn_out_weight"],
            "gate": params[f"{our}_mlp_gate_weight"],
            "up": params[f"{our}_mlp_up_weight"],
            "down": params[f"{our}_mlp_out_weight"],
        }

    return layer_params


def write_rows(cache, new, write_at):
    """Write ``new`` [B, KV, Sq, D] into rows ``[w, w + Sq)`` of ``cache``
    [B, KV, T, D] in place, ``w`` an int or a [B] tensor of per-row
    starts (device values, no host read), clamped to [0, T - Sq] as
    ``dynamic_update_slice`` clamps."""
    b, _, sq, _ = new.shape
    t = cache.shape[2]
    if isinstance(write_at, int):
        w = min(max(write_at, 0), t - sq)
        cache[:, :, w:w + sq] = new
        return
    rows = (write_at.clamp(0, t - sq)[:, None]
            + torch.arange(sq, device=cache.device))          # [B, Sq]
    bidx = torch.arange(b, device=cache.device)[:, None]
    cache[bidx, :, rows] = new.permute(0, 2, 1, 3)


def make_block(config):
    """One Llama decoder layer over an explicit K/V cache; returns
    ``block(lp, x [B, Sq, H], cache_k, cache_v [B, KV, T, D], cos, sin
    [B or 1, Sq, D], pos_mask [Sq, T] or [B, Sq, T], write_at) -> x'``.
    The new K/V rows are written into the caches in place at rows
    ``[write_at, write_at + Sq)`` (an int, or a [B] tensor of per-row
    starts) before the attention reads them.  Used by both the one-shot
    greedy decoder and the slot-batched serving engine."""
    c = config
    _no_moe(c)
    hd = c.hidden_size // c.num_heads
    attend = make_attend(hd, c.num_heads // c.num_kv_heads)

    def block(lp, x, cache_k, cache_v, cos, sin, pos_mask, write_at):
        b, sq, _ = x.shape
        if cos.dim() == 2:
            cos, sin = cos[None], sin[None]
        h = _rms(x, lp["in_norm"], c.rms_eps)
        q = (h @ lp["wq"]).view(b, sq, c.num_heads, hd).transpose(1, 2)
        k = (h @ lp["wk"]).view(b, sq, c.num_kv_heads, hd).transpose(1, 2)
        v = (h @ lp["wv"]).view(b, sq, c.num_kv_heads, hd).transpose(1, 2)
        q = _rotate(q, cos, sin)
        write_rows(cache_k, _rotate(k, cos, sin), write_at)
        write_rows(cache_v, v, write_at)
        o = attend(q, cache_k, cache_v, pos_mask)
        x = x + o.transpose(1, 2).reshape(b, sq, c.hidden_size) @ lp["wo"]
        f = _rms(x, lp["post_norm"], c.rms_eps)
        return x + (F.silu(f @ lp["gate"]) * (f @ lp["up"])) @ lp["down"]

    return block


def make_logits(config, name):
    """Final-norm + LM-head projection shared by decode paths."""
    c = config

    def logits_of(params, h_last):
        h = _rms(h_last, params[f"{name}_norm_scale"], c.rms_eps)
        if c.tie_embeddings:
            return h @ params[f"{name}_embed_table"].T
        return h @ params[f"{name}_lm_head_weight"]

    return logits_of


def causal_mask(p_len, device):
    """[P, P] boolean causal mask (True = attend)."""
    ar = torch.arange(p_len, device=device)
    return ar[None, :] <= ar[:, None]


def build_greedy_decode(config, max_new, name="llama", temperature=0.0,
                        top_k=0):
    """Returns ``fn(params, prompt_ids [B, P], generator=None) ->
    [B, P+max_new]`` on the params' device.

    ``temperature`` 0 = greedy argmax; > 0 samples from
    softmax(logits/temperature), restricted to the ``top_k`` largest
    logits when top_k > 0, drawing from ``generator`` (a
    ``torch.Generator`` on the params' device; a fresh one seeded 0 by
    default).  The prefill attends the prompt's own P rows, as the
    serving engine's prefill does, and the decode steps the whole
    cache."""
    c = config
    _no_moe(c)
    hd = c.hidden_size // c.num_heads
    layer_params = make_layer_params(c, name)
    block = make_block(c)
    logits_of = make_logits(c, name)
    pick = make_picker(temperature, top_k)

    def decode(params, prompt_ids, generator=None):
        emb = params[f"{name}_embed_table"]
        dev = emb.device
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        prompt_ids = prompt_ids.to(dev)
        b, p_len = prompt_ids.shape
        total = p_len + max_new
        cos_t, sin_t = _rope_tables(total, hd, c.rope_theta, device=dev)
        lps = [layer_params(params, i) for i in range(c.num_layers)]
        kshape = (b, c.num_kv_heads, total, hd)
        caches = [(torch.zeros(kshape, dtype=emb.dtype, device=dev),
                   torch.zeros(kshape, dtype=emb.dtype, device=dev))
                  for _ in lps]

        with torch.no_grad():
            # ---- prefill: the prompt through all layers, rows [0, P) ----
            x = emb[prompt_ids]
            mask = causal_mask(p_len, dev)
            for lp, (ck, cv) in zip(lps, caches):
                x = block(lp, x, ck[:, :, :p_len], cv[:, :, :p_len],
                          cos_t[:p_len], sin_t[:p_len], mask, 0)
            first = pick(logits_of(params, x[:, -1]), generator)   # [B]

            # ---- decode: one token a step, captured on the card --------
            owner = _Owner(generator)
            tok = first.clone()
            pos = torch.full((1,), p_len, dtype=torch.long, device=dev)
            step_no = torch.zeros(1, dtype=torch.long, device=dev)
            toks = torch.zeros(max(max_new - 1, 1), b, dtype=torch.long,
                               device=dev)
            cols = torch.arange(total, device=dev)

            def step():
                x = emb[tok][:, None]                          # [B, 1, H]
                cos = cos_t.index_select(0, pos)
                sin = sin_t.index_select(0, pos)
                mask = (cols <= pos)[None]                     # [1, T]
                at = pos.expand(b)
                for lp, (ck, cv) in zip(lps, caches):
                    x = block(lp, x, ck, cv, cos, sin, mask, at)
                nxt = pick(logits_of(params, x[:, 0]), owner.generator)
                toks.index_copy_(0, step_no, tok[None])
                tok.copy_(nxt)
                pos.add_(1)
                step_no.add_(1)

            prog = Captured(f"greedy decode step of {name!r}", step, dev,
                            owner=owner)
            for _ in range(max_new - 1):
                prog()
            return assemble(prompt_ids, first, tok[:, None],
                            toks[:max_new - 1], max_new)

    return decode


class _Owner:
    """Holds the generator a captured step draws from (a failed capture
    replaces it)."""

    def __init__(self, generator):
        self.generator = generator


def greedy_generate(executor, model, prompt_ids, max_new, name=None,
                    temperature=0.0, top_k=0, seed=0):
    """Convenience wrapper: decode from an Executor's params on its
    device.  ``model``: the LlamaForCausalLM whose config/naming to
    use.  Returns [B, P + max_new] as numpy."""
    name = name or param_prefix(executor, "_embed_table")
    fn = build_greedy_decode(model.config, max_new, name=name,
                             temperature=temperature, top_k=top_k)
    return executor_generate(fn, executor, [prompt_ids], seed)
