"""Slot-batched views of the KV-cache decoder for the serving engine (port
of ``hetu_tpu/serving/adapters.py``).

The one-shot decoder (models/llama_decode.py) steps one shared position
for its whole batch; continuous batching needs every slot at its own
position.  The adapter re-hosts the SAME block (imported, not copied) in
slot-batched form, over the pool ``k, v [L, S, KV, T, D]``:

* ``decode(params, tokens [S], positions [S], k, v)`` — one token per
  slot, each at its own position.  The JAX package vmaps the block over
  slots; here every slot is a row of every product, with its own rotary
  row, mask row and write position, so a slot's result does not depend
  on the other slots.  Each slot's new K/V row is written into the pool
  in place.
* ``prefill(params, prompt [1, P], k, v, slot)`` — a whole prompt
  through all layers at once into a fresh [1, KV, P, D] cache a layer
  (as the JAX prefill's zeros), copied into rows [0, P) of slot ``slot``
  (a one-element device tensor, so that one captured program serves
  every slot); returns the logits of the rows asked for.

Pad-safety: prefill pads prompts to the engine's fixed bucket P and also
writes K/V for the pad tail.  That tail is harmless — decode masks
attention to ``col <= position`` and every cache row between the true
prompt length and the current position has been overwritten by a decode
step before it first becomes attendable.

The paged engine's ``prefill_chunk`` and the speculative self-draft's
``n_layers`` arrive with slice D2, the GPT adapter with GPT decode (slice C)
(ROADMAP.md).
"""

from __future__ import annotations

import torch

from ..models import llama_decode as _ld
from ..ops.rotary import _rope_tables


class LlamaSlotAdapter:
    """Rotary/GQA (Llama-family) slot-batched decode."""

    def __init__(self, config, name):
        c = config
        self.config = c
        self.name = name
        self.layers = c.num_layers
        self.kv_heads = c.num_kv_heads
        self.head_dim = c.hidden_size // c.num_heads
        self.position_cap = None          # rotary: no learned-table limit
        self.embed_param = f"{name}_embed_table"
        self._layer_params = _ld.make_layer_params(c, name)
        self._block = _ld.make_block(c)
        self._logits = _ld.make_logits(c, name)
        self._tables = {}

    @classmethod
    def for_model(cls, model, name):
        return cls(model.config, name)

    def _rope(self, t, device):
        """f32 rotary tables for rows [0, t), built once per length."""
        key = (t, str(device))
        if key not in self._tables:
            self._tables[key] = _rope_tables(t, self.head_dim,
                                             self.config.rope_theta,
                                             device=device)
        return self._tables[key]

    def decode(self, params, tokens, positions, k, v):
        """Slot-batched decode (see module doc): ``tokens, positions``
        [S] int64 on the pool's device.  Returns logits [S, V]; row
        ``positions[i]`` of slot ``i`` is written in every layer."""
        emb = params[self.embed_param]
        t = k.shape[3]
        cos_t, sin_t = self._rope(t, k.device)
        rows = positions.clamp(0, t - 1)         # a gather clamps, as in JAX
        x = emb[tokens][:, None]                               # [S, 1, H]
        cos = cos_t[rows][:, None]                             # [S, 1, hd]
        sin = sin_t[rows][:, None]
        mask = (torch.arange(t, device=k.device)[None, :]
                <= positions[:, None])[:, None]                # [S, 1, T]
        for i in range(self.layers):
            x = self._block(self._layer_params(params, i), x, k[i], v[i],
                            cos, sin, mask, positions)
        return self._logits(params, x[:, 0])                   # [S, V]

    def prefill(self, params, prompt, k, v, slot, rows=None):
        """``prompt [1, P]`` into rows [0, P) of slot ``slot`` ([1] int64)
        of the pool, in every layer.  Returns the logits of ``rows``
        ([n] int64 row indices) or, by default, of every row: [n or P,
        V]."""
        emb = params[self.embed_param]
        p_len = prompt.shape[1]
        cos_t, sin_t = self._rope(p_len, k.device)
        mask = _ld.causal_mask(p_len, k.device)
        kshape = (self.layers, 1, self.kv_heads, p_len, self.head_dim)
        ks = torch.zeros(kshape, dtype=k.dtype, device=k.device)
        vs = torch.zeros(kshape, dtype=v.dtype, device=v.device)
        x = emb[prompt]
        for i in range(self.layers):
            x = self._block(self._layer_params(params, i), x, ks[i], vs[i],
                            cos_t, sin_t, mask, 0)
        k[:, :, :, :p_len].index_copy_(1, slot, ks)
        v[:, :, :, :p_len].index_copy_(1, slot, vs)
        h = x[0] if rows is None else x[0].index_select(0, rows)
        return self._logits(params, h)


class GPTSlotAdapter:
    """The learned-positions GPT adapter arrives with GPT decode, the next
    part of slice C of the port (ROADMAP.md); the model trains today
    (models/gpt.py)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "GPTSlotAdapter arrives with GPT decode, the next PR of slice C "
            "of the port (models/gpt_decode.py; ROADMAP.md)")


def adapter_for(model, name):
    """Pick the slot adapter matching a model instance by its config
    family (rotary Llama-likes; learned-position GPTs raise until GPT
    decode, slice C)."""
    c = model.config
    if hasattr(c, "rope_theta"):
        return LlamaSlotAdapter.for_model(model, name)
    if hasattr(c, "seq_len") and hasattr(c, "num_layers"):
        return GPTSlotAdapter(c, name)
    raise TypeError(
        f"no slot adapter for {type(model).__name__} "
        f"(config {type(c).__name__}) — serving supports the Llama "
        "KV-cache decoder tier")
