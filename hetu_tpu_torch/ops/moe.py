"""MoE routing, dispatch and combine (port of ``hetu_tpu/ops/moe.py``).

The gates turn logits [T, E] into routing CHOICES, one
``(expert_idx [T], gate [T], pos [T])`` per routing choice, where ``pos``
is the token's place in its expert's queue, plus a balance loss.  Tokens
past an expert's capacity C are dropped.  From the choices, the sparse
route moves rows (``sparse_dispatch``, ``sparse_combine``: a row gather
each, ops/kernels/moe_dispatch.py) and never builds the [T, E, C] one-hot
tensors; the dense route builds them (``_accumulate_dispatch``) and moves
tokens with einsums (``layout_transform_op``).  The arithmetic follows the
JAX package op for op: positions come from an f32 cumsum of 0/1 masks
(exact below 2^24), ``argmax`` takes the first maximum in both packages,
and gradients reach the gate weights only through the softmax
probabilities.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import simple_op
from .kernels.moe_dispatch import row_gather


def _one_hot(idx, n, dtype):
    return F.one_hot(idx.long(), n).to(dtype)


def top_k_gating(logits, k, capacity):
    """GShard top-k gating (k in {1, 2}): (dispatch [T, E, C], combine
    [T, E, C], aux loss); tokens past capacity C are dropped.  The JAX
    package's ``second_renorm`` and ``noise_*`` arguments, which none of its
    callers sets, are left out: the second choice is always renormalised,
    and no noise is added."""
    choices, aux = top_k_gating_choices(logits, k, capacity)
    T, E = logits.shape
    dispatch, combine = _accumulate_dispatch(T, E, capacity, choices,
                                             logits.dtype)
    return dispatch, combine, aux


def top_k_gating_choices(logits, k, capacity):
    """``top_k_gating`` in choices form: [(expert_idx, gate, pos)] per
    routing choice and the aux loss."""
    if k not in (1, 2):
        raise ValueError(f"top_k_gating supports k in (1, 2), got k={k}")
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    idx1 = torch.argmax(logits, dim=-1)
    mask1 = _one_hot(idx1, E, probs.dtype)
    gate1 = torch.sum(probs * mask1, dim=-1)

    # load-balancing aux loss (GShard eq. 4): E * mean(me * ce)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(mask1, dim=0)
    aux = E * torch.sum(me * ce)

    masks_gates = [(mask1, gate1)]
    if k == 2:
        logits2 = torch.where(mask1 > 0, -torch.inf, logits)
        mask2 = _one_hot(torch.argmax(logits2, dim=-1), E, probs.dtype)
        masks_gates.append((mask2, torch.sum(probs * mask2, dim=-1)))
    choices = _choices_with_positions(masks_gates)
    # zero dropped gates BEFORE renorm so kept mass renormalizes to 1
    choices = [(i, g * (p < capacity), p) for (i, g, p) in choices]
    if k == 2:
        total = choices[0][1] + choices[1][1]
        denom = total + 1e-9
        choices = [(i, g / denom * (total > 0), p)
                   for (i, g, p) in choices]
    return choices, aux


def top_k_balance_aux(logits):
    """Just the GShard balance loss of ``top_k_gating``: O(T·E), no
    dispatch."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    mask1 = _one_hot(torch.argmax(logits, dim=-1), E, probs.dtype)
    return E * torch.sum(torch.mean(probs, dim=0) * torch.mean(mask1, dim=0))


def ktop1_balance_aux(logits, k):
    """Just the per-prototype balance loss of ``ktop1_gating``."""
    T, E = logits.shape
    Ep = E // k
    sub = logits.reshape(T, k, Ep)
    probs = torch.softmax(sub, dim=-1)
    aux = 0.0
    for i in range(k):
        mask_local = _one_hot(torch.argmax(sub[:, i], dim=-1), Ep,
                              probs.dtype)
        aux = aux + Ep * torch.sum(torch.mean(probs[:, i], dim=0)
                                   * torch.mean(mask_local, dim=0))
    return aux


def sam_balance_aux(logits, num_groups):
    """Just the balance and group-alignment terms of ``sam_gating``."""
    T, E = logits.shape
    Eg = E // num_groups
    probs = torch.softmax(logits, dim=-1)
    gidx = _group_index(num_groups, Eg, logits.device)
    gmass = sam_group_sum(probs.T, gidx, num_groups).T
    top_group = torch.argmax(gmass, dim=-1)
    in_group = gidx[None, :] == top_group[:, None]
    first_mask = _one_hot(torch.argmax(
        torch.where(in_group, logits, -torch.inf), dim=-1), E, probs.dtype)
    balance = E * torch.sum(torch.mean(probs, dim=0)
                            * torch.mean(first_mask, dim=0))
    alignment = torch.mean(1.0 - torch.max(gmass, dim=-1).values)
    return balance + alignment


def hash_gating_choices(ids, num_experts, capacity, dtype=torch.float32):
    """``hash_gating`` in choices form."""
    T = ids.shape[0]
    idx = torch.remainder(ids.to(torch.int32), num_experts)
    mask = _one_hot(idx, num_experts, dtype)
    choices = _choices_with_positions(
        [(mask, torch.ones((T,), dtype=dtype, device=ids.device))])
    return choices, torch.zeros((), dtype=dtype, device=ids.device)


def hash_gating(ids, num_experts, capacity, dtype=torch.float32):
    """HashGate: expert = id % E, gate = 1."""
    T = ids.shape[0]
    choices, _ = hash_gating_choices(ids, num_experts, capacity, dtype)
    dispatch, _ = _accumulate_dispatch(T, num_experts, capacity, choices,
                                       dtype)
    return dispatch, dispatch, torch.zeros((), dtype=dtype,
                                           device=ids.device)


def _slots(choice, capacity, dropped):
    """A choice's (expert, capacity-slot) row, ``dropped`` where the token
    was dropped or its gate is zero."""
    idx, gate, pos = choice
    keep = (pos < capacity) & (gate > 0)
    return torch.where(keep, idx.long() * capacity + pos.long(), dropped)


def slot_to_token(choices, num_experts, capacity):
    """The dispatch's gather index: [E * C] int32, the token in each
    (expert, capacity-slot) row, -1 for an empty slot.  Dropped choices
    write a spare last entry, which nothing reads (the JAX package drops
    that write)."""
    T = choices[0][0].shape[0]
    device = choices[0][0].device
    S = num_experts * capacity
    slot_tok = torch.full((S + 1,), -1, dtype=torch.int32, device=device)
    arange = torch.arange(T, dtype=torch.int32, device=device)
    for choice in choices:
        slot_tok[_slots(choice, capacity, S)] = arange
    return slot_tok[:S]


def sparse_dispatch(tokens, choices, num_experts, capacity):
    """[E, C, H] expert inputs straight from routing choices: a row gather
    of the tokens by the slot -> token map (a zero row for an empty
    slot)."""
    H = tokens.shape[1]
    slot_tok = slot_to_token(choices, num_experts, capacity)
    return row_gather(tokens, slot_tok).reshape(num_experts, capacity, H)


def token_to_slot(choice, capacity):
    """The combine's gather index of one routing choice: [T], each token's
    (expert, capacity-slot) row, -1 where it was dropped."""
    return _slots(choice, capacity, -1)


def sparse_combine(expert_out, choices):
    """[T, H] outputs from [E, C, H] expert results and the routing
    choices: per choice, gather the token's slot row (a zero row if it was
    dropped) and scale it by its gate."""
    E, C, H = expert_out.shape
    flat = expert_out.reshape(E * C, H)
    out = None
    for choice in choices:
        term = (row_gather(flat, token_to_slot(choice, C))
                * choice[1][:, None].to(flat.dtype))
        out = term if out is None else out + term
    return out


def _positions_in_queue(mask):
    """Per-token position within its expert's arrival queue; mask [T, E]."""
    return torch.sum(torch.cumsum(mask, dim=0) * mask - mask, dim=-1)


def _choices_with_positions(masks_gates):
    """[(mask [T,E], gate [T])] -> [(expert_idx, gate, pos)], positions
    drawn from per-expert queues SHARED across choices: a later choice
    queues behind every earlier choice's tokens, so two choices never
    share an (expert, capacity-slot)."""
    used = None
    out = []
    for mask, gate in masks_gates:
        pos = _positions_in_queue(mask)
        if used is not None:
            pos = pos + torch.sum(mask * used, dim=-1)
        out.append((torch.argmax(mask, dim=-1), gate, pos))
        counts = torch.sum(mask, dim=0, keepdim=True)
        used = counts if used is None else used + counts
    return out


def _accumulate_dispatch(T, E, C, choices, dtype):
    """choices -> dispatch and combine [T, E, C] (zero rows for tokens past
    capacity).  ``jax.nn.one_hot`` gives a zero row for a position >= C,
    where ``F.one_hot`` raises: the position is clamped, and the keep mask
    zeroes the row as in the JAX package."""
    device = choices[0][1].device
    dispatch = torch.zeros((T, E, C), dtype=dtype, device=device)
    combine = torch.zeros((T, E, C), dtype=dtype, device=device)
    for idx, gate, pos in choices:
        keep = (pos < C).to(dtype)
        oh = (_one_hot(idx, E, dtype)[:, :, None]
              * _one_hot(pos.long().clamp(0, C - 1), C, dtype)[:, None, :])
        oh = oh * keep[:, None, None]
        dispatch = dispatch + oh * (gate > 0).to(dtype)[:, None, None]
        combine = combine + oh * gate[:, None, None]
    return dispatch, combine


layout_transform_op = simple_op(
    lambda x, dispatch: torch.einsum("tec,th->ech", dispatch, x),
    "layout_transform")
reverse_layout_transform_op = simple_op(
    lambda expert_out, combine: torch.einsum("ech,tec->th", expert_out,
                                             combine),
    "reverse_layout_transform")


def ktop1_gating_choices(logits, k, capacity):
    """``ktop1_gating`` in choices form."""
    T, E = logits.shape
    assert E % k == 0, "KTop1 needs num_experts divisible by k"
    Ep = E // k
    sub = logits.reshape(T, k, Ep)
    probs = torch.softmax(sub, dim=-1)         # softmax per prototype
    aux = 0.0
    masks_gates = []
    for i in range(k):
        idx_local = torch.argmax(sub[:, i], dim=-1)
        mask_local = _one_hot(idx_local, Ep, probs.dtype)
        gate = torch.sum(probs[:, i] * mask_local, dim=-1)
        aux = aux + Ep * torch.sum(torch.mean(probs[:, i], dim=0)
                                   * torch.mean(mask_local, dim=0))
        mask = _one_hot(i * Ep + idx_local, E, probs.dtype)
        masks_gates.append((mask, gate))
    return _choices_with_positions(masks_gates), aux


def ktop1_gating(logits, k, capacity):
    """KTop1 gate: experts split into k prototypes of E/k; each token routes
    top-1 within every prototype, with a balance loss per prototype."""
    T, E = logits.shape
    choices, aux = ktop1_gating_choices(logits, k, capacity)
    dispatch, combine = _accumulate_dispatch(T, E, capacity, choices,
                                             logits.dtype)
    return dispatch, combine, aux


def _group_index(num_groups, Eg, device):
    """Each expert's group: [0]*Eg + [1]*Eg + ..."""
    return torch.arange(num_groups, device=device).repeat_interleave(Eg)


def sam_gating_choices(logits, k, capacity, num_groups):
    """``sam_gating`` in choices form."""
    T, E = logits.shape
    assert E % num_groups == 0
    Eg = E // num_groups
    assert k <= Eg, (f"SAM routes within one group of {Eg} experts; "
                     f"k={k} would exhaust it")
    probs = torch.softmax(logits, dim=-1)
    gidx = _group_index(num_groups, Eg, logits.device)
    gmass = sam_group_sum(probs.T, gidx, num_groups).T      # [T, G]
    top_group = torch.argmax(gmass, dim=-1)                 # [T]
    in_group = gidx[None, :] == top_group[:, None]
    remaining = torch.where(in_group, logits, -torch.inf)
    masks_gates = []
    first_mask = None
    for _ in range(k):
        mask = _one_hot(torch.argmax(remaining, dim=-1), E, probs.dtype)
        if first_mask is None:
            first_mask = mask
        masks_gates.append((mask, torch.sum(probs * mask, dim=-1)))
        remaining = torch.where(mask > 0, -torch.inf, remaining)
    choices = _choices_with_positions(masks_gates)
    balance = E * torch.sum(torch.mean(probs, dim=0)
                            * torch.mean(first_mask, dim=0))
    alignment = torch.mean(1.0 - torch.max(gmass, dim=-1).values)
    return choices, balance + alignment


def sam_gating(logits, k, capacity, num_groups):
    """SAM gate: each token picks the expert group with the largest
    probability mass, then its top-k experts inside that group.  Aux =
    GShard balance loss + an alignment term on the chosen group's mass."""
    T, E = logits.shape
    choices, aux = sam_gating_choices(logits, k, capacity, num_groups)
    dispatch, combine = _accumulate_dispatch(T, E, capacity, choices,
                                             logits.dtype)
    return dispatch, combine, aux


def base_balance_gating(scores, capacity):
    """BASE-layer gate: a capacity-constrained assignment balances the load;
    the combine weight is sigmoid(token . centroid)."""
    T, E = scores.shape
    idx = balance_assignment(scores, capacity)
    gate = torch.sigmoid(scores[torch.arange(T, device=scores.device), idx])
    mask = _one_hot(idx, E, scores.dtype)
    pos = _positions_in_queue(mask)
    dispatch, combine = _accumulate_dispatch(
        T, E, capacity, [(idx, gate, pos)], scores.dtype)
    return dispatch, combine, torch.zeros((), dtype=scores.dtype,
                                          device=scores.device)


def balance_assignment(scores, capacity=None):
    """BASE-layer balanced assignment, the JAX package's greedy scan: token
    by token, the best-scoring expert that still has room.  scores [T, E]
    -> expert index [T] int32."""
    T, E = scores.shape
    cap = capacity or (T + E - 1) // E
    load = torch.zeros((E,), dtype=torch.int32, device=scores.device)
    out = torch.zeros((T,), dtype=torch.int32, device=scores.device)
    full = scores.new_full((), torch.inf)
    for t in range(T):
        e = torch.argmax(scores[t] - torch.where(load >= cap, full, 0.0))
        load[e] += 1
        out[t] = e
    return out


def sam_group_sum(x, group_idx, num_groups):
    """Segment sum of ``x`` rows by ``group_idx`` into ``num_groups``."""
    out = torch.zeros((num_groups,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add(0, group_idx.long(), x)


def _scatter1d(x, idx, size=None):
    if size is None:
        raise ValueError("scatter1d_op requires size= (the output length)")
    out = torch.zeros((size,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[idx.long()] = x
    return out


scatter1d_op = simple_op(_scatter1d, "scatter1d")
topk_idx_op = simple_op(
    lambda x, k=1: torch.topk(x, k).indices.to(torch.int32), "topk_idx")
topk_val_op = simple_op(lambda x, k=1: torch.topk(x, k).values, "topk_val")
