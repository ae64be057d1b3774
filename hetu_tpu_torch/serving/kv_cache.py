"""The dense slot pool for serving K/V caches (port of ``SlotKVCache`` in
``hetu_tpu/serving/kv_cache.py``).

ONE pair of static-shaped device tensors,

    k, v : [layers, n_slots, kv_heads, max_len, head_dim]

allocated once at engine construction and never reshaped, so the
engine's captured prefill and decode step read the same tensors whichever
requests occupy which slots.  The JAX pool is slot-major
([n_slots, layers, ...]); here each layer's cache is one contiguous
block, which the attention's batched products read as a view.  The
engine's programs write the pool in place: a prefill rows [0, P) of its
slot, a decode step row ``positions[i]`` of each slot ``i``.

A slot is the unit of admission: one in-flight request owns one slot;
retiring a request returns its slot to the free list immediately, and
the next queued request reuses it mid-flight without touching the other
slots.  Per-slot write positions (== tokens cached) are tracked on the
host in numpy; stale rows beyond a slot's position are never attended
(the step's mask is ``col <= position``) and are overwritten in order by
later decode writes, so freeing or reusing a slot needs no zeroing.

The JAX pool books its bytes in the telemetry HBM ledger (slice G of the
port, ROADMAP.md); here ``nbytes`` holds them.  The paged pool arrives
with slice D2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.executor import resolve_device


class SlotKVCache:
    """Fixed pool of ``n_slots`` K/V cache slots on one device (the card
    unless ``device="cpu"``)."""

    def __init__(self, n_slots, layers, kv_heads, max_len, head_dim,
                 dtype=torch.float32, device=None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self.layers = int(layers)
        self.kv_heads = int(kv_heads)
        self.max_len = int(max_len)
        self.head_dim = int(head_dim)
        self.device = resolve_device(device)
        shape = (self.layers, self.n_slots, self.kv_heads, self.max_len,
                 self.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.nbytes = 2 * self.k.numel() * self.k.element_size()
        # host mirrors: next write position (== tokens cached) per slot
        self.positions = np.zeros(self.n_slots, np.int32)
        # pop() -> slot 0 first
        self._free = list(range(self.n_slots - 1, -1, -1))
        self._owner = [None] * self.n_slots
        self.alloc_count = 0
        self.free_count = 0

    # -- allocation --------------------------------------------------------
    @property
    def n_free(self):
        return len(self._free)

    @property
    def n_active(self):
        return self.n_slots - len(self._free)

    def alloc(self, owner=None, n_tokens=None, shared=None):
        """Claim a free slot (lowest id first); None when the pool is
        exhausted — admission control, not an error.  ``n_tokens`` (the
        paged pool's worst-case reservation) is accepted and ignored:
        every dense slot already holds a full ``max_len`` span.
        ``shared`` (page-granular prefix sharing) is a paged-pool
        concept and must stay empty here."""
        del n_tokens
        if shared:
            raise ValueError(
                "SlotKVCache has no pages to share; prefix caching "
                "requires the paged pool")
        if not self._free:
            return None
        slot = self._free.pop()
        self._owner[slot] = owner
        self.positions[slot] = 0
        self.alloc_count += 1
        return slot

    def free(self, slot):
        """Return ``slot`` to the pool.  Double-free is a bug in the
        scheduler and raises — a silently re-listed slot would be handed
        to two requests at once and corrupt both."""
        slot = int(slot)
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range")
        if slot in self._free:
            raise RuntimeError(f"double free of slot {slot}")
        self._owner[slot] = None
        self.positions[slot] = 0
        self._free.append(slot)
        self.free_count += 1

    def owner(self, slot):
        return self._owner[slot]

    def allocated_slots(self):
        """Slots currently claimed (not on the free list), sorted."""
        free = set(self._free)
        return [s for s in range(self.n_slots) if s not in free]

    def audit(self):
        """Lifetime alloc/free accounting for the no-leak invariant: after
        a drain, ``allocs == frees`` and ``in_use == 0`` — anything else
        means a slot leaked (lost to a crashed request) and the pool will
        eventually starve."""
        return {"allocs": self.alloc_count,
                "frees": self.free_count,
                "in_use": self.n_active}

    # -- step plumbing -----------------------------------------------------
    def advance(self, slots):
        """Bump the write position of ``slots`` after a decode step wrote
        one token each."""
        for s in slots:
            if self.positions[s] >= self.max_len:
                raise RuntimeError(
                    f"slot {s} overran max_len={self.max_len}")
            self.positions[s] += 1

    def close(self):
        """Nothing to release: the JAX pool ends its HBM-ledger booking
        here (slice G); the tensors are reclaimed with the pool."""
