"""Slot-based state pool: one fixed cache arena, leased per request.

The arena is the batch dimension of the decode cache (``init_cache(cfg,
n_slots, max_len)``, leaves shaped ``(n_groups, n_slots, ...)``).  A slot
is one batch row: a request leases it on admission, the engine resets
the row, and retirement releases it.  ``plan`` is the memory allocator's
placement of the rows; the allocator is not ported yet, so it stays None.
"""
from __future__ import annotations

from typing import Optional

import torch


def slot_bytes(cfg, max_len: int) -> int:
    """Bytes of ONE slot row across every cache leaf of every unit: an
    attention unit's KV ring, an rwkv6 unit's recurrent state (wkv and
    shift), a Mamba unit's conv rows and SSM state (the states
    independent of max_len)."""
    from repro_torch.runtime.train_loop import cache_bytes
    return cache_bytes(cfg, 1, max_len)


class SlotPool:
    """Lease/release bookkeeping over ``n_slots`` arena rows.

    Lease order is deterministic (lowest free slot first);
    ``leased_by_recency`` supports the scheduler's eviction policy.
    """

    def __init__(self, n_slots: int, plan=None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.plan = plan
        self._free = list(range(n_slots - 1, -1, -1))   # pop() -> lowest
        self._owner: dict = {}                          # slot -> request id
        self._seq: dict = {}                            # slot -> lease tick
        self._tick = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    def owner(self, slot: int) -> Optional[str]:
        return self._owner.get(slot)

    def lease(self, rid: str) -> Optional[int]:
        """Lease the lowest free slot to `rid`; None when the arena is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._owner[slot] = rid
        self._seq[slot] = self._tick
        self._tick += 1
        return slot

    def release(self, slot: int) -> None:
        if slot not in self._owner:
            raise KeyError(f"slot {slot} is not leased")
        del self._owner[slot]
        del self._seq[slot]
        self._free.append(slot)
        self._free.sort(reverse=True)

    def leased_by_recency(self) -> list:
        return sorted(self._seq, key=self._seq.__getitem__, reverse=True)


def reset_slots(cache, slots) -> object:
    """Re-initialise arena rows `slots` in place: integer leaves (the
    attention ``pos`` maps) to -1, float leaves (KV values, the rwkv6
    ``wkv`` state and token ``shift``, the Mamba ``conv`` rows and
    ``ssm`` state) to 0 — ``init_cache``'s values.  Returns the cache."""
    if isinstance(cache, dict):
        for v in cache.values():
            reset_slots(v, slots)
        return cache
    fill = 0 if cache.is_floating_point() else -1
    cache[:, torch.as_tensor(slots, dtype=torch.int64,
                             device=cache.device)] = fill
    return cache
