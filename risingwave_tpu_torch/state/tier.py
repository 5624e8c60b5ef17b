"""StateTier: the cold tier stateful executors register with.

Port of ``risingwave_tpu/state/tier.py`` (reference parity: src/stream/
src/executor/managed_state/join/mod.rs:379-420, an LRU over the
StateTable; cache/managed_lru.rs; memory_management/memory_manager.rs:
33-70). The card holds the hot working set, the state table holds
everything, and a touch of an evicted key reloads it.

Contract per participant (an executor-owned cache of keyed state):

- ``touch(part, keys, seq)`` on the ingest path records each key's
  last-touched sequence (the executor's barrier counter). The tier's map
  holds exactly the resident keys, oldest first.
- ``sweep(part, seq)`` runs at the executor's own checkpoint barrier,
  after its flush and commit, never mid-epoch: every state the tier sees
  is the just-committed snapshot. It picks the oldest keys past the
  participant's cap, or past the pressure watermark while the memory
  context (``utils/memory.py``) is over its soft limit, and hands them to
  the participant's ``evict(keys)`` callback, which moves them out of
  device slots and host caches (they stay durable in the state table).
- ``forget(part, keys)`` drops keys that left the state entirely
  (watermark expiry). An evicted key the participant no longer holds is
  a no-op evict.

The tier never touches executor state: eviction and reload mechanics stay
with the owners; this module decides which keys and when. Each
participant counts ``evicted_total`` and ``reload_total`` in keys; the
reference's metric gauges belong to the observability slice and are not
ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple


class TierParticipant:
    """One registered executor-side cache (name, cap, evict hook)."""

    __slots__ = ("name", "cap", "evict", "keys",
                 "evicted_total", "reload_total")

    def __init__(self, name: str, evict: Callable[[List], int],
                 cap: Optional[int]):
        # `evict(keys)` returns the number of keys actually evicted
        self.name = name
        self.evict = evict
        self.cap = cap
        # key → last-touched sequence; a re-touch deletes and reinserts,
        # so the dict's insertion order is oldest first (an O(1) LRU)
        self.keys: Dict[object, int] = {}
        self.evicted_total = 0
        self.reload_total = 0


class StateTier:
    """Central registry and eviction policy (the managed-LRU watermark)."""

    # keep this fraction of the cap after a cap-driven sweep (room for
    # arrivals before the next barrier)
    EVICT_TARGET_RATIO = 0.75
    # under memory pressure, evict each participant down to this fraction
    # of its current residency at its next sweep
    PRESSURE_KEEP_RATIO = 0.5

    def __init__(self, memory=None):
        # the memory context, injected by tests; by default the process's
        self._memory = memory
        self._parts: Dict[str, TierParticipant] = {}

    def _mem(self):
        if self._memory is None:
            from risingwave_tpu_torch.utils import memory as _mem
            self._memory = _mem.GLOBAL
        return self._memory

    # -- registration -----------------------------------------------------
    def register(self, name: str, evict: Callable[[List], int],
                 cap: Optional[int] = None) -> TierParticipant:
        part = TierParticipant(name, evict, cap)
        self._parts[name] = part
        return part

    def unregister(self, part: TierParticipant) -> None:
        self._parts.pop(part.name, None)

    # -- hot path ---------------------------------------------------------
    @staticmethod
    def touch(part: TierParticipant, keys: Iterable, seq: int,
              insert: bool = True) -> None:
        """Refresh recency for `keys`. ``insert=False`` refreshes only
        keys already tracked."""
        d = part.keys
        for k in keys:
            if k in d:
                del d[k]
            elif not insert:
                continue
            d[k] = seq

    @staticmethod
    def forget(part: TierParticipant, keys: Iterable) -> None:
        d = part.keys
        for k in keys:
            d.pop(k, None)

    @staticmethod
    def note_reload(part: TierParticipant, n: int) -> None:
        part.reload_total += n

    # -- the barrier sweep ------------------------------------------------
    def _pressure(self) -> bool:
        mem = self._mem()
        if mem.soft_limit is None:
            return False
        return mem.last_total > mem.soft_limit

    def sweep(self, part: TierParticipant, seq: int) -> int:
        """Evict this participant's oldest keys past its cap (or past the
        pressure watermark). Runs only at the owner's checkpoint barrier.
        Returns keys evicted."""
        del seq                       # recency clock; policy is size-based
        resident = len(part.keys)
        target = None
        if part.cap is not None and resident > part.cap:
            target = int(part.cap * self.EVICT_TARGET_RATIO)
        if self._pressure() and resident > 0:
            ptarget = int(resident * self.PRESSURE_KEEP_RATIO)
            target = ptarget if target is None else min(target, ptarget)
        if target is None:
            return 0
        n_evict = resident - target
        victims = []
        for k in part.keys:           # oldest first
            if len(victims) >= n_evict:
                break
            victims.append(k)
        n = 0
        if victims:
            # count the keys the callback actually evicted (stale and
            # phantom entries are no-ops there), not the request
            n = int(part.evict(victims))
            for k in victims:
                del part.keys[k]
            part.evicted_total += n
        return n

    # -- introspection ------------------------------------------------------
    def stats_rows(self) -> List[Tuple]:
        """(executor, cap, resident_keys, evicted_total, reload_total,
        accounted_bytes) per participant (the reference's rw_state_tier
        rows). Byte accounting belongs to the observability slice, so
        accounted_bytes is 0."""
        out = []
        for p in self._parts.values():
            out.append((p.name, -1 if p.cap is None else int(p.cap),
                        len(p.keys), p.evicted_total, p.reload_total, 0))
        return out


# the process-global tier (managed-LRU registry analog)
GLOBAL = StateTier()
