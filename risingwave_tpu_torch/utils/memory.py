"""The process's host-memory context: a registry of host-state size
reporters and evictors under a soft limit.

Port of ``risingwave_tpu/utils/memory.py``'s ``MemoryContext`` (reference
parity: src/common/src/estimate_size/ and src/compute/src/
memory_management/memory_manager.rs:33-70). Operators register an
``nbytes`` callable (constant-time accounting of a host cache) and,
where the cache is a clean snapshot that can be reloaded, an ``evict``
callable that frees what it safely can and returns the bytes freed.
``tick()`` sums the reporters into ``last_total`` and, while the total is
over ``soft_limit``, runs the evictors largest-first.

``state/tier.py`` reads ``soft_limit`` and ``last_total`` at its barrier
sweeps: it evicts every participant down to half its residency while
``last_total`` is over ``soft_limit``.

Not ported yet:

- the ``host_state_bytes`` gauge that the reference sets for each
  reporter in ``tick()`` and drops in ``unregister()``: the port's
  ``utils/metrics.py`` has no gauge;
- calling ``tick()`` from the barrier loop, and the agg's, the TopN's and
  the tier's reporters. Only the over-window executor registers here, so
  ``last_total`` moves only where a caller ticks the context.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


class MemoryContext:
    """Host-state size reporters and evictors under a soft limit (None:
    no limit); ``last_total`` is the total of the last ``tick()`` or
    ``total_bytes()``, in bytes."""

    def __init__(self, soft_limit_bytes: Optional[int] = None):
        self.soft_limit = soft_limit_bytes
        self.last_total = 0
        self._reporters: Dict[str, Callable[[], int]] = {}
        self._evictors: Dict[str, Callable[[], int]] = {}

    def register(self, name: str, nbytes: Callable[[], int],
                 evict: Optional[Callable[[], int]] = None) -> None:
        self._reporters[name] = nbytes
        if evict is not None:
            self._evictors[name] = evict

    def unregister(self, name: str) -> None:
        self._reporters.pop(name, None)
        self._evictors.pop(name, None)

    def sizes(self) -> Dict[str, int]:
        # a snapshot first: a dead executor's reporter unregisters itself
        # when called, which mutates the registry
        return {n: int(f()) for n, f in list(self._reporters.items())}

    def total_bytes(self) -> int:
        total = sum(self.sizes().values())
        self.last_total = total
        return total

    def tick(self) -> int:
        """Account every reporter; over the soft limit, run the evictors
        largest-first until the total is back under it. Returns the total
        after any eviction."""
        sizes = self.sizes()
        total = sum(sizes.values())
        self.last_total = total
        if self.soft_limit is None or total <= self.soft_limit:
            return total
        for name in sorted(self._evictors, key=lambda n: -sizes.get(n, 0)):
            freed = int(self._evictors[name]())
            total -= freed
            if total <= self.soft_limit:
                break
        # a deferred evictor (the state tier) sees the over-limit total
        # through last_total and sweeps at its own barriers
        self.last_total = max(total, 0)
        return total


GLOBAL = MemoryContext()
