"""The process's host-memory context, as far as the cold tier reads it.

A minimal copy of ``risingwave_tpu/utils/memory.py``'s ``MemoryContext``
(reference parity: src/compute/src/memory_management/memory_manager.rs:
33-70): a soft limit on the accounted host-state bytes and the last
accounted total. ``state/tier.py`` evicts every participant down to half
its residency at its next sweep while ``last_total`` is over
``soft_limit``. The reference's reporter registry, evictors and gauges
(``register``, ``tick``) are not ported: they belong to the observability
slice, so here the total is set by whoever measures it.
"""

from __future__ import annotations

from typing import Optional


class MemoryContext:
    """A soft limit (None: no limit) and the last accounted total, in
    bytes."""

    def __init__(self, soft_limit_bytes: Optional[int] = None):
        self.soft_limit = soft_limit_bytes
        self.last_total = 0


GLOBAL = MemoryContext()
