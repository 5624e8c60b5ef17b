"""Counters of the streaming spine, as far as the ported modules write them.

A minimal copy of ``risingwave_tpu/utils/metrics.py`` (reference parity:
src/common/src/metrics.rs and src/stream/src/executor/monitor/
streaming_stats.rs): ``Counter`` (:85) with labeled series, a registry,
and the four streaming counters the coalescing layer and the keyed
executors write (:311-341):

- ``device_dispatch``: device steps requested per executor (or per
  sharded kernel), counted at the same sites as the reference's, so the
  count means the same thing in both packages: one per chunk an unfused
  agg applies and one per flush, two per join side-epoch, one per fused
  chain step, one per backlog step of a fused agg, one per routed step
  or flush gather of a sharded kernel;
- ``coalesce_chunks_in`` / ``coalesce_chunks_out``: chunks entering and
  leaving coalescers (their ratio is the amortization factor);
- ``compaction_rows_saved``: padded row slots dropped by compaction.

Gauges, histograms, the Prometheus rendering and the other families are
not ported: they belong to the observability slice.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# read-modify-write updates from more than one thread must not lose
# increments across a GIL preemption
_WRITE_LOCK = threading.Lock()


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted(labels.items()))


class Counter:
    """A monotone count per label set."""

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        k = _label_key(labels)
        with _WRITE_LOCK:
            self._values[k] = self._values.get(k, 0.0) + amount

    def series(self) -> List[Tuple[Dict[str, str], float]]:
        """Every labeled series as (labels, value)."""
        return [(dict(k), v) for k, v in sorted(self._values.items())]

    def total(self) -> float:
        """The sum over every labeled series."""
        return sum(self._values.values())


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: Dict[str, Counter] = {}

    def counter(self, name: str, help_: str = "") -> Counter:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Counter(name, help_)
        return m


# the process-global registry
GLOBAL = MetricsRegistry()


class StreamingMetrics:
    """The streaming counters the ported modules write."""

    def __init__(self, registry: MetricsRegistry = GLOBAL):
        r = registry
        self.device_dispatch = r.counter(
            "stream_device_dispatch_count",
            "device steps requested per executor or sharded kernel (the "
            "per-step host cost coalescing amortizes)")
        self.coalesce_chunks_in = r.counter(
            "stream_coalesce_chunks_in",
            "chunks entering coalescers (ratio vs _out is the "
            "amortization factor)")
        self.coalesce_chunks_out = r.counter(
            "stream_coalesce_chunks_out",
            "chunks leaving coalescers after merging")
        self.compaction_rows_saved = r.counter(
            "stream_compaction_rows_saved",
            "padded row slots dropped by chunk compaction")


STREAMING = StreamingMetrics()
