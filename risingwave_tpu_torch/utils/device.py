"""Device placement, host<->device transfers and kernel launch counts.

Counterpart of ``risingwave_tpu/utils/jaxtools.py``: ``upload`` (:336),
``start_fetch``/``fetch`` (:234, :280) and ``PendingCounters`` (:354).
There is no jit here, so ``instrumented_jit``'s retrace count has no
counterpart; what a run needs to show instead is that the main path
went through the hand-written kernels, which ``LAUNCHES`` counts.

On CUDA a device->host copy into pageable memory is synchronous, so
every fetch copies into a pinned buffer with ``non_blocking=True`` and
records an event; the host reads the buffer only after the event has
completed. On the CPU a fetch is a copy taken at once: the port updates
device state in place, so a later read must not see later updates.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without one, the caller must ask for the
    CPU explicitly (``device="cpu"``), which runs the plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


class LaunchCounts:
    """Per-kernel launch counts. Each kernel wrapper adds one where it
    launches its CUDA kernel, and nowhere else (the plain versions do
    not count), so a run can show which kernels its path went through."""

    def __init__(self) -> None:
        self._n: Dict[str, int] = {}

    def add(self, name: str) -> None:
        self._n[name] = self._n.get(name, 0) + 1

    def reset(self) -> None:
        self._n.clear()

    def snapshot(self) -> Dict[str, int]:
        return dict(self._n)


LAUNCHES = LaunchCounts()


def upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host numpy array -> device tensor. On CUDA the array goes through
    a pinned buffer and the copy is asynchronous on the current stream
    (PyTorch's pinned allocator keeps the buffer alive until it lands)."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


def staging(n: int, device: torch.device) -> torch.Tensor:
    """A 1-D int32 host tensor to write an upload into in place, then
    send with ``send``: pinned for a CUDA device (no second host copy),
    a plain tensor on the CPU (which ``send`` returns as it is)."""
    return torch.empty(n, dtype=torch.int32,
                       pin_memory=device.type == "cuda")


def send(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A ``staging`` tensor on `device`: an asynchronous copy on the
    current stream on CUDA (the pinned allocator keeps the buffer alive
    until it lands)."""
    if device.type != "cuda":
        return host
    return host.to(device, non_blocking=True)


class Fetch:
    """A started device->host copy; ``result()`` waits for it."""

    __slots__ = ("_host", "_event")

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t.detach().clone()
            self._event = None

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def start_fetch(t: torch.Tensor) -> Fetch:
    """Start the device->host copy without waiting."""
    return Fetch(t)


def fetch(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> numpy, through the pinned async path."""
    return Fetch(t).result()


class ProbeOverflowError(RuntimeError):
    """A probe_insert ran ``cap`` steps without placing a row: the
    load-factor contract (ops/hash_table.py MAX_LOAD) was broken."""


class PendingCounters:
    """Sync-free occupancy accounting for device hash structures.

    Every insert launch returns a device ``stats`` pair (rows inserted,
    overflow flag); its copy to the host starts at launch and folds into
    the running count when it lands. The load bound callers use is
    ``count() + pending_rows()`` — exact once every counter drained, an
    upper bound meanwhile. Launches that insert no counted rows (table
    rebuilds) are ``watch``ed for the overflow flag alone. A set flag
    raises ``ProbeOverflowError`` when its copy is folded in.
    """

    def __init__(self, initial: int = 0):
        self._count = initial
        self._pending: List[Tuple[Fetch, int]] = []
        self._rows = 0
        self._watched: List[Fetch] = []

    def push(self, stats: torch.Tensor, n_rows: int) -> None:
        self._pending.append((start_fetch(stats), n_rows))
        self._rows += n_rows

    def watch(self, stats: torch.Tensor) -> None:
        self._watched.append(start_fetch(stats))

    def count(self) -> int:
        return self._count

    def pending_rows(self) -> int:
        return self._rows

    def bound(self) -> int:
        return self._count + self._rows

    @staticmethod
    def _check(stats: np.ndarray) -> int:
        if int(stats[1]):
            raise ProbeOverflowError(
                "probe_insert ran out of probe steps: the table is "
                "over its load-factor contract")
        return int(stats[0])

    def _drain_watched(self, block: bool) -> None:
        while self._watched and (block or self._watched[0].ready()):
            self._check(self._watched.pop(0).result())

    def drain_ready(self) -> None:
        """Fold in landed counters; never blocks. FIFO: counters land in
        launch order (one stream)."""
        while self._pending and self._pending[0][0].ready():
            f, n = self._pending.pop(0)
            self._count += self._check(f.result())
            self._rows -= n
        self._drain_watched(block=False)

    def drain_all(self) -> int:
        """Fold in every counter (blocks on copies already in flight)."""
        for f, _n in self._pending:
            self._count += self._check(f.result())
        self._pending = []
        self._rows = 0
        self._drain_watched(block=True)
        return self._count

    def reset(self, exact: int) -> None:
        """Adopt an externally observed exact count (flush header,
        rebuild) that subsumes every in-flight counter. Their overflow
        flags are still checked first."""
        self.drain_all()
        self._count = exact
