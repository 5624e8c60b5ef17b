"""The Executor protocol: pull-based async message streams.

Port of ``risingwave_tpu/stream/executor.py`` (unchanged protocol).

Reference parity: src/stream/src/executor/mod.rs:173 (``Executor`` trait —
``execute() -> BoxedMessageStream`` plus schema/pk/identity metadata).

Executors are async generators. An executor chain is a
single-consumer pull pipeline; barriers flowing through it are the only
synchronization points. Stateful executors buffer device work between
barriers and flush on ``Barrier`` — one fused device step per epoch where
possible, so Python overhead amortizes over the whole micro-batch.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import AsyncIterator, List, Optional, Tuple

from risingwave_tpu_torch.common.types import Schema
from risingwave_tpu_torch.stream.message import Message


@dataclass
class ExecutorInfo:
    """Schema + pk + display identity of an executor's output."""

    schema: Schema
    pk_indices: List[int] = field(default_factory=list)
    identity: str = "Executor"


class Executor(abc.ABC):
    """Base for all stream executors (mod.rs:173 analog)."""

    def __init__(self, info: ExecutorInfo):
        self._info = info

    @property
    def schema(self) -> Schema:
        return self._info.schema

    @property
    def pk_indices(self) -> List[int]:
        return self._info.pk_indices

    @property
    def identity(self) -> str:
        return self._info.identity

    @abc.abstractmethod
    def execute(self) -> AsyncIterator[Message]:
        """Async generator of Messages, ending after a Stop barrier."""

    def __repr__(self) -> str:
        return f"{self.identity}({self.schema!r})"



# attributes under which executors hold their input executors, in plan
# order (the conventional names every executor in stream/executors uses)
_CHILD_ATTRS = ("input", "upstream", "left_in", "right_in")
_CHILD_LIST_ATTRS = ("inputs",)


def executor_children(ex) -> List[Tuple[str, Optional[int], "Executor"]]:
    """(attr, list-index-or-None, child) per input executor of `ex`: the
    one shared tree walk of the plan rewrite (frontend/opt)."""
    out: List[Tuple[str, Optional[int], Executor]] = []
    for attr in _CHILD_ATTRS:
        c = getattr(ex, attr, None)
        if isinstance(c, Executor):
            out.append((attr, None, c))
    for attr in _CHILD_LIST_ATTRS:
        cs = getattr(ex, attr, None)
        if isinstance(cs, list):
            for i, c in enumerate(cs):
                if isinstance(c, Executor):
                    out.append((attr, i, c))
    return out
