"""Stream messages: the protocol every executor speaks.

Port of ``risingwave_tpu/stream/message.py`` (unchanged protocol).

Reference parity: src/stream/src/executor/mod.rs:173 (``Message::{Chunk,
Barrier, Watermark}``), :223-246 (``Mutation``), :622 (``Barrier``);
proto/stream_plan.proto:85-122 (Barrier/Watermark wire shape);
BarrierKind: proto/stream_plan.proto:86-92.

Messages are host-side control objects — the device only ever sees the
lanes a stateful operator packs from a ``StreamChunk``. A ``Barrier`` is the
global synchronization token; everything between two barriers is one
"micro-batch" that kernels may process as a single fused device step.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Optional, Union

from risingwave_tpu_torch.common.chunk import StreamChunk
from risingwave_tpu_torch.common.epoch import EpochPair
from risingwave_tpu_torch.common.types import DataType


class BarrierKind(enum.Enum):
    """proto/stream_plan.proto:86-92: not every barrier is a checkpoint."""

    INITIAL = "initial"        # first barrier after boot/recovery
    BARRIER = "barrier"        # flush memtables, no durable sync
    CHECKPOINT = "checkpoint"  # flush + sync: durable recovery point

    @property
    def is_checkpoint(self) -> bool:
        return self in (BarrierKind.INITIAL, BarrierKind.CHECKPOINT)


# ---------------------------------------------------------------------------
# Mutations: control-plane commands piggybacked on barriers
# (src/stream/src/executor/mod.rs:223; the port carries Update (a hash
# dispatcher's output swap), Stop, Pause and Resume)


@dataclass(frozen=True)
class UpdateMutation:
    """Dispatcher output swaps at a barrier (reschedule): dispatcher id
    -> its replacement output list."""

    dispatcher_updates: Dict[int, list] = field(default_factory=dict)


@dataclass(frozen=True)
class StopMutation:
    """Actors to stop (job drop). Actors in the set terminate after this
    barrier; their downstream channels close."""

    actors: FrozenSet[int] = frozenset()


@dataclass(frozen=True)
class PauseMutation:
    """Pause sources (no data until Resume; barriers still flow)."""


@dataclass(frozen=True)
class ResumeMutation:
    """Resume paused sources."""


Mutation = Union[UpdateMutation, StopMutation, PauseMutation,
                 ResumeMutation]


# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Barrier:
    """The checkpoint token (executor/mod.rs:622 analog).

    Flows from sources to sinks through every channel; aligned at fan-in.
    Carrying `epoch = EpochPair(curr, prev)`: data after this barrier lands
    at `curr`; state committed by this barrier is readable at `prev`.
    """

    epoch: EpochPair
    kind: BarrierKind = BarrierKind.CHECKPOINT
    mutation: Optional[Mutation] = None
    passed_actors: tuple = ()  # debug trail, actor ids appended in transit

    @property
    def is_checkpoint(self) -> bool:
        return self.kind.is_checkpoint

    def is_stop(self, actor_id: int) -> bool:
        return (isinstance(self.mutation, StopMutation)
                and actor_id in self.mutation.actors)

    def is_pause(self) -> bool:
        return isinstance(self.mutation, PauseMutation)

    def is_resume(self) -> bool:
        return isinstance(self.mutation, ResumeMutation)

    def with_passed(self, actor_id: int) -> "Barrier":
        return Barrier(self.epoch, self.kind, self.mutation,
                       self.passed_actors + (actor_id,))

    def __repr__(self) -> str:
        m = f", {type(self.mutation).__name__}" if self.mutation else ""
        return f"Barrier({self.epoch.curr.value:#x}, {self.kind.value}{m})"


@dataclass(frozen=True)
class Watermark:
    """Monotonic lower bound on future values of one column
    (executor/mod.rs watermark; used for state cleaning and EOWC)."""

    col_idx: int
    data_type: DataType
    value: object  # host scalar in the column's logical domain

    def with_idx(self, idx: int) -> "Watermark":
        return Watermark(idx, self.data_type, self.value)

    def __repr__(self) -> str:
        return f"Watermark(col={self.col_idx}, {self.value})"


Message = Union[StreamChunk, Barrier, Watermark]


def is_chunk(m: Message) -> bool:
    return isinstance(m, StreamChunk)


def is_barrier(m: Message) -> bool:
    return isinstance(m, Barrier)


def is_watermark(m: Message) -> bool:
    return isinstance(m, Watermark)
