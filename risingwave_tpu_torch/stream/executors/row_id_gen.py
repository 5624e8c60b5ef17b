"""RowIdGenExecutor: append a hidden serial row-id column.

Port of ``risingwave_tpu/stream/executors/row_id_gen.py`` (reference
parity: src/stream/src/executor/row_id_gen.rs + the snowflake layout of
src/common/src/util/row_id.rs): tables and MVs with no user pk get a
generated ``_row_id`` so every row has a unique, stable key, unique
across parallel actors and across restarts (the time component comes
from the epoch, and recovery resumes at a strictly newer epoch).

Layout: | shard (10, most significant) | rel_ms (epoch physical ms, ~41
bits) | seq (12) |. A sequence that overflows its 12 bits carries into
rel_ms within the same shard. The sequence is rebased to the current
barrier's epoch floor at every barrier. Id assignment is one vectorized
arange add per chunk.
"""

from __future__ import annotations

from typing import AsyncIterator

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, StreamChunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import Message, is_barrier, is_chunk

ROW_ID_FIELD = Field("_row_id", DataType.SERIAL)

_SHARD_BITS = 10
_SEQ_BITS = 12


class RowIdCounter:
    """The id counter alone: the runtime of a ``row_id_gen`` stage
    absorbed into a fused run (ops/fused.py). RowIdGenExecutor is one
    (plus the executor loop)."""

    def __init__(self, vnode_base: int = 0):
        assert 0 <= vnode_base < (1 << _SHARD_BITS)
        self._shard = vnode_base << (63 - _SHARD_BITS)
        self._next = self._shard

    @property
    def vnode_base(self) -> int:
        return self._shard >> (63 - _SHARD_BITS)

    def _rebase(self, epoch_value: int) -> None:
        floor = self._shard | ((epoch_value >> 16) << _SEQ_BITS)
        if self._next < floor:
            self._next = floor


class RowIdGenExecutor(RowIdCounter, Executor):
    """Appends ``_row_id`` (SERIAL) as the last column (row_id_gen.rs)."""

    def __init__(self, input_: Executor, vnode_base: int = 0):
        schema = Schema(list(input_.schema.fields) + [ROW_ID_FIELD])
        Executor.__init__(self, ExecutorInfo(schema, [len(input_.schema)],
                                             "RowIdGenExecutor"))
        RowIdCounter.__init__(self, vnode_base)
        self.input = input_

    async def execute(self) -> AsyncIterator[Message]:
        async for msg in self.input.execute():
            if is_chunk(msg):
                cap = msg.capacity
                # every slot (visible or padding) gets an id; ids of
                # padding slots are never observed
                ids = self._next + np.arange(cap, dtype=np.int64)
                self._next += cap
                yield StreamChunk(self.schema,
                                  list(msg.columns)
                                  + [Column(DataType.SERIAL, ids)],
                                  msg.visibility, msg.ops)
            else:
                if is_barrier(msg):
                    self._rebase(msg.epoch.curr.value)
                yield msg
