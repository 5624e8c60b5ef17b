"""ExpandExecutor: replicate each chunk once per column subset
(grouping sets, DISTINCT aggregates).

Port of ``risingwave_tpu/stream/executors/expand.py`` (reference parity:
src/stream/src/executor/expand.rs:27). The output schema is [input fields
(subset-masked), input fields (full copy), flag: int64]; for subset i
every non-subset column of the first half is NULL and ``flag`` is i. One
output chunk per (input chunk, subset): whole-column masking over the
host numpy columns, no per-row work.
"""

from __future__ import annotations

from typing import AsyncIterator, List, Sequence

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, StreamChunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import Message, is_chunk


def _null_column(dt: DataType, n: int) -> Column:
    if dt.is_device:
        vals = np.zeros(n, dtype=dt.np_dtype)
    else:
        vals = np.empty(n, dtype=object)
    return Column(dt, vals, np.zeros(n, dtype=bool))


class ExpandExecutor(Executor):
    """Grouping-sets expansion (expand.rs:27 analog)."""

    def __init__(self, input_: Executor,
                 column_subsets: Sequence[Sequence[int]],
                 pk_indices: Sequence[int] = ()):
        fields: List[Field] = []
        for _copy in range(2):
            for f in input_.schema:
                fields.append(Field(f.name, f.data_type))
        fields.append(Field("flag", DataType.INT64))
        super().__init__(ExecutorInfo(Schema(fields), list(pk_indices),
                                      "ExpandExecutor"))
        self.input = input_
        self.column_subsets = [set(s) for s in column_subsets]

    async def execute(self) -> AsyncIterator[Message]:
        async for msg in self.input.execute():
            if not is_chunk(msg):
                yield msg
                continue
            n = msg.capacity
            for i, subset in enumerate(self.column_subsets):
                cols: List[Column] = [
                    c if j in subset else _null_column(c.data_type, n)
                    for j, c in enumerate(msg.columns)]
                cols.extend(msg.columns)
                cols.append(Column(DataType.INT64,
                                   np.full(n, i, dtype=np.int64), None))
                yield StreamChunk(self.schema, cols, msg.visibility,
                                  msg.ops)
