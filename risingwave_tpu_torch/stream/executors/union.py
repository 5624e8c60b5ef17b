"""UnionExecutor: merge N same-schema inputs into one aligned stream.

Port of ``risingwave_tpu/stream/executors/union.py`` (reference parity:
src/stream/src/executor/union.rs:29, with watermarks per
BufferedWatermarks: the minimum across inputs, monotonically). Unlike
``MergeExecutor``, which merges exchange channels, a union composes child
executors of one actor.
"""

from __future__ import annotations

from typing import AsyncIterator, Sequence

from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.merge import (
    _WatermarkAligner, barrier_align_n,
)
from risingwave_tpu_torch.stream.message import Message, Watermark


class UnionExecutor(Executor):
    """Merge N upstream executors (union.rs:29 analog)."""

    def __init__(self, inputs: Sequence[Executor],
                 pk_indices: Sequence[int] = ()):
        assert inputs, "UnionExecutor needs at least one input"
        schema = inputs[0].schema
        for e in inputs[1:]:
            assert [f.data_type for f in e.schema] == \
                [f.data_type for f in schema], \
                f"union schema mismatch: {e.schema!r} vs {schema!r}"
        super().__init__(ExecutorInfo(schema, list(pk_indices),
                                      "UnionExecutor"))
        self.inputs = list(inputs)

    async def execute(self) -> AsyncIterator[Message]:
        wm = _WatermarkAligner(len(self.inputs))
        async for tag, msg in barrier_align_n(
                [e.execute() for e in self.inputs]):
            if tag == "barrier":
                yield msg
            elif isinstance(msg, Watermark):
                w = wm.update(tag, msg)
                if w is not None:
                    yield w
            else:
                yield msg
