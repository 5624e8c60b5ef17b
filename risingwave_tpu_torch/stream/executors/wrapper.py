"""WrapperExecutor: runtime protocol checks around any executor.

Port of ``risingwave_tpu/stream/executors/wrapper.py`` (reference parity:
src/stream/src/executor/wrapper.rs with wrapper/schema_check.rs,
update_check.rs, epoch_check.rs). The checks catch a protocol violation
where it starts instead of three operators downstream:

- schema: a chunk's column count and types match the executor's schema;
- update pairs: a visible UPDATE_DELETE is immediately followed (in
  visible row order) by a visible UPDATE_INSERT, and only by one;
- epochs: barrier epochs strictly increase;
- watermarks: a column's watermark never regresses.
"""

from __future__ import annotations

from typing import AsyncIterator, Dict, Optional

import numpy as np

from risingwave_tpu_torch.common.chunk import Op, StreamChunk
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import (
    Message, Watermark, is_barrier, is_chunk,
)


class SanityError(AssertionError):
    """A stream-protocol violation caught by WrapperExecutor."""


class WrapperExecutor(Executor):
    """Protocol assertions around an inner executor (wrapper.rs analog)."""

    def __init__(self, inner: Executor):
        super().__init__(ExecutorInfo(
            inner.schema, list(inner.pk_indices),
            f"Wrapper({inner.identity})"))
        self.inner = inner
        self._last_epoch: Optional[int] = None
        self._watermarks: Dict[int, object] = {}

    def _check_chunk(self, chunk: StreamChunk) -> None:
        ident = self.inner.identity
        if len(chunk.columns) != len(self.schema):
            raise SanityError(
                f"{ident}: chunk has {len(chunk.columns)} columns, "
                f"schema has {len(self.schema)}")
        for i, (c, f) in enumerate(zip(chunk.columns, self.schema)):
            if c.data_type != f.data_type:
                raise SanityError(
                    f"{ident}: column {i} is {c.data_type}, "
                    f"schema says {f.data_type}")
        visible_ops = np.asarray(chunk.ops)[np.asarray(chunk.visibility)]
        is_ud = visible_ops == int(Op.UPDATE_DELETE)
        is_ui = visible_ops == int(Op.UPDATE_INSERT)
        if len(visible_ops) and bool(is_ud[-1]):
            raise SanityError(f"{ident}: chunk ends with UPDATE_DELETE")
        if bool((is_ud & ~np.roll(is_ui, -1)).any()):
            raise SanityError(
                f"{ident}: UPDATE_DELETE not followed by UPDATE_INSERT")
        if bool((is_ui & ~np.roll(is_ud, 1)).any()):
            raise SanityError(
                f"{ident}: UPDATE_INSERT not preceded by UPDATE_DELETE")

    async def execute(self) -> AsyncIterator[Message]:
        async for msg in self.inner.execute():
            if is_chunk(msg):
                self._check_chunk(msg)
            elif is_barrier(msg):
                e = msg.epoch.curr.value
                if self._last_epoch is not None and e <= self._last_epoch:
                    raise SanityError(
                        f"{self.inner.identity}: barrier epoch {e:#x} not "
                        f"after {self._last_epoch:#x}")
                self._last_epoch = e
            elif isinstance(msg, Watermark):
                prev = self._watermarks.get(msg.col_idx)
                if prev is not None and msg.value < prev:
                    raise SanityError(
                        f"{self.inner.identity}: watermark regressed on "
                        f"col {msg.col_idx}: {msg.value} < {prev}")
                self._watermarks[msg.col_idx] = msg.value
            yield msg
