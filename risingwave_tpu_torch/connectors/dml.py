"""In-process DML channel: the table-write path.

Port of ``risingwave_tpu/connectors/dml.py``, unchanged but for its
imports.

Reference parity: src/source/src/dml_manager.rs + the DmlExecutor —
batch INSERT/DELETE/UPDATE statements hand their chunks to the
table's streaming fragment through a registered channel, so table
writes flow through the SAME barrier/checkpoint pipeline as connector
data (exactly-once, MV chains see them as ordinary deltas).

TPU re-design: the reader side implements the SplitReader protocol
(stream/executors/source.py), so a plain SourceExecutor drives it;
``unbounded=True`` parks the source on its barrier channel while no
DML is pending instead of declaring the stream exhausted.

Replay: none. A DML statement only returns once its chunk's
checkpoint commits, so after recovery the committed table state IS
the statement's effect — seek() has nothing to do.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from risingwave_tpu_torch.common.chunk import StreamChunk
from risingwave_tpu_torch.common.types import Schema

_SEQ_BITS = 12            # row-id epoch window (row_id_gen.py scheme)


class DmlReader:
    """SplitReader over an in-process deque of DML chunks."""

    unbounded = True

    def __init__(self, schema: Schema):
        self.schema = schema
        self.split_id = "dml"
        self.offset = 0
        self._pending: deque = deque()

    def seek(self, offset: int) -> None:
        pass                       # nothing to replay (module docstring)

    def push(self, chunk: StreamChunk) -> None:
        self._pending.append(chunk)

    def next_chunk(self) -> Optional[StreamChunk]:
        if not self._pending:
            return None
        self.offset += 1
        return self._pending.popleft()


class RowIdSeq:
    """Hidden-_row_id allocator for tables without a PRIMARY KEY.
    Same epoch-rebase scheme as RowIdGenExecutor: ids from after a
    recovery start above every id allocated before it (the committed
    epoch is monotone), without persisting a counter."""

    def __init__(self) -> None:
        self._next = 0

    def take(self, committed_epoch: int, n: int) -> range:
        floor = (committed_epoch >> 16) << _SEQ_BITS
        if self._next < floor:
            self._next = floor
        start = self._next
        self._next += n
        return range(start, start + n)
