"""EowcGateExecutor: EMIT ON WINDOW CLOSE output gating.

Port of ``risingwave_tpu/stream/executors/eowc.py`` (reference parity:
src/stream/src/executor/sort_buffer.rs, the watermark-keyed sort buffer,
as hash_agg.rs:510 and over_window/eowc.rs use it). Under EMIT ON WINDOW
CLOSE a job emits each result row once, when the watermark passes its
window column, instead of a changelog. The gate, downstream of a
windowed aggregation, holds the current version of every result row in
a StateTable keyed by (window column, pk suffix); a watermark advancing
to w releases, as plain INSERTs in window order, every row whose window
column is below w, and is forwarded. Released windows are final by the
upstream's own watermark contract, so a late change to one is an
upstream violation and raises.
"""

from __future__ import annotations

from typing import AsyncIterator, List, Optional

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk, next_pow2
from risingwave_tpu_torch.state.keycodec import (
    encode_memcomparable, encode_vnode_prefix,
)
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import (
    Message, Watermark, is_barrier, is_chunk,
)

MAX_OUT_CHUNK = 4096


class EowcGateExecutor(Executor):
    """Emit-once gate over a changelog (sort_buffer.rs analog)."""

    def __init__(self, input_: Executor, wm_col: int,
                 state: StateTable, actor_id: int = 0):
        self.input = input_
        self.wm_col = wm_col
        self.state = state
        # the buffer's pk leads with the watermark column: a release is
        # one ordered range scan and its deletion
        assert state.pk_indices[0] == wm_col, \
            "EOWC buffer pk must lead with the watermark column"
        super().__init__(ExecutorInfo(
            input_.schema, list(input_.pk_indices),
            f"EowcGateExecutor(actor={actor_id})"))
        self._released: Optional[int] = None

    def _apply(self, chunk: StreamChunk) -> None:
        if self._released is not None:
            vis = np.asarray(chunk.visibility)
            c = chunk.columns[self.wm_col]
            late = vis & (np.asarray(c.values).astype(np.int64)
                          < self._released)
            if c.validity is not None:
                late &= np.asarray(c.validity)
            if late.any():
                raise RuntimeError(
                    "EMIT ON WINDOW CLOSE violation: upstream changed "
                    "a window already released at watermark "
                    f"{self._released}")
        self.state.write_chunk(chunk)

    def _release(self, wm: int) -> List[StreamChunk]:
        """Range scan of the closed windows, O(released): it starts
        above the NULL tag (a NULL window never closes; those rows stay
        buffered)."""
        dt = self.schema[self.wm_col].data_type
        start = encode_vnode_prefix(0) + b"\x01"   # skip NULL windows
        end = encode_vnode_prefix(0) + encode_memcomparable([wm], [dt])
        rows = [row for _k, row in
                self.state.iter_encoded_range(start, end)]
        # not max(released or 0, wm): pre-1970 windows are negative
        self._released = wm if self._released is None \
            else max(self._released, wm)
        if not rows:
            return []
        self.state.delete_rows(rows)
        out = []
        for at in range(0, len(rows), MAX_OUT_CHUNK):
            batch = rows[at:at + MAX_OUT_CHUNK]
            t = len(batch)
            cap = next_pow2(t)
            cols = []
            for i, f in enumerate(self.schema):
                dt = f.data_type
                vals = [r[i] for r in batch]
                ok = np.ones(cap, dtype=bool)
                ok[:t] = [v is not None for v in vals]
                if dt.is_device:
                    arr = np.zeros(cap, dtype=dt.np_dtype)
                    arr[:t] = [0 if v is None else v for v in vals]
                else:
                    arr = np.empty(cap, dtype=object)
                    arr[:t] = vals
                cols.append(Column(dt, arr, None if ok.all() else ok))
            vis = np.zeros(cap, dtype=bool)
            vis[:t] = True
            ops = np.full(cap, int(Op.INSERT), dtype=np.int8)
            out.append(StreamChunk(self.schema, cols, vis, ops))
        return out

    async def execute(self) -> AsyncIterator[Message]:
        it = self.input.execute()
        first = await it.__anext__()
        assert is_barrier(first)
        self.state.init_epoch(first.epoch)
        yield first
        pending_wm: Optional[Watermark] = None
        async for msg in it:
            if is_chunk(msg):
                self._apply(msg)
            elif is_barrier(msg):
                # release at the barrier: the emitted rows and the
                # buffer's deletion commit together
                if pending_wm is not None:
                    for out in self._release(int(pending_wm.value)):
                        yield out
                    yield pending_wm
                    pending_wm = None
                self.state.commit(msg.epoch)
                yield msg
            elif isinstance(msg, Watermark):
                if msg.col_idx == self.wm_col:
                    pending_wm = msg
                # other columns' watermarks mean nothing past the gate
