"""ProjectExecutor: stateless vectorized projection.

Port of ``ProjectExecutor`` of ``risingwave_tpu/stream/executors/
simple.py`` (reference parity: src/stream/src/executor/project.rs): eval
expressions over the chunk on the host, emit the new columns; watermarks
pass through monotone derivations (e.g. tumble_start maps a date_time
watermark to a window_start watermark); no-op U-/U+ pairs drop.
"""

from __future__ import annotations

from typing import AsyncIterator, List, Optional, Sequence

import numpy as np

from risingwave_tpu_torch.common.chunk import Op, StreamChunk
from risingwave_tpu_torch.common.types import Field, Schema
from risingwave_tpu_torch.expr.expr import Expression
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import Message, Watermark, is_chunk


class ProjectExecutor(Executor):
    """Vectorized projection (project.rs analog)."""

    def __init__(self, input_: Executor, exprs: Sequence[Expression],
                 names: Optional[Sequence[str]] = None,
                 watermark_derivations: Optional[dict] = None):
        self.input = input_
        self.exprs = list(exprs)
        names = list(names) if names else [
            f"expr{i}" for i in range(len(exprs))]
        out_fields: List[Field] = [Field(name, e.return_type)
                                   for name, e in zip(names, self.exprs)]
        super().__init__(ExecutorInfo(Schema(out_fields), [],
                                      "ProjectExecutor"))
        # input col idx -> output col idx, or (output col idx, transform)
        # for a monotone expression over the watermark column
        self.watermark_derivations = dict(watermark_derivations or {})

    @staticmethod
    def _drop_noop_updates(cols, vis, ops):
        """Mask out U-/U+ pairs whose halves are identical AFTER the
        projection (project.rs noop-update elimination)."""
        ud = np.flatnonzero(vis[:-1] & vis[1:]
                            & (ops[:-1] == int(Op.UPDATE_DELETE))
                            & (ops[1:] == int(Op.UPDATE_INSERT)))
        if not len(ud):
            return vis
        same = np.ones(len(ud), dtype=bool)
        for c in cols:
            v = c.values
            eq = np.asarray(v[ud] == v[ud + 1], dtype=bool)
            if c.validity is not None:
                ok = c.validity
                both_null = ~ok[ud] & ~ok[ud + 1]
                eq = (eq & ok[ud] & ok[ud + 1]) | both_null
            same &= eq
            if not same.any():
                return vis
        drop = ud[same]
        vis = vis.copy()
        vis[drop] = False
        vis[drop + 1] = False
        return vis

    async def execute(self) -> AsyncIterator[Message]:
        async for msg in self.input.execute():
            if is_chunk(msg):
                cols = [e.eval(msg) for e in self.exprs]
                vis = msg.visibility
                if (msg.ops == int(Op.UPDATE_DELETE)).any():
                    vis = self._drop_noop_updates(cols, vis, msg.ops)
                    if not vis.any():
                        continue   # all pairs were noops: emit nothing
                yield StreamChunk(self.schema, cols, vis, msg.ops)
            elif isinstance(msg, Watermark):
                d = self.watermark_derivations.get(msg.col_idx)
                for one in (d if isinstance(d, list)
                            else [] if d is None else [d]):
                    if isinstance(one, tuple):
                        out_idx, fn = one
                        yield Watermark(out_idx, msg.data_type,
                                        fn(msg.value))
                    else:
                        yield msg.with_idx(one)
                # underivable watermarks are dropped (reference behavior)
            else:
                yield msg
