"""ReceiverExecutor, ProjectExecutor and FilterExecutor: stateless
single-input executors.

Port of ``risingwave_tpu/stream/executors/simple.py`` (reference parity:
src/stream/src/executor/receiver.rs, project.rs, filter.rs). A receiver
adapts one exchange channel into an executor. A projection evals
expressions over the chunk on the host and emits the new columns;
watermarks pass through monotone derivations (e.g. tumble_start maps a
date_time watermark to a window_start watermark); no-op U-/U+ pairs
drop. A filter narrows the visibility mask and degrades update pairs
whose halves the predicate splits.
"""

from __future__ import annotations

from typing import AsyncIterator, List, Optional, Sequence

import numpy as np

from risingwave_tpu_torch.common.chunk import Op, StreamChunk
from risingwave_tpu_torch.common.types import Field, Schema
from risingwave_tpu_torch.expr.expr import Expression
from risingwave_tpu_torch.stream.exchange import ChannelClosed, Receiver
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import (
    Message, Watermark, is_barrier, is_chunk,
)


class ReceiverExecutor(Executor):
    """Adapts one exchange Receiver into an Executor (receiver.rs). It
    does not close the receiver when it ends: the upstream may still be
    attached to the channel."""

    def __init__(self, info: ExecutorInfo, rx: Receiver, actor_id: int = 0):
        super().__init__(info)
        self.rx = rx
        self.actor_id = actor_id

    async def execute(self) -> AsyncIterator[Message]:
        while True:
            try:
                msg = await self.rx.recv()
            except ChannelClosed:
                return
            yield msg
            if is_barrier(msg) and msg.is_stop(self.actor_id):
                return


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


class FilterExecutor(Executor):
    """Visibility-mask filter with update-pair degradation (filter.rs)."""

    def __init__(self, input_: Executor, predicate: Expression):
        self.input = input_
        self.predicate = predicate
        super().__init__(ExecutorInfo(input_.schema,
                                      list(input_.pk_indices),
                                      "FilterExecutor"))

    async def execute(self) -> AsyncIterator[Message]:
        async for msg in self.input.execute():
            if is_chunk(msg):
                out = self.apply_predicate(msg, self.predicate)
                # a fully-filtered chunk is dead weight downstream
                if np.asarray(out.visibility).any():
                    yield out
            else:
                yield msg

    @staticmethod
    def apply_predicate(chunk: StreamChunk,
                        predicate: Expression) -> StreamChunk:
        """THE filter transform: visibility mask plus U-/U+ pair
        degradation by shifted compares (rolled with wrap-around, as the
        fused chain of ops/fused.py does it on the card)."""
        pcol = predicate.eval(chunk)
        pred = np.asarray(pcol.values).astype(bool)
        if pcol.validity is not None:  # NULL predicate = not satisfied
            pred = pred & pcol.validity
        ops = np.asarray(chunk.ops)
        is_ud = ops == np.int8(int(Op.UPDATE_DELETE))
        is_ui = ops == np.int8(int(Op.UPDATE_INSERT))
        # pair (i, i+1): U- at i, U+ at i+1
        next_is_ui = np.roll(is_ui, -1)
        prev_is_ud = np.roll(is_ud, 1)
        next_pred = np.roll(pred, -1)
        prev_pred = np.roll(pred, 1)
        # U- whose U+ half fails the predicate → plain DELETE
        degrade_del = is_ud & next_is_ui & pred & ~next_pred
        # U+ whose U- half fails the predicate → plain INSERT
        degrade_ins = is_ui & prev_is_ud & pred & ~prev_pred
        new_ops = np.where(degrade_del, np.int8(int(Op.DELETE)), ops)
        new_ops = np.where(degrade_ins, np.int8(int(Op.INSERT)), new_ops)
        return StreamChunk(chunk.schema, chunk.columns,
                           np.asarray(chunk.visibility) & pred, new_ops)
