"""TemporalJoinExecutor: a stream joined with a versioned table AS OF
process time.

Port of ``risingwave_tpu/stream/executors/temporal_join.py`` (reference
parity: src/stream/src/executor/temporal_join.rs:52; the right side is an
arrangement, lookup.rs:42). The left stream probes the right side's
current version; a match is emitted once and never revised when the right
side changes later, so the output is append-only. The arrangement is a
host map from the right join key to a row ref in a columnar arena (the
hash join's ``_Arena``), kept from the right input's changelog: right
rows must be readable by any key at probe time, and VARCHAR payloads stay
on the host.

- The right pk is the join key (the planner enforces it): one row a key.
- INNER drops unmatched left rows; LEFT OUTER pads them with NULLs. A
  NULL key never matches.
- Left chunks and left watermarks buffer until the barrier and probe
  after every right row of the epoch has applied, so the answer does not
  depend on how the two inputs interleave within an epoch.
- Right ops apply in row order: a U-/U+ pair on one key ends on the new
  version.
- The left input must be append-only (asserted).
- Nothing persists: recovery replays the right side's chain to rebuild
  the arrangement.

This is host code: no kernel runs here.
"""

from __future__ import annotations

from typing import AsyncIterator, Dict, List, Optional, Sequence

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk, next_pow2
from risingwave_tpu_torch.common.types import Field, Schema
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.executors.hash_join import _Arena
from risingwave_tpu_torch.stream.merge import barrier_align_2
from risingwave_tpu_torch.stream.message import Message, Watermark, is_barrier

_INSERT_OPS = (int(Op.INSERT), int(Op.UPDATE_INSERT))


class TemporalJoinExecutor(Executor):
    """A stream LEFT OUTER or INNER temporal join against an arranged
    table."""

    # the arena compacts once this many refs were handed out and at most
    # half of them are live
    COMPACT_MIN_REFS = 4096

    def __init__(self, left: Executor, right: Executor,
                 left_keys: Sequence[int], right_keys: Sequence[int],
                 outer: bool = False, actor_id: int = 0,
                 output_names: Optional[Sequence[str]] = None):
        assert len(left_keys) == len(right_keys)
        self.left_in, self.right_in = left, right
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.outer = outer
        fields = [f for sch in (left.schema, right.schema) for f in sch]
        if output_names:
            fields = [Field(output_names[k], f.data_type)
                      for k, f in enumerate(fields)]
        # the output's identity is the left row; the right columns are
        # frozen as of the probe
        super().__init__(ExecutorInfo(
            Schema(fields), list(left.pk_indices),
            f"TemporalJoinExecutor(actor={actor_id})"))
        self.n_left = len(left.schema)
        # right join-key tuple → row ref into the arena
        self._arranged: Dict[tuple, int] = {}
        self._arena = _Arena(right.schema)
        self._next_ref = 0

    # -- the arrangement --------------------------------------------------
    @staticmethod
    def _row_keys(chunk: StreamChunk, idx: np.ndarray,
                  key_cols: Sequence[int]) -> List[tuple]:
        """Join-key tuples of the given rows (None for a NULL); the payload
        columns never become Python values."""
        cols = []
        for i in key_cols:
            c = chunk.columns[i]
            vals = np.asarray(c.values)[idx].tolist()
            if c.validity is not None:
                okv = np.asarray(c.validity)[idx].tolist()
                vals = [v if o else None for v, o in zip(vals, okv)]
            cols.append(vals)
        return list(zip(*cols)) if cols else [()] * len(idx)

    def _apply_right(self, chunk: StreamChunk) -> None:
        vis_idx = np.flatnonzero(np.asarray(chunk.visibility))
        if not len(vis_idx):
            return
        ops = np.asarray(chunk.ops)[vis_idx]
        keys = self._row_keys(chunk, vis_idx, self.right_keys)
        is_ins = np.isin(ops, _INSERT_OPS)
        has_null = [any(v is None for v in k) for k in keys]
        ins_rows = [j for j in range(len(vis_idx))
                    if is_ins[j] and not has_null[j]]
        ref_of = {}
        if ins_rows:
            refs = np.arange(self._next_ref, self._next_ref + len(ins_rows),
                             dtype=np.int32)
            self._next_ref += len(ins_rows)
            self._arena.store(refs, chunk, vis_idx[ins_rows])
            ref_of = dict(zip(ins_rows, refs.tolist()))
        # in row order: an update pair is [U-, U+] on one key and must end
        # on the new version
        for j, key in enumerate(keys):
            if has_null[j]:
                continue
            if is_ins[j]:
                self._arranged[key] = ref_of[j]
            else:
                self._arranged.pop(key, None)
        self._maybe_compact()

    def _maybe_compact(self) -> None:
        """Reclaim dead arena refs wholesale once they are at least half:
        the right side is an MV changelog, and update pairs strand old
        rows."""
        if self._next_ref < self.COMPACT_MIN_REFS or \
                len(self._arranged) * 2 > self._next_ref:
            return
        live = list(self._arranged.items())
        old_refs = np.asarray([r for _k, r in live], dtype=np.int64)
        arena = _Arena(self.right_in.schema)
        arena.ensure(max(len(live) - 1, 0))
        for i in range(len(self.right_in.schema)):
            arena.cols[i][:len(live)] = self._arena.cols[i][old_refs]
            arena.valid[i][:len(live)] = self._arena.valid[i][old_refs]
        self._arena = arena
        self._arranged = {k: j for j, (k, _r) in enumerate(live)}
        self._next_ref = len(live)

    # -- the probe ----------------------------------------------------------
    def _probe_left(self, chunk: StreamChunk) -> Optional[StreamChunk]:
        vis_idx = np.flatnonzero(np.asarray(chunk.visibility))
        if not len(vis_idx):
            return None
        ops = np.asarray(chunk.ops)[vis_idx]
        assert np.isin(ops, _INSERT_OPS).all(), \
            "temporal join left input must be append-only"
        keys = self._row_keys(chunk, vis_idx, self.left_keys)
        get = self._arranged.get
        refs = np.fromiter((get(k, -1) for k in keys), dtype=np.int64,
                           count=len(keys))
        # a row with a NULL key never matches
        for i in self.left_keys:
            c = chunk.columns[i]
            if c.validity is not None:
                refs[~np.asarray(c.validity)[vis_idx]] = -1
        matched = refs >= 0
        sel = np.ones(len(keys), dtype=bool) if self.outer else matched
        t = int(sel.sum())
        if t == 0:
            return None
        cap = next_pow2(t)
        out_idx = vis_idx[sel]
        cols: List[Column] = []
        for i, f in enumerate(self.left_in.schema):
            c = chunk.columns[i]
            src = np.asarray(c.values)[out_idx]
            vals = np.empty(cap, dtype=object) if src.dtype == object \
                else np.zeros(cap, dtype=src.dtype)
            vals[:t] = src
            ok = np.ones(cap, dtype=bool)
            if c.validity is not None:
                ok[:t] = np.asarray(c.validity)[out_idx]
            cols.append(Column(f.data_type, vals, None if ok.all() else ok))
        # the right columns gather from the arena by ref; an unmatched
        # (outer) row is NULL, its value 0 or None
        sel_refs = np.maximum(refs[sel], 0)
        sel_ok = matched[sel]
        padded = not sel_ok.all()
        for i, f in enumerate(self.right_in.schema):
            col = self._arena.gather_col(i, sel_refs, cap)
            ok = np.ones(cap, dtype=bool)
            ok[:t] = sel_ok if col.validity is None \
                else (np.asarray(col.validity)[:t] & sel_ok)
            vals = col.values
            if padded:
                vals = vals.copy()
                vals[:t][~sel_ok] = None if vals.dtype == object else 0
            cols.append(Column(f.data_type, vals, None if ok.all() else ok))
        vis = np.zeros(cap, dtype=bool)
        vis[:t] = True
        ops_out = np.full(cap, int(Op.INSERT), dtype=np.int8)
        return StreamChunk(self.schema, cols, vis, ops_out)

    # -- main loop --------------------------------------------------------
    async def execute(self) -> AsyncIterator[Message]:
        lit = self.left_in.execute()
        rit = self.right_in.execute()
        first_l = await lit.__anext__()
        first_r = await rit.__anext__()
        assert is_barrier(first_l) and is_barrier(first_r)
        yield first_l
        # the epoch's left messages, probed at its barrier
        left_buf: List[Message] = []
        async for tag, msg in barrier_align_2(lit, rit):
            if tag == "barrier":
                for m in left_buf:
                    if isinstance(m, StreamChunk):
                        out = self._probe_left(m)
                        if out is not None:
                            yield out
                    else:
                        yield m          # a left watermark, in order
                left_buf.clear()
                yield msg
            elif tag == "right":
                # right watermarks do not bound the output
                if isinstance(msg, StreamChunk):
                    self._apply_right(msg)
            elif isinstance(msg, StreamChunk) or (
                    isinstance(msg, Watermark) and msg.col_idx < self.n_left):
                left_buf.append(msg)
