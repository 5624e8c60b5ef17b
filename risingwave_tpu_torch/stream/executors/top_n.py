"""TopN executors: streaming ORDER BY ... OFFSET ... LIMIT maintenance.

Port of ``risingwave_tpu/stream/executors/top_n.py``: ``GroupTopNExecutor``
(:92) in its grouped, plain and append-only forms, and ``TopNExecutor``
(:370). Reference parity: src/stream/src/executor/top_n/ (top_n_plain.rs,
group_top_n.rs, top_n_appendonly.rs); the state table holds every
candidate row keyed by [group key +] order key + pk (top_n_state.rs).

Each chunk applies as one batch and the executor emits the NET delta of
the visible window [offset, offset+limit) of every group the chunk
touched, as the reference does. Ordering is host work (small, control-
heavy sorted structures, as the reference's btree cache): no kernel runs
here. NULLs order as PostgreSQL's: last for ASC, first for DESC. Ties are
broken by the pk, so the order is total and the output deterministic.

Sort keys are native tuples of (null rank, value) per column, flattened
into one tuple, where every DESC column has a numeric physical type
(``_fast_keys``: tuples compare in C, the reference's q5 hot path);
otherwise a per-column comparator. A chunk's inserts into one group are
merged into its sorted rows in one sort when the chunk is done with the
group (before a delete on it, and at the chunk's end), not one
``insort`` each: the same rows in the same order, so the same deltas
(q5-hot's new windows take thousands of candidates in one chunk).

The group cold tier (``tier_cap``, grouped TopN only) runs on the port's
``state/tier.py``: whole group caches evict at checkpoint barriers (their
rows stay in the state table, whose pk leads with the group key), and a
chunk touching an evicted group reloads it with one prefix scan before
its old window is read, so the deltas stay exact.

Not ported: the reference's registration with the host-memory accountant
(``utils/memory.GLOBAL.register``, :143-158), which the port's
``utils/memory.py`` does not have yet; the agg's port leaves it out the
same way.
"""

from __future__ import annotations

import bisect
from collections import Counter
from typing import AsyncIterator, Dict, List, Optional, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk
from risingwave_tpu_torch.common.types import DataType
from risingwave_tpu_torch.state import tier as _tier
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import (
    Message, is_barrier, is_chunk, is_watermark,
)

_INSERT_OPS = frozenset({int(Op.INSERT), int(Op.UPDATE_INSERT)})

# physical types whose values negate, so a DESC column sorts as a tuple
_NUMERIC = frozenset({
    DataType.INT16, DataType.INT32, DataType.INT64, DataType.SERIAL,
    DataType.DECIMAL, DataType.DATE, DataType.TIME, DataType.TIMESTAMP,
    DataType.TIMESTAMPTZ, DataType.FLOAT32, DataType.FLOAT64,
    DataType.BOOLEAN,
})


class _Key:
    """None-aware, per-column asc/desc comparable sort key."""

    __slots__ = ("vals", "descs")

    def __init__(self, vals: Tuple, descs: Tuple[bool, ...]):
        self.vals = vals
        self.descs = descs

    def __lt__(self, other: "_Key") -> bool:
        for a, b, d in zip(self.vals, other.vals, self.descs):
            if a is None and b is None:
                continue
            if a is None:               # NULLS LAST asc / FIRST desc
                return d
            if b is None:
                return not d
            if a == b:
                continue
            return (a > b) if d else (a < b)
        return False

    def __eq__(self, other) -> bool:
        return self.vals == other.vals

    def __repr__(self) -> str:
        return f"_Key({self.vals})"


class _SortedRows:
    """One group's candidates: rows sorted by order key, then pk."""

    __slots__ = ("entries",)

    def __init__(self):
        self.entries: List[Tuple[object, tuple]] = []

    def insert(self, key, row: tuple) -> None:
        bisect.insort(self.entries, (key, row))

    def merge(self, pending: List[Tuple[object, tuple]]) -> None:
        """Insert many (key, row) entries: one stable sort of the sorted
        rows and the new ones (timsort merges the two runs)."""
        if len(pending) == 1:
            bisect.insort(self.entries, pending[0])
        else:
            self.entries.extend(pending)
            self.entries.sort()

    def delete(self, key, row: tuple) -> None:
        i = bisect.bisect_left(self.entries, (key, row))
        if i < len(self.entries) and self.entries[i][1] == row:
            del self.entries[i]

    def window(self, offset: int, limit: Optional[int]) -> List[tuple]:
        hi = None if limit is None else offset + limit
        return [r for _k, r in self.entries[offset:hi]]

    def truncate_beyond(self, n: int) -> List[tuple]:
        """Drop rows ranked >= n (append-only pruning); returns them."""
        dropped = [r for _k, r in self.entries[n:]]
        del self.entries[n:]
        return dropped


class GroupTopNExecutor(Executor):
    """Streaming [group] top-n (top_n_plain.rs / group_top_n.rs analog).

    ``group_indices=[]`` gives plain TopN; ``append_only=True`` prunes the
    state beyond the window (top_n_appendonly.rs analog); ``pk_indices``
    overrides the input's pk where the planner knows it better (a
    projection over an agg).
    """

    def __init__(self, input_: Executor, order_by: Sequence[Tuple[int, bool]],
                 offset: int, limit: Optional[int], state: StateTable,
                 group_indices: Sequence[int] = (),
                 append_only: bool = False,
                 pk_indices: Optional[Sequence[int]] = None,
                 tier_cap: Optional[int] = None):
        pk = list(pk_indices if pk_indices is not None
                  else input_.pk_indices)
        super().__init__(ExecutorInfo(
            input_.schema, pk,
            "GroupTopNExecutor" if group_indices else "TopNExecutor"))
        self.input = input_
        self.order_by = list(order_by)
        self.offset = int(offset)
        self.limit = limit
        self.state = state
        self.group_indices = list(group_indices)
        self.append_only = append_only
        # sort = order columns, then the pk for a total order
        ordered = {j for j, _ in self.order_by}
        self._sort_cols = [i for i, _ in self.order_by] + [
            i for i in pk if i not in ordered]
        self._descs = tuple([d for _, d in self.order_by] +
                            [False] * (len(self._sort_cols)
                                       - len(self.order_by)))
        self.groups: Dict[tuple, _SortedRows] = {}
        self._fast_keys = all(
            (not d) or input_.schema[i].data_type in _NUMERIC
            for i, d in zip(self._sort_cols, self._descs))
        self._key_spec = tuple(zip(self._sort_cols, self._descs))
        # the group cold tier (state/tier.py): whole group caches evict;
        # plain TopN is one window, with nothing to tier
        self._tier = None
        self._tier_part = None
        self._cold_groups: set = set()
        self._tier_seq = 0
        if tier_cap is not None:
            g = len(self.group_indices)
            if not g:
                raise ValueError("tier_cap needs a grouped TopN")
            if state.pk_indices[:g] != self.group_indices:
                raise ValueError(
                    "tier_cap needs the state-table pk prefixed by "
                    "the group key (reload prefix-scans by group): "
                    f"pk={state.pk_indices} group={self.group_indices}")
            for i in state.dist_key_indices:
                if state.pk_indices.index(i) >= g:
                    raise ValueError(
                        "tier_cap needs dist keys inside the group "
                        "prefix")
            self._tier = _tier.GLOBAL
            # registered in execute(): a plan that never runs leaves no
            # participant in the global tier
            self._tier_cap = int(tier_cap)
            self._tier_name = f"{self.identity}#{id(self)}"

    # -- helpers ---------------------------------------------------------
    def _key_of(self, row: tuple):
        if self._fast_keys:
            # per column (null rank, value), flattened: rows are physical,
            # so every DESC value negates; NULLS LAST asc / FIRST desc
            out = []
            for i, d in self._key_spec:
                v = row[i]
                if v is None:
                    out += (-1, 0) if d else (1, 0)
                else:
                    out += (0, -v) if d else (0, v)
            return tuple(out)
        return _Key(tuple(row[i] for i in self._sort_cols), self._descs)

    def _group_of(self, row: tuple) -> tuple:
        return tuple([row[i] for i in self.group_indices])

    def _window(self, g: tuple) -> List[tuple]:
        rows = self.groups.get(g)
        return rows.window(self.offset, self.limit) if rows else []

    def _recover(self) -> None:
        # rows are physical end to end (DECIMAL as scaled int64): the
        # order is the same under that encoding, and the state table
        # stores it
        for _pk, row in self.state.iter_rows():
            g = self._group_of(row)
            self.groups.setdefault(g, _SortedRows()).insert(
                self._key_of(row), row)
        if self._tier is not None and self.groups:
            # every group recovers resident (cold marks do not survive a
            # crash); the first checkpoint sweep applies the cap again
            self._tier.touch(self._tier_part, list(self.groups),
                             self._tier_seq)

    # -- the cold tier (state/tier.py) -------------------------------------
    def _tier_register(self) -> None:
        import weakref
        tref = weakref.ref(self)

        def _evict_cb(keys):
            s = tref()
            return 0 if s is None else s._tier_evict(keys)

        self._tier_part = self._tier.register(self._tier_name, _evict_cb,
                                              cap=self._tier_cap)

    def _tier_evict(self, groups: List[tuple]) -> int:
        """The tier's sweep callback (checkpoint barriers, after the
        commit): drop these groups' sorted caches; their rows stay in
        the state table."""
        n = 0
        for g in groups:
            if self.groups.pop(g, None) is not None:
                self._cold_groups.add(g)
                n += 1
        return n

    def _reload_group(self, g: tuple) -> None:
        """Reload an evicted group's candidates with one prefix scan,
        before the chunk's writes and its old-window capture."""
        self._cold_groups.discard(g)
        rows = _SortedRows()
        for _pk, row in self.state.iter_prefix(list(g)):
            row = tuple(row)
            rows.insert(self._key_of(row), row)
        if rows.entries:
            self.groups[g] = rows
        self._tier.note_reload(self._tier_part, 1)

    # -- the chunk path --------------------------------------------------
    def _apply(self, chunk: StreamChunk) -> Optional[StreamChunk]:
        touched: Dict[tuple, List[tuple]] = {}
        _idx, prows, pops = chunk.to_physical_records()
        # cold groups reload BEFORE write_chunk: the prefix scan must see
        # the pre-chunk state only, or the old window would already hold
        # this chunk's rows and the loop would insert them twice
        if self._cold_groups:
            for row in prows:
                g = self._group_of(row)
                if g in self._cold_groups:
                    self._reload_group(g)
        # the state writes as one chunk apply (the same multiset the loop
        # below keeps in memory); only append-only pruning writes rows
        self.state.write_chunk(chunk)
        # each group's inserts wait in `pending` until a delete on the
        # group or the chunk's end, then merge in one sort
        pending: Dict[tuple, List[Tuple[object, tuple]]] = {}
        for op_i, row in zip(pops.tolist(), prows):
            g = self._group_of(row)
            if g not in touched:
                touched[g] = self._window(g)
            key = self._key_of(row)
            if op_i in _INSERT_OPS:
                pending.setdefault(g, []).append((key, row))
                continue
            if self.append_only:
                raise ValueError("delete on append-only TopN input")
            rows = self.groups.setdefault(g, _SortedRows())
            if g in pending:
                rows.merge(pending.pop(g))
            rows.delete(key, row)
        for g, new in pending.items():
            rows = self.groups.setdefault(g, _SortedRows())
            rows.merge(new)
            if self.append_only and self.limit is not None:
                for dropped in rows.truncate_beyond(self.offset
                                                    + self.limit):
                    self.state.delete(dropped)
        if self._tier is not None and touched:
            self._tier.touch(self._tier_part, list(touched),
                             self._tier_seq)
        # the net window delta of each touched group
        deletes: List[tuple] = []
        inserts: List[tuple] = []
        for g, old_window in touched.items():
            new_window = self._window(g)
            old_c, new_c = Counter(old_window), Counter(new_window)
            for r, cnt in (old_c - new_c).items():
                deletes.extend([r] * cnt)
            for r, cnt in (new_c - old_c).items():
                inserts.extend([r] * cnt)
        if not deletes and not inserts:
            return None
        return self._delta_chunk(deletes, inserts)

    def _delta_chunk(self, deletes: List[tuple],
                     inserts: List[tuple]) -> StreamChunk:
        rows = deletes + inserts
        n = len(rows)
        ops = np.asarray([int(Op.DELETE)] * len(deletes)
                         + [int(Op.INSERT)] * len(inserts), dtype=np.int8)
        cols: List[Column] = []
        for j, f in enumerate(self.schema):
            vals_l = [r[j] for r in rows]
            ok = np.asarray([v is not None for v in vals_l])
            if f.data_type.is_device:
                vals = np.asarray([0 if v is None else v for v in vals_l],
                                  dtype=f.data_type.np_dtype)
            else:
                vals = np.asarray(vals_l, dtype=object)
            cols.append(Column(f.data_type, vals,
                               None if ok.all() else ok))
        return StreamChunk(self.schema, cols, np.ones(n, dtype=bool), ops)

    async def execute(self) -> AsyncIterator[Message]:
        it = self.input.execute()
        first = await it.__anext__()
        assert is_barrier(first)
        if self._tier is not None:
            self._tier_register()
        self.state.init_epoch(first.epoch)
        self._recover()
        yield first
        try:
            async for msg in it:
                if is_chunk(msg):
                    out = self._apply(msg)
                    if out is not None:
                        yield out
                elif is_barrier(msg):
                    self.state.commit(msg.epoch)
                    if self._tier is not None:
                        # sweep at checkpoints, after the commit: evicted
                        # groups' rows are durable, no chunk in flight
                        self._tier_seq += 1
                        if msg.kind.is_checkpoint:
                            self._tier.sweep(self._tier_part,
                                             self._tier_seq)
                    yield msg
                elif is_watermark(msg):
                    if msg.col_idx in self.group_indices:
                        yield msg   # group-key watermarks pass through
        finally:
            if self._tier_part is not None:
                self._tier.unregister(self._tier_part)


def TopNExecutor(input_: Executor, order_by, offset, limit,
                 state: StateTable, append_only: bool = False
                 ) -> GroupTopNExecutor:
    """Plain (ungrouped) TopN: top_n_plain.rs / top_n_appendonly.rs."""
    return GroupTopNExecutor(input_, order_by, offset, limit, state,
                             group_indices=(), append_only=append_only)
