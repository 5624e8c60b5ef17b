"""OverWindowExecutor: window functions over a retractable stream.

Port of ``risingwave_tpu/stream/executors/over_window.py`` (reference
parity: src/stream/src/executor/over_window/general.rs:59, state pk =
partition | order | input pk, output = input + window columns; delta
application per partition, general.rs:295 and :443; the partition cache
of over_window/over_partition.rs). Append-only inputs never produce
retraction deltas, so the EOWC variant (over_window/eowc.rs) is this
executor too.

Each partition an epoch touched recomputes its window outputs as whole-
column numpy passes (``expr/window.compute_window_outputs``) at the
barrier and emits the diff against its previous outputs: one recompute
per touched partition per epoch. Outputs are a function of the
partition's rows, so recovery needs only the input rows in the state
table: a partition recomputes on its first touch.

Window order is the memcomparable bytes of the ORDER BY columns (DESC
inverts every byte), then the input pk's bytes as the tie-break: the
reference's StateKey = memcmp(order) | pk (general.rs:130). A NULL order
value is the tag 0x02, above every non-NULL tag, so ASC sorts NULLS LAST
and DESC NULLS FIRST (PostgreSQL's defaults).

Two rules keep a reload from applying an epoch twice:

- a partition is loaded (snapshot) before the epoch's rows reach the
  state table's memtable: the first row of an epoch that touches it
  loads it, then the chunk is written;
- neither the partition LRU (``PARTITION_CACHE_CAP``) nor the memory
  context's evictor (``utils/memory.py``, which keeps the 8 most recent)
  drops a partition with buffered deltas.

The partition cache registers with ``utils/memory.GLOBAL`` as the
reference's does: its size in bytes, and an evictor, since the cache is
a clean snapshot of the state table. This is host code: no kernel runs
here.
"""

from __future__ import annotations

import bisect
import weakref
from collections import OrderedDict
from typing import AsyncIterator, Dict, List, Optional, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk, next_pow2
from risingwave_tpu_torch.common.types import Field, Schema
from risingwave_tpu_torch.expr.window import WindowCall, compute_window_outputs
from risingwave_tpu_torch.state.keycodec import encode_memcomparable
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import Message, is_barrier, is_chunk
from risingwave_tpu_torch.utils import memory as _mem

MAX_OUT_CHUNK = 4096
PARTITION_CACHE_CAP = 256
# partitions the memory context's evictor leaves cached
EVICT_KEEP = 8


class _Partition:
    """One partition's rows in window order and its last emitted
    outputs."""

    __slots__ = ("keys", "rows", "outs")

    def __init__(self):
        # sort keys: (memcomparable order bytes, memcomparable pk bytes)
        self.keys: List[Tuple[bytes, bytes]] = []
        self.rows: List[tuple] = []
        self.outs: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None

    def nbytes(self) -> int:
        """The reference's constant-time estimate of this partition."""
        return (120 * len(self.rows) + 64 * len(self.keys)
                + (0 if self.outs is None else
                   sum(v.nbytes + ok.nbytes for v, ok in self.outs)))


class OverWindowExecutor(Executor):
    """Adds window-function columns to a retractable stream."""

    def __init__(self, input_: Executor,
                 partition_indices: Sequence[int],
                 order_by: Sequence[Tuple[int, bool]],
                 calls: Sequence[WindowCall],
                 state: StateTable,
                 input_pk: Optional[Sequence[int]] = None,
                 output_names: Optional[Sequence[str]] = None,
                 actor_id: int = 0):
        self.input = input_
        self.partition_indices = list(partition_indices)
        self.order_by = [(i, bool(desc)) for i, desc in order_by]
        self.calls = list(calls)
        self.state = state
        in_schema = input_.schema
        # the state pk's tie-break suffix is the part of the input pk
        # outside the partition and order columns; the full input pk (the
        # output's identity) defaults to it, which is right when the pk is
        # disjoint from them (a planner passes the full pk)
        prefix = len(self.partition_indices) + len(self.order_by)
        self.pk_suffix = list(state.pk_indices[prefix:])
        self.input_pk = list(input_pk if input_pk is not None
                             else self.pk_suffix)
        assert state.pk_indices[:prefix] == \
            self.partition_indices + [i for i, _ in self.order_by], \
            "over-window state pk must be partition | order | suffix"
        names = list(output_names) if output_names else \
            [f"w{j}" for j in range(len(self.calls))]
        fields = list(in_schema) + [
            Field(names[j], c.output_type(in_schema))
            for j, c in enumerate(self.calls)]
        super().__init__(ExecutorInfo(
            Schema(fields), list(self.input_pk),
            f"OverWindowExecutor(actor={actor_id})"))
        self.order_types = [in_schema[i].data_type for i, _ in self.order_by]
        self.pk_types = [in_schema[i].data_type for i in self.pk_suffix]
        # partition key → _Partition, a bounded LRU; a miss reloads from
        # the state table (over_partition.rs's cache)
        self._cache: "OrderedDict[tuple, _Partition]" = OrderedDict()
        # the epoch's deltas: partition key → [(sort key, row, is_insert)]
        self._delta: Dict[tuple, List[tuple]] = {}
        self._register_memory()

    def _register_memory(self) -> None:
        """Account the partition cache with the memory context, and let it
        evict every partition without buffered deltas but the last
        ``EVICT_KEEP``. The callables hold the executor weakly: a dead
        executor's reporter unregisters itself."""
        name = f"{self.identity}#{id(self)}"
        ref = weakref.ref(self)

        def nbytes() -> int:
            s = ref()
            if s is None:
                _mem.GLOBAL.unregister(name)
                return 0
            return sum(p.nbytes() for p in s._cache.values())

        def evict() -> int:
            s = ref()
            if s is None:
                return 0
            before = nbytes()
            for k in [k for k in s._cache if k not in s._delta][:-EVICT_KEEP]:
                s._cache.pop(k)
            return before - nbytes()

        _mem.GLOBAL.register(name, nbytes, evict=evict)

    # -- keys -------------------------------------------------------------
    def _sort_key(self, row: tuple) -> Tuple[bytes, bytes]:
        """(order bytes, pk bytes): sorts in window order with the pk as
        the tie-break; the order half alone decides ORDER BY peerage."""
        parts = []
        for (i, desc), dt in zip(self.order_by, self.order_types):
            b = b"\x02" if row[i] is None else \
                encode_memcomparable([row[i]], [dt])
            parts.append(bytes(255 - x for x in b) if desc else b)
        return (b"".join(parts), encode_memcomparable(
            [row[i] for i in self.pk_suffix], self.pk_types))

    def _partition_key(self, row: tuple) -> tuple:
        return tuple(row[i] for i in self.partition_indices)

    # -- partition load / recompute --------------------------------------
    def _load(self, pkey: tuple) -> _Partition:
        p = self._cache.get(pkey)
        if p is not None:
            self._cache.move_to_end(pkey)
            return p
        p = _Partition()
        pairs = [(self._sort_key(row), row)
                 for _pk, row in self.state.iter_prefix(list(pkey))]
        pairs.sort(key=lambda t: t[0])   # a DESC order differs from pk order
        p.keys = [k for k, _ in pairs]
        p.rows = [r for _, r in pairs]
        self._cache[pkey] = p
        while len(self._cache) > PARTITION_CACHE_CAP:
            # never a partition with buffered deltas, nor the one just
            # loaded (its delta registers right after this call): the
            # snapshot predates the epoch's writes, and a reload would see
            # them in the memtable and apply them twice
            for victim in self._cache:
                if victim not in self._delta and victim != pkey:
                    self._cache.pop(victim)
                    break
            else:
                break
        return p

    def _compute(self, p: _Partition) -> List[Tuple[np.ndarray, np.ndarray]]:
        n = len(p.rows)
        eq_prev = np.zeros(n, dtype=bool)
        if n > 1:
            eq_prev[1:] = [p.keys[j][0] == p.keys[j - 1][0]
                           for j in range(1, n)]
        inputs = []
        for c in self.calls:
            if c.input_idx is None:      # the rank family and COUNT(*)
                inputs.append(None)
                continue
            dt = self.input.schema[c.input_idx].data_type
            col = [r[c.input_idx] for r in p.rows]
            ok = np.asarray([v is not None for v in col])
            if dt.is_device:
                vals = np.asarray([0 if v is None else v for v in col],
                                  dtype=dt.np_dtype)
            else:
                vals = np.asarray(col, dtype=object)
            inputs.append((vals, ok))
        return compute_window_outputs(self.calls, n, eq_prev, inputs)

    def _outputs_of(self, outs, j: int) -> tuple:
        """Row j's window outputs as Python values (None for NULL)."""
        return tuple(None if not outs[c][1][j] else _pyval(outs[c][0][j])
                     for c in range(len(self.calls)))

    # -- delta application ------------------------------------------------
    def _buffer_chunk(self, chunk: StreamChunk) -> None:
        for op, row in chunk.to_records():
            pkey = self._partition_key(row)
            if pkey not in self._delta:
                # the snapshot, before this epoch's writes reach the
                # memtable (the deltas apply on top of it at the barrier)
                self._load(pkey)
                self._delta[pkey] = []
            self._delta[pkey].append(
                (self._sort_key(row), row, op.is_insert))
        self.state.write_chunk(chunk)

    def _flush(self) -> List[StreamChunk]:
        """Apply the buffered deltas partition by partition and emit the
        diff of the window outputs (general.rs build_changes_for_partition).

        Every deletion comes before every insertion, across partitions: a
        row whose partition key changed within the epoch is a delete in its
        old partition's diff and an insert in its new one's, and a
        pk-keyed downstream must see the delete first. Update pairs split
        into plain D/I halves under this order, as the reference's do."""
        dels: List[Tuple[int, tuple]] = []
        inss: List[Tuple[int, tuple]] = []
        for pkey, deltas in self._delta.items():
            p = self._load(pkey)
            old_rows = p.rows
            old_outs = p.outs if p.outs is not None else \
                (self._compute(p) if old_rows else [])
            keys, rows = list(p.keys), list(p.rows)
            for sk, row, is_ins in deltas:
                at = bisect.bisect_left(keys, sk)
                if is_ins:
                    keys.insert(at, sk)
                    rows.insert(at, row)
                elif at < len(keys) and keys[at] == sk:
                    keys.pop(at)
                    rows.pop(at)
                # else: a delete of an unseen row (inconsistent op): skip
            p.keys, p.rows = keys, rows
            p.outs = new_outs = self._compute(p)
            # old vs new (row, outputs) keyed by the input pk: D/I for rows
            # removed or added, D then I for rows whose outputs changed
            old_map = {}
            for j, r in enumerate(old_rows):
                old_map[tuple(r[i] for i in self.input_pk)] = \
                    (r, self._outputs_of(old_outs, j))
            for j, r in enumerate(p.rows):
                o = self._outputs_of(new_outs, j)
                old = old_map.pop(tuple(r[i] for i in self.input_pk), None)
                if old is None:
                    inss.append((int(Op.INSERT), r + o))
                elif old[1] != o or old[0] != r:
                    dels.append((int(Op.DELETE), old[0] + old[1]))
                    inss.append((int(Op.INSERT), r + o))
            for r, o in old_map.values():
                dels.append((int(Op.DELETE), r + o))
        self._delta.clear()
        return self._build_chunks(dels + inss)

    def _build_chunks(self, records) -> List[StreamChunk]:
        out = []
        for at in range(0, len(records), MAX_OUT_CHUNK):
            batch = records[at:at + MAX_OUT_CHUNK]
            t = len(batch)
            cap = next_pow2(t)
            cols = []
            for i, f in enumerate(self.schema):
                dt = f.data_type
                vals = [r[i] for _op, r in batch]
                ok = np.ones(cap, dtype=bool)
                ok[:t] = [v is not None for v in vals]
                if dt.is_device:
                    arr = np.zeros(cap, dtype=dt.np_dtype)
                    arr[:t] = [0 if v is None else v for v in vals]
                else:
                    arr = np.empty(cap, dtype=object)
                    arr[:t] = vals
                cols.append(Column(dt, arr, None if ok.all() else ok))
            ops = np.full(cap, int(Op.INSERT), dtype=np.int8)
            ops[:t] = [op for op, _r in batch]
            vis = np.zeros(cap, dtype=bool)
            vis[:t] = True
            out.append(StreamChunk(self.schema, cols, vis, ops))
        return out

    # -- main loop --------------------------------------------------------
    async def execute(self) -> AsyncIterator[Message]:
        it = self.input.execute()
        first = await it.__anext__()
        assert is_barrier(first), f"expected init barrier, got {first!r}"
        self.state.init_epoch(first.epoch)
        yield first
        async for msg in it:
            if is_chunk(msg):
                self._buffer_chunk(msg)
            elif is_barrier(msg):
                for out in self._flush():
                    yield out
                self.state.commit(msg.epoch)
                yield msg
            # watermarks are dropped: a window over ordered history keeps
            # no column monotone to forward (the reference drops them too)


def _pyval(x):
    return x.item() if hasattr(x, "item") else x
