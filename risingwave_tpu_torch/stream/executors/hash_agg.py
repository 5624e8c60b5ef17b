"""HashAggExecutor: streaming GROUP BY on device-resident state.

Port of the append-only/device path of ``risingwave_tpu/stream/executors/
hash_agg.py`` (reference parity: src/stream/src/executor/hash_agg.rs:67,
:329 apply_chunk, :445 flush_data; value-state encoding of
aggregation/agg_group.rs). The executor is the host driver of a
``GroupedAggKernel``:

  chunk    → int32 key/input lanes (ops/lanes.py codecs) into the kernel's
             backlog; one device step per BATCH_ROWS rows
  barrier  → one device gather of dirty groups → change chunk; physical
             rows persisted through the StateTable; epoch committed;
             groups below the watermark retired on the device

Emission matches flush_data: a group's first appearance emits Insert, a
change emits an UpdateDelete/UpdateInsert pair, a group whose row count
drops to zero emits Delete; outputs compare against the device-resident
emitted snapshot, so no-op touches emit nothing.

Value-state row layout (physical): group keys | group_rows | per call
(value [+ non-null count]); recovery reloads it into the kernel.

Not ported yet, and refused at construction with NotImplementedError:
retractable MIN/MAX (the materialized-input tables), DISTINCT,
approx_count_distinct, string_agg/array_agg, the cold tier (``tier_cap``),
fused stages and injected (sharded) kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import AsyncIterator, Dict, List, Optional, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk, next_pow2
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.ops.hash_agg import (
    DEVICE_AGG_KINDS, AggKind, AggSpec, GroupedAggKernel, acc_dtypes,
)
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.executors.keys import LANES_PER_KEY, KeyCodec
from risingwave_tpu_torch.stream.message import (
    Message, is_barrier, is_chunk, is_watermark,
)

_SUM_OUT = {
    DataType.INT16: DataType.INT64, DataType.INT32: DataType.INT64,
    DataType.INT64: DataType.INT64, DataType.DECIMAL: DataType.DECIMAL,
    DataType.FLOAT32: DataType.FLOAT64, DataType.FLOAT64: DataType.FLOAT64,
}


def agg_result_type(kind: AggKind,
                    input_type: Optional[DataType]) -> DataType:
    """Result type of one aggregate call."""
    if kind == AggKind.COUNT:
        return DataType.INT64
    if kind == AggKind.SUM:
        try:
            return _SUM_OUT[input_type]
        except KeyError:
            raise TypeError(f"sum over {input_type} unsupported")
    if kind in (AggKind.MIN, AggKind.MAX):
        return input_type
    raise NotImplementedError(f"{kind.value} is not ported")


@dataclass(frozen=True)
class AggCall:
    """Logical aggregate call (agg/mod.rs AggCall analog)."""

    kind: AggKind
    input_idx: Optional[int] = None      # None ⇒ count(*)
    distinct: bool = False               # refused: not ported yet

    def out_type(self, input_schema: Schema) -> DataType:
        in_t = None if self.input_idx is None \
            else input_schema[self.input_idx].data_type
        return agg_result_type(self.kind, in_t)

    def spec(self, input_schema: Schema) -> AggSpec:
        if self.kind not in DEVICE_AGG_KINDS:
            raise NotImplementedError(f"{self.kind.value} is not ported")
        if self.kind == AggKind.COUNT and self.input_idx is None:
            return AggSpec(AggKind.COUNT, None)
        in_t = input_schema[self.input_idx].data_type
        if not in_t.is_device:
            raise TypeError(f"agg over host type {in_t} needs the host path")
        return AggSpec(self.kind, np.dtype(in_t.np_dtype))


def agg_output_schema(input_schema: Schema, group_indices: Sequence[int],
                      agg_calls: Sequence[AggCall],
                      names: Optional[Sequence[str]] = None) -> Schema:
    """Output schema: group keys then one column per agg call."""
    fields = [input_schema[i] for i in group_indices]
    for j, call in enumerate(agg_calls):
        name = names[j] if names else f"agg{j}"
        fields.append(Field(name, call.out_type(input_schema)))
    return Schema(fields)


def agg_state_schema(input_schema: Schema, group_indices: Sequence[int],
                     agg_calls: Sequence[AggCall]
                     ) -> Tuple[Schema, List[int]]:
    """Value-state table schema + pk indices (pk = group keys)."""
    fields = [input_schema[i] for i in group_indices]
    fields.append(Field("_group_rows", DataType.INT64))
    specs = [c.spec(input_schema) for c in agg_calls]
    for j, dt in enumerate(acc_dtypes(specs)):
        lt = DataType.FLOAT64 if np.issubdtype(dt, np.floating) \
            else DataType.INT64
        fields.append(Field(f"_acc{j}", lt))
    return Schema(fields), list(range(len(group_indices)))


class HashAggExecutor(Executor):
    """Streaming hash aggregation over a device kernel (hash_agg.rs:67)."""

    def __init__(self, input_: Executor, group_indices: Sequence[int],
                 agg_calls: Sequence[AggCall], table: StateTable,
                 append_only: bool = False,
                 output_names: Optional[Sequence[str]] = None,
                 minput_tables: Optional[Dict[int, StateTable]] = None,
                 actor_id: int = 0,
                 kernel: Optional[object] = None,
                 distinct_tables: Optional[Dict[int, StateTable]] = None,
                 kernel_capacity: Optional[int] = None,
                 flush_capacity: Optional[int] = None,
                 tier_cap: Optional[int] = None,
                 fused_stages=None,
                 device=None):
        for what, given in (("minput_tables", minput_tables),
                            ("distinct_tables", distinct_tables),
                            ("kernel injection (mesh)", kernel),
                            ("tier_cap", tier_cap),
                            ("fused_stages", fused_stages)):
            if given:
                raise NotImplementedError(f"{what} is not ported")
        for c in agg_calls:
            if c.distinct:
                raise NotImplementedError("DISTINCT aggs are not ported")
            if c.kind in (AggKind.MIN, AggKind.MAX) and not append_only:
                raise NotImplementedError(
                    "retractable min/max is not ported: pass "
                    "append_only=True")
        self.input = input_
        self.group_indices = list(group_indices)
        self.agg_calls = list(agg_calls)
        self.table = table
        self.append_only = append_only
        in_schema = input_.schema
        self.group_types = [in_schema[i].data_type
                            for i in self.group_indices]
        self.key_codec = KeyCodec(self.group_types)
        self.specs = [c.spec(in_schema) for c in self.agg_calls]
        self._live_groups = 0
        kw = {"device": device}
        if kernel_capacity is not None:
            kw["capacity"] = kernel_capacity
        if flush_capacity is not None:
            kw["flush_capacity"] = flush_capacity
        self.kernel = GroupedAggKernel(
            key_width=LANES_PER_KEY * len(self.group_indices),
            specs=self.specs, **kw)
        # watermark-driven state cleaning (state_table.rs:894 analog):
        # latest watermark on the FIRST group column, and the last value
        # already applied to the kernel/table
        self._clean_wm: Optional[int] = None
        self._cleaned_wm: Optional[int] = None
        super().__init__(ExecutorInfo(
            agg_output_schema(in_schema, group_indices, agg_calls,
                              output_names),
            list(range(len(group_indices))),
            f"HashAggExecutor(actor={actor_id})"))

    # -- chunk path ------------------------------------------------------
    def _inputs(self, chunk: StreamChunk) -> Tuple:
        """Per call: (host input lane arrays, valid mask)."""
        out = []
        for call, spec in zip(self.agg_calls, self.specs):
            if call.input_idx is None:          # count(*)
                out.append(((), None))
                continue
            c = chunk.columns[call.input_idx]
            in_lanes = spec.encode_input(c.values)
            ok = np.ones(chunk.capacity, dtype=bool) \
                if c.validity is None else c.validity
            out.append((in_lanes, ok))
        return tuple(out)

    def _apply_chunk(self, chunk: StreamChunk) -> None:
        key_lanes = self.key_codec.build(chunk, self.group_indices)
        self.kernel.apply(key_lanes, chunk.signs(), chunk.visibility,
                          self._inputs(chunk))

    # -- watermark state cleaning ----------------------------------------
    def _cleanable_type(self) -> bool:
        """Integer-family first group col only: the device compare runs
        on the (hi, lo) i64 split, order-preserving for ints/timestamps
        but not for bit-cast floats."""
        dt = np.dtype(self.group_types[0].np_dtype)
        return np.issubdtype(dt, np.integer) or dt == np.dtype(bool)

    def _clean_state(self) -> None:
        """Retire groups below the watermark: device rebuild + ordered
        range delete from the state table. Runs after flush/advance."""
        wm = self._clean_wm
        if wm is None or (self._cleaned_wm is not None
                          and wm <= self._cleaned_wm):
            return
        phys = int(wm)
        self.kernel.retire_below(0, phys)
        n = self.table.delete_below_prefix(phys)
        self._live_groups = max(0, self._live_groups - n)
        self._cleaned_wm = wm

    INTERNER_GC_MIN = 4096

    def _maybe_gc_interner(self) -> None:
        """Retire group-key interner entries no live group references,
        once at least half the entries are provably dead."""
        codec = self.key_codec
        if not codec.interners:
            return
        total = codec.interner_entries()
        if total < self.INTERNER_GC_MIN or \
                total <= 2 * max(self._live_groups, 1) * \
                len(codec.interners):
            return
        live_cols: Dict[int, list] = {j: [] for j in codec.interners}
        n_live = 0
        for _pk, row in self.table.iter_rows():
            n_live += 1
            for j in live_cols:
                if row[j] is not None:
                    live_cols[j].append(row[j])
        self._live_groups = n_live
        for j, it in codec.interners.items():
            it.gc(live_cols[j])

    # -- barrier path ----------------------------------------------------
    def _flush(self) -> Optional[StreamChunk]:
        fr = self.kernel.flush()
        if fr.n == 0:
            self.kernel.advance()
            return None
        gk = self.key_codec.decode(fr.keys)
        outs, nulls = fr.outs, fr.nulls
        pouts, pnulls = fr.prev_outs, fr.prev_nulls
        cur_live = fr.group_rows > 0
        was = fr.was_emitted
        changed = np.zeros(fr.n, dtype=bool)
        for o, po, nu, pnu in zip(outs, pouts, nulls, pnulls):
            changed |= (nu != pnu) | (~nu & (o != po))
        ins_i = np.flatnonzero(cur_live & ~was)
        upd_i = np.flatnonzero(cur_live & was & changed)
        del_i = np.flatnonzero(~cur_live & was)
        self._live_groups += len(ins_i) - len(del_i)
        # persistence also covers groups whose outputs are unchanged but
        # whose row/non-null counts moved, or recovery reloads stale counts
        state_moved = fr.group_rows != fr.prev_rows
        for nn, pnn in zip(fr.nns, fr.prev_nns):
            if nn is not None:
                state_moved |= nn != pnn
        persist_upd_i = np.flatnonzero(
            cur_live & was & (changed | state_moved))
        self._persist(fr, gk, ins_i, persist_upd_i, del_i)
        self.kernel.advance()
        t = len(ins_i) + 2 * len(upd_i) + len(del_i)
        if t == 0:
            return None
        cap = next_pow2(t)

        def emit_col(cur: np.ndarray, prev: np.ndarray, dtype) -> np.ndarray:
            out = np.zeros(cap, dtype=dtype)
            k = len(ins_i)
            out[:k] = cur[ins_i]
            out[k:k + 2 * len(upd_i):2] = prev[upd_i]
            out[k + 1:k + 2 * len(upd_i):2] = cur[upd_i]
            out[k + 2 * len(upd_i):t] = prev[del_i]
            return out

        columns: List[Column] = []
        for (vals, ok), dt in zip(gk, self.group_types):
            v = emit_col(vals, vals, dt.np_dtype)
            okc = emit_col(ok, ok, bool)
            columns.append(Column(dt, v, None if okc.all() else okc))
        for j, (o, po, nu, pnu) in enumerate(zip(outs, pouts, nulls,
                                                 pnulls)):
            dt = self.schema[len(self.group_indices) + j].data_type
            v = emit_col(o.astype(dt.np_dtype), po.astype(dt.np_dtype),
                         dt.np_dtype)
            nuc = emit_col(nu, pnu, bool)
            columns.append(Column(dt, v, None if not nuc.any() else ~nuc))
        ops = np.full(cap, int(Op.INSERT), dtype=np.int8)
        k = len(ins_i)
        ops[k:k + 2 * len(upd_i):2] = int(Op.UPDATE_DELETE)
        ops[k + 1:k + 2 * len(upd_i):2] = int(Op.UPDATE_INSERT)
        ops[k + 2 * len(upd_i):t] = int(Op.DELETE)
        vis = np.zeros(cap, dtype=bool)
        vis[:t] = True
        return StreamChunk(self.schema, columns, vis, ops)

    def _state_rows(self, fr, gk, idx: np.ndarray,
                    prev: bool) -> List[tuple]:
        """Physical value-state rows for the given flush indices."""
        rows_col = fr.prev_rows if prev else fr.group_rows
        outs = fr.prev_outs if prev else fr.outs
        nulls = fr.prev_nulls if prev else fr.nulls
        nns = fr.prev_nns if prev else fr.nns
        cols: List[list] = []
        for vals, ok in gk:
            cols.append([v if o else None for v, o in
                         zip(vals[idx].tolist(), ok[idx].tolist())])
        cols.append(rows_col[idx].tolist())
        for j, spec in enumerate(self.specs):
            nn = nns[j]
            cols.extend(spec.host_acc_cols(
                outs[j][idx], nulls[j][idx],
                None if nn is None else nn[idx]))
        return list(zip(*cols)) if cols else []

    def _persist(self, fr, gk, ins_i, upd_i, del_i) -> None:
        self.table.insert_rows(self._state_rows(fr, gk, ins_i, prev=False))
        self.table.update_rows(self._state_rows(fr, gk, upd_i, prev=True),
                               self._state_rows(fr, gk, upd_i, prev=False))
        self.table.delete_rows(self._state_rows(fr, gk, del_i, prev=True))

    # -- recovery --------------------------------------------------------
    def _recover(self) -> None:
        keys_l: List[np.ndarray] = []
        rows_l: List[int] = []
        accs_l: List[tuple] = []
        ng = len(self.group_indices)
        for _pk, row in self.table.iter_rows():
            keys_l.append(self.key_codec.lanes_of_values(row[:ng]))
            rows_l.append(int(row[ng]))
            accs_l.append(row[ng + 1:])
        self._live_groups = len(rows_l)
        if not rows_l:
            return
        acc_cols = [np.asarray([0 if a[j] is None else a[j]
                                for a in accs_l], dtype=dt)
                    for j, dt in enumerate(acc_dtypes(self.specs))]
        self.kernel.rebuild(np.stack(keys_l),
                            np.asarray(rows_l, dtype=np.int64), acc_cols)

    # -- main loop -------------------------------------------------------
    async def execute(self) -> AsyncIterator[Message]:
        it = self.input.execute()
        first = await it.__anext__()
        assert is_barrier(first), f"expected init barrier, got {first!r}"
        self.table.init_epoch(first.epoch)
        self._recover()
        yield first
        async for msg in it:
            if is_chunk(msg):
                self._apply_chunk(msg)
            elif is_barrier(msg):
                out = self._flush()
                self._clean_state()
                self._maybe_gc_interner()
                self.table.commit(msg.epoch)
                if out is not None:
                    yield out
                yield msg
            elif is_watermark(msg):
                # forward only group-key watermarks, re-indexed
                if msg.col_idx in self.group_indices:
                    pos = self.group_indices.index(msg.col_idx)
                    if pos == 0 and self._cleanable_type():
                        self._clean_wm = msg.value
                    yield msg.with_idx(pos)
