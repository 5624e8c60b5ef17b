"""HashAggExecutor: streaming GROUP BY on device-resident state.

Port of ``risingwave_tpu/stream/executors/hash_agg.py`` (reference parity:
src/stream/src/executor/hash_agg.rs:67, :329 apply_chunk, :445
flush_data; value-state encoding of aggregation/agg_group.rs). The
executor is the host driver of a ``GroupedAggKernel``:

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

Host-side state beside the card's (each in its own state table, built by
``agg_aux_tables``):

- retractable MIN/MAX keeps a materialized-input value multiset per call
  (aggregation/minput.rs); at a barrier the groups that saw deletes
  recompute their extremes from it and the kernel's ``patch_accs`` (K9)
  writes them back before the snapshot advances;
- DISTINCT keeps one (group, value, count) multiset per input column
  (aggregation/distinct.rs): the kernel sees one representative row
  only when a value's multiplicity crosses zero;
- approx_count_distinct keeps a dense HLL sketch per group on the host
  (BYTEA rows), append-only;
- string_agg and array_agg compute their outputs from the multiset at
  each flush; the card carries one dummy lane for each of these kinds.

With ``tier_cap`` the agg joins the cold tier (``state/tier.py``): at a
checkpoint barrier, after flush, advance and commit, groups past the cap
are evicted from the card (B9) and their host mirrors dropped; a chunk
that touches a cold group reloads it first (B10), so a retraction meets
exact state. Only the executor's own single-device kernel evicts.

Fragment fusion (``frontend/opt/fusion.py``): with ``fused_stages`` the
executor's input is the RAW upstream, each chunk ships as one raw int64
matrix (``ops/fused.encode_raw_chunk``) and the absorbed filter/project
run becomes the kernel's prelude (``agg_prelude``, B19) ahead of K1 + K2;
watermarks derive through the absorbed stages. Aggs with host-side state
or a tier cap are not fused.

Kernel injection: ``build_q7(mesh=...)`` passes a vnode-sharded kernel
(``parallel/agg.ShardedAggKernel``) with the same host surface; the
executor runs it as it runs its own, and on the fused path hands it the
prelude on first touch and, when the group keys map to raw input columns,
per-row owners for its skew-exact routing bucket.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import AsyncIterator, Dict, List, Optional, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk, next_pow2
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.ops.hash_agg import (
    HOST_AGG_KINDS, AggKind, AggSpec, GroupedAggKernel, acc_dtypes,
    hll_estimate_dense, hll_lanes, HLL_M,
)
from risingwave_tpu_torch.ops import lanes as _lanes
from risingwave_tpu_torch.parallel.agg import ShardedAggKernel
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.executors.keys import (
    LANES_PER_KEY, KeyCodec, to_i64,
)
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
    if kind in (AggKind.COUNT, AggKind.APPROX_COUNT_DISTINCT):
        return DataType.INT64
    if kind == AggKind.STRING_AGG:
        return DataType.VARCHAR
    if kind == AggKind.ARRAY_AGG:
        return DataType.LIST
    if kind == AggKind.SUM:
        try:
            return _SUM_OUT[input_type]
        except KeyError:
            raise TypeError(f"sum over {input_type} unsupported")
    return input_type


@dataclass(frozen=True)
class AggCall:
    """Logical aggregate call (agg/mod.rs AggCall analog)."""

    kind: AggKind
    input_idx: Optional[int] = None      # None ⇒ count(*)
    # DISTINCT dedup (aggregation/distinct.rs): a per-(group, value)
    # multiset gates the device kernel so each distinct value contributes
    # once; MIN/MAX ignore it (it changes nothing for them)
    distinct: bool = False
    # string_agg separator (ignored by other kinds)
    delimiter: str = ","

    def out_type(self, input_schema: Schema) -> DataType:
        in_t = None if self.input_idx is None \
            else input_schema[self.input_idx].data_type
        return agg_result_type(self.kind, in_t)

    def spec(self, input_schema: Schema) -> AggSpec:
        if self.kind == AggKind.COUNT and self.input_idx is None:
            return AggSpec(AggKind.COUNT, None)
        in_t = input_schema[self.input_idx].data_type
        if self.kind in HOST_AGG_KINDS:
            return AggSpec(self.kind, np.dtype(object))
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


def minput_state_schema(input_schema: Schema,
                        group_indices: Sequence[int], call: AggCall
                        ) -> Tuple[Schema, List[int], List[int]]:
    """Materialized-input table of ONE call (aggregation/minput.rs, value
    multiset form): rows (group keys..., value, _cnt) with pk = (group
    keys, value), so a prefix scan over a group yields its surviving
    values. Returns (schema, pk_indices, dist_key_indices)."""
    fields = [input_schema[i] for i in group_indices]
    fields.append(Field("_value", input_schema[call.input_idx].data_type))
    fields.append(Field("_cnt", DataType.INT64))
    g = len(group_indices)
    return Schema(fields), list(range(g + 1)), list(range(g))


def hll_state_schema(input_schema: Schema,
                     group_indices: Sequence[int]
                     ) -> Tuple[Schema, List[int], List[int]]:
    """Dense-HLL sketch table of ONE approx_count_distinct call: (group
    keys..., _sketch BYTEA), one packed register file per group, upserted
    per barrier for dirty groups."""
    fields = [input_schema[i] for i in group_indices]
    fields.append(Field("_sketch", DataType.BYTEA))
    g = len(group_indices)
    return Schema(fields), list(range(g)), list(range(g))


def agg_aux_tables(input_schema: Schema,
                   group_indices: Sequence[int],
                   agg_calls: Sequence["AggCall"], append_only: bool,
                   store, dedup_table_id, minput_table_id
                   ) -> Tuple[Dict[int, StateTable],
                              Dict[int, StateTable]]:
    """The aux state tables a HashAggExecutor needs: one dedup table per
    DISTINCT input column, and per call a sketch table
    (approx_count_distinct) or a materialized-input table (retractable
    MIN/MAX, string_agg, array_agg). ``dedup_table_id(input_idx)`` and
    ``minput_table_id(call_idx)`` supply the ids; the order is the
    reference's (dedup tables first, then sketches, then multisets).
    Returns (distinct_tables, minput_tables): sketch tables travel in the
    minput dict, as in the reference."""
    distinct_tables: Dict[int, StateTable] = {}
    for c in agg_calls:
        if c.distinct and c.input_idx not in distinct_tables:
            dsch, dpk, ddk = minput_state_schema(
                input_schema, group_indices, c)
            distinct_tables[c.input_idx] = StateTable(
                dedup_table_id(c.input_idx), dsch, dpk, store,
                dist_key_indices=ddk)
    minput_tables: Dict[int, StateTable] = {}
    for j, c in enumerate(agg_calls):
        if c.kind == AggKind.APPROX_COUNT_DISTINCT:
            hsch, hpk, hdk = hll_state_schema(input_schema, group_indices)
            # sanity off: sketch rows are blind upserts (same pk, a newer
            # epoch shadows)
            minput_tables[j] = StateTable(
                minput_table_id(j), hsch, hpk, store,
                dist_key_indices=hdk, sanity_check=False)
    for j, c in enumerate(agg_calls):
        if ((c.kind in (AggKind.MIN, AggKind.MAX) and not append_only)
                or c.kind in HOST_AGG_KINDS):
            msch, mpk, mdk = minput_state_schema(
                input_schema, group_indices, c)
            minput_tables[j] = StateTable(
                minput_table_id(j), msch, mpk, store,
                dist_key_indices=mdk)
    return distinct_tables, minput_tables


def _pyval(x):
    return x.item() if hasattr(x, "item") else x


def _sort_groups(a: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Rows of an int matrix grouped as ``np.unique(a, axis=0,
    return_inverse=True)`` groups them (the same lexicographic order),
    by one lexsort: (inverse, stable order by group, group starts in
    that order, n groups)."""
    order = np.lexsort(a.T[::-1])
    srt = a[order]
    new = np.ones(len(a), dtype=bool)
    new[1:] = (srt[1:] != srt[:-1]).any(axis=1)
    gid = np.cumsum(new) - 1
    inverse = np.empty(len(a), dtype=np.int64)
    inverse[order] = gid
    return inverse, order, np.flatnonzero(new), int(gid[-1]) + 1


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
        self.input = input_
        self.group_indices = list(group_indices)
        self.agg_calls = list(agg_calls)
        self.table = table
        self.append_only = append_only
        # with fused_stages, `input_` is the RAW upstream and the absorbed
        # run's output schema is the space this agg is planned on
        self.fused_stages = fused_stages
        in_schema = input_.schema if fused_stages is None \
            else fused_stages.out_schema
        self.group_types = [in_schema[i].data_type
                            for i in self.group_indices]
        self.key_codec = KeyCodec(self.group_types)
        self.specs = [c.spec(in_schema) for c in self.agg_calls]
        # retractable MIN/MAX and the host kinds: per-call value multisets
        # (minput tables), written through once per barrier from the
        # buffered deltas (call → key → delta); groups that saw deletes
        # recompute their extremes at the flush
        self.minput: Dict[int, StateTable] = dict(minput_tables or {})
        self._deleted_lanes: set = set()
        self._minput_pending: Dict[int, Dict[tuple, int]] = {}
        # DISTINCT: one durable (group, value, cnt) table and an in-memory
        # multiplicity mirror per distinct INPUT COLUMN (count(DISTINCT x)
        # and sum(DISTINCT x) share it)
        self.distinct_tables: Dict[int, StateTable] = dict(
            distinct_tables or {})
        self._distinct_cols: Dict[int, List[int]] = {}
        for j, c in enumerate(self.agg_calls):
            if c.distinct and c.kind in (AggKind.COUNT, AggKind.SUM):
                self._distinct_cols.setdefault(c.input_idx, []).append(j)
        missing_d = [col for col in self._distinct_cols
                     if col not in self.distinct_tables]
        if missing_d:
            raise ValueError(
                f"DISTINCT column(s) {missing_d} need dedup state tables: "
                "pass distinct_tables keyed by input column "
                "(minput_state_schema shape)")
        self._distinct_mult: Dict[int, Dict[tuple, int]] = {}
        self._distinct_pending: Dict[int, Dict[tuple, int]] = {}
        self._live_groups = 0
        # approx_count_distinct: the sketch tables travel in the minput
        # dict (agg_aux_tables) and are split off here, so the multiset
        # write paths never touch them
        self._hll_calls = [j for j, sp in enumerate(self.specs)
                           if sp.kind == AggKind.APPROX_COUNT_DISTINCT]
        self.hll_tables: Dict[int, StateTable] = {
            j: self.minput.pop(j) for j in self._hll_calls
            if j in self.minput}
        missing_s = [j for j in self._hll_calls if j not in self.hll_tables]
        if missing_s:
            raise ValueError(
                "approx_count_distinct needs a sketch state table per call "
                f"({missing_s}): pass minput_tables from agg_aux_tables "
                "(hll_state_schema)")
        # per call: group tuple → uint8[HLL_M] registers; the last emitted
        # estimate; the groups dirty since the last barrier
        self._hll_regs: Dict[int, Dict[tuple, np.ndarray]] = {
            j: {} for j in self._hll_calls}
        self._hll_prev: Dict[int, Dict[tuple, int]] = {
            j: {} for j in self._hll_calls}
        self._hll_dirty: Dict[int, set] = {j: set() for j in self._hll_calls}
        self._host_calls = [j for j, sp in enumerate(self.specs)
                            if sp.kind in HOST_AGG_KINDS]
        missing_h = [j for j in self._host_calls if j not in self.minput]
        if missing_h:
            raise ValueError(
                f"{[self.specs[j].kind.value for j in missing_h]} need "
                "materialized-input state tables: pass minput_tables "
                "(see minput_state_schema)")
        if not append_only:
            need = [j for j, sp in enumerate(self.specs)
                    if sp.kind in (AggKind.MIN, AggKind.MAX)]
            missing = [j for j in need if j not in self.minput]
            if missing:
                raise ValueError(
                    "retractable min/max needs materialized-input state "
                    f"tables for call(s) {missing}: pass minput_tables "
                    "(see minput_state_schema) or append_only=True")
            if self._hll_calls:
                raise ValueError(
                    "approx_count_distinct needs an append-only upstream: "
                    "an HLL sketch cannot retract")
        kw = {"device": device}
        if kernel_capacity is not None:
            kw["capacity"] = kernel_capacity
        if flush_capacity is not None:
            kw["flush_capacity"] = flush_capacity
        # the kernel is built on first touch: the fusion rule absorbs a
        # run into a copy of this executor before any data flows. An
        # injected (sharded) kernel is used as it is.
        self._kern_kw = kw
        self._kernel = kernel
        # the cold tier: registration waits for execute(), so executors
        # that never run leave nothing in the process-global registry
        self._tier = None
        self._tier_part = None
        self._cold_groups: Dict[tuple, tuple] = {}
        self._tier_seq = 0            # barrier counter = the LRU clock
        self.tier_cap = tier_cap
        if tier_cap is not None:
            if kernel is not None:
                raise ValueError(
                    "tier_cap needs the single-device lazy kernel (a "
                    "sharded kernel has no targeted-evict path)")
            from risingwave_tpu_torch.state import tier as _tier
            self._tier = _tier.GLOBAL
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
        if fused_stages is not None:
            from risingwave_tpu_torch.frontend.opt.fusion import (
                agg_ineligible_reason,
            )
            r = agg_ineligible_reason(self)
            if r is not None:
                raise ValueError(f"agg is not fusion-eligible: {r}")

    @property
    def kernel(self):
        """The device kernel, built on first touch (raw mode when the agg
        absorbed a fused run). An injected sharded kernel gets the
        absorbed run's prelude on first touch instead."""
        if self._kernel is None:
            kw = dict(self._kern_kw)
            if self.fused_stages is not None:
                kw["prelude"] = self._compile_prelude()
            self._kernel = GroupedAggKernel(
                key_width=LANES_PER_KEY * len(self.group_indices),
                specs=self.specs, **kw)
        elif self.fused_stages is not None and \
                getattr(self._kernel, "supports_prelude", False) and \
                self._kernel._prelude is None:
            self._kernel.set_prelude(self._compile_prelude())
        return self._kernel

    def _compile_prelude(self):
        from risingwave_tpu_torch.ops.fused import MODE_AGG, compile_program
        return compile_program(self.fused_stages, MODE_AGG,
                               group_indices=self.group_indices,
                               agg_calls=self.agg_calls, specs=self.specs)

    # -- fragment fusion (frontend/opt/fusion.py adopts on a copy) --------
    def adopt_fused_stages(self, fs, raw_input: Executor) -> None:
        """Absorb a filter/project run: `raw_input` becomes the direct
        input and `fs` (whose out_schema must equal the input schema this
        executor was planned on) runs as the kernel's prelude. Only valid
        before the kernel is built, or while an injected kernel has seen
        no data (``agg_ineligible_reason``)."""
        from risingwave_tpu_torch.frontend.opt.fusion import (
            agg_fusable_reason,
        )
        r = agg_fusable_reason(self)
        if r is not None:
            raise ValueError(f"agg is not fusion-eligible: {r}")
        got = [f.data_type for f in fs.out_schema]
        want = [f.data_type for f in self.input.schema]
        if got != want:
            raise ValueError(
                f"fused stage chain emits {got}, agg planned on {want}")
        self.fused_stages = fs
        self.input = raw_input

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
        if self.fused_stages is not None:
            # the RAW chunk ships as one int64 matrix; filter, project
            # and the key/lane encode run in the kernel's prelude
            from risingwave_tpu_torch.ops.fused import encode_raw_chunk
            raw = encode_raw_chunk(chunk, self.fused_stages.ref_cols)
            if not isinstance(self.kernel, ShardedAggKernel):
                self.kernel.apply_raw(raw)
                return
            # sharded: when the group keys map to raw columns, per-row
            # owners from the host key lanes size the routing bucket
            raw_keys = self.fused_stages.input_positions(self.group_indices)
            owners = None if raw_keys is None else self.kernel.owners_of(
                self.key_codec.build(chunk, raw_keys))
            self.kernel.apply_raw(raw, chunk.cardinality(), owners=owners)
            return
        key_lanes = self.key_codec.build(chunk, self.group_indices)
        signs = np.asarray(chunk.signs())
        vis = np.asarray(chunk.visibility)
        if self._tier is not None:
            self._tier_touch(key_lanes, vis)
        inputs = list(self._inputs(chunk))
        if self.minput:
            self._apply_minput(chunk, key_lanes, signs, vis)
        for col, js in self._distinct_cols.items():
            _in_lanes0, ok0 = inputs[js[0]]
            mask = self._apply_distinct(col, chunk, key_lanes, signs,
                                        vis & ok0)
            for j in js:
                inputs[j] = (inputs[j][0], mask)
        self.kernel.apply(key_lanes, signs, vis, tuple(inputs))
        for j in self._hll_calls:
            self._apply_hll(j, chunk, key_lanes, signs, vis)

    def _group_tuple(self, g_cols, r: int) -> tuple:
        return tuple(None if (okc is not None and not okc[r])
                     else _pyval(gv[r]) for gv, okc in g_cols)

    def _chunk_group_cols(self, chunk: StreamChunk):
        return [(np.asarray(chunk.columns[i].values),
                 None if chunk.columns[i].validity is None
                 else np.asarray(chunk.columns[i].validity))
                for i in self.group_indices]

    def _apply_hll(self, j: int, chunk: StreamChunk,
                   key_lanes: np.ndarray, signs: np.ndarray,
                   vis: np.ndarray) -> None:
        """Scatter-max this chunk's rows into the per-group dense register
        files (vectorized; python work is O(groups in the chunk))."""
        call = self.agg_calls[j]
        c = chunk.columns[call.input_idx]
        ok = vis if c.validity is None else (vis & np.asarray(c.validity))
        rows = np.flatnonzero(ok)
        if not len(rows):
            return
        if (signs[rows] < 0).any():
            raise ValueError(
                "approx_count_distinct saw a retraction: the sketch is "
                "append-only (guarded at construction)")
        reg, rho = hll_lanes(to_i64(np.asarray(c.values)[rows]))
        rho8 = rho.astype(np.uint8)
        _inv, order, starts, n_uniq = _sort_groups(key_lanes[rows])
        ends = np.append(starts[1:], len(order))
        g_cols = self._chunk_group_cols(chunk)
        regs_d, dirty = self._hll_regs[j], self._hll_dirty[j]
        for u in range(n_uniq):
            gkey = self._group_tuple(g_cols, int(rows[order[starts[u]]]))
            arr = regs_d.get(gkey)
            if arr is None:
                arr = regs_d[gkey] = np.zeros(HLL_M, dtype=np.uint8)
            sel = order[starts[u]:ends[u]]
            np.maximum.at(arr, reg[sel], rho8[sel])
            dirty.add(gkey)

    # -- per-(group, value) multisets (minput + distinct) ----------------
    def _multiset_groups(self, chunk: StreamChunk, key_lanes: np.ndarray,
                         signs: np.ndarray, ok: np.ndarray,
                         input_idx: int, vals_override=None):
        """Vectorized grouping of the ok rows by (group key, value).
        Returns (rows, inverse, n_uniq, deltas, key_tuple_fn, order,
        starts); python work is O(distinct keys), not O(rows)."""
        rows = np.flatnonzero(ok)
        if not len(rows):
            return None
        c = chunk.columns[input_idx]
        vals = vals_override if vals_override is not None \
            else np.asarray(c.values)
        comp = np.empty((len(rows), key_lanes.shape[1] + 1), dtype=np.int64)
        comp[:, :key_lanes.shape[1]] = key_lanes[rows]
        if vals.dtype == object:
            # host-typed values: exact interning local to this call (ids
            # live for this call alone, so nothing accumulates)
            local: Dict[object, int] = {}
            comp[:, -1] = np.fromiter(
                (local.setdefault(v, len(local))
                 for v in vals[rows].tolist()),
                dtype=np.int64, count=len(rows))
        else:
            comp[:, -1] = to_i64(vals[rows])
        inverse, order, starts, n_uniq = _sort_groups(comp)
        deltas = np.zeros(n_uniq, dtype=np.int64)
        np.add.at(deltas, inverse, signs[rows])
        first_rows = rows[order[starts]]
        g_cols = self._chunk_group_cols(chunk)

        def key_tuple(u: int) -> tuple:
            r = int(first_rows[u])
            return self._group_tuple(g_cols, r) + (_pyval(vals[r]),)

        return rows, inverse, n_uniq, deltas, key_tuple, order, starts

    def _apply_minput(self, chunk: StreamChunk, key_lanes: np.ndarray,
                      signs: np.ndarray, vis: np.ndarray) -> None:
        """Maintain the per-call value multisets; remember which groups
        saw deletes (only those can have stale device extremes)."""
        del_rows = np.flatnonzero(vis & (signs < 0))
        if len(del_rows):
            self._deleted_lanes.update(
                map(tuple, key_lanes[del_rows].tolist()))
        for j in self.minput:
            call = self.agg_calls[j]
            c = chunk.columns[call.input_idx]
            vals_override = None
            if call.kind == AggKind.ARRAY_AGG:
                # array_agg keeps NULL elements (string_agg and MIN/MAX
                # skip them); a device-typed column needs an object view
                # so NULL slots carry None instead of buffer fill
                ok = vis
                if c.validity is not None and c.data_type.is_device:
                    vo = np.asarray(c.values).astype(object)
                    vo[~np.asarray(c.validity)] = None
                    vals_override = vo
            else:
                ok = vis if c.validity is None \
                    else vis & np.asarray(c.validity)
            ms = self._multiset_groups(chunk, key_lanes, signs, ok,
                                       call.input_idx,
                                       vals_override=vals_override)
            if ms is None:
                continue
            _rows, _inv, _n, deltas, key_tuple, _o, _s = ms
            pend = self._minput_pending.setdefault(j, {})
            for u in np.flatnonzero(deltas != 0).tolist():
                key = key_tuple(u)
                pend[key] = pend.get(key, 0) + int(deltas[u])

    def _apply_distinct(self, col: int, chunk: StreamChunk,
                        key_lanes: np.ndarray, signs: np.ndarray,
                        ok: np.ndarray) -> np.ndarray:
        """DISTINCT gating (aggregation/distinct.rs): the kernel sees ONE
        representative row of a (group, value) only when its multiplicity
        crosses zero, with the sign of the crossing. Returns the call's
        new valid mask."""
        new_ok = np.zeros(chunk.capacity, dtype=bool)
        ms = self._multiset_groups(chunk, key_lanes, signs, ok, col)
        if ms is None:
            return new_ok
        rows, inverse, n_uniq, deltas, key_tuple, order, starts = ms
        mult = self._distinct_mult.setdefault(col, {})
        pend = self._distinct_pending.setdefault(col, {})
        srt_len = len(inverse)
        for u in np.flatnonzero(deltas != 0).tolist():
            d = int(deltas[u])
            key = key_tuple(u)
            old = mult.get(key, 0)
            new = old + d
            if new < 0:
                raise ValueError(f"distinct retract below zero for {key}")
            if new == 0:
                del mult[key]
            else:
                mult[key] = new
            pend[key] = pend.get(key, 0) + d
            eff = (1 if new > 0 else 0) - (1 if old > 0 else 0)
            if eff == 0:
                continue
            # a representative row with the matching sign exists: the
            # net delta moved that way
            lo = int(starts[u])
            hi = int(starts[u + 1]) if u + 1 < n_uniq else srt_len
            cand = rows[order[lo:hi]]
            match = cand[signs[cand] == eff]
            new_ok[int(match[0])] = True
        return new_ok

    @staticmethod
    def _write_multiset_pending(pending: Dict[int, Dict[tuple, int]],
                                tables: Dict[int, StateTable]) -> None:
        """Write buffered multiset deltas through to the StateTables once
        per barrier (the recompute then reads them): one bulk read of the
        keys' current counts, then bulk inserts, updates and deletes (the
        keys of one table are distinct, so the order between them does
        not matter)."""
        for j, deltas in pending.items():
            table = tables[j]
            items = [(key, d) for key, d in deltas.items() if d != 0]
            cur_rows = table.get_rows([key + (0,) for key, _d in items])
            ins, dels, old, new = [], [], [], []
            for (key, d), cur in zip(items, cur_rows):
                cnt = (0 if cur is None else cur[-1]) + d
                row = key + (cnt,)
                if cur is None:
                    assert cnt > 0, f"retract of unseen value {key}"
                    ins.append(row)
                elif cnt == 0:
                    dels.append(cur)
                else:
                    old.append(cur)
                    new.append(row)
            table.insert_rows(ins)
            table.update_rows(old, new)
            table.delete_rows(dels)
        pending.clear()

    # -- cold tier (state/tier.py) ---------------------------------------
    def _tier_register(self) -> None:
        """Register with the tier at execute() start."""
        import weakref
        tref = weakref.ref(self)

        def _evict_cb(keys):
            s = tref()
            return 0 if s is None else s._tier_evict(keys)

        self._tier_part = self._tier.register(
            f"{self.identity}#{id(self)}", _evict_cb, cap=int(self.tier_cap))

    def _tier_touch(self, key_lanes: np.ndarray, vis: np.ndarray) -> None:
        """LRU recency and reload-on-touch: the chunk's distinct group keys
        refresh the tier clock, and any that are cold reload from their
        committed state rows before this chunk's apply."""
        rows = np.flatnonzero(vis)
        if not len(rows):
            return
        lanes_ = key_lanes[rows]
        _inv, order, starts, _n = _sort_groups(lanes_)
        tuples = list(map(tuple, lanes_[order[starts]].tolist()))
        self._tier.touch(self._tier_part, tuples, self._tier_seq)
        if self._cold_groups:
            need = [t for t in tuples if t in self._cold_groups]
            if need:
                self._reload_groups(need)

    def _reload_groups(self, lanes_ts: List[tuple]) -> None:
        """Reload evicted groups: device state from the value-state row
        (``load_groups``: K1 + K9), distinct multisets and HLL registers
        from their aux tables. A retraction against a cold group reloads
        first and then meets exact state."""
        ng = len(self.group_indices)
        rows: List[tuple] = []
        lanes_keep: List[tuple] = []
        groups: List[tuple] = []
        cold = [self._cold_groups.pop(lt) for lt in lanes_ts]
        for lt, vt, row in zip(lanes_ts, cold, self.table.get_rows(cold)):
            if row is None:
                continue       # retired under a watermark while cold
            rows.append(row)
            lanes_keep.append(lt)
            groups.append(vt)
        if not rows:
            return
        keys = np.asarray(lanes_keep, dtype=np.int32)
        grows = np.asarray([int(r[ng]) for r in rows], dtype=np.int64)
        acc_cols = [
            np.asarray([0 if r[ng + 1 + j] is None else r[ng + 1 + j]
                        for r in rows], dtype=dt)
            for j, dt in enumerate(acc_dtypes(self.specs))]
        self.kernel.load_groups(keys, grows, acc_cols)
        for col, t in self.distinct_tables.items():
            mult = self._distinct_mult.setdefault(col, {})
            for vt in groups:
                for _pk, row in t.iter_prefix(list(vt)):
                    mult[tuple(row[:-1])] = int(row[-1])
        for j, t in self.hll_tables.items():
            for vt in groups:
                row = t.get_row(vt)
                if row is not None:
                    arr = np.frombuffer(row[-1], dtype=np.uint8).copy()
                    self._hll_regs[j][vt] = arr
                    self._hll_prev[j][vt] = int(hll_estimate_dense(arr)[0])
        self._tier.note_reload(self._tier_part, len(rows))

    def _tier_evict(self, lanes_ts: List[tuple]) -> int:
        """The tier's sweep callback (checkpoint barriers only, after the
        flush): device slots rebuild away (``evict_keys``: K8 + K4 + K1),
        host mirrors drop, durable rows stay. Groups with no durable row
        (retracted to zero, watermark-cleaned) are phantoms: skipped, not
        marked cold, not counted."""
        mat = np.asarray(lanes_ts, dtype=np.int32)
        gk = self.key_codec.decode(mat)
        groups = [tuple(None if not ok[r] else _pyval(vals[r])
                        for vals, ok in gk) for r in range(len(lanes_ts))]
        kept_lanes: List[tuple] = []
        kept_groups: List[tuple] = []
        for lt, vt, row in zip(lanes_ts, groups, self.table.get_rows(groups)):
            if row is None:
                continue
            kept_lanes.append(lt)
            kept_groups.append(vt)
        if not kept_lanes:
            return 0
        self.kernel.evict_keys(np.asarray(kept_lanes, dtype=np.int32))
        for lt, vt in zip(kept_lanes, kept_groups):
            self._cold_groups[lt] = vt
        gset = set(kept_groups)
        ng = len(self.group_indices)
        for col, mult in self._distinct_mult.items():
            if mult:
                self._distinct_mult[col] = {
                    k: v for k, v in mult.items() if k[:ng] not in gset}
        for j in self._hll_calls:
            self._hll_regs[j] = {k: v for k, v in self._hll_regs[j].items()
                                 if k not in gset}
            self._hll_prev[j] = {k: v for k, v in self._hll_prev[j].items()
                                 if k not in gset}
        self._deleted_lanes -= set(kept_lanes)
        return len(kept_lanes)

    def _tier_forget_expired(self, phys: int) -> None:
        """Watermark cleaning retired the groups below `phys`: drop their
        cold markers (rows already range-deleted) and their resident tier
        entries (retired on the card by retire_below)."""
        if self._cold_groups:
            self._cold_groups = {
                lt: vt for lt, vt in self._cold_groups.items()
                if vt[0] is None or vt[0] >= phys}
        part = self._tier_part
        if part is None or not part.keys:
            return
        keys_list = list(part.keys)
        mat = np.asarray(keys_list, dtype=np.int64)
        ok = mat[:, 2] != 0
        v = _lanes.merge_i64(mat[:, 0].astype(np.int32),
                             mat[:, 1].astype(np.int32))
        dead = ok & (v < phys)
        if dead.any():
            self._tier.forget(part, [
                k for k, d in zip(keys_list, dead.tolist()) if d])

    # -- watermark state cleaning ----------------------------------------
    def _cleanable_type(self) -> bool:
        """Integer-family first group col only: the device compare runs
        on the (hi, lo) i64 split, order-preserving for ints/timestamps
        but not for bit-cast floats."""
        dt = np.dtype(self.group_types[0].np_dtype)
        return np.issubdtype(dt, np.integer) or dt == np.dtype(bool)

    def _clean_state(self) -> None:
        """Retire groups below the watermark: device rebuild + ordered
        range delete from every state table. Runs after flush/advance."""
        wm = self._clean_wm
        if wm is None or (self._cleaned_wm is not None
                          and wm <= self._cleaned_wm):
            return
        phys = int(wm)
        self.kernel.retire_below(0, phys)
        n = self.table.delete_below_prefix(phys)
        self._live_groups = max(0, self._live_groups - n)
        for t in self.minput.values():
            t.delete_below_prefix(phys)
        for col, t in self.distinct_tables.items():
            t.delete_below_prefix(phys)
            mult = self._distinct_mult.get(col)
            if mult:
                self._distinct_mult[col] = {
                    k: v for k, v in mult.items()
                    if k[0] is None or k[0] >= phys}
        for j, t in self.hll_tables.items():
            t.delete_below_prefix(phys)
            self._hll_regs[j] = {
                k: v for k, v in self._hll_regs[j].items()
                if k[0] is None or k[0] >= phys}
            self._hll_prev[j] = {
                k: v for k, v in self._hll_prev[j].items()
                if k[0] is None or k[0] >= phys}
        if self._tier is not None:
            self._tier_forget_expired(phys)
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
        if self.fused_stages is not None:
            counts = self.kernel.drain_stage_counts()
            self.fused_stages.note_stage_rows(
                self.fused_stages.stage_rows_of(counts), 0)
        gk = None
        host_prev = None
        if self._host_calls and fr.n:
            # the host kinds' PREV outputs come from the multiset tables
            # as of the last barrier: read them before this epoch's writes
            gk = self.key_codec.decode(fr.keys)
            host_prev = self._host_agg_outputs(fr, gk)
        if self.minput:
            self._write_multiset_pending(self._minput_pending, self.minput)
        if self._distinct_pending:
            self._write_multiset_pending(self._distinct_pending,
                                         self.distinct_tables)
        if fr.n == 0:
            self._deleted_lanes.clear()
            self.kernel.advance()
            return None
        if gk is None:
            gk = self.key_codec.decode(fr.keys)
        if self.minput and self._deleted_lanes:
            self._recompute_extremes(fr, gk)
        if self._host_calls:
            host_new = self._host_agg_outputs(fr, gk)
            for j in self._host_calls:
                fr.prev_outs[j], fr.prev_nulls[j] = host_prev[j]
                fr.outs[j], fr.nulls[j] = host_new[j]
        if self._hll_calls:
            self._overwrite_hll_outputs(fr, gk)
            self._persist_hll_dirty()
        self._deleted_lanes.clear()
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

    @staticmethod
    def _flushed_groups(fr, gk) -> List[tuple]:
        """The flushed groups as python tuples (interned keys decode to
        plain strings)."""
        return [tuple(None if not ok[r] else _pyval(vals[r])
                      for vals, ok in gk) for r in range(fr.n)]

    def _overwrite_hll_outputs(self, fr, gk) -> None:
        """Replace the placeholder approx outputs with the sketches'
        estimates (and the previous estimates for update pairs)."""
        gkeys = self._flushed_groups(fr, gk)
        for j in self._hll_calls:
            regs_d, prev_d = self._hll_regs[j], self._hll_prev[j]
            dirty = self._hll_dirty[j]
            # estimate only dirty sketches (64 KiB each); clean groups
            # reuse the cached value
            fresh = [g for g in dict.fromkeys(gkeys) if g in dirty]
            ests = {}
            if fresh:
                mat = np.stack([regs_d[g] for g in fresh])
                for g, e in zip(fresh, hll_estimate_dense(mat).tolist()):
                    ests[g] = int(e)
            for r, g in enumerate(gkeys):
                prev = prev_d.get(g)
                new = ests.get(g)
                if new is None:
                    new = prev if prev is not None else 0
                fr.outs[j][r] = new
                fr.nulls[j][r] = False
                fr.prev_outs[j][r] = 0 if prev is None else prev
                fr.prev_nulls[j][r] = prev is None
                prev_d[g] = new

    def _persist_hll_dirty(self) -> None:
        """Upsert dirty register files (one BYTEA row per group; the
        sketch table is sanity-off, so a same-pk rewrite shadows)."""
        for j in self._hll_calls:
            table, regs_d = self.hll_tables[j], self._hll_regs[j]
            for gkey in self._hll_dirty[j]:
                table.insert(gkey + (regs_d[gkey].tobytes(),))
            self._hll_dirty[j].clear()

    def _recompute_extremes(self, fr, gk) -> None:
        """Correct stale device MIN/MAX of the groups that saw deletes
        from their surviving value multisets, then patch the device
        accumulators (``kernel.patch_accs``: K9) before the advance."""
        need = [r for r in range(fr.n)
                if tuple(fr.keys[r].tolist()) in self._deleted_lanes]
        if not need:
            return
        for r in need:
            group = tuple(None if not ok[r] else _pyval(vals[r])
                          for vals, ok in gk)
            for j, table in self.minput.items():
                if self.specs[j].kind in HOST_AGG_KINDS:
                    continue       # host outputs recompute separately
                is_max = self.specs[j].kind == AggKind.MAX
                best = None
                for _pk, row in table.iter_prefix(group):
                    v = row[-2]
                    if best is None or (v > best if is_max else v < best):
                        best = v
                nn = fr.nns[j][r]
                if nn == 0 or best is None:
                    fr.nulls[j][r] = True
                    fr.nns[j][r] = 0
                else:
                    fr.outs[j][r] = best
                    fr.nulls[j][r] = False
        decoded = [
            (fr.outs[j], fr.nns[j])
            if j in self.minput and self.specs[j].kind not in HOST_AGG_KINDS
            else None for j in range(len(self.specs))]
        self.kernel.patch_accs(decoded, raw_accs=fr.raw_accs)

    def _host_agg_outputs(self, fr, gk):
        """string_agg/array_agg outputs of the flushed groups from their
        value multisets, composed in VALUE order (the multiset keeps no
        arrival order; value order is deterministic and recovery-stable)."""
        out: Dict[int, tuple] = {}
        groups = self._flushed_groups(fr, gk)
        for j in self._host_calls:
            call = self.agg_calls[j]
            table = self.minput[j]
            vals_col = np.empty(fr.n, dtype=object)
            nulls_col = np.zeros(fr.n, dtype=bool)
            for r, group in enumerate(groups):
                items: List = []
                for _pk, row in table.iter_prefix(group):
                    v, cnt = row[-2], int(row[-1])
                    items.extend([v] * cnt)
                if not items:
                    nulls_col[r] = True
                elif call.kind == AggKind.STRING_AGG:
                    vals_col[r] = call.delimiter.join(
                        str(v) for v in items if v is not None)
                else:                # array_agg keeps NULL elements
                    vals_col[r] = tuple(items)
            out[j] = (vals_col, nulls_col)
        return out

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
        """Reload the value-state rows into the kernel (every group comes
        back resident: cold markers do not survive a restart)."""
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
        if self._tier is not None:
            # seeding the tier clock with the recovered keys lets the
            # first checkpoint sweep re-apply the cap
            self._tier.touch(self._tier_part,
                             [tuple(k.tolist()) for k in keys_l],
                             self._tier_seq)
        acc_cols = [np.asarray([0 if a[j] is None else a[j]
                                for a in accs_l], dtype=dt)
                    for j, dt in enumerate(acc_dtypes(self.specs))]
        self.kernel.rebuild(np.stack(keys_l),
                            np.asarray(rows_l, dtype=np.int64), acc_cols)

    def _init_aux(self, epoch) -> None:
        """Open the aux tables' epoch and reload their host mirrors: the
        sketches (with their committed estimates) and the distinct
        multisets."""
        for t in self.minput.values():
            t.init_epoch(epoch)
        for j, t in self.hll_tables.items():
            t.init_epoch(epoch)
            for _pk, row in t.iter_rows():
                gkey = tuple(row[:-1])
                arr = np.frombuffer(row[-1], dtype=np.uint8).copy()
                self._hll_regs[j][gkey] = arr
                # emitted outputs were committed with this sketch: the
                # previous estimates must match them exactly
                self._hll_prev[j][gkey] = int(hll_estimate_dense(arr)[0])
        for col, t in self.distinct_tables.items():
            t.init_epoch(epoch)
            mult = {tuple(row[:-1]): int(row[-1])
                    for _pk, row in t.iter_rows()}
            if mult:
                self._distinct_mult[col] = mult

    def _aux_tables(self) -> List[StateTable]:
        return [*self.minput.values(), *self.hll_tables.values(),
                *self.distinct_tables.values()]

    # -- main loop -------------------------------------------------------
    async def execute(self) -> AsyncIterator[Message]:
        it = self.input.execute()
        first = await it.__anext__()
        assert is_barrier(first), f"expected init barrier, got {first!r}"
        if self._tier is not None:
            self._tier_register()
        self.table.init_epoch(first.epoch)
        self._init_aux(first.epoch)
        self._recover()
        yield first
        try:
            async for msg in it:
                if is_chunk(msg):
                    self._apply_chunk(msg)
                elif is_barrier(msg):
                    out = self._flush()
                    self._clean_state()
                    self._maybe_gc_interner()
                    self.table.commit(msg.epoch)
                    for t in self._aux_tables():
                        t.commit(msg.epoch)
                    if self._tier is not None:
                        # sweep at checkpoint barriers only, after flush,
                        # advance and commit: the evicted groups are clean
                        # and durable, and no epoch is in flight
                        self._tier_seq += 1
                        if msg.kind.is_checkpoint:
                            self._tier.sweep(self._tier_part,
                                             self._tier_seq)
                    if out is not None:
                        yield out
                    yield msg
                elif is_watermark(msg):
                    # a fused agg first maps the watermark through the
                    # absorbed projects' derivations
                    wms = [msg] if self.fused_stages is None \
                        else self.fused_stages.derive_watermarks(msg)
                    # forward only group-key watermarks, re-indexed
                    for m in wms:
                        if m.col_idx in self.group_indices:
                            pos = self.group_indices.index(m.col_idx)
                            if pos == 0 and self._cleanable_type():
                                self._clean_wm = m.value
                            yield m.with_idx(pos)
        finally:
            if self._tier_part is not None:
                self._tier.unregister(self._tier_part)
