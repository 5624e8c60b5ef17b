"""Fragment fusion: composed filter/project runs as one device pass.

Port of ``risingwave_tpu/ops/fused.py``. A maximal filter/project run
(``frontend/opt/fusion.py`` marks them) is composed onto its ONE input
schema (``FusedStages``: every predicate and output expression
substituted back to input space), and then runs on the card in one pass
instead of one host pass per executor per chunk:

- ``traceable_reason``: the eligibility walker (the reference's, bit for
  bit): host comparisons, host functions and casts to DECIMAL refuse.
- the raw codec (``encode_raw_chunk``): one int64[N, 2 + 2r] matrix per
  chunk — [ops, vis] then (value, valid) per referenced column, f64 as
  bits and f32 widened to f64 — is the ONE upload of a fused path.
- ``FusedStages``: the composed normal form, its numpy ``chain_body``
  (the host half the join's fused sides run for visibility), runtime
  columns (row ids, watermark thresholds), barrier work and watermark
  derivation.
- the expression compiler (``compile_program``): a FusedStages becomes a
  flat int64 program at plan time — a column table, one postfix
  sub-program per predicate and per output column with typed opcodes,
  and an encode section per entry point. ``csrc/fused.cu`` interprets
  it with one thread per row; ``run_program_plain`` interprets the same
  words opcode by opcode as vectorized torch ops over all rows (the CPU
  path, and the card's yardstick).

Three kernel entry points, one program format (the reference's three
jitted functions):

    fused_chain   (B18, build_chain_step :839)   chunk → projected
                  columns + validity, vis, ops, stage row counts
    agg_prelude   (B19, build_agg_prelude :877)  raw → the packed
                  int32 matrix of ops/hash_agg.pack_chunk (key lanes,
                  sign, vis, per-call input lanes), K1 + K2 then run on it
    join_prelude  (B20, build_join_prelude :930) raw → [key lanes |
                  payload lanes] int32, the upload K1/K5/K6 consume

Semantics follow the reference's traced (XLA) path: / and % floor-based
as numpy and jnp compute them, a zero divisor gives NULL, float→int
casts saturate and send NaN to 0 (the numpy interpretive path gives
INT_MIN there, as the reference's does), and a float division by a
constant is a multiplication by the constant's reciprocal (XLA's
algebraic simplifier rewrites it so; DECIMAL → float divides by the
constant 10^4). Integer arithmetic wraps at the column's width as numpy
defines it: where XLA's compiler exploits signed overflow (a wrapped
product feeding a division) the port keeps numpy's wrapped value. Each wrapper launches its kernel on a CUDA tensor
and counts the launch in ``LAUNCHES``; on a CPU tensor it runs the plain
version.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk
from risingwave_tpu_torch.common.types import (
    DECIMAL_SCALE, DataType, Field, Schema,
)
from risingwave_tpu_torch.ops import cuda
from risingwave_tpu_torch.utils.device import LAUNCHES

# FuncCalls with a compiled opcode (and, in the reference, an xp-generic
# implementation)
TRACEABLE_FUNCS = frozenset({"tumble_start", "tumble_end",
                             "extract_epoch"})


# -- eligibility walker ----------------------------------------------------


def traceable_reason(e, schema: Schema) -> Optional[str]:
    """None if `e` runs on the card bit-identically against `schema`;
    otherwise a human-readable refusal."""
    from risingwave_tpu_torch.expr.expr import (
        BinaryOp, Case, Cast, FuncCall, InputRef, Literal, UnaryOp,
    )
    if isinstance(e, InputRef):
        if not e.return_type.is_device:
            return f"host-typed column ref ${e.index}:{e.return_type.value}"
        return None
    if isinstance(e, Literal):
        return None
    if isinstance(e, BinaryOp):
        if not e._common.is_device:
            return (f"operator {e.op!r} over host type "
                    f"{e._common.value}")
        for side in (e.left, e.right):
            # implicit float→DECIMAL promotion carries overflow
            # DETECTION on the host path; int→DECIMAL wraps identically
            if (e._common == DataType.DECIMAL
                    and side.return_type in (DataType.FLOAT32,
                                             DataType.FLOAT64)):
                return "float->DECIMAL promotion (overflow detection)"
            r = traceable_reason(side, schema)
            if r:
                return r
        return None
    if isinstance(e, UnaryOp):
        return traceable_reason(e.child, schema)
    if isinstance(e, Cast):
        if not e.return_type.is_device:
            return f"cast to host type {e.return_type.value}"
        src = e.child.return_type
        if not src.is_device:
            return f"cast from host type {src.value}"
        if e.return_type == DataType.DECIMAL and src != DataType.DECIMAL:
            return "cast to DECIMAL (overflow detection is host-only)"
        return traceable_reason(e.child, schema)
    if isinstance(e, Case):
        if not e.return_type.is_device:
            return f"CASE over host type {e.return_type.value}"
        for c, v in e.whens:
            r = traceable_reason(c, schema) or traceable_reason(v, schema)
            if r:
                return r
        return traceable_reason(e.else_, schema)
    if isinstance(e, FuncCall):
        if e.name not in TRACEABLE_FUNCS:
            return f"function {e.name}() has no traceable kernel"
        for a in e.args:
            if isinstance(a, Literal):
                continue            # constant args evaluate host-side
            r = traceable_reason(a, schema)
            if r:
                return r
        return None
    return f"unknown expression node {type(e).__name__}"


# -- raw-chunk codec (the ONE upload of a fused path) ----------------------
# Layout (int64 columns): [ops, vis] then (value, valid) per referenced
# input column. f64 travels bitcast; f32 widens exactly through f64.

RAW_META_COLS = 2


def raw_width(n_ref_cols: int) -> int:
    return RAW_META_COLS + 2 * n_ref_cols


def encode_raw_chunk(chunk: StreamChunk,
                     ref_cols: Sequence[int]) -> np.ndarray:
    """Host side: one int64[N, W] matrix for the referenced columns."""
    n = chunk.capacity
    m = np.zeros((n, raw_width(len(ref_cols))), dtype=np.int64)
    m[:, 0] = np.asarray(chunk.ops)
    m[:, 1] = np.asarray(chunk.visibility)
    for k, i in enumerate(ref_cols):
        c = chunk.columns[i]
        vals = np.asarray(c.values)
        if vals.dtype == np.float64:
            v = vals.view(np.int64)
        elif vals.dtype == np.float32:
            v = vals.astype(np.float64).view(np.int64)
        else:
            v = vals.astype(np.int64)
        m[:, RAW_META_COLS + 2 * k] = v
        m[:, RAW_META_COLS + 2 * k + 1] = (
            1 if c.validity is None
            else np.asarray(c.validity).astype(np.int64))
    return m


def decode_words(v64: np.ndarray, dt: DataType) -> np.ndarray:
    """int64 codec words (raw-matrix layout) → values of `dt`."""
    d = np.dtype(dt.np_dtype)
    if d == np.float64:
        return v64.view(np.float64)
    if d == np.float32:
        return v64.view(np.float64).astype(np.float32)
    return v64.astype(d)


# -- composed stage normal form --------------------------------------------


@dataclass(frozen=True)
class FusedStage:
    """One logical executor inside a fused block."""

    kind: str    # "filter" | "project" | "row_id_gen"
    #            # | "watermark_filter" | "hop_window"
    identity: str                  # e.g. "FilterExecutor"
    # filter: the ORIGINAL predicate (own column space); project: the
    # original exprs/names
    exprs: tuple = ()
    names: tuple = ()
    watermark_derivations: dict = field(default_factory=dict)
    # watermark_filter: event-time column + delay; row_id_gen /
    # watermark_filter runtime state (the id counter, the watermark
    # executor) is carried by `runtime`, a host-only handle; hop_window:
    # time_col + slide/size
    time_col: int = -1
    delay_usecs: int = 0
    slide_usecs: int = 0
    size_usecs: int = 0
    runtime: object = None

    @property
    def units(self) -> int:
        return self.size_usecs // self.slide_usecs


class FusedStages:
    """A maximal fusable filter/project run in composed normal form.

    ``stages`` is the run in dataflow order. Construction composes
    everything onto ``in_schema``: ``preds`` (each substituted back to
    input space) and ``out_exprs`` / ``out_schema`` (the final
    projection; None means the run is filter-only). Predicate
    conjunction commutes, a pair whose halves diverge under ANY
    predicate degrades as sequential filters would, and the noop-update
    drop after the FINAL projection drops exactly the pairs the
    per-stage drops would have.
    """

    def __init__(self, in_schema: Schema, stages: Sequence[FusedStage]):
        from risingwave_tpu_torch.expr.expr import InputRef
        from risingwave_tpu_torch.frontend.opt.rules import subst_expr
        self.in_schema = in_schema
        self.stages = list(stages)
        if not self.stages:
            raise ValueError("FusedStages needs at least one stage")
        # synthetic RUNTIME columns appended past the real input: each
        # row_id_gen stage contributes its per-chunk id column, each
        # watermark_filter its scalar threshold broadcast per row
        self.syn_specs: List[tuple] = []     # ("row_id"|"wm", stage_i)
        syn_fields: List[Field] = []
        n_in = len(in_schema)
        self.row_id_stages: List[tuple] = []   # (stage_i, ext col)
        self.wm_stages: List[tuple] = []       # (stage_i, ext col)
        # a head-of-run hop stage replicates every row `units`x on the
        # card and synthesizes window_start/window_end columns; the raw
        # upload keeps the PRE-hop arity
        self.hop: Optional[FusedStage] = None
        base_fields = list(in_schema.fields)
        if self.stages[0].kind == "hop_window":
            self.hop = self.stages[0]
            base_fields = base_fields + [
                Field("window_start", DataType.TIMESTAMP),
                Field("window_end", DataType.TIMESTAMP)]
        if any(st.kind == "hop_window" for st in self.stages[1:]):
            raise ValueError("hop_window stage must head the run")
        base_schema = Schema(base_fields) if self.hop is not None \
            else in_schema
        self._base_schema = base_schema
        cur: Optional[list] = None          # None = identity projection
        preds: List[object] = []
        pred_stage: List[int] = []          # stage index per pred
        names = [f.name for f in base_schema]
        for si, st in enumerate(self.stages):
            if st.kind == "hop_window":
                continue
            if st.kind == "filter":
                (p,) = st.exprs
                preds.append(p if cur is None else subst_expr(p, cur))
                pred_stage.append(si)
            elif st.kind == "project":
                cur = [e if cur is None else subst_expr(e, cur)
                       for e in st.exprs]
                names = list(st.names)
            elif st.kind == "row_id_gen":
                syn = n_in + len(syn_fields)
                syn_fields.append(Field("_row_id", DataType.SERIAL))
                self.syn_specs.append(("row_id", si))
                self.row_id_stages.append((si, syn))
                if cur is None:
                    cur = [InputRef(i, f.data_type)
                           for i, f in enumerate(in_schema)]
                cur = cur + [InputRef(syn, DataType.SERIAL)]
                names = names + ["_row_id"]
            elif st.kind == "watermark_filter":
                dt_t = in_schema[st.time_col].data_type
                syn = n_in + len(syn_fields)
                syn_fields.append(Field(f"_wm_thr{si}", dt_t))
                self.syn_specs.append(("wm", si))
                self.wm_stages.append((si, syn))
            else:
                raise ValueError(f"unknown stage kind {st.kind!r}")
        self.ext_schema = Schema(list(in_schema.fields)
                                 + syn_fields) if syn_fields \
            else in_schema
        # the space the composed preds/exprs bind against
        self.body_schema = base_schema if self.hop is not None \
            else self.ext_schema
        self.preds = preds
        self._pred_stage = pred_stage
        self.out_exprs = cur
        if cur is None:
            self.out_schema = base_schema
        else:
            self.out_schema = Schema([
                Field(n, e.return_type) for n, e in zip(names, cur)])
        from risingwave_tpu_torch.frontend.opt.checker import expr_refs
        refs: set = set()
        for p in self.preds:
            refs |= expr_refs(p)
        for e in (self.out_exprs or []):
            refs |= expr_refs(e)
        for si, syn in self.wm_stages:
            refs.add(self.stages[si].time_col)
            refs.add(syn)
        for _si, syn in self.row_id_stages:
            refs.add(syn)
        # host passthrough outputs: bare InputRefs to host-typed input
        # columns ride AROUND the device pass (vis/ops are positional)
        self.host_out: Dict[int, int] = {}
        if self.out_exprs is None:
            for i, f in enumerate(base_schema):
                if i >= n_in:
                    continue      # hop window cols: synthesized on card
                if f.data_type.is_device:
                    refs.add(i)
                else:
                    self.host_out[i] = i
        else:
            for j, e in enumerate(self.out_exprs):
                if isinstance(e, InputRef) and not e.return_type.is_device:
                    self.host_out[j] = e.index
        if self.hop is not None:
            refs = {self.hop.time_col if i >= n_in else i
                    for i in refs}
            refs.add(self.hop.time_col)
        self.ref_cols: List[int] = sorted(
            i for i in refs if self.ext_schema[i].data_type.is_device)
        self.stage_rows = np.zeros(len(self.stages), dtype=np.int64)
        self.stage_chunks = np.zeros(len(self.stages), dtype=np.int64)

    # -- eligibility -------------------------------------------------------
    def fusable_reason(self) -> Optional[str]:
        """None iff the composed run runs on the card; else the first
        refusal (the reference's rule, then what the expression
        compiler cannot express)."""
        if self.hop is not None:
            if self.wm_stages or self.row_id_stages:
                return ("hop_window cannot share a run with absorbed "
                        "runtime stages")
            for st in self.stages[1:]:
                if st.kind == "hop_window":
                    return "more than one hop_window stage in the run"
            dt_t = self.in_schema[self.hop.time_col].data_type
            if not dt_t.is_device or \
                    np.dtype(dt_t.np_dtype).kind not in "iu":
                return ("hop_window over non-integer time column "
                        f"{dt_t.value}")
        if len(self.wm_stages) > 1:
            return "more than one watermark_filter stage in the run"
        for si, _syn in self.wm_stages:
            if si != 0:
                return ("watermark_filter stage not at the head of "
                        "the run (its late mask must see raw rows)")
            st = self.stages[si]
            dt_t = self.in_schema[st.time_col].data_type
            if not dt_t.is_device or \
                    np.dtype(dt_t.np_dtype).kind not in "iu":
                return ("watermark_filter over non-integer time "
                        f"column {dt_t.value}")
        for p in self.preds:
            r = traceable_reason(p, self.body_schema)
            if r:
                return r
        for j, e in enumerate(self.out_exprs or []):
            if j in self.host_out:
                continue
            r = traceable_reason(e, self.body_schema)
            if r:
                return r
        return compile_reason(self)

    # -- synthetic runtime columns (host side, per chunk) ------------------
    def augment(self, chunk: StreamChunk) -> StreamChunk:
        """Chunk over in_schema → chunk over ext_schema: append each
        row_id_gen stage's id column (base + arange, every slot) and each
        watermark_filter's threshold column (the watermark EMITTED before
        this chunk; the time column dtype's minimum = no watermark yet).
        Advances the absorbed executors' runtime state as their own chunk
        loops would have."""
        if not self.syn_specs:
            return chunk
        cap = chunk.capacity
        cols = list(chunk.columns)
        for kind, si in self.syn_specs:
            rt = self.stages[si].runtime
            if kind == "row_id":
                cols.append(Column(
                    DataType.SERIAL,
                    rt._next + np.arange(cap, dtype=np.int64)))
                rt._next += cap
            else:
                thr = rt.current
                dt = self.ext_schema[len(cols)].data_type
                info = np.iinfo(np.dtype(dt.np_dtype))
                # sentinel/clamp in the TIME COLUMN's own dtype
                val = info.min if thr is None \
                    else min(max(int(thr), info.min), info.max)
                cols.append(Column(dt, np.full(
                    cap, val, dtype=np.dtype(dt.np_dtype))))
                st = self.stages[si]
                c = chunk.columns[st.time_col]
                ts = np.asarray(c.values).astype(np.int64)
                ok = np.asarray(chunk.visibility) if c.validity is None \
                    else (np.asarray(chunk.visibility)
                          & np.asarray(c.validity))
                if ok.any():
                    mx = int(ts[ok].max()) - st.delay_usecs
                    if rt.current is None or mx > rt.current:
                        rt.current = mx
        return StreamChunk(self.ext_schema, cols, chunk.visibility,
                           chunk.ops)

    def on_barrier(self, barrier, first: bool = False) -> List:
        """Absorbed-runtime barrier work. Returns watermark messages to
        emit AFTER the barrier (IN-schema space). First barrier: restore
        the persisted watermark; later barriers: persist + commit;
        row-id counters rebase to the epoch floor either way."""
        from risingwave_tpu_torch.stream.message import Watermark
        out: List = []
        for si, _syn in self.row_id_stages:
            self.stages[si].runtime._rebase(barrier.epoch.curr.value)
        for si, _syn in self.wm_stages:
            st = self.stages[si]
            rt = st.runtime
            if first:
                if rt.state is not None:
                    rt.state.init_epoch(barrier.epoch)
                    row = rt.state.get_row((0,))
                    if row is not None:
                        rt.current = int(row[1])
                if rt.current is not None:
                    out.append(Watermark(st.time_col,
                                         DataType.TIMESTAMP,
                                         rt.current))
            else:
                rt._persist()
                if rt.state is not None:
                    rt.state.commit(barrier.epoch)
        return out

    def post_chunk_watermarks(self) -> List:
        """Watermarks due after a data chunk (IN-schema space)."""
        from risingwave_tpu_torch.stream.message import Watermark
        return [Watermark(self.stages[si].time_col, DataType.TIMESTAMP,
                          self.stages[si].runtime.current)
                for si, _syn in self.wm_stages
                if self.stages[si].runtime.current is not None]

    def wm_time_cols(self) -> List[int]:
        return [self.stages[si].time_col for si, _syn in self.wm_stages]

    def describe(self) -> str:
        return "→".join(s.identity for s in self.stages)

    # -- watermark path (host, per message) --------------------------------
    def derive_watermarks(self, msg) -> List:
        """Watermark(s) in OUTPUT column space, composing each stage's
        semantics in order (filters pass through, projects derive or
        drop — ProjectExecutor's exact rules)."""
        from risingwave_tpu_torch.stream.message import Watermark
        outs = [msg]
        for st in self.stages:
            if st.kind == "hop_window":
                nxt = []
                ws_idx = len(self.in_schema)
                for m in outs:
                    if m.col_idx == st.time_col:
                        b = (int(m.value) // st.slide_usecs) \
                            * st.slide_usecs
                        nxt.append(Watermark(
                            ws_idx, DataType.TIMESTAMP,
                            b - (st.units - 1) * st.slide_usecs))
                outs = nxt
                continue
            if st.kind != "project":
                continue
            nxt = []
            for m in outs:
                d = st.watermark_derivations.get(m.col_idx)
                for one in (d if isinstance(d, list)
                            else [] if d is None else [d]):
                    if isinstance(one, tuple):
                        oi, fn = one
                        nxt.append(Watermark(oi, m.data_type,
                                             fn(m.value)))
                    else:
                        nxt.append(m.with_idx(one))
            outs = nxt
        return outs

    def note_stage_rows(self, counts: np.ndarray, chunks: int) -> None:
        self.stage_rows += counts.astype(np.int64)
        self.stage_chunks += chunks

    def drain_stage_metrics(self) -> List[Tuple[str, int, int]]:
        idents = [st.identity for st in self.stages]
        dup = {n for n in idents if idents.count(n) > 1}
        out = [(f"{st.identity}[{i}]" if st.identity in dup
                else st.identity,
                int(self.stage_rows[i]), int(self.stage_chunks[i]))
               for i, st in enumerate(self.stages)]
        self.stage_rows[:] = 0
        self.stage_chunks[:] = 0
        return out

    def input_positions(self, cols) -> Optional[List[int]]:
        """Map output column positions back through the composed
        projection to raw input positions, or None when any is not a pure
        input ref (``ops/fused.py:592`` of the reference): a sharded agg
        computes its routing owners on the host from those raw columns."""
        from risingwave_tpu_torch.expr.expr import InputRef
        n_in = len(self.in_schema)
        out: List[int] = []
        for c in cols:
            if self.out_exprs is None:
                if not 0 <= c < n_in:
                    return None
                out.append(int(c))
                continue
            e = self.out_exprs[c]
            if isinstance(e, InputRef) and e.index < n_in:
                out.append(int(e.index))
            else:
                return None
        return out

    def stage_rows_of(self, counts: np.ndarray) -> np.ndarray:
        """Per-stage visible rows from a program's cumulative mask counts
        ([input, (watermark,) each predicate, final]): a filter reports
        its own count, a project the count at its slot, the last stage
        the final count (noop-pair drop included)."""
        counts = np.asarray(counts, dtype=np.int64)
        n = len(self.stages)
        rows: List[Optional[int]] = [None] * n
        c_in = int(counts[0])
        at = 1
        if self.hop is not None:
            rows[0] = c_in
        for si, _syn in self.wm_stages:
            rows[si] = int(counts[at])
            at += 1
        for si in self._pred_stage:
            rows[si] = int(counts[at])
            at += 1
        cur = c_in
        for si in range(n):
            if rows[si] is None:
                rows[si] = cur
            else:
                cur = rows[si]
        rows[-1] = int(counts[at])
        return np.asarray(rows, dtype=np.int64)

    # -- host half of the noop-pair drop ----------------------------------
    def host_noop_eq(self, chunk) -> Optional[np.ndarray]:
        """Adjacent-row equality over the HOST passthrough columns (a
        U-/U+ pair whose only change is a varchar must not be dropped).
        None when there are no host columns."""
        if not self.host_out or self.out_exprs is None:
            return None
        same = np.ones(chunk.capacity, dtype=bool)
        for _j, src in self.host_out.items():
            c = chunk.columns[src]
            v = np.asarray(c.values)
            eq = np.asarray(v == np.roll(v, -1), dtype=bool)
            if c.validity is not None:
                ok = np.asarray(c.validity)
                ok_n = np.roll(ok, -1)
                eq = (eq & ok & ok_n) | (~ok & ~ok_n)
            same &= eq
        return same

    # -- the composed chain on numpy --------------------------------------
    def chain_body(self, cols: List[Column], vis, ops, host_same=None
                   ) -> Tuple[List[Optional[Column]], np.ndarray,
                              np.ndarray, np.ndarray]:
        """Composed filter+project over numpy arrays (the reference's
        chain_body with xp = numpy). Returns (out device columns, vis,
        ops, per-stage visible-row counts int64[n_stages]); host
        passthrough outputs come back as None placeholders."""
        from risingwave_tpu_torch.stream.executors.simple import (
            FilterExecutor,
        )
        n_stages = len(self.stages)
        stage_rows: List[object] = [None] * n_stages
        vis = np.asarray(vis)
        ops = np.asarray(ops)
        if self.hop is not None:
            cols, vis, ops, host_same = self._expand_hop(
                cols, vis, ops, host_same)
        chunk = StreamChunk(self.body_schema, cols, vis, ops)
        if self.hop is not None:
            stage_rows[0] = np.sum(vis.astype(np.int64))
        for si, syn in self.wm_stages:
            st = self.stages[si]
            c_ts = chunk.columns[st.time_col]
            ts = c_ts.values
            thr = chunk.columns[syn].values
            okm = chunk.visibility if c_ts.validity is None \
                else chunk.visibility & c_ts.validity
            late = okm & (ts < thr)
            chunk = StreamChunk(self.ext_schema, chunk.columns,
                                chunk.visibility & ~late, chunk.ops)
            stage_rows[si] = np.sum(chunk.visibility.astype(np.int64))
        for p, si in zip(self.preds, self._pred_stage):
            chunk = FilterExecutor.apply_predicate(chunk, p)
            stage_rows[si] = np.sum(chunk.visibility.astype(np.int64))
        out_cols: List[Optional[Column]] = []
        if self.out_exprs is None:
            out_cols = [None if j in self.host_out else c
                        for j, c in
                        enumerate(chunk.columns[:len(self._base_schema)])]
        else:
            for j, e in enumerate(self.out_exprs):
                out_cols.append(None if j in self.host_out
                                else e.eval(chunk))
        vis2, ops2 = chunk.visibility, chunk.ops
        if self.out_exprs is not None:
            vis2 = _drop_noop_pairs_np(
                [c for c in out_cols if c is not None], vis2, ops2,
                host_same=host_same)
        final_n = np.sum(vis2.astype(np.int64))
        cur = np.sum(vis.astype(np.int64))
        for si in range(n_stages):
            if stage_rows[si] is None:
                stage_rows[si] = cur
            else:
                cur = stage_rows[si]
        stage_rows[-1] = final_n
        return out_cols, vis2, ops2, np.asarray(stage_rows,
                                                dtype=np.int64)

    def _expand_hop(self, cols: List[Column], vis, ops, host_same=None):
        """Hop expansion (HopWindowExecutor's math): `units` copy-major
        replicas of every column; copy i carries window_start =
        floor(ts/slide)*slide - i*slide; NULL-timestamp rows invisible."""
        st = self.hop
        units = st.units
        slide = st.slide_usecs
        c_ts = cols[st.time_col]
        ts = np.asarray(c_ts.values).astype(np.int64)
        okm = vis if c_ts.validity is None else vis & c_ts.validity
        base = (ts // slide) * slide
        ws = np.concatenate([base - i * slide for i in range(units)])
        out_cols = [Column(c.data_type, np.tile(c.values, units),
                           None if c.validity is None
                           else np.tile(c.validity, units))
                    for c in cols]
        out_cols.append(Column(DataType.TIMESTAMP, ws, None))
        out_cols.append(Column(DataType.TIMESTAMP, ws + st.size_usecs,
                               None))
        return (out_cols, np.tile(okm, units), np.tile(ops, units),
                None if host_same is None else np.tile(host_same, units))


def _drop_noop_pairs_np(cols: Sequence[Column], vis, ops, host_same=None):
    """Clear both halves of adjacent (U-, U+) pairs whose projected
    values (and validities) are identical (ProjectExecutor's rule as
    shifted compares, rolled with wrap-around)."""
    ud = np.int8(int(Op.UPDATE_DELETE))
    ui = np.int8(int(Op.UPDATE_INSERT))
    is_pair = (vis & np.roll(vis, -1)
               & (ops == ud) & (np.roll(ops, -1) == ui))
    same = np.ones(vis.shape[0], dtype=bool) if host_same is None \
        else np.asarray(host_same).astype(bool)
    for c in cols:
        v = np.asarray(c.values)
        eq = v == np.roll(v, -1)
        if c.validity is not None:
            ok = np.asarray(c.validity)
            ok_n = np.roll(ok, -1)
            eq = (eq & ok & ok_n) | (~ok & ~ok_n)
        same = same & eq
    drop = is_pair & same
    return vis & ~drop & ~np.roll(drop, 1)


# -- the expression program -------------------------------------------------
# One int64 word array per (FusedStages, entry point), built at plan time
# and interpreted by csrc/fused.cu (one thread per row) and by
# run_program_plain (vectorized torch). Header words, then sections.

MODE_CHAIN, MODE_AGG, MODE_JOIN = 0, 1, 2

# physical register types: values live in 64-bit words — ints
# sign-extended from their width, bool 0/1, f32 as float bits in the low
# 32 bits, f64 as double bits
T_BOOL, T_I16, T_I32, T_I64, T_F32, T_F64 = range(6)
_PHYS_OF = {np.dtype(np.bool_): T_BOOL, np.dtype(np.int16): T_I16,
            np.dtype(np.int32): T_I32, np.dtype(np.int64): T_I64,
            np.dtype(np.float32): T_F32, np.dtype(np.float64): T_F64}
_INT_T = (T_I16, T_I32, T_I64)
_FLOAT_T = (T_F32, T_F64)
_BITS = {T_I16: 16, T_I32: 32, T_I64: 64}

# header word positions (csrc/fused.cu enum Hdr mirrors these); H_DEPTH
# is the deepest stack any sub-program needs, H_ENCAT the position of the
# encode section's lane offsets (one word an encode op)
(H_MODE, H_NREF, H_NBODY, H_UNITS, H_HOP_TS, H_SLIDE, H_SIZE, H_WM_TS,
 H_WM_THR, H_NPRED, H_NOUT, H_DROP, H_COLTAB, H_PREDTAB, H_OUTTAB, H_ENC,
 H_NENC, H_OUTW, H_NCOUNT, H_LEN, H_DEPTH, H_ENCAT) = range(22)
HEADER_WORDS = 24

# column table kinds
C_RAW, C_WSTART, C_WEND, C_NONE = range(4)

# opcodes: every instruction is 4 words (op, a, b, c)
(OP_COL, OP_CONST, OP_CAST, OP_INT2DEC, OP_DEC2F, OP_ADD, OP_SUB,
 OP_MUL, OP_DECMUL, OP_FDIV, OP_DECDIV, OP_MOD, OP_CMP, OP_AND, OP_OR,
 OP_NOT, OP_NEG, OP_ISNULL, OP_ISNOTNULL, OP_CASE_BEGIN, OP_CASE_WHEN,
 OP_CASE_END, OP_TUMBLE_START, OP_TUMBLE_END, OP_EXTRACT_EPOCH) = range(25)
INSN = 4
CMP_CODES = {"=": 0, "<>": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}

# encode ops (agg / join modes): lanes written left to right
(E_KEY, E_SIGN, E_VIS, E_SUM_INT, E_SUM_FLOAT, E_ORDER, E_VALID,
 E_PAY) = range(8)
_E_LANES = {E_KEY: 3, E_SIGN: 1, E_VIS: 1, E_SUM_INT: 4, E_SUM_FLOAT: 2,
            E_ORDER: 2, E_VALID: 1, E_PAY: 3}

MAX_STACK = 16
MAX_PRED = 4
MAX_OUT = 32
MAX_PROG_WORDS = 4096


class CompileError(ValueError):
    """An eligible expression the program format cannot express."""


def phys_of(dt: DataType) -> int:
    d = np.dtype(dt.np_dtype)
    if d not in _PHYS_OF:
        raise CompileError(f"no device register type for {dt.value}")
    return _PHYS_OF[d]


def _const_word(value, dt: DataType) -> int:
    """A literal's physical value as its 64-bit register word."""
    from risingwave_tpu_torch.common.types import decimal_to_scaled
    t = phys_of(dt)
    if dt == DataType.DECIMAL:
        return int(decimal_to_scaled(value))
    if t == T_F64:
        return int(np.float64(value).view(np.int64))
    if t == T_F32:
        return int(np.float32(value).view(np.int32).astype(np.int64)
                   & 0xFFFFFFFF)
    if t == T_BOOL:
        return int(bool(value))
    return int(np.asarray(value).astype(np.dtype(dt.np_dtype))
               .astype(np.int64))


class _Compiler:
    """Expression tree → postfix instruction words against body space."""

    def __init__(self, body: Schema):
        self.body = body
        self.words: List[int] = []
        self.depth = 0
        self.max_depth = 0
        self.cols_used: set = set()

    def emit(self, op: int, a: int = 0, b: int = 0, c: int = 0,
             push: int = 1, pop: int = 0) -> None:
        self.words += [op, a, b, c]
        self.depth += push - pop
        self.max_depth = max(self.max_depth, self.depth)
        if self.max_depth > MAX_STACK:
            raise CompileError("expression deeper than the kernel stack")

    def cast(self, src: DataType, dst: DataType) -> None:
        """Emit _cast_values(src → dst) for the top of stack."""
        if src == dst:
            return
        if dst == DataType.DECIMAL:
            ts = phys_of(src)
            if ts not in _INT_T:
                raise CompileError(f"cast {src.value} -> DECIMAL")
            self.emit(OP_INT2DEC, ts, push=1, pop=1)
            return
        if src == DataType.DECIMAL:
            td = phys_of(dst)
            if td not in _FLOAT_T:
                raise CompileError(f"cast DECIMAL -> {dst.value}")
            self.emit(OP_DEC2F, td, push=1, pop=1)
            return
        ts, td = phys_of(src), phys_of(dst)
        if ts != td:
            self.emit(OP_CAST, ts, td, push=1, pop=1)

    def expr(self, e) -> None:
        from risingwave_tpu_torch.expr.expr import (
            BinaryOp, Case, Cast, FuncCall, InputRef, Literal, UnaryOp,
            _window_usecs,
        )
        if isinstance(e, InputRef):
            if not e.return_type.is_device:
                raise CompileError("host-typed column in a device program")
            phys_of(e.return_type)
            self.cols_used.add(e.index)
            self.emit(OP_COL, e.index)
            return
        if isinstance(e, Literal):
            if not e.return_type.is_device:
                raise CompileError("host-typed literal in value position")
            t = phys_of(e.return_type)
            if e.value is None:
                self.emit(OP_CONST, 0, 0, t)
            else:
                self.emit(OP_CONST, _const_word(e.value, e.return_type), 1,
                          t)
            return
        if isinstance(e, BinaryOp):
            self.expr(e.left)
            if e.op not in ("and", "or"):
                self.cast(e.left.return_type, e._common)
            self.expr(e.right)
            if e.op not in ("and", "or"):
                self.cast(e.right.return_type, e._common)
            self.binop(e)
            return
        if isinstance(e, UnaryOp):
            self.expr(e.child)
            if e.op == "not":
                if e.child.return_type != DataType.BOOLEAN:
                    raise CompileError("NOT over a non-boolean")
                self.emit(OP_NOT, push=1, pop=1)
            elif e.op == "neg":
                t = phys_of(e.child.return_type)
                if t == T_BOOL:
                    raise CompileError("negation of a boolean")
                self.emit(OP_NEG, t, push=1, pop=1)
            elif e.op == "is_null":
                self.emit(OP_ISNULL, push=1, pop=1)
            else:
                self.emit(OP_ISNOTNULL, push=1, pop=1)
            return
        if isinstance(e, Cast):
            self.expr(e.child)
            self.cast(e.child.return_type, e.return_type)
            return
        if isinstance(e, Case):
            phys_of(e.return_type)
            self.expr(e.else_)
            self.emit(OP_CASE_BEGIN)
            for c, v in e.whens:
                self.expr(c)
                self.expr(v)
                self.emit(OP_CASE_WHEN, push=2, pop=4)
            self.emit(OP_CASE_END, push=0, pop=1)
            return
        if isinstance(e, FuncCall):
            if e.name in ("tumble_start", "tumble_end"):
                ts, win = e.args
                if not isinstance(win, Literal):
                    raise CompileError("tumble over a non-literal window")
                if phys_of(ts.return_type) != T_I64 or \
                        phys_of(e.return_type) != T_I64:
                    raise CompileError("tumble over a non-64-bit column")
                w = None if win.value is None else \
                    _window_usecs(Column(win.return_type,
                                         np.asarray([win.value],
                                                    dtype=object)))
                if w is None:
                    self.emit(OP_CONST, 0, 0, T_I64)
                    return
                if int(w) <= 0:
                    raise CompileError("tumble window must be positive")
                self.expr(ts)
                op = OP_TUMBLE_START if e.name == "tumble_start" \
                    else OP_TUMBLE_END
                self.emit(op, int(w), push=1, pop=1)
                return
            if e.name == "extract_epoch":
                (ts,) = e.args
                if phys_of(ts.return_type) not in _INT_T:
                    raise CompileError("extract_epoch over a non-integer")
                self.expr(ts)
                self.emit(OP_EXTRACT_EPOCH, push=1, pop=1)
                return
            raise CompileError(f"function {e.name}() has no opcode")
        raise CompileError(f"unknown expression node {type(e).__name__}")

    @staticmethod
    def is_const(e) -> bool:
        """No column in the subtree: XLA folds it to a constant."""
        from risingwave_tpu_torch.frontend.opt.checker import expr_refs
        return not expr_refs(e)

    def binop(self, e) -> None:
        op = e.op
        if op == "and":
            self.emit(OP_AND, push=1, pop=2)
            return
        if op == "or":
            self.emit(OP_OR, push=1, pop=2)
            return
        t = phys_of(e._common)
        if op in CMP_CODES:
            self.emit(OP_CMP, CMP_CODES[op], t, push=1, pop=2)
            return
        if t == T_BOOL:
            raise CompileError("arithmetic over booleans")
        dec = e._common == DataType.DECIMAL
        if op == "+":
            self.emit(OP_ADD, t, push=1, pop=2)
        elif op == "-":
            self.emit(OP_SUB, t, push=1, pop=2)
        elif op == "*":
            self.emit(OP_DECMUL if dec else OP_MUL, t, push=1, pop=2)
        elif op == "/":
            if dec:
                self.emit(OP_DECDIV, push=1, pop=2)
            elif t in _FLOAT_T:
                # a constant divisor: x * (1 / c), as XLA computes it
                self.emit(OP_FDIV, t, int(self.is_const(e.right)), push=1,
                          pop=2)
            else:
                raise CompileError("integer '/' outside DECIMAL")
        else:
            self.emit(OP_MOD, t, push=1, pop=2)


class Program:
    """A compiled FusedStages for one entry point: the int64 words (on
    the host, and copied to each device once) plus what the wrappers
    need to size their outputs."""

    def __init__(self, words: np.ndarray, mode: int, out_width: int,
                 n_counts: int, units: int, out_types: List[int],
                 out_pos: List[int]):
        self.words = words
        self.mode = mode
        self.out_width = out_width
        self.n_counts = n_counts
        self.units = units
        self.out_types = out_types          # phys per compiled output
        self.out_pos = out_pos              # its out-schema position
        self._dev: Dict[str, torch.Tensor] = {}

    def opcodes(self) -> set:
        """The opcodes of every predicate and output sub-program."""
        w = self.words
        out = set()
        for tab, n, stride in ((int(w[H_PREDTAB]), int(w[H_NPRED]), 2),
                               (int(w[H_OUTTAB]), int(w[H_NOUT]), 3)):
            for i in range(n):
                start, n_insn = int(w[tab + stride * i]), \
                    int(w[tab + stride * i + 1])
                out.update(int(w[start + INSN * k]) for k in range(n_insn))
        return out

    def on(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = torch.from_numpy(self.words).to(device)
            self._dev[key] = t
        return t


def _body_cols(fs: FusedStages) -> List[Tuple[int, int, int]]:
    """Column table: per body column (kind, raw position, phys)."""
    by_pos = {i: k for k, i in enumerate(fs.ref_cols)}
    n_in = len(fs.in_schema)
    out = []
    for i, f in enumerate(fs.body_schema):
        if fs.hop is not None and i >= n_in:
            out.append((C_WSTART if i == n_in else C_WEND, -1, T_I64))
            continue
        k = by_pos.get(i)
        if k is None or not f.data_type.is_device:
            out.append((C_NONE, -1, 0))
        else:
            out.append((C_RAW, k, phys_of(f.data_type)))
    return out


def compile_program(fs: FusedStages, mode: int,
                    group_indices: Sequence[int] = (),
                    agg_calls=(), specs=(),
                    key_indices: Sequence[int] = (),
                    pay_indices: Sequence[int] = ()) -> Program:
    """Compile a FusedStages into the program of one entry point:
    MODE_CHAIN (every device output column), MODE_AGG (the packed layout
    of ``group_indices`` + ``agg_calls``/``specs``) or MODE_JOIN (key
    lanes of ``key_indices`` then payload lanes of ``pay_indices``)."""
    from risingwave_tpu_torch.expr.expr import InputRef
    from risingwave_tpu_torch.ops.hash_agg import AggKind
    if mode == MODE_JOIN and fs.hop is not None:
        raise CompileError("hop expansion changes cardinality — join "
                           "preludes refuse it")
    body = fs.body_schema
    coltab = _body_cols(fs)
    # output columns, in out-position order (device columns only)
    if fs.out_exprs is None:
        outs = {j: InputRef(j, f.data_type)
                for j, f in enumerate(fs.out_schema)
                if j not in fs.host_out and f.data_type.is_device}
    else:
        outs = {j: e for j, e in enumerate(fs.out_exprs)
                if j not in fs.host_out}
    if mode == MODE_JOIN:
        need = set(key_indices) | set(pay_indices)
        outs = {j: e for j, e in outs.items() if j in need}
    if len(outs) > MAX_OUT:
        raise CompileError(f"more than {MAX_OUT} output columns")
    preds = [] if mode == MODE_JOIN else list(fs.preds)
    if len(preds) > MAX_PRED:
        raise CompileError(f"more than {MAX_PRED} composed predicates")
    code: List[int] = []
    predtab, outtab = [], []
    depth = 1
    for p in preds:
        c = _Compiler(body)
        c.expr(p)
        depth = max(depth, c.max_depth)
        if p.return_type != DataType.BOOLEAN:
            raise CompileError("predicate is not boolean")
        predtab.append((len(code), len(c.words) // INSN))
        code += c.words
    out_pos = {}
    out_types = []
    for j, e in outs.items():
        c = _Compiler(body)
        c.expr(e)
        depth = max(depth, c.max_depth)
        out_pos[j] = len(outtab)
        outtab.append((len(code), len(c.words) // INSN,
                       phys_of(e.return_type)))
        out_types.append(phys_of(e.return_type))
        code += c.words
    enc: List[Tuple[int, int]] = []
    if mode == MODE_AGG:
        for g in group_indices:
            enc.append((E_KEY, out_pos[g]))
        enc.append((E_SIGN, 0))
        enc.append((E_VIS, 0))
        for call, spec in zip(agg_calls, specs):
            if call.input_idx is None:
                continue
            o = out_pos[call.input_idx]
            if spec.kind == AggKind.SUM:
                enc.append((E_SUM_FLOAT if spec.is_float_sum
                            else E_SUM_INT, o))
            elif spec.kind in (AggKind.MIN, AggKind.MAX):
                enc.append((E_ORDER, o))
            enc.append((E_VALID, o))
    elif mode == MODE_JOIN:
        enc = [(E_KEY, out_pos[k]) for k in key_indices] + \
            [(E_PAY, out_pos[p]) for p in pay_indices]
    if mode == MODE_CHAIN:
        out_width = 2 * len(outtab) + 2
    else:
        out_width = sum(_E_LANES[e] for e, _o in enc)
    has_wm = bool(fs.wm_stages)
    n_counts = 0 if mode == MODE_JOIN else 2 + int(has_wm) + len(preds)
    hop = fs.hop
    hdr = [0] * HEADER_WORDS
    hdr[H_MODE] = mode
    hdr[H_NREF] = len(fs.ref_cols)
    hdr[H_NBODY] = len(body)
    hdr[H_UNITS] = 1 if hop is None else hop.units
    hdr[H_HOP_TS] = -1 if hop is None else hop.time_col
    hdr[H_SLIDE] = 0 if hop is None else hop.slide_usecs
    hdr[H_SIZE] = 0 if hop is None else hop.size_usecs
    if has_wm and mode != MODE_JOIN:
        (si, syn), = fs.wm_stages
        hdr[H_WM_TS] = fs.stages[si].time_col
        hdr[H_WM_THR] = syn
    else:
        hdr[H_WM_TS] = hdr[H_WM_THR] = -1
    hdr[H_NPRED] = len(preds)
    hdr[H_NOUT] = len(outtab)
    hdr[H_DROP] = int(fs.out_exprs is not None and mode != MODE_JOIN)
    words = list(hdr)
    hdr_at = {}
    hdr_at[H_COLTAB] = len(words)
    for kind, k, t in coltab:
        words += [kind, k, t]
    hdr_at[H_PREDTAB] = len(words)
    for start, n in predtab:
        words += [start, n]
    hdr_at[H_OUTTAB] = len(words)
    for start, n, t in outtab:
        words += [start, n, t]
    hdr_at[H_ENC] = len(words)
    for e, o in enc:
        words += [e, o]
    hdr_at[H_ENCAT] = len(words)
    at = 0
    for e, _o in enc:
        words.append(at)
        at += _E_LANES[e]
    code_at = len(words)
    words += code
    for h, at in hdr_at.items():
        words[h] = at
    words[H_NENC] = len(enc)
    words[H_OUTW] = out_width
    words[H_NCOUNT] = n_counts
    words[H_DEPTH] = depth
    words[H_LEN] = len(words)
    # sub-program starts are relative to the code section
    for i in range(len(predtab)):
        words[hdr_at[H_PREDTAB] + 2 * i] += code_at
    for i in range(len(outtab)):
        words[hdr_at[H_OUTTAB] + 3 * i] += code_at
    if len(words) > MAX_PROG_WORDS:
        raise CompileError("program longer than the kernel's shared "
                           "memory copy")
    # every column a program reads must reach it through the raw matrix
    # or the hop synthesis; an OP_COL of a raw column carries its raw
    # position and type in its spare words (kind + 1, 8 * k + phys), so the
    # kernel reads it without the column table
    for i in range(code_at, len(words), INSN):
        if words[i] != OP_COL:
            continue
        kind, k, t = coltab[words[i + 1]]
        if kind == C_NONE:
            raise CompileError(f"column ${words[i + 1]} is not uploaded")
        if kind == C_RAW:
            words[i + 2], words[i + 3] = kind + 1, 8 * k + t
    arr = np.asarray(words, dtype=np.int64)
    return Program(arr, mode, out_width, n_counts,
                   hdr[H_UNITS], out_types, list(outs))


def compile_reason(fs: FusedStages) -> Optional[str]:
    """None iff every entry point's program compiles for `fs`."""
    try:
        compile_program(fs, MODE_CHAIN)
    except CompileError as e:
        return f"expression program: {e}"
    return None


# -- the plain version: the program, opcode by opcode, over all rows --------

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
_DEC = DECIMAL_SCALE


def _wrap(x: torch.Tensor, t: int) -> torch.Tensor:
    """Sign-extend an int64 tensor from the width of type t."""
    if t == T_I64:
        return x
    if t == T_BOOL:
        return (x != 0).to(torch.int64)
    s = 64 - _BITS[t]
    return (x << s) >> s


def _floordiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """numpy/jnp floor division on int64 (INT64_MIN // -1 wraps); b != 0."""
    neg1 = b == -1
    bs = torch.where(neg1, torch.ones_like(b), b)
    q = torch.div(a, bs, rounding_mode="trunc")
    r = a - q * bs
    q = torch.where((r != 0) & ((r < 0) != (bs < 0)), q - 1, q)
    return torch.where(neg1, torch.zeros_like(a) - a, q)


def _floormod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    neg1 = b == -1
    bs = torch.where(neg1, torch.ones_like(b), b)
    r = a - torch.div(a, bs, rounding_mode="trunc") * bs
    r = torch.where((r != 0) & ((r < 0) != (bs < 0)), r + bs, r)
    return torch.where(neg1, torch.zeros_like(a), r)


def _div_trunc_t(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """The reference's _div_trunc, built from floor ops as it is."""
    q = _floordiv(num, den)
    rem = _floormod(num, den)
    neg = (num < 0) != (den < 0)
    return torch.where(neg & (rem != 0), q + 1, q)


def _f2i(x: torch.Tensor, t: int) -> torch.Tensor:
    """Saturating float→int of width t (XLA's convert): NaN → 0."""
    d = x.to(torch.float64)
    tr = torch.trunc(d)
    if t == T_BOOL:
        return (d != 0).to(torch.int64)
    bits = _BITS[t]
    hi = float(2 ** (bits - 1))
    lo = -hi
    safe = torch.where(torch.isnan(tr) | (tr >= hi) | (tr < lo),
                       torch.zeros_like(tr), tr)
    out = safe.to(torch.int64)
    out = torch.where(tr >= hi, torch.full_like(out, (1 << (bits - 1)) - 1),
                      out)
    out = torch.where(tr < lo, torch.full_like(out, -(1 << (bits - 1))),
                      out)
    return torch.where(torch.isnan(d), torch.zeros_like(out), out)


def _ftype(t: int):
    return torch.float32 if t == T_F32 else torch.float64


class _Reg:
    """A plain-version register: typed values over all rows + validity.
    Ints and bool as int64 (sign-extended / 0-1), floats as their dtype."""

    __slots__ = ("v", "ok")

    def __init__(self, v: torch.Tensor, ok: torch.Tensor):
        self.v = v
        self.ok = ok


def _cast_plain(r: _Reg, ts: int, td: int) -> _Reg:
    v = r.v
    if ts in _FLOAT_T:
        if td in _FLOAT_T:
            return _Reg(v.to(_ftype(td)), r.ok)
        return _Reg(_f2i(v, td), r.ok)
    # int or bool source (int64 register)
    if td in _FLOAT_T:
        return _Reg(v.to(_ftype(td)), r.ok)
    return _Reg(_wrap(v, td), r.ok)


def _word_to_reg(w: torch.Tensor, t: int) -> torch.Tensor:
    """Register word (int64) → typed register values (constants)."""
    if t == T_F64:
        return w.view(torch.float64)
    if t == T_F32:
        return (w & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
    return w


def _reg_word(v: torch.Tensor, t: int) -> torch.Tensor:
    """Typed register values → codec word (f32 widened to f64 bits)."""
    if t in _FLOAT_T:
        return v.to(torch.float64).view(torch.int64)
    return v


class _PlainRows:
    """Row context of the plain interpreter: decoded body columns over
    the (hop-expanded) rows."""

    def __init__(self, words: np.ndarray, raw: torch.Tensor):
        self.w = words
        n = raw.shape[0]
        units = int(words[H_UNITS])
        self.units = units
        self.m = n * units
        self.raw = raw
        self.cols: Dict[int, _Reg] = {}
        at = int(words[H_COLTAB])
        self.coltab = [tuple(int(x) for x in words[at + 3 * i:at + 3 * i + 3])
                       for i in range(int(words[H_NBODY]))]

    def tile(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.units == 1 else x.repeat(self.units)

    def col(self, c: int) -> _Reg:
        r = self.cols.get(c)
        if r is not None:
            return r
        kind, k, t = self.coltab[c]
        dev = self.raw.device
        if kind == C_RAW:
            w = self.tile(self.raw[:, RAW_META_COLS + 2 * k])
            ok = self.tile(self.raw[:, RAW_META_COLS + 2 * k + 1] != 0)
            if t == T_F64:
                v = w.view(torch.float64)
            elif t == T_F32:
                v = w.view(torch.float64).to(torch.float32)
            else:
                v = _wrap(w, t)
            r = _Reg(v, ok)
        elif kind in (C_WSTART, C_WEND):
            ts_c = int(self.w[H_HOP_TS])
            tsr = self.col(ts_c)
            n = self.raw.shape[0]
            slide = int(self.w[H_SLIDE])
            copy = torch.arange(self.m, device=dev) // n
            ts = tsr.v.to(torch.int64)
            ws = _floordiv(ts, torch.full_like(ts, slide)) * slide \
                - copy * slide
            if kind == C_WEND:
                ws = ws + int(self.w[H_SIZE])
            r = _Reg(ws, torch.ones(self.m, dtype=torch.bool, device=dev))
        else:
            raise RuntimeError(f"column ${c} is not in the program")
        self.cols[c] = r
        return r


def _eval_plain(rows: _PlainRows, start: int, n_insn: int) -> _Reg:
    """One postfix sub-program over every row."""
    w = rows.w
    st: List[_Reg] = []
    m = rows.m
    dev = rows.raw.device
    for pc in range(start, start + n_insn * INSN, INSN):
        op, a, b = int(w[pc]), int(w[pc + 1]), int(w[pc + 2])
        if op == OP_COL:
            st.append(rows.col(a))
        elif op == OP_CONST:
            word = torch.full((m,), a, dtype=torch.int64, device=dev)
            st.append(_Reg(_word_to_reg(word, int(w[pc + 3])),
                           torch.full((m,), bool(b), device=dev)))
        elif op == OP_CAST:
            st.append(_cast_plain(st.pop(), a, b))
        elif op == OP_INT2DEC:
            r = st.pop()
            st.append(_Reg(r.v * _DEC, r.ok))
        elif op == OP_DEC2F:
            r = st.pop()
            ft = _ftype(a)
            recip = torch.tensor(1, dtype=ft) / torch.tensor(_DEC, dtype=ft)
            st.append(_Reg(r.v.to(ft) * recip, r.ok))
        elif op in (OP_ADD, OP_SUB, OP_MUL):
            y, x = st.pop(), st.pop()
            if op == OP_ADD:
                v = x.v + y.v
            elif op == OP_SUB:
                v = x.v - y.v
            else:
                v = x.v * y.v
            if a in _INT_T:
                v = _wrap(v, a)
            st.append(_Reg(v, x.ok & y.ok))
        elif op == OP_DECMUL:
            y, x = st.pop(), st.pop()
            st.append(_Reg(_div_trunc_t(x.v * y.v,
                                        torch.full_like(x.v, _DEC)),
                           x.ok & y.ok))
        elif op in (OP_FDIV, OP_DECDIV, OP_MOD):
            y, x = st.pop(), st.pop()
            zero = y.v == 0
            safe = torch.where(zero, torch.ones_like(y.v), y.v)
            if op == OP_FDIV:
                v = x.v * (torch.ones_like(safe) / safe) if b else \
                    x.v / safe
            elif op == OP_DECDIV:
                v = _div_trunc_t(x.v * _DEC, safe)
            elif a in _FLOAT_T:
                v = torch.fmod(x.v, safe)
            else:
                v = _wrap(x.v - _wrap(_div_trunc_t(x.v, safe) * safe, a),
                          a)
                v = _wrap(v, a)
            st.append(_Reg(v, x.ok & y.ok & ~zero))
        elif op == OP_CMP:
            y, x = st.pop(), st.pop()
            fn = (torch.eq, torch.ne, torch.lt, torch.le, torch.gt,
                  torch.ge)[a]
            st.append(_Reg(fn(x.v, y.v).to(torch.int64), x.ok & y.ok))
        elif op in (OP_AND, OP_OR):
            y, x = st.pop(), st.pop()
            lv, rv = x.v != 0, y.v != 0
            ln, rn = x.ok, y.ok
            if op == OP_AND:
                v = lv & rv
                ok = (ln & rn) | (ln & ~lv) | (rn & ~rv)
            else:
                v = lv | rv
                ok = (ln & rn) | (ln & lv) | (rn & rv)
            st.append(_Reg(v.to(torch.int64), ok))
        elif op == OP_NOT:
            r = st.pop()
            st.append(_Reg((r.v == 0).to(torch.int64), r.ok))
        elif op == OP_NEG:
            r = st.pop()
            v = -r.v if a in _FLOAT_T else _wrap(torch.zeros_like(r.v)
                                                 - r.v, a)
            st.append(_Reg(v, r.ok))
        elif op in (OP_ISNULL, OP_ISNOTNULL):
            r = st.pop()
            v = r.ok if op == OP_ISNOTNULL else ~r.ok
            st.append(_Reg(v.to(torch.int64),
                           torch.ones(m, dtype=torch.bool, device=dev)))
        elif op == OP_CASE_BEGIN:
            st.append(_Reg(torch.zeros(m, dtype=torch.int64, device=dev),
                           torch.ones(m, dtype=torch.bool, device=dev)))
        elif op == OP_CASE_WHEN:
            val, cond, taken, acc = st.pop(), st.pop(), st.pop(), st.pop()
            cv = (cond.v != 0) & cond.ok & (taken.v == 0)
            v = torch.where(cv, val.v, acc.v)
            ok = torch.where(cv, val.ok, acc.ok)
            st.append(_Reg(v, ok))
            st.append(_Reg(((taken.v != 0) | cv).to(torch.int64),
                           taken.ok))
        elif op == OP_CASE_END:
            st.pop()
        elif op in (OP_TUMBLE_START, OP_TUMBLE_END):
            r = st.pop()
            wv = torch.full_like(r.v, a)
            v = r.v - _floormod(r.v, wv)
            if op == OP_TUMBLE_END:
                v = v + a
            st.append(_Reg(v, r.ok))
        elif op == OP_EXTRACT_EPOCH:
            r = st.pop()
            us = torch.full_like(r.v, 1_000_000)
            whole = _floordiv(r.v, us)
            frac = _floormod(r.v, us)
            v = whole * _DEC + _floordiv(frac * _DEC, us)
            st.append(_Reg(v, r.ok))
        else:
            raise RuntimeError(f"bad opcode {op} at {pc}")
    assert len(st) == 1, "program left a malformed stack"
    return st[0]


def _key_word(r: _Reg, t: int) -> torch.Tensor:
    """keys.to_i64: floats -0.0 → 0.0 then f64 bits; ints as int64."""
    if t in _FLOAT_T:
        v = torch.where(r.v == 0, torch.zeros_like(r.v), r.v)
        return v.to(torch.float64).view(torch.int64)
    return r.v


def _hi_lo(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    hi = (w >> 32).to(torch.int32)
    lo = (w & 0xFFFFFFFF)
    lo = torch.where(lo >= (1 << 31), lo - (1 << 32), lo).to(torch.int32)
    return hi, lo


def _order_word(r: _Reg, t: int) -> torch.Tensor:
    """lanes.order_lanes' uint64 order key, as int64 bits."""
    sign = torch.tensor(_I64_MIN, dtype=torch.int64)
    if t in _FLOAT_T:
        v = torch.where(r.v == 0, torch.zeros_like(r.v), r.v)
        bits = v.to(torch.float64).view(torch.int64)
        return torch.where(bits < 0, ~bits, bits | sign)
    return r.v ^ sign


def run_program_plain(prog: Program, raw: torch.Tensor,
                      host_same: Optional[torch.Tensor] = None,
                      counts: Optional[torch.Tensor] = None,
                      seg: int = 0) -> torch.Tensor:
    """The plain version of all three entry points: the program's words
    interpreted opcode by opcode as vectorized torch ops over every row
    (the reference's chain_body + preludes, with xp = torch). With
    ``seg``, the rows are blocks of ``seg`` rows and the ±1 neighbour
    rolls wrap inside each block (a sharded step's per-shard prelude)."""
    w = prog.words
    rows = _PlainRows(w, raw)
    m = rows.m
    dev = raw.device
    _check_seg(prog, raw, seg)

    def roll(x: torch.Tensor, shift: int) -> torch.Tensor:
        if not seg:
            return torch.roll(x, shift)
        return torch.roll(x.reshape(-1, seg), shift, dims=1).reshape(-1)

    mode = int(w[H_MODE])
    outtab_at = int(w[H_OUTTAB])
    nout = int(w[H_NOUT])
    outs: List[_Reg] = []
    for j in range(nout):
        s, n, _t = (int(x) for x in w[outtab_at + 3 * j:outtab_at + 3 * j + 3])
        outs.append(_eval_plain(rows, s, n))
    out_t = [int(w[outtab_at + 3 * j + 2]) for j in range(nout)]
    vis = ops = None
    if mode != MODE_JOIN:
        vis = rows.tile(raw[:, 1] != 0)
        ops = rows.tile(raw[:, 0])
        cnt = []
        hop_ts = int(w[H_HOP_TS])
        if hop_ts >= 0:
            vis = vis & rows.col(hop_ts).ok
        cnt.append(vis.sum())
        wm_ts = int(w[H_WM_TS])
        if wm_ts >= 0:
            ts = rows.col(wm_ts)
            thr = rows.col(int(w[H_WM_THR]))
            late = vis & ts.ok & (ts.v < thr.v)
            vis = vis & ~late
            cnt.append(vis.sum())
        ud, ui = int(Op.UPDATE_DELETE), int(Op.UPDATE_INSERT)
        pt = int(w[H_PREDTAB])
        for k in range(int(w[H_NPRED])):
            r = _eval_plain(rows, int(w[pt + 2 * k]), int(w[pt + 2 * k + 1]))
            pred = (r.v != 0) & r.ok
            is_ud, is_ui = ops == ud, ops == ui
            ddel = is_ud & roll(is_ui, -1) & pred & \
                ~roll(pred, -1)
            dins = is_ui & roll(is_ud, 1) & pred & \
                ~roll(pred, 1)
            ops = torch.where(ddel, torch.full_like(ops, int(Op.DELETE)),
                              ops)
            ops = torch.where(dins, torch.full_like(ops, int(Op.INSERT)),
                              ops)
            vis = vis & pred
            cnt.append(vis.sum())
        if int(w[H_DROP]):
            is_pair = vis & roll(vis, -1) & (ops == ud) & \
                (roll(ops, -1) == ui)
            same = torch.ones(m, dtype=torch.bool, device=dev) \
                if host_same is None else rows.tile(host_same != 0)
            for r in outs:
                eq = (r.v == roll(r.v, -1))
                ok_n = roll(r.ok, -1)
                eq = (eq & r.ok & ok_n) | (~r.ok & ~ok_n)
                same = same & eq
            drop = is_pair & same
            vis = vis & ~drop & ~roll(drop, 1)
        cnt.append(vis.sum())
        if counts is not None:
            counts += torch.stack(cnt).to(torch.int64)
    if mode == MODE_CHAIN:
        cols = []
        for r, t in zip(outs, out_t):
            cols.append(_reg_word(r.v, t))
            cols.append(r.ok.to(torch.int64))
        cols.append(vis.to(torch.int64))
        cols.append(ops)
        return torch.stack(cols, dim=1) if cols else \
            torch.zeros((m, 0), dtype=torch.int64, device=dev)
    lanes: List[torch.Tensor] = []
    enc_at = int(w[H_ENC])
    for i in range(int(w[H_NENC])):
        e, o = int(w[enc_at + 2 * i]), int(w[enc_at + 2 * i + 1])
        if e == E_SIGN:
            is_ins = (ops == int(Op.INSERT)) | (ops == int(Op.UPDATE_INSERT))
            lanes.append(torch.where(is_ins, 1, -1).to(torch.int32))
            continue
        if e == E_VIS:
            lanes.append(vis.to(torch.int32))
            continue
        r, t = outs[o], out_t[o]
        if e in (E_KEY, E_PAY):
            kw = _key_word(r, t) if e == E_KEY else _reg_word(r.v, t)
            kw = torch.where(r.ok, kw, torch.zeros_like(kw))
            hi, lo = _hi_lo(kw)
            lanes += [hi, lo, r.ok.to(torch.int32)]
        elif e == E_SUM_INT:
            v = r.v
            for k in range(3):
                lanes.append(((v >> (17 * k)) & ((1 << 17) - 1))
                             .to(torch.int32))
            lanes.append((v >> 51).to(torch.int32))
        elif e == E_SUM_FLOAT:
            hi = r.v.to(torch.float32)
            lo = (r.v.to(torch.float64) - hi.to(torch.float64)) \
                .to(torch.float32)
            lanes += [hi.view(torch.int32), lo.view(torch.int32)]
        elif e == E_ORDER:
            hi, lo = _hi_lo(_order_word(r, t))
            # (m >> 32) - 2^31 and (m & 0xffffffff) - 2^31 as int32: the
            # unsigned halves with their top bit flipped
            lanes += [hi ^ torch.tensor(_I32_SIGN, dtype=torch.int32),
                      lo ^ torch.tensor(_I32_SIGN, dtype=torch.int32)]
        elif e == E_VALID:
            lanes.append(r.ok.to(torch.int32))
    return torch.stack(lanes, dim=1).contiguous()


_I32_SIGN = -(1 << 31)


# -- the three entry points ----------------------------------------------------

def _check_launch(prog: Program, raw: torch.Tensor, what: str) -> None:
    if raw.dtype != torch.int64 or raw.dim() != 2 or \
            not raw.is_contiguous():
        raise TypeError(f"{what} takes a contiguous int64 raw matrix")
    if raw.shape[1] != raw_width(int(prog.words[H_NREF])):
        raise ValueError(f"{what}: raw width {raw.shape[1]} is not the "
                         "program's")


def _check_seg(prog: Program, raw: torch.Tensor, seg: int) -> None:
    if seg and (prog.units != 1 or seg < 0 or raw.shape[0] % seg):
        raise ValueError(f"segments of {seg} rows need a program without "
                         f"hop expansion and a multiple of {seg} rows")


def _launch(fn: str, prog: Program, raw: torch.Tensor,
            host_same: Optional[torch.Tensor], out: torch.Tensor,
            counts: Optional[torch.Tensor], *extra) -> None:
    pw = prog.on(raw.device)
    # the device copy runs; the host copy gives the launch its shape
    cuda.call("fused", fn, pw.data_ptr(), prog.words.ctypes.data,
              int(pw.shape[0]), raw.data_ptr(),
              int(raw.shape[0]), int(raw.shape[1]),
              0 if host_same is None else host_same.data_ptr(),
              out.data_ptr(), int(out.shape[1]),
              0 if counts is None else counts.data_ptr(), *extra)


def fused_chain(prog: Program, raw: torch.Tensor,
                host_same: Optional[torch.Tensor] = None,
                counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B18: raw int64[N, 2 + 2r] → int64[N * units, 2 * n_out + 2] of
    (word, valid) per device output column, then vis and ops; the
    cumulative mask counts add into `counts`."""
    assert prog.mode == MODE_CHAIN
    if raw.device.type != "cuda":
        return run_program_plain(prog, raw, host_same, counts)
    _check_launch(prog, raw, "fused_chain")
    if host_same is not None and (host_same.dtype != torch.int8 or
                                  host_same.shape != (raw.shape[0],)):
        raise TypeError("fused_chain takes int8[N] host_same")
    if counts is not None and (counts.dtype != torch.int64 or
                               counts.shape != (prog.n_counts,)):
        raise TypeError("fused_chain takes int64[n_counts] counts")
    out = torch.empty((raw.shape[0] * prog.units, prog.out_width),
                      dtype=torch.int64, device=raw.device)
    _launch("rw_fused_chain", prog, raw, host_same, out, counts)
    LAUNCHES.add("fused_chain")
    return out


def agg_prelude(prog: Program, raw: torch.Tensor,
                counts: Optional[torch.Tensor] = None,
                seg: int = 0) -> torch.Tensor:
    """B19: raw int64[N, 2 + 2r] → the packed int32[N * units, W] matrix
    of ops/hash_agg.pack_chunk; the cumulative mask counts add into
    `counts`. With ``seg`` (no hop expansion), the rows are N / seg
    blocks, each its own ring for the neighbour rolls: the sharded
    step's prelude, which the reference runs on each shard's block
    (``parallel/agg.py:349``); the counts sum over the blocks."""
    assert prog.mode == MODE_AGG
    if raw.device.type != "cuda":
        return run_program_plain(prog, raw, None, counts, seg)
    _check_launch(prog, raw, "agg_prelude")
    _check_seg(prog, raw, seg)
    if counts is not None and (counts.dtype != torch.int64 or
                               counts.shape != (prog.n_counts,)):
        raise TypeError("agg_prelude takes int64[n_counts] counts")
    out = torch.empty((raw.shape[0] * prog.units, prog.out_width),
                      dtype=torch.int32, device=raw.device)
    _launch("rw_agg_prelude", prog, raw, None, out, counts, int(seg))
    LAUNCHES.add("agg_prelude")
    return out


def join_prelude(prog: Program, raw: torch.Tensor) -> torch.Tensor:
    """B20: raw int64[N, 2 + 2r] → [key lanes | payload lanes]
    int32[N, 3k + 3p]."""
    assert prog.mode == MODE_JOIN
    if raw.device.type != "cuda":
        return run_program_plain(prog, raw)
    _check_launch(prog, raw, "join_prelude")
    out = torch.empty((raw.shape[0], prog.out_width), dtype=torch.int32,
                      device=raw.device)
    _launch("rw_join_prelude", prog, raw, None, out, None)
    LAUNCHES.add("join_prelude")
    return out


def decode_chain_output(prog: Program, fs: FusedStages,
                        mat: np.ndarray) -> Tuple[List[Optional[Column]],
                                                  np.ndarray, np.ndarray]:
    """fused_chain's output matrix (fetched) → (out columns in out-schema
    positions, host positions None; vis; ops)."""
    cols: List[Optional[Column]] = []
    k = 0
    for j, f in enumerate(fs.out_schema):
        if j in fs.host_out or not f.data_type.is_device:
            cols.append(None)
            continue
        vals = decode_words(np.ascontiguousarray(mat[:, 2 * k]),
                            f.data_type)
        ok = mat[:, 2 * k + 1] != 0
        cols.append(Column(f.data_type, vals, None if ok.all() else ok))
        k += 1
    return cols, mat[:, 2 * k] != 0, mat[:, 2 * k + 1].astype(np.int8)


def bound_bytes(prog: Program, n_rows: int) -> int:
    """Bytes the entry point must move for n_rows raw rows: the raw
    matrix read once, the output written once (the byte bound chip_smoke
    divides by the card's memory rate)."""
    nref = int(prog.words[H_NREF])
    m = n_rows * prog.units
    out_elem = 8 if prog.mode == MODE_CHAIN else 4
    return n_rows * raw_width(nref) * 8 + m * prog.out_width * out_elem

