"""HashJoinExecutor: streaming inner equi-join on the device matcher.

Port of the single-device, epoch-batched, inner-join path of
``risingwave_tpu/stream/executors/hash_join.py`` (reference parity:
src/stream/src/executor/hash_join.rs:227 executor, :697 main loop over
barrier-aligned sides, :990 ``eq_join_oneside``; state layout
managed_state/join/mod.rs:228). The device owns the MATCH structure
(``ops/hash_join.py``: key table + row chains + payload lanes); the host
owns row payloads of host-typed columns (varchar never ships to the
device) and materializes output chunks with vectorized gathers.

Chunk lifecycle on side S (probing side O):
  1. ingest: host bookkeeping (pk → row ref, arena), and the chunk's
     [key lanes | payload lanes] and aux rows buffered for the epoch;
  2. barrier: each side's buffered epoch ships as one upload, one apply
     dispatch (K1 + K5) and one probe dispatch against the other side
     (K6); both probes are collected (sequence versioning makes every
     row's result exact for its own message) and emitted in message
     order. Update pairs degrade to Delete+Insert, as the reference
     degrades split pairs;
  3. both sides' StateTables commit, then compaction (a rebuild: K1 +
     K5 + K7) once dead refs dominate. Recovery rebuilds arena + chains.

Inner-join NULL semantics: rows whose join key contains NULL never match
and are not stored.

Fused input sides (``frontend/opt/fusion.py``): a side that absorbed its
filter/project/row_id_gen run receives RAW chunks. The composed chain
runs once on numpy for the host bookkeeping (visibility, pk→ref, arena,
state rows), the raw int64 matrix is buffered for the epoch, and at the
barrier one ``join_prelude`` launch (B20) builds the side's [key lanes |
payload lanes] on the card from it; that one matrix feeds both the
side's apply (K1 + K5) and its probe of the other side (K6).

With ``mesh`` (a ``ShardMesh``), both sides' matchers are the
vnode-sharded ``parallel/join.ShardedJoinKernel``: the reference's hash
dispatch to N parallel join actors. Its epoch steps route each side's
epoch to the key owners with a skew-exact bucket (per-row owners from the
host twin of the routing, ``_ingest_chunk``), and matched rows gather
from the host arena by ref (the reference's mesh path keeps no device
payload). ``epoch_batch=False`` (only with a mesh, as in the reference)
is the per-chunk arm: each chunk dispatches one ``apply_and_probe`` (B16)
at once and the pending probes are collected in message order at the
barrier. ``device_payload=False`` forces the same host-gather emit on
one device.

Not ported, refused at construction with NotImplementedError: the outer,
semi and anti join types (device degrees) and the cold tier
(``state_cap``), with or without a mesh. Join-key watermarks (state
expiry) raise NotImplementedError when one arrives; a watermark on any
other column is dropped, as the reference drops it. Metrics, hot-key
sketches and dispatch spans are left out.
"""

from __future__ import annotations

import enum
from typing import AsyncIterator, Dict, List, Optional, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk, next_pow2
from risingwave_tpu_torch.common.types import Field, Schema
from risingwave_tpu_torch.ops import lanes as _lanes
from risingwave_tpu_torch.ops.hash_join import (
    FLAG_DEL, FLAG_INS, FLAG_NEG, FLAG_PROBE, JoinSideKernel,
)
from risingwave_tpu_torch.parallel.join import ShardedJoinKernel
from risingwave_tpu_torch.parallel.mesh import ShardMesh
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.executors.keys import LANES_PER_KEY, KeyCodec
from risingwave_tpu_torch.stream.merge import barrier_align_2
from risingwave_tpu_torch.stream.message import Message, Watermark, is_barrier
from risingwave_tpu_torch.utils.device import resolve_device


class JoinType(enum.Enum):
    """The 8 streaming join types (hash_join.rs:61-71); only INNER is
    ported."""

    INNER = "inner"
    LEFT_OUTER = "left_outer"
    RIGHT_OUTER = "right_outer"
    FULL_OUTER = "full_outer"
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"
    RIGHT_SEMI = "right_semi"
    RIGHT_ANTI = "right_anti"


class _Arena:
    """Host row store: typed column arrays indexed by device row refs."""

    def __init__(self, schema: Schema, capacity: int = 1024):
        self.schema = schema
        self.cap = capacity
        self.cols: List[np.ndarray] = []
        self.valid: List[np.ndarray] = []
        for f in schema:
            dt = f.data_type
            self.cols.append(
                np.zeros(capacity, dtype=dt.np_dtype) if dt.is_device
                else np.empty(capacity, dtype=object))
            self.valid.append(np.ones(capacity, dtype=bool))

    def ensure(self, max_ref: int) -> None:
        if max_ref < self.cap:
            return
        new_cap = self.cap
        while new_cap <= max_ref:
            new_cap *= 2
        for i, c in enumerate(self.cols):
            grown = np.zeros(new_cap, dtype=c.dtype) if c.dtype != object \
                else np.empty(new_cap, dtype=object)
            grown[:self.cap] = c
            self.cols[i] = grown
            v = np.ones(new_cap, dtype=bool)
            v[:self.cap] = self.valid[i]
            self.valid[i] = v
        self.cap = new_cap

    def store(self, refs: np.ndarray, chunk: StreamChunk,
              row_idx: np.ndarray) -> None:
        if not len(refs):
            return
        self.ensure(int(refs.max()))
        for i, c in enumerate(chunk.columns):
            self.cols[i][refs] = np.asarray(c.values)[row_idx]
            self.valid[i][refs] = True if c.validity is None else \
                np.asarray(c.validity)[row_idx]

    def gather_col(self, i: int, refs: np.ndarray,
                   out_cap: int) -> Column:
        f, c, v = self.schema[i], self.cols[i], self.valid[i]
        vals = np.zeros(out_cap, dtype=c.dtype) if c.dtype != object \
            else np.empty(out_cap, dtype=object)
        vals[:len(refs)] = c[refs]
        ok = np.ones(out_cap, dtype=bool)
        ok[:len(refs)] = v[refs]
        return Column(f.data_type, vals, None if ok.all() else ok)


class _JoinSide:
    """One side's state: device matcher + host arena + durability.

    With a mesh, the matcher is the vnode-sharded
    ``parallel/join.ShardedJoinKernel`` (same API, rows routed to their
    key's owner shard) and every output column gathers from the arena."""

    # dead-ref fraction of the arena that triggers a compaction; dead
    # refs cannot be recycled in place (see alloc_refs), so churn-heavy
    # streams reclaim them wholesale here
    COMPACT_DEAD_RATIO = 0.5
    COMPACT_MIN_REFS = 4096

    def __init__(self, schema: Schema, key_indices: Sequence[int],
                 pk_indices: Sequence[int], table: StateTable,
                 key_codec: KeyCodec, kernel_opts: Optional[dict],
                 device, mesh: Optional[ShardMesh] = None,
                 device_payload: bool = True):
        self.schema = schema
        self.key_indices = list(key_indices)
        self.pk_indices = list(pk_indices)
        # SHARED with the other side: equal values must get equal
        # interned ids or varchar keys would never match
        self.key_codec = key_codec
        self.table = table
        # device payload lanes: every device-typed column of a stored row
        # lives on the card as a (hi, lo, valid) int32 triple by row ref,
        # written where the apply links chains and gathered by the
        # probe's emit walk; host-typed columns stay arena-gathered. One
        # device only: the sharded kernel keeps no payload store
        self.pay_indices: List[int] = [
            i for i, f in enumerate(schema) if f.data_type.is_device
        ] if device_payload and mesh is None else []
        self.pay_pos: Dict[int, int] = {
            c: k for k, c in enumerate(self.pay_indices)}
        self.mesh = mesh
        key_width = LANES_PER_KEY * len(self.key_indices)
        if mesh is not None:
            self.kernel = ShardedJoinKernel(mesh, key_width,
                                            **dict(kernel_opts or {}))
        else:
            opts = {k: v for k, v in dict(kernel_opts or {}).items()
                    if k in ("key_capacity", "row_capacity",
                             "probe_capacity")}
            self.kernel = JoinSideKernel(
                key_width=key_width, payload_width=3 * len(self.pay_indices),
                device=device, **opts)
        self.arena = _Arena(schema)
        self.pk_to_ref: Dict[tuple, int] = {}
        self.free: List[int] = []
        self.next_ref = 0
        # fused input run: `schema` is the run's OUTPUT space; the
        # prelude program is compiled on first use
        self.fused_input = None
        self._prog = None

    @property
    def prelude(self):
        """The fused input run's join_prelude program (MODE_JOIN)."""
        if self._prog is None:
            from risingwave_tpu_torch.ops.fused import (
                MODE_JOIN, compile_program,
            )
            self._prog = compile_program(
                self.fused_input, MODE_JOIN, key_indices=self.key_indices,
                pay_indices=self.pay_indices)
        return self._prog

    def key_nonnull_mask(self, chunk: StreamChunk) -> np.ndarray:
        """Rows whose join key has no NULL (keys are device-typed on a
        fused side)."""
        m = np.ones(chunk.capacity, dtype=bool)
        for i in self.key_indices:
            c = chunk.columns[i]
            if c.validity is not None:
                m &= np.asarray(c.validity)
        return m

    # -- device payload lanes (ops/lanes.py payload codecs) ---------------
    def payload_rows(self, chunk: StreamChunk) -> np.ndarray:
        """int32[cap, 3*len(pay_indices)] payload lanes for every row
        (the device scatter masks non-inserted rows itself)."""
        return _lanes.payload_lanes(
            [(np.asarray(chunk.columns[i].values),
              None if chunk.columns[i].validity is None
              else np.asarray(chunk.columns[i].validity))
             for i in self.pay_indices])

    def payload_from_arena(self, refs: np.ndarray) -> np.ndarray:
        """Payload lanes of stored rows (recovery and compaction rebuild
        the device store from the host copy)."""
        return _lanes.payload_lanes(
            [(self.arena.cols[i][refs], self.arena.valid[i][refs])
             for i in self.pay_indices])

    def cols_from_payload(self, pay_rows: np.ndarray,
                          refs: np.ndarray, out_cap: int
                          ) -> List[Column]:
        """Matched rows from the packed probe matrix: device-typed
        columns decode from the gathered payload lanes, host-typed
        columns gather from the arena by ref."""
        t = len(refs)
        out: List[Column] = []
        for i, f in enumerate(self.schema):
            k = self.pay_pos.get(i)
            if k is None:
                out.append(self.arena.gather_col(i, refs, out_cap))
                continue
            v64 = _lanes.merge_i64(pay_rows[:, 3 * k],
                                   pay_rows[:, 3 * k + 1])
            dt = np.dtype(f.data_type.np_dtype)
            vals = np.zeros(out_cap, dtype=dt)
            vals[:t] = _lanes.decode_payload_i64(v64, dt)
            ok = np.ones(out_cap, dtype=bool)
            ok[:t] = pay_rows[:, 3 * k + 2] != 0
            out.append(Column(f.data_type, vals,
                              None if ok.all() else ok))
        return out

    def alloc_refs(self, k: int) -> np.ndarray:
        """Bump allocation ONLY: a tombstoned ref stays linked in its
        chain, so reusing it would splice its node into a second chain.
        Dead refs are reclaimed wholesale by compaction."""
        out = np.arange(self.next_ref, self.next_ref + k, dtype=np.int32)
        self.next_ref += k
        return out

    def apply_chunk_host(self, chunk: StreamChunk, nonnull: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray, np.ndarray, np.ndarray]:
        """HOST half of a chunk apply: pk→ref/arena bookkeeping only.
        Returns (ins_idx, ins_refs, full_refs, ins_mask, del_refs,
        del_mask) for the epoch dispatch. pk→ref bookkeeping runs in ROW
        ORDER (a delete refers to the latest same-pk version, which may
        be an insert earlier in this very chunk); an all-insert chunk
        takes a bulk dict.update instead of the per-row loop."""
        vis = np.asarray(chunk.visibility)
        storable = vis & nonnull
        ops = np.asarray(chunk.ops)
        is_ins = (ops == int(Op.INSERT)) | (ops == int(Op.UPDATE_INSERT))
        ins_idx = np.flatnonzero(storable & is_ins)
        st_idx = np.flatnonzero(storable)
        pk_lists = []
        for i in self.pk_indices:
            c = chunk.columns[i]
            col = np.asarray(c.values)[st_idx].tolist()
            if c.validity is not None:
                okv = np.asarray(c.validity)[st_idx]
                col = [None if not o else v
                       for v, o in zip(col, okv.tolist())]
            pk_lists.append(col)
        pk_tuples = list(zip(*pk_lists)) if pk_lists \
            else [()] * len(st_idx)
        ins_refs = self.alloc_refs(len(ins_idx))
        del_refs = np.zeros(chunk.capacity, dtype=np.int32)
        del_mask = np.zeros(chunk.capacity, dtype=bool)
        if len(ins_idx) == len(st_idx):
            # append-only fast path: no deletes, refs align with pks
            self.pk_to_ref.update(zip(pk_tuples, ins_refs.tolist()))
        else:
            pks = dict(zip(st_idx.tolist(), pk_tuples))
            ins_pos = {int(r): j for j, r in enumerate(ins_idx)}
            for r in st_idx.tolist():
                if r in ins_pos:
                    self.pk_to_ref[pks[r]] = int(ins_refs[ins_pos[r]])
                else:
                    ref = self.pk_to_ref.pop(pks[r], None)
                    if ref is None:
                        continue    # inconsistent delete: ignored
                    del_refs[r] = ref
                    del_mask[r] = True
                    self.free.append(ref)
        full_refs = np.zeros(chunk.capacity, dtype=np.int32)
        ins_mask = np.zeros(chunk.capacity, dtype=bool)
        if len(ins_idx):
            self.arena.store(ins_refs, chunk, ins_idx)
            full_refs[ins_idx] = ins_refs
            ins_mask[ins_idx] = True
        self.table.write_chunk(chunk, defer=True)
        return ins_idx, ins_refs, full_refs, ins_mask, del_refs, del_mask

    def maybe_compact(self) -> bool:
        if (self.next_ref < self.COMPACT_MIN_REFS
                or len(self.free) < self.COMPACT_DEAD_RATIO * self.next_ref):
            return False
        self.compact()
        return True

    def compact(self) -> None:
        """Rebuild arena + device state with only live rows (dense
        refs)."""
        live = np.fromiter(self.pk_to_ref.values(), dtype=np.int64,
                           count=len(self.pk_to_ref))
        n = len(live)
        new_arena = _Arena(self.schema,
                           capacity=max(1024, next_pow2(max(n, 1))))
        for i in range(len(self.schema)):
            new_arena.cols[i][:n] = self.arena.cols[i][live]
            new_arena.valid[i][:n] = self.arena.valid[i][live]
        self.arena = new_arena
        new_refs = np.arange(n, dtype=np.int32)
        self.pk_to_ref = dict(zip(self.pk_to_ref.keys(), new_refs.tolist()))
        self.free = []
        self.next_ref = n
        if n:
            key_cols = [(self.arena.cols[i][:n], self.arena.valid[i][:n])
                        for i in self.key_indices]
            self.kernel.rebuild(
                self.key_codec.build_arrays(key_cols), new_refs,
                payload=self.payload_from_arena(new_refs)
                if self.pay_indices else None)
        else:
            self.kernel.rebuild(
                np.zeros((0, LANES_PER_KEY * len(self.key_indices)),
                         dtype=np.int32), new_refs)

    def recover(self) -> None:
        """Reload the arena and the device chains from the state
        table."""
        rows = [row for _pk, row in self.table.iter_rows()]
        if not rows:
            return
        n = len(rows)
        refs = self.alloc_refs(n)
        self.arena.ensure(int(refs.max()))
        for i, f in enumerate(self.schema):
            col_vals = [r[i] for r in rows]
            if f.data_type.is_device:
                ok = np.asarray([v is not None for v in col_vals])
                vals = np.asarray(
                    [0 if v is None else v for v in col_vals],
                    dtype=f.data_type.np_dtype)
                self.arena.cols[i][refs] = vals
                self.arena.valid[i][refs] = ok
            else:
                self.arena.cols[i][refs] = np.asarray(col_vals,
                                                      dtype=object)
        keys_l = []
        for row, ref in zip(rows, refs.tolist()):
            self.pk_to_ref[tuple(row[i] for i in self.pk_indices)] = ref
            keys_l.append(self.key_codec.lanes_of_values(
                [row[i] for i in self.key_indices]))
        # rows with NULL join keys were never stored on the device
        keep = [j for j, row in enumerate(rows)
                if all(row[i] is not None for i in self.key_indices)]
        if keep:
            self.kernel.rebuild(
                np.stack([keys_l[j] for j in keep]), refs[keep],
                payload=self.payload_from_arena(refs[keep])
                if self.pay_indices else None)


class HashJoinExecutor(Executor):
    """Streaming inner equi-join (hash_join.rs:227, device matcher)."""

    def __init__(self, left: Executor, right: Executor,
                 left_keys: Sequence[int], right_keys: Sequence[int],
                 left_table: StateTable, right_table: StateTable,
                 actor_id: int = 0,
                 output_names: Optional[Sequence[str]] = None,
                 join_type: JoinType = JoinType.INNER,
                 mesh=None, shard_opts: Optional[dict] = None,
                 state_cap: Optional[int] = None,
                 device_payload: bool = True,
                 epoch_batch: Optional[bool] = None,
                 device=None):
        if join_type != JoinType.INNER:
            raise NotImplementedError(
                f"{join_type.value} join is not ported (inner only)")
        if state_cap is not None:
            raise NotImplementedError("HashJoinExecutor state_cap (cold "
                                      "tier) is not ported")
        if mesh is not None and not isinstance(mesh, ShardMesh):
            raise TypeError(f"HashJoinExecutor takes a ShardMesh, got "
                            f"{mesh!r}")
        if epoch_batch is False and mesh is None:
            raise ValueError(
                "epoch_batch=False is the sharded per-chunk arm: it needs a "
                "mesh (the single-device kernel is epoch-only)")
        assert len(left_keys) == len(right_keys)
        device = resolve_device(device)
        if mesh is not None and mesh.device != device:
            raise ValueError(f"the mesh is on {mesh.device}, the join on "
                             f"{device}")
        self.left_in, self.right_in = left, right
        self.join_type = join_type
        key_codec = KeyCodec([left.schema[i].data_type for i in left_keys])
        self.sides = (
            _JoinSide(left.schema, left_keys, left_table.pk_indices,
                      left_table, key_codec, shard_opts, device, mesh,
                      device_payload),
            _JoinSide(right.schema, right_keys, right_table.pk_indices,
                      right_table, key_codec, shard_opts, device, mesh,
                      device_payload),
        )
        n_left = len(left.schema)
        names = list(output_names) if output_names else None
        fields = []
        k = 0
        for sch in (left.schema, right.schema):
            for f in sch:
                fields.append(Field(names[k] if names else f.name,
                                    f.data_type))
                k += 1
        # output pk: both sides' pks (joined row identity)
        pk = list(left_table.pk_indices) + \
            [n_left + i for i in right_table.pk_indices]
        super().__init__(ExecutorInfo(
            Schema(fields), pk,
            f"HashJoinExecutor({join_type.value}, actor={actor_id})"))
        self.n_left = n_left
        self._epoch_batch = epoch_batch is not False
        # message sequence (sequence-versioned device state) + the
        # epoch's buffered chunks (per-chunk arm: pending probes)
        self._seq = 1
        self._pending: List[tuple] = []
        self._epoch_buf: tuple = ([], [])
        self._epoch_rows = [0, 0]

    # -- emission ---------------------------------------------------------
    @staticmethod
    def _chunk_cols(schema: Schema, chunk: StreamChunk,
                    idx: np.ndarray, cap: int) -> List[Column]:
        """Columns gathered from incoming-chunk rows `idx`."""
        t = len(idx)
        out: List[Column] = []
        for f, c in zip(schema, chunk.columns):
            src = np.asarray(c.values)[idx]
            vals = np.zeros(cap, dtype=src.dtype) if src.dtype != object \
                else np.empty(cap, dtype=object)
            vals[:t] = src
            ok = np.ones(cap, dtype=bool)
            if c.validity is not None:
                ok[:t] = np.asarray(c.validity)[idx]
            out.append(Column(f.data_type, vals,
                              None if ok.all() else ok))
        return out

    def _compose(self, side_idx: int, my_cols: List[Column],
                 other_cols: List[Column], ops: np.ndarray,
                 t: int, cap: int) -> StreamChunk:
        columns = my_cols + other_cols if side_idx == 0 \
            else other_cols + my_cols
        out_vis = np.zeros(cap, dtype=bool)
        out_vis[:t] = True
        full_ops = np.full(cap, int(Op.INSERT), dtype=np.int8)
        full_ops[:t] = ops[:t]
        return StreamChunk(self.schema, columns, out_vis, full_ops)

    @staticmethod
    def _ops_of(chunk: StreamChunk, idx: np.ndarray) -> np.ndarray:
        """Degrade update pairs (split halves) to Delete/Insert."""
        in_ops = np.asarray(chunk.ops)[idx]
        is_ins = (in_ops == int(Op.INSERT)) | \
            (in_ops == int(Op.UPDATE_INSERT))
        return np.where(is_ins, int(Op.INSERT),
                        int(Op.DELETE)).astype(np.int8)

    def _pairs_chunk(self, side_idx: int, chunk: StreamChunk,
                     probe_idx: np.ndarray, refs: np.ndarray,
                     pay: Optional[np.ndarray]) -> StreamChunk:
        t = len(probe_idx)
        cap = next_pow2(t)
        me = self.sides[side_idx]
        other = self.sides[1 - side_idx]
        # matched stored rows: device columns decode from the payload
        # lanes the probe's emit walk gathered on the card; only
        # host-typed columns gather from the arena by ref
        if pay is not None:
            other_cols = other.cols_from_payload(pay, refs, cap)
        else:
            other_cols = [other.arena.gather_col(i, refs, cap)
                          for i in range(len(other.schema))]
        return self._compose(
            side_idx, self._chunk_cols(me.schema, chunk, probe_idx, cap),
            other_cols, self._ops_of(chunk, probe_idx), t, cap)

    # -- fragment fusion (frontend/opt/fusion.py adopts on a copy) --------
    def adopt_fused_input(self, side_idx: int, fs, base: Executor) -> None:
        """Absorb a filter/project/row_id_gen run on one input side:
        ``base`` becomes the direct input and ``fs`` (whose out_schema
        must equal the side schema this join was planned on) runs as a
        numpy pass for host bookkeeping plus ``join_prelude`` on the card
        at each epoch dispatch. Only valid before any data flows."""
        from risingwave_tpu_torch.frontend.opt.fusion import (
            join_side_fusable_reason,
        )
        r = join_side_fusable_reason(self, side_idx)
        if r is not None:
            raise ValueError(f"join side is not fusion-eligible: {r}")
        side = self.sides[side_idx]
        got = [f.data_type for f in fs.out_schema]
        want = [f.data_type for f in side.schema]
        if got != want:
            raise ValueError(f"fused input run emits {got}, join side "
                             f"planned on {want}")
        side.fused_input = fs
        side._prog = None
        if side_idx == 0:
            self.left_in = base
        else:
            self.right_in = base

    def _run_fused_input(self, side_idx: int, chunk: StreamChunk):
        """The host half of a fused input side: augment (runtime
        columns), run the composed chain ONCE on numpy, reattach host
        passthrough columns, and encode the raw matrix the epoch
        dispatch uploads. Returns (post_chunk, raw) or None when every
        row filtered out."""
        from risingwave_tpu_torch.ops.fused import encode_raw_chunk
        fs = self.sides[side_idx].fused_input
        aug = fs.augment(chunk)
        out_cols, vis2, ops2, stage_rows = fs.chain_body(
            list(aug.columns), np.asarray(aug.visibility),
            np.asarray(aug.ops), host_same=fs.host_noop_eq(aug))
        fs.note_stage_rows(stage_rows, 1)
        if not vis2.any():
            return None
        cols: List[Column] = []
        for j, f in enumerate(fs.out_schema):
            host_src = fs.host_out.get(j)
            if host_src is not None:
                src = aug.columns[host_src]
                cols.append(Column(f.data_type, src.values, src.validity))
            else:
                cols.append(out_cols[j])
        post = StreamChunk(fs.out_schema, cols, vis2, ops2)
        return post, encode_raw_chunk(aug, fs.ref_cols)

    def _ingest_chunk(self, side_idx: int, chunk: StreamChunk,
                      key_lanes: Optional[np.ndarray], nonnull: np.ndarray,
                      raw: Optional[np.ndarray] = None) -> None:
        """Host bookkeeping per chunk; the device work buffers for the
        ONE epoch dispatch at the barrier (sequence versioning keeps the
        batched probes exact per row), or, on the per-chunk arm,
        dispatches one apply_and_probe now and collects it at the
        barrier. A fused side buffers its raw matrix instead of lanes."""
        me = self.sides[side_idx]
        seq = self._seq
        self._seq += 1
        probe_vis = np.asarray(chunk.visibility) & nonnull
        (_ins_idx, ins_refs, full_refs, ins_mask, del_refs,
         del_mask) = me.apply_chunk_host(chunk, nonnull)
        if not self._epoch_batch:
            # ins/del entries exist only at storable (= probe-visible)
            # rows, so one mask decides both dispatch and collect
            handle = None
            if probe_vis.any():
                handle = me.kernel.apply_and_probe(
                    self.sides[1 - side_idx].kernel, key_lanes, probe_vis,
                    full_refs, ins_mask, del_refs, del_mask, seq)
            self._pending.append((side_idx, chunk, handle, 0,
                                  chunk.capacity))
            return
        dn = chunk.capacity
        ops = np.asarray(chunk.ops)
        neg = (ops != int(Op.INSERT)) & (ops != int(Op.UPDATE_INSERT))
        aux = np.zeros((dn, 4), dtype=np.int32)
        aux[:, 0] = full_refs[:dn]
        aux[:, 1] = del_refs[:dn]
        aux[:, 2] = (probe_vis[:dn] * FLAG_PROBE
                     + ins_mask[:dn] * FLAG_INS
                     + del_mask[:dn] * FLAG_DEL + neg[:dn] * FLAG_NEG)
        aux[:, 3] = seq
        off = self._epoch_rows[side_idx]
        self._pending.append((side_idx, chunk, None, off, dn))
        if raw is not None:
            # fused side: the RAW int64 matrix is the upload; the side's
            # join_prelude builds [key | payload] lanes on the card
            up = raw[:dn]
        elif me.pay_indices:
            # [key lanes | payload lanes]: ONE upload matrix per side per
            # epoch carries both
            up = np.concatenate([key_lanes[:dn],
                                 me.payload_rows(chunk)[:dn]], axis=1)
        else:
            up = key_lanes[:dn]
        owners = None
        if me.mesh is not None:
            # per-row owner shards for the skew-exact routing bucket; a
            # fused side builds its key lanes from the post chunk here
            lanes_o = key_lanes if key_lanes is not None else \
                me.key_codec.build(chunk, me.key_indices)
            owners = me.kernel.owners_of(np.asarray(lanes_o)[:dn])
        self._epoch_buf[side_idx].append(
            (up, aux, int(ins_refs.max()) if len(ins_refs) else -1, owners))
        self._epoch_rows[side_idx] = off + dn

    def _dispatch_epoch(self) -> Dict[int, tuple]:
        """Ship each side's buffered epoch as one upload + one apply +
        one probe dispatch, then collect both probes. Returns {side:
        (deg|None, probe_idx, refs, pay, old_deg)} in the CONCATENATED
        row space; _emit_pending slices per chunk by offset."""
        devs: Dict[int, tuple] = {}
        for s in (0, 1):
            buf = self._epoch_buf[s]
            if not buf:
                continue
            total = self._epoch_rows[s]
            cap = next_pow2(total)
            # fused sides buffer int64 raw matrices, others int32 lanes
            up = np.zeros((cap, buf[0][0].shape[1]), dtype=buf[0][0].dtype)
            aux = np.zeros((cap, 4), dtype=np.int32)
            side = self.sides[s]
            owners = None if side.mesh is None else \
                np.zeros(cap, dtype=np.int64)
            at = 0
            max_ref = -1
            for lan, a, mr, ow in buf:
                up[at:at + lan.shape[0]] = lan
                aux[at:at + a.shape[0]] = a
                if owners is not None:
                    owners[at:at + lan.shape[0]] = ow
                at += lan.shape[0]
                max_ref = max(max_ref, mr)
            # the sharded kernel pads to the shard count, runs its growth
            # guards and sizes the skew-exact routing bucket here
            kw = {}
            if side.mesh is None:
                up_dev, aux_dev = side.kernel.stage_epoch(up, aux, total,
                                                          max_ref)
            else:
                up_dev, aux_dev, kw["bucket"] = side.kernel.stage_epoch(
                    up, aux, total, max_ref, owners=owners)
            if side.fused_input is not None:
                # one prelude launch per side-epoch, before any routing
                # (its output is per row): its lanes feed both this side's
                # apply and its probe of the other side
                from risingwave_tpu_torch.ops.fused import join_prelude
                up_dev = join_prelude(side.prelude, up_dev)
            devs[s] = (up_dev, aux_dev, total, max_ref, kw)
        # both applies land before either probe dispatches: a probe at
        # seq s must see the other side's same-epoch rows with seq < s
        for s, (ld, ad, total, max_ref, kw) in devs.items():
            self.sides[s].kernel.apply_epoch(ld, ad, total, max_ref, **kw)
        # inner: both probes dispatch before either collects, so the two
        # device→host copies overlap; a probe routes by the PROBING side's
        # bucket
        probes = {s: self.sides[1 - s].kernel.probe_epoch(
            ld, ad, False, sink=self.sides[s].kernel, **kw)
            for s, (ld, ad, _t, _m, kw) in devs.items()}
        return {s: p.collect() for s, p in probes.items()}

    def _emit_pending(self) -> List[StreamChunk]:
        """Barrier sweep: collect the epoch's probes and emit in message
        order."""
        outs: List[StreamChunk] = []
        results = self._dispatch_epoch() \
            if (self._epoch_buf[0] or self._epoch_buf[1]) else {}
        for side_idx, chunk, handle, off, dn in self._pending:
            probe_idx = np.zeros(0, dtype=np.int32)
            refs = np.zeros(0, dtype=np.int32)
            pay = None
            if handle is not None:
                _d, probe_idx, refs = handle.collect()
            elif side_idx in results:
                _d, p_s, r_s, pay_s, _old = results[side_idx]
                lo = np.searchsorted(p_s, off)
                hi = np.searchsorted(p_s, off + dn)
                probe_idx = (p_s[lo:hi] - off).astype(np.int32)
                refs = r_s[lo:hi]
                if pay_s is not None:
                    pay = pay_s[lo:hi]
            outs.extend(self._emit_one(side_idx, chunk, probe_idx, refs,
                                       pay))
        self._pending.clear()
        self._epoch_buf = ([], [])
        self._epoch_rows = [0, 0]
        return outs

    def _emit_one(self, side_idx: int, chunk: StreamChunk,
                  probe_idx: np.ndarray, refs: np.ndarray,
                  pay: Optional[np.ndarray]) -> List[StreamChunk]:
        """Emission per eq_join_oneside (hash_join.rs:990), inner
        branch: the matched pairs."""
        if not len(probe_idx):
            return []
        return [self._pairs_chunk(side_idx, chunk, probe_idx, refs, pay)]

    # -- watermarks -------------------------------------------------------
    def _on_watermark(self, side_idx: int, msg: Watermark) -> None:
        """Join-key watermarks drive state expiry in the reference, which
        is not ported; non-key watermarks are dropped (reference
        behavior)."""
        if msg.col_idx in self.sides[side_idx].key_indices:
            raise NotImplementedError(
                "join-key watermarks (state expiry) are not ported")

    # interner GC gate: skip below this many entries, and while entries
    # ≤ 2× live refs (GC cost is O(live))
    INTERNER_GC_MIN = 4096

    def _maybe_gc_interner(self) -> None:
        """Retire interner entries no stored row references."""
        codec = self.sides[0].key_codec
        if not codec.interners:
            return
        total = codec.interner_entries()
        live_refs = sum(len(s.pk_to_ref) for s in self.sides)
        if total < self.INTERNER_GC_MIN or \
                total <= 2 * live_refs * len(codec.interners):
            return
        for pos, it in codec.interners.items():
            vals: List[object] = []
            for side in self.sides:
                col = side.key_indices[pos]
                if not side.pk_to_ref:
                    continue
                refs = np.fromiter(side.pk_to_ref.values(),
                                   dtype=np.int64,
                                   count=len(side.pk_to_ref))
                ok = side.arena.valid[col][refs]
                vals.extend(side.arena.cols[col][refs][ok].tolist())
            it.gc(vals)

    # -- main loop --------------------------------------------------------
    async def execute(self) -> AsyncIterator[Message]:
        lit = self.left_in.execute()
        rit = self.right_in.execute()
        first_l = await lit.__anext__()
        first_r = await rit.__anext__()
        assert is_barrier(first_l) and is_barrier(first_r)
        assert first_l.epoch == first_r.epoch
        for side in self.sides:
            side.table.init_epoch(first_l.epoch)
            side.recover()
        yield first_l
        async for tag, msg in barrier_align_2(lit, rit):
            if tag == "barrier":
                # consume pending probes FIRST: compaction rebuilds device
                # state a re-dispatched probe would need
                for out in self._emit_pending():
                    yield out
                for side in self.sides:
                    if side.mesh is not None:
                        # the apply steps' lazily fetched overflow flags
                        side.kernel.drain_overflows()
                    side.table.commit(msg.epoch)
                    side.maybe_compact()
                    if side.fused_input is not None:
                        # absorbed-runtime barrier work (row-id counters
                        # rebase to the epoch floor)
                        side.fused_input.on_barrier(msg)
                self._maybe_gc_interner()
                if self._seq > (1 << 30):
                    # int32 sequence headroom: with no probes in flight,
                    # rebase every finite seq to 0 and restart
                    for side in self.sides:
                        side.kernel.rebase_seq()
                    self._seq = 1
                yield msg
            else:
                i = 0 if tag == "left" else 1
                side = self.sides[i]
                if isinstance(msg, StreamChunk):
                    if side.fused_input is not None:
                        r = self._run_fused_input(i, msg)
                        if r is not None:
                            post, raw = r
                            self._ingest_chunk(
                                i, post, None,
                                side.key_nonnull_mask(post), raw=raw)
                        continue
                    lanes_np, nonnull = side.key_codec.build_with_mask(
                        msg, side.key_indices)
                    self._ingest_chunk(i, msg, lanes_np, nonnull)
                elif isinstance(msg, Watermark):
                    # a fused side receives watermarks in the run's input
                    # space: derive them through the absorbed stages
                    derived = [msg] if side.fused_input is None \
                        else side.fused_input.derive_watermarks(msg)
                    for one in derived:
                        self._on_watermark(i, one)
