"""HashJoinExecutor: streaming two-sided equi-join on the device matcher.

Port of ``risingwave_tpu/stream/executors/hash_join.py`` (reference
parity: src/stream/src/executor/hash_join.rs:227 executor, :697 main loop
over barrier-aligned sides, :990 ``eq_join_oneside``; state layout
managed_state/join/mod.rs:228). The device owns the MATCH structure
(``ops/hash_join.py``: key table + row chains + payload lanes + degrees);
the host owns row payloads of host-typed columns (varchar never ships to
the device) and materializes output chunks with vectorized gathers.

Chunk lifecycle on side S (probing side O):
  1. ingest: host bookkeeping (pk → row ref, arena), and the chunk's
     [key lanes | payload lanes] and aux rows buffered for the epoch;
  2. barrier: evicted keys the epoch's probes need reload first (the cold
     tier); each side's buffered epoch ships as one upload, one apply
     dispatch (K1 + K5) and one probe dispatch against the other side
     (K6); the probes are collected (sequence versioning makes every
     row's result exact for its own message) and emitted in message
     order: matched pairs, outer NULL-padding, semi/anti rows and
     degree-transition flips. Update pairs degrade to Delete+Insert, as
     the reference degrades split pairs;
  3. join-key watermark expiry (K5 tombstones), both sides' StateTables
     commit, then the cold tier's sweep or a compaction (a rebuild: K1 +
     K5 + K7, degrees carried through K7) once dead refs dominate.
     Recovery rebuilds arena + chains and recomputes degrees with one
     batch probe (K6) and K7.

Join types (``JoinType``): all 8. Outer, semi and anti joins track a
match DEGREE per stored row of their tracked sides. On one device the
degree array lives on the card and the epoch probe (``join_probe_deg``)
updates it; emission replays each chunk's transitions from the probe
matrix's pre-epoch column. With a mesh the degrees are a host array.

Inner-join NULL semantics: rows whose join key contains NULL never match
and are not stored; an outer side emits them NULL-padded, an anti join
emits them.

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

``state_cap`` (the cold tier, ``state/tier.py``) caps each side's
resident join keys on one device for inner and outer joins whose state
tables' pks start with the join keys, as the reference does. Metrics,
hot-key sketches and dispatch spans are left out.
"""

from __future__ import annotations

import enum
import weakref
from typing import AsyncIterator, Dict, List, Optional, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk, next_pow2
from risingwave_tpu_torch.common.types import Field, Schema
from risingwave_tpu_torch.ops import lanes as _lanes
from risingwave_tpu_torch.ops.hash_join import (
    AUX_FLAGS, AUX_INS_REF, FLAG_DEL, FLAG_INS, FLAG_NEG, FLAG_PROBE,
    JoinSideKernel,
)
from risingwave_tpu_torch.parallel.join import ShardedJoinKernel
from risingwave_tpu_torch.parallel.mesh import ShardMesh
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.executors.keys import LANES_PER_KEY, KeyCodec
from risingwave_tpu_torch.stream.merge import barrier_align_2
from risingwave_tpu_torch.stream.message import Message, Watermark, is_barrier
from risingwave_tpu_torch.utils.device import resolve_device, upload
from risingwave_tpu_torch.utils.metrics import STREAMING as _METRICS


class JoinType(enum.Enum):
    """The 8 streaming join types (hash_join.rs:61-71 const generics).

    Outer sides track per-stored-row match DEGREES. The reference
    persists degree state tables (managed_state/join/mod.rs:228); here
    degrees are recomputed on recovery by one batch probe of the
    recovered keys against the other side: the degree is a pure function
    of both sides' state."""

    INNER = "inner"
    LEFT_OUTER = "left_outer"
    RIGHT_OUTER = "right_outer"
    FULL_OUTER = "full_outer"
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"
    RIGHT_SEMI = "right_semi"
    RIGHT_ANTI = "right_anti"

    @property
    def is_semi_or_anti(self) -> bool:
        return self in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI,
                        JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI)

    @property
    def is_anti(self) -> bool:
        return self in (JoinType.LEFT_ANTI, JoinType.RIGHT_ANTI)

    @property
    def subject(self) -> Optional[int]:
        """Side whose rows a semi/anti join emits (0=left, 1=right)."""
        if self in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            return 0
        if self in (JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI):
            return 1
        return None

    @property
    def tracked_sides(self) -> tuple:
        """Sides whose stored rows need degree maintenance."""
        if self == JoinType.LEFT_OUTER:
            return (0,)
        if self == JoinType.RIGHT_OUTER:
            return (1,)
        if self == JoinType.FULL_OUTER:
            return (0, 1)
        if self.is_semi_or_anti:
            return (self.subject,)
        return ()

    def outer_on(self, side: int) -> bool:
        """Does `side` emit NULL-padded rows when unmatched?"""
        if self == JoinType.FULL_OUTER:
            return True
        return (self == JoinType.LEFT_OUTER and side == 0) or \
            (self == JoinType.RIGHT_OUTER and side == 1)


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

    def store_rows(self, refs: np.ndarray, rows: List[tuple],
                   schema: Schema) -> None:
        """Python rows (state-table reads) into the arena at ``refs``."""
        self.ensure(int(refs.max()))
        for i, f in enumerate(schema):
            col_vals = [r[i] for r in rows]
            if f.data_type.is_device:
                self.cols[i][refs] = np.asarray(
                    [0 if v is None else v for v in col_vals],
                    dtype=f.data_type.np_dtype)
                self.valid[i][refs] = [v is not None for v in col_vals]
            else:
                # host-typed columns carry NULL as the None object
                self.cols[i][refs] = np.asarray(col_vals, dtype=object)
                self.valid[i][refs] = True

    def gather(self, refs: np.ndarray, out_cap: int) -> List[Column]:
        return [self.gather_col(i, refs, out_cap)
                for i in range(len(self.schema))]

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
        self.key_types = [schema[i].data_type for i in self.key_indices]
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
        # the cold tier (state/tier.py): the tier's sweep hands this side
        # its coldest keys, whose rows leave the arena and the card but
        # stay durable in the state table; a later probe of an evicted
        # key reloads it first (HashJoinExecutor._reload_cold).
        # cold_keys: key lanes tuple → key values tuple (the values drive
        # the state-table prefix scan on reload)
        self.state_cap: Optional[int] = None
        self.cold_keys: Dict[tuple, tuple] = {}
        # lanes of keys watermark expiry dropped (resident and cold): the
        # executor drains them into tier.forget after each sweep
        self.expired_lanes: List[tuple] = []
        # per-ref match degree (outer/semi/anti). On one device the
        # authoritative copy is the kernel's device array, updated by the
        # epoch probe (K6 with degrees); this host array then stays empty
        # and emission replays per-chunk transitions from the matrix's
        # pre-epoch column. The sharded path keeps the host array.
        self.dev_degrees = mesh is None
        self.track_degrees = False      # set by the executor (tracked
        self.degrees = np.zeros(         # sides only)
            0 if self.dev_degrees else self.arena.cap, dtype=np.int64)

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

    def _row_key_lanes(self, chunk: StreamChunk, r: int
                       ) -> Optional[tuple]:
        """One row's join-key lanes tuple (the cold_keys key), or None
        when any key column is NULL: null keys are never stored, so they
        cannot be cold. Miss path only (rare)."""
        vals = []
        for i in self.key_indices:
            c = chunk.columns[i]
            if c.validity is not None and \
                    not bool(np.asarray(c.validity)[r]):
                return None
            v = np.asarray(c.values)[r]
            vals.append(v.item() if hasattr(v, "item") else v)
        if any(v is None for v in vals):
            return None
        return tuple(self.key_codec.lanes_of_values(vals).tolist())

    def ensure_degrees(self, max_ref: int) -> None:
        """Grow the host degree array (mesh) to the arena's capacity."""
        if self.dev_degrees or max_ref < len(self.degrees):
            return
        grown = np.zeros(self.arena.cap, dtype=np.int64)
        grown[:len(self.degrees)] = self.degrees
        self.degrees = grown

    def live_refs(self) -> np.ndarray:
        return np.fromiter(self.pk_to_ref.values(), dtype=np.int64,
                           count=len(self.pk_to_ref))

    def key_cols_of(self, refs: np.ndarray) -> list:
        """(values, valid) of each join-key column at ``refs``."""
        return [(self.arena.cols[i][refs], self.arena.valid[i][refs])
                for i in self.key_indices]

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
        """Payload lanes of stored rows (recovery, compaction and reload
        rebuild the device store from the host copy)."""
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

    def row_tuple(self, ref: int) -> tuple:
        return tuple(
            None if not self.arena.valid[i][ref]
            else (self.arena.cols[i][ref].item()
                  if self.schema[i].data_type.is_device
                  else self.arena.cols[i][ref])
            for i in range(len(self.schema)))

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
                    continue
                ref = self.pk_to_ref.pop(pks[r], None)
                if ref is None:
                    # an unseen pk: an inconsistent delete (ignored, as
                    # the reference ignores it) or, with the cold tier
                    # on, a retraction for an EVICTED key, whose device
                    # bookkeeping cannot be applied: the cold tier needs
                    # append-only inputs, and failing loud beats leaving
                    # already-emitted join outputs stale
                    if self.cold_keys and \
                            self._row_key_lanes(chunk, r) in self.cold_keys:
                        raise RuntimeError(
                            "join cold-state tier got a retraction for an "
                            "evicted key: state_cap requires append-only "
                            "inputs")
                    continue
                del_refs[r] = ref
                del_mask[r] = True
                self.free.append(ref)
        full_refs = np.zeros(chunk.capacity, dtype=np.int32)
        ins_mask = np.zeros(chunk.capacity, dtype=bool)
        if len(ins_idx):
            self.arena.store(ins_refs, chunk, ins_idx)
            self.ensure_degrees(int(ins_refs.max()))
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
        refs). Degrees survive: on one device the rebuild carries them on
        the card from the old degree array into the fresh one (K7's
        gather at the live refs, no host round trip); a mesh moves its
        host array."""
        live = self.live_refs()
        n = len(live)
        new_arena = _Arena(self.schema,
                           capacity=max(1024, next_pow2(max(n, 1))))
        for i in range(len(self.schema)):
            new_arena.cols[i][:n] = self.arena.cols[i][live]
            new_arena.valid[i][:n] = self.arena.valid[i][live]
        if not self.dev_degrees:
            new_degrees = np.zeros(new_arena.cap, dtype=np.int64)
            new_degrees[:n] = self.degrees[live]
            self.degrees = new_degrees
        self.arena = new_arena
        new_refs = np.arange(n, dtype=np.int32)
        self.pk_to_ref = dict(zip(self.pk_to_ref.keys(), new_refs.tolist()))
        self.free = []
        self.next_ref = n
        if n:
            self.kernel.rebuild(
                self.key_codec.build_arrays(self.key_cols_of(new_refs)),
                new_refs, payload=self.payload_from_arena(new_refs)
                if self.pay_indices else None,
                carry=live if self.dev_degrees and self.track_degrees
                else None)
        else:
            self.kernel.rebuild(
                np.zeros((0, LANES_PER_KEY * len(self.key_indices)),
                         dtype=np.int32), new_refs)

    def expire_below(self, key_pos: int, wm_physical, seq: int = 0) -> int:
        """Watermark state expiry (hash_join.rs:860-945 analog): drop
        every stored row whose ``key_pos``-th join-key column is below
        the watermark: their pks leave the map, their rows the state
        table, and their refs are tombstoned on the card at ``seq`` (K5;
        on a mesh each tombstone routes to its key's owner shard). Cold
        keys below the watermark expire too: their durable rows delete
        and the cold marker drops. Returns the rows expired."""
        n_cold = 0
        if self.cold_keys:
            dead_cold = [(lt, vt) for lt, vt in self.cold_keys.items()
                         if vt[key_pos] is not None
                         and int(vt[key_pos]) < int(wm_physical)]
            for lt, vt in dead_cold:
                del self.cold_keys[lt]
                self.expired_lanes.append(lt)
                dead_rows = [tuple(row) for _pk, row
                             in self.table.iter_prefix(list(vt))]
                if dead_rows:
                    self.table.delete_rows(dead_rows)
                    n_cold += len(dead_rows)
        if not self.pk_to_ref:
            return n_cold
        col = self.key_indices[key_pos]
        refs = self.live_refs()
        vals = self.arena.cols[col][refs]
        ok = self.arena.valid[col][refs]
        dead = ok & (vals.astype(np.int64) < int(wm_physical))
        n_dead = int(dead.sum())
        if n_dead == 0:
            return n_cold
        dead_refs = refs[dead].astype(np.int32)
        pks = list(self.pk_to_ref.keys())
        for j, ref in zip(np.flatnonzero(dead).tolist(), dead_refs.tolist()):
            del self.pk_to_ref[pks[j]]
            self.free.append(ref)
        self.table.delete_rows([self.row_tuple(r)
                                for r in dead_refs.tolist()])
        cap = next_pow2(n_dead)
        del_refs = np.zeros(cap, dtype=np.int32)
        del_refs[:n_dead] = dead_refs
        mask = np.zeros(cap, dtype=bool)
        mask[:n_dead] = True
        dead_lanes = self.key_codec.build_arrays(self.key_cols_of(dead_refs))
        if self.state_cap is not None:
            # tier bookkeeping only: an uncapped side has nothing to forget
            self.expired_lanes.extend(
                map(tuple, np.unique(dead_lanes, axis=0).tolist()))
        lanes_ = np.zeros((cap, dead_lanes.shape[1]), dtype=np.int32)
        lanes_[:n_dead] = dead_lanes
        self.kernel.delete(del_refs, mask, seq=seq, key_lanes=lanes_)
        return n_dead + n_cold

    def evict_keys(self, lanes_ts: Sequence[tuple]) -> Tuple[int, int]:
        """Targeted cold-tier eviction (the tier's sweep callback): every
        row of each given key leaves the arena and the card together (a
        probe must see all or none) but stays durable in the state
        table. Returns (keys evicted, rows evicted). The tier calls it at
        this executor's own checkpoint barrier, with no probe in
        flight."""
        want = set(lanes_ts)
        if not want or not self.pk_to_ref:
            return 0, 0
        pks = list(self.pk_to_ref.keys())
        refs = self.live_refs()
        key_cols = self.key_cols_of(refs)
        lane_rows = list(map(tuple, self.key_codec.build_arrays(key_cols)
                             .tolist()))
        evicted = 0
        vt_by_lane: Dict[tuple, tuple] = {}
        for j, lt in enumerate(lane_rows):
            if lt not in want:
                continue
            if lt not in vt_by_lane:
                vt = tuple(None if not ok[j] else
                           (v[j].item() if hasattr(v[j], "item") else v[j])
                           for v, ok in key_cols)
                if any(x is None for x in vt):
                    continue       # null-key rows are never stored
                vt_by_lane[lt] = vt
            self.free.append(self.pk_to_ref.pop(pks[j]))
            evicted += 1
        self.cold_keys.update(vt_by_lane)
        if evicted:
            # compaction rebuilds arena and card from the survivors; the
            # evicted rows' degrees drop with them (recomputed on reload)
            self.compact()
        return len(vt_by_lane), evicted

    def reload_keys(self, need: Dict[tuple, tuple]) -> Optional[tuple]:
        """Reload evicted keys' rows from the state table (arena, pk_to_ref
        and the upload of a device insert at seq 0, visible to every
        probe). Returns (lanes, aux, n, max_ref) for the device apply, or
        None when nothing reloaded."""
        rows: List[tuple] = []
        lanes_rows: List[tuple] = []
        for lanes_t, values_t in need.items():
            if lanes_t not in self.cold_keys:
                continue
            del self.cold_keys[lanes_t]
            for _pk, row in self.table.iter_prefix(list(values_t)):
                row = tuple(row)
                if tuple(row[i] for i in self.pk_indices) in self.pk_to_ref:
                    # a row inserted AFTER the key went cold is already
                    # resident: re-adding it would double its matches
                    continue
                rows.append(row)
                lanes_rows.append(lanes_t)
        if not rows:
            return None
        n = len(rows)
        refs = self.alloc_refs(n)
        self.arena.store_rows(refs, rows, self.schema)
        self.ensure_degrees(int(refs.max()))
        for row, ref in zip(rows, refs.tolist()):
            self.pk_to_ref[tuple(row[i] for i in self.pk_indices)] = ref
        cap = next_pow2(n)
        w = LANES_PER_KEY * len(self.key_indices)
        up = np.zeros((cap, w + 3 * len(self.pay_indices)), dtype=np.int32)
        up[:n, :w] = np.asarray(lanes_rows, dtype=np.int32)
        if self.pay_indices:
            # the reloaded rows' payload lanes rebuild from the arena copy
            # just stored: the same scatter shape as a live insert
            up[:n, w:] = self.payload_from_arena(refs)
        aux = np.zeros((cap, 4), dtype=np.int32)
        aux[:n, 0] = refs
        aux[:n, 2] = FLAG_INS
        # seq 0: reloaded rows predate every live sequence, so every
        # probe of this epoch sees them
        return up, aux, n, int(refs.max())

    def recover(self) -> None:
        """Reload the arena and the device chains from the state
        table."""
        rows = [row for _pk, row in self.table.iter_rows()]
        if not rows:
            return
        refs = self.alloc_refs(len(rows))
        self.arena.store_rows(refs, rows, self.schema)
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
    """Streaming equi-join of all 8 join types (hash_join.rs:227, device
    matcher)."""

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
        if mesh is not None and not isinstance(mesh, ShardMesh):
            raise TypeError(f"HashJoinExecutor takes a ShardMesh, got "
                            f"{mesh!r}")
        if epoch_batch is False and mesh is None:
            raise ValueError(
                "epoch_batch=False is the sharded per-chunk arm: it needs a "
                "mesh (the single-device kernel is epoch-only)")
        if state_cap is not None:
            # the cold tier's prerequisites, as the reference's: the
            # single-device epoch path (reload hooks the epoch dispatch),
            # an inner or outer join (semi/anti emission depends on
            # degree TRANSITIONS whose history an eviction would lose;
            # outer degrees recompute on reload), and state-table pks
            # prefixed by the join keys (reload prefix-scans by key)
            if join_type.is_semi_or_anti or mesh is not None:
                raise ValueError(
                    "state_cap needs an INNER or OUTER join on the "
                    "single-device epoch-batched path (semi/anti "
                    "degree-transition history cannot be evicted)")
            for keys, tbl in ((left_keys, left_table),
                              (right_keys, right_table)):
                if list(tbl.pk_indices[:len(keys)]) != list(keys):
                    raise ValueError(
                        "state_cap needs state-table pks prefixed by the "
                        f"join keys (reload prefix-scans by key): "
                        f"pk={list(tbl.pk_indices)} keys={list(keys)}")
        assert len(left_keys) == len(right_keys)
        device = resolve_device(device)
        if mesh is not None and mesh.device != device:
            raise ValueError(f"the mesh is on {mesh.device}, the join on "
                             f"{device}")
        self.left_in, self.right_in = left, right
        self.join_type = join_type
        # rebuild recipe for plan rewrites (frontend/opt): column pruning
        # reconstructs the join over narrowed inputs with this exact
        # configuration, on the same device
        self.rebuild_opts = {"actor_id": actor_id, "mesh": mesh,
                             "shard_opts": shard_opts,
                             "state_cap": state_cap,
                             "device_payload": device_payload,
                             "epoch_batch": epoch_batch, "device": device}
        key_codec = KeyCodec([left.schema[i].data_type for i in left_keys])
        self.sides = (
            _JoinSide(left.schema, left_keys, left_table.pk_indices,
                      left_table, key_codec, shard_opts, device, mesh,
                      device_payload),
            _JoinSide(right.schema, right_keys, right_table.pk_indices,
                      right_table, key_codec, shard_opts, device, mesh,
                      device_payload),
        )
        for i, side in enumerate(self.sides):
            side.track_degrees = i in join_type.tracked_sides
        n_left = len(left.schema)
        names = list(output_names) if output_names else None
        subj = join_type.subject
        if subj is not None:
            # semi/anti: the output is the subject side's schema alone
            src = (left if subj == 0 else right).schema
            fields = [Field(names[i] if names else f.name, f.data_type)
                      for i, f in enumerate(src)]
            pk = list((left_table if subj == 0 else right_table).pk_indices)
        else:
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
        # join-key watermarks (hash_join.rs:860-945): per side, the latest
        # watermark per key POSITION; the forwarded and cleaning watermark
        # is the min across sides, monotone
        self._side_wm: List[Dict[int, object]] = [{}, {}]
        self._combined_wm: Dict[int, object] = {}
        self._expired_wm: Dict[int, object] = {}
        # message sequence (sequence-versioned device state) + the
        # epoch's buffered chunks (per-chunk arm: pending probes)
        self._seq = 1
        self._pending: List[tuple] = []
        self._epoch_buf: tuple = ([], [])
        self._epoch_rows = [0, 0]
        self._deg_replay: List = [None, None]
        # the cold tier: one participant per side, registered at execute()
        # so plan-only executors leave no entry in the global registry
        self._tier = None
        self._tier_parts: Tuple = (None, None)
        self._tier_seq = 0
        if state_cap is not None:
            from risingwave_tpu_torch.state import tier as _tier_mod
            for side in self.sides:
                side.state_cap = int(state_cap)
            self._tier = _tier_mod.GLOBAL
            self._tier_cap = int(state_cap)

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

    @staticmethod
    def _null_cols(schema: Schema, cap: int) -> List[Column]:
        out: List[Column] = []
        for f in schema:
            dt = f.data_type
            vals = np.zeros(cap, dtype=dt.np_dtype) if dt.is_device \
                else np.empty(cap, dtype=object)
            out.append(Column(dt, vals, np.zeros(cap, dtype=bool)))
        return out

    def _out_chunk(self, columns: List[Column], ops: np.ndarray, t: int,
                   cap: int) -> StreamChunk:
        """An output chunk of `t` visible rows padded to `cap`."""
        out_vis = np.zeros(cap, dtype=bool)
        out_vis[:t] = True
        full_ops = np.full(cap, int(Op.INSERT), dtype=np.int8)
        full_ops[:t] = ops[:t]
        return StreamChunk(self.schema, columns, out_vis, full_ops)

    def _compose(self, side_idx: int, my_cols: List[Column],
                 other_cols: List[Column], ops: np.ndarray,
                 t: int, cap: int) -> StreamChunk:
        return self._out_chunk(my_cols + other_cols if side_idx == 0
                               else other_cols + my_cols, ops, t, cap)

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
            other_cols = other.arena.gather(refs, cap)
        return self._compose(
            side_idx, self._chunk_cols(me.schema, chunk, probe_idx, cap),
            other_cols, self._ops_of(chunk, probe_idx), t, cap)

    def _padded_from_chunk(self, side_idx: int, chunk: StreamChunk,
                           idx: np.ndarray) -> StreamChunk:
        """(row, NULLs) for unmatched rows of an outer incoming side."""
        cap = next_pow2(len(idx))
        return self._compose(
            side_idx,
            self._chunk_cols(self.sides[side_idx].schema, chunk, idx, cap),
            self._null_cols(self.sides[1 - side_idx].schema, cap),
            self._ops_of(chunk, idx), len(idx), cap)

    def _padded_from_arena(self, side_idx: int, refs: np.ndarray,
                           op: Op) -> StreamChunk:
        """(stored row, NULLs) for degree transitions of an outer side."""
        cap = next_pow2(len(refs))
        return self._compose(
            side_idx, self.sides[side_idx].arena.gather(refs, cap),
            self._null_cols(self.sides[1 - side_idx].schema, cap),
            np.full(cap, int(op), dtype=np.int8), len(refs), cap)

    def _subject_from_chunk(self, chunk: StreamChunk,
                            idx: np.ndarray) -> StreamChunk:
        cap = next_pow2(len(idx))
        cols = self._chunk_cols(
            self.sides[self.join_type.subject].schema, chunk, idx, cap)
        return self._out_chunk(cols, self._ops_of(chunk, idx), len(idx),
                               cap)

    def _subject_from_arena(self, refs: np.ndarray, op: Op
                            ) -> StreamChunk:
        cap = next_pow2(len(refs))
        cols = self.sides[self.join_type.subject].arena.gather(refs, cap)
        return self._out_chunk(cols, np.full(cap, int(op), np.int8),
                               len(refs), cap)

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
        if self._tier is not None and key_lanes is not None:
            rows = np.flatnonzero(probe_vis)
            if len(rows):
                uniq = list(map(tuple, np.unique(
                    np.asarray(key_lanes)[rows], axis=0).tolist()))
                # stored here: a full touch; the probe only REFRESHES the
                # other side's recency (a probed key the other side never
                # stored must not mint a phantom)
                self._tier.touch(self._tier_parts[side_idx], uniq,
                                 self._tier_seq)
                self._tier.touch(self._tier_parts[1 - side_idx], uniq,
                                 self._tier_seq, insert=False)
        (ins_idx, ins_refs, full_refs, ins_mask, del_refs,
         del_mask) = me.apply_chunk_host(chunk, nonnull)
        if not self._epoch_batch:
            # ins/del entries exist only at storable (= probe-visible)
            # rows, so one mask decides both dispatch and collect
            handle = None
            if probe_vis.any():
                handle = me.kernel.apply_and_probe(
                    self.sides[1 - side_idx].kernel, key_lanes, probe_vis,
                    full_refs, ins_mask, del_refs, del_mask, seq)
            self._pending.append((side_idx, chunk, nonnull, handle, ins_idx,
                                  ins_refs, 0, chunk.capacity))
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
        self._pending.append((side_idx, chunk, nonnull, None, ins_idx,
                              ins_refs, off, dn))
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
        self._reload_cold()
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
            # apply + probe = two device steps a side-epoch; a sharded
            # kernel counts its own routed steps
            if self.sides[s].mesh is None:
                _METRICS.device_dispatch.inc(2, executor=self.identity)
            self.sides[s].kernel.apply_epoch(ld, ad, total, max_ref, **kw)
        if self.join_type == JoinType.INNER:
            # inner: both probes dispatch before either collects, so the
            # two device→host copies overlap; a probe routes by the
            # PROBING side's bucket
            probes = {s: self.sides[1 - s].kernel.probe_epoch(
                ld, ad, False, sink=self.sides[s].kernel, **kw)
                for s, (ld, ad, _t, _m, kw) in devs.items()}
            return {s: p.collect() for s, p in probes.items()}
        # degree-tracked joins: each probe updates BOTH sides' device
        # degree arrays (transitions on the probed side, inserted-row
        # inits on the probing side), and a pair-buffer overflow
        # re-dispatches the first probe from its entry arrays, so probe 2
        # dispatches only after probe 1's collect installed its final
        # arrays: one sync point an epoch, tracked joins only
        out: Dict[int, tuple] = {}
        for s, (ld, ad, _t, _m, kw) in devs.items():
            out[s] = self.sides[1 - s].kernel.probe_epoch(
                ld, ad, True, sink=self.sides[s].kernel, **kw).collect()
        return out

    def _tier_register(self) -> None:
        """Register both sides with the global tier at execute() start:
        only executors that actually run appear in the registry."""
        sref = weakref.ref(self)
        parts = []
        for i in (0, 1):
            def _evict_cb(keys, _i=i):
                s = sref()
                return 0 if s is None else s.sides[_i].evict_keys(keys)[0]

            parts.append(self._tier.register(
                f"{self.identity}/side{i}#{id(self)}", _evict_cb,
                cap=self._tier_cap))
        self._tier_parts = tuple(parts)

    def _reload_cold(self) -> None:
        """Reload the evicted keys this epoch's probes will need, BEFORE
        the epoch's applies and probes dispatch (managed_state/join
        reload-on-miss, batched per barrier). The reload inserts (K1 +
        K5) at seq 0, so every probe of the epoch sees the reloaded rows.

        Tracked (outer) joins reload a needed key on BOTH sides: the
        reloaded rows' degrees recompute by probing the opposite side
        (K6, then K7 writes them), and a cold twin there would
        undercount. The recompute runs after both sides' reloads, against
        pre-epoch state; this epoch's own chunks then layer their degree
        deltas on top in message order (_emit_one step 3), exactly as if
        the rows had never left."""
        kw = LANES_PER_KEY * len(self.sides[0].key_indices)
        need: List[Dict[tuple, tuple]] = [{}, {}]
        for s in (0, 1):
            other = self.sides[1 - s]
            if not other.cold_keys or not self._epoch_buf[s]:
                continue
            for lan, aux, _mr, _ow in self._epoch_buf[s]:
                rows = np.flatnonzero(aux[:, 2] & FLAG_PROBE)
                # the buffered upload is [key lanes | payload lanes]:
                # cold-key lookups read the key slice only
                for t in map(tuple, lan[rows, :kw].tolist()):
                    v = other.cold_keys.get(t)
                    if v is not None:
                        need[1 - s][t] = v
        if self.join_type.tracked_sides:
            for s in (0, 1):
                twin = self.sides[s]
                if not twin.cold_keys:
                    continue
                for t in need[1 - s]:
                    v = twin.cold_keys.get(t)
                    if v is not None:
                        need[s][t] = v
        reloaded: List[Optional[tuple]] = [None, None]
        for s in (0, 1):
            if not need[s]:
                continue
            side = self.sides[s]
            loaded = side.reload_keys(need[s])
            if loaded is None:
                continue
            up, aux2, n, max_ref = loaded
            up_dev, aux_dev = side.kernel.stage_epoch(up, aux2, n, max_ref)
            side.kernel.apply_epoch(up_dev, aux_dev, n, max_ref)
            reloaded[s] = (up_dev, aux_dev, n)
            part = self._tier_parts[s]
            uniq = np.unique(up[:n, :kw], axis=0)
            self._tier.touch(part, map(tuple, uniq.tolist()),
                             self._tier_seq)
            # the tier's counters are in keys
            self._tier.note_reload(part, len(uniq))
        for t_side in self.join_type.tracked_sides:
            rl = reloaded[t_side]
            if rl is None:
                continue
            up_dev, aux_dev, n = rl
            # the reloaded rows' degrees, on the card from end to end (the
            # cold tier is one device only): the staged key lanes probe
            # the other side (every reloaded row's flags are FLAG_INS, so
            # the flags column is their visibility), and K6's degree
            # column is written at the staged refs
            deg = self.sides[1 - t_side].kernel.probe_degrees(
                up_dev[:n, :kw], aux_dev[:n, AUX_FLAGS])
            self.sides[t_side].kernel.write_degrees(
                aux_dev[:n, AUX_INS_REF], deg)

    def _emit_pending(self) -> List[StreamChunk]:
        """Barrier sweep: collect the epoch's probes and run emission in
        message order. Degree bookkeeping happens here, in the order the
        chunks were applied; on one device it replays from the probe
        matrix's pre-epoch degree column (the device array is the
        store; see _emit_one)."""
        outs: List[StreamChunk] = []
        results = self._dispatch_epoch() \
            if (self._epoch_buf[0] or self._epoch_buf[1]) else {}
        # the epoch's replay of stored-row degrees, per side: a value
        # array + written mask by ref, seeded lazily from the matrix's
        # old column, written through by inserted-row inits and
        # per-chunk transition deltas
        self._deg_replay = [None, None]
        for (side_idx, chunk, nonnull, handle, ins_idx, ins_refs, off,
             dn) in self._pending:
            n = chunk.capacity
            deg = None
            probe_idx = np.zeros(0, dtype=np.int32)
            refs = np.zeros(0, dtype=np.int32)
            pay = old = None
            if handle is not None:
                deg_p, probe_idx, refs = handle.collect()
                deg = np.zeros(n, dtype=np.int64)
                deg[:len(deg_p)] = deg_p
            elif side_idx in results:
                d_s, p_s, r_s, pay_s, old_s = results[side_idx]
                lo = np.searchsorted(p_s, off)
                hi = np.searchsorted(p_s, off + dn)
                probe_idx = (p_s[lo:hi] - off).astype(np.int32)
                refs = r_s[lo:hi]
                if pay_s is not None:
                    pay = pay_s[lo:hi]
                if old_s is not None:
                    old = old_s[lo:hi].astype(np.int64)
                if d_s is not None:
                    deg = np.zeros(n, dtype=np.int64)
                    deg[:dn] = d_s[off:off + dn]
            outs.extend(self._emit_one(side_idx, chunk, nonnull, deg,
                                       probe_idx, refs, ins_idx, ins_refs,
                                       pay, old))
        self._pending.clear()
        self._epoch_buf = ([], [])
        self._epoch_rows = [0, 0]
        self._deg_replay = [None, None]
        return outs

    def _deg_replay_arrays(self, side_idx: int, max_ref: int):
        """(values, written) replay arrays for `side_idx`, grown to cover
        `max_ref`."""
        pair = self._deg_replay[side_idx]
        need = max_ref + 1
        if pair is None or len(pair[0]) < need:
            cap = max(next_pow2(need), 1024)
            vals = np.zeros(cap, dtype=np.int64)
            wr = np.zeros(cap, dtype=bool)
            if pair is not None:
                vals[:len(pair[0])] = pair[0]
                wr[:len(pair[1])] = pair[1]
            pair = (vals, wr)
            self._deg_replay[side_idx] = pair
        return pair

    def _emit_one(self, side_idx: int, chunk: StreamChunk,
                  nonnull: np.ndarray, deg: Optional[np.ndarray],
                  probe_idx: np.ndarray, refs: np.ndarray,
                  ins_idx: np.ndarray, ins_refs: np.ndarray,
                  pay: Optional[np.ndarray] = None,
                  old: Optional[np.ndarray] = None) -> List[StreamChunk]:
        """Emission per eq_join_oneside (hash_join.rs:990) generalized to
        the degree-transition rule: a stored outer row flips its
        NULL-padded emission exactly when its match degree crosses zero
        (the net per-chunk delta against the old degree: intermediate
        flips within one chunk cancel, leaving the same multiset).

        `deg` is None exactly when the join is INNER (no rule below reads
        it). On the epoch path `pay` carries the matched refs' payload
        lanes and `old` their pre-epoch degrees, from which the replay
        arrays rebuild each chunk's old and new degrees."""
        jt = self.join_type
        me = self.sides[side_idx]
        other = self.sides[1 - side_idx]
        vis = np.asarray(chunk.visibility)
        if deg is None and jt != JoinType.INNER:
            deg = np.zeros(chunk.capacity, dtype=np.int64)
        outs: List[StreamChunk] = []
        # 1) matched pairs (all types except semi/anti)
        if jt.subject is None and len(probe_idx):
            outs.append(self._pairs_chunk(side_idx, chunk, probe_idx, refs,
                                          pay))
        # 2) incoming-row direct emissions
        if jt.outer_on(side_idx):
            # NULL-key rows of an outer side always emit padded
            unmatched = np.flatnonzero(vis & ((deg == 0) | ~nonnull))
            if len(unmatched):
                outs.append(self._padded_from_chunk(side_idx, chunk,
                                                    unmatched))
        elif jt.subject == side_idx:
            if jt.is_anti:
                sel = np.flatnonzero(vis & ((deg == 0) | ~nonnull))
            else:
                sel = np.flatnonzero(vis & nonnull & (deg > 0))
            if len(sel):
                outs.append(self._subject_from_chunk(chunk, sel))
        # 3) stored-row degree transitions on the other side
        if (1 - side_idx) in jt.tracked_sides and len(refs):
            sgn = np.where(self._ops_of(chunk, probe_idx) == int(Op.INSERT),
                           1, -1)
            uref, inv = np.unique(refs, return_inverse=True)
            delta = np.zeros(len(uref), dtype=np.int64)
            np.add.at(delta, inv, sgn)
            if other.dev_degrees:
                # seed from the matrix's pre-epoch value on first touch;
                # later chunks read the replay arrays
                seed = np.zeros(len(uref), dtype=np.int64)
                if old is not None and len(old):
                    # any pair of a ref carries the same old value
                    seed[inv] = old
                vals, wr = self._deg_replay_arrays(1 - side_idx,
                                                   int(uref.max()))
                old_v = np.where(wr[uref], vals[uref], seed)
                new = old_v + delta
                vals[uref] = new
                wr[uref] = True
            else:
                old_v = other.degrees[uref]
                new = old_v + delta
                other.degrees[uref] = new
            flip_on = uref[(old_v == 0) & (new > 0)]
            flip_off = uref[(old_v > 0) & (new == 0)]
            if jt.subject is not None:       # semi/anti subject = other
                on_op = Op.DELETE if jt.is_anti else Op.INSERT
                off_op = Op.INSERT if jt.is_anti else Op.DELETE
                if len(flip_on):
                    outs.append(self._subject_from_arena(flip_on, on_op))
                if len(flip_off):
                    outs.append(self._subject_from_arena(flip_off, off_op))
            else:                            # outer side: padded flips
                if len(flip_on):
                    outs.append(self._padded_from_arena(
                        1 - side_idx, flip_on, Op.DELETE))
                if len(flip_off):
                    outs.append(self._padded_from_arena(
                        1 - side_idx, flip_off, Op.INSERT))
        # 4) initial degrees of the rows this chunk stored (the device
        # array already took them in the probe's scatter: only the replay
        # arrays, or the mesh's host array, need them here)
        if side_idx in jt.tracked_sides and len(ins_idx):
            if me.dev_degrees:
                vals, wr = self._deg_replay_arrays(side_idx,
                                                   int(ins_refs.max()))
                vals[ins_refs] = deg[ins_idx]
                wr[ins_refs] = True
            else:
                me.degrees[ins_refs] = deg[ins_idx]
        return outs

    # -- watermarks -------------------------------------------------------
    def _on_watermark(self, side_idx: int, msg: Watermark):
        """Join-key watermarks combine as the min across sides and
        forward on BOTH output columns of the key pair (equal by the join
        predicate), or on the subject's key column alone for semi/anti
        joins; non-key watermarks are dropped (reference behavior). The
        combined watermark also drives state expiry at the next
        barrier."""
        me = self.sides[side_idx]
        if msg.col_idx not in me.key_indices:
            return
        pos = me.key_indices.index(msg.col_idx)
        self._side_wm[side_idx][pos] = msg.value
        other_wm = self._side_wm[1 - side_idx].get(pos)
        if other_wm is None:
            return
        combined = min(msg.value, other_wm)
        prev = self._combined_wm.get(pos)
        if prev is not None and combined <= prev:
            return
        self._combined_wm[pos] = combined
        subj = self.join_type.subject
        if subj is not None:
            yield Watermark(self.sides[subj].key_indices[pos],
                            msg.data_type, combined)
        else:
            yield Watermark(self.sides[0].key_indices[pos], msg.data_type,
                            combined)
            yield Watermark(self.n_left + self.sides[1].key_indices[pos],
                            msg.data_type, combined)

    def _expire_state(self) -> None:
        """Expire both sides' rows below each advanced combined
        watermark (integer keys only: float keys have no order-safe
        expiry)."""
        for pos, wm in self._combined_wm.items():
            done = self._expired_wm.get(pos)
            if done is not None and wm <= done:
                continue
            dt = np.dtype(self.sides[0].key_types[pos].np_dtype)
            if not np.issubdtype(dt, np.integer):
                continue
            for side in self.sides:
                side.expire_below(pos, int(wm), seq=self._seq)
            # visibility is del_seq >= probe_seq, so the NEXT chunk's
            # sequence must exceed the tombstones' del_seq
            self._seq += 1
            self._expired_wm[pos] = wm

    # interner GC gate: skip below this many entries, and while entries
    # ≤ 2× live refs (GC cost is O(live))
    INTERNER_GC_MIN = 4096

    def _maybe_gc_interner(self) -> None:
        """Retire interner entries no stored row references. Cold keys
        count as live in the gate and pin their interned values: retiring
        an id a cold marker holds would dangle it."""
        codec = self.sides[0].key_codec
        if not codec.interners:
            return
        total = codec.interner_entries()
        live_refs = sum(len(s.pk_to_ref) + len(s.cold_keys)
                        for s in self.sides)
        if total < self.INTERNER_GC_MIN or \
                total <= 2 * live_refs * len(codec.interners):
            return
        for pos, it in codec.interners.items():
            vals: List[object] = []
            for side in self.sides:
                if side.pk_to_ref:
                    col = side.key_indices[pos]
                    refs = side.live_refs()
                    ok = side.arena.valid[col][refs]
                    vals.extend(side.arena.cols[col][refs][ok].tolist())
                # vt is ordered by key position, like the interners
                vals.extend(vt[pos] for vt in side.cold_keys.values()
                            if vt[pos] is not None)
            it.gc(vals)

    def _recover_degrees(self) -> None:
        """Degrees are a pure function of both sides' recovered state:
        ONE batch probe of the tracked side's keys against the other
        side's matcher (K6), then a write by ref (K7 on one device)."""
        for t in self.join_type.tracked_sides:
            side = self.sides[t]
            other = self.sides[1 - t]
            if not side.pk_to_ref:
                continue
            refs = side.live_refs()
            key_cols = side.key_cols_of(refs)
            # host-typed arena key columns hold None for NULL keys:
            # build_arrays reads them as NULL
            lanes_ = side.key_codec.build_arrays(key_cols)
            nonnull = np.ones(len(refs), dtype=bool)
            for j in range(len(key_cols)):
                nonnull &= lanes_[:, LANES_PER_KEY * j + 2] != 0
            if side.dev_degrees:
                # K6 gives a row it does not see (a NULL key) degree 0 in
                # its degree column, which K7 writes as it lies: the
                # zeroing and the write stay on the card
                side.kernel.write_degrees(
                    upload(refs.astype(np.int32), side.kernel.device),
                    other.kernel.probe_degrees(lanes_, nonnull))
            else:
                deg, _pi, _refs = other.kernel.probe(lanes_, nonnull)
                side.ensure_degrees(int(refs.max()))
                side.degrees[refs] = np.where(nonnull, deg[:len(refs)], 0)

    # -- main loop --------------------------------------------------------
    async def execute(self) -> AsyncIterator[Message]:
        lit = self.left_in.execute()
        rit = self.right_in.execute()
        first_l = await lit.__anext__()
        first_r = await rit.__anext__()
        assert is_barrier(first_l) and is_barrier(first_r)
        assert first_l.epoch == first_r.epoch
        if self._tier is not None:
            self._tier_register()
        for i, side in enumerate(self.sides):
            side.table.init_epoch(first_l.epoch)
            side.recover()
            if self._tier_parts[i] is not None and side.pk_to_ref:
                # recovery rebuilds everything RESIDENT (cold markers do
                # not survive a crash); seed the tier clock so the first
                # checkpoint sweep re-applies the cap
                lanes_all = side.key_codec.build_arrays(
                    side.key_cols_of(side.live_refs()))
                self._tier.touch(
                    self._tier_parts[i],
                    map(tuple, np.unique(lanes_all, axis=0).tolist()),
                    self._tier_seq)
        self._recover_degrees()
        yield first_l
        try:
            async for tag, msg in barrier_align_2(lit, rit):
                if tag == "barrier":
                    # consume pending probes FIRST: expiry and compaction
                    # rebuild device state a re-dispatched probe would need
                    for out in self._emit_pending():
                        yield out
                    self._expire_state()
                    self._tier_seq += 1
                    for i, side in enumerate(self.sides):
                        if side.mesh is not None:
                            # the apply steps' lazily fetched overflow flags
                            side.kernel.drain_overflows()
                        side.table.commit(msg.epoch)
                        part = self._tier_parts[i]
                        swept = 0
                        if side.expired_lanes:
                            if part is not None:
                                self._tier.forget(part, side.expired_lanes)
                            side.expired_lanes = []
                        if part is not None and msg.kind.is_checkpoint:
                            # sweep at checkpoints only, after the commit:
                            # evicted rows are durable and no probe is in
                            # flight
                            swept = self._tier.sweep(part, self._tier_seq)
                        if not swept:
                            side.maybe_compact()
                        if side.fused_input is not None:
                            # absorbed-runtime barrier work (row-id
                            # counters rebase to the epoch floor)
                            side.fused_input.on_barrier(msg)
                    self._maybe_gc_interner()
                    if self._seq > (1 << 30):
                        # int32 sequence headroom: with no probes in
                        # flight, rebase every finite seq to 0 and restart
                        for side in self.sides:
                            side.kernel.rebase_seq()
                        self._seq = 1
                    yield msg
                    continue
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
                    wms: List[Watermark] = []
                    for one in derived:
                        wms.extend(self._on_watermark(i, one))
                    if wms:
                        # buffered join outputs must precede any watermark
                        # that could close windows over them
                        for out in self._emit_pending():
                            yield out
                    for wm in wms:
                        yield wm
        finally:
            if self._tier is not None:
                for p in self._tier_parts:
                    if p is not None:
                        self._tier.unregister(p)
