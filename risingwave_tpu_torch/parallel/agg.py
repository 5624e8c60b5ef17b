"""Vnode-sharded grouped aggregation over the logical shards of one card.

Port of ``risingwave_tpu/parallel/agg.py`` (reference parity: N parallel
HashAggExecutor actors fed by a HASH dispatcher, hash_agg.rs:67 +
dispatch.rs:582). The state is the single-device agg state with a leading
shard axis (``ops/hash_agg.ShardedAggState``); each shard owns a
contiguous range of the 256 vnodes (``mesh.ShardMesh``). One routed step
per epoch batch:

  input      the packed batch (or, fused, the raw batch through the
             absorbed prelude, each shard block its own ring) is split
             into S row blocks of ``local`` rows;
  exchange   ``route`` (``csrc/route.cu``) hashes each row's key lanes to
             its owner and writes it into its shard's receive block,
             sender-major, input order kept (the reference's bucketize +
             all_to_all);
  apply      K1 and K2 with a shard axis: each shard probes and folds
             what it received into its own table.

One step launches ``route``, ``probe_insert`` and K2 (``agg_apply``) the
same number of times whatever S is. The barrier flush gathers every
shard's dirty groups in one K3 launch, and a retractable MIN/MAX
recompute uploads its columns once (``patch_accs``) for the advance to
write in its own launch (a pending patch that meets any other state
operation goes out first through K9); growth, retirement and resharding
rebuild every shard with K4 (mask and fresh tables), K1 and K4 (remap),
one launch each, and recovery loads every shard with K1 + K9, as the
single-device ``load_groups`` does. There is no targeted
eviction: the cold tier runs on the single-device kernel only. On the
CPU every wrapper runs its plain version, shard by shard, so the state is
the reference's bit for bit (float SUM within its declared tolerance).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch.common.chunk import next_pow2
from risingwave_tpu_torch.common.hash import VNODE_COUNT
from risingwave_tpu_torch.ops import hash_table as ht
from risingwave_tpu_torch.ops import lanes
from risingwave_tpu_torch.ops.hash_agg import (
    LIVE_GROW, LIVE_OCCUPIED, LIVE_RETIRE, ROW_ACC0, ROW_GROUP_ROWS,
    AggSpec, ApplyPlan, FlushResult, ShardedAggState, as_i32_cols,
    advance_sharded, agg_apply_sharded, decode_flush_data, decode_outputs,
    dev_layout, encode_host_accs, encode_patch_cols, flush_gather_sharded,
    live_and_table_sharded, load_rows, load_src, make_sharded_agg_state,
    pack_chunk, patch_rows, rebuild_sharded, remap_sharded,
    scatter_rows_sharded, state_fills,
)
from risingwave_tpu_torch.parallel.exchange import (
    owners_host, route, skew_bucket,
)
from risingwave_tpu_torch.parallel.mesh import ShardMesh
from risingwave_tpu_torch.utils.device import (
    Fetch, ProbeOverflowError, fetch, start_fetch, upload,
)
from risingwave_tpu_torch.utils.metrics import STREAMING as _METRICS


def _check_probe(stats: np.ndarray) -> None:
    if np.asarray(stats)[:, 1].any():
        raise ProbeOverflowError(
            "probe_insert ran out of probe steps: a shard's table is over "
            "its load-factor contract")


class _ShardedCounters:
    """Per-shard sync-free occupancy accounting and deferred overflow
    (``agg.py:70``): the vector twin of ``utils/device.PendingCounters``.
    Each routed step returns K1's per-shard stats int32[S, 2] (inserts,
    probe overflow) and the route's per-sender overflow flags int32[S];
    their copies to the host start at launch and fold in when they land,
    so the hot path never waits on the card. A set flag raises when it
    is folded in (at the barrier's flush at the latest)."""

    def __init__(self, n_dev: int):
        self._count = np.zeros(n_dev, dtype=np.int64)
        self._pending: List[Tuple[Fetch, Fetch, int]] = []
        self._rows = 0
        self._watched: List[Fetch] = []

    def push(self, stats: torch.Tensor, overflow: torch.Tensor,
             n_rows: int) -> None:
        self._pending.append((start_fetch(stats), start_fetch(overflow),
                              n_rows))
        self._rows += n_rows

    def watch(self, stats: torch.Tensor) -> None:
        """A rebuild's K1 stats: checked for the probe overflow only."""
        self._watched.append(start_fetch(stats))

    def _fold(self, stats: Fetch, overflow: Fetch, n_rows: int) -> None:
        if overflow.result().any():
            raise RuntimeError(
                "bucket overflow: routed rows dropped — raise `bucket`")
        st = stats.result()
        _check_probe(st)
        self._count += st[:, 0].astype(np.int64)
        self._rows -= n_rows

    def drain_ready(self) -> None:
        while self._pending and self._pending[0][0].ready() \
                and self._pending[0][1].ready():
            self._fold(*self._pending.pop(0))
        while self._watched and self._watched[0].ready():
            _check_probe(self._watched.pop(0).result())

    def drain_all(self) -> None:
        pending, self._pending = self._pending, []
        watched, self._watched = self._watched, []
        for entry in pending:
            self._fold(*entry)
        for f in watched:
            _check_probe(f.result())

    def bound(self) -> int:
        """Upper bound on the FULLEST shard's occupancy: every pending
        row could route to one shard."""
        return int(self._count.max(initial=0)) + self._rows

    def worst_exact(self) -> int:
        return int(self._count.max(initial=0))

    def reset(self, per_shard_counts) -> None:
        self._count = np.asarray(per_shard_counts, dtype=np.int64).copy()
        self._pending = []
        self._rows = 0


class ShardedAggKernel:
    """Grouped aggregation over the logical shards of a ``ShardMesh``:
    the ``GroupedAggKernel`` host surface (apply, flush, advance,
    retire_below, rebuild) with one routed step per epoch batch.

    ``epoch_batch=False`` is the per-chunk oracle arm: every apply
    dispatches at once. ``dispatches`` counts routed steps and flush
    gathers (the reference's dispatch sites): plain versions launch no
    kernel, so this is the count the CPU can check.
    """

    # epoch batch bound, as GroupedAggKernel.BATCH_ROWS: the backlog
    # dispatches at this many rows mid-epoch, else once at the flush
    BATCH_ROWS = 1 << 15
    # first gather buffer per shard; doubles until the fullest shard fits
    FLUSH_CAPACITY = 1 << 10

    def __init__(self, mesh: ShardMesh, key_width: int,
                 specs: Sequence[AggSpec], capacity: int = 1 << 12,
                 bucket: Optional[int] = None,
                 epoch_batch: bool = True):
        if not isinstance(mesh, ShardMesh):
            raise TypeError(f"a ShardMesh is needed, got {mesh!r}")
        if capacity & (capacity - 1) or capacity <= 0:
            raise ValueError("capacity must be a power of two")
        self.mesh = mesh
        self.n_dev = mesh.n_shards
        self.device = mesh.device
        self.specs = tuple(specs)
        self.key_width = key_width
        self.bucket = bucket
        self.epoch_batch = bool(epoch_batch)
        self._backlog: List[np.ndarray] = []
        self._backlog_owners: List[Optional[np.ndarray]] = []
        self._backlog_rows = 0
        # fused mode (set_prelude, before any data): the raw batch runs
        # through agg_prelude ahead of the routing
        self._prelude = None
        self._stage_counts: Optional[torch.Tensor] = None
        self._touched = False
        self._owner_map_host, self.owner_map = self._owner_maps(
            mesh.owner_map())
        self.state = make_sharded_agg_state(self.n_dev, capacity, key_width,
                                            self.specs, self.device)
        self._plan = ApplyPlan(key_width, self.specs, self.device)
        self._fill = torch.tensor(state_fills(self.specs), dtype=torch.int32,
                                  device=self.device)
        self._flush_cap = self.FLUSH_CAPACITY
        self._flush_idx: Optional[List[np.ndarray]] = None
        # the last flush's device matrices, whether any shard listed a
        # dirty slot and the step they saw (advance runs on their lists),
        # and calls that may dirty or move slots since the kernel was made
        self._flushed: Optional[Tuple[torch.Tensor, bool, int]] = None
        self._patched = False
        # patch_accs' columns on the card until advance carries them
        self._patch: Optional[torch.Tensor] = None
        self._steps = 0
        self._counters = _ShardedCounters(self.n_dev)
        self.dispatches = 0

    @property
    def capacity(self) -> int:
        """Slots per shard."""
        return self._state.capacity

    @property
    def state(self) -> ShardedAggState:
        """The device state, with any pending patch written first."""
        self._patch_out()
        return self._state

    @state.setter
    def state(self, value: ShardedAggState) -> None:
        self._state = value

    def _stepped(self) -> None:
        """A call that may dirty or move slots: a held flush is stale, and
        a pending patch is written first."""
        self._patch_out()
        self._steps += 1

    def _patch_out(self) -> None:
        """Write a pending patch with the standalone K9 at each shard's
        flushed slots (padded with cap), for an operation other than
        advance."""
        if self._patch is None:
            return
        cols, self._patch = self._patch, None
        bidx = np.full((self.n_dev, cols.shape[2]), self._state.capacity,
                       dtype=np.int32)
        for d, ix in enumerate(self._flush_idx):
            bidx[d, :len(ix)] = ix
        scatter_rows_sharded(self._state.st, upload(bidx, self.device),
                             patch_rows(self._state.n_acc, self.device),
                             cols)

    def _owner_maps(self, owners) -> Tuple[np.ndarray, torch.Tensor]:
        """A vnode → shard map, checked: (host copy, device copy)."""
        owners = np.asarray(owners, dtype=np.int32)
        if owners.shape != (VNODE_COUNT,) or owners.min() < 0 or \
                owners.max() >= self.n_dev:
            raise ValueError(f"an owner map is int32[{VNODE_COUNT}] of "
                             f"shards in [0, {self.n_dev})")
        return owners, upload(owners, self.device)

    # -- fused-fragment prelude (ops/fused.py) ----------------------------
    @property
    def supports_prelude(self) -> bool:
        """Fusion eligibility hook (opt/fusion.agg_ineligible_reason):
        only a kernel that has not seen data can adopt a prelude."""
        return not self._touched

    def set_prelude(self, prelude) -> None:
        """Install the fused-input prelude (an ``ops/fused.Program`` of
        MODE_AGG) before any data touches the kernel. A hop expansion is
        refused: the routing is sized for the uploaded rows."""
        assert not self._touched, "set_prelude after data flowed"
        if prelude.units != 1:
            raise ValueError("a sharded agg takes no hop-expanding prelude")
        self._prelude = prelude
        self._stage_counts = torch.zeros(prelude.n_counts, dtype=torch.int64,
                                         device=self.device)

    # -- hot path ---------------------------------------------------------
    def apply(self, key_lanes: np.ndarray, signs: np.ndarray,
              vis: np.ndarray, inputs: Sequence) -> None:
        """Buffer one host chunk for the epoch's routed step (one step at
        the flush, or per BATCH_ROWS rows mid-epoch; at once with
        ``epoch_batch=False``). `inputs` is per call (value lanes, valid
        mask)."""
        assert self._prelude is None, \
            "fused kernel takes raw chunks (apply_raw)"
        self._touched = True
        packed = pack_chunk(self.key_width, self.specs,
                            np.asarray(key_lanes), np.asarray(signs),
                            np.asarray(vis), inputs)
        n = packed.shape[0]
        if self._backlog_rows + n > self.BATCH_ROWS:
            self._dispatch_backlog()
        self._backlog.append(packed)
        self._backlog_rows += n
        self._reserve(self._backlog_rows)
        if not self.epoch_batch or self._backlog_rows >= self.BATCH_ROWS:
            self._dispatch_backlog()

    def owners_of(self, key_lanes: np.ndarray) -> np.ndarray:
        """Host twin of the device routing: per-row owners (the executor
        feeds them back for the skew-exact bucket on the fused path)."""
        return owners_host(key_lanes, self._owner_map_host)

    def apply_raw(self, raw: np.ndarray, n_visible: int,
                  owners: Optional[np.ndarray] = None) -> None:
        """Fused hot path: backlog one RAW int64 chunk matrix
        (ops/fused.encode_raw_chunk) plus an always-invisible separator
        row. ``owners`` (when the group keys map to raw columns) rides
        along for the skew-exact bucket: a pre-filter superset of the
        routed rows, so the bound stays safe. ``n_visible`` (the chunk's
        visible rows) feeds the reference's dispatch metrics, which are
        not ported."""
        assert self._prelude is not None, \
            "apply_raw needs a fused (set_prelude) kernel"
        self._touched = True
        n = raw.shape[0] + 1
        if self._backlog_rows + n > self.BATCH_ROWS:
            self._dispatch_backlog()
        self._backlog.append(raw)
        self._backlog.append(np.zeros((1, raw.shape[1]), dtype=np.int64))
        if owners is not None:
            ow = np.full(n, -1, dtype=np.int64)
            vis = raw[:, 1] != 0
            ow[:n - 1][vis] = np.asarray(owners)[vis]
            self._backlog_owners.append(ow)
        else:
            self._backlog_owners.append(None)
        self._backlog_rows += n
        self._reserve(self._backlog_rows)
        if not self.epoch_batch or self._backlog_rows >= self.BATCH_ROWS:
            self._dispatch_backlog()

    def _dispatch_backlog(self) -> None:
        """Ship the buffered rows as ONE routed step: pad to a power of
        two and a multiple of S (pad rows are invisible and route
        nowhere), route every row to its owner, apply per shard."""
        if not self._backlog:
            return
        self._stepped()
        mats, n = self._backlog, self._backlog_rows
        owner_chunks = self._backlog_owners
        self._backlog, self._backlog_rows = [], 0
        self._backlog_owners = []
        raw_mode = self._prelude is not None
        self._reserve(n)
        s, kw = self.n_dev, self.key_width
        cap_rows = max(next_pow2(n), s)
        if cap_rows % s:
            cap_rows += s - cap_rows % s
        w = mats[0].shape[1]
        packed = np.zeros((cap_rows, w),
                          dtype=np.int64 if raw_mode else np.int32)
        at = 0
        for m_ in mats:
            packed[at:at + m_.shape[0]] = m_
            at += m_.shape[0]
        local = cap_rows // s
        bucket = self.bucket or local
        if raw_mode and self.bucket is None and owner_chunks and \
                all(o is not None for o in owner_chunks):
            ow = np.full(cap_rows, -1, dtype=np.int64)
            ow[:n] = np.concatenate(owner_chunks)
            bucket = skew_bucket(ow, ow >= 0, s, local)
        if not raw_mode and self.bucket is None:
            # skew-exact bucket from the host key lanes: the default
            # (local) makes every shard take the whole batch
            owner = owners_host(packed[:, :kw], self._owner_map_host)
            bucket = skew_bucket(owner, packed[:, kw + 1] != 0, s, local)
        dev = upload(packed, self.device)
        if raw_mode:
            from risingwave_tpu_torch.ops.fused import agg_prelude
            dev = agg_prelude(self._prelude, dev, self._stage_counts,
                              seg=local)
        recv, rvalid, overflow = route(dev, dev[:, kw + 1], self.owner_map,
                                       s, bucket, kw)
        slots, stats = ht.probe_insert_sharded(self.state.table,
                                               recv[:, :, :kw], rvalid)
        agg_apply_sharded(self.state, recv, slots, self._plan)
        self._note_dispatch()
        self._counters.push(stats, overflow, n)

    def _note_dispatch(self) -> None:
        """One routed step or flush gather: the kernel counts its own
        device steps (the executor does not count for it)."""
        self.dispatches += 1
        _METRICS.device_dispatch.inc(1, kernel="sharded_agg")

    def drain_stage_counts(self) -> Optional[np.ndarray]:
        """The prelude's cumulative mask counts since the last drain,
        summed over the shard blocks (the reference's
        ``drain_stage_rows``; call after flush)."""
        if self._stage_counts is None:
            return None
        out = fetch(self._stage_counts)
        self._stage_counts.zero_()
        return out

    # -- growth -----------------------------------------------------------
    def _reserve(self, n: int) -> None:
        """Grow every shard until the fullest keeps room for `n`
        pessimistic inserts (``agg.py:589``)."""
        self._counters.drain_ready()
        if self._counters.bound() + n <= ht.MAX_LOAD * self.capacity:
            return
        self._counters.drain_all()
        worst = self._counters.worst_exact()
        if worst + n > ht.MAX_LOAD * self.capacity:
            self.grow(next_pow2(int((worst + n) / ht.MAX_LOAD) + 1))

    def _rebuild(self, mode: int, new_cap: int, lane_off: int = 0,
                 wm_hi: int = 0, wm_lo: int = 0) -> torch.Tensor:
        """Re-insert every shard's live slots (the rule ``mode``) into
        fresh tables of ``new_cap`` slots and move every state row: K4's
        mask with the fresh tables, K1, K4's remap. Returns K1's stats
        int32[S, 2]."""
        self._stepped()
        self.state, stats = rebuild_sharded(self.state, mode, new_cap,
                                            self._fill, lane_off, wm_hi,
                                            wm_lo)
        return stats

    def grow(self, new_capacity: int) -> None:
        """Double (at least) every shard's table, keeping every occupied
        slot with its dirty flag and emitted snapshot (``agg.py:603``)."""
        new_capacity = next_pow2(max(new_capacity, self.capacity * 2))
        stats = fetch(self._rebuild(LIVE_OCCUPIED, new_capacity))
        _check_probe(stats)
        # exact per-shard occupancy falls out of the rebuild
        self._counters.reset(stats[:, 0])

    # -- barrier flush ----------------------------------------------------
    def flush(self) -> FlushResult:
        """Gather every shard's dirty groups in one K3 launch and one
        read, and decode their concatenation in shard order (keys never
        span shards)."""
        self._dispatch_backlog()
        # an overflow must surface before this barrier's results count
        self._counters.drain_all()
        fc = self._flush_cap
        while True:
            dev_mats = flush_gather_sharded(self.state, fc)
            mats = fetch(dev_mats)
            self._note_dispatch()
            ps = mats[:, 0, 0]
            self._counters.reset(mats[:, 0, 1])
            worst = int(ps.max())
            if worst <= fc:
                break
            fc = max(fc * 2, next_pow2(worst))
        self._flush_cap = fc
        # the last gather lists every shard's dirty slots
        self._flushed = (dev_mats, bool(ps.any()), self._steps)
        self._patched = False
        if int(ps.sum()) == 0:
            self._flush_idx = [np.zeros(0, dtype=np.int32)
                               for _ in range(self.n_dev)]
            return FlushResult.empty(self.specs, self.key_width)
        segs = [mats[d, 1:1 + int(ps[d])] for d in range(self.n_dev)]
        self._flush_idx = [np.ascontiguousarray(sg[:, 0]) for sg in segs]
        return decode_flush_data(self.specs, self.key_width,
                                 np.concatenate(segs, axis=0))

    def advance(self) -> None:
        """K3's advance on every shard's list from the last flush, in one
        launch; none when no shard listed a dirty slot. A pending patch
        rides in the same launch. Only ``patch_accs`` may run between the
        flush and the advance."""
        assert self._flush_idx is not None, "flush() first"
        mats, any_dirty, steps = self._flushed
        patch, self._patch = self._patch, None
        self._flush_idx = self._flushed = None
        if steps != self._steps:
            raise RuntimeError("advance after the state was stepped past "
                               "its flush")
        if any_dirty:
            advance_sharded(self._state, mats, current=not self._patched,
                            patch=patch)

    def patch_accs(self, decoded, raw_accs=None) -> None:
        """Overwrite the flushed groups' accumulators on every shard (the
        retractable MIN/MAX recompute, ``agg.py:669``) before
        ``advance``: the corrected rows go back to their shards as one
        upload of columns int32[S, n_acc, m] (shard d's column i for its
        flush list's row i, m the fullest shard's count), which
        ``advance`` writes in its own
        launch; untouched calls pass their gathered columns through bit
        for bit. The flush retried until every shard's list fit, so no
        list is truncated."""
        idxs = self._flush_idx
        assert idxs is not None and any(len(ix) for ix in idxs), \
            "flush() first"
        self._patch_out()
        cols = as_i32_cols(encode_patch_cols(self.specs, decoded, raw_accs))
        counts = [len(ix) for ix in idxs]
        if max(counts) > self._flush_cap:
            raise RuntimeError("a truncated flush list cannot carry a "
                               "patch")
        bsrc = np.zeros((self.n_dev, len(cols), max(counts)),
                        dtype=np.int32)
        flat = np.stack(cols)
        at = 0
        for d, c in enumerate(counts):
            bsrc[d, :, :c] = flat[:, at:at + c]
            at += c
        self._patch = upload(bsrc, self.device)
        self._patched = True

    def retire_below(self, group_pos: int, wm_i64: int) -> None:
        """Watermark state cleaning on every shard: one live-mask launch
        and one rebuild. Runs post-flush only: a buffered batch here
        would apply rows to retired groups out of order."""
        if self._backlog_rows:
            raise RuntimeError("retire_below with undispatched backlog")
        hi, lo = lanes.split_i64(np.asarray([wm_i64], dtype=np.int64))
        self._counters.watch(self._rebuild(LIVE_RETIRE, self.capacity,
                                           group_pos * 3, int(hi[0]),
                                           int(lo[0])))

    # -- recovery ---------------------------------------------------------
    def rebuild(self, keys: np.ndarray, group_rows: np.ndarray,
                acc_cols: Sequence[np.ndarray]) -> None:
        """Reload committed value-state rows (recovery), routing each
        group to its owning shard on the host, then one K1 + K9 launch
        loads every shard (``agg.py:729``), as ``load_groups`` does. Restored groups are marked
        emitted."""
        n = len(group_rows)
        self._backlog = []
        self._backlog_owners = []
        self._backlog_rows = 0
        if self._stage_counts is not None:
            self._stage_counts.zero_()
        cap = self.capacity
        self._stepped()
        self._counters.reset(np.zeros(self.n_dev, dtype=np.int64))
        owner = owners_host(np.asarray(keys, dtype=np.int32),
                            self._owner_map_host) if n else \
            np.zeros(0, dtype=np.int32)
        per_shard = np.bincount(owner, minlength=self.n_dev)
        worst = int(per_shard.max(initial=0))
        if worst > ht.MAX_LOAD * cap:
            # an over-full shard would break the probe's contract: size
            # the fresh state to fit instead
            cap = next_pow2(int(worst / ht.MAX_LOAD) + 1)
        self.state = make_sharded_agg_state(self.n_dev, cap, self.key_width,
                                            self.specs, self.device)
        if n == 0:
            return
        src = load_src(group_rows, encode_host_accs(self.specs, acc_cols))
        m = next_pow2(int(per_shard.max(initial=1)))
        order = np.argsort(owner, kind="stable")
        pos = np.empty(n, dtype=np.int64)
        at = 0
        for d in range(self.n_dev):
            c = int(per_shard[d])
            pos[order[at:at + c]] = np.arange(c)
            at += c
        bkeys = np.zeros((self.n_dev, m, self.key_width), dtype=np.int32)
        bkeys[owner, pos] = keys
        bvalid = np.zeros((self.n_dev, m), dtype=np.int32)
        bvalid[owner, pos] = 1
        bsrc = np.zeros((self.n_dev, src.shape[0], m), dtype=np.int32)
        bsrc[owner, :, pos] = src.T
        slots, stats = ht.probe_insert_sharded(
            self.state.table, upload(bkeys, self.device),
            upload(bvalid, self.device))
        scatter_rows_sharded(self.state.st, slots,
                             load_rows(self.state.n_acc, self.device),
                             upload(bsrc, self.device))
        self._counters.watch(stats)
        self._counters.reset(per_shard)

    # -- elastic resharding (scale.rs:174 / Mutation::Update analog) ------
    def reshard(self, new_owner_map: np.ndarray) -> None:
        """Move the state to a new vnode → shard map at a barrier
        (``agg.py:814``): every live slot's whole state row (key,
        counters, accumulators, emitted snapshot) routes to its new owner
        through the same exchange (bucket = cap, so nothing overflows),
        then each shard rebuilds its table. Raises, leaving the state as
        it was, when a shard would receive more than MAX_LOAD * cap
        groups."""
        host_map, dev_map = self._owner_maps(new_owner_map)
        s, cap, k = self.n_dev, self.capacity, self.key_width
        st = self.state
        r = st.st.shape[1]
        # the mask's launch also zeroes the fresh tables the moved groups
        # go into
        live, table = live_and_table_sharded(st, LIVE_GROW, cap)
        rows = torch.cat([st.table.keys, st.st.transpose(1, 2)], dim=2) \
            .reshape(s * cap, k + r)
        recv, rvalid, _ovf = route(rows, live.reshape(-1), dev_map, s, cap,
                                   k)
        received = fetch(rvalid.sum(dim=1))
        worst = int(received.max())
        if worst > ht.MAX_LOAD * cap:
            raise RuntimeError(
                f"reshard overfills a shard: {worst} live groups vs "
                f"{cap} slots — raise capacity before rescaling")
        slots, stats = ht.probe_insert_sharded(table, recv[:, :, :k], rvalid)
        src = recv[:, :, k:].transpose(1, 2).contiguous()
        self._stepped()
        self.state = ShardedAggState(
            table, remap_sharded(src, slots, table.occ, self._fill, cap))
        # both maps change together: the skew-exact bucket counts against
        # the host copy
        self._owner_map_host, self.owner_map = host_map, dev_map
        self._counters.watch(stats)
        self._counters.reset(received)

    # -- host-side full decode (tests) ------------------------------------
    def snapshot(self) -> Dict[tuple, tuple]:
        """group key lanes tuple → decoded outputs, across all shards."""
        self._dispatch_backlog()
        self._counters.drain_all()
        keys = fetch(self.state.table.keys)
        occ = fetch(self.state.table.occ) != 0
        st = fetch(self.state.st)
        out: Dict[tuple, tuple] = {}
        for d in range(self.n_dev):
            idx = np.flatnonzero(occ[d] & (st[d, ROW_GROUP_ROWS] > 0))
            if not len(idx):
                continue
            accs = []
            for i, (dt, _f) in enumerate(dev_layout(self.specs)):
                col = np.ascontiguousarray(st[d, ROW_ACC0 + i, idx])
                accs.append(col.view(np.float32) if dt == np.float32
                            else col)
            outs, nulls = decode_outputs(self.specs, accs)
            for j, kr in enumerate(keys[d, idx].tolist()):
                out[tuple(kr)] = tuple(
                    None if nulls[c][j] else outs[c][j].item()
                    for c in range(len(self.specs)))
        return out
