"""Vnode-sharded join matcher over the logical shards of one card.

Port of ``risingwave_tpu/parallel/join.py`` (reference parity: N parallel
HashJoinExecutor actors fed by HASH dispatchers on both inputs,
dispatch.rs:582, hash_join.rs:227). Each shard of a ``ShardMesh`` owns
the join-key vnode range's slice of BOTH sides' key tables and row
chains: the single-device state (``ops/hash_join.py``) with a leading
shard axis. Every step routes its rows to their key's owner and runs the
single-device kernels on each shard's received rows, all shards in one
launch:

  exchange   ``route`` (``csrc/route.cu``) writes each row into its
             owner's receive block [S, S * bucket, W], sender-major, input
             order kept (the reference's bucketize + all_to_all);
  apply      K1 (``probe_insert_sharded``) and K5 (``join_apply_sharded``)
             with a shard axis: find-or-insert the keys, link the rows
             into their chains in batch order, tombstone the deletes;
  probe      K6 (``join_probe_sharded``) with a shard axis: each shard's
             pairs and degrees, mapped back to global row ids by the
             routed row-id lane; the host concatenates the shards' pairs
             and stable-sorts them by probe row (a key lives on one shard,
             so each probe row keeps that shard's chain order).

Row refs are GLOBAL (the executor's host arena's): a ref lives only on its
key's owner shard, so each shard's chain arrays [S, row_capacity] index by
global ref and probe results need no translation. The executor cannot
tell this kernel from the single-device ``JoinSideKernel``: the same
apply_and_probe / probe / delete / rebuild / rebase_seq API, the same
pending-probe contract, and the epoch twins stage_epoch / apply_epoch /
probe_epoch. Route overflow flags (impossible by construction: the bucket
is computed, not guessed) are fetched asynchronously and checked at
collect and at the barrier, never synced at dispatch; so are K1's probe
overflow flags. On the CPU every kernel runs its plain version, shard by
shard, so the state is the reference's bit for bit.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from risingwave_tpu_torch.common.chunk import next_pow2
from risingwave_tpu_torch.ops import hash_table as ht
from risingwave_tpu_torch.ops.hash_agg import remap_sharded
from risingwave_tpu_torch.ops.hash_join import (
    AUX_DEL_REF, AUX_FLAGS, AUX_INS_REF, AUX_SEQ, FLAG_DEL, FLAG_INS,
    FLAG_PROBE, I32_MAX, ChainState, _rebase, join_apply_sharded,
    join_probe_sharded, link_scratch,
)
from risingwave_tpu_torch.parallel.exchange import (
    owners_host, route, skew_bucket,
)
from risingwave_tpu_torch.parallel.mesh import ShardMesh
from risingwave_tpu_torch.utils.device import (
    Fetch, ProbeOverflowError, fetch, start_fetch, upload,
)
from risingwave_tpu_torch.utils.metrics import STREAMING as _METRICS


def _raise_overflow(route_ovf: Optional[Fetch], stats: Optional[Fetch],
                    what: str) -> None:
    """Fold in one step's lazily fetched flags: a route overflow (rows
    dropped) or a K1 probe overflow raises."""
    if route_ovf is not None and route_ovf.result().any():
        raise RuntimeError(f"bucket overflow routing {what}")
    if stats is not None and stats.result()[..., 1].any():
        raise ProbeOverflowError(
            "probe_insert ran out of probe steps: a shard's key table is "
            "over its load-factor contract")


def _parse(mats: np.ndarray, out_cap: int, n: int, with_degrees: bool
           ) -> Tuple[Optional[np.ndarray], np.ndarray, np.ndarray]:
    """Per-shard blocks [1 + (m) + out_cap, 2] → (degrees | None over the
    ``n`` caller rows, probe rows, refs), pairs stable-sorted by probe
    row."""
    m = mats.shape[1] - 1 - out_cap
    deg = np.zeros(n, dtype=np.int32) if with_degrees else None
    probes, refs = [], []
    for d in range(mats.shape[0]):
        if with_degrees:
            blk = mats[d, 1:1 + m]
            rid, dg = blk[:, 1], blk[:, 0]
            sel = rid >= 0
            deg[rid[sel]] = dg[sel]
        total = int(mats[d, 0, 0])
        pairs = mats[d, 1 + (m if with_degrees else 0):][:total]
        probes.append(pairs[:, 0])
        refs.append(pairs[:, 1])
    probe_idx = np.concatenate(probes)
    ref_arr = np.concatenate(refs)
    order = np.argsort(probe_idx, kind="stable")
    return deg, probe_idx[order], ref_arr[order]


class _PendingMats:
    """The collect loop both pending kinds share: check the route's
    overflow flags, read the per-shard matrices, and re-dispatch with the
    kernel's grown ``probe_capacity`` while the worst shard's TRUE total
    exceeds the buffer (sequence versioning makes the retry exact)."""

    def __init__(self, kernel: "ShardedJoinKernel", mats: torch.Tensor,
                 overflow: torch.Tensor, out_cap: int,
                 redispatch: Callable[[int], tuple], what: str):
        self.kernel = kernel
        self.out_cap = out_cap
        self.redispatch = redispatch
        self.what = what
        self._set(mats, overflow)

    def _set(self, mats, overflow) -> None:
        self.mats = mats
        self._mats = start_fetch(mats)
        self._overflow = start_fetch(overflow)

    def read(self) -> np.ndarray:
        k = self.kernel
        while True:
            _raise_overflow(self._overflow, None, self.what)
            mats = self._mats.result()
            worst = int(mats[:, 0, 0].max())
            if worst <= self.out_cap:
                return mats
            while k.probe_capacity < worst:
                k.probe_capacity *= 2
            self.out_cap = k.probe_capacity
            self._set(*self.redispatch(self.out_cap))


class ShardedPendingProbe(_PendingMats):
    """An in-flight per-chunk sharded probe (``parallel/join.py:75``):
    ``collect`` → (degrees[n], probe_idx[pairs], refs[pairs]), pairs
    sorted by probe row so same-pk delete/insert halves stay ordered. An
    overflowed pair buffer re-dispatches a probe-only step of the probed
    kernel's CURRENT state at the recorded sequence."""

    def __init__(self, kernel: "ShardedJoinKernel", mats, overflow,
                 key_lanes: np.ndarray, vis: np.ndarray, seq: int,
                 out_cap: int, n: int):
        super().__init__(
            kernel, mats, overflow, out_cap,
            lambda cap: kernel._dispatch_probe(key_lanes, vis, seq, cap),
            "join rows")
        self.n = n                      # caller rows (before padding)

    def collect(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return _parse(self.read(), self.out_cap, self.n, True)


class ShardedPendingEpochProbe(_PendingMats):
    """An in-flight sharded EPOCH probe (``parallel/join.py:135``):
    ``collect`` → (degrees | None, probe_idx, refs, None, None) over the
    concatenated epoch row space, pairs sorted stably by probe row.
    Payload lanes and device degrees are None: the sharded path
    materializes rows from the host arena."""

    def __init__(self, kernel: "ShardedJoinKernel", mats, overflow,
                 n_rows: int, out_cap: int, with_degrees: bool,
                 redispatch):
        super().__init__(kernel, mats, overflow, out_cap, redispatch,
                         "epoch join probes")
        self.n = n_rows                 # padded epoch rows
        self.with_degrees = with_degrees

    def collect(self):
        self.kernel.drain_overflows()
        deg, probe_idx, refs = _parse(self.read(), self.out_cap, self.n,
                                      self.with_degrees)
        return deg, probe_idx.astype(np.int64), refs, None, None


class ShardedJoinKernel:
    """``JoinSideKernel``'s API over the shards of a ``ShardMesh``.

    Key-table occupancy is tracked per shard as a host upper bound (each
    batch's distinct keys by owner; keys recurring across batches
    over-count); when the fullest shard's bound crosses the load limit it
    collapses to the exact per-shard occupancy with one device read, and
    the tables grow 4x if still needed. Growth keeps the sequences (only
    the key tables and heads remap), so it is safe with probes in flight.
    ``dispatches`` counts routed steps (the reference's dispatch sites),
    which the CPU can check."""

    # the reference's defaults (``parallel/join.py:218``)
    def __init__(self, mesh: ShardMesh, key_width: int,
                 key_capacity: int = 1 << 15, row_capacity: int = 1 << 17,
                 probe_capacity: int = 1 << 13):
        if not isinstance(mesh, ShardMesh):
            raise TypeError(f"a ShardMesh is needed, got {mesh!r}")
        self.mesh = mesh
        self.n_dev = mesh.n_shards
        self.device = mesh.device
        self.key_width = key_width
        self.key_capacity = key_capacity
        self._row_capacity = row_capacity
        self.probe_capacity = probe_capacity
        self._owner_map_host = mesh.owner_map()
        self.owner_map = upload(self._owner_map_host, self.device)
        self._fresh_state()
        # per-shard distinct-key upper bound (host)
        self._keys_upper = np.zeros(self.n_dev, dtype=np.int64)
        # apply steps' route and K1 overflow flags, checked lazily at the
        # next probe collect or barrier
        self._apply_overflows: List[Tuple[Optional[Fetch], Fetch]] = []
        self.dispatches = 0

    @property
    def row_capacity(self) -> int:
        return self._row_capacity

    def _full(self, shape, v) -> torch.Tensor:
        return torch.full(shape, v, dtype=torch.int32, device=self.device)

    def _fresh_state(self) -> None:
        s, cap, r = self.n_dev, self.key_capacity, self._row_capacity
        self.table = ht.TableState(self._full((s, cap, self.key_width), 0),
                                   self._full((s, cap), 0))
        self.chains = ChainState(self._full((s, cap), -1),
                                 self._full((s, r), -1),
                                 self._full((s, r), I32_MAX),
                                 self._full((s, r), I32_MAX))
        self._new_scratch()

    def _new_scratch(self) -> None:
        """K5's per-slot bucket words for head [S, cap] (no launch
        restores them)."""
        self._link_scratch = link_scratch(self.chains.head)

    # -- capacity management -----------------------------------------------
    def owners_of(self, key_lanes: np.ndarray) -> np.ndarray:
        """Host twin of the device routing (same hash → same owner): the
        executor's per-row owners for the skew-exact bucket."""
        return owners_host(np.asarray(key_lanes), self._owner_map_host)

    def _occupancy(self) -> np.ndarray:
        """Exact per-shard key occupancy: one device read."""
        return fetch(self.table.occ.sum(dim=1)).astype(np.int64)

    def _guard_keys(self, key_lanes: np.ndarray, vis: np.ndarray,
                    owners: Optional[np.ndarray] = None) -> None:
        """The per-shard distinct-key bound (``parallel/join.py:279``);
        grows the key tables when the fullest shard runs out. ``owners``
        are the rows' owner shards where the caller has them already."""
        kv = key_lanes[vis]
        ov = None
        if len(kv):
            ov = self.owners_of(kv) if owners is None else owners[vis]
            _u, idx = np.unique(kv, axis=0, return_index=True)
            self._keys_upper = self._keys_upper + np.bincount(
                ov[idx], minlength=self.n_dev)
        limit = ht.MAX_LOAD * self.key_capacity
        if int(self._keys_upper.max()) <= limit:
            return
        headroom = 0 if ov is None else np.bincount(ov, minlength=self.n_dev)
        need = self._occupancy() + headroom
        self._keys_upper = need
        worst = int(need.max())
        if worst > limit:
            self._grow_keys(next_pow2(int(worst / ht.MAX_LOAD) + 1))

    def _guard_keys_blind(self, n_ins: int) -> None:
        """The key guard when the host has no key lanes (a fused raw
        upload, ``parallel/join.py:557``): every insert could route to
        one shard."""
        if n_ins == 0:
            return
        self._keys_upper = self._keys_upper + n_ins
        limit = ht.MAX_LOAD * self.key_capacity
        if int(self._keys_upper.max()) <= limit:
            return
        need = self._occupancy() + n_ins
        self._keys_upper = need
        worst = int(need.max())
        if worst > limit:
            self._grow_keys(next_pow2(int(worst / ht.MAX_LOAD) + 1))

    def _grow_keys(self, new_capacity: int) -> None:
        """Re-insert every shard's keys into tables of at least 4x the
        slots (K1) and move the heads (K4); the chain arrays stay."""
        new_capacity = max(new_capacity, self.key_capacity * 4)
        s = self.n_dev
        table = ht.TableState(self._full((s, new_capacity, self.key_width),
                                         0),
                              self._full((s, new_capacity), 0))
        o2n, stats = ht.probe_insert_sharded(table, self.table.keys,
                                             self.table.occ)
        head = remap_sharded(self.chains.head[:, None, :], o2n, table.occ,
                             self._full((1,), -1), new_capacity)[:, 0]
        self.table = table
        self.chains = self.chains._replace(head=head.contiguous())
        self.key_capacity = new_capacity
        self._new_scratch()
        self._apply_overflows.append((None, start_fetch(stats)))

    def _guard_refs(self, refs: np.ndarray, mask: np.ndarray) -> None:
        if mask.any():
            mx = int(refs[mask].max())
            if mx >= self._row_capacity:
                self._grow_rows(next_pow2(mx + 1))

    def _grow_rows(self, new_capacity: int) -> None:
        """Row arrays padded per shard to at least 4x (refs index rows
        directly; nothing remaps)."""
        new_capacity = max(new_capacity, self._row_capacity * 4)
        pad = new_capacity - self._row_capacity

        def padded(a, fill):
            return torch.cat([a, self._full((self.n_dev, pad), fill)], dim=1)
        c = self.chains
        self.chains = c._replace(next=padded(c.next, -1),
                                 ins_seq=padded(c.ins_seq, I32_MAX),
                                 del_seq=padded(c.del_seq, I32_MAX))
        self._row_capacity = new_capacity

    def reserve_rows(self, max_ref: int) -> None:
        if max_ref >= self._row_capacity:
            self._grow_rows(next_pow2(max_ref + 1))

    # -- the routed steps --------------------------------------------------
    def _route(self, rows: torch.Tensor, valid: torch.Tensor, bucket: int):
        """The exchange every step starts with: (recv [S, S * bucket, W],
        rvalid [S, S * bucket], per-sender overflow [S])."""
        self.dispatches += 1
        _METRICS.device_dispatch.inc(1, kernel="sharded_join")
        return route(rows, valid, self.owner_map, self.n_dev, bucket,
                     self.key_width)

    def _apply_routed(self, recv: torch.Tensor, ins, ins_col, dels,
                      del_col, seq) -> Optional[torch.Tensor]:
        """K1 on each shard's insert rows, then K5 (link in batch order,
        tombstone) on its received rows. ``ins`` / ``dels`` are (ok
        [S, S * bucket], bits) or None, ``ins_col`` / ``del_col`` the
        receive-block columns of their refs. Returns K1's stats [S, 2]
        (None without inserts)."""
        kw = self.key_width
        slots = stats = None
        if ins is not None:
            ok, bits = ins
            slots, stats = ht.probe_insert_sharded(
                self.table, recv[:, :, :kw], ok if bits == -1 else ok & bits)
        join_apply_sharded(
            self.chains, slots,
            ins_ok=None if ins is None else ins[0],
            ins_bits=-1 if ins is None else ins[1],
            ins_ref=None if ins is None else recv[:, :, ins_col],
            del_ok=None if dels is None else dels[0],
            del_bits=-1 if dels is None else dels[1],
            del_ref=None if dels is None else recv[:, :, del_col],
            seq=seq, scratch=self._link_scratch)
        return stats

    def _probe_routed(self, recv, rvalid, vis, vis_bits, rid_col, seq,
                      out_cap: int, with_degrees: bool) -> torch.Tensor:
        mats, _stats = join_probe_sharded(
            self.table, self.chains, recv[:, :, :self.key_width], vis,
            vis_bits, seq, out_cap, with_degrees,
            rid=recv[:, :, rid_col], rvalid=rvalid)
        return mats

    def _pad(self, arrs, n: int):
        """Host arrays padded with zero rows to a multiple of the shard
        count (pad rows are invisible: routed nowhere)."""
        m = max(self.n_dev, n)
        if m % self.n_dev:
            m += self.n_dev - (m % self.n_dev)
        out = []
        for a in arrs:
            a = np.asarray(a)
            if m != n:
                p = np.zeros((m,) + a.shape[1:], dtype=a.dtype)
                p[:n] = a
                a = p
            out.append(a)
        return out, m

    def _upload_rows(self, cols) -> torch.Tensor:
        """One int32 upload of [key lanes | columns...]."""
        return upload(np.concatenate(
            [np.asarray(c, np.int32).reshape(len(c), -1) for c in cols],
            axis=1), self.device)

    # -- the per-chunk API (JoinSideKernel parity) ------------------------
    def apply_and_probe(self, other: "ShardedJoinKernel",
                        key_lanes: np.ndarray, probe_vis: np.ndarray,
                        ins_refs: np.ndarray, ins_mask: np.ndarray,
                        del_refs: np.ndarray, del_mask: np.ndarray,
                        seq: int) -> ShardedPendingProbe:
        """One per-chunk step (``parallel/join.py:838``): route the chunk
        [key lanes | row id | ins ref | del ref | flags], probe ``other``
        at ``seq`` (K6), apply this side's inserts and deletes at ``seq``
        (K1 + K5). All arguments are host arrays."""
        rows, lanes, pv, n = self._stage_chunk(key_lanes, probe_vis,
                                               ins_refs, ins_mask, del_refs,
                                               del_mask)
        out_cap = other.probe_capacity
        mats, overflow, stats = self._chunk_step(other, rows, seq, out_cap)
        self._apply_overflows.append((None, start_fetch(stats)))
        return ShardedPendingProbe(other, mats, overflow, lanes, pv, seq,
                                   out_cap, n)

    def _stage_chunk(self, key_lanes, probe_vis, ins_refs, ins_mask,
                     del_refs, del_mask) -> tuple:
        """The host half of a per-chunk step: the growth guards, padding
        to the shard count and one upload. Returns (rows, padded lanes,
        padded probe mask, caller rows)."""
        key_lanes = np.asarray(key_lanes)
        ins_mask, del_mask = np.asarray(ins_mask), np.asarray(del_mask)
        probe_vis = np.asarray(probe_vis)
        n = int(key_lanes.shape[0])
        self._guard_keys(key_lanes, ins_mask)
        self._guard_refs(np.asarray(ins_refs), ins_mask)
        flags = (probe_vis * FLAG_PROBE + ins_mask * FLAG_INS
                 + del_mask * FLAG_DEL).astype(np.int32)
        (lanes, refs, drefs, fl, pv), m = self._pad(
            [key_lanes, ins_refs, del_refs, flags, probe_vis], n)
        rows = self._upload_rows([lanes, np.arange(m), refs, drefs, fl])
        return rows, lanes, pv, n

    def _chunk_step(self, other: "ShardedJoinKernel", rows: torch.Tensor,
                    seq: int, out_cap: int) -> tuple:
        """The device half of a per-chunk step on the uploaded rows
        [key lanes | row id | ins ref | del ref | flags]: route, K6 on
        ``other``, K1 + K5 on this side. Returns (mats, route overflow,
        K1 stats)."""
        kw = self.key_width
        recv, rvalid, overflow = self._route(
            rows, rows[:, kw + 3] != 0, int(rows.shape[0]) // self.n_dev)
        flags = recv[:, :, kw + 3]
        mats = other._probe_routed(recv, rvalid, flags, FLAG_PROBE, kw, seq,
                                   out_cap, True)
        stats = self._apply_routed(recv, (flags, FLAG_INS), kw + 1,
                                   (flags, FLAG_DEL), kw + 2, seq)
        return mats, overflow, stats

    def _dispatch_probe(self, lanes: np.ndarray, vis: np.ndarray, seq: int,
                        out_cap: int):
        """A probe-only step of this side's CURRENT state: (mats,
        overflow)."""
        m = int(lanes.shape[0])
        rows = self._upload_rows([lanes, np.arange(m)])
        recv, rvalid, overflow = self._route(
            rows, upload(np.asarray(vis, np.int32), self.device),
            m // self.n_dev)
        mats = self._probe_routed(recv, rvalid, rvalid, -1, self.key_width,
                                  seq, out_cap, True)
        return mats, overflow

    def probe_submit(self, key_lanes, vis, seq: Optional[int] = None
                     ) -> ShardedPendingProbe:
        n = int(np.asarray(key_lanes).shape[0])
        s = I32_MAX if seq is None else seq
        (lanes, pv), _m = self._pad([key_lanes, vis], n)
        mats, overflow = self._dispatch_probe(lanes, pv, s,
                                              self.probe_capacity)
        return ShardedPendingProbe(self, mats, overflow, lanes, pv, s,
                                   self.probe_capacity, n)

    def probe(self, key_lanes, vis, seq: Optional[int] = None):
        return self.probe_submit(key_lanes, vis, seq).collect()

    def insert(self, key_lanes: np.ndarray, refs: np.ndarray,
               vis: np.ndarray, seq: int = 0) -> None:
        """Routed batch insert (recovery, rebuild, tests): route, K1, K5
        link. Checks the route's overflow at once."""
        key_lanes, vis = np.asarray(key_lanes), np.asarray(vis)
        n = int(key_lanes.shape[0])
        self._guard_keys(key_lanes, vis)
        self._guard_refs(np.asarray(refs), vis)
        (lanes, refs_, mask), m = self._pad([key_lanes, refs, vis], n)
        rows = self._upload_rows([lanes, refs_])
        recv, rvalid, overflow = self._route(
            rows, upload(mask.astype(np.int32), self.device),
            m // self.n_dev)
        stats = self._apply_routed(recv, (rvalid, -1), self.key_width,
                                   None, None, seq)
        _raise_overflow(start_fetch(overflow), start_fetch(stats),
                        "join rows for insert")

    def delete(self, del_refs: np.ndarray, vis, seq: int = 0,
               key_lanes=None) -> None:
        """Tombstone by ref. The owner shard is a function of the key, so
        the refs' key lanes are needed."""
        if key_lanes is None:
            raise ValueError("a sharded delete routes by key: pass the "
                             "refs' key_lanes")
        n = int(np.asarray(key_lanes).shape[0])
        (lanes, drefs, dm), m = self._pad([key_lanes, del_refs, vis], n)
        rows = self._upload_rows([lanes, drefs])
        recv, rvalid, overflow = self._route(
            rows, upload(np.asarray(dm, np.int32), self.device),
            m // self.n_dev)
        self._apply_routed(recv, None, None, (rvalid, -1), self.key_width,
                           seq)
        _raise_overflow(start_fetch(overflow), None, "join deletes")

    def rebase_seq(self) -> None:
        """Every finite ins/del sequence becomes 0 (K7 on the flattened
        [S, row_capacity] arrays), at a point with no probes in flight."""
        c = self.chains
        _rebase(ChainState(c.head.view(-1), c.next.view(-1),
                           c.ins_seq.view(-1), c.del_seq.view(-1)))

    def rebuild(self, key_lanes: np.ndarray, row_refs: np.ndarray,
                payload: Optional[np.ndarray] = None,
                carry: Optional[np.ndarray] = None) -> None:
        """Reload all live rows (recovery, compaction): fresh state and
        one routed insert at seq 0. Each shard's key capacity is sized for
        ALL n keys (worst skew: one shard owns every key). There is no
        payload store (matched rows gather from the host arena) and no
        degree array to carry (the executor keeps a mesh's degrees on the
        host)."""
        if payload is not None or carry is not None:
            raise ValueError("the sharded join keeps no payload lanes or "
                             "device degrees")
        n = len(row_refs)
        while n and int(np.max(row_refs)) >= self._row_capacity:
            self._row_capacity *= 2
        need_keys = ht.MIN_CAPACITY if n == 0 else 1 << int(np.ceil(
            np.log2(max(n / ht.MAX_LOAD, 1))))
        self.key_capacity = max(self.key_capacity, need_keys,
                                ht.MIN_CAPACITY)
        self._fresh_state()
        self._keys_upper = np.zeros(self.n_dev, dtype=np.int64)
        if n == 0:
            return
        self.insert(key_lanes, row_refs, np.ones(n, dtype=bool), seq=0)

    # -- epoch batching ----------------------------------------------------
    def stage_epoch(self, up: np.ndarray, aux: np.ndarray, total: int,
                    max_ins_ref: int, owners: Optional[np.ndarray] = None
                    ) -> tuple:
        """Host→device staging of one side's epoch batch
        (``parallel/join.py:581``): the growth guards on the HOST
        matrices, padding to a multiple of the shard count (pad rows have
        flags 0: routed nowhere), and the routing bucket — skew-exact
        from ``owners`` (per-row owner shards), else the whole local
        block. Returns (up_dev, aux_dev, bucket); both uploads feed this
        side's apply_epoch and its probe of the other side."""
        n = up.shape[0]
        ins_mask = (aux[:, AUX_FLAGS] & FLAG_INS) != 0
        if owners is not None:
            owners = np.asarray(owners)
        if up.dtype == np.int64:
            # a fused raw matrix: the key lanes exist only on the card
            self._guard_keys_blind(int(ins_mask.sum()))
        else:
            self._guard_keys(up[:, :self.key_width], ins_mask,
                             owners if owners is not None
                             and len(owners) == n else None)
        if max_ins_ref >= 0:
            self.reserve_rows(max_ins_ref)
        (up, aux), m = self._pad([up, aux], n)
        local = m // self.n_dev
        bucket = local
        if owners is not None:
            ow = np.full(m, -1, dtype=np.int64)
            routed = aux[:total, AUX_FLAGS] != 0
            ow[:total][routed] = owners[:total][routed]
            bucket = skew_bucket(ow, ow >= 0, self.n_dev, local)
        return upload(up, self.device), upload(aux, self.device), bucket

    def apply_epoch(self, up_dev: torch.Tensor, aux_dev: torch.Tensor,
                    n_rows: int, max_ins_ref: int,
                    bucket: Optional[int] = None) -> None:
        """Apply a whole epoch's inserts and tombstones in one routed
        step, each row at its own sequence (the guards ran at
        stage_epoch). ``up_dev`` starts with the key lanes (int32; a
        fused side's join_prelude output)."""
        del n_rows, max_ins_ref
        m = int(up_dev.shape[0])
        kw = self.key_width
        flags = aux_dev[:, AUX_FLAGS]
        rows = torch.cat([up_dev[:, :kw], aux_dev], dim=1)
        recv, _rv, overflow = self._route(
            rows, (flags & (FLAG_INS | FLAG_DEL)) != 0,
            m // self.n_dev if bucket is None else bucket)
        rf = recv[:, :, kw + AUX_FLAGS]
        stats = self._apply_routed(recv, (rf, FLAG_INS), kw + AUX_INS_REF,
                                   (rf, FLAG_DEL), kw + AUX_DEL_REF,
                                   recv[:, :, kw + AUX_SEQ])
        self._apply_overflows.append((start_fetch(overflow),
                                      start_fetch(stats)))

    def probe_epoch(self, up_dev: torch.Tensor, aux_dev: torch.Tensor,
                    with_degrees: bool, sink=None,
                    bucket: Optional[int] = None
                    ) -> ShardedPendingEpochProbe:
        """Probe a whole epoch's rows against THIS side, each at its aux
        sequence, in one routed step; call after both sides' apply_epoch.
        ``sink`` is accepted for JoinSideKernel parity and unused: the
        sharded path keeps no device degrees. ``bucket`` is the PROBING
        side's stage_epoch bound (the same rows route by the same
        keys)."""
        del sink
        m = int(up_dev.shape[0])
        kw = self.key_width
        bucket = m // self.n_dev if bucket is None else bucket
        rows = torch.cat([up_dev[:, :kw],
                          torch.arange(m, dtype=torch.int32,
                                       device=up_dev.device)[:, None],
                          aux_dev[:, AUX_SEQ:AUX_SEQ + 1]], dim=1)
        valid = (aux_dev[:, AUX_FLAGS] & FLAG_PROBE) != 0

        def dispatch(cap):
            recv, rvalid, overflow = self._route(rows, valid, bucket)
            return self._probe_routed(recv, rvalid, rvalid, -1, kw,
                                      recv[:, :, kw + 1], cap,
                                      with_degrees), overflow

        mats, overflow = dispatch(self.probe_capacity)
        return ShardedPendingEpochProbe(self, mats, overflow, m,
                                        self.probe_capacity, with_degrees,
                                        dispatch)

    def drain_overflows(self) -> None:
        """Fold in the apply steps' lazily fetched flags (an assertion,
        surfaced at the barrier)."""
        flags, self._apply_overflows = self._apply_overflows, []
        for ovf, stats in flags:
            _raise_overflow(ovf, stats, "epoch join rows")
