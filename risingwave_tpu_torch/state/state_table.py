"""StateTable: schema-aware, vnode-partitioned view over the state store.

Port of ``risingwave_tpu/state/state_table.py``, without the per-(table,
vnode) topology books and the barrier-domain re-anchor mode (neither is
on the q7 path yet).

Reference parity: src/stream/src/common/table/state_table.rs:76 —
write API insert/delete/update (:746,760,773) buffered in a MemTable;
``commit(new_epoch)`` (:901) flushes the buffer at the sealed epoch;
read API get_row (:587) and iterators (:1092); per-table vnode ownership
bitmap.

This is the *host-side durability seam*. Device-resident
operator state (device hash tables) flushes dirty entries through this API at
every barrier; recovery reads it back to rebuild device state. Keys are
2-byte-vnode-prefixed memcomparable bytes; values are host row tuples.

Rows are PHYSICAL tuples: DECIMAL is its scaled int64, timestamps are µs
ints, NULL is None — the exact representation device kernels flush and
recovery re-uploads (no host conversion on the hot path).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.common.chunk import Op, StreamChunk
from risingwave_tpu_torch.common.epoch import EpochPair
from risingwave_tpu_torch.common.hash import (
    VNODE_COUNT, hash_strings_host, vnodes_of_host,
)
from risingwave_tpu_torch.common.types import DataType, Schema
from risingwave_tpu_torch.state.keycodec import (
    decode_memcomparable, encode_memcomparable, encode_vnode_prefix,
)
from risingwave_tpu_torch.state.mem_table import KeyOp, MemTable
from risingwave_tpu_torch.state.store import StateStore


class StateTable:
    """One logical table of operator state, partitioned by vnode."""

    def __init__(self, table_id: int, schema: Schema,
                 pk_indices: Sequence[int], store: StateStore,
                 dist_key_indices: Optional[Sequence[int]] = None,
                 vnodes: Optional[np.ndarray] = None,
                 sanity_check: bool = True):
        self.table_id = table_id
        self.schema = schema
        self.pk_indices = list(pk_indices)
        self.pk_types = [schema[i].data_type for i in self.pk_indices]
        # dist keys must be a subset of the pk so vnode is derivable from pk
        self.dist_key_indices = (list(dist_key_indices)
                                 if dist_key_indices is not None else [])
        for i in self.dist_key_indices:
            assert i in self.pk_indices, \
                "dist key must be part of the state-table pk"
        self.store = store
        self.mem_table = MemTable(sanity_check=sanity_check)
        # staged all-insert chunk batches (write_chunk(defer=True) —
        # the materialize/join emit hot path): encoded keys + physical
        # rows held OUTSIDE the memtable until flush, skipping the
        # per-row op-merge dict entirely. Invariant: staged batches
        # exist only while the memtable is CLEAN — any interleaved
        # read or non-insert write spills them into the memtable
        # first, restoring the exact merge semantics.
        self._staged_keys: List[List[bytes]] = []
        self._staged_vals: List[List[tuple]] = []
        # ownership bitmap: which vnodes this instance owns (scaling swaps it)
        self.vnodes = (np.ones(VNODE_COUNT, dtype=bool)
                       if vnodes is None else np.asarray(vnodes, dtype=bool))
        self.epoch: Optional[EpochPair] = None

    # -- epoch lifecycle ------------------------------------------------
    def init_epoch(self, epoch: EpochPair) -> None:
        """Set the epoch at which buffered writes will land (recovery/boot)."""
        self.epoch = epoch

    def flush(self) -> Tuple[List[bytes], List, int]:
        """Drain the buffered ops as staged imms — (keys, values,
        write_epoch) — WITHOUT writing through to the store.
        Extraction point only: ``commit`` below is its one caller
        today (the async checkpoint pipeline decouples at the STORE
        level — HummockLite.build_ssts drains imms, not state tables);
        callers that need to route a flush elsewhere (worker shipping,
        tests) take the staged batch from here."""
        assert self.epoch is not None, "init_epoch first"
        if self._staged_keys:
            if self.mem_table.is_dirty():
                # defensive: the staged-while-clean invariant should
                # make this unreachable — merge order-exactly anyway
                self._spill_staged()
            else:
                kbs, vbs = self._staged_keys, self._staged_vals
                self._staged_keys, self._staged_vals = [], []
                if len(kbs) == 1:
                    return kbs[0], vbs[0], self.epoch.curr.value
                return ([k for b in kbs for k in b],
                        [v for b in vbs for v in b],
                        self.epoch.curr.value)
        keys, vals = self.mem_table.drain_bulk()
        return keys, vals, self.epoch.curr.value

    def commit(self, new_epoch: EpochPair) -> int:
        """Flush buffered ops at the sealed (current) epoch; advance.

        Returns the number of flushed entries. state_table.rs:901 analog —
        the caller (actor on barrier) invokes this for every state table,
        then the barrier manager seals the epoch and hands the flush to
        the checkpoint uploader.
        """
        assert self.epoch is not None, "init_epoch first"
        # strict continuity: a prev mismatch means a missed barrier —
        # fail at the fault, not at a later sealed-write rejection
        assert new_epoch.prev == self.epoch.curr, (new_epoch, self.epoch)
        keys, vals, epoch = self.flush()
        n = self.store.ingest_keyed(self.table_id, keys, vals, epoch)
        self.epoch = new_epoch
        return n

    # -- key helpers ----------------------------------------------------
    def _vnode_of_pk(self, pk_values: Sequence) -> int:
        if not self.dist_key_indices:
            return 0  # singleton distribution (VirtualNode::ZERO analog)
        lanes: List[np.ndarray] = []
        for i in self.dist_key_indices:
            dt = self.schema[i].data_type
            v = pk_values[self.pk_indices.index(i)]
            lanes.append(_key_lane(v, dt))
        return int(vnodes_of_host(lanes)[0])

    def _encode_pk(self, pk_values: Sequence) -> bytes:
        vnode = self._vnode_of_pk(pk_values)
        return (encode_vnode_prefix(vnode) +
                encode_memcomparable(pk_values, self.pk_types))

    def pk_of(self, row: Sequence) -> tuple:
        return tuple(row[i] for i in self.pk_indices)

    # -- staged-batch spill (write_chunk(defer=True) fast path) ----------
    def is_dirty(self) -> bool:
        return bool(self._staged_keys) or self.mem_table.is_dirty()

    def _spill_staged(self) -> None:
        """Replay staged all-insert batches into the memtable (in
        arrival order) so interleaved reads/non-insert writes see the
        exact per-key merge semantics the fast path skipped."""
        if not self._staged_keys:
            return
        kbs, vbs = self._staged_keys, self._staged_vals
        self._staged_keys, self._staged_vals = [], []
        mt = self.mem_table
        for keys, rows in zip(kbs, vbs):
            if not mt.insert_batch(keys, rows):
                for key, row in zip(keys, rows):
                    mt.insert(key, row)

    # -- write API -------------------------------------------------------
    def insert(self, row: Sequence) -> None:
        self._spill_staged()
        row = tuple(row)
        self.mem_table.insert(self._encode_pk(self.pk_of(row)), row)

    def delete(self, row: Sequence) -> None:
        self._spill_staged()
        row = tuple(row)
        self.mem_table.delete(self._encode_pk(self.pk_of(row)), row)

    def update(self, old_row: Sequence, new_row: Sequence) -> None:
        self._spill_staged()
        old_row, new_row = tuple(old_row), tuple(new_row)
        ok, nk = self._encode_pk(self.pk_of(old_row)), \
            self._encode_pk(self.pk_of(new_row))
        if ok == nk:
            self.mem_table.update(ok, old_row, new_row)
        else:  # pk changed: delete + insert (reference requires same pk; we allow)
            self.mem_table.delete(ok, old_row)
            self.mem_table.insert(nk, new_row)

    def delete_below_prefix(self, watermark) -> int:
        """Watermark state cleaning (state_table.rs:894 update_watermark):
        delete every row whose FIRST pk column is strictly below the
        watermark. Cost is O(deleted) + an ordered seek per owned vnode
        (rows below a watermark on the pk prefix form a contiguous range
        in memcomparable order). Returns rows deleted."""
        first_pk_type = self.pk_types[0]
        end_suffix = encode_memcomparable([watermark], [first_pk_type])
        deleted = 0
        for vnode in self.owned_vnodes():
            start = encode_vnode_prefix(vnode)
            end = start + end_suffix
            for _pk, row in self._iter_range(start, end):
                self.delete(row)
                deleted += 1
        return deleted

    # -- bulk row API (barrier-flush hot path for device operators) -----
    def insert_rows(self, rows: Sequence[Sequence]) -> None:
        """Batch insert: pk encoding + vnode hashing vectorized over all
        rows (one numpy pass per pk column instead of per-row hashing —
        the r3 profile spent half of q8 in per-row ``_encode_pk``)."""
        self._spill_staged()
        mt = self.mem_table
        keys = self._encode_pk_rows(rows)
        rows_t = [tuple(r) for r in rows]
        if mt.insert_batch(keys, rows_t):
            return
        for key, row in zip(keys, rows_t):
            mt.insert(key, row)

    def delete_rows(self, rows: Sequence[Sequence]) -> None:
        self._spill_staged()
        mt = self.mem_table
        for key, row in zip(self._encode_pk_rows(rows), rows):
            mt.delete(key, tuple(row))

    def update_rows(self, old_rows: Sequence[Sequence],
                    new_rows: Sequence[Sequence]) -> None:
        self._spill_staged()
        mt = self.mem_table
        ok_keys = self._encode_pk_rows(old_rows)
        nk_keys = self._encode_pk_rows(new_rows)
        for ok, nk, old, new in zip(ok_keys, nk_keys, old_rows, new_rows):
            old, new = tuple(old), tuple(new)
            if ok == nk:
                mt.update(ok, old, new)
            else:
                mt.delete(ok, old)
                mt.insert(nk, new)

    def _encode_pk_rows(self, rows: Sequence[Sequence]) -> List[bytes]:
        """Vectorized vnode-prefixed pk keys from row tuples."""
        n = len(rows)
        if n == 0:
            return []
        pk_cols: List[Tuple[np.ndarray, DataType]] = []
        bulk_ok = True
        for i in self.pk_indices:
            dt = self.schema[i].data_type
            col = [r[i] for r in rows]
            if dt not in self._BULK_OK or any(v is None for v in col):
                bulk_ok = False
                break
            pk_cols.append((np.asarray(col, dtype=dt.np_dtype), dt))
        if not bulk_ok:          # rare: varchar/NULL pks → per-row codec
            return [self._encode_pk(self.pk_of(r)) for r in rows]
        if not self.dist_key_indices:
            vnodes = np.zeros(n, dtype=np.int64)
        else:
            # dist keys are a pk subset (asserted in __init__) and the
            # bulk path excludes NULLs/varchar — reuse the arrays the pk
            # pass just built instead of re-extracting per row
            lanes = [pk_cols[self.pk_indices.index(i)][0]
                     for i in self.dist_key_indices]
            vnodes = vnodes_of_host(lanes).astype(np.int64)
        return self._pack_keys(vnodes, pk_cols)

    def write_chunk(self, chunk: StreamChunk,
                    defer: bool = False) -> None:
        """Apply a visible-row StreamChunk — the barrier-flush hot path.

        Fully vectorized up to the memtable: physical row extraction, vnode
        hashing and pk encoding are whole-column numpy passes; only the
        final dict ops are per-row.

        ``defer=True``: all-insert chunks against a clean
        memtable STAGE as (keys, rows) batches and flow to the store as
        one bulk ingest at flush — no per-row memtable dict ops at all.
        Only callers that trust upstream key discipline (the NO_CHECK
        materialize contract, the join's append-fast state writes) pass
        it: the fast path skips the memtable's double-insert sanity
        check, and duplicate pks within one epoch resolve last-wins at
        the store instead of raising. Any interleaved read, delete, or
        row-API write spills the stage first, so mixed epochs keep the
        exact merge semantics.
        """
        idx, rows, ops = chunk.to_physical_records()
        if not rows:
            return
        keys = self._encode_pks_bulk(chunk, idx)
        is_ins = (ops == int(Op.INSERT)) | (ops == int(Op.UPDATE_INSERT))
        if defer and not self.mem_table.is_dirty() and is_ins.all():
            self._staged_keys.append(keys)
            self._staged_vals.append(rows)
            return
        self._spill_staged()
        mt = self.mem_table
        if is_ins.all() and mt.insert_batch(keys, rows):
            return
        for key, row, ins in zip(keys, rows, is_ins.tolist()):
            if ins:
                mt.insert(key, row)
            else:
                mt.delete(key, row)

    # fixed-width device pk types eligible for the bulk encoder
    _BULK_OK = frozenset({
        DataType.INT16, DataType.INT32, DataType.INT64, DataType.SERIAL,
        DataType.DECIMAL, DataType.DATE, DataType.TIME, DataType.TIMESTAMP,
        DataType.TIMESTAMPTZ, DataType.FLOAT32, DataType.FLOAT64,
        DataType.BOOLEAN,
    })

    def _encode_pks_bulk(self, chunk: StreamChunk,
                         idx: np.ndarray) -> List[bytes]:
        """Vectorized vnode-prefixed memcomparable keys for visible rows."""
        n = len(idx)
        # vnodes (vectorized, same math as device dispatch)
        if not self.dist_key_indices:
            vnodes = np.zeros(n, dtype=np.int64)
        else:
            lanes = []
            for i in self.dist_key_indices:
                c = chunk.columns[i]
                vals = np.asarray(c.values)[idx]
                if c.data_type.is_device:
                    if c.validity is not None:
                        # NULL dist-key values hash as the zero lane (same
                        # rule as _key_lane(None)) regardless of buffer fill
                        vals = np.where(np.asarray(c.validity)[idx], vals,
                                        np.zeros((), dtype=vals.dtype))
                    lanes.append(vals)
                else:
                    lanes.append(hash_strings_host(vals, n))
            vnodes = vnodes_of_host(lanes).astype(np.int64)

        pk_cols = [chunk.columns[i] for i in self.pk_indices]
        bulk_ok = all(
            c.data_type in self._BULK_OK and
            (c.validity is None or bool(np.asarray(c.validity)[idx].all()))
            for c in pk_cols)
        if not bulk_ok:  # rare path: varchar/null pks — per-row codec
            out = []
            host_pk = [(np.asarray(c.values)[idx],
                        None if c.validity is None
                        else np.asarray(c.validity)[idx]) for c in pk_cols]
            for j in range(n):
                pk = tuple(
                    None if (val is not None and not val[j])
                    else (vals[j].item() if hasattr(vals[j], "item")
                          else vals[j])
                    for vals, val in host_pk)
                out.append(encode_vnode_prefix(int(vnodes[j]))
                           + encode_memcomparable(pk, self.pk_types))
            return out

        typed = [(np.asarray(c.values)[idx], c.data_type)
                 for c in pk_cols]
        return self._pack_keys(vnodes, typed)

    @staticmethod
    def _pack_keys(vnodes: np.ndarray,
                   cols: Sequence[Tuple[np.ndarray, DataType]]
                   ) -> List[bytes]:
        """Non-null fixed-width pk columns → memcomparable key matrix.

        Layout: [2B vnode][per col: 0x01 + payload]."""
        n = len(vnodes)
        widths = [2] + [1 + (1 if dt == DataType.BOOLEAN else 8)
                        for _v, dt in cols]
        total = sum(widths)
        m = np.empty((n, total), dtype=np.uint8)
        m[:, 0] = (vnodes >> 8).astype(np.uint8)
        m[:, 1] = (vnodes & 0xFF).astype(np.uint8)
        off = 2
        for vals, dt in cols:
            m[:, off] = 1  # non-null tag
            off += 1
            if dt == DataType.BOOLEAN:
                m[:, off] = vals.astype(np.uint8)
                off += 1
                continue
            if dt in (DataType.FLOAT32, DataType.FLOAT64):
                with np.errstate(over="ignore"):
                    f = vals.astype(np.float64)
                    f = np.where(f == 0, 0.0, f)  # -0.0 → 0.0
                    bits = f.view(np.uint64)
                    neg = (bits >> np.uint64(63)) == 1
                    bits = np.where(neg, ~bits,
                                    bits | np.uint64(1 << 63))
            else:
                with np.errstate(over="ignore"):
                    bits = vals.astype(np.int64).view(np.uint64) \
                        + np.uint64(1 << 63)
            be = bits.astype(">u8").view(np.uint8).reshape(n, 8)
            m[:, off:off + 8] = be
            off += 8
        flat = m.tobytes()
        return [flat[i * total:(i + 1) * total] for i in range(n)]

    # -- read API --------------------------------------------------------
    def _read_epoch(self) -> int:
        assert self.epoch is not None, "init_epoch first"
        return self.epoch.prev.value

    def get_row(self, pk_values: Sequence) -> Optional[tuple]:
        self._spill_staged()
        key = self._encode_pk(tuple(pk_values))
        present, value = self.mem_table.get(key)
        if present:
            return value
        return self.store.get(self.table_id, key, self._read_epoch())

    def get_rows(self, rows: Sequence[Sequence]) -> List[Optional[tuple]]:
        """The current row under each given row's pk (None where there is
        none), the pks encoded in one vectorized pass."""
        self._spill_staged()
        out: List[Optional[tuple]] = []
        epoch = self._read_epoch()
        for key in self._encode_pk_rows(rows):
            present, value = self.mem_table.get(key)
            out.append(value if present
                       else self.store.get(self.table_id, key, epoch))
        return out

    def iter_rows(self, vnode: Optional[int] = None,
                  reverse: bool = False
                  ) -> Iterator[Tuple[tuple, tuple]]:
        """Yield (pk, row) in memcomparable pk order (descending with
        `reverse=True` — the backward iterator), memtable merged.

        v0 correctness-first: materializes the committed range then overlays
        buffered ops (the in-memory fake is small; hummock-lite gets a real
        merge iterator).
        """
        if vnode is None:
            start, end = None, None
        else:
            start = encode_vnode_prefix(vnode)
            end = encode_vnode_prefix(vnode + 1) if vnode + 1 < VNODE_COUNT \
                else None
        yield from self._iter_range(start, end, reverse=reverse)

    def iter_prefix(self, prefix_values: Sequence
                    ) -> Iterator[Tuple[tuple, tuple]]:
        """(pk, row) for every pk starting with the given leading pk
        values (state_table.rs:1092 prefix iterators). The prefix must
        cover the dist keys, so the vnode is derivable."""
        k = len(prefix_values)
        for i in self.dist_key_indices:
            assert self.pk_indices.index(i) < k, \
                "prefix must include all dist keys"
        vnode = self._vnode_of_pk(
            list(prefix_values) + [None] * (len(self.pk_indices) - k))
        start = (encode_vnode_prefix(vnode) +
                 encode_memcomparable(prefix_values, self.pk_types[:k]))
        yield from self._iter_range(start, _next_prefix(start))

    def _iter_range_raw(self, start: Optional[bytes],
                        end: Optional[bytes], reverse: bool = False
                        ) -> Iterator[Tuple[bytes, tuple]]:
        self._spill_staged()
        merged = {k: v for k, v in self.store.iter(
            self.table_id, self._read_epoch(), start, end)}
        for key, (op, _old, new) in self.mem_table.iter_ops():
            if start is not None and key < start:
                continue
            if end is not None and key >= end:
                continue
            if op == KeyOp.DELETE:
                merged.pop(key, None)
            else:
                merged[key] = new
        for key in sorted(merged, reverse=reverse):
            yield key, merged[key]

    def _iter_range(self, start: Optional[bytes], end: Optional[bytes],
                    reverse: bool = False
                    ) -> Iterator[Tuple[tuple, tuple]]:
        for key, row in self._iter_range_raw(start, end, reverse):
            yield decode_memcomparable(key[2:], self.pk_types), row

    def owned_vnodes(self) -> List[int]:
        return np.flatnonzero(self.vnodes).tolist()


def _key_lane(v, dt: DataType) -> np.ndarray:
    """One physical scalar → length-1 lane array (device hashing rules).

    NULL hashes as the zero lane — consistent with the bulk encoder's
    treatment of invalid slots, so a NULL dist-key row is addressable."""
    if dt.is_device:
        return np.asarray([0 if v is None else v], dtype=dt.np_dtype)
    return hash_strings_host(np.asarray([v], dtype=object), 1)


def _next_prefix(b: bytes) -> Optional[bytes]:
    """Smallest byte string greater than every string prefixed by b."""
    arr = bytearray(b)
    while arr:
        if arr[-1] != 0xFF:
            arr[-1] += 1
            return bytes(arr)
        arr.pop()
    return None
