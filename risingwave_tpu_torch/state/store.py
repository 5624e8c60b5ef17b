"""State store: epoch-MVCC KV with table namespaces.

Port of ``risingwave_tpu/state/store.py``: the interface and the
in-memory store (the hummock-lite LSM is not ported yet).

Reference parity: src/storage/src/store.rs:72 (StateStoreRead: get/iter),
:198 (LocalStateStore: ingest at epoch, seal), and memory.rs
(MemoryStateStore — the BTreeMap fake every executor test runs on).

Re-design notes: keys are vnode-prefixed memcomparable bytes; values are
host row tuples (serialization to bytes happens at the hummock-lite SST
boundary, not here). MVCC: per key we keep (epoch, value|None) versions,
newest first; a read at epoch e sees the newest version with epoch <= e.
Tombstones are value=None.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

Value = Optional[tuple]            # None = tombstone
Versions = List[Tuple[int, Value]]  # newest-first [(epoch, value)]


class StateStore:
    """Interface of the state stores (only MemoryStateStore is ported;
    the hummock-lite LSM will implement it too)."""

    def ingest_batch(self, table_id: int,
                     batch: Iterable[Tuple[bytes, Value]],
                     epoch: int) -> int:
        raise NotImplementedError

    def ingest_keyed(self, table_id: int, keys: List[bytes],
                     values: List[Value], epoch: int) -> int:
        """Bulk ingest of parallel key/value lists (keys unique —
        memtable-drained). Backends may take a C-speed merge path;
        the default delegates to ingest_batch."""
        return self.ingest_batch(table_id, zip(keys, values), epoch)

    def get(self, table_id: int, key: bytes, epoch: int) -> Value:
        raise NotImplementedError

    def iter(self, table_id: int, epoch: int,
             start: Optional[bytes] = None, end: Optional[bytes] = None
             ) -> Iterator[Tuple[bytes, tuple]]:
        raise NotImplementedError

    def seal_epoch(self, epoch: int, is_checkpoint: bool) -> None:
        """Global order point: no further writes at <= epoch."""

    def sync(self, epoch: int) -> dict:
        """Await all data at <= epoch durable; returns uploadinfo."""
        return {}

    def committed_epoch(self) -> int:
        """Latest durably committed (checkpoint) epoch — the recovery
        point the initial barrier's `prev` is set to after a restart."""
        return 0


class _Table:
    """One table's ordered MVCC map: sorted key index + version lists.

    The key index is LAZILY sorted: puts append (O(1)) and set a dirty
    flag; the first ordered read re-sorts. Timsort on a sorted prefix +
    appended tail is near O(n) — while ``bisect.insort`` per new key is
    O(n) EACH, which made streaming ingest quadratic in table size (the
    r3 join benches spent most of their p99 barrier here)."""

    __slots__ = ("keys", "versions", "_dirty")

    def __init__(self) -> None:
        self.keys: List[bytes] = []          # sorted iff not _dirty
        self.versions: Dict[bytes, Versions] = {}
        self._dirty = False

    def sorted_keys(self) -> List[bytes]:
        if self._dirty:
            self.keys.sort()
            self._dirty = False
        return self.keys

    def put_batch(self, batch: Iterable[Tuple[bytes, Value]],
                  epoch: int) -> int:
        """Barrier-flush hot loop (one call per written key per
        epoch; a method call per key costs ~1/3 of q8 throughput).
        Inlines put()'s new-key insert and newest-at-head update —
        the in-order cases every barrier flush hits — and falls back
        to put() only for out-of-order epoch ingest. Keep the two in
        lockstep with put() below."""
        versions = self.versions
        keys = self.keys
        n = 0
        for key, value in batch:
            vs = versions.get(key)
            if vs is None:
                versions[key] = [(epoch, value)]
                keys.append(key)
                self._dirty = True
            else:
                if type(vs) is tuple:       # bulk-ingest single-version
                    vs = versions[key] = [vs]       # form: normalize
                e0 = vs[0][0]
                if e0 == epoch:
                    vs[0] = (epoch, value)
                elif e0 < epoch:
                    vs.insert(0, (epoch, value))
                else:
                    self.put(key, epoch, value)
            n += 1
        return n

    def put(self, key: bytes, epoch: int, value: Value) -> None:
        vs = self.versions.get(key)
        if vs is None:
            self.versions[key] = [(epoch, value)]
            self.keys.append(key)
            self._dirty = True
            return
        if type(vs) is tuple:
            vs = self.versions[key] = [vs]
        # keep newest-first order even for out-of-order epoch ingest;
        # same-epoch overwrite replaces (linear scan: version lists are short)
        for i, (e, _v) in enumerate(vs):
            if e == epoch:
                vs[i] = (epoch, value)
                return
            if e < epoch:
                vs.insert(i, (epoch, value))
                return
        vs.append((epoch, value))

    def read(self, key: bytes, epoch: int) -> Value:
        vs = self.versions.get(key)
        if not vs:
            return None
        if type(vs) is tuple:           # single-version fast form
            return vs[1] if vs[0] <= epoch else None
        for e, v in vs:
            if e <= epoch:
                return v
        return None


class MemoryStateStore(StateStore):
    """In-memory MVCC store (memory.rs analog) — the test/checkpoint fake."""

    def __init__(self) -> None:
        self._tables: Dict[int, _Table] = {}
        self._sealed_epoch = 0
        self._committed_epoch = 0

    def _table(self, table_id: int) -> _Table:
        t = self._tables.get(table_id)
        if t is None:
            t = self._tables[table_id] = _Table()
        return t

    # -- write path ----------------------------------------------------
    def ingest_batch(self, table_id: int,
                     batch: Iterable[Tuple[bytes, Value]],
                     epoch: int) -> int:
        if epoch <= self._sealed_epoch:
            raise ValueError(
                f"write at epoch {epoch} <= sealed {self._sealed_epoch}")
        return self._table(table_id).put_batch(batch, epoch)

    def ingest_keyed(self, table_id: int, keys: List[bytes],
                     values: List[Value], epoch: int) -> int:
        if epoch <= self._sealed_epoch:
            raise ValueError(
                f"write at epoch {epoch} <= sealed {self._sealed_epoch}")
        t = self._table(table_id)
        versions = t.versions
        if versions.keys().isdisjoint(keys):
            # all-fresh bulk path (append-only streams): one C-speed
            # dict merge of BARE (epoch, value) versions — the
            # single-version tuple fast form (_Table normalizes it to
            # a list on the first subsequent mutation), built by
            # zip(repeat, …) with no python-level per-row work at all
            # (the [(epoch, v)] list-per-row was the top q1 host_emit
            # cost in the r10 profile)
            from itertools import repeat
            before = len(versions)
            versions.update(zip(keys, zip(repeat(epoch), values)))
            if len(versions) - before == len(keys):
                t.keys.extend(keys)
            else:
                # intra-batch duplicate pks (a blind NO_CHECK upstream
                # re-inserting one key in an epoch): versions resolved
                # last-wins above, but the key INDEX must stay unique
                # or scans would yield the row twice forever
                t.keys.extend(dict.fromkeys(keys))
            t._dirty = True
            return len(keys)
        return t.put_batch(zip(keys, values), epoch)

    def seal_epoch(self, epoch: int, is_checkpoint: bool = True) -> None:
        assert epoch >= self._sealed_epoch, (epoch, self._sealed_epoch)
        self._sealed_epoch = epoch

    def sync(self, epoch: int) -> dict:
        self._committed_epoch = max(self._committed_epoch, epoch)
        return {}

    def committed_epoch(self) -> int:
        return self._committed_epoch

    # -- read path -----------------------------------------------------
    def get(self, table_id: int, key: bytes, epoch: int) -> Value:
        return self._table(table_id).read(key, epoch)

    def iter(self, table_id: int, epoch: int,
             start: Optional[bytes] = None, end: Optional[bytes] = None,
             reverse: bool = False) -> Iterator[Tuple[bytes, tuple]]:
        t = self._table(table_id)
        keys = t.sorted_keys()
        lo = bisect.bisect_left(keys, start) if start is not None else 0
        hi = bisect.bisect_left(keys, end) if end is not None else len(keys)
        rng = range(hi - 1, lo - 1, -1) if reverse else range(lo, hi)
        for i in rng:
            key = keys[i]
            v = t.read(key, epoch)
            if v is not None:
                yield key, v
