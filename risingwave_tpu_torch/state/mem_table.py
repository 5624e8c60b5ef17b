"""MemTable: per-executor buffer of uncommitted key ops.

Port of ``risingwave_tpu/state/mem_table.py`` (unchanged semantics).

Reference parity: src/storage/src/mem_table.rs:44,53 — buffered
KeyOp{Insert,Delete,Update} with inconsistent-operation detection, merged
into the state store at barrier commit.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional, Tuple


class MemTableError(Exception):
    pass


class KeyOp(enum.Enum):
    INSERT = "insert"
    DELETE = "delete"
    UPDATE = "update"


class MemTable:
    """key → (op, old_value, new_value); op merge rules match mem_table.rs."""

    def __init__(self, sanity_check: bool = True):
        self._ops: Dict[bytes, Tuple[KeyOp, Optional[tuple],
                                     Optional[tuple]]] = {}
        self.sanity_check = sanity_check

    def __len__(self) -> int:
        return len(self._ops)

    def is_dirty(self) -> bool:
        return bool(self._ops)

    def insert_batch(self, keys, values) -> bool:
        """All-insert bulk path: ONE C-speed dict merge when every key
        is fresh (the append-only hot case — a method call per row cost
        ~1/3 of q8 host throughput). Returns False when any key is
        already buffered or duplicated in the batch: the caller must
        then run the per-row merge rules instead."""
        new = dict(zip(keys, values))
        if len(new) != len(keys) or not self._ops.keys().isdisjoint(new):
            return False
        ins = KeyOp.INSERT
        # listcomp + C-level zip beats a genexpr-fed update by ~25%
        # at 100K rows/epoch (the r10 host_emit profile)
        self._ops.update(zip(new.keys(),
                             [(ins, None, v) for v in new.values()]))
        return True

    def drain_bulk(self):
        """(keys, values) lists for ingest_keyed; clears. Same content
        as drain(), shaped for the store's bulk ingest."""
        ops, self._ops = self._ops, {}
        keys = list(ops.keys())
        delete = KeyOp.DELETE
        vals = [None if op is delete else new
                for (op, _old, new) in ops.values()]
        return keys, vals

    def insert(self, key: bytes, value: tuple) -> None:
        cur = self._ops.get(key)
        if cur is None:
            self._ops[key] = (KeyOp.INSERT, None, value)
            return
        op, old, _new = cur
        if op == KeyOp.INSERT:
            if self.sanity_check:
                raise MemTableError(f"double insert on key {key!r}")
            self._ops[key] = (KeyOp.INSERT, None, value)
        elif op == KeyOp.DELETE:
            self._ops[key] = (KeyOp.UPDATE, old, value)
        else:  # UPDATE = delete-then-insert already happened
            if self.sanity_check:
                raise MemTableError(f"insert after update on key {key!r}")
            self._ops[key] = (KeyOp.UPDATE, old, value)

    def delete(self, key: bytes, old_value: tuple) -> None:
        cur = self._ops.get(key)
        if cur is None:
            self._ops[key] = (KeyOp.DELETE, old_value, None)
            return
        op, old, _new = cur
        if op == KeyOp.INSERT:
            del self._ops[key]          # insert+delete annihilate
        elif op == KeyOp.DELETE:
            if self.sanity_check:
                raise MemTableError(f"double delete on key {key!r}")
        else:  # UPDATE
            self._ops[key] = (KeyOp.DELETE, old, None)

    def update(self, key: bytes, old_value: tuple, new_value: tuple) -> None:
        cur = self._ops.get(key)
        if cur is None:
            self._ops[key] = (KeyOp.UPDATE, old_value, new_value)
            return
        op, old, new = cur
        if op == KeyOp.INSERT:
            if self.sanity_check and new != old_value:
                raise MemTableError(
                    f"update old {old_value!r} != buffered insert {new!r}")
            self._ops[key] = (KeyOp.INSERT, None, new_value)
        elif op == KeyOp.DELETE:
            if self.sanity_check:
                raise MemTableError(f"update after delete on key {key!r}")
            self._ops[key] = (KeyOp.UPDATE, old, new_value)
        else:
            self._ops[key] = (KeyOp.UPDATE, old, new_value)

    def get(self, key: bytes):
        """(present, value) — present=False means 'no buffered op'."""
        cur = self._ops.get(key)
        if cur is None:
            return False, None
        op, _old, new = cur
        return True, (new if op != KeyOp.DELETE else None)

    def iter_ops(self):
        return iter(sorted(self._ops.items()))
