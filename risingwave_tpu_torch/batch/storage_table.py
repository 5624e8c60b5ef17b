"""StorageTable: the batch side's snapshot reads of a materialized table.

Port of ``risingwave_tpu/batch/storage_table.py`` (reference parity:
src/storage/src/table/batch_table/storage_table.rs:55): a point get and a
full scan over the committed state at a fixed epoch, with the streaming
side's key codec and no memtable. It reads whatever state table the
streaming side committed, an MV or an operator's state (a device agg's
flushed groups included).
"""

from __future__ import annotations

import decimal
from typing import Iterator, List, Optional, Sequence

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, DataChunk, next_pow2
from risingwave_tpu_torch.common.types import (
    DataType, Schema, decimal_to_scaled,
)
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.state.store import StateStore


class StorageTable:
    """A read-only snapshot view of one table id in the state store."""

    def __init__(self, table_id: int, schema: Schema,
                 pk_indices: Sequence[int], store: StateStore,
                 dist_key_indices: Optional[Sequence[int]] = None):
        self.table_id = table_id
        self.schema = schema
        self.pk_indices = list(pk_indices)
        self.store = store
        # StateTable's key codec for point gets (nothing is written)
        self._keys = StateTable(table_id, schema, pk_indices, store,
                                dist_key_indices=dist_key_indices)

    @staticmethod
    def of(state_table: StateTable) -> "StorageTable":
        return StorageTable(state_table.table_id, state_table.schema,
                            state_table.pk_indices, state_table.store,
                            state_table.dist_key_indices)

    def get_row(self, pk_values: Sequence, epoch: int) -> Optional[tuple]:
        key = self._keys._encode_pk(tuple(pk_values))
        return self.store.get(self.table_id, key, epoch)

    def iter_rows(self, epoch: int) -> Iterator[tuple]:
        for _key, row in self.store.iter(self.table_id, epoch):
            yield row

    def scan_chunks(self, epoch: int, chunk_size: int = 1024
                    ) -> Iterator[DataChunk]:
        """The snapshot as DataChunks of ``chunk_size`` rows."""
        buf: List[tuple] = []
        for row in self.iter_rows(epoch):
            buf.append(row)
            if len(buf) >= chunk_size:
                yield rows_to_chunk(self.schema, buf)
                buf = []
        if buf:
            yield rows_to_chunk(self.schema, buf)


def rows_to_chunk(schema: Schema, rows: List[tuple]) -> DataChunk:
    """Row tuples → one DataChunk of host columns.

    A DECIMAL cell may come in either value domain, told apart by its
    type: a scaled int64 (a state row, the scan path) passes through, and
    a ``decimal.Decimal`` (``to_pylist``'s output, which the batch agg,
    join and sort round-trip rows through) is scaled here."""
    n = len(rows)
    cap = next_pow2(max(n, 1))
    cols: List[Column] = []
    for i, f in enumerate(schema):
        vals = [r[i] for r in rows]
        dt = f.data_type
        if dt == DataType.DECIMAL and any(
                isinstance(v, decimal.Decimal) for v in vals):
            vals = [decimal_to_scaled(v) if isinstance(v, decimal.Decimal)
                    else v for v in vals]
        ok = np.ones(cap, dtype=bool)
        has_null = any(v is None for v in vals)
        if has_null:
            ok[:n] = [v is not None for v in vals]
        if dt.is_device:
            arr = np.zeros(cap, dtype=dt.np_dtype)
            arr[:n] = [0 if v is None else v for v in vals] if has_null \
                else vals
        else:
            arr = np.empty(cap, dtype=object)
            arr[:n] = vals
        cols.append(Column(dt, arr, ok if has_null else None))
    vis = np.zeros(cap, dtype=bool)
    vis[:n] = True
    return DataChunk(schema, cols, vis)
