"""Batch task manager: staged, partitioned query execution.

Port of ``risingwave_tpu/batch/task.py`` (reference parity:
src/batch/src/task/ (task_manager.rs, the per-task contexts) and the batch
exchange (src/batch/src/executor/generic_exchange.rs with the hash
shuffle the scheduler puts between stages)). A stage runs N partition
tasks as asyncio coroutines and materializes their output; between
stages an exchange re-partitions rows by the streaming side's vnode hash
of the distribution keys, so batch and streaming agree on who owns a key.

``run_agg`` is the two-stage shape the reference scheduler gives an
aggregation: parallel vnode-range scans, a hash exchange on the group
keys, a HashAgg per partition, and a gather. Its rows equal the
single-task plan's exactly: a group never spans partitions, and an agg
without group keys routes to one partition. Host code: no kernel runs
here.
"""

from __future__ import annotations

import asyncio
from typing import Iterator, List, Optional, Sequence

import numpy as np

from risingwave_tpu_torch.batch.executors import BatchExecutor, BatchHashAgg
from risingwave_tpu_torch.batch.storage_table import StorageTable, rows_to_chunk
from risingwave_tpu_torch.common.chunk import DataChunk
from risingwave_tpu_torch.common.hash import (
    VNODE_COUNT, hash_strings_host, vnodes_of_host,
)
from risingwave_tpu_torch.state.keycodec import encode_vnode_prefix


class VnodeRangeScan(BatchExecutor):
    """A scan of one vnode range of a table: a leaf task's input
    (row_seq_scan with a vnode bitmap in the reference)."""

    def __init__(self, table: StorageTable, epoch: int,
                 vnode_lo: int, vnode_hi: int, chunk_size: int = 1024):
        self.table = table
        self.schema = table.schema
        self.epoch = epoch
        self.lo, self.hi = vnode_lo, vnode_hi
        self.chunk_size = chunk_size

    def execute(self) -> Iterator[DataChunk]:
        start = encode_vnode_prefix(self.lo)
        end = encode_vnode_prefix(self.hi) if self.hi < VNODE_COUNT else None
        # the range is read eagerly: the task yields to the event loop
        # between chunks, and a store must not change under a held scan
        rows = [row for _k, row in self.table.store.iter(
            self.table.table_id, self.epoch, start, end)]
        for at in range(0, len(rows), self.chunk_size):
            yield rows_to_chunk(self.schema, rows[at:at + self.chunk_size])


class _StageSource(BatchExecutor):
    """A stage's input, fed by an exchange (generic_exchange.rs)."""

    def __init__(self, schema, chunks: List[DataChunk]):
        self.schema = schema
        self._chunks = chunks

    def execute(self) -> Iterator[DataChunk]:
        yield from self._chunks


def _hash_partition(chunk: DataChunk, key_indices: Sequence[int],
                    n: int) -> List[List[tuple]]:
    """The chunk's visible rows in n buckets by the vnode hash of the key
    columns: a numeric column hashes its values (a NULL as the zero lane),
    a string column its string hash, as the streaming dispatch does."""
    rows = chunk.to_pylist()
    if not rows:
        return [[] for _ in range(n)]
    if not key_indices:
        return [list(rows)] + [[] for _ in range(n - 1)]
    idx = np.flatnonzero(np.asarray(chunk.visibility))
    lanes = []
    for i in key_indices:
        c = chunk.columns[i]
        vals = np.asarray(c.values)[idx]
        if c.data_type.is_device:
            if c.validity is not None:
                vals = np.where(np.asarray(c.validity)[idx], vals,
                                np.zeros((), dtype=vals.dtype))
            lanes.append(vals)
        else:
            lanes.append(hash_strings_host(np.asarray(vals, dtype=object),
                                           len(idx)))
    owner = (vnodes_of_host(lanes) * n // VNODE_COUNT).astype(np.int64)
    out: List[List[tuple]] = [[] for _ in range(n)]
    for row, o in zip(rows, owner.tolist()):
        out[o].append(row)
    return out


class BatchTaskManager:
    """Runs staged, partitioned batch plans (task_manager.rs analog)."""

    def __init__(self, parallelism: int = 4):
        assert parallelism >= 1
        self.parallelism = parallelism

    async def _run_stage(self, factories) -> List[List[DataChunk]]:
        """One stage's partition tasks, run concurrently."""
        async def one(factory):
            out = []
            for chunk in factory().execute():
                out.append(chunk)
                await asyncio.sleep(0)     # cooperative scheduling
            return out

        return list(await asyncio.gather(*(one(f) for f in factories)))

    async def run_agg(self, table: StorageTable, epoch: int,
                      group_indices: Sequence[int], agg_calls,
                      names: Optional[Sequence[str]] = None
                      ) -> List[tuple]:
        """Parallel scans → hash exchange on the group keys → an agg per
        partition → gather."""
        n = self.parallelism
        step = (VNODE_COUNT + n - 1) // n
        scans = [(lambda lo=lo: VnodeRangeScan(
                     table, epoch, lo, min(lo + step, VNODE_COUNT)))
                 for lo in range(0, VNODE_COUNT, step)]
        scanned = await self._run_stage(scans)
        parts: List[List[tuple]] = [[] for _ in range(n)]
        for chunks in scanned:
            for chunk in chunks:
                for o, rows in enumerate(
                        _hash_partition(chunk, group_indices, n)):
                    parts[o].extend(rows)
        aggs = [(lambda p=p: BatchHashAgg(
                    _StageSource(table.schema,
                                 [rows_to_chunk(table.schema, parts[p])]
                                 if parts[p] else []),
                    list(group_indices), list(agg_calls), names))
                for p in range(n)]
        agged = await self._run_stage(aggs)
        # the gather: the partitions' groups are disjoint, so no merge
        return [row for chunks in agged for chunk in chunks
                for row in chunk.to_pylist()]
