"""Batch engine: ad-hoc queries over committed snapshots.

Port of ``risingwave_tpu/batch`` (reference parity: src/batch/, the
pull-based executor tree of src/batch/src/executor/mod.rs:92 that serves
``SELECT`` over StorageTable snapshots at the committed epoch). The
executors are host numpy and Python over the streaming side's DataChunk;
``batch/task.py`` runs the staged, vnode-partitioned plan.
"""

from risingwave_tpu_torch.batch.storage_table import StorageTable
from risingwave_tpu_torch.batch.executors import (
    BatchExecutor, BatchFilter, BatchHashAgg, BatchHashJoin, BatchLimit,
    BatchOrderBy, BatchProject, BatchValues, RowSeqScan, collect,
)

__all__ = [
    "StorageTable", "BatchExecutor", "RowSeqScan", "BatchFilter",
    "BatchProject", "BatchHashAgg", "BatchHashJoin", "BatchOrderBy",
    "BatchLimit", "BatchValues", "collect",
]
