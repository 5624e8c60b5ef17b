"""Source-connector framework: splits, enumerators, readers, formats.

Port of ``risingwave_tpu/connectors/base.py``, unchanged but for its
imports (pure Python: the port keeps its own copy).

Reference parity: src/connector/src/source/base.rs — SplitEnumerator
(:86, discovers the current split set of an external system) and
SplitReader (:282, consumes one split from a seekable offset). The
in-tree generators (nexmark/datagen/tpch) already satisfy the READER
shape structurally (split_id / offset / seek / next_chunk / schema);
this module gives the contract a name, adds the enumerator half, and
defines the parser seam (src/connector/src/parser/) that turns
external BYTES into typed StreamChunks — the boundary where data the
system did not generate itself enters the dataflow.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import List, Optional, Protocol, runtime_checkable

from risingwave_tpu_torch.common.chunk import StreamChunk
from risingwave_tpu_torch.common.types import Schema


@dataclass(frozen=True)
class SourceSplit:
    """One unit of parallel consumption (base.rs SplitMetaData)."""

    split_id: str
    # connector-specific restart position for a FRESH reader; a
    # recovered reader seeks to its persisted offset instead
    start_offset: int = 0


class SplitEnumerator(abc.ABC):
    """Discovers splits (base.rs:86). Called at CREATE SOURCE and by
    future split-rebalance ticks."""

    @abc.abstractmethod
    def list_splits(self) -> List[SourceSplit]:
        ...


@runtime_checkable
class SplitReader(Protocol):
    """The reader contract every source implements (base.rs:282).

    offset is the EXACT recovery cursor: after seek(offset) the reader
    re-emits precisely the rows that were not yet offset-committed —
    with the source executor's split-state persistence this yields
    exactly-once ingestion into MVs.
    """

    schema: Schema
    offset: int

    @property
    def split_id(self) -> str: ...

    def seek(self, offset: int) -> None: ...

    def next_chunk(self) -> Optional[StreamChunk]: ...
