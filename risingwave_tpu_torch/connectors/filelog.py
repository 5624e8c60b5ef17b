"""File-log source: Kafka-shaped ingestion from append-only log files.

Port of ``risingwave_tpu/connectors/filelog.py`` without its
segmented reader (``SegmentedFileLogReader``, :273): that reads a
filelog SINK's output, and sinks are ``ROADMAP.md`` queue A item 13, so
the planner refuses ``segmented='true'`` naming it.

Reference parity: the Kafka source family
(src/connector/src/source/kafka/ — enumerator.rs lists partitions,
source/reader.rs consumes one partition from an offset). The external
system here is a DIRECTORY of append-only partition files
``<topic>-<partition>.log`` (newline-delimited records) — the same
protocol shape without a broker: partitions are discovered by the
enumerator, each split tails one file from a BYTE offset, and the
offset is the exact recovery cursor (a restarted reader re-emits
precisely the suffix the last checkpoint had not committed).
Producers append records (optionally fsync) with any tool — the
framework finally ingests bytes it did not generate itself.

SQL surface::

    CREATE SOURCE t (a INT, b VARCHAR)
    WITH (connector='filelog', path='/data/logs', topic='t',
          format='json')
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

from risingwave_tpu_torch.common.chunk import StreamChunk
from risingwave_tpu_torch.common.types import Schema
from risingwave_tpu_torch.connectors.base import SourceSplit, SplitEnumerator
from risingwave_tpu_torch.connectors.parser import RowParser, make_parser

_PART_RE = re.compile(r"^(?P<topic>.+)-(?P<part>\d+)\.log$")


# block size for the bulk read path: big enough that a typical chunk's
# records arrive in one read, small enough that an over-read past the
# line limit stays cheap (the tail re-seeks by returned `consumed`)
_READ_BLOCK = 1 << 20


def _read_complete_records(f, payloads: List[bytes],
                           limit: int) -> int:
    """Append up to `limit` COMPLETE newline-terminated records from an
    open file handle; returns bytes consumed. A trailing line without
    its newline is a torn write (or segment end) and stays unconsumed —
    the one 'complete record' protocol both readers share.

    Reads in blocks and splits at C speed (a readline per record
    costs ~1 s at 200K records). Callers advance their offset by the returned byte
    count, so over-reading past `limit` lines costs nothing — the
    unconsumed suffix is simply not counted."""
    consumed = 0
    pending = b""
    while len(payloads) < limit:
        block = f.read(_READ_BLOCK)
        if not block:
            break
        data = pending + block
        # only COMPLETE lines: the suffix after the last newline is
        # torn (or mid-write) and carries over / stays unconsumed
        cut = data.rfind(b"\n")
        if cut < 0:
            pending = data
            continue
        lines = data[:cut].split(b"\n")
        rest = limit - len(payloads)
        if len(lines) > rest:
            lines = lines[:rest]
            # consumed bytes = the kept lines + their newlines (any
            # carried-over pending prefix is part of the first line)
            consumed += sum(map(len, lines)) + len(lines)
            payloads.extend(
                ln.rstrip(b"\r") for ln in lines if ln.rstrip(b"\r"))
            return consumed
        consumed += cut + 1          # includes the pending prefix
        # the partial line past the last newline carries into the
        # next block — dropping it would corrupt any record that
        # straddles a read-block boundary
        pending = data[cut + 1:]
        payloads.extend(
            ln.rstrip(b"\r") for ln in lines if ln.rstrip(b"\r"))
    return consumed



def partition_path(path: str, topic: str, partition: int) -> str:
    return os.path.join(path, f"{topic}-{partition}.log")


class FileLogEnumerator(SplitEnumerator):
    """Lists ``<topic>-<N>.log`` partition files (enumerator.rs)."""

    def __init__(self, path: str, topic: str):
        self.path = path
        self.topic = topic

    def list_splits(self) -> List[SourceSplit]:
        out = []
        try:
            names = sorted(os.listdir(self.path))
        except FileNotFoundError:
            return []
        for name in names:
            m = _PART_RE.match(name)
            if m and m.group("topic") == self.topic:
                out.append(SourceSplit(
                    split_id=f"filelog-{self.topic}-"
                             f"{int(m.group('part'))}"))
        return out


class FileLogSplitReader:
    """Tails one partition file from a byte offset (SplitReader).

    The offset is the BYTE position after the last fully-consumed
    record — torn trailing writes (no newline yet) stay unconsumed
    until the producer completes them, so a record is never half-read.
    """

    # log sources never finish: None from next_chunk means "idle",
    # not "exhausted" (SourceExecutor parks on the barrier channel)
    unbounded = True

    def __init__(self, path: str, topic: str, partition: int,
                 schema: Schema, fmt: str = "json",
                 max_chunk_size: int = 1024, offset: int = 0,
                 options=None):
        self.path = path
        self.topic = topic
        self.partition = partition
        self.schema = schema
        self.parser: RowParser = make_parser(fmt, schema, options)
        self.max_chunk_size = int(max_chunk_size)
        self.offset = int(offset)
        # exact emitted-row counter: the offset is BYTES (the recovery
        # cursor); throughput accounting needs rows
        self.rows_read = 0

    @property
    def split_id(self) -> str:
        return f"filelog-{self.topic}-{self.partition}"

    @property
    def file_path(self) -> str:
        return partition_path(self.path, self.topic, self.partition)

    def seek(self, offset: int) -> None:
        self.offset = int(offset)

    def next_chunk(self) -> Optional[StreamChunk]:
        """Read up to max_chunk_size complete records from the offset.

        Returns None when no complete record is available (the stream
        idles until the producer appends more — unlike the bounded
        generators, a log source never 'finishes')."""
        try:
            with open(self.file_path, "rb") as f:
                f.seek(self.offset)
                payloads: List[bytes] = []
                consumed = _read_complete_records(
                    f, payloads, self.max_chunk_size)
        except FileNotFoundError:
            return None
        if not payloads:
            return None
        chunk = self.parser.build_chunk(payloads)
        # advance past malformed records too (they are counted by the
        # parser) — re-reading them forever would wedge the split
        self.offset += consumed
        self.rows_read += chunk.cardinality()
        return chunk


class FileLogMultiReader:
    """One source actor driving SEVERAL partition splits (the split-
    rebalancing contract): the scheduler assigns each source
    actor a partition subset and stamps it into the shipped plan; this
    reader round-robins over per-partition ``FileLogSplitReader``s so
    no split starves, and exposes the per-split byte offsets —
    ``splits()`` / ``seek_split()`` — that the SourceExecutor persists
    one row per split. On rescale, each split's offset row migrates to
    its new owner's namespace and the new reader resumes from exactly
    that byte: no record lost, none re-read.

    An EMPTY partition set is legal (scale-out past the partition
    count): the reader idles forever and the actor just forwards
    barriers."""

    unbounded = True

    def __init__(self, path: str, topic: str, partitions,
                 schema: Schema, fmt: str = "json",
                 max_chunk_size: int = 1024, options=None):
        self.path = path
        self.topic = topic
        self.partitions = [int(p) for p in partitions]
        self.schema = schema
        self.readers = [FileLogSplitReader(
            path, topic, p, schema, fmt=fmt,
            max_chunk_size=max_chunk_size, options=options)
            for p in self.partitions]
        self._rr = 0

    @property
    def split_id(self) -> str:
        parts = "+".join(str(p) for p in self.partitions) or "none"
        return f"filelog-{self.topic}-p{parts}"

    @property
    def offset(self) -> int:
        """Aggregate byte position (throughput accounting only — the
        recovery cursors are the PER-SPLIT offsets)."""
        return sum(r.offset for r in self.readers)

    @property
    def rows_read(self) -> int:
        return sum(r.rows_read for r in self.readers)

    # -- the per-split offset contract ---------------------------------
    def splits(self) -> List[tuple]:
        """[(split_id, byte offset)] — one durable row per split."""
        return [(r.split_id, r.offset) for r in self.readers]

    def seek_split(self, split_id: str, offset: int) -> None:
        for r in self.readers:
            if r.split_id == split_id:
                r.seek(offset)
                return

    def seek(self, offset: int) -> None:
        """Aggregate seek is meaningless across splits — recovery goes
        through ``seek_split`` (SourceExecutor's multi-split path); a
        fresh deployment starts every split at 0 anyway."""

    def next_chunk(self) -> Optional[StreamChunk]:
        """Round-robin the splits, starting after the last producer so
        a hot partition cannot starve its siblings."""
        n = len(self.readers)
        for i in range(n):
            r = self.readers[(self._rr + i) % n]
            chunk = r.next_chunk()
            if chunk is not None:
                self._rr = (self._rr + i + 1) % n
                return chunk
        return None
