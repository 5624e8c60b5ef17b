"""Datagen source: deterministic synthetic rows from WITH options.

Port of ``risingwave_tpu/connectors/datagen.py``, unchanged but for
its imports, so both packages generate the same chunks bit for bit.

Reference parity: src/connector/src/source/datagen/ — per-field
sequence/random generators configured via `fields.<name>.*` WITH
options (the reference reads field types from DDL columns; here the
type rides in `fields.<name>.type`, keeping CREATE SOURCE one
statement). Generation is whole-chunk vectorized numpy keyed by the
absolute row offset, so a seek makes replay exact (split recovery
contract, same as the nexmark reader).

Options:
    connector = 'datagen'
    datagen.rows.per.chunk  (default 1024)
    datagen.event.num       (default unbounded)
    fields.<name>.type      bigint | double | varchar | timestamp
    fields.<name>.kind      sequence | random       (default sequence)
    fields.<name>.start / .end      sequence bounds (wraps at end)
    fields.<name>.min / .max        random bounds
    fields.<name>.seed              per-field seed offset
    fields.<name>.length            varchar length (random strings)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, StreamChunk, next_pow2
from risingwave_tpu_torch.common.types import DataType, Field, Schema

_TYPES = {
    "bigint": DataType.INT64, "int": DataType.INT32,
    "integer": DataType.INT32, "smallint": DataType.INT16,
    "double": DataType.FLOAT64, "real": DataType.FLOAT32,
    "varchar": DataType.VARCHAR, "timestamp": DataType.TIMESTAMP,
    "boolean": DataType.BOOLEAN,
}


@dataclass
class FieldSpec:
    name: str
    data_type: DataType
    kind: str = "sequence"               # sequence | random
    start: int = 0
    end: int = (1 << 62)
    vmin: float = 0
    vmax: float = 100
    seed: int = 0
    length: int = 8


@dataclass
class DatagenConfig:
    fields: List[FieldSpec] = field(default_factory=list)
    rows_per_chunk: int = 1024
    event_num: int = 1 << 62
    seed: int = 0xDA7A

    @property
    def schema(self) -> Schema:
        return Schema([Field(f.name, f.data_type) for f in self.fields])

    @staticmethod
    def from_options(opts: Dict[str, str]) -> "DatagenConfig":
        cfg = DatagenConfig(
            rows_per_chunk=int(opts.get("datagen.rows.per.chunk", 1024)),
            event_num=int(opts.get("datagen.event.num", 1 << 62)),
            seed=int(opts.get("datagen.seed", 0xDA7A)),
        )
        specs: Dict[str, FieldSpec] = {}
        order: List[str] = []
        for key, val in opts.items():
            if not key.startswith("fields."):
                continue
            _prefix, name, prop = key.split(".", 2)
            if name not in specs:
                specs[name] = FieldSpec(name, DataType.INT64)
                order.append(name)
            s = specs[name]
            if prop == "type":
                s.data_type = _TYPES[val.lower()]
            elif prop == "kind":
                s.kind = val.lower()
            elif prop == "start":
                s.start = int(val)
            elif prop == "end":
                s.end = int(val)
            elif prop == "min":
                s.vmin = float(val)
            elif prop == "max":
                s.vmax = float(val)
            elif prop == "seed":
                s.seed = int(val)
            elif prop == "length":
                s.length = int(val)
            else:
                raise ValueError(f"unknown datagen option {key!r}")
        if not order:
            raise ValueError("datagen needs at least one fields.<name>.*")
        cfg.fields = [specs[n] for n in order]
        return cfg


def _mix(k: np.ndarray, seed: int) -> np.ndarray:
    """splitmix-style stateless mix of row offsets (uint64)."""
    gamma = (seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = (k.astype(np.uint64) + np.uint64(gamma)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def gen_rows(k: np.ndarray, cfg: DatagenConfig) -> Dict[str, np.ndarray]:
    """Absolute offsets → column arrays (vectorized, replayable)."""
    out: Dict[str, np.ndarray] = {}
    for f in cfg.fields:
        if f.kind == "sequence":
            span = max(1, f.end - f.start)
            vals = f.start + (k % span)
            if f.data_type == DataType.FLOAT64 or \
                    f.data_type == DataType.FLOAT32:
                out[f.name] = vals.astype(f.data_type.np_dtype)
            elif f.data_type == DataType.VARCHAR:
                out[f.name] = np.array(
                    [f"{f.name}_{v}" for v in vals.tolist()], dtype=object)
            else:
                out[f.name] = vals.astype(f.data_type.np_dtype)
        elif f.kind == "random":
            bits = _mix(k, cfg.seed + f.seed + hash(f.name) % (1 << 31))
            u = (bits >> np.uint64(11)).astype(np.float64) / float(1 << 53)
            if f.data_type == DataType.VARCHAR:
                letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
                idx = np.stack([
                    (_mix(k, cfg.seed + f.seed + i) % 26).astype(np.int64)
                    for i in range(f.length)], axis=1)
                out[f.name] = np.array(
                    ["".join(letters[row]) for row in idx], dtype=object)
            elif f.data_type in (DataType.FLOAT64, DataType.FLOAT32):
                out[f.name] = (f.vmin + u * (f.vmax - f.vmin)).astype(
                    f.data_type.np_dtype)
            elif f.data_type == DataType.BOOLEAN:
                out[f.name] = (bits & np.uint64(1)).astype(bool)
            else:
                vals = (f.vmin + u * (f.vmax - f.vmin + 1)).astype(np.int64)
                out[f.name] = np.minimum(
                    vals, int(f.vmax)).astype(f.data_type.np_dtype)
        else:
            raise ValueError(f"unknown datagen kind {f.kind!r}")
    return out


class DatagenSplitReader:
    """Replayable split reader (SplitReader protocol)."""

    def __init__(self, cfg: DatagenConfig, offset: int = 0):
        self.cfg = cfg
        self.schema = cfg.schema
        self.split_id = "datagen-0"
        self.offset = offset

    def seek(self, offset: int) -> None:
        self.offset = offset

    def next_chunk(self) -> Optional[StreamChunk]:
        n = min(self.cfg.rows_per_chunk, self.cfg.event_num - self.offset)
        if n <= 0:
            return None
        k = np.arange(self.offset, self.offset + n, dtype=np.int64)
        self.offset += n
        data = gen_rows(k, self.cfg)
        cap = next_pow2(n)
        cols = []
        for f in self.schema:
            arr = data[f.name]
            if f.data_type.is_device:
                full = np.zeros(cap, dtype=f.data_type.np_dtype)
            else:
                full = np.empty(cap, dtype=object)
            full[:n] = arr
            cols.append(Column(f.data_type, full, None))
        vis = np.zeros(cap, dtype=bool)
        vis[:n] = True
        from risingwave_tpu_torch.common.chunk import Op
        ops = np.full(cap, int(Op.INSERT), dtype=np.int8)
        return StreamChunk(self.schema, cols, vis, ops)
