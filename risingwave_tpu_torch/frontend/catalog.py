"""Catalog: named sources / materialized views + id allocation.

Reference parity: src/meta/src/manager/catalog/mod.rs:135 (the meta
CatalogManager) + the frontend's read mirror — collapsed to one
in-process structure for the single-node deployment shape.

Copied from ``risingwave_tpu/frontend/catalog.py`` unchanged but for
its imports (pure Python: the port keeps its own copy).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from risingwave_tpu_torch.common.types import Schema


@dataclass
class SourceCatalog:
    name: str
    source_id: int
    schema: Schema
    options: Dict[str, str]


@dataclass
class MvCatalog:
    name: str
    table_id: int
    schema: Schema
    pk_indices: List[int]
    definition: str
    actor_id: int = 0
    dependent_sources: List[str] = field(default_factory=list)
    # catalog id-counter value when this MV was planned: a reschedule
    # replans the same definition from the same base so every state
    # table gets its ORIGINAL id back (state survives the replan)
    id_base: int = -1
    # user-facing column count; trailing columns past it are hidden
    # plumbing (_row_id, unprojected group keys) that SELECT * and
    # downstream scopes must not expose (None = all visible)
    n_visible: Optional[int] = None
    # CREATE TABLE jobs share this registry; system catalogs and SHOW
    # split on it
    is_table: bool = False
    # planner-proved append-only changelog (no retractions ever):
    # sinks chained FROM this MV derive their mode from this proof
    # without re-walking the MV's executor tree
    append_only: bool = False

    @property
    def visible_schema(self) -> Schema:
        if self.n_visible is None:
            return self.schema
        return Schema(list(self.schema)[:self.n_visible])


@dataclass
class SinkCatalog:
    name: str
    actor_id: int
    options: Dict[str, str]
    definition: str = ""
    dependent_sources: List[str] = field(default_factory=list)
    # exactly-once epoch-segment sinks (connectors/sink.py): the
    # derived record mode and writer count, kept so ctl/rw_sinks can
    # rebuild the target from options without replanning
    mode: str = ""               # "append" | "upsert" | "" (legacy)
    n_writers: int = 1


class Catalog:
    def __init__(self) -> None:
        self.sources: Dict[str, SourceCatalog] = {}
        self.mvs: Dict[str, MvCatalog] = {}
        self.sinks: Dict[str, SinkCatalog] = {}
        self._next_id = 1

    def next_id(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    def _check_free(self, name: str) -> None:
        if name in self.sources or name in self.mvs or name in self.sinks:
            raise ValueError(f"catalog object {name!r} already exists")

    def add_source(self, name: str, schema: Schema,
                   options: Dict[str, str]) -> SourceCatalog:
        self._check_free(name)
        sc = SourceCatalog(name, self.next_id(), schema, options)
        self.sources[name] = sc
        return sc

    def add_mv(self, mv: MvCatalog) -> None:
        self._check_free(mv.name)
        self.mvs[mv.name] = mv

    def add_sink(self, sk: SinkCatalog) -> None:
        self._check_free(sk.name)
        self.sinks[sk.name] = sk

    def resolve(self, name: str):
        if name in self.sources:
            return self.sources[name]
        if name in self.mvs:
            return self.mvs[name]
        raise KeyError(f"unknown relation {name!r}")
