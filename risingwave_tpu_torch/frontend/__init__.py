"""SQL frontend: parse → bind → plan → rewrite → deploy/execute.

Port of ``risingwave_tpu/frontend`` for one device (reference parity:
src/sqlparser/, src/frontend/src/{binder,planner,optimizer,handler}/):
CREATE SOURCE / CREATE MATERIALIZED VIEW deployed as live streaming
pipelines on the card's kernels (over sources, tables or other MVs, at
parallelism 1 or over logical shards of the card), CREATE TABLE and DML,
batch SELECT over committed MV snapshots, EXPLAIN, SET / SHOW, ALTER ...
SET PARALLELISM, DROP, one process, one session, served over the
PostgreSQL wire by ``pgwire.PgServer``. The fragmenter comes with
``ROADMAP.md`` item 10d.
"""

from risingwave_tpu_torch.frontend.session import Frontend

__all__ = ["Frontend"]
