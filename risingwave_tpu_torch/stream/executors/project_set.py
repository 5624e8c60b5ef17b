"""ProjectSetExecutor: set-returning functions in the SELECT list.

Port of ``risingwave_tpu/stream/executors/project_set.py`` (reference
parity: src/stream/src/executor/project_set.rs). Each input row expands
into the rows its table functions return, with a hidden
``_projected_row_id`` ordinal so equal output rows from different
elements stay distinct in downstream state. Several set-returning items
zip with NULL padding (PostgreSQL >= 10); a row whose functions all
return no rows vanishes.

Stateless: expansion is a function of the row, so a DELETE re-expands to
the matching deletes. Update pairs demote to Delete + Insert: the old and
new rows may expand to different cardinalities. Expansion is host work
(a per-row output count is a data-dependent shape); the expanded chunk
re-enters the device path downstream.

Items: ``("scalar", Expression)`` or ``("series", (start, stop, step))``
with three int64 Expressions (``generate_series``, both ends inclusive).
"""

from __future__ import annotations

from typing import AsyncIterator, List, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.common.chunk import DataChunk, Op, StreamChunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.expr.expr import Expression, InputRef
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import Message, Watermark, is_chunk

Item = Tuple[str, object]


class ProjectSetExecutor(Executor):
    """Row expansion by table functions (project_set.rs analog)."""

    def __init__(self, input_: Executor, items: Sequence[Item],
                 names: Sequence[str], pass_pk: Sequence[int] = ()):
        assert len(items) == len(names)
        if not any(kind != "scalar" for kind, _ in items):
            raise ValueError("ProjectSet needs at least one set-returning "
                             "item")
        fields = []
        for (kind, payload), name in zip(items, names):
            if kind == "scalar":
                fields.append(Field(name, payload.return_type))
            elif kind == "series":
                fields.append(Field(name, DataType.INT64))
            else:
                raise ValueError(f"unknown item kind {kind!r}")
        self.pass_pk = list(pass_pk)
        for j, c in enumerate(self.pass_pk):
            fields.append(Field(f"_ps_pk{j}", input_.schema[c].data_type))
        fields.append(Field("_projected_row_id", DataType.INT64))
        n_items = len(items)
        pk = list(range(n_items, n_items + len(self.pass_pk) + 1))
        super().__init__(ExecutorInfo(Schema(fields), pk,
                                      "ProjectSetExecutor"))
        self.input = input_
        self.items = list(items)
        self.names = list(names)

    async def execute(self) -> AsyncIterator[Message]:
        schema = self.schema
        # positional build: output names may collide (two unaliased
        # generate_series items share a name)
        tmp_schema = Schema([Field(f"_c{i}", f.data_type)
                             for i, f in enumerate(schema)])
        async for msg in self.input.execute():
            if isinstance(msg, Watermark):
                # a watermark survives only through a scalar passthrough
                for j, (kind, payload) in enumerate(self.items):
                    if kind == "scalar" and \
                            isinstance(payload, InputRef) and \
                            payload.index == msg.col_idx:
                        yield Watermark(j, msg.data_type, msg.value)
                        break
                continue
            if not is_chunk(msg):
                yield msg
                continue
            rows, ops = self._expand(msg)
            if not rows:
                continue
            data = {f"_c{i}": [r[i] for r in rows]
                    for i in range(len(schema))}
            out = StreamChunk.from_pydict(tmp_schema, data, ops=ops)
            yield StreamChunk(schema, out.columns, out.visibility, out.ops)

    def _expand(self, msg: StreamChunk):
        # every expression evaluates once per chunk; the host values come
        # out through one temporary DataChunk
        eval_cols, eval_fields = [], []

        def add(expr: Expression):
            eval_cols.append(expr.eval(msg))
            eval_fields.append(
                Field(f"_e{len(eval_fields)}", expr.return_type))

        for kind, payload in self.items:
            if kind == "scalar":
                add(payload)
            else:
                for a in payload:
                    add(a)
        for c in self.pass_pk:
            eval_cols.append(msg.columns[c])
            eval_fields.append(Field(f"_e{len(eval_fields)}",
                                     msg.schema[c].data_type))
        vals = DataChunk(Schema(eval_fields), eval_cols,
                         msg.visibility).to_pylist(compact=False)
        vis = np.asarray(msg.visibility)
        in_ops = np.asarray(msg.ops)

        out_rows: List[tuple] = []
        out_ops: List[int] = []
        for i, row in enumerate(vals):
            if not vis[i]:
                continue
            op = Op(int(in_ops[i]))
            op = Op.DELETE if op == Op.UPDATE_DELETE else (
                Op.INSERT if op == Op.UPDATE_INSERT else op)
            pos = 0
            cells: List[tuple] = []      # per item: ("s", v) / ("f", list)
            n = 0
            for kind, _payload in self.items:
                if kind == "scalar":
                    cells.append(("s", row[pos]))
                    pos += 1
                    continue
                start, stop, step = row[pos], row[pos + 1], row[pos + 2]
                pos += 3
                if start is None or stop is None or step is None \
                        or step == 0:
                    series: List[int] = []
                else:
                    s, e, st = int(start), int(stop), int(step)
                    series = list(range(s, e + (1 if st > 0 else -1), st))
                cells.append(("f", series))
                n = max(n, len(series))
            if n == 0:
                continue                  # every function empty: no row
            pk_vals = tuple(row[pos:])
            for k in range(n):
                out = [v if tag == "s" else (v[k] if k < len(v) else None)
                       for tag, v in cells]
                out_rows.append(tuple(out) + pk_vals + (k,))
                out_ops.append(int(op))
        return out_rows, out_ops
