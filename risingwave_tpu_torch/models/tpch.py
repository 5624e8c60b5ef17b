"""Hand-built TPC-H streaming pipeline: q3 (two chained joins → DECIMAL
revenue agg → top 10).

Port of ``risingwave_tpu/models/tpch.py`` (``build_q3``, :64), on
e2e_test/streaming/tpch/q3's semantics:

    SELECT l_orderkey, SUM(l_extendedprice * (1 - l_discount)) AS
           revenue, o_orderdate, o_shippriority
    FROM customer, orders, lineitem
    WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
      AND l_orderkey = o_orderkey AND o_orderdate < DATE '1995-03-15'
      AND l_shipdate > DATE '1995-03-15'
    GROUP BY l_orderkey, o_orderdate, o_shippriority
    ORDER BY revenue DESC, o_orderdate LIMIT 10

The plan: three TPC-H sources → filters, each with a generated
``_row_id`` → customer ⋈ orders on custkey → (that) ⋈ lineitem on
orderkey, join 1's pk as join 2's left state-table pk → the DECIMAL
revenue projection (scaled int64, exact; the product truncates toward
zero) → append-only SUM per (l_orderkey, o_orderdate, o_shippriority) on
the device → plain TopN (revenue DESC, o_orderdate, ties by the pk) →
materialize. Capacities are presized from the known cardinalities, as
the reference's ``j_opts`` do; join 2's right side outgrows them at SF1
(the key table to 2^21, the rows to 2^22).

``device=None`` means the card, ``device="cpu"`` the kernels' plain
versions. ``fusion=True`` rewrites the plan with the fragment fusion
rule: the agg absorbs the revenue projection (``agg_prelude`` with
``OP_DECMUL``), and each join side absorbs what the rule lets it (the
orders and lineitem filters with their row ids; the customer side's
VARCHAR predicate stays on the host). The reference's monitoring and
freshness hooks (``install_monitoring``, ``_register_freshness``) belong
to the observability slice and are left out, as in the port's other
``build_*`` functions.
"""

from __future__ import annotations

import datetime
from typing import Optional

from risingwave_tpu_torch.common.chunk import presize_cap, presize_flush_cap
from risingwave_tpu_torch.common.types import DataType
from risingwave_tpu_torch.connectors.tpch import (
    LINES_PER_ORDER, TpchConfig, TpchSplitReader,
)
from risingwave_tpu_torch.expr.expr import InputRef, lit
from risingwave_tpu_torch.models.nexmark import (
    Pipeline, _check_store, _finish, _reader_source,
)
from risingwave_tpu_torch.ops.hash_agg import AggKind
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.stream.actor import LocalBarrierManager
from risingwave_tpu_torch.stream.executors.hash_agg import (
    AggCall, HashAggExecutor, agg_state_schema,
)
from risingwave_tpu_torch.stream.executors.hash_join import HashJoinExecutor
from risingwave_tpu_torch.stream.executors.materialize import (
    MaterializeExecutor,
)
from risingwave_tpu_torch.stream.executors.row_id_gen import RowIdGenExecutor
from risingwave_tpu_torch.stream.executors.simple import (
    FilterExecutor, ProjectExecutor,
)
from risingwave_tpu_torch.stream.executors.top_n import GroupTopNExecutor
from risingwave_tpu_torch.utils.device import resolve_device

EPOCH_DAY = datetime.date(1970, 1, 1)
CUTOFF = (datetime.date(1995, 3, 15) - EPOCH_DAY).days
Q3_TOP = 10                              # rows of the MV


def build_q3(store, customers: int = 300, orders: int = 3000,
             rate_limit: Optional[int] = 8,
             min_chunks: Optional[int] = None,
             fusion: bool = False, device=None) -> Pipeline:
    """q3 over ``customers`` customers and ``orders`` orders (TPC-H SF1:
    150,000 and 1,500,000), driven by its three readers {1: customer, 2:
    orders, 3: lineitem}."""
    _check_store(store)
    device = resolve_device(device)
    local = LocalBarrierManager()

    cust, ordr, line = (
        _reader_source(local, store, i, TpchSplitReader(TpchConfig(
            table=t, customers=customers, orders=orders)), i, rate_limit,
            min_chunks)
        for i, t in ((1, "customer"), (2, "orders"), (3, "lineitem")))

    n_line = orders * LINES_PER_ORDER
    j_opts = {"key_capacity": presize_cap(n_line),
              "row_capacity": presize_cap(n_line),
              "probe_capacity": 1 << 16}

    cs = cust.schema
    c_f = RowIdGenExecutor(FilterExecutor(
        cust, InputRef(cs.index_of("c_mktsegment"), DataType.VARCHAR)
        == lit("BUILDING")))
    os_ = ordr.schema
    o_f = RowIdGenExecutor(FilterExecutor(
        ordr, InputRef(os_.index_of("o_orderdate"), DataType.DATE)
        < lit(CUTOFF, DataType.DATE)))
    ls = line.schema
    l_f = RowIdGenExecutor(FilterExecutor(
        line, InputRef(ls.index_of("l_shipdate"), DataType.DATE)
        > lit(CUTOFF, DataType.DATE)))

    # join 1: customer ⋈ orders on custkey
    j1_lt = StateTable(4, c_f.schema, [len(c_f.schema) - 1], store)
    j1_rt = StateTable(5, o_f.schema, [len(o_f.schema) - 1], store)
    j1 = HashJoinExecutor(
        c_f, o_f,
        left_keys=[c_f.schema.index_of("c_custkey")],
        right_keys=[o_f.schema.index_of("o_custkey")],
        left_table=j1_lt, right_table=j1_rt, shard_opts=j_opts,
        device=device)

    # join 2: (customer ⋈ orders) ⋈ lineitem on orderkey
    j2_lt = StateTable(6, j1.schema, list(j1.pk_indices), store)
    j2_rt = StateTable(7, l_f.schema, [len(l_f.schema) - 1], store)
    j2 = HashJoinExecutor(
        j1, l_f,
        left_keys=[j1.schema.index_of("o_orderkey")],
        right_keys=[l_f.schema.index_of("l_orderkey")],
        left_table=j2_lt, right_table=j2_rt, shard_opts=j_opts,
        device=device)

    js = j2.schema
    revenue = (InputRef(js.index_of("l_extendedprice"), DataType.DECIMAL)
               * (lit(1, DataType.DECIMAL)
                  - InputRef(js.index_of("l_discount"),
                             DataType.DECIMAL)))
    proj = ProjectExecutor(
        j2,
        exprs=[InputRef(js.index_of("l_orderkey"), DataType.INT64),
               InputRef(js.index_of("o_orderdate"), DataType.DATE),
               InputRef(js.index_of("o_shippriority"), DataType.INT32),
               revenue],
        names=["l_orderkey", "o_orderdate", "o_shippriority", "revenue"])

    calls = [AggCall(AggKind.SUM, 3)]
    agg_sch, agg_pk = agg_state_schema(proj.schema, [0, 1, 2], calls)
    agg = HashAggExecutor(
        proj, [0, 1, 2], calls,
        StateTable(8, agg_sch, agg_pk, store, dist_key_indices=[0]),
        append_only=True,
        output_names=["l_orderkey", "o_orderdate", "o_shippriority",
                      "revenue"],
        kernel_capacity=presize_cap(orders, 1 << 18),
        flush_capacity=presize_flush_cap(orders), device=device)

    topn_state = StateTable(9, agg.schema, [0, 1, 2], store)
    topn = GroupTopNExecutor(
        agg, order_by=[(3, True), (1, False)], offset=0,
        limit=Q3_TOP, state=topn_state, pk_indices=[0, 1, 2])

    mv = StateTable(10, topn.schema, [0, 1, 2], store)
    mat = MaterializeExecutor(topn, mv)
    return _finish(local, store, mat, mv, 11,
                   {1: cust.reader, 2: ordr.reader, 3: line.reader},
                   "tpch-q3", fusion, device)
