"""TPC-H query corpus through the port's SQL front door.

Twins of every TPC-H case of ``tests/test_corpus.py`` (q1, q6, q10, q18)
at its size (300 customers, 2,000 orders): the same SQL through the
reference's ``Frontend`` and the port's ``Frontend(device="cpu")``, the
MV rows equal — DECIMAL sums and products as the same exact Decimals.
"""

import pytest

from tests.test_torch_frontend import (  # noqa: F401 — fixture
    _port_strict_checker, run_both,
)

CUSTOMERS, ORDERS = 300, 2000
SOURCES = [
    "CREATE SOURCE {t} WITH (connector='tpch', tpch.table='{t}', "
    "tpch.customers={c}, tpch.orders={o})".format(t=t, c=CUSTOMERS,
                                                  o=ORDERS)
    for t in ("customer", "orders", "lineitem")
]

# name -> (CREATE MATERIALIZED VIEW, SELECT, steps), as tests/test_corpus.py
CASES = {
    "q1": ("CREATE MATERIALIZED VIEW q1 AS SELECT l_returnflag, "
           "l_linestatus, sum(l_quantity) AS sum_qty, "
           "sum(l_extendedprice) AS sum_base, count(*) AS cnt "
           "FROM lineitem GROUP BY l_returnflag, l_linestatus",
           "SELECT * FROM q1 ORDER BY l_returnflag, l_linestatus", 12),
    "q6": ("CREATE MATERIALIZED VIEW q6 AS SELECT "
           "sum(l_extendedprice * l_discount) AS revenue FROM lineitem "
           "WHERE l_discount BETWEEN 0.03 AND 0.07 AND l_quantity < 24",
           "SELECT revenue FROM q6", 12),
    "q10": ("CREATE MATERIALIZED VIEW q10 AS SELECT c.c_custkey, "
            "c.c_name, sum(l.l_extendedprice * (1.0 - l.l_discount)) "
            "AS revenue FROM customer AS c "
            "JOIN orders AS o ON c.c_custkey = o.o_custkey "
            "JOIN lineitem AS l ON o.o_orderkey = l.l_orderkey "
            "WHERE l.l_returnflag = 'R' "
            "GROUP BY c.c_custkey, c.c_name "
            "ORDER BY revenue DESC LIMIT 20",
            "SELECT * FROM q10 ORDER BY revenue DESC, c_custkey", 16),
    "q18": ("CREATE MATERIALIZED VIEW q18 AS SELECT o.o_orderkey, "
            "o.o_orderdate, b.total FROM orders AS o JOIN ("
            "  SELECT l_orderkey, sum(l_quantity) AS total FROM lineitem "
            "  GROUP BY l_orderkey HAVING sum(l_quantity) > 140"
            ") AS b ON o.o_orderkey = b.l_orderkey",
            "SELECT * FROM q18", 16),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tpch_corpus_case_matches_reference(name):
    mv, select, steps = CASES[name]
    out = run_both(SOURCES + [mv, steps, select], min_chunks=8)
    assert out[-1], f"{name} produced no rows at this size"
