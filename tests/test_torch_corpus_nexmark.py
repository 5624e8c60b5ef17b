"""Nexmark query corpus through the port's SQL front door.

Twins of every Nexmark case of ``tests/test_corpus.py`` (q0, q2, q3, q7,
q9, q10, q14-q20, q22, q101, q103, q105, q106, and q101 over many small
epochs), at its 4,000-event size: the same CREATE SOURCE / CREATE
MATERIALIZED VIEW / SELECT through the reference's ``Frontend`` and the
port's ``Frontend(device="cpu")``, and the MV rows equal — as multisets,
or as lists where the SELECT orders them. Float aggregates (AVG) are
exact here: on the CPU the port's plain versions add in the reference's
order. The TPC-H cases are ``tests/test_torch_corpus_tpch.py``.
"""

import pytest

from tests.test_torch_frontend import (  # noqa: F401 — fixture
    _port_strict_checker, nexmark_source, run_both,
)

N_EVENTS = 4000
GAP_NS = 100_000_000
SOURCES = [nexmark_source(t, N_EVENTS, gap=GAP_NS)
           for t in ("bid", "auction", "person")]

# name -> (CREATE MATERIALIZED VIEW, SELECT), as tests/test_corpus.py
CASES = {
    "q0": ("CREATE MATERIALIZED VIEW q0 AS SELECT auction, bidder, "
           "price, date_time FROM bid", "SELECT * FROM q0"),
    "q2": ("CREATE MATERIALIZED VIEW q2 AS SELECT auction, price FROM "
           "bid WHERE auction = 1007 OR auction = 1020 OR auction = 1040 "
           "OR auction = 1087", "SELECT * FROM q2"),
    "q3": ("CREATE MATERIALIZED VIEW q3 AS SELECT p.name, p.city, "
           "p.state, a.id FROM auction AS a JOIN person AS p "
           "ON a.seller = p.id WHERE a.category = 10 AND "
           "(p.state = 'OR' OR p.state = 'ID' OR p.state = 'CA')",
           "SELECT * FROM q3"),
    "q7": ("CREATE MATERIALIZED VIEW q7 AS "
           "SELECT b.auction, b.price, b.bidder, b.date_time "
           "FROM TUMBLE(bid, date_time, INTERVAL '10' SECOND) AS b "
           "JOIN (SELECT MAX(price) AS maxprice, window_start AS ws "
           "      FROM TUMBLE(bid, date_time, INTERVAL '10' SECOND) "
           "      GROUP BY window_start) AS m "
           "ON b.window_start = m.ws AND b.price = m.maxprice",
           "SELECT * FROM q7"),
    "q9": ("CREATE MATERIALIZED VIEW q9 AS SELECT auction, price, "
           "date_time FROM ("
           "  SELECT auction, price, date_time, row_number() OVER ("
           "    PARTITION BY auction ORDER BY price DESC, date_time ASC"
           "  ) AS rn FROM bid) AS t WHERE rn = 1", "SELECT * FROM q9"),
    "q20": ("CREATE MATERIALIZED VIEW q20 AS SELECT b.auction, b.bidder, "
            "b.price, a.item_name, a.category FROM bid AS b "
            "JOIN auction AS a ON b.auction = a.id WHERE a.category = 12",
            "SELECT * FROM q20"),
    "q101": ("CREATE MATERIALIZED VIEW q101 AS SELECT a.id, a.item_name, "
             "b.max_price FROM auction AS a JOIN ("
             "  SELECT auction, MAX(price) AS max_price FROM bid "
             "  GROUP BY auction) AS b ON a.id = b.auction",
             "SELECT * FROM q101"),
    "q103": ("CREATE MATERIALIZED VIEW q103 AS SELECT a.id, a.item_name "
             "FROM auction AS a JOIN ("
             "  SELECT auction FROM bid GROUP BY auction "
             "  HAVING count(*) >= 15) AS b ON a.id = b.auction",
             "SELECT * FROM q103"),
    "q105": ("CREATE MATERIALIZED VIEW q105 AS SELECT auction, count(*) "
             "AS num FROM bid GROUP BY auction ORDER BY num DESC LIMIT 10",
             "SELECT auction, num FROM q105 ORDER BY num DESC, auction"),
    "q106": ("CREATE MATERIALIZED VIEW q106 AS SELECT MIN(final) AS m "
             "FROM ("
             "  SELECT a.id AS id, MAX(b.price) AS final "
             "  FROM auction AS a JOIN bid AS b ON a.id = b.auction "
             "  WHERE b.date_time BETWEEN a.date_time AND a.expires "
             "  GROUP BY a.id) AS q", "SELECT m FROM q106"),
    "q10": ("CREATE MATERIALIZED VIEW q10 AS SELECT auction, bidder, "
            "price, date_time, to_char(date_time, 'YYYY-MM-DD') AS dt, "
            "to_char(date_time, 'HH24:MI') AS dm FROM bid",
            "SELECT * FROM q10"),
    "q14": ("CREATE MATERIALIZED VIEW q14 AS SELECT auction, bidder, "
            "0.908 * price AS price, CASE "
            "WHEN date_part('hour', date_time) >= 8 AND "
            "date_part('hour', date_time) <= 18 THEN 'dayTime' "
            "WHEN date_part('hour', date_time) <= 6 OR "
            "date_part('hour', date_time) >= 20 THEN 'nightTime' "
            "ELSE 'otherTime' END AS bid_time_type, date_time "
            "FROM bid WHERE 0.908 * price > 1000000",
            "SELECT auction, bidder, price, bid_time_type FROM q14"),
    "q15": ("CREATE MATERIALIZED VIEW q15 AS SELECT "
            "to_char(date_time, 'HH24:MI') AS minute, count(*) AS bids, "
            "count(DISTINCT bidder) AS bidders, "
            "count(DISTINCT auction) AS auctions FROM bid "
            "GROUP BY to_char(date_time, 'HH24:MI')", "SELECT * FROM q15"),
    "q22": ("CREATE MATERIALIZED VIEW q22 AS SELECT auction, bidder, "
            "price, channel, split_part(url, '/', 4) AS dir1, "
            "split_part(url, '/', 5) AS dir2, "
            "split_part(url, '/', 6) AS dir3 FROM bid",
            "SELECT * FROM q22"),
    "q16": ("CREATE MATERIALIZED VIEW q16 AS SELECT channel, "
            "count(*) AS total, "
            "count(*) FILTER (WHERE price < 10000) AS rank1, "
            "count(*) FILTER (WHERE price >= 10000 AND price < 1000000) "
            "AS rank2, "
            "count(*) FILTER (WHERE price >= 1000000) AS rank3, "
            "max(price) FILTER (WHERE price < 10000) AS max1, "
            "avg(price) FILTER (WHERE price < 150) AS avg_tiny "
            "FROM bid GROUP BY channel", "SELECT * FROM q16"),
    "q17": ("CREATE MATERIALIZED VIEW q17 AS SELECT auction, "
            "to_char(date_time, 'YYYY-MM-DD') AS day, count(*) AS total, "
            "count(*) FILTER (WHERE price < 10000) AS r1, "
            "count(*) FILTER (WHERE price >= 10000 AND price < 1000000) "
            "AS r2, count(*) FILTER (WHERE price >= 1000000) AS r3, "
            "min(price) AS mn, max(price) AS mx, sum(price) AS sm "
            "FROM bid GROUP BY auction, to_char(date_time, 'YYYY-MM-DD')",
            "SELECT * FROM q17"),
    "q18": ("CREATE MATERIALIZED VIEW q18 AS SELECT auction, bidder, "
            "price, date_time FROM (SELECT auction, bidder, price, "
            "date_time, row_number() OVER (PARTITION BY bidder, auction "
            "ORDER BY date_time DESC) AS rn FROM bid) AS t WHERE rn = 1",
            "SELECT * FROM q18"),
    "q19": ("CREATE MATERIALIZED VIEW q19 AS SELECT auction, bidder, "
            "price FROM (SELECT auction, bidder, price, row_number() "
            "OVER (PARTITION BY auction ORDER BY price DESC) AS rn "
            "FROM bid) AS t WHERE rn <= 10", "SELECT * FROM q19"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_nexmark_corpus_case_matches_reference(name):
    mv, select = CASES[name]
    out = run_both(SOURCES + [mv, 12, select], min_chunks=8)
    assert out[-1], f"{name} produced no rows at this size"


def test_nexmark_q101_small_epochs_no_stale_rows_twin():
    """Many small epochs: per-epoch MAX updates retract through the join
    by the derived table's pk."""
    sources = [nexmark_source(t, N_EVENTS, gap=GAP_NS, chunk=64)
               for t in ("bid", "auction")]
    out = run_both(sources + [
        "CREATE MATERIALIZED VIEW q101s AS SELECT a.id, b.m "
        "FROM auction AS a JOIN ("
        "  SELECT auction, MAX(price) AS m FROM bid "
        "  GROUP BY auction) AS b ON a.id = b.auction", 40,
        "SELECT * FROM q101s"], min_chunks=2, rate_limit=2)
    assert out[-1]
