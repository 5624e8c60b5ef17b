"""TPC-H table generators (streaming form): customer, orders and lineitem,
plus the q5 dimension tables supplier, nation and region.

Port of ``risingwave_tpu/connectors/tpch.py``: the six schemas,
``LINES_PER_ORDER`` (:99), ``TpchConfig`` (:103), the generators and
``TpchSplitReader`` (:214), with the same counter-based mix, so both
packages generate the same chunks bit for bit (DECIMAL as scaled int64).

Reference parity: the role of the TPC-H corpus the reference streams in
e2e_test/streaming/tpch/ (tables loaded as append-only streams). Rows are
a pure function of their ordinal: a chunk is one vectorized pass over an
ordinal range, so a reader is replayable by absolute offset (``seek``).
Scale is set by row counts (``customers``, ``orders``): TPC-H SF1 is
150,000 customers and 1,500,000 orders (4 lines an order here).

The name columns (``c_name``, ``s_name``) are formatted by one
``np.char.mod`` over the chunk rather than a python f-string a row: the
same strings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk, next_pow2
from risingwave_tpu_torch.common.types import DataType, Field, Schema

CUSTOMER_SCHEMA = Schema([
    Field("c_custkey", DataType.INT64),
    Field("c_name", DataType.VARCHAR),
    Field("c_mktsegment", DataType.VARCHAR),
    Field("c_nationkey", DataType.INT64),
])

ORDERS_SCHEMA = Schema([
    Field("o_orderkey", DataType.INT64),
    Field("o_custkey", DataType.INT64),
    Field("o_orderdate", DataType.DATE),
    Field("o_shippriority", DataType.INT32),
])

LINEITEM_SCHEMA = Schema([
    Field("l_orderkey", DataType.INT64),
    Field("l_extendedprice", DataType.DECIMAL),
    Field("l_discount", DataType.DECIMAL),
    Field("l_shipdate", DataType.DATE),
    Field("l_suppkey", DataType.INT64),
    Field("l_quantity", DataType.INT64),
    Field("l_tax", DataType.DECIMAL),
    Field("l_returnflag", DataType.VARCHAR),
    Field("l_linestatus", DataType.VARCHAR),
])

SUPPLIER_SCHEMA = Schema([
    Field("s_suppkey", DataType.INT64),
    Field("s_name", DataType.VARCHAR),
    Field("s_nationkey", DataType.INT64),
])

NATION_SCHEMA = Schema([
    Field("n_nationkey", DataType.INT64),
    Field("n_name", DataType.VARCHAR),
    Field("n_regionkey", DataType.INT64),
])

REGION_SCHEMA = Schema([
    Field("r_regionkey", DataType.INT64),
    Field("r_name", DataType.VARCHAR),
])

_RETURNFLAGS = np.array(["R", "A", "N"], dtype=object)
_LINESTATUS = np.array(["O", "F"], dtype=object)

# the 25 nations and 5 regions of the TPC-H spec (nation → region)
NATION_NAMES = np.array([
    "ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
    "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ",
    "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU",
    "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA",
    "UNITED KINGDOM", "UNITED STATES"], dtype=object)
NATION_REGIONS = np.array([0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4,
                           0, 0, 0, 1, 2, 3, 4, 2, 3, 3, 1],
                          dtype=np.int64)
REGION_NAMES = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE",
                         "MIDDLE EAST"], dtype=object)
SUPPLIERS = 100                     # matches l_suppkey ∈ 1..100

TABLE_SCHEMAS = {
    "customer": CUSTOMER_SCHEMA,
    "orders": ORDERS_SCHEMA,
    "lineitem": LINEITEM_SCHEMA,
    "supplier": SUPPLIER_SCHEMA,
    "nation": NATION_SCHEMA,
    "region": REGION_SCHEMA,
}

SEGMENTS = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
                     "HOUSEHOLD"], dtype=object)

# date domain: 1992-01-01 .. 1998-08-02 as days since the epoch (int32)
DATE_LO = 8035      # 1992-01-01
DATE_HI = 10440     # 1998-08-02
LINES_PER_ORDER = 4


@dataclass
class TpchConfig:
    table: str = "lineitem"
    customers: int = 1500           # SF0.01-ish proportions
    orders: int = 15000
    row_count: Optional[int] = None  # rows of THIS table to emit
    max_chunk_size: int = 1024
    seed: int = 0x7C9

    @property
    def total_rows(self) -> int:
        if self.row_count is not None:
            return self.row_count
        if self.table == "customer":
            return self.customers
        if self.table == "orders":
            return self.orders
        if self.table == "supplier":
            return SUPPLIERS
        if self.table == "nation":
            return len(NATION_NAMES)
        if self.table == "region":
            return len(REGION_NAMES)
        return self.orders * LINES_PER_ORDER


def _mix(k: np.ndarray, seed: int) -> np.ndarray:
    """splitmix64's finalizer over ordinal + seed * golden ratio."""
    x = (k.astype(np.uint64)
         + np.uint64((seed * 0x9E3779B97F4A7C15) & (2**64 - 1)))
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def _names(prefix: str, k: np.ndarray) -> np.ndarray:
    """f"{prefix}#{k + 1:09d}" a row, formatted in one pass."""
    return np.char.mod(prefix + "#%09d", k + 1).astype(object)


def gen_customer(k: np.ndarray, cfg: TpchConfig) -> Dict[str, np.ndarray]:
    return {
        "c_custkey": k + 1,
        "c_name": _names("Customer", k),
        "c_mktsegment": SEGMENTS[
            (_mix(k, cfg.seed + 1) % 5).astype(np.int64)],
        "c_nationkey": (_mix(k, cfg.seed + 2) % 25).astype(np.int64),
    }


def gen_orders(k: np.ndarray, cfg: TpchConfig) -> Dict[str, np.ndarray]:
    return {
        "o_orderkey": k + 1,
        "o_custkey": (_mix(k, cfg.seed + 3)
                      % cfg.customers).astype(np.int64) + 1,
        "o_orderdate": (DATE_LO + _mix(k, cfg.seed + 4)
                        % (DATE_HI - DATE_LO)).astype(np.int32),
        "o_shippriority": np.zeros(len(k), dtype=np.int32),
    }


def gen_lineitem(k: np.ndarray, cfg: TpchConfig) -> Dict[str, np.ndarray]:
    order_k = k // LINES_PER_ORDER
    price_cents = (_mix(k, cfg.seed + 5) % 104949).astype(np.int64) + 10001
    discount_pct = (_mix(k, cfg.seed + 6) % 11).astype(np.int64)  # 0..0.10
    ship_delay = (_mix(k, cfg.seed + 7) % 122).astype(np.int64)
    odate = (DATE_LO + _mix(order_k, cfg.seed + 4)
             % (DATE_HI - DATE_LO)).astype(np.int64)
    return {
        "l_orderkey": order_k + 1,
        # DECIMAL's physical form: scaled int64 (4 fractional digits)
        "l_extendedprice": price_cents * 100,
        "l_discount": discount_pct * 100,          # 0.00..0.10
        "l_shipdate": (odate + 1 + ship_delay).astype(np.int32),
        "l_suppkey": (_mix(k, cfg.seed + 8) % 100).astype(np.int64) + 1,
        "l_quantity": (_mix(k, cfg.seed + 9) % 50).astype(np.int64) + 1,
        "l_tax": (_mix(k, cfg.seed + 10) % 9).astype(np.int64) * 100,
        "l_returnflag": _RETURNFLAGS[
            (_mix(k, cfg.seed + 11) % 3).astype(np.int64)],
        "l_linestatus": _LINESTATUS[
            (_mix(k, cfg.seed + 12) % 2).astype(np.int64)],
    }


def gen_supplier(k: np.ndarray, cfg: TpchConfig) -> Dict[str, np.ndarray]:
    return {
        "s_suppkey": k + 1,
        "s_name": _names("Supplier", k),
        "s_nationkey": (_mix(k, cfg.seed + 13) % 25).astype(np.int64),
    }


def gen_nation(k: np.ndarray, cfg: TpchConfig) -> Dict[str, np.ndarray]:
    return {
        "n_nationkey": k.astype(np.int64),
        "n_name": NATION_NAMES[k],
        "n_regionkey": NATION_REGIONS[k],
    }


def gen_region(k: np.ndarray, cfg: TpchConfig) -> Dict[str, np.ndarray]:
    return {
        "r_regionkey": k.astype(np.int64),
        "r_name": REGION_NAMES[k],
    }


_GENERATORS = {"customer": gen_customer, "orders": gen_orders,
               "lineitem": gen_lineitem, "supplier": gen_supplier,
               "nation": gen_nation, "region": gen_region}


class TpchSplitReader:
    """One table's split, replayable by absolute row offset (the split
    state a source persists is that offset; recovery is ``seek``)."""

    def __init__(self, cfg: TpchConfig, offset: int = 0):
        assert cfg.table in _GENERATORS, cfg.table
        self.cfg = cfg
        self.schema = TABLE_SCHEMAS[cfg.table]
        self.split_id = f"tpch-{cfg.table}-0"
        self.offset = offset

    def seek(self, offset: int) -> None:
        self.offset = offset

    def next_chunk(self) -> Optional[StreamChunk]:
        n = min(self.cfg.max_chunk_size,
                self.cfg.total_rows - self.offset)
        if n <= 0:
            return None
        k = np.arange(self.offset, self.offset + n, dtype=np.int64)
        self.offset += n
        data = _GENERATORS[self.cfg.table](k, self.cfg)
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
        ops = np.full(cap, int(Op.INSERT), dtype=np.int8)
        return StreamChunk(self.schema, cols, vis, ops)
