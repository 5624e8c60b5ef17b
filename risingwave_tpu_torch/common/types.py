"""Logical SQL types and their physical representation.

Port of ``risingwave_tpu/common/types.py`` (reference parity: ``DataType``
in src/common/src/types/mod.rs:99-160). Every type picks a *physical*
representation: a numpy dtype for "device" types (fixed-width values that
kernels can take as lanes) or a host object column (varchar/jsonb — strings
never ship to the device). Physical dtypes are the reference's, as numpy.
"""

from __future__ import annotations

import decimal
import enum
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

# DECIMAL physical representation: fixed-point int64, 4 fractional decimal
# digits (like SQL money). Exact for add/sub/compare — the operations money
# aggregates need — with documented bounds: |value| < 9.2e14 and products
# must fit int64 before rescale. The reference's Decimal (types/decimal.rs)
# is 28-digit arbitrary-scale; we trade generality for a representation
# kernels can aggregate natively with retraction-exact sums.
DECIMAL_SCALE_DIGITS = 4
DECIMAL_SCALE = 10 ** DECIMAL_SCALE_DIGITS


# int64 bound of the scaled domain: |value| < 2^63 / 10^4 ≈ 9.2e14.
# Beyond it the fixed-point payload would WRAP silently — every
# ingest/cast boundary funnels through decimal_to_scaled, so the check
# lives here, once.
_SCALED_MAX = (1 << 63) - 1


class DecimalOverflowError(ValueError):
    """A DECIMAL value left the int64 fixed-point domain."""


def decimal_to_scaled(v) -> int:
    """Python number → scaled int64 payload (banker-free, half-up
    round). Raises DecimalOverflowError instead of silently wrapping
    when |scaled| exceeds int64 (~9.2e14 in value units)."""
    if isinstance(v, int):
        scaled = v * DECIMAL_SCALE
    else:
        d = v if isinstance(v, decimal.Decimal) \
            else decimal.Decimal(str(v))
        scaled = int((d * DECIMAL_SCALE).to_integral_value(
            rounding=decimal.ROUND_HALF_UP))
    if not -_SCALED_MAX <= scaled <= _SCALED_MAX:
        raise DecimalOverflowError(
            f"DECIMAL value {v} overflows the int64 fixed-point "
            f"domain (|value| must stay under "
            f"{_SCALED_MAX // DECIMAL_SCALE})")
    return scaled


def scaled_to_decimal(raw: int) -> decimal.Decimal:
    return decimal.Decimal(int(raw)) / DECIMAL_SCALE


@dataclass(frozen=True)
class Interval:
    """Calendar interval: (months, days, microseconds) triple.

    Reference parity: src/common/src/types/interval.rs — the three components
    do NOT fold into each other (a month is not a fixed number of days).
    Comparison/equality use the *justified* value (month = 30 days), matching
    the reference's IntervalCmpValue: INTERVAL '30 days' == INTERVAL
    '1 month'. Interval columns live on host; device window arithmetic uses
    ``exact_usecs()`` of *literal* intervals at plan-build time.
    """

    months: int = 0
    days: int = 0
    usecs: int = 0

    USECS_PER_DAY = 86_400_000_000
    USECS_PER_MONTH_APPROX = 30 * 86_400_000_000  # justified comparison

    def _justified_usecs(self) -> int:
        return (self.months * Interval.USECS_PER_MONTH_APPROX
                + self.days * Interval.USECS_PER_DAY + self.usecs)

    def __eq__(self, other):
        if not isinstance(other, Interval):
            return NotImplemented
        return self._justified_usecs() == other._justified_usecs()

    def __hash__(self):
        return hash(self._justified_usecs())

    def __lt__(self, other: "Interval"):
        return self._justified_usecs() < other._justified_usecs()

    def __le__(self, other: "Interval"):
        return self._justified_usecs() <= other._justified_usecs()

    def __gt__(self, other: "Interval"):
        return self._justified_usecs() > other._justified_usecs()

    def __ge__(self, other: "Interval"):
        return self._justified_usecs() >= other._justified_usecs()

    def exact_usecs(self) -> int:
        """Total µs for month-free intervals; raises if months != 0."""
        if self.months:
            raise ValueError(
                f"interval {self!r} has calendar months; no exact µs length")
        return self.days * Interval.USECS_PER_DAY + self.usecs

    def __add__(self, other: "Interval") -> "Interval":
        return Interval(self.months + other.months, self.days + other.days,
                        self.usecs + other.usecs)

    def __neg__(self) -> "Interval":
        return Interval(-self.months, -self.days, -self.usecs)


class DataType(enum.Enum):
    """Logical SQL data types (reference: src/common/src/types/mod.rs:99)."""

    BOOLEAN = "boolean"
    INT16 = "smallint"
    INT32 = "int"
    INT64 = "bigint"
    FLOAT32 = "real"
    FLOAT64 = "double precision"
    DECIMAL = "numeric"          # physical: scaled int64 fixed-point (exact)
    DATE = "date"                # days since epoch, int32
    TIME = "time"                # microseconds since midnight, int64
    TIMESTAMP = "timestamp"      # microseconds since unix epoch, int64
    TIMESTAMPTZ = "timestamptz"  # microseconds since unix epoch (UTC), int64
    INTERVAL = "interval"        # host column of Interval triples
    VARCHAR = "varchar"          # host column (numpy object)
    BYTEA = "bytea"              # host column
    JSONB = "jsonb"              # host column
    SERIAL = "serial"            # int64 row id
    INT256 = "rw_int256"         # host column (python int); device later
    STRUCT = "struct"            # host column of tuples
    LIST = "list"                # host column of lists

    # ------------------------------------------------------------------
    @property
    def is_device(self) -> bool:
        """Whether values of this type are fixed-width device lanes."""
        return self not in _HOST_TYPES

    @property
    def dtype(self) -> Optional[np.dtype]:
        """Physical numpy dtype for device types; None for host types."""
        return _PHYSICAL.get(self)

    @property
    def np_dtype(self):
        d = _PHYSICAL.get(self)
        return np.dtype(object) if d is None else np.dtype(d)


_HOST_TYPES = frozenset({DataType.VARCHAR, DataType.BYTEA, DataType.JSONB,
                         DataType.INTERVAL, DataType.INT256, DataType.STRUCT,
                         DataType.LIST})

_PHYSICAL = {
    DataType.BOOLEAN: np.bool_,
    DataType.INT16: np.int16,
    DataType.INT32: np.int32,
    DataType.INT64: np.int64,
    DataType.FLOAT32: np.float32,
    DataType.FLOAT64: np.float64,
    DataType.DECIMAL: np.int64,
    DataType.DATE: np.int32,
    DataType.TIME: np.int64,
    DataType.TIMESTAMP: np.int64,
    DataType.TIMESTAMPTZ: np.int64,
    DataType.SERIAL: np.int64,
}


@dataclass(frozen=True)
class Field:
    """A named, typed column (reference: src/common/src/catalog/field-like)."""

    name: str
    data_type: DataType

    def __repr__(self) -> str:
        return f"{self.name}:{self.data_type.name.lower()}"


@dataclass(frozen=True)
class Schema:
    """Ordered list of fields describing a chunk/table/executor output."""

    fields: Tuple[Field, ...] = field(default_factory=tuple)

    def __init__(self, fields):
        object.__setattr__(self, "fields", tuple(fields))

    @staticmethod
    def of(**cols: DataType) -> "Schema":
        return Schema([Field(n, t) for n, t in cols.items()])

    def __len__(self) -> int:
        return len(self.fields)

    def __getitem__(self, i: int) -> Field:
        return self.fields[i]

    def __iter__(self):
        return iter(self.fields)

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def names(self):
        return [f.name for f in self.fields]

    def types(self):
        return [f.data_type for f in self.fields]

    def select(self, indices) -> "Schema":
        return Schema([self.fields[i] for i in indices])

    def __repr__(self) -> str:
        return "Schema(" + ", ".join(map(repr, self.fields)) + ")"
