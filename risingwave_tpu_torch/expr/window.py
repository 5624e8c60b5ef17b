"""Window functions: kinds, calls and their vectorized evaluation over one
partition.

Port of ``risingwave_tpu/expr/window.py`` (reference parity:
src/expr/src/window_function/{kind.rs:24,call.rs}: RowNumber, Rank,
DenseRank, Lag, Lead and the aggregates). The reference steps one
incremental window state per function row by row; here a partition's
outputs are recomputed as whole-column numpy passes (cumsum, accumulate,
shift), bounded by the partitions an epoch's deltas touch.

The frame is PostgreSQL's default, RANGE BETWEEN UNBOUNDED PRECEDING AND
CURRENT ROW, which reaches to the end of the current row's peer group
(the rows equal under ORDER BY). Integer SUM is an int64 ``np.cumsum``
and wraps on overflow, as the reference's does. This is host code: no
kernel runs here.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.common.types import DataType


class WindowFuncKind(enum.Enum):
    ROW_NUMBER = "row_number"
    RANK = "rank"
    DENSE_RANK = "dense_rank"
    LAG = "lag"
    LEAD = "lead"
    SUM = "sum"
    COUNT = "count"
    MIN = "min"
    MAX = "max"
    FIRST_VALUE = "first_value"
    LAST_VALUE = "last_value"

    @property
    def needs_input(self) -> bool:
        return self not in RANK_KINDS


RANK_KINDS = (WindowFuncKind.ROW_NUMBER, WindowFuncKind.RANK,
              WindowFuncKind.DENSE_RANK)

_INT_TYPES = (DataType.INT16, DataType.INT32, DataType.INT64,
              DataType.SERIAL)


@dataclass(frozen=True)
class WindowCall:
    """One window function over the executor's shared (partition, order)
    window. ``input_idx`` indexes the input schema; ``offset`` is the LAG/
    LEAD distance."""

    kind: WindowFuncKind
    input_idx: Optional[int] = None
    offset: int = 1

    def output_type(self, input_schema) -> DataType:
        if self.kind in RANK_KINDS or self.kind == WindowFuncKind.COUNT:
            return DataType.INT64
        dt = input_schema[self.input_idx].data_type
        if self.kind == WindowFuncKind.SUM and dt in _INT_TYPES:
            return DataType.INT64
        return dt


def _peer_group_bounds(eq_prev: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(group_start[i], group_end_exclusive[i]) of each row's peer group,
    given eq_prev[i] = row i has the same ORDER BY key as row i-1."""
    n = len(eq_prev)
    idx = np.arange(n, dtype=np.int64)
    start = np.maximum.accumulate(np.where(eq_prev, 0, idx))
    is_last = np.ones(n, dtype=bool)
    is_last[:-1] = ~eq_prev[1:]
    # each group's last index + 1, carried backwards over the group
    end = np.minimum.accumulate(
        np.where(is_last, idx + 1, n + 1)[::-1])[::-1]
    return start, end


def _shift(vals: np.ndarray, ok: np.ndarray, lag: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    """vals moved ``lag`` rows later (LAG) or earlier (LEAD, lag < 0);
    rows shifted in from outside the partition are NULL. The values under
    a NULL are left unset (``np.empty_like``), as the reference's are."""
    n = len(vals)
    shifted = np.empty_like(vals)
    sok = np.zeros(n, dtype=bool)
    d = abs(lag)
    if d < n:
        if lag > 0:
            shifted[d:] = vals[:n - d]
            sok[d:] = ok[:n - d]
        else:
            shifted[:n - d] = vals[d:]
            sok[:n - d] = ok[d:]
    return shifted, sok


def _fill(vals: np.ndarray, for_max: bool):
    """The dtype's extreme that never wins a MAX (``for_max``) or a MIN:
    what a NULL becomes before the running MIN/MAX."""
    if np.issubdtype(vals.dtype, np.floating):
        return -np.inf if for_max else np.inf
    info = np.iinfo(vals.dtype if np.issubdtype(vals.dtype, np.integer)
                    else np.int64)
    return info.min if for_max else info.max


def compute_window_outputs(
        calls: Sequence[WindowCall],
        n: int,
        eq_prev: np.ndarray,
        inputs: Sequence[Optional[Tuple[np.ndarray, np.ndarray]]],
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Outputs for one partition whose rows are already in window order.

    eq_prev[i]: row i is an ORDER BY peer of row i-1 (False at 0).
    inputs[j]: (values, nonnull) arrays for call j, or None.
    Returns (values, nonnull) of length n for each call.
    """
    if n == 0:
        return [(np.zeros(0), np.zeros(0, dtype=bool)) for _ in calls]
    eq_prev = np.asarray(eq_prev, dtype=bool)
    start, end = _peer_group_bounds(eq_prev)
    ones = np.ones(n, dtype=bool)
    # the default frame ends at the last row of the current peer group
    at = end - 1
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    for call, inp in zip(calls, inputs):
        k = call.kind
        if k == WindowFuncKind.ROW_NUMBER:
            out.append((np.arange(1, n + 1, dtype=np.int64), ones.copy()))
        elif k == WindowFuncKind.RANK:
            out.append((start + 1, ones.copy()))
        elif k == WindowFuncKind.DENSE_RANK:
            out.append((np.cumsum(~eq_prev).astype(np.int64), ones.copy()))
        elif k == WindowFuncKind.COUNT and inp is None:
            # COUNT(*): every frame row counts
            out.append((end.astype(np.int64), ones.copy()))
        elif k in (WindowFuncKind.LAG, WindowFuncKind.LEAD):
            vals, ok = inp
            lag = call.offset if k == WindowFuncKind.LAG else -call.offset
            out.append(_shift(vals, ok, lag))
        elif k == WindowFuncKind.COUNT:
            out.append((np.cumsum(inp[1].astype(np.int64))[at], ones.copy()))
        elif k == WindowFuncKind.SUM:
            vals, ok = inp
            nonnull = np.cumsum(ok.astype(np.int64))[at] > 0
            out.append((np.cumsum(np.where(ok, vals, 0))[at], nonnull))
        elif k in (WindowFuncKind.MIN, WindowFuncKind.MAX):
            vals, ok = inp
            for_max = k == WindowFuncKind.MAX
            filled = np.where(ok, vals, _fill(vals, for_max))
            acc = (np.maximum if for_max else np.minimum).accumulate(filled)
            nonnull = np.cumsum(ok.astype(np.int64))[at] > 0
            out.append((acc[at], nonnull))
        elif k == WindowFuncKind.FIRST_VALUE:
            vals, ok = inp
            out.append((np.broadcast_to(vals[0], (n,)).copy(),
                        np.broadcast_to(ok[0], (n,)).copy()))
        elif k == WindowFuncKind.LAST_VALUE:
            vals, ok = inp
            out.append((vals[at], ok[at]))
        else:                                    # pragma: no cover
            raise NotImplementedError(k)
    return out
