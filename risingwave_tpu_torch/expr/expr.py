"""Vectorized expressions over host chunks: the subset q7 needs.

Port of part of ``risingwave_tpu/expr/expr.py`` (reference parity:
src/expr/src/expr/mod.rs:74): ``InputRef``, literals and ``tumble_start``
(:610), evaluated on numpy. ``eval`` returns a ``Column`` covering the
chunk's full capacity; padding rows compute values that are never read.
The reference's other operators and functions are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, DataChunk
from risingwave_tpu_torch.common.types import (
    DataType, Interval, decimal_to_scaled,
)


class Expression:
    """Base: vectorized ``eval(chunk) -> Column``."""

    return_type: DataType

    def eval(self, chunk: DataChunk) -> Column:
        raise NotImplementedError


class InputRef(Expression):
    """Column reference by index (expr_input_ref.rs analog)."""

    def __init__(self, index: int, data_type: DataType):
        self.index = index
        self.return_type = data_type

    def eval(self, chunk: DataChunk) -> Column:
        c = chunk.columns[self.index]
        assert c.data_type == self.return_type, (c.data_type,
                                                 self.return_type)
        return c

    def __repr__(self):
        return f"${self.index}:{self.return_type.name.lower()}"


class Literal(Expression):
    """Constant (expr_literal.rs analog); broadcast at eval."""

    def __init__(self, value, data_type: DataType):
        self.value = value
        self.return_type = data_type

    def _physical(self):
        if self.return_type == DataType.DECIMAL and self.value is not None:
            return decimal_to_scaled(self.value)
        return self.value

    def eval(self, chunk: DataChunk) -> Column:
        cap = chunk.capacity
        dt = self.return_type
        if self.value is None:
            vals = (np.zeros(cap, dtype=dt.np_dtype) if dt.is_device
                    else np.full(cap, None, dtype=object))
            return Column(dt, vals, np.zeros(cap, dtype=bool))
        if dt.is_device:
            return Column(dt, np.full(cap, self._physical(),
                                      dtype=dt.np_dtype))
        return Column(dt, np.full(cap, self.value, dtype=object))

    def __repr__(self):
        return f"{self.value!r}:{self.return_type.name.lower()}"


_FUNCTIONS: Dict[str, Callable[..., Column]] = {}


def register_function(name: str):
    def deco(fn):
        _FUNCTIONS[name] = fn
        return fn
    return deco


class FuncCall(Expression):
    """Named scalar function over evaluated child columns."""

    def __init__(self, name: str, args: Sequence[Expression],
                 return_type: DataType):
        if name not in _FUNCTIONS:
            raise NotImplementedError(f"function {name} is not ported")
        self.name = name
        self.args = list(args)
        self.return_type = return_type

    def eval(self, chunk: DataChunk) -> Column:
        cols = [a.eval(chunk) for a in self.args]
        return _FUNCTIONS[self.name](self.return_type, *cols)

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


def _window_usecs(window: Column):
    """Interval-literal column → scalar µs, or None for a NULL literal."""
    if window.data_type != DataType.INTERVAL:
        return window.values
    iv = next((v for v in window.values if v is not None), None)
    return None if iv is None else np.int64(iv.exact_usecs())


@register_function("tumble_start")
def _tumble_start(rt: DataType, ts: Column, window: Column) -> Column:
    """Window start for TUMBLE(ts, interval): ts - ts % window_usecs. The
    window must be a month-free interval literal; NULL yields NULL."""
    w = _window_usecs(window)
    if w is None:
        return Column(rt, np.zeros_like(ts.values),
                      np.zeros(ts.values.shape[0], dtype=bool))
    return Column(rt, ts.values - (ts.values % w), ts.validity)


def tumble_start(ts: Expression, window: Interval) -> FuncCall:
    return FuncCall("tumble_start", [ts, Literal(window, DataType.INTERVAL)],
                    ts.return_type)
