"""32-bit lane codecs: how 64-bit logical values live in device state.

Port of ``risingwave_tpu/ops/lanes.py``. Device state is int32/float32
only, and 64-bit logical values are (de)composed on the host with
vectorized numpy. The port keeps the reference's codecs bit for bit, so
device state carries across the two packages unchanged:

- **key lanes** (``split_i64``): bijective (hi, lo) int32 pair.
- **sum limbs** (``sum_limbs``): signed base-2^17 decomposition into four
  int32 limbs. Adding the limbs of at most ``MAX_CHUNK_ROWS`` rows stays
  inside int32 (17 + 13 < 31); a carry pass after every such slice keeps
  limbs normalized. Exact for |Σ| < 2^63.
- **order lanes** (``order_lanes``): order-preserving (hi, lo) int32 pair —
  lexicographic (hi, lo) order equals value order — so MIN/MAX run as
  int32 max/min passes. Floats use the IEEE total-order bit trick.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

LIMB_BITS = 17
N_LIMBS = 4
# slice row-count bound that keeps limb adds inside int32
MAX_CHUNK_ROWS = 1 << (31 - LIMB_BITS - 1)       # 8192

_BIAS32 = np.int64(1) << np.int64(31)
_MASK32 = np.int64(0xFFFFFFFF)


# -- bijective key lanes ----------------------------------------------------

def split_i64(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int64[N] → (hi, lo) int32[N], bijective."""
    v = v.astype(np.int64, copy=False)
    hi = (v >> np.int64(32)).astype(np.int32)
    lo = (v & _MASK32).astype(np.uint32).view(np.int32)
    return hi, lo


def merge_i64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.int64) << np.int64(32)) | \
        lo.view(np.uint32).astype(np.int64)


# -- exact integer sums: signed base-2^17 limbs -----------------------------

def sum_limbs(v: np.ndarray) -> Tuple[np.ndarray, ...]:
    """int64[N] → N_LIMBS int32 limb arrays; v = Σ limb_i << (17*i).

    Limbs 0..2 ∈ [0, 2^17); limb 3 carries the sign."""
    v = v.astype(np.int64, copy=False)
    out = []
    for i in range(N_LIMBS - 1):
        out.append(((v >> np.int64(LIMB_BITS * i))
                    & np.int64((1 << LIMB_BITS) - 1)).astype(np.int32))
    out.append((v >> np.int64(LIMB_BITS * (N_LIMBS - 1))).astype(np.int32))
    return tuple(out)


def merge_limbs(*limbs: np.ndarray) -> np.ndarray:
    """Inverse of sum_limbs for arbitrary (possibly unnormalized) limbs."""
    acc = np.zeros(limbs[0].shape, dtype=np.int64)
    for i, l in enumerate(limbs):
        acc += l.astype(np.int64) << np.int64(LIMB_BITS * i)
    return acc


# -- order-preserving lanes for MIN/MAX -------------------------------------

def _order_u64_from_i64(v: np.ndarray) -> np.ndarray:
    """int64 → uint64 where unsigned order == signed order."""
    return (v.astype(np.int64) ^ (np.int64(1) << np.int64(63))) \
        .view(np.uint64)


def _order_u64_from_f64(v: np.ndarray) -> np.ndarray:
    """float64 → uint64 total order (IEEE bit trick; -0.0 == 0.0)."""
    v = np.where(v == 0, np.zeros((), dtype=v.dtype), v)
    bits = v.astype(np.float64).view(np.uint64)
    neg = (bits >> np.uint64(63)) == 1
    return np.where(neg, ~bits, bits | (np.uint64(1) << np.uint64(63)))


def _lanes_from_u64(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint64 order key → (hi, lo) int32 with lexicographic int32 order."""
    hi = ((m >> np.uint64(32)).astype(np.int64) - _BIAS32).astype(np.int32)
    lo = ((m & np.uint64(0xFFFFFFFF)).astype(np.int64)
          - _BIAS32).astype(np.int32)
    return hi, lo


def _u64_from_lanes(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    h = (hi.astype(np.int64) + _BIAS32).astype(np.uint64)
    l = (lo.astype(np.int64) + _BIAS32).astype(np.uint64)
    return (h << np.uint64(32)) | l


def order_lanes(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """value array (any device dtype) → order-preserving (hi, lo) int32."""
    if np.issubdtype(v.dtype, np.floating):
        return _lanes_from_u64(_order_u64_from_f64(v))
    if v.dtype == np.bool_:
        v = v.astype(np.int64)
    return _lanes_from_u64(_order_u64_from_i64(v))


def inv_order_lanes(hi: np.ndarray, lo: np.ndarray,
                    dtype: np.dtype) -> np.ndarray:
    m = _u64_from_lanes(hi, lo)
    if np.issubdtype(dtype, np.floating):
        neg = (m >> np.uint64(63)) == 0
        bits = np.where(neg, ~m, m & ~(np.uint64(1) << np.uint64(63)))
        return bits.view(np.float64).astype(dtype)
    v = (m.view(np.int64) ^ (np.int64(1) << np.int64(63)))
    if dtype == np.bool_:
        return v != 0
    return v.astype(dtype)
