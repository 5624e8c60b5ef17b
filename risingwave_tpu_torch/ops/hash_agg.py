"""Device-resident grouped aggregation state (the q7 kernels).

Port of ``risingwave_tpu/ops/hash_agg.py`` (reference parity:
src/stream/src/executor/hash_agg.rs:67, :329 apply_chunk, :445
flush_data). Per batch the executor's rows are packed on the host into one
int32 matrix, uploaded once, found-or-inserted in the hash table (K1) and
folded into the accumulators (K2); per barrier the dirty groups are
gathered in one packed matrix (K3 ``flush_gather``), read once, and the
emitted snapshot advances (K3 ``advance``); growth and watermark
retirement rebuild the table from its live slots (K4).

Device state is int32/float32, in the reference's layout (see
``ops/lanes.py``), with one difference of form: every slot-indexed array
is a row of ONE int32 matrix ``st[R, cap]`` (float rows hold f32 bits), so
a kernel takes one pointer and a rebuild moves every array in one launch:

    row 0  group_rows      net row count (Σ signs), int32
    row 1  dirty           touched since the last flush (0/1)
    row 2  emitted_valid   live at the last flush (0/1)
    row 3  emitted_rows
    rows 4 .. 4+n_acc-1            accumulators (dev_layout order)
    rows 4+n_acc .. 4+2*n_acc-1    emitted accumulators

Accumulators per call: COUNT → [cnt]; SUM(int) → 4 limbs + nn (exact);
SUM(float) → [hi f32, lo f32] + nn; MIN/MAX → order lanes [hi, lo] + nn;
approx_count_distinct, string_agg and array_agg → one dummy lane (their
values live on the host: dense HLL sketches and the materialized-input
multisets of the executor). MIN/MAX are append-only on the device: with
retractions the executor recomputes them on the host from the
materialized input and writes them back with ``patch_state`` (K9, B10).

The agg's cold tier (``state/tier.py``) evicts clean groups with
``evict_state`` (K8 lookup, K4 in its evict mode, then the K1 + K4
rebuild: B9) and reloads them with ``GroupedAggKernel.load_groups`` (K1,
then K9).

Each kernel wrapper launches its CUDA kernel for CUDA tensors (and counts
the launch in ``LAUNCHES``) and runs its plain PyTorch version for CPU
tensors. The plain versions follow the reference's JAX programs step for
step, so on the CPU the port's state is bit-for-bit the reference's
(float SUM within a tolerance: summation order). Where the reference
donates the state (``donate_argnums=(0,)``), the port updates ``st`` and
the table in place; a rebuild returns new tensors.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch.common.chunk import next_pow2
from risingwave_tpu_torch.ops import cuda
from risingwave_tpu_torch.ops import hash_table as ht
from risingwave_tpu_torch.ops import lanes
from risingwave_tpu_torch.utils.device import (
    LAUNCHES, PendingCounters, fetch, resolve_device, upload,
)

I32_MIN = -(1 << 31)
I32_MAX = (1 << 31) - 1

ROW_GROUP_ROWS = 0
ROW_DIRTY = 1
ROW_EMITTED_VALID = 2
ROW_EMITTED_ROWS = 3
ROW_ACC0 = 4


class AggKind(enum.Enum):
    COUNT = "count"        # count(col) or count(*) when input is None
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    # HyperLogLog cardinality sketch (append-only; see HLL_* below)
    APPROX_COUNT_DISTINCT = "approx_count_distinct"
    # host-only aggs (string/list outputs never live on the card): the
    # device keeps one dummy lane; the executor computes their outputs
    # from the materialized-input value multiset at flush
    STRING_AGG = "string_agg"
    ARRAY_AGG = "array_agg"


HOST_AGG_KINDS = (AggKind.STRING_AGG, AggKind.ARRAY_AGG)

# kernel-side call kinds (csrc/agg_apply.cu enum Kind); _K_NONE is the
# dummy lane of the host kinds and approx_count_distinct: K2 writes nothing
_K_COUNT, _K_SUM_INT, _K_SUM_FLOAT, _K_MAX, _K_MIN, _K_NONE = range(6)


# -- HyperLogLog (approx_count_distinct) ----------------------------------
# A dense 2^16-register sketch per group (the reference's bucket count,
# src/expr/src/aggregate/approx_count_distinct/mod.rs:35-42; standard
# error 1.04 / sqrt(2^16) ~ 0.4%), kept by the executor on the host (one
# uint8 register array per group, a vectorized scatter-max per chunk) and
# persisted as one BYTEA row per group. The estimate is float64 numpy on
# the host; the card carries only the call's dummy lane.
HLL_B = 16              # index bits
HLL_M = 1 << HLL_B      # registers (65536)
HLL_RHO_MAX = 65 - HLL_B
HLL_ALPHA = 0.7213 / (1 + 1.079 / HLL_M)   # bias constant, m >= 128


def _clz64(x: np.ndarray) -> np.ndarray:
    """Vectorized count-leading-zeros over uint64 (0 → 64)."""
    x = x.astype(np.uint64)
    n = np.full(x.shape, 64, dtype=np.int64)
    cur = x
    for s in (32, 16, 8, 4, 2, 1):
        big = cur >= (np.uint64(1) << np.uint64(s))
        n = np.where(big, n - s, n)
        cur = np.where(big, cur >> np.uint64(s), cur)
    return n - 1 * (x > 0)          # exact clz: 64 - bit length, 64 for 0


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: a uniform 64-bit hash of the i64 image."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def hll_lanes(v64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """i64 value image → (register index, rho) int32."""
    h = _mix64(v64)
    reg = (h >> np.uint64(64 - HLL_B)).astype(np.int32)
    w = (h << np.uint64(HLL_B)).astype(np.uint64)
    rho = np.where(w == 0, HLL_RHO_MAX, _clz64(w) + 1).astype(np.int32)
    return reg, np.minimum(rho, HLL_RHO_MAX).astype(np.int32)


def hll_estimate_dense(mat: np.ndarray) -> np.ndarray:
    """Estimates for stacked register files: (G, HLL_M) uint8 → int64 per
    group, with the linear-counting small-range correction."""
    mat = np.atleast_2d(mat)
    m = float(HLL_M)
    inv = np.power(2.0, -mat.astype(np.float64)).sum(axis=1)
    zeros = (mat == 0).sum(axis=1)
    e = HLL_ALPHA * m * m / inv
    small = (e <= 2.5 * m) & (zeros > 0)
    with np.errstate(divide="ignore"):
        lin = m * np.log(np.where(zeros > 0, m / np.maximum(zeros, 1),
                                  1.0))
    return np.where(small, lin, e).round().astype(np.int64)


def _is_placeholder(kind: AggKind) -> bool:
    """Calls whose device state is one dummy lane (no value, no nn)."""
    return kind in HOST_AGG_KINDS or kind == AggKind.APPROX_COUNT_DISTINCT


@dataclass(frozen=True)
class AggSpec:
    """One aggregate call, physical view (numpy dtypes)."""

    kind: AggKind
    in_dtype: Optional[np.dtype] = None   # None ⇒ count(*)

    @property
    def out_dtype(self) -> np.dtype:
        if self.kind in HOST_AGG_KINDS:
            return np.dtype(object)
        if self.kind in (AggKind.COUNT, AggKind.APPROX_COUNT_DISTINCT):
            return np.dtype(np.int64)
        assert self.in_dtype is not None
        if self.kind == AggKind.SUM:
            if np.issubdtype(self.in_dtype, np.floating):
                return np.dtype(np.float64)
            return np.dtype(np.int64)     # ints + scaled DECIMAL
        return np.dtype(self.in_dtype)    # MIN/MAX

    @property
    def is_float_sum(self) -> bool:
        return (self.kind == AggKind.SUM and self.in_dtype is not None
                and np.issubdtype(self.in_dtype, np.floating))

    def dev_layout(self) -> List[Tuple[np.dtype, object]]:
        """Device accumulator arrays of this call: [(dtype, fill)]."""
        i32 = np.dtype(np.int32)
        f32 = np.dtype(np.float32)
        if self.kind == AggKind.COUNT or _is_placeholder(self.kind):
            return [(i32, 0)]             # the count, or the dummy lane
        if self.kind == AggKind.SUM:
            if self.is_float_sum:
                return [(f32, 0.0), (f32, 0.0), (i32, 0)]
            return [(i32, 0)] * lanes.N_LIMBS + [(i32, 0)]
        fill = I32_MIN if self.kind == AggKind.MAX else I32_MAX
        return [(i32, fill), (i32, fill), (i32, 0)]

    # -- host codecs -----------------------------------------------------
    def encode_input(self, vals: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Host value column → device input lanes (vectorized)."""
        if self.kind == AggKind.COUNT or _is_placeholder(self.kind):
            return ()               # the host keeps the value (or sketch)
        if self.kind == AggKind.SUM:
            if self.is_float_sum:
                hi = vals.astype(np.float32)
                lo = (vals.astype(np.float64)
                      - hi.astype(np.float64)).astype(np.float32)
                return (hi, lo)
            return lanes.sum_limbs(vals)
        return lanes.order_lanes(vals)

    def decode_acc(self, cols: Sequence[np.ndarray]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Gathered device acc columns → (value host array, is_null)."""
        if self.kind == AggKind.COUNT:
            cnt = cols[0].astype(np.int64)
            assert (cnt >= 0).all(), \
                "COUNT wrapped int32 — a group exceeded 2^31 rows"
            return cnt, np.zeros(cnt.shape, dtype=bool)
        if self.kind in HOST_AGG_KINDS:
            # placeholder: the executor overwrites these from the minput
            # multiset at flush
            n = len(cols[0])
            return np.full(n, None, dtype=object), np.ones(n, dtype=bool)
        if self.kind == AggKind.APPROX_COUNT_DISTINCT:
            # placeholder: the executor overwrites these from its sketches
            n = len(cols[0])
            return np.zeros(n, dtype=np.int64), np.ones(n, dtype=bool)
        nn = cols[-1]
        assert (nn >= 0).all(), \
            "non-null count wrapped int32 — a group exceeded 2^31 rows"
        null = nn == 0
        if self.kind == AggKind.SUM:
            if self.is_float_sum:
                v = cols[0].astype(np.float64) + cols[1].astype(np.float64)
            else:
                v = lanes.merge_limbs(*cols[:-1])
            return v, null
        v = lanes.inv_order_lanes(cols[0], cols[1], self.out_dtype)
        return v, null

    # -- host (state-row) accumulator layout ------------------------------
    def host_acc_dtypes(self) -> List[np.dtype]:
        """Columns this call persists in the value-state row (one
        placeholder for the dummy-lane kinds: their state lives in the
        minput or sketch tables, and the row keeps its arity)."""
        if self.kind == AggKind.COUNT or _is_placeholder(self.kind):
            return [np.dtype(np.int64)]
        return [self.out_dtype, np.dtype(np.int64)]

    def host_acc_cols(self, vals: np.ndarray, nulls: np.ndarray,
                      nn: Optional[np.ndarray]) -> List[list]:
        """Decoded flush columns → per-column python lists for state
        rows, NULLs as None."""
        if self.kind == AggKind.COUNT:
            return [vals.tolist()]
        if _is_placeholder(self.kind):
            return [[0] * len(vals)]
        value_col = [None if bad else v
                     for v, bad in zip(vals.tolist(), nulls.tolist())]
        return [value_col, nn.tolist()]

    def encode_acc(self, value: np.ndarray, nn: Optional[np.ndarray]
                   ) -> Tuple[np.ndarray, ...]:
        """(decoded value, nn) → device acc columns (recovery and the
        patch). NULL slots (nn == 0) re-encode as the identity fill."""
        if self.kind == AggKind.COUNT:
            return (value.astype(np.int32),)
        assert nn is not None
        nn32 = nn.astype(np.int32)
        if self.kind == AggKind.SUM:
            if self.is_float_sum:
                hi = value.astype(np.float32)
                lo = (value.astype(np.float64)
                      - hi.astype(np.float64)).astype(np.float32)
                return (hi, lo, nn32)
            return lanes.sum_limbs(value.astype(np.int64)) + (nn32,)
        hi, lo = lanes.order_lanes(np.asarray(value, dtype=self.out_dtype))
        fill = I32_MIN if self.kind == AggKind.MAX else I32_MAX
        dead = nn32 == 0
        hi = np.where(dead, np.int32(fill), hi).astype(np.int32)
        lo = np.where(dead, np.int32(fill), lo).astype(np.int32)
        return (hi, lo, nn32)

    def host_to_dev(self, host_cols: Sequence[np.ndarray]
                    ) -> Tuple[np.ndarray, ...]:
        """Recovered host acc columns → device-layout columns."""
        if self.kind == AggKind.COUNT or _is_placeholder(self.kind):
            return (host_cols[0].astype(np.int32),)
        return self.encode_acc(host_cols[0], host_cols[1])


def encode_host_accs(specs: Sequence[AggSpec],
                     acc_cols: Sequence[np.ndarray]) -> List[np.ndarray]:
    """HOST state-row acc columns → device-layout columns (recovery)."""
    out: List[np.ndarray] = []
    j = 0
    for s in specs:
        k = len(s.host_acc_dtypes())
        out.extend(s.host_to_dev(acc_cols[j:j + k]))
        j += k
    return out


def acc_dtypes(specs: Sequence[AggSpec]) -> List[np.dtype]:
    """HOST (state-row) accumulator columns, per call."""
    out: List[np.dtype] = []
    for s in specs:
        out.extend(s.host_acc_dtypes())
    return out


def dev_layout(specs: Sequence[AggSpec]) -> List[Tuple[np.dtype, object]]:
    out: List[Tuple[np.dtype, object]] = []
    for s in specs:
        out.extend(s.dev_layout())
    return out


def n_input_lanes(spec: AggSpec) -> int:
    """Device input lanes per row for this call (encode_input arity)."""
    if spec.kind == AggKind.COUNT or spec.kind in HOST_AGG_KINDS:
        return 0
    if spec.kind == AggKind.SUM:
        return 2 if spec.is_float_sum else lanes.N_LIMBS
    # MIN/MAX order lanes; approx_count_distinct keeps the reference's two
    # (register, rho) columns, which the host fills and K2 never reads
    return 2


def _call_slices(specs: Sequence[AggSpec]) -> List[slice]:
    """Flat device-acc index range per call."""
    out, j = [], 0
    for s in specs:
        n = len(s.dev_layout())
        out.append(slice(j, j + n))
        j += n
    return out


def decode_outputs(specs: Sequence[AggSpec],
                   dev_cols: Sequence[np.ndarray]
                   ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Gathered device acc columns → per-call (value, is_null) host cols."""
    outs, nulls = [], []
    for s, sl in zip(specs, _call_slices(specs)):
        v, nu = s.decode_acc(dev_cols[sl])
        outs.append(v)
        nulls.append(nu)
    return outs, nulls


def _has_valid_col(spec: AggSpec) -> bool:
    """count(*) is the only call with no input → no non-null mask."""
    return spec.in_dtype is not None or spec.kind != AggKind.COUNT


def packed_layout(key_width: int, specs: Sequence[AggSpec]
                  ) -> List[Tuple[List[int], Optional[int]]]:
    """Per-call (value-lane columns, valid column | None) of the packed
    per-batch input matrix: key lanes | sign | vis | per call with input:
    lanes + valid. Everything is int32 (f32 lanes travel bitcast), so a
    batch is ONE host→device transfer."""
    out: List[Tuple[List[int], Optional[int]]] = []
    c = key_width + 2
    for s in specs:
        if _has_valid_col(s):
            nl = n_input_lanes(s)
            out.append((list(range(c, c + nl)), c + nl))
            c += nl + 1
        else:
            out.append(([], None))
    return out


def packed_width(key_width: int, specs: Sequence[AggSpec]) -> int:
    last = key_width + 1
    for cols, vc in packed_layout(key_width, specs):
        for i in cols:
            last = max(last, i)
        if vc is not None:
            last = max(last, vc)
    return last + 1


def pack_chunk(key_width: int, specs: Sequence[AggSpec],
               key_lanes: np.ndarray, signs: np.ndarray, vis: np.ndarray,
               inputs: Sequence) -> np.ndarray:
    """Host-side chunk → one int32[N, W] matrix. `inputs` is per call
    (value lane arrays, valid mask); count(*) contributes no columns."""
    n = len(signs)
    m = np.empty((n, packed_width(key_width, specs)), dtype=np.int32)
    m[:, :key_width] = key_lanes
    m[:, key_width] = signs
    m[:, key_width + 1] = vis
    for (cols, vc), (in_lanes, valid) in zip(
            packed_layout(key_width, specs), inputs):
        for c, a in zip(cols, in_lanes):
            a = np.asarray(a)
            m[:, c] = a.view(np.int32) if a.dtype == np.float32 else a
        if vc is not None:
            m[:, vc] = np.asarray(valid)
    return m


# -- device state ---------------------------------------------------------------

class AggState(NamedTuple):
    """Device state of one grouped-agg operator (updated in place)."""

    table: ht.TableState
    st: torch.Tensor                   # int32[4 + 2 * n_acc, cap]

    @property
    def capacity(self) -> int:
        return int(self.st.shape[1])

    @property
    def n_acc(self) -> int:
        return (int(self.st.shape[0]) - ROW_ACC0) // 2


def state_fills(specs: Sequence[AggSpec]) -> List[int]:
    """Fill of every row of ``st`` (float fills as their int32 bits)."""
    accs = []
    for dt, f in dev_layout(specs):
        if dt == np.dtype(np.float32):
            f = int(np.float32(f).view(np.int32))
        accs.append(int(f))
    return [0, 0, 0, 0] + accs + accs


def make_agg_state(capacity: int, key_width: int, specs: Sequence[AggSpec],
                   device: torch.device) -> AggState:
    fills = state_fills(specs)
    st = torch.empty((len(fills), capacity), dtype=torch.int32,
                     device=device)
    for r, f in enumerate(fills):
        st[r].fill_(f)
    return AggState(ht.make_state(capacity, key_width, device), st)


class ShardedAggState(NamedTuple):
    """Device state of S shards of one grouped-agg operator: the
    ``AggState`` tensors with a leading shard axis (the reference's
    stacked ``AggState`` of ``parallel/agg.py``), updated in place."""

    table: ht.TableState               # keys int32[S, cap, K], occ [S, cap]
    st: torch.Tensor                   # int32[S, 4 + 2 * n_acc, cap]

    @property
    def n_shards(self) -> int:
        return int(self.st.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.st.shape[2])

    @property
    def n_acc(self) -> int:
        return (int(self.st.shape[1]) - ROW_ACC0) // 2

    def shard(self, s: int) -> AggState:
        """Shard s as an ``AggState`` of views (writes reach this state)."""
        return AggState(ht.TableState(self.table.keys[s], self.table.occ[s]),
                        self.st[s])


def make_sharded_agg_state(n_shards: int, capacity: int, key_width: int,
                           specs: Sequence[AggSpec],
                           device: torch.device) -> ShardedAggState:
    fills = state_fills(specs)
    st = torch.empty((n_shards, len(fills), capacity), dtype=torch.int32,
                     device=device)
    for r, f in enumerate(fills):
        st[:, r].fill_(f)
    table = ht.TableState(
        keys=torch.zeros((n_shards, capacity, key_width), dtype=torch.int32,
                         device=device),
        occ=torch.zeros((n_shards, capacity), dtype=torch.int32,
                        device=device))
    return ShardedAggState(table, st)


class HostTable(NamedTuple):
    keys: np.ndarray     # int32[cap, K]
    occ: np.ndarray      # bool[cap]


class HostAggState(NamedTuple):
    """Agg state as numpy arrays in the reference's ``AggState`` layout
    (bool masks, float accumulators as float32)."""

    table: HostTable
    group_rows: np.ndarray
    dirty: np.ndarray
    accs: Tuple[np.ndarray, ...]
    emitted_valid: np.ndarray
    emitted_rows: np.ndarray
    emitted_accs: Tuple[np.ndarray, ...]


def from_jax_state(ref, device) -> AggState:
    """A reference-layout state (any object with the reference
    ``AggState`` fields, arrays convertible by ``np.asarray``) → the
    port's ``AggState`` on `device`."""
    device = torch.device(device)

    def i32(a) -> np.ndarray:
        a = np.asarray(a)
        if a.dtype == np.float32:
            return a.view(np.int32)
        return a.astype(np.int32)

    rows = [i32(ref.group_rows), i32(ref.dirty), i32(ref.emitted_valid),
            i32(ref.emitted_rows)]
    rows += [i32(a) for a in ref.accs]
    rows += [i32(a) for a in ref.emitted_accs]
    st = torch.from_numpy(np.ascontiguousarray(np.stack(rows))).to(device)
    table = ht.TableState(
        keys=torch.from_numpy(np.array(ref.table.keys,
                                       dtype=np.int32)).to(device),
        occ=torch.from_numpy(i32(ref.table.occ)).to(device))
    return AggState(table, st)


def to_numpy_state(state: AggState,
                   specs: Sequence[AggSpec]) -> HostAggState:
    """The port's ``AggState`` → numpy arrays in the reference layout."""
    st = state.st.cpu().numpy()
    lay = dev_layout(specs)
    n = len(lay)

    def acc(r: int, dt: np.dtype) -> np.ndarray:
        row = np.ascontiguousarray(st[r])
        return row.view(np.float32) if dt == np.dtype(np.float32) else row

    return HostAggState(
        table=HostTable(state.table.keys.cpu().numpy(),
                        state.table.occ.cpu().numpy() != 0),
        group_rows=st[ROW_GROUP_ROWS].copy(),
        dirty=st[ROW_DIRTY] != 0,
        accs=tuple(acc(ROW_ACC0 + i, dt) for i, (dt, _f) in enumerate(lay)),
        emitted_valid=st[ROW_EMITTED_VALID] != 0,
        emitted_rows=st[ROW_EMITTED_ROWS].copy(),
        emitted_accs=tuple(acc(ROW_ACC0 + n + i, dt)
                           for i, (dt, _f) in enumerate(lay)),
    )


def _host_shard(ref, s: int) -> HostAggState:
    """Shard s of a stacked reference-layout state, as numpy arrays."""
    def a(x):
        return np.asarray(x)[s]
    return HostAggState(
        table=HostTable(a(ref.table.keys), a(ref.table.occ)),
        group_rows=a(ref.group_rows), dirty=a(ref.dirty),
        accs=tuple(a(x) for x in ref.accs),
        emitted_valid=a(ref.emitted_valid), emitted_rows=a(ref.emitted_rows),
        emitted_accs=tuple(a(x) for x in ref.emitted_accs))


def from_jax_sharded_state(ref, device) -> ShardedAggState:
    """A stacked reference-layout state (the reference ``AggState`` with a
    leading [n_dev] axis on every array, as ``ShardedAggKernel.state``
    holds it) → the port's ``ShardedAggState`` on `device`."""
    n = np.asarray(ref.group_rows).shape[0]
    shards = [from_jax_state(_host_shard(ref, s), device) for s in range(n)]
    return ShardedAggState(
        ht.TableState(torch.stack([a.table.keys for a in shards]),
                      torch.stack([a.table.occ for a in shards])),
        torch.stack([a.st for a in shards]))


def to_numpy_sharded_state(state: ShardedAggState,
                           specs: Sequence[AggSpec]) -> HostAggState:
    """The port's ``ShardedAggState`` → numpy arrays in the reference
    layout, each with a leading shard axis."""
    per = [to_numpy_state(state.shard(s), specs)
           for s in range(state.n_shards)]

    def stack(get):
        return np.stack([get(h) for h in per])
    n_acc = len(per[0].accs)
    return HostAggState(
        table=HostTable(stack(lambda h: h.table.keys),
                        stack(lambda h: h.table.occ)),
        group_rows=stack(lambda h: h.group_rows),
        dirty=stack(lambda h: h.dirty),
        accs=tuple(stack(lambda h, i=i: h.accs[i]) for i in range(n_acc)),
        emitted_valid=stack(lambda h: h.emitted_valid),
        emitted_rows=stack(lambda h: h.emitted_rows),
        emitted_accs=tuple(stack(lambda h, i=i: h.emitted_accs[i])
                           for i in range(n_acc)))


class ApplyPlan:
    """What K2 needs to know of an agg plan: a call descriptor int32[C, 4]
    (kernel kind, first acc row relative to ROW_ACC0, first input column
    or -1, valid column or -1) in the packed layout of ``pack_chunk``."""

    def __init__(self, key_width: int, specs: Sequence[AggSpec],
                 device: torch.device):
        self.key_width = key_width
        self.specs = tuple(specs)
        rows = []
        for spec, sl, (cols, vc) in zip(
                self.specs, _call_slices(self.specs),
                packed_layout(key_width, self.specs)):
            if spec.kind == AggKind.COUNT:
                kind = _K_COUNT
            elif _is_placeholder(spec.kind):
                kind = _K_NONE
            elif spec.kind == AggKind.SUM:
                kind = _K_SUM_FLOAT if spec.is_float_sum else _K_SUM_INT
            else:
                kind = _K_MAX if spec.kind == AggKind.MAX else _K_MIN
            rows.append([kind, sl.start, cols[0] if cols else -1,
                         -1 if vc is None else vc])
        self.desc = np.asarray(rows, dtype=np.int32).reshape(-1, 4)
        self.desc_dev = torch.from_numpy(self.desc).to(device)
        kinds = set(self.desc[:, 0].tolist())
        self.has_sum_int = _K_SUM_INT in kinds
        self.has_extreme = bool(kinds & {_K_MAX, _K_MIN})


# -- K2: apply -----------------------------------------------------------------

def _carry_plain(st: torch.Tensor, row: int) -> None:
    for k in range(lanes.N_LIMBS - 1):
        carry = st[row + k] >> lanes.LIMB_BITS
        st[row + k] -= carry << lanes.LIMB_BITS
        st[row + k + 1] += carry


def agg_apply_plain(state: AggState, packed: torch.Tensor,
                    slots: torch.Tensor, plan: ApplyPlan) -> None:
    """Plain PyTorch version of K2: ``build_apply``'s ``core`` after the
    probe (``hash_agg.py:540``) and ``_update_call`` (:392)."""
    st = state.st
    kw = plan.key_width
    n = packed.shape[0]
    s32 = packed[:, kw]
    vis = packed[:, kw + 1] != 0
    slot64 = slots.to(torch.int64)
    idx = slot64[vis]
    st[ROW_GROUP_ROWS].index_add_(0, idx, s32[vis])
    st[ROW_DIRTY][idx] = 1
    for kind, a, ic, vc in plan.desc.tolist():
        if kind == _K_NONE:
            continue
        row = ROW_ACC0 + a
        live = vis if vc < 0 else vis & (packed[:, vc] != 0)
        li = slot64[live]
        if kind == _K_COUNT:
            st[row].index_add_(0, li, s32[live])
            continue
        nn_row = row + (lanes.N_LIMBS if kind == _K_SUM_INT else 2)
        st[nn_row].index_add_(0, li, s32[live])
        if kind == _K_SUM_INT:
            for lo in range(0, n, lanes.MAX_CHUNK_ROWS):
                hi = min(lo + lanes.MAX_CHUNK_ROWS, n)
                lv = live[lo:hi]
                si = slot64[lo:hi][lv]
                sg = s32[lo:hi][lv]
                for k in range(lanes.N_LIMBS):
                    st[row + k].index_add_(
                        0, si, packed[lo:hi, ic + k][lv] * sg)
                _carry_plain(st, row)
        elif kind == _K_SUM_FLOAT:
            sf = s32[live].to(torch.float32)
            for k in range(2):
                v = packed[:, ic + k].contiguous().view(torch.float32)
                st[row + k].view(torch.float32).index_add_(
                    0, li, v[live] * sf)
        else:
            is_max = kind == _K_MAX
            red = "amax" if is_max else "amin"
            ident = I32_MIN if is_max else I32_MAX
            ins = live & (s32 > 0)
            ii = slot64[ins]
            v_hi = packed[:, ic][ins]
            v_lo = packed[:, ic + 1][ins]
            old_hi = st[row].clone()
            st[row].scatter_reduce_(0, ii, v_hi, reduce=red,
                                    include_self=True)
            st[row + 1].copy_(torch.where(old_hi == st[row], st[row + 1],
                                          ident))
            contrib = torch.where(v_hi == st[row][ii], v_lo, ident)
            st[row + 1].scatter_reduce_(0, ii, contrib, reduce=red,
                                        include_self=True)


def agg_apply(state: AggState, packed: torch.Tensor, slots: torch.Tensor,
              plan: ApplyPlan) -> None:
    """Kernel K2: fold a packed batch into the state at its slots.

    Launch plan: phase 0 over each MAX_CHUNK_ROWS slice with a carry
    launch after it when the plan has an integer SUM (one phase-0 launch
    over all rows otherwise), then one phase-1 launch when it has a
    MIN/MAX."""
    if packed.device.type != "cuda":
        agg_apply_plain(state, packed, slots, plan)
        return
    _agg_apply_cuda(state.st[None], packed[None], slots[None], plan)


def agg_apply_sharded_plain(state: ShardedAggState, packed: torch.Tensor,
                            slots: torch.Tensor, plan: ApplyPlan) -> None:
    """Plain PyTorch version of the sharded K2: shard by shard."""
    for s in range(state.n_shards):
        agg_apply_plain(state.shard(s), packed[s], slots[s], plan)


def agg_apply_sharded(state: ShardedAggState, packed: torch.Tensor,
                      slots: torch.Tensor, plan: ApplyPlan) -> None:
    """K2 over S shards in one launch per phase and slice (the per-shard
    accumulator update of ``risingwave_tpu/parallel/agg.py:306-321``):
    shard s folds ``packed[s]`` int32[N, W] at ``slots[s]`` into its own
    state. The launch plan is ``agg_apply``'s, whatever S is."""
    if packed.device.type != "cuda":
        agg_apply_sharded_plain(state, packed, slots, plan)
        return
    _agg_apply_cuda(state.st, packed, slots, plan)


def _agg_apply_cuda(st: torch.Tensor, packed: torch.Tensor,
                    slots: torch.Tensor, plan: ApplyPlan) -> None:
    ns, n, w = packed.shape
    if packed.dtype != torch.int32 or slots.dtype != torch.int32 or \
            st.dtype != torch.int32:
        raise TypeError("agg_apply takes int32 packed rows, slots, state")
    if slots.shape != (ns, n) or st.shape[0] != ns or not (
            packed.stride(1) == w and packed.stride(2) == 1
            and slots.stride(1) == 1 and st[0].is_contiguous()):
        raise ValueError("agg_apply needs [S, N, W] rows, [S, N] slots and "
                         "[S, R, cap] state, each shard contiguous")
    if not (packed.device == slots.device == st.device ==
            plan.desc_dev.device):
        raise ValueError("agg_apply tensors must share one device")
    cap = st.shape[2]
    ncalls = plan.desc.shape[0]
    kw = plan.key_width
    step = lanes.MAX_CHUNK_ROWS if plan.has_sum_int else max(n, 1)
    for lo in range(0, n, step):
        rows = min(step, n - lo)
        cuda.call("agg_apply", "rw_agg_apply", 0, packed.data_ptr(), w, kw,
                  lo, rows, packed.stride(0), slots.data_ptr(),
                  slots.stride(0), st.data_ptr(), cap, st.stride(0),
                  plan.desc_dev.data_ptr(), ncalls, ns)
        LAUNCHES.add("agg_apply")
        if plan.has_sum_int:
            cuda.call("agg_apply", "rw_agg_carry", st.data_ptr(), cap,
                      st.stride(0), plan.desc_dev.data_ptr(), ncalls, ns)
            LAUNCHES.add("agg_apply")
    if plan.has_extreme and n:
        cuda.call("agg_apply", "rw_agg_apply", 1, packed.data_ptr(), w, kw,
                  0, n, packed.stride(0), slots.data_ptr(), slots.stride(0),
                  st.data_ptr(), cap, st.stride(0),
                  plan.desc_dev.data_ptr(), ncalls, ns)
        LAUNCHES.add("agg_apply")


def apply_batch(state: AggState, packed: torch.Tensor,
                plan: ApplyPlan) -> torch.Tensor:
    """One device step (``build_apply``'s step): K1 on the key lanes with
    valid = vis, then K2. Returns K1's stats (inserts, overflow)."""
    kw = plan.key_width
    _t, slots, stats = ht.probe_insert(state.table, packed[:, :kw],
                                       packed[:, kw + 1])
    agg_apply(state, packed, slots, plan)
    return stats


# -- K3: flush gather + advance ---------------------------------------------------

def flush_width(key_width: int, n_acc: int) -> int:
    return 1 + key_width + 1 + n_acc + 2 + n_acc


def _check_state(st: torch.Tensor, keys: torch.Tensor, occ: torch.Tensor,
                 what: str) -> None:
    """Wrapper checks of K3/K4 on [S, ...] state: int32, contiguous, one
    device, one capacity and shard count."""
    if not all(t.dtype == torch.int32 for t in (st, keys, occ)):
        raise TypeError(f"{what} takes int32 state")
    if not all(t.is_contiguous() for t in (st, keys, occ)):
        raise ValueError(f"{what} needs contiguous state")
    if not (st.device == keys.device == occ.device):
        raise ValueError(f"{what}: state tensors on different devices")
    if not (st.shape[0] == keys.shape[0] == occ.shape[0] and
            st.shape[2] == keys.shape[1] == occ.shape[1]):
        raise ValueError(f"{what}: state and table shapes differ")


def flush_gather_plain(state: AggState, flush_cap: int) -> torch.Tensor:
    """Plain PyTorch version of ``gather_packed`` (``hash_agg.py:596``)."""
    st, keys, occ = state.st, state.table.keys, state.table.occ
    cap = st.shape[1]
    nacc = state.n_acc
    dev = st.device
    dirty = st[ROW_DIRTY] != 0
    d32 = dirty.to(torch.int64)
    pos = torch.cumsum(d32, 0) - 1
    n_dirty = int(d32.sum())
    scat = torch.where(dirty & (pos < flush_cap), pos, flush_cap)
    idx = torch.zeros(flush_cap + 1, dtype=torch.int64, device=dev)
    idx.scatter_(0, scat, torch.arange(cap, dtype=torch.int64, device=dev))
    idx = idx[:flush_cap]
    cols = [idx.to(torch.int32)]
    cols += [keys[idx, k] for k in range(keys.shape[1])]
    cols.append(st[ROW_GROUP_ROWS][idx])
    cols += [st[ROW_ACC0 + a][idx] for a in range(nacc)]
    cols.append(st[ROW_EMITTED_VALID][idx])
    cols.append(st[ROW_EMITTED_ROWS][idx])
    cols += [st[ROW_ACC0 + nacc + a][idx] for a in range(nacc)]
    mat = torch.stack(cols, dim=1)
    header = torch.zeros((1, mat.shape[1]), dtype=torch.int32, device=dev)
    header[0, 0] = n_dirty
    header[0, 1] = int((occ != 0).sum())
    return torch.cat([header, mat], dim=0)


def flush_gather(state: AggState, flush_cap: int) -> torch.Tensor:
    """Kernel K3 (gather): dirty slots in slot order → int32[1 +
    flush_cap, W'] with header [n_dirty, n_groups] (the TRUE n_dirty,
    also past flush_cap)."""
    st, keys, occ = state.st, state.table.keys, state.table.occ
    if st.device.type != "cuda":
        return flush_gather_plain(state, flush_cap)
    return _flush_gather_cuda(st[None], keys[None], occ[None], flush_cap)[0]


def flush_gather_sharded_plain(state: ShardedAggState,
                               flush_cap: int) -> torch.Tensor:
    return torch.stack([flush_gather_plain(state.shard(s), flush_cap)
                        for s in range(state.n_shards)])


def flush_gather_sharded(state: ShardedAggState,
                         flush_cap: int) -> torch.Tensor:
    """K3 (gather) over S shards in one launch (``parallel/agg.py:621``'s
    per-shard ``gather_packed``) → int32[S, 1 + flush_cap, W'], one
    header per shard."""
    if state.st.device.type != "cuda":
        return flush_gather_sharded_plain(state, flush_cap)
    return _flush_gather_cuda(state.st, state.table.keys, state.table.occ,
                              flush_cap)


def _flush_gather_cuda(st: torch.Tensor, keys: torch.Tensor,
                       occ: torch.Tensor, flush_cap: int) -> torch.Tensor:
    _check_state(st, keys, occ, "flush_gather")
    ns, r, cap = st.shape
    k = keys.shape[2]
    nacc = (r - ROW_ACC0) // 2
    wout = flush_width(k, nacc)
    nb = (cap + 1023) // 1024
    counts = torch.empty((ns, 2 * nb), dtype=torch.int32, device=st.device)
    out = torch.empty((ns, 1 + flush_cap, wout), dtype=torch.int32,
                      device=st.device)
    cuda.call("flush", "rw_flush_gather", st.data_ptr(), keys.data_ptr(),
              occ.data_ptr(), cap, k, nacc, ns, counts.data_ptr(),
              flush_cap, out.data_ptr(), wout)
    LAUNCHES.add("flush_gather")
    return out


def advance_plain(state: AggState) -> None:
    """Plain PyTorch version of ``advance_state`` (``hash_agg.py:744``)."""
    st = state.st
    nacc = state.n_acc
    d = st[ROW_DIRTY] != 0
    gr = st[ROW_GROUP_ROWS]
    st[ROW_EMITTED_VALID] = torch.where(d, (gr > 0).to(torch.int32),
                                        st[ROW_EMITTED_VALID])
    st[ROW_EMITTED_ROWS] = torch.where(d, gr, st[ROW_EMITTED_ROWS])
    for a in range(nacc):
        e = ROW_ACC0 + nacc + a
        st[e] = torch.where(d, st[ROW_ACC0 + a], st[e])
    st[ROW_DIRTY] = 0


def advance(state: AggState) -> None:
    """Kernel K3 (advance): emitted := current for dirty slots; clear
    dirty. In place."""
    st = state.st
    if st.device.type != "cuda":
        advance_plain(state)
        return
    _advance_cuda(st[None], state.table.keys[None], state.table.occ[None])


def advance_sharded(state: ShardedAggState) -> None:
    """K3 (advance) over S shards in one launch (``parallel/agg.py:664``).
    In place."""
    if state.st.device.type != "cuda":
        for s in range(state.n_shards):
            advance_plain(state.shard(s))
        return
    _advance_cuda(state.st, state.table.keys, state.table.occ)


def _advance_cuda(st: torch.Tensor, keys: torch.Tensor,
                  occ: torch.Tensor) -> None:
    _check_state(st, keys, occ, "advance")
    cuda.call("flush", "rw_advance", st.data_ptr(), st.shape[2],
              (st.shape[1] - ROW_ACC0) // 2, st.shape[0])
    LAUNCHES.add("advance")


# -- K4: rebuild (live mask + remap) ------------------------------------------------

LIVE_GROW = 0          # also the reshard's rule (parallel/agg.py:833)
LIVE_RETIRE = 1
LIVE_EVICT = 2
_I32_SIGN_FLIP = -0x80000000


def live_mask_plain(state: AggState, mode: int, lane_off: int = 0,
                    wm_hi: int = 0, wm_lo: int = 0,
                    dropped: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the live masks of the growth step
    (``hash_agg.py:968``), ``retire_state`` (:676) and ``evict_state``
    (:727-728: the growth rule minus the ``dropped`` slots)."""
    st, keys, occ = state.st, state.table.keys, state.table.occ
    occ_b = occ != 0
    live = occ_b & ((st[ROW_GROUP_ROWS] != 0) | (st[ROW_DIRTY] != 0)
                    | (st[ROW_EMITTED_VALID] != 0))
    if mode == LIVE_EVICT:
        live = live & (dropped == 0)
    if mode == LIVE_RETIRE:
        hi = keys[:, lane_off]
        lo = keys[:, lane_off + 1] ^ _I32_SIGN_FLIP
        nonnull = keys[:, lane_off + 2] != 0
        wlo = wm_lo ^ _I32_SIGN_FLIP
        below = (hi < wm_hi) | ((hi == wm_hi) & (lo < wlo))
        live = live & ~(occ_b & nonnull & below)
    return live.to(torch.int32)


def live_mask(state: AggState, mode: int, lane_off: int = 0,
              wm_hi: int = 0, wm_lo: int = 0,
              dropped: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K4 (live mask) → int32[cap] of slots that survive a
    rebuild: the growth rule, the watermark-retirement rule on the key
    column whose lanes start at ``lane_off``, or the eviction rule (the
    growth rule minus the slots set in ``dropped`` int32[cap])."""
    st, keys, occ = state.st, state.table.keys, state.table.occ
    if st.device.type != "cuda":
        return live_mask_plain(state, mode, lane_off, wm_hi, wm_lo, dropped)
    return _live_mask_cuda(st[None], keys[None], occ[None], mode, lane_off,
                           wm_hi, wm_lo,
                           None if dropped is None else dropped[None])[0]


def live_mask_sharded(state: ShardedAggState, mode: int, lane_off: int = 0,
                      wm_hi: int = 0, wm_lo: int = 0) -> torch.Tensor:
    """K4 (live mask) over S shards in one launch → int32[S, cap]: the
    growth rule (also the reshard's) or the retirement rule."""
    if state.st.device.type != "cuda":
        return torch.stack([live_mask_plain(state.shard(s), mode, lane_off,
                                            wm_hi, wm_lo)
                            for s in range(state.n_shards)])
    return _live_mask_cuda(state.st, state.table.keys, state.table.occ,
                           mode, lane_off, wm_hi, wm_lo)


def _live_mask_cuda(st: torch.Tensor, keys: torch.Tensor, occ: torch.Tensor,
                    mode: int, lane_off: int, wm_hi: int, wm_lo: int,
                    dropped: Optional[torch.Tensor] = None) -> torch.Tensor:
    _check_state(st, keys, occ, "live_mask")
    if mode == LIVE_RETIRE and lane_off + 3 > keys.shape[2]:
        raise ValueError(f"lane_off {lane_off} past key width "
                         f"{keys.shape[2]}")
    if mode == LIVE_EVICT and (
            dropped is None or dropped.dtype != torch.int32
            or dropped.shape != occ.shape or not dropped.is_contiguous()
            or dropped.device != st.device):
        raise ValueError("the evict mode needs a contiguous int32 dropped "
                         "mask shaped like occ")
    ns, _r, cap = st.shape
    live = torch.empty((ns, cap), dtype=torch.int32, device=st.device)
    cuda.call("rebuild", "rw_live_mask", mode, st.data_ptr(),
              keys.data_ptr(), occ.data_ptr(), cap, keys.shape[2], lane_off,
              wm_hi, wm_lo, st.stride(0), ns,
              None if mode != LIVE_EVICT else dropped.data_ptr(),
              live.data_ptr())
    LAUNCHES.add("live_mask")
    return live


def remap_plain(src: torch.Tensor, old_to_new: torch.Tensor,
                occ_new: torch.Tensor, fill: torch.Tensor,
                new_cap: int) -> torch.Tensor:
    """Plain PyTorch version of ``remap_slots`` (``hash_agg.py:795``) over
    every row of a state matrix."""
    out = fill.to(torch.int32)[:, None].expand(
        src.shape[0], new_cap).clone()
    m = old_to_new >= 0
    out[:, old_to_new[m].to(torch.int64)] = src[:, m]
    return out


def remap(src: torch.Tensor, old_to_new: torch.Tensor,
          occ_new: torch.Tensor, fill: torch.Tensor,
          new_cap: int) -> torch.Tensor:
    """Kernel K4 (remap): re-scatter every row of ``src[R, n]`` through
    ``old_to_new`` into a fresh ``[R, new_cap]`` matrix, the fill of each
    row in the slots the fresh table (``occ_new``) left empty."""
    if src.device.type != "cuda":
        return remap_plain(src, old_to_new, occ_new, fill, new_cap)
    return _remap_cuda(src[None], old_to_new[None], occ_new[None], fill,
                       new_cap)[0]


def remap_sharded(src: torch.Tensor, old_to_new: torch.Tensor,
                  occ_new: torch.Tensor, fill: torch.Tensor,
                  new_cap: int) -> torch.Tensor:
    """K4 (remap) over S shards in one launch: ``src[S, R, n]`` through
    ``old_to_new[S, n]`` into a fresh ``[S, R, new_cap]``, shard by
    shard."""
    if src.device.type != "cuda":
        return torch.stack([remap_plain(src[s], old_to_new[s], occ_new[s],
                                        fill, new_cap)
                            for s in range(src.shape[0])])
    return _remap_cuda(src, old_to_new, occ_new, fill, new_cap)


def _remap_cuda(src: torch.Tensor, old_to_new: torch.Tensor,
                occ_new: torch.Tensor, fill: torch.Tensor,
                new_cap: int) -> torch.Tensor:
    ns, r, n = src.shape
    if src.dtype != torch.int32 or old_to_new.dtype != torch.int32 or \
            occ_new.dtype != torch.int32 or fill.dtype != torch.int32:
        raise TypeError("remap takes int32 tensors")
    if old_to_new.shape != (ns, n) or occ_new.shape != (ns, new_cap) or \
            fill.shape != (r,):
        raise ValueError("remap shape mismatch")
    if not all(t.is_contiguous() for t in (src, old_to_new, occ_new, fill)):
        raise ValueError("remap needs contiguous tensors")
    out = torch.empty((ns, r, new_cap), dtype=torch.int32,
                      device=src.device)
    cuda.call("rebuild", "rw_remap", src.data_ptr(), n,
              old_to_new.data_ptr(), occ_new.data_ptr(), new_cap,
              fill.data_ptr(), r, ns, out.data_ptr())
    LAUNCHES.add("remap")
    return out


def rebuild_live(state: AggState, live: torch.Tensor, new_cap: int,
                 fill: torch.Tensor) -> Tuple[AggState, torch.Tensor]:
    """``_rebuild_live`` (``hash_agg.py:642``): insert the live slots'
    keys into a fresh table (K1) and move every state row (K4). Returns
    (new state, K1 stats: [n_live, overflow])."""
    table = ht.make_state(new_cap, state.table.key_width, state.st.device)
    table, old_to_new, stats = ht.probe_insert(table, state.table.keys,
                                               live)
    st = remap(state.st, old_to_new, table.occ, fill, new_cap)
    return AggState(table, st), stats


def retire_state(state: AggState, wm_hi: int, wm_lo: int, lane_off: int,
                 fill: torch.Tensor) -> Tuple[AggState, torch.Tensor]:
    """Watermark retirement (``hash_agg.py:676``): drop every group whose
    key column at ``lane_off`` is strictly below the watermark."""
    live = live_mask(state, LIVE_RETIRE, lane_off, wm_hi, wm_lo)
    return rebuild_live(state, live, state.capacity, fill)


def grow_state(state: AggState, new_cap: int,
               fill: torch.Tensor) -> Tuple[AggState, torch.Tensor]:
    """Growth rehash (``GroupedAggKernel._grow_step``, :968), reclaiming
    groups with no rows that are neither dirty nor still emitted."""
    live = live_mask(state, LIVE_GROW)
    return rebuild_live(state, live, new_cap, fill)


def evict_state(state: AggState, key_lanes: torch.Tensor,
                valid: torch.Tensor, fill: torch.Tensor
                ) -> Tuple[AggState, torch.Tensor, torch.Tensor]:
    """Cold-tier eviction (``evict_state``, ``hash_agg.py:714``, B9): K8
    finds the given keys' slots and marks them dropped, K4 keeps the
    growth rule's live slots minus the dropped ones, and the K1 + K4
    rebuild moves the survivors into a fresh table of the same capacity.
    Keys that are not resident, duplicates and padding rows (valid = 0)
    drop nothing. The caller guarantees the evicted groups are clean
    (flushed and advanced). Returns (new state, K1's stats, K8's stats)."""
    dropped = torch.zeros(state.capacity, dtype=torch.int32,
                          device=state.st.device)
    _slots, lstats = ht.lookup(state.table, key_lanes, valid, dropped)
    live = live_mask(state, LIVE_EVICT, dropped=dropped)
    new, stats = rebuild_live(state, live, state.capacity, fill)
    return new, stats, lstats


# -- K9: scatter rows (the patch and the reload) --------------------------------

def scatter_rows_plain(st: torch.Tensor, idx: torch.Tensor,
                       rows: torch.Tensor, src: torch.Tensor) -> None:
    """Plain PyTorch version of K9 over S shards: ``st[s, rows[j],
    idx[s, i]] = src[s, j, i]``, indices outside [0, cap) dropped
    (``.at[idx].set(mode="drop")`` of ``build_patch``, :783)."""
    cap = st.shape[2]
    r = rows.to(torch.int64)
    for s in range(st.shape[0]):
        ix = idx[s].to(torch.int64)
        keep = (ix >= 0) & (ix < cap)
        st[s][r[:, None], ix[keep][None, :]] = src[s][:, keep]


def scatter_rows_sharded(st: torch.Tensor, idx: torch.Tensor,
                         rows: torch.Tensor, src: torch.Tensor) -> None:
    """Kernel K9: ``st[s, rows[j], idx[s, i]] = src[s, j, i]`` over S
    shards in one launch (st int32[S, R, cap], idx int32[S, n], rows
    int32[k], src int32[S, k, n]); an index outside [0, cap) — each
    shard's padding is its ``cap`` — writes nothing. In place."""
    if st.device.type != "cuda":
        scatter_rows_plain(st, idx, rows, src)
        return
    ns, _nr, cap = st.shape
    n = idx.shape[1]
    if not all(t.dtype == torch.int32 for t in (st, idx, rows, src)):
        raise TypeError("scatter_rows takes int32 tensors")
    if idx.shape != (ns, n) or src.shape != (ns, rows.shape[0], n) or \
            rows.dim() != 1:
        raise ValueError(f"scatter_rows shape mismatch: st {tuple(st.shape)}"
                         f", idx {tuple(idx.shape)}, rows "
                         f"{tuple(rows.shape)}, src {tuple(src.shape)}")
    if not all(t.is_contiguous() for t in (st, idx, rows, src)):
        raise ValueError("scatter_rows needs contiguous tensors")
    if not all(t.device == st.device for t in (idx, rows, src)):
        raise ValueError("scatter_rows tensors must share one device")
    cuda.call("scatter", "rw_scatter_rows", st.data_ptr(), cap,
              st.stride(0), idx.data_ptr(), idx.stride(0), n,
              rows.data_ptr(), rows.shape[0], src.data_ptr(),
              src.stride(0), ns)
    if n:
        LAUNCHES.add("scatter_rows")


def scatter_rows(st: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                 src: torch.Tensor) -> None:
    """K9 on one device: ``st[rows[j], idx[i]] = src[j, i]`` (st int32[R,
    cap], idx int32[n], src int32[k, n]); idx == cap is padding."""
    scatter_rows_sharded(st[None], idx[None], rows, src[None])


def encode_patch_cols(specs: Sequence[AggSpec], decoded,
                      raw_accs) -> List[np.ndarray]:
    """Corrected (value, nn) pairs → device acc columns for a patch
    (``hash_agg.py:761``). ``decoded[j]`` is (value, nn) for a corrected
    call, or None for an untouched one: untouched calls pass their RAW
    gathered device columns through bit for bit (re-encoding a float sum
    through its decoded f64 would perturb the (hi, lo) pair, and an
    integer SUM keeps K2's own limbs). Shared by the single-device and
    sharded kernels."""
    slices = _call_slices(specs)
    dev_cols: List[np.ndarray] = []
    for j, (s, d) in enumerate(zip(specs, decoded)):
        if d is None:
            assert raw_accs is not None, "raw accs needed for passthrough"
            dev_cols.extend(raw_accs[slices[j]])
        else:
            v, nn = d
            dev_cols.extend(s.encode_acc(v, nn))
    return dev_cols


def as_i32_cols(cols: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Device-layout columns as int32 (float columns as their bits)."""
    return [c.view(np.int32) if c.dtype == np.float32 else c.astype(np.int32)
            for c in cols]


def patch_rows(n_acc: int, device: torch.device) -> torch.Tensor:
    """The rows ``patch_state`` writes: every accumulator row."""
    return torch.arange(ROW_ACC0, ROW_ACC0 + n_acc, dtype=torch.int32,
                        device=device)


def patch_state(state: AggState, idx: torch.Tensor,
                cols: torch.Tensor) -> None:
    """``build_patch`` (``hash_agg.py:783``, B10) on K9: set every
    accumulator row at the slots ``idx`` int32[n] to ``cols`` int32[n_acc,
    n] (device layout, float rows as bits); idx == cap is padding. In
    place."""
    scatter_rows(state.st, idx, patch_rows(state.n_acc, state.st.device),
                 cols)


def load_rows(n_acc: int, device: torch.device) -> torch.Tensor:
    """The rows a reload writes (``load_groups``, :1200-1212): group_rows,
    emitted_valid, emitted_rows, the accumulators and the emitted
    accumulators — every row but dirty."""
    return torch.tensor([ROW_GROUP_ROWS, ROW_EMITTED_VALID,
                         ROW_EMITTED_ROWS,
                         *range(ROW_ACC0, ROW_ACC0 + 2 * n_acc)],
                        dtype=torch.int32, device=device)


def load_src(group_rows: np.ndarray,
             dev_cols: Sequence[np.ndarray]) -> np.ndarray:
    """K9's source block of a reload, in ``load_rows`` order: the groups
    come back emitted, their snapshot equal to their state."""
    n = len(group_rows)
    rows32 = np.asarray(group_rows).astype(np.int32)
    cols = as_i32_cols(dev_cols)
    return np.stack([rows32, np.ones(n, np.int32), rows32, *cols, *cols])


# -- host view of a flush -------------------------------------------------------------

@dataclass
class FlushResult:
    """Host view of the dirty groups at a barrier (decoded values)."""

    n: int
    keys: np.ndarray                 # int32[n, K] raw key lanes
    group_rows: np.ndarray           # int64[n] — current
    outs: List[np.ndarray]           # per call decoded output value
    nulls: List[np.ndarray]          # per call output-is-NULL
    nns: List[Optional[np.ndarray]]  # per call non-null count (None: cnt)
    was_emitted: np.ndarray          # bool[n]
    prev_rows: np.ndarray
    prev_outs: List[np.ndarray]
    prev_nulls: List[np.ndarray]
    prev_nns: List[Optional[np.ndarray]]
    # device-layout acc columns of the gather (None on an empty flush):
    # the patch passes untouched calls' columns through bit for bit
    raw_accs: Optional[List[np.ndarray]] = None
    prev_raw_accs: Optional[List[np.ndarray]] = None

    @staticmethod
    def empty(specs: Sequence[AggSpec], key_width: int) -> "FlushResult":
        z = np.zeros(0, dtype=np.int64)
        zb = np.zeros(0, dtype=bool)
        vals = [np.zeros(0, dtype=s.out_dtype) for s in specs]
        nns = [None if s.kind == AggKind.COUNT or _is_placeholder(s.kind)
               else z.copy() for s in specs]
        return FlushResult(
            0, np.zeros((0, key_width), dtype=np.int32), z.copy(),
            list(vals), [zb.copy() for _ in specs], list(nns),
            zb.copy(), z.copy(),
            [v.copy() for v in vals], [zb.copy() for _ in specs],
            [None if n is None else n.copy() for n in nns])


def _unpack_acc_cols(specs: Sequence[AggSpec], data: np.ndarray,
                     c0: int) -> List[np.ndarray]:
    """Packed int32 matrix columns → device-layout acc arrays."""
    out = []
    for dt, _fill in dev_layout(specs):
        col = np.ascontiguousarray(data[:, c0])
        if dt == np.dtype(np.float32):
            col = col.view(np.float32)
        out.append(col)
        c0 += 1
    return out


def _nns_of(specs, dev_cols) -> List[Optional[np.ndarray]]:
    out = []
    for s, sl in zip(specs, _call_slices(specs)):
        out.append(None if s.kind == AggKind.COUNT or _is_placeholder(s.kind)
                   else dev_cols[sl][-1].astype(np.int64))
    return out


def decode_flush_data(specs: Sequence[AggSpec], key_width: int,
                      data: np.ndarray) -> FlushResult:
    """Decode gathered dirty-slot rows (the gather layout minus the
    header) into a host FlushResult."""
    p = data.shape[0]
    k = key_width
    keys = data[:, 1:1 + k]
    rows = np.ascontiguousarray(data[:, 1 + k])
    if not (rows >= 0).all():
        raise RuntimeError(
            "group_rows wrapped int32 — a group exceeded 2^31 rows")
    n_acc = len(dev_layout(specs))
    accs = _unpack_acc_cols(specs, data, 2 + k)
    was = np.ascontiguousarray(data[:, 2 + k + n_acc]).astype(bool)
    prows = np.ascontiguousarray(data[:, 3 + k + n_acc])
    paccs = _unpack_acc_cols(specs, data, 4 + k + n_acc)
    outs, nulls = decode_outputs(specs, accs)
    pouts, pnulls = decode_outputs(specs, paccs)
    return FlushResult(
        n=p, keys=keys, group_rows=rows.astype(np.int64),
        outs=outs, nulls=nulls, nns=_nns_of(specs, accs),
        was_emitted=was, prev_rows=prows.astype(np.int64),
        prev_outs=pouts, prev_nulls=pnulls,
        prev_nns=_nns_of(specs, paccs), raw_accs=accs, prev_raw_accs=paccs)


class GroupedAggKernel:
    """Host driver of one operator's device state: batching, growth,
    flush bookkeeping, recovery (``hash_agg.py:342``).

    ``apply`` per chunk (rows gather into a host backlog; one upload and
    one K1 + K2 step per ``BATCH_ROWS`` rows, no waits), ``flush`` per
    barrier (one K3 gather, one device→host read), ``patch_accs`` between
    them for a retractable MIN/MAX (K9), ``advance`` after it,
    ``retire_below`` for watermark cleaning, ``evict_keys`` and
    ``load_groups`` for the cold tier (B9, B10), and ``rebuild`` on
    recovery (a fresh state and ``load_groups``).

    With ``prelude`` (an ``ops/fused.py`` program of MODE_AGG) the kernel
    runs in raw mode: ``apply_raw`` backlogs raw int64 chunk matrices, a
    dispatch uploads them once and ``agg_prelude`` (B19) computes the
    packed matrix on the card ahead of K1 + K2; the prelude's stage row
    counts accumulate on the card and are read with the flush.

    Occupancy accounting is sync-free (``PendingCounters``): each step's
    insert count is copied back asynchronously and folded in once it
    lands; growth decisions use count + rows of undrained steps.
    """

    # pressure growth (see _reserve) stops doubling past this capacity
    PRESSURE_GROW_CEILING = 1 << 21
    # default table: two in-flight 32K batches of pessimistic inserts plus
    # real occupancy without touching the growth ladder (~16 MiB for q7)
    DEFAULT_CAPACITY = 1 << 18
    # rows per device step (one upload, one K1 launch, K2 launches)
    BATCH_ROWS = 1 << 15

    def __init__(self, key_width: int, specs: Sequence[AggSpec],
                 capacity: Optional[int] = None,
                 flush_capacity: int = 1 << 10, device=None,
                 prelude=None):
        self.device = resolve_device(device)
        if capacity is None:
            capacity = self.DEFAULT_CAPACITY
        capacity = max(next_pow2(capacity), ht.MIN_CAPACITY)
        self.specs = tuple(specs)
        self.key_width = key_width
        self.state = make_agg_state(capacity, key_width, self.specs,
                                    self.device)
        self._plan = ApplyPlan(key_width, self.specs, self.device)
        self._fill = torch.tensor(state_fills(self.specs),
                                  dtype=torch.int32, device=self.device)
        self._flush_cap = next_pow2(flush_capacity)
        self._counters = PendingCounters()
        self._backlog: List[np.ndarray] = []
        self._backlog_rows = 0
        self._flush_idx: Optional[np.ndarray] = None
        self._prelude = prelude
        self._stage_counts = None if prelude is None else torch.zeros(
            prelude.n_counts, dtype=torch.int64, device=self.device)

    @property
    def capacity(self) -> int:
        return self.state.capacity

    # -- hot path -------------------------------------------------------
    def apply(self, key_lanes: np.ndarray, signs: np.ndarray,
              vis: np.ndarray, inputs: Sequence) -> None:
        assert self._prelude is None, "a fused kernel takes apply_raw"
        packed = pack_chunk(self.key_width, self.specs,
                            np.asarray(key_lanes), np.asarray(signs),
                            np.asarray(vis), inputs)
        # a chunk may straddle two device steps: accumulator updates are
        # row-independent, so the batch slab fills completely
        n = len(signs)
        at = 0
        while at < n:
            room = self.BATCH_ROWS - self._backlog_rows
            if room <= 0:
                self._dispatch_backlog()
                continue
            take = min(n - at, room)
            self._backlog.append(
                packed if take == n else packed[at:at + take])
            self._backlog_rows += take
            at += take
            if self._backlog_rows >= self.BATCH_ROWS:
                self._dispatch_backlog()

    def apply_raw(self, raw: np.ndarray) -> None:
        """Fused hot path: backlog one RAW chunk matrix
        (ops/fused.encode_raw_chunk) plus an always-invisible separator
        row, so the prelude's shifted compares never pair rows of two
        chunks. A chunk never straddles two dispatches."""
        assert self._prelude is not None, "apply_raw needs a prelude"
        n = raw.shape[0] + 1
        if self._backlog_rows + n > self.BATCH_ROWS:
            self._dispatch_backlog()
        self._backlog.append(raw)
        self._backlog.append(np.zeros((1, raw.shape[1]), dtype=np.int64))
        self._backlog_rows += n
        if self._backlog_rows >= self.BATCH_ROWS:
            self._dispatch_backlog()

    def _dispatch_backlog(self) -> None:
        if not self._backlog:
            return
        mats, n = self._backlog, self._backlog_rows
        self._backlog, self._backlog_rows = [], 0
        raw_mode = self._prelude is not None
        units = self._prelude.units if raw_mode else 1
        self._reserve(n * units)
        w = mats[0].shape[1]
        cap_rows = self.BATCH_ROWS if n <= self.BATCH_ROWS \
            else next_pow2(n)
        packed = np.zeros((cap_rows, w),     # pad rows: vis=0
                          dtype=np.int64 if raw_mode else np.int32)
        at = 0
        for m in mats:
            packed[at:at + m.shape[0]] = m
            at += m.shape[0]
        dev = upload(packed, self.device)
        if raw_mode:
            from risingwave_tpu_torch.ops.fused import agg_prelude
            dev = agg_prelude(self._prelude, dev, self._stage_counts)
        stats = apply_batch(self.state, dev, self._plan)
        self._counters.push(stats, n * units)

    def drain_stage_counts(self) -> Optional[np.ndarray]:
        """The prelude's cumulative mask counts since the last drain
        (raw mode; call after flush, whose gather already waited for
        every queued step)."""
        if self._stage_counts is None:
            return None
        out = fetch(self._stage_counts)
        self._stage_counts.zero_()
        return out

    # -- growth ---------------------------------------------------------
    def _reserve(self, n: int) -> None:
        self._counters.drain_ready()
        if self._counters.bound() + n <= ht.MAX_LOAD * self.capacity:
            return
        # bound crossed: collapse it exactly, then grow as needed
        self._counters.drain_all()
        grew = False
        while self._counters.count() + n > ht.MAX_LOAD * self.capacity:
            self._grow()
            grew = True
        if not grew and self.capacity < self.PRESSURE_GROW_CEILING:
            # pressure growth: the wait was caused by the loose bound, not
            # by real occupancy; doubling lets the bound absorb an epoch
            self._grow()

    def _grow(self) -> None:
        """Rehash into a doubled table, reclaiming dead groups. The count
        before the grow stays a valid upper bound (a rebuild only
        reclaims); the next flush header makes it exact."""
        self.state, stats = grow_state(self.state, self.capacity * 2,
                                       self._fill)
        self._counters.watch(stats)

    def retire_below(self, group_pos: int, wm_i64: int) -> None:
        """Watermark state cleaning: drop groups whose ``group_pos``-th
        key column is strictly below the watermark (a device rebuild, no
        transfers). Call after ``advance``."""
        if self._backlog_rows:
            raise RuntimeError("retire_below with undispatched backlog")
        hi, lo = lanes.split_i64(np.asarray([wm_i64], dtype=np.int64))
        self.state, stats = retire_state(self.state, int(hi[0]), int(lo[0]),
                                         group_pos * 3, self._fill)
        self._counters.watch(stats)

    # -- cold tier (state/tier.py) ---------------------------------------
    def evict_keys(self, key_lanes: np.ndarray) -> None:
        """Drop the given groups' device slots (cold-tier eviction, B9;
        their rows stay durable in the value-state table). Call only at a
        barrier, after flush and advance, with no backlog: the tier sweeps
        only there, so the evicted groups are clean. The rebuild only
        reclaims, so the occupancy bound stays valid; K8's and K1's
        overflow flags are checked when their copies land."""
        if self._backlog_rows:
            raise RuntimeError("evict_keys with undispatched backlog")
        n = len(key_lanes)
        if n == 0:
            return
        cap_n = next_pow2(n)
        keys = np.zeros((cap_n, self.key_width), dtype=np.int32)
        keys[:n] = key_lanes
        valid = np.zeros(cap_n, dtype=np.int32)
        valid[:n] = 1
        self.state, stats, lstats = evict_state(
            self.state, upload(keys, self.device),
            upload(valid, self.device), self._fill)
        self._counters.watch(lstats)
        self._counters.watch(stats)

    def load_groups(self, keys: np.ndarray, group_rows: np.ndarray,
                    acc_cols: Sequence[np.ndarray]) -> None:
        """Reload evicted groups from committed state rows into the live
        table (cold-tier reload-on-touch, B10): K1 inserts the keys, K9
        sets group_rows, the accumulators and the emitted snapshot and
        marks them emitted (their outputs were committed downstream before
        eviction, so the next flush derives update pairs). ``dirty`` and
        the resident groups are untouched. `acc_cols` uses the HOST layout
        (acc_dtypes). The backlog dispatches first, so the reload lands
        before any buffered chunk that touches the same keys."""
        n = len(group_rows)
        if n == 0:
            return
        self._dispatch_backlog()
        self._reserve(n)
        dev_cols = encode_host_accs(self.specs, acc_cols)
        _t, slots, stats = ht.probe_insert(
            self.state.table,
            upload(np.asarray(keys, dtype=np.int32), self.device),
            upload(np.ones(n, dtype=np.int32), self.device))
        self._counters.push(stats, n)
        scatter_rows(self.state.st, slots,
                     load_rows(self.state.n_acc, self.device),
                     upload(load_src(group_rows, dev_cols), self.device))

    # -- barrier flush ---------------------------------------------------
    def flush(self) -> FlushResult:
        """Gather dirty groups to the host and decode — one device→host
        read. Call ``advance`` after consuming."""
        self._dispatch_backlog()
        while True:
            mat = fetch(flush_gather(self.state, self._flush_cap))
            p = int(mat[0, 0])
            # the gather ran after every queued step, so its header count
            # subsumes all pending insert counters
            self._counters.reset(int(mat[0, 1]))
            if p <= self._flush_cap:
                break
            self._flush_cap = max(self._flush_cap * 2, next_pow2(p))
        if p == 0:
            self._flush_idx = np.zeros(0, dtype=np.int32)
            return FlushResult.empty(self.specs, self.key_width)
        data = mat[1:1 + p]
        self._flush_idx = np.ascontiguousarray(data[:, 0])
        return decode_flush_data(self.specs, self.key_width, data)

    def patch_accs(self, decoded: List[Optional[Tuple[np.ndarray,
                                                      np.ndarray]]],
                   raw_accs: Optional[List[np.ndarray]] = None) -> None:
        """Overwrite the flushed groups' accumulators (the retractable
        MIN/MAX recompute, ``hash_agg.py:1241``) with one K9 launch, before
        ``advance``. See ``encode_patch_cols`` for the passthrough."""
        idx = self._flush_idx
        assert idx is not None and len(idx) > 0, "flush() first"
        cols = as_i32_cols(encode_patch_cols(self.specs, decoded, raw_accs))
        pad = next_pow2(len(idx))
        idx_p = np.full(pad, self.capacity, dtype=np.int32)
        idx_p[:len(idx)] = idx
        src = np.zeros((len(cols), pad), dtype=np.int32)
        src[:, :len(idx)] = np.stack(cols)
        patch_state(self.state, upload(idx_p, self.device),
                    upload(src, self.device))

    def advance(self) -> None:
        """Snapshot emitted := current for every dirty slot; clear dirty."""
        assert self._flush_idx is not None, "flush() first"
        self._flush_idx = None
        advance(self.state)

    # -- recovery ---------------------------------------------------------
    def rebuild(self, keys: np.ndarray, group_rows: np.ndarray,
                acc_cols: Sequence[np.ndarray]) -> None:
        """Reload from committed value-state rows (boot/recovery): a fresh
        state sized for them, then ``load_groups`` (K1 + K9). `acc_cols`
        uses the HOST layout (acc_dtypes). Restored groups are marked
        emitted: their outputs were committed downstream."""
        n = len(group_rows)
        cap = max(self.capacity, next_pow2(int(n / ht.MAX_LOAD) + 1))
        self.state = make_agg_state(cap, self.key_width, self.specs,
                                    self.device)
        self._counters.reset(0)
        self._backlog = []
        self._backlog_rows = 0
        self.load_groups(keys, group_rows, acc_cols)
