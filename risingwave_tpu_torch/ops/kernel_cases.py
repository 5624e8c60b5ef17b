"""Batches that hold K2 (``agg_apply``) and ``route`` to their plain
versions at the shapes their warp-level designs meet at the edges.

``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py`` phase 3 run
both kernels on these on the card. K2 aggregates the lanes of a warp that
share a slot, so its cases put every row on one slot, give every lane its
own slot, mix two or three slots a warp with invisible rows and NULL
inputs interleaved, tie MAX/MIN on the hi lane with different lo lanes
(with retractions among them), drive integer SUM to its limb extremes over
whole 8192-row slices, and carry a kNone lane. ``route`` cuts each sender
block into tiles of 256-row chunks and counts owners per warp, so its
cases send every row to one owner, spread owners uniformly, take 3
shards, a block that is not a whole number of chunks and one whose tiles
hold several chunks, an overflowing bucket, bucket 0 and empty blocks.
Everything is numpy, made from fixed seeds.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from risingwave_tpu_torch.ops import hash_agg as H
from risingwave_tpu_torch.ops import lanes

KW = 3                          # one int64 group column: (hi, lo, valid)
FLOAT_SUM_RTOL = 1e-6           # of Σ|terms| per group: atomic order
AGG_CASES = ("one_slot", "own_slot", "few_slots", "ties", "limbs", "none")
ROUTE_CASES = ("one_owner", "uniform", "three_shards", "ragged",
               "multi_chunk", "overflow", "bucket_0", "empty")
# every device kind: SUM(int), SUM(float), MAX, MIN, COUNT(*), COUNT(col)
ALL_KINDS = (("sum", np.int64), ("sum", np.float64), ("max", np.int64),
             ("min", np.int64), ("count", None), ("count", np.int64))
# the distinct path's plan: approx_count_distinct is K2's kNone lane
NONE_KINDS = (("count", None), ("count", np.int64),
              ("approx_count_distinct", np.int64))


def specs_of(pairs) -> tuple:
    return tuple(H.AggSpec(H.AggKind(k), None if d is None else np.dtype(d))
                 for k, d in pairs)


def key_lanes(g: np.ndarray) -> np.ndarray:
    hi, lo = lanes.split_i64(np.asarray(g, dtype=np.int64))
    return np.stack([hi, lo, np.ones(len(hi), np.int32)], axis=1)


def agg_batch(groups: np.ndarray, specs, rng, *, vis=None, signs=None,
              ok=None, ints=None) -> np.ndarray:
    """A packed batch (pack_chunk layout) of len(groups) rows. Defaults:
    5% invisible, 15% retractions, 10% NULL inputs, int inputs in
    ±1e12, float inputs ~ N(0, 1e3)."""
    n = len(groups)
    if vis is None:
        vis = rng.random(n) < 0.95
    if signs is None:
        signs = np.where(rng.random(n) < 0.15, -1, 1)
    if ints is None:
        ints = rng.integers(-10**12, 10**12, n)
    floats = rng.standard_normal(n) * 1e3
    inputs = []
    for s in specs:
        if s.in_dtype is None:
            inputs.append(((), None))
            continue
        valid = rng.random(n) < 0.9 if ok is None else ok
        vals = floats if np.issubdtype(s.in_dtype, np.floating) else ints
        inputs.append((s.encode_input(vals), valid))
    return H.pack_chunk(KW, specs, key_lanes(groups),
                        np.asarray(signs, np.int32), vis, inputs)


def agg_cases(n: int = 1 << 13) -> Dict[str, Tuple[tuple, np.ndarray]]:
    """name -> (specs, packed batch) for single-device K2 checks."""
    rng = np.random.default_rng(71)
    out = {}
    specs = specs_of(ALL_KINDS)
    # every row on one slot: one peer group per warp
    out["one_slot"] = (specs, agg_batch(np.full(n, 17), specs, rng))
    # every lane of a warp on its own slot: no peers at all
    out["own_slot"] = (specs, agg_batch(np.arange(n) * 7 - 3, specs, rng))
    # two or three slots a warp, interleaved with invisible rows (every
    # fifth) and NULL inputs (every third)
    warp = np.arange(n) // 32
    k = np.where(warp % 2 == 0, 2, 3)
    g = warp * 3 + (np.arange(n) * 7 + warp) % k
    out["few_slots"] = (specs, agg_batch(
        g, specs, rng, vis=np.arange(n) % 5 != 4,
        ok=np.arange(n) % 3 != 1))
    # MAX/MIN ties on hi: three hi words, random lo words, two groups,
    # retractions among the tied rows
    ties = (rng.integers(0, 3, n).astype(np.int64) << np.int64(32)) \
        + rng.integers(0, 1 << 32, n)
    out["ties"] = (specs, agg_batch(rng.integers(0, 2, n), specs, rng,
                                    ints=ties))
    # integer SUM at the limb extremes over exactly two 8192-row slices:
    # INT64_MAX, INT64_MIN and -1 (every limb at its largest); the first
    # slice inserts all its rows into one slot, the second splits between
    # that slot and another and retracts half its rows
    m = 2 * lanes.MAX_CHUNK_ROWS
    half = lanes.MAX_CHUNK_ROWS
    ext = np.array([np.iinfo(np.int64).max, np.iinfo(np.int64).min, -1])
    signs = np.ones(m, np.int64)
    signs[half:] = np.where(rng.random(half) < 0.5, -1, 1)
    g = np.zeros(m, np.int64)
    g[half:] = rng.integers(0, 2, half)
    out["limbs"] = (specs, agg_batch(
        g, specs, rng,
        vis=np.ones(m, bool), signs=signs, ok=np.ones(m, bool),
        ints=ext[rng.integers(0, 3, m)]))
    # the kNone lane on a hot slot
    nspecs = specs_of(NONE_KINDS)
    out["none"] = (nspecs, agg_batch(rng.integers(0, 3, n), nspecs, rng))
    return out


def sharded_agg_batch(n_shards: int, n: int = 1 << 12) -> Tuple[
        tuple, np.ndarray]:
    """(specs, packed [S, n, W]): per shard a hot slot, a few warm ones
    and singletons, with invisible rows and NULL inputs."""
    rng = np.random.default_rng(72 + n_shards)
    specs = specs_of(ALL_KINDS)
    blocks = []
    for s in range(n_shards):
        u = rng.random(n)
        g = np.where(u < 0.4, 5, np.where(u < 0.7, rng.integers(0, 6, n),
                                          rng.integers(100, 10**6, n)))
        blocks.append(agg_batch(g + s * 10**7, specs, rng))
    return specs, np.stack(blocks)


def route_cases() -> Dict[str, tuple]:
    """name -> (rows int32[S * local, W], valid bool[S * local], S,
    bucket) for route checks. Row lanes past the key lanes are random."""
    rng = np.random.default_rng(73)

    def rows(g, w):
        k = key_lanes(g)
        pay = rng.integers(-2**31, 2**31, (len(g), w - KW))
        return np.ascontiguousarray(
            np.concatenate([k, pay], axis=1).astype(np.int32))

    def case(s, local, w, bucket, keys=None, p_valid=0.9):
        n = s * local
        g = rng.integers(0, 10**6, n) if keys is None else keys(n)
        return rows(g, w), rng.random(n) < p_valid, s, bucket

    return {
        "one_owner": case(8, 4096, 8, 4096, keys=lambda n: np.full(n, 42)),
        "uniform": case(8, 4096, 8, 4096),
        "three_shards": case(3, 2500, 7, 2500),
        "ragged": case(8, 1000, 7, 1000),
        "multi_chunk": case(2, 40_000, 5, 40_000),
        "overflow": case(8, 4096, 8, 64),
        "bucket_0": case(8, 512, 8, 0),
        "empty": case(8, 0, 8, 16),
    }


def agg_state_err(specs, a: np.ndarray, b: np.ndarray, packed: np.ndarray,
                  slots: np.ndarray, kw: int = KW) -> float:
    """K2's state ``a`` against the plain version's ``b`` (int32[R, cap],
    after the same batch at the same slots): every integer row exact, and
    each lane of a float SUM within FLOAT_SUM_RTOL of its group's summed
    magnitudes in that lane, so a kernel that drops either lane misses by
    the lane. Raises AssertionError; returns the largest float error."""
    plan = H.ApplyPlan(kw, specs, "cpu")
    frows = {}
    for kind, acc, ic, vc in plan.desc.tolist():
        if kind == H._K_SUM_FLOAT:
            for k in range(2):
                frows[H.ROW_ACC0 + acc + k] = (ic + k, vc)
    ints = [r for r in range(a.shape[0]) if r not in frows]
    bad = np.flatnonzero((a[ints] != b[ints]).any(axis=1))
    assert len(bad) == 0, f"integer state rows {[ints[i] for i in bad]}"
    worst = 0.0
    for row, (col, vc) in frows.items():
        live = (packed[:, kw + 1] != 0) & (packed[:, vc] != 0) & (slots >= 0)
        mag = np.zeros(a.shape[1])
        np.add.at(mag, slots[live], np.abs(
            packed[live, col].view(np.float32).astype(np.float64)))
        err = np.abs(a[row].view(np.float32).astype(np.float64)
                     - b[row].view(np.float32).astype(np.float64))
        assert (err <= FLOAT_SUM_RTOL * mag).all(), (row, float(err.max()))
        worst = max(worst, float(err.max()))
    return worst
