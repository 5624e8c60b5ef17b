"""Batches that hold K2 (``agg_apply``), ``route``, K1 (``probe_insert``),
K6 (``join_probe``), K3 (``flush_gather``, ``advance``) and K5
(``join_apply``) to their plain versions at the shapes their
designs meet at the edges.

``tests/test_torch_cuda_kernels.py`` runs the kernels on these on the
card (``chip_smoke.py`` phase 3 K2's and route's). K2 aggregates the lanes of a warp that
share a slot, so its cases put every row on one slot, give every lane its
own slot, mix two or three slots a warp with invisible rows and NULL
inputs interleaved, tie MAX/MIN on the hi lane with different lo lanes
(with retractions among them), drive integer SUM to its limb extremes over
whole 8192-row slices, and carry a kNone lane. ``route`` cuts each sender
block into tiles of 256-row chunks and counts owners per warp, so its
cases send every row to one owner, spread owners uniformly, take 3
shards, a block that is not a whole number of chunks and one whose tiles
hold several chunks, an overflowing bucket, bucket 0 and empty blocks.
K1 claims slots by CAS, publishes them with a release store, lets a
warp's and a block's equal keys probe once and sums its insert count by
warp, so its cases race every row for one new key, give every row a new
key, spread in-batch duplicates over warps and blocks, fill a table to
just under MAX_LOAD, put home slots at the end of the table (the probe
wraps), interleave invalid rows (and all-zero keys), take 1, 3 and 6
lanes, n = 0, n that is not a multiple of 32 or of the block, and 8 and
3 shards. K6 keeps each
row's first two visible refs and walks longer chains from there, cuts
256-row tiles and pads the pair buffer with 16-byte stores, so its cases
hold chains of 0, 1 and many refs, refs invisible at the row's sequence
on either side, a buffer that the pairs fill exactly or overflow by one,
n that is not a multiple of the tile, n = 0, the degree branch and absent
keys whose probe wraps. K3 (``flush_gather``) scans 2,048-slot tiles in
one launch with a look-back between them and writes the header and the
padding from each shard's last tile, so its cases have no dirty slot,
every slot dirty, ``n_dirty`` equal to ``flush_cap`` and one past it (the
header keeps the true count), dirty slots on both sides of every tile
edge and at the last slot, a capacity smaller than one tile, 0 and 4
accumulators, and 1, 3 and 8 shards with a different ``n_dirty`` in each;
at maxbids' first agg's size (2^20 slots, and 8 shards of 2^17) a shard
has more tiles than the card holds blocks, so a block takes several
tiles in turn, and dirty slots lie in every tile. K5 (``join_apply``)
groups a warp's rows that share a slot, pushes each group onto its
slot's list, walks short lists and scans the batch for a slot of many
groups, and copies payload word by word, so its cases spread one slot
over many warps and blocks, hold q8's 400-row hot key, insert and delete
one ref in one batch, mix slot -1 rows and refs past row_cap into shared
slots, take P = 0 and an odd P, link only and tombstone only, 8 shards
of mostly empty received rows and a batch past one wave of resident
blocks. K3's advance runs on the flush's own list, so its cases
(``advance_case``) have nothing dirty, slot 0 dirty, every slot dirty, a
truncated list, 2^20 slots and 8 shards with uneven counts.
Everything is numpy, made from fixed seeds.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from risingwave_tpu_torch.common.hash import hash_lanes_plain
from risingwave_tpu_torch.ops import hash_agg as H
from risingwave_tpu_torch.ops import lanes

KW = 3                          # one int64 group column: (hi, lo, valid)
FLOAT_SUM_RTOL = 1e-6           # of Σ|terms| per group: atomic order
AGG_CASES = ("one_slot", "own_slot", "few_slots", "ties", "limbs", "none")
ROUTE_CASES = ("one_owner", "uniform", "three_shards", "ragged",
               "multi_chunk", "overflow", "bucket_0", "empty")
K1_CASES = ("one_key", "all_new", "dup_warps", "near_max_load", "wrap",
            "invalid_rows", "lanes_1", "lanes_6", "empty", "ragged")
K1_SHARDS = (8, 3)
K6_CASES = ("chains", "invisible", "exact_fit", "one_over", "ragged",
            "empty", "degrees", "absent_wrap")
K3_CASES = ("no_dirty", "all_dirty", "at_flush_cap", "past_flush_cap",
            "tile_edges", "small_cap", "nacc_0", "nacc_4", "maxbids",
            "maxbids_sharded")
K3_SHARDS = (1, 3, 8)
K3_TILE = H.FLUSH_TILE          # slots of one scan tile (csrc/flush.cu)
J_KW, J_P = 3, 6                # the K6 cases' key and payload lanes
FLAG_PROBE, FLAG_INS, FLAG_DEL, FLAG_NEG = 1, 2, 4, 8   # ops/hash_join.py
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


# -- K1 (probe_insert) -----------------------------------------------------------

def home_slots(keys: np.ndarray, cap: int) -> np.ndarray:
    """Each key row's home slot in a table of `cap` slots."""
    h = hash_lanes_plain(torch.from_numpy(np.ascontiguousarray(keys)))
    return (h & (cap - 1)).numpy()


def _rand_keys(rng, n: int, k: int, lo: int = -2**31, hi: int = 2**31):
    """n distinct rows of k random int32 lanes."""
    out = np.unique(rng.integers(lo, hi, (2 * n + 16, k)).astype(np.int32),
                    axis=0)
    return out[rng.permutation(len(out))[:n]]


def k1_cases() -> Dict[str, Tuple[int, List[Tuple[np.ndarray, np.ndarray]]]]:
    """name -> (cap, batches): batches (keys int32[n, K], valid bool[n])
    to apply in order to an empty table of cap slots."""
    rng = np.random.default_rng(81)
    n = 1 << 15
    ones = np.ones
    out = {}
    # 32K rows racing for one new key
    out["one_key"] = (1 << 16, [(np.tile(key_lanes([123_456_789]), (n, 1)),
                                 ones(n, bool))])
    # every row a new key (load 0.5)
    out["all_new"] = (1 << 16, [(key_lanes(rng.choice(10**9, n,
                                                      replace=False)),
                                 ones(n, bool))])
    # 4,096 keys, each on 8 rows that lie in different warps and blocks,
    # half of them placed by a first batch; all-zero keys among them
    g = (np.arange(n) * 7_919) % 4096
    keys = key_lanes(g * 31 + 7)
    keys[g % 512 == 0] = 0
    first = keys[np.unique(g, return_index=True)[1]][::2]
    out["dup_warps"] = (1 << 14, [(first, ones(len(first), bool)),
                                  (keys, ones(n, bool))])
    # a table filled to just under MAX_LOAD: long probe chains; the last
    # batch mixes new keys, keys already placed and in-batch duplicates
    cap = 1 << 12
    total = int(0.70 * cap) - 1
    u = key_lanes(rng.choice(10**6, total, replace=False) * 13 + 1)
    fill, new = u[:total // 2], u[total // 2:]
    last = np.concatenate([new, fill[:300], new[:200]])
    out["near_max_load"] = (cap, [(fill, ones(len(fill), bool)),
                                  (last[rng.permutation(len(last))],
                                   ones(len(last), bool))])
    # home slots in the last 8 of 1,024: every probe past cap - 1 wraps
    cap = 1 << 10
    cand = _rand_keys(rng, 40_000, KW)
    tail = cand[home_slots(cand, cap) >= cap - 8][:48]
    keys = np.concatenate([tail, tail[:16]])
    out["wrap"] = (cap, [(keys[rng.permutation(len(keys))],
                          ones(len(keys), bool))])
    # invalid rows interleaved (every other row, and every third), with
    # all-zero keys and duplicates
    m = 4096
    keys = key_lanes(rng.integers(0, 1500, m))
    keys[::97] = 0
    valid = (np.arange(m) % 2 == 0) | (np.arange(m) % 3 == 0)
    out["invalid_rows"] = (1 << 13, [(keys, valid)])
    # one lane and six lanes, with duplicates
    out["lanes_1"] = (1 << 13, [(rng.integers(-2000, 2000, (8192, 1))
                                 .astype(np.int32), rng.random(8192) < 0.9)])
    six = np.concatenate([key_lanes(rng.integers(0, 900, 8192)),
                          key_lanes(rng.integers(0, 5, 8192))], axis=1)
    out["lanes_6"] = (1 << 14, [(six, rng.random(8192) < 0.9)])
    # no rows; then rows that fill neither a warp nor a block evenly
    out["empty"] = (1 << 10, [(np.zeros((0, KW), np.int32),
                               np.zeros(0, bool))])
    out["ragged"] = (1 << 12, [
        (key_lanes(rng.integers(0, 700, 1000)), rng.random(1000) < 0.9),
        (key_lanes(rng.integers(0, 900, 33)), ones(33, bool))])
    return out


def k1_sharded_case(n_shards: int) -> Tuple[int, List[tuple]]:
    """(cap per shard, batches) for the shard axis: batches (keys
    int32[S, n, K], valid bool[S, n]); per shard a hot key, warm keys,
    singletons and invalid rows, then a second batch meeting them again
    (3 shards: rows that fill no block evenly)."""
    rng = np.random.default_rng(82 + n_shards)
    n = 4096 if n_shards == 8 else 1000
    batches = []
    for _b in range(2):
        keys, valid = [], []
        for s in range(n_shards):
            u = rng.random(n)
            g = np.where(u < 0.3, 5, np.where(u < 0.6, rng.integers(
                0, 50, n), rng.integers(100, 10**6, n)))
            keys.append(key_lanes(g + s * 10**7))
            valid.append(rng.random(n) < 0.9)
        batches.append((np.stack(keys), np.stack(valid)))
    return 1 << 12, batches


def k1_invariants(before: tuple, after: tuple, plain_after: tuple,
                  keys: np.ndarray, valid: np.ndarray, slots: np.ndarray,
                  stats: np.ndarray, plain_stats: np.ndarray) -> None:
    """K1 on one table against its plain version on one batch, in numpy
    (its slot rule is not the plain version's): the stats [inserted,
    overflow] exact and no overflow; invalid rows -1; each valid row's
    slot occupied and holding its key; equal keys on one slot; the slots
    occupied before unchanged; occ only 0 or 1; and the same keys newly
    inserted. `before`, `after` and `plain_after` are (keys [cap, K], occ
    [cap]). Raises AssertionError."""
    assert stats.tolist() == plain_stats.tolist(), (stats, plain_stats)
    assert int(stats[1]) == 0, "probe overflow"
    v = valid != 0
    assert (slots[~v] == -1).all() and (slots[v] >= 0).all()
    assert (after[0][slots[v]] == keys[v]).all(), "a slot lost its key"
    assert (after[1][slots[v]] == 1).all()
    if v.any():
        _u, inv = np.unique(keys[v], axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        first = np.full(inv.max() + 1, -1)
        first[inv[::-1]] = slots[v][::-1]
        assert (first[inv] == slots[v]).all(), "equal keys on two slots"
    b_occ = before[1] != 0
    assert (after[0][b_occ] == before[0][b_occ]).all() and \
        (after[1][b_occ] == 1).all(), "an occupied slot changed"
    assert set(np.unique(after[1]).tolist()) <= {0, 1}

    def new_keys(t):
        x = t[0][(t[1] != 0) & ~b_occ]
        return x[np.lexsort(x.T[::-1])] if len(x) else x
    np.testing.assert_array_equal(new_keys(after), new_keys(plain_after))


# -- K6 (join_probe) -------------------------------------------------------------

def _join_rows(g: np.ndarray, rng) -> np.ndarray:
    """[key lanes | payload lanes] of one int64 key column."""
    pay = rng.integers(-2**31, 2**31, (len(g), J_P)).astype(np.int32)
    return np.concatenate([key_lanes(g), pay], axis=1)


def _join_aux(n, ins_ref=None, del_ref=None, flags=0, seq=1):
    aux = np.zeros((n, 4), np.int32)
    if ins_ref is not None:
        aux[:, 0] = ins_ref
    if del_ref is not None:
        aux[:, 1] = del_ref
    aux[:, 2] = flags
    aux[:, 3] = seq
    return aux


def k6_cases() -> Dict[str, dict]:
    """name -> dict(cap, rows, stored=[(up, aux)], probe=(up, aux),
    out_cap, with_degrees): `stored` epochs go through epoch_apply on an
    empty side of cap key slots and rows refs (K_W = 3 key lanes, 6
    payload lanes), then `probe` through epoch_probe. `out_cap` is an int,
    or "total" / "total-1": the probe's pair count, which the caller reads
    with a large buffer first."""
    rng = np.random.default_rng(83)
    cap, rows = 1 << 11, 1 << 13
    # chains of 1 ref (300 keys) and of 60 refs (4 hot keys), inserted
    # interleaved at seqs 1..; payload random
    single = np.arange(300) * 11 + 1
    hot = np.array([7_000_001, 7_000_002, 7_000_003, 7_000_004])
    g = np.concatenate([single, np.repeat(hot, 60)])
    g = g[rng.permutation(len(g))]
    stored = [(_join_rows(g, rng), _join_aux(
        len(g), ins_ref=np.arange(len(g)), flags=FLAG_PROBE | FLAG_INS,
        seq=1 + np.arange(len(g)) // 64))]

    def probe(n, seq, neg_share=0.0, ins_share=0.0):
        u = rng.random(n)
        pg = np.where(u < 0.3, single[rng.integers(0, 300, n)],
                      np.where(u < 0.5, hot[rng.integers(0, 4, n)],
                               rng.integers(10**8, 2 * 10**8, n)))
        flags = FLAG_PROBE * (rng.random(n) < 0.9) \
            + FLAG_NEG * (rng.random(n) < neg_share) \
            + FLAG_INS * (rng.random(n) < ins_share)
        return _join_rows(pg, rng), _join_aux(
            n, ins_ref=rng.integers(-5, rows + 5, n), flags=flags, seq=seq)
    out = {}

    def case(p, out_cap=1 << 14, with_degrees=False, st=stored, c=cap):
        return dict(cap=c, rows=rows, stored=st, probe=p, out_cap=out_cap,
                    with_degrees=with_degrees)
    out["chains"] = case(probe(1024, 2**31 - 1))
    # refs invisible at the row's seq on either side: a 12-ref key and
    # single keys inserted at seqs 10..21, half of them deleted at seq 30;
    # probe rows at seqs on and around each edge (ins_seq < seq <= del_seq)
    g2 = np.concatenate([np.full(12, 9_000_001), np.arange(40) * 3 + 5])
    n2 = len(g2)
    ins2 = _join_aux(n2, ins_ref=np.arange(n2),
                     flags=FLAG_PROBE | FLAG_INS, seq=10 + np.arange(n2) % 12)
    dref = np.arange(0, n2, 2)
    del2 = _join_aux(len(dref), del_ref=dref, flags=FLAG_DEL, seq=30)
    st2 = [(_join_rows(g2, rng), ins2),
           (_join_rows(g2[dref], rng), del2)]
    m = 777
    pg = np.concatenate([g2, g2, g2])[rng.integers(0, 3 * n2, m)]
    seqs = rng.choice([5, 10, 11, 15, 21, 22, 29, 30, 31, 2**31 - 1], m)
    out["invisible"] = case((_join_rows(pg, rng), _join_aux(
        m, flags=FLAG_PROBE, seq=seqs)), st=st2)
    out["exact_fit"] = case(probe(1024, 2**31 - 1), out_cap="total")
    out["one_over"] = case(probe(1024, 2**31 - 1), out_cap="total-1")
    out["ragged"] = case(probe(777, 5))
    out["empty"] = case((np.zeros((0, J_KW + J_P), np.int32),
                         np.zeros((0, 4), np.int32)))
    out["degrees"] = case(probe(1000, 2**31 - 1, 0.2, 0.5),
                          with_degrees=True)
    # absent keys whose probe wraps: the last 8 slots of a 256-slot table
    # and its first ones hold keys homed at the end; probe keys homed there
    # that are not stored
    c3 = 1 << 8
    cand = rng.choice(10**7, 20_000, replace=False) + 10**6
    home = home_slots(key_lanes(cand), c3)
    at_end = cand[home >= c3 - 8]
    g3, absent = at_end[:24], at_end[24:64]
    st3 = [(_join_rows(g3, rng), _join_aux(
        len(g3), ins_ref=np.arange(len(g3)), flags=FLAG_PROBE | FLAG_INS))]
    pg = np.concatenate([absent, g3])
    out["absent_wrap"] = case((_join_rows(pg, rng), _join_aux(
        len(pg), flags=FLAG_PROBE, seq=2**31 - 1)), st=st3, c=c3)
    return out


def resolve_out_cap(spec, total: int) -> int:
    """A K6 case's pair buffer: an int as it is, "total" the probe's pair
    count, "total-1" one row short of it."""
    return {"total": total, "total-1": total - 1}.get(spec, spec)


def k6_sharded_case(n_shards: int) -> dict:
    """Inputs of the shard axis: keys stored per owner shard and a probe
    batch whose receive blocks are mostly empty: dict(stored=(lanes
    int32[m, K], refs), probe=(lanes int32[q, K], vis bool[q]), seqs,
    out_cap)."""
    rng = np.random.default_rng(84 + n_shards)
    m = 96 * n_shards
    g = np.concatenate([np.arange(m - 40) * 5 + 3, np.full(40, 77)])
    q = 24 * n_shards
    pg = np.where(rng.random(q) < 0.5, g[rng.integers(0, m, q)],
                  rng.integers(10**6, 10**7, q))
    return dict(stored=(key_lanes(g), np.arange(m, dtype=np.int32)),
                probe=(key_lanes(pg), rng.random(q) < 0.1),
                seqs=(2, 2**31 - 1), out_cap=1 << 8)



def k3_state(rng, cap: int, nacc: int, dirty: np.ndarray,
             k: int = KW) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(st int32[R, cap], keys int32[cap, k], occ int32[cap]) of an agg
    state in the port's layout with `nacc` accumulator rows: the slots in
    `dirty` dirty and occupied, ~half the others occupied, every other
    word random (emitted_valid 0/1, as the state holds it)."""
    r = H.ROW_ACC0 + 2 * nacc
    st = rng.integers(-2**31, 2**31, (r, cap), dtype=np.int64) \
        .astype(np.int32)
    st[H.ROW_DIRTY] = 0
    st[H.ROW_DIRTY, dirty] = 1
    st[H.ROW_EMITTED_VALID] = rng.integers(0, 2, cap)
    occ = (rng.random(cap) < 0.5).astype(np.int32)
    occ[dirty] = 1
    keys = rng.integers(-2**31, 2**31, (cap, k), dtype=np.int64) \
        .astype(np.int32)
    return st, keys, occ


def k3_case(name: str) -> Tuple[int, np.ndarray, np.ndarray,
                                np.ndarray]:
    """(flush_cap, st [S, R, cap], keys [S, cap, k], occ [S, cap]) of
    one of ``K3_CASES``: one shard (nacc 3, as q7's plan, unless the name
    says otherwise) but for ``maxbids_sharded``. ``maxbids`` is maxbids'
    first agg (2^20 slots, six key lanes, COUNT(*)) with three dirty slots
    in every tile, two of them its edges; ``maxbids_sharded`` is 8 shards
    of 2^17 slots with 1-3 dirty slots a tile (64, 128 and 192 a shard:
    under, at and past the flush_cap of 128)."""
    rng = np.random.default_rng(91 + K3_CASES.index(name))
    t = K3_TILE
    cap = 4 * t

    def case(fc, cap, nacc, dirty, k=KW):
        st, keys, occ = k3_state(rng, cap, nacc,
                                 np.asarray(dirty, dtype=np.int64), k)
        return fc, st[None], keys[None], occ[None]

    def per_tile(cap, n):
        """n dirty slots in every tile: its first, its last, then random
        ones between them."""
        tiles = np.arange(0, cap, t)
        picks = [tiles, tiles + t - 1][:n]
        for _ in range(n - 2):
            picks.append(tiles + rng.integers(1, t - 1, len(tiles)))
        return np.unique(np.concatenate(picks))

    if name == "no_dirty":
        return case(64, cap, 3, [])
    if name == "all_dirty":
        return case(2 * t, 2 * t, 3, np.arange(2 * t))
    if name in ("at_flush_cap", "past_flush_cap"):
        nd = 100 if name == "at_flush_cap" else 101
        return case(100, cap, 3, np.sort(rng.choice(cap, nd, replace=False)))
    if name == "tile_edges":
        return case(64, cap, 3, [0, 1] + [e + d for e in range(t, cap, t)
                                          for d in (-1, 0)] + [cap - 1])
    if name == "small_cap":
        return case(16, 64, 3, [0, 5, 31, 32, 63])
    if name in ("nacc_0", "nacc_4"):
        return case(1 << 10, 2 * t, int(name[-1]),
                    np.flatnonzero(rng.random(2 * t) < 0.1))
    if name == "maxbids":
        return case(1 << 11, 1 << 20, 1, per_tile(1 << 20, 3), k=2 * KW)
    assert name == "maxbids_sharded", name
    cap = 1 << 17
    parts = [k3_state(rng, cap, 3, per_tile(cap, d % 3 + 1))
             for d in range(8)]
    return (128,) + tuple(np.stack([p[i] for p in parts]) for i in range(3))


def k3_cases() -> Dict[str, Tuple[int, np.ndarray, np.ndarray,
                                  np.ndarray]]:
    """Every one of ``K3_CASES``: name -> ``k3_case(name)``."""
    return {name: k3_case(name) for name in K3_CASES}


def k3_sharded_case(n_shards: int) -> Tuple[int, np.ndarray, np.ndarray,
                                             np.ndarray]:
    """(flush_cap, st [S, R, cap], keys [S, cap, k], occ [S, cap]): two
    tiles a shard, a different n_dirty in each shard (13, 110, 207, 304,
    1, ...), some past the flush_cap of 256."""
    rng = np.random.default_rng(92 + n_shards)
    cap = 2 * K3_TILE
    sts, keys, occs = [], [], []
    for d in range(n_shards):
        nd = (d * 97 + 13) % 400
        st, k, o = k3_state(rng, cap, 3,
                            np.sort(rng.choice(cap, nd, replace=False)))
        sts.append(st)
        keys.append(k)
        occs.append(o)
    return 256, np.stack(sts), np.stack(keys), np.stack(occs)


# -- K5 (join_apply) ---------------------------------------------------------------

K5_CASES = ("many_warps", "hot_key", "ins_del_same_ref", "slot_minus_1",
            "refs_out_of_range", "p0", "odd_p", "link_only",
            "tombstone_only", "sharded_8", "past_one_wave")
K5_SHARDS = 8                   # the sharded case's shards


def k5_case(name: str) -> dict:
    """One K5 launch's inputs on chain arrays that already hold rows, as
    numpy: dict(cap, row_cap, head [S, cap], next / ins_seq / del_seq [S,
    row_cap], pay [S, row_cap, P] or None, slots [S, n] or None (no
    link), flags [S, n] (FLAG_INS inserts, FLAG_DEL tombstones), ins_ref,
    del_ref [S, n], seq [S, n] or an int, pay_src [S, n, P] or None).
    S = 1 but for ``sharded_8``. Insert refs are distinct, and so are
    delete refs (a ref written twice in one batch has no one result)."""
    rng = np.random.default_rng(131 + K5_CASES.index(name))
    cap, row_cap, p, s, n = 1 << 12, 1 << 14, J_P, 1, 4096
    link = name != "tombstone_only"
    tomb = name != "link_only"
    if name == "hot_key":
        cap, n = 1 << 14, 1 << 13
    elif name == "past_one_wave":
        # more 32-row tiles than one wave of resident blocks takes
        cap, row_cap, n = 1 << 20, 1 << 21, 1 << 19
    elif name == "sharded_8":
        s, n = K5_SHARDS, 8 * 256
    if name in ("p0", "link_only", "tombstone_only"):
        p = 0
    elif name == "odd_p":
        p = 5
    head = np.where(rng.random((s, cap)) < 0.5,
                    rng.integers(0, row_cap, (s, cap)), -1).astype(np.int32)
    nxt = rng.integers(-1, row_cap, (s, row_cap)).astype(np.int32)
    ins_seq = np.where(rng.random((s, row_cap)) < 0.5,
                       rng.integers(0, 1000, (s, row_cap)),
                       2**31 - 1).astype(np.int32)
    del_seq = np.where(rng.random((s, row_cap)) < 0.9, 2**31 - 1,
                       rng.integers(0, 1000, (s, row_cap))).astype(np.int32)
    pay = rng.integers(-2**31, 2**31, (s, row_cap, p)).astype(np.int32) \
        if p else None
    # inserts take fresh refs, deletes other refs (2n <= row_cap)
    ins = rng.random((s, n)) < 0.6
    dels = ~ins & (rng.random((s, n)) < 0.5)
    perm = np.stack([rng.permutation(row_cap)[:2 * n] for _ in range(s)])
    ins_ref = perm[:, :n].astype(np.int32)
    del_ref = perm[:, n:].astype(np.int32)
    if name == "hot_key":
        # q8's mixed epoch: ~400 rows of one key spread over the batch
        # among new keys (distinct slots), deletes and probe-only rows
        slots = rng.permutation(cap)[:n].astype(np.int32)[None]
        slots[0, rng.choice(np.flatnonzero(ins[0]), 400,
                            replace=False)] = 99
    else:
        slots = rng.integers(0, cap, (s, n)).astype(np.int32)
    if name == "many_warps":
        # one slot on 70% of the rows (every warp and block: more warp
        # groups than a leader walks), one on a row in each of 12 warps,
        # one on 3 rows of one warp
        slots[0, rng.random(n) < 0.7] = 7
        slots[0, np.arange(12) * 96 + 5] = 11
        slots[0, [40, 41, 63]] = 13
        ins[0] |= rng.random(n) < 0.8
    elif name == "ins_del_same_ref":
        # rows that insert and delete one ref, and rows that delete a ref
        # another row of the batch inserts
        both = ins & (rng.random((s, n)) < 0.15)
        dels |= both
        del_ref[both] = ins_ref[both]
        other = np.flatnonzero(dels[0] & ~both[0])[:200]
        src = np.flatnonzero(ins[0] & ~both[0])[:len(other)]
        del_ref[0, other[:len(src)]] = ins_ref[0, src]
    elif name == "slot_minus_1":
        slots[rng.random((s, n)) < 0.3] = -1
        slots[0, :64] = 5                         # shared, some -1 between
        slots[0, 3:64:4] = -1
    elif name == "refs_out_of_range":
        # refs past row_cap: nothing is written at them (the reference's
        # scatters drop them; a negative ref, which the reference wraps,
        # the port drops: a declared deviation, held by
        # tests/test_torch_hash_join.py::
        # test_deviation_negative_ref_dropped_where_reference_wraps)
        bad = rng.random((s, n)) < 0.2
        ins_ref[bad] = rng.integers(row_cap, row_cap + 50, int(bad.sum()))
        dbad = rng.random((s, n)) < 0.2
        del_ref[dbad] = rng.integers(row_cap, row_cap + 9, int(dbad.sum()))
        # a shared slot whose first and last rows have such refs
        sh = np.flatnonzero(ins[0])[:5]
        slots[0, sh] = 17
        ins_ref[0, sh[0]] = row_cap + 1
        ins_ref[0, sh[-1]] = row_cap + 2
    elif name == "sharded_8":
        # route's receive block: each shard's rows mostly empty (flags 0,
        # refs 0: ref 0 is a real ref), the live ones with shared slots
        live = rng.random((s, n)) < 0.1
        ins &= live
        dels &= live
        ins_ref[~live] = 0
        del_ref[~live] = 0
        slots[~live] = 0
        slots[live & (rng.random((s, n)) < 0.3)] = 3
    elif name == "past_one_wave":
        slots[0, rng.random(n) < 0.001] = 12345   # spread over the batch
        slots[0, 1000:1040] = 777                 # two warps
    if not link:
        ins[:] = False
    if not tomb:
        dels[:] = False
    flags = (ins * FLAG_INS + dels * FLAG_DEL + FLAG_PROBE
             * (rng.random(ins.shape) < 0.5)).astype(np.int32)
    seq = rng.integers(1, 2000, ins.shape).astype(np.int32) \
        if name != "link_only" else 1234
    pay_src = rng.integers(-2**31, 2**31, ins.shape + (p,)).astype(
        np.int32) if p else None
    return dict(cap=cap, row_cap=row_cap, head=head, next=nxt,
                ins_seq=ins_seq, del_seq=del_seq, pay=pay,
                slots=slots if link else None, flags=flags,
                ins_ref=ins_ref, del_ref=del_ref, seq=seq, pay_src=pay_src)


def k5_tensors(case: dict, device) -> tuple:
    """(chains [S, ...], pay [S, row_cap, P] or None, parts): a case on
    `device`, ``parts`` the keyword arguments of one K5 launch ([S, n]
    row inputs)."""
    from risingwave_tpu_torch.ops import hash_join as J

    def t(a):                   # a copy: the case's arrays stay as made
        return None if a is None else torch.from_numpy(
            np.array(a, copy=True)).to(device)
    chains = J.ChainState(*(t(case[k]) for k in ("head", "next", "ins_seq",
                                                 "del_seq")))
    seq = case["seq"]
    parts = dict(slots=t(case["slots"]), ins_ok=t(case["flags"]),
                 ins_bits=FLAG_INS, ins_ref=t(case["ins_ref"]),
                 seq=t(seq) if isinstance(seq, np.ndarray) else seq,
                 del_ok=t(case["flags"]), del_bits=FLAG_DEL,
                 del_ref=t(case["del_ref"]), pay_src=t(case["pay_src"]))
    return chains, t(case["pay"]), parts


def k5_plain(chains, pay, parts) -> None:
    """K5's plain version on one launch's row inputs ([n] with [cap] /
    [row_cap] chain arrays, or [S, n] with [S, ...]), in place: each
    shard's link_rows + tombstone_rows, then the payload scatter."""
    from risingwave_tpu_torch.ops import hash_join as J
    one = chains.head.dim() == 1

    def rows(x):
        return x[None] if one and isinstance(x, torch.Tensor) else x
    ch = J.ChainState(*(x[None] for x in chains)) if one else chains
    J.join_apply_sharded_plain(
        ch, rows(parts["slots"]), ins_ok=rows(parts["ins_ok"]),
        ins_bits=parts["ins_bits"], ins_ref=rows(parts["ins_ref"]),
        del_ok=rows(parts["del_ok"]), del_bits=parts["del_bits"],
        del_ref=rows(parts["del_ref"]), seq=rows(parts["seq"]))
    src = parts["pay_src"]
    if src is not None and src.shape[-1]:
        pays, srcs = (pay[None], src[None]) if one else (pay, src)
        ok = rows((parts["ins_ok"] & parts["ins_bits"]) != 0)
        refs = rows(parts["ins_ref"])
        for d in range(pays.shape[0]):
            J._masked_scatter_plain(pays[d], refs[d], ok[d], srcs[d])


def k5_launch(chains, pay, parts, scratch=None) -> None:
    """One K5 launch through the port's launch wrapper on CUDA tensors
    (the plain version on CPU tensors), in place."""
    from risingwave_tpu_torch.ops import hash_join as J
    if chains.head.device.type != "cuda":
        k5_plain(chains, pay, parts)
        return
    shape = tuple(parts["ins_ref"].shape)
    J._join_apply_launch(chains, pay, shape[-1],
                         1 if len(shape) == 1 else shape[0],
                         scratch=scratch, **parts)


def k5_result(chains, pay) -> List[np.ndarray]:
    """The arrays a K5 launch writes, as numpy."""
    return [x.cpu().numpy() for x in (*chains, *([] if pay is None
                                                 else [pay]))]


# -- K3 advance ----------------------------------------------------------------------

ADVANCE_CASES = ("nothing_dirty", "slot_0", "all_dirty", "truncated",
                 "maxbids", "sharded_uneven")


def advance_case(name: str) -> Tuple[int, np.ndarray, np.ndarray,
                                     np.ndarray]:
    """(flush_cap, st [S, R, cap], keys [S, cap, k], occ [S, cap]) of a
    state the flush gathers and the advance then takes on that flush's
    list: nothing dirty, slot 0 dirty, every slot dirty, more dirty slots
    than flush_cap (the matrix is truncated: the advance sweeps), maxbids'
    first agg (2^20 slots, ~2,200 dirty, one accumulator, six key lanes)
    and 8 shards of 2^15 slots with uneven counts (0 to 600, one shard
    past flush_cap)."""
    rng = np.random.default_rng(141 + ADVANCE_CASES.index(name))
    cap = 1 << 12

    def case(fc, cap, nacc, dirty, k=KW):
        st, keys, occ = k3_state(rng, cap, nacc,
                                 np.asarray(dirty, dtype=np.int64), k)
        return fc, st[None], keys[None], occ[None]
    if name == "nothing_dirty":
        return case(64, cap, 3, [])
    if name == "slot_0":
        return case(64, cap, 3, [0, 1, cap - 1])
    if name == "all_dirty":
        return case(cap, cap, 3, np.arange(cap))
    if name == "truncated":
        return case(128, cap, 3, np.sort(rng.choice(cap, 300,
                                                    replace=False)))
    if name == "maxbids":
        return case(1 << 12, 1 << 20, 1,
                    np.sort(rng.choice(1 << 20, 2214, replace=False)),
                    k=2 * KW)
    assert name == "sharded_uneven", name
    cap = 1 << 15
    parts = [k3_state(rng, cap, 3, np.sort(rng.choice(cap, nd,
                                                      replace=False)))
             for nd in (0, 1, 7, 130, 0, 600, 2, 511)]
    return (512,) + tuple(np.stack([p[i] for p in parts]) for i in range(3))
