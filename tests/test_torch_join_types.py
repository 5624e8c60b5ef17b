"""All 8 join types on the PyTorch port against the JAX reference, on the
CPU (every kernel's plain version).

The same scripts, made from numpy seeds, run through the port's
``HashJoinExecutor`` (``device="cpu"``) and the reference's, on one
device, over 8 shards (``ShardMesh(8, "cpu")`` against the reference's
8-device CPU mesh from tests/conftest.py) and on the sharded per-chunk
arm (``epoch_batch=False``). The emitted message streams must be equal
record for record (so every barrier's materialized changelog is), both
state tables must be equal, and the final view must equal the join
recomputed over the final state:

- ``tests/test_join_types.py:110`` (scripted: unmatched inserts, a late
  match, N:M growth, retraction back to unmatched, NULL keys), :139 (a
  random stream with deletes and NULL keys) and :176 (kill and rebuild:
  degrees recomputed by one batch probe);
- ``tests/test_multichip_join_exec.py:92`` (a random stream over 8
  shards, varchar right values);
- ``tests/test_join_payload.py:119``, :128 and :169: the device-payload
  emit of outer rows equals the host-gather emit (``device_payload=
  False``) and the reference's, also across a kill and rebuild;
- a degree-tracked epoch whose pair buffer overflows (a small
  ``probe_capacity``: the first probe re-dispatches from its entry
  degree arrays), and a compaction under an outer join (degrees carried
  through ``read_degrees`` and K7's plain version).
"""

from collections import Counter

import numpy as np
import pytest
import torch

from risingwave_tpu.stream.executors import hash_join as ref_hj
from risingwave_tpu_torch.stream.executors import hash_join as port_hj
from tests.test_torch_e2e_q8_mesh import (
    PAY, PKG, _payload_random, _payload_scripted, run_join,
)

torch.set_num_threads(2)

TYPES = [t.value for t in port_hj.JoinType]
# one device, 8 shards epoch-batched, 8 shards per chunk
ARMS = {"one": dict(n_shards=None), "mesh": dict(n_shards=8),
        "perchunk": dict(n_shards=8, epoch_batch=False)}


def join_kw(pkg, jt: str, **kw) -> dict:
    mod = port_hj if pkg == "port" else ref_hj
    return dict(kw, join_type=mod.JoinType(jt))


def both(sl, sr, nb, jt, devs, stores=(None, None), **kw):
    """The port's and the reference's run of one script: records equal,
    state tables equal. Returns the port's (records, executor, state)."""
    port = run_join("port", sl, sr, nb, devs, store=stores[0],
                    **join_kw("port", jt, **kw))
    ref = run_join("ref", sl, sr, nb, devs, store=stores[1],
                   **join_kw("ref", jt, **kw))
    assert port[0] == ref[0]
    assert port[2] == ref[2]
    return port


def view(records) -> Counter:
    out = Counter()
    for rec in records:
        if not isinstance(rec, list):       # a barrier or a watermark
            continue
        for op, row in rec:
            out[row] += 1 if op in (1, 4) else -1
            assert out[row] >= 0, f"negative count for {row}"
    return +out


def oracle_view(jt: str, left, right, width=(2, 2)) -> Counter:
    """``test_join_types.py``'s oracle over the final multiset state."""
    def n_match(k, rows):
        return 0 if k is None else sum(1 for r in rows if r[0] == k)
    out = Counter()
    if jt in ("left_semi", "left_anti", "right_semi", "right_anti"):
        subj, other = (left, right) if jt.startswith("left") else \
            (right, left)
        for row in subj:
            if (n_match(row[0], other) > 0) != jt.endswith("anti"):
                out[tuple(row)] += 1
        return out
    nl, nr = (None,) * width[0], (None,) * width[1]
    for lrow in left:
        if n_match(lrow[0], right) == 0:
            if jt in ("left_outer", "full_outer"):
                out[tuple(lrow) + nr] += 1
            continue
        for rrow in right:
            if rrow[0] == lrow[0]:
                out[tuple(lrow) + tuple(rrow)] += 1
    if jt in ("right_outer", "full_outer"):
        for rrow in right:
            if n_match(rrow[0], left) == 0:
                out[nl + tuple(rrow)] += 1
    return out


def _lc(ks, vs, ops=None):
    return ({"lk": ks, "lv": vs}, ops)


def _rc(ks, vs, ops=None):
    return ({"rk": ks, "rv": vs}, ops)


def scripted():
    """``test_join_types.py:110``'s streams (right values varchar)."""
    sl = [("b", 1), _lc([1, 2, None], [10, 20, 30]), ("b", 2),
          _lc([1], [11]), ("b", 3), _lc([2], [20], [2]), ("b", 4)]
    sr = [("b", 1), _rc([3, None], ["90", "91"]), ("b", 2),
          _rc([1, 1], ["70", "71"]), ("b", 3), _rc([1], ["70"], [2]),
          ("b", 4)]
    left = [(1, 10), (None, 30), (1, 11)]
    right = [(3, "90"), (None, "91"), (1, "71")]
    return sl, sr, 4, left, right


def random_stream(seed: int, rows_a_side=(20, 20), key_range=6,
                  null_p=0.1):
    """``test_join_types.py:139`` (20 rows a side, keys 0-5, 10% NULL)
    and ``test_multichip_join_exec.py:92`` (24 and 16 rows, keys 0-7, no
    NULL): 5 epochs of inserts and deletes of live rows."""
    rng = np.random.default_rng(seed)
    rows = [[], []]
    sl, sr = [("b", 1)], [("b", 1)]
    pk = [0, 0]
    for b in range(2, 7):
        for side, script in ((0, sl), (1, sr)):
            ks, vs, ops = [], [], []
            for _ in range(rows_a_side[side]):
                if rows[side] and rng.random() < 0.3:
                    k, v = rows[side].pop(int(rng.integers(len(rows[side]))))
                    ops.append(2)
                else:
                    k = int(rng.integers(0, key_range))
                    if rng.random() < null_p:
                        k = None
                    v = pk[side] if side == 0 else f"r{pk[side]}"
                    pk[side] += 1
                    rows[side].append((k, v))
                    ops.append(1)
                ks.append(k)
                vs.append(v)
            script.append((_lc if side == 0 else _rc)(ks, vs, ops))
            script.append(("b", b))
    return sl, sr, 6, rows[0], rows[1]


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("jt", TYPES)
def test_join_type_scripted_matches_reference(eight_devices, jt, arm):
    sl, sr, nb, left, right = scripted()
    rec, ex, _st = both(sl, sr, nb, jt, eight_devices, **ARMS[arm])
    assert view(rec) == oracle_view(jt, left, right)
    assert [s.track_degrees for s in ex.sides] == [
        i in ex.join_type.tracked_sides for i in (0, 1)]


# the per-chunk arm on the random stream for one type of each kind (the
# scripted case runs it for all 8)
RANDOM_CASES = [(jt, arm) for arm in ARMS for jt in TYPES
                if arm != "perchunk" or jt in ("inner", "left_outer",
                                               "full_outer", "right_anti")]


@pytest.mark.parametrize("jt,arm", RANDOM_CASES)
def test_join_type_random_stream_matches_reference(eight_devices, jt, arm):
    seed = 100 + TYPES.index(jt)
    shape = {} if arm == "one" else dict(rows_a_side=(24, 16), key_range=8)
    sl, sr, nb, left, right = random_stream(seed, **shape)
    rec, _ex, _st = both(sl, sr, nb, jt, eight_devices, **ARMS[arm])
    assert view(rec) == oracle_view(jt, left, right)


@pytest.mark.parametrize("arm", ["one", "mesh"])
@pytest.mark.parametrize("jt", TYPES)
def test_join_type_recovery_recomputes_degrees(eight_devices, jt, arm):
    """``test_join_types.py:176``: kill and rebuild mid-stream on the same
    store; degrees recompute from the recovered state by one batch probe,
    and the resumed changelog still materializes to the oracle."""
    stores = (PKG["port"]["Store"](), PKG["ref"]["Store"]())
    p1 = both([("b", 1), _lc([1, 2], [10, 20]), ("b", 2)],
              [("b", 1), _rc([1], ["70"]), ("b", 2)], 2, jt, eight_devices,
              stores=stores, **ARMS[arm])
    p2 = both([("b", 3), _lc([1], [10], [2]), ("b", 4)],
              [("b", 3), _rc([2, 1], ["80", "71"]), ("b", 4)], 2, jt,
              eight_devices, stores=stores, **ARMS[arm])
    want = oracle_view(jt, [(2, 20)], [(1, "70"), (2, "80"), (1, "71")])
    assert view(p1[0] + p2[0]) == want


def _pay_scripts(streams):
    return {"scripted": _payload_scripted, "random": _payload_random}[
        streams]()


@pytest.mark.parametrize("streams", ["scripted", "random"])
@pytest.mark.parametrize("jt", [t for t in TYPES if t != "inner"])
def test_device_payload_emits_outer_rows_bit_identical(jt, streams):
    """``test_join_payload.py:119`` and :128 for the 7 degree-tracked
    types: the device-payload emit (NULL-padded rows, degree flips,
    float bit patterns, NULL payload values, a varchar column from the
    arena) equals the host-gather emit and the reference's, message for
    message; the state tables too."""
    sl, sr, nb = _pay_scripts(streams)
    kw = dict(n_shards=None, schemas=PAY, pks=([0, 1], [0, 1]))
    on, ex_on, st_on = both(sl, sr, nb, jt, None, **kw)
    off, _x, st_off = run_join("port", sl, sr, nb, device_payload=False,
                               **join_kw("port", jt, **kw))
    assert ex_on.sides[0].pay_indices
    assert sum(len(c) for c in on if c != "b") > 0
    assert on == off and st_on == st_off


@pytest.mark.parametrize("jt", ["inner", "full_outer", "left_anti"])
def test_recovery_rebuilds_payload_lanes_and_degrees(jt):
    """``test_join_payload.py:169``: kill and rebuild mid-stream; the new
    executor rebuilds payload lanes where it rebuilds chains and
    recomputes degrees, and its emit equals the host-gather arm resumed
    the same way and the reference's."""
    kw = dict(n_shards=None, schemas=PAY, pks=([0, 1], [0, 1]))
    p1 = ([("b", 1), ({"lk": [1, 2], "lv": [10, 20], "ls": ["a", None],
                       "lf": [-0.0, 2.5]}, None), ("b", 2)],
          [("b", 1), ({"rk": [1], "rv": [70], "rs": ["r70"]}, None),
           ("b", 2)])
    p2 = ([("b", 3), ({"lk": [1], "lv": [10], "ls": ["a"], "lf": [-0.0]},
                      [2]), ("b", 4)],
          [("b", 3), ({"rk": [2, 1], "rv": [80, 71], "rs": [None, "z"]},
                      None), ("b", 4)])
    out = {}
    for arm in (True, False):
        stores = (PKG["port"]["Store"](), PKG["ref"]["Store"]())
        a = both(*p1, 2, jt, None, stores=stores, device_payload=arm, **kw)
        b = both(*p2, 2, jt, None, stores=stores, device_payload=arm, **kw)
        out[arm] = a[0] + b[0]
    assert out[True] == out[False]


@pytest.mark.parametrize("jt", ["left_outer", "full_outer", "right_semi",
                                "left_anti"])
def test_degree_epoch_pair_buffer_overflow(jt):
    """A degree-tracked epoch whose pair buffer overflows (probe_capacity
    8 against hundreds of pairs): each side's probe re-dispatches from
    the degree arrays it started from, installs them only after its
    collect, and the second side's probe waits for that; the records,
    the state and the device degree arrays equal the reference's."""
    sl, sr, nb, left, right = random_stream(7, rows_a_side=(40, 40),
                                            key_range=3, null_p=0.0)
    opts = dict(n_shards=None, shard_opts={"probe_capacity": 8})
    rec, ex, _st = both(sl, sr, nb, jt, None, **opts)
    assert ex.sides[0].kernel._probe_cap > 8
    assert view(rec) == oracle_view(jt, left, right)


def test_outer_compaction_carries_degrees(monkeypatch):
    """Update churn under a FULL OUTER join leaves dead refs; the
    barrier-time compaction reads the live degrees (``read_degrees``),
    rebuilds, and writes them back (K7's plain version): the emit after
    it still flips NULL-padded rows exactly as the reference's."""
    for mod in (port_hj, ref_hj):
        monkeypatch.setattr(mod._JoinSide, "COMPACT_MIN_REFS", 8)
    sl, sr = [("b", 1), _lc([0], [5])], [("b", 1), _rc([3], ["z"])]
    b, k_cur = 2, 0
    for _ in range(20):
        sl.append(("b", b))
        sr.append(("b", b))
        b += 1
        k_new = (k_cur + 1) % 4
        sl.append(_lc([k_cur, k_new], [5, 5], [3, 4]))
        k_cur = k_new
        if b % 5 == 0:
            sr.append(_rc([k_cur], [f"x{b}"]))
    sl.append(("b", b))
    sr.append(("b", b))
    compacted = []
    real = port_hj._JoinSide.compact

    def spy(self):
        compacted.append(self.kernel.read_degrees(self.live_refs()).copy()
                         if self.track_degrees and self.pk_to_ref else None)
        real(self)
        if compacted[-1] is not None:
            # the rebuilt refs are dense and keep their degrees
            np.testing.assert_array_equal(
                self.kernel.read_degrees(self.live_refs()), compacted[-1])
    monkeypatch.setattr(port_hj._JoinSide, "compact", spy)
    rec, ex, _st = both(sl, sr, b, "full_outer", None, n_shards=None)
    assert any(c is not None and c.any() for c in compacted)
    assert ex.sides[0].next_ref < 21
