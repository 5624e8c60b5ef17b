"""The temporal join of the PyTorch port, against the JAX reference, on
the CPU (host code: exact equality).

Each case builds the same left and right scripts in both packages and
runs them through the reference's ``TemporalJoinExecutor`` and the
port's: the message streams must be equal message for message.

- the twins of ``tests/test_temporal_join.py``'s executor cases (:52,
  :71, :79), each with the reference test's own expectation;
- the arrangement's compaction past 4,096 refs under update pairs, with
  NULL right keys, deletes and a LEFT OUTER probe every epoch: equal
  output, equal arrangement;
- seeded scripts with NULL left keys, left watermarks and INNER and
  LEFT OUTER probes, and the append-only assertion on the left input.
"""

import asyncio
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

import risingwave_tpu.common.chunk as r_chunk
import risingwave_tpu.common.epoch as r_epoch
import risingwave_tpu.common.types as r_types
import risingwave_tpu.stream.executors.temporal_join as r_tj
import risingwave_tpu.stream.executors.test_utils as r_tu
import risingwave_tpu.stream.message as r_msg
import risingwave_tpu_torch.common.chunk as p_chunk
import risingwave_tpu_torch.common.epoch as p_epoch
import risingwave_tpu_torch.common.types as p_types
import risingwave_tpu_torch.stream.executors.temporal_join as p_tj
import risingwave_tpu_torch.stream.executors.test_utils as p_tu
import risingwave_tpu_torch.stream.message as p_msg

PKGS = {
    "ref": SimpleNamespace(chunk=r_chunk, epoch=r_epoch, types=r_types,
                           tj=r_tj, tu=r_tu, msg=r_msg),
    "port": SimpleNamespace(chunk=p_chunk, epoch=p_epoch, types=p_types,
                            tj=p_tj, tu=p_tu, msg=p_msg),
}

INSERT, DELETE, U_DEL, U_INS = 1, 2, 3, 4
L = [("k", "INT64"), ("v", "INT64")]
R = [("rk", "INT64"), ("rv", "VARCHAR")]


def barrier(m, n):
    E = m.epoch.Epoch
    prev = E.from_physical(n - 1) if n > 1 else E.INVALID
    return m.msg.Barrier(m.epoch.EpochPair(E.from_physical(n), prev),
                         m.msg.BarrierKind.CHECKPOINT)


def schema_of(m, cols):
    T = m.types
    return T.Schema.of(**{nm: getattr(T.DataType, t) for nm, t in cols})


def script(m, cols, steps):
    """("b", n) a barrier, ("w", col, value) an INT64 watermark, ("c", rows,
    ops) a chunk of row tuples (None for NULL)."""
    sch = schema_of(m, cols)
    out = []
    for st in steps:
        if st[0] == "b":
            out.append(barrier(m, st[1]))
        elif st[0] == "w":
            out.append(m.msg.Watermark(st[1], m.types.DataType.INT64, st[2]))
        else:
            _c, rows, ops = st
            data = {nm: [r[i] for r in rows] for i, (nm, _t) in
                    enumerate(cols)}
            out.append(m.chunk.StreamChunk.from_pydict(sch, data, ops=ops))
    return out


def B(n):
    return ("b", n)


def C(rows, ops=None):
    return ("c", [tuple(r) for r in rows], ops)


def norm(m, msgs):
    out = []
    for x in msgs:
        if m.msg.is_chunk(x):
            out.append(("C", [(int(op), tuple(r)) for op, r in
                              x.to_records()]))
        elif m.msg.is_barrier(x):
            out.append(("B", x.epoch.curr.value))
        else:
            out.append(("W", x.col_idx, x.value))
    return out


def make(m, sl, sr, outer=False):
    ex = m.tj.TemporalJoinExecutor(
        m.tu.MockSource(schema_of(m, L), script(m, L, sl)),
        m.tu.MockSource(schema_of(m, R), script(m, R, sr), pk_indices=[0]),
        [0], [0], outer=outer)
    return ex


def run(m, sl, sr, nb, outer=False):
    ex = make(m, sl, sr, outer)
    msgs = asyncio.run(m.tu.collect_until_n_barriers(ex, nb))
    return norm(m, msgs), ex


def both(sl, sr, nb, outer=False):
    """Both executors on the scripts: equal streams and equal
    arrangements; returns the port's stream."""
    (got, pex), (want, rex) = (run(PKGS[p], sl, sr, nb, outer)
                               for p in ("port", "ref"))
    assert got == want, "message streams differ"
    assert pex._arranged == rex._arranged
    assert pex._next_ref == rex._next_ref
    return got


def rows(stream):
    return [r for item in stream if item[0] == "C" for _op, r in item[1]]


# -- twins of tests/test_temporal_join.py ---------------------------------------

def test_temporal_probe_sees_version_as_of_arrival_matches_reference():
    sl = [B(1), B(2), C([(1, 10)]), B(3), B(4), C([(1, 11)]), B(5)]
    sr = [B(1), C([(1, "old")]), B(2), B(3),
          C([(1, "old"), (1, "new")], ops=[U_DEL, U_INS]), B(4), B(5)]
    got = both(sl, sr, 5)
    assert rows(got) == [(1, 10, 1, "old"), (1, 11, 1, "new")]


@pytest.mark.parametrize("outer,want", [
    (False, {(1, 10, 1, "a"): 1}),
    (True, {(1, 10, 1, "a"): 1, (2, 20, None, None): 1})])
def test_temporal_inner_drops_unmatched_left_outer_pads_matches_reference(
        outer, want):
    sl = [B(1), B(2), C([(1, 10), (2, 20)]), B(3)]
    sr = [B(1), C([(1, "a")]), B(2), B(3)]
    assert Counter(rows(both(sl, sr, 3, outer=outer))) == Counter(want)


def test_temporal_right_delete_unmatches_matches_reference():
    sl = [B(1), B(2), B(3), C([(1, 10)]), B(4)]
    sr = [B(1), C([(1, "a")]), B(2), C([(1, "a")], ops=[DELETE]), B(3), B(4)]
    assert rows(both(sl, sr, 4, outer=True)) == [(1, 10, None, None)]


# -- compaction and seeded scripts ------------------------------------------------

@pytest.mark.parametrize("n_keys", [600, 3000])
def test_temporal_arena_compaction_under_update_pairs_matches_reference(
        n_keys):
    """A right changelog of ``n_keys`` keys updated in U-/U+ pairs every
    epoch (with deletes, re-inserts and NULL keys) hands out more than
    4,096 refs: the arena compacts (at 3,000 keys only once the dead refs
    are half), and the LEFT OUTER probes after it read the current
    versions, as the reference's do."""
    rng = np.random.default_rng(3)
    version = {}
    sl, sr = [B(1)], [B(1)]
    nb = 1
    for e in range(12):
        rrows, rops = [], []
        for k in range(n_keys):
            if k in version:
                if rng.random() < 0.05:
                    rrows.append((k, version.pop(k)))
                    rops.append(DELETE)
                    continue
                new = f"v{e}_{k}"
                rrows += [(k, version[k]), (k, new)]
                rops += [U_DEL, U_INS]
                version[k] = new
            elif rng.random() < 0.8:
                version[k] = f"v{e}_{k}"
                rrows.append((k, version[k]))
                rops.append(INSERT)
        rrows.append((None, "null key"))
        rops.append(INSERT)
        sr.append(C(rrows, rops))
        keys = rng.integers(0, n_keys + 100, 64).tolist()
        lrows = [(None if j % 17 == 0 else k, e * 100 + j)
                 for j, k in enumerate(keys)]
        sl.append(C(lrows))
        nb += 1
        sl.append(B(nb))
        sr.append(B(nb))
    got = both(sl, sr, nb, outer=True)
    out = rows(got)
    assert len(out) == 12 * 64
    # the last epoch's probes see the last versions
    last = [r for r in out if r[1] >= 1100]
    for k, _v, rk, rv in last:
        assert rv == version.get(k) if k is not None else rv is None
        assert (rk is None) == (rv is None)
    port_ex = run(PKGS["port"], sl, sr, nb, outer=True)[1]
    # refs handed out since the last compaction, below all refs ever taken
    assert port_ex._next_ref < sum(
        sum(1 for _r, op in zip(s[1], s[2] or [INSERT] * len(s[1]))
            if op in (INSERT, U_INS)) for s in sr if s[0] == "c")
    assert port_ex._next_ref >= len(port_ex._arranged) == len(version)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("outer", [False, True])
def test_temporal_seeded_scripts_match_reference(seed, outer):
    """Random right changelogs (inserts, deletes, update pairs), left
    chunks with NULL keys and left watermarks (one on a right column,
    which the join drops), barriers in between."""
    rng = np.random.default_rng(seed)
    version = {}
    sl, sr = [B(1)], [B(1)]
    nb = 1
    for e in range(6):
        for _ in range(int(rng.integers(1, 4))):
            rrows, rops = [], []
            for k in rng.integers(0, 30, 20).tolist():
                if k in version and rng.random() < 0.3:
                    rrows.append((k, version.pop(k)))
                    rops.append(DELETE)
                elif k in version:
                    new = f"{version[k]}+"
                    rrows += [(k, version[k]), (k, new)]
                    rops += [U_DEL, U_INS]
                    version[k] = new
                else:
                    version[k] = f"r{k}"
                    rrows.append((k, version[k]))
                    rops.append(INSERT)
            sr.append(C(rrows, rops))
            lk = rng.integers(0, 35, 10).tolist()
            sl.append(C([(None if rng.random() < 0.1 else k, e)
                         for k in lk]))
        sl.append(("w", 0, e * 10))
        sl.append(("w", 3, e))          # a right column: dropped
        nb += 1
        sl.append(B(nb))
        sr.append(B(nb))
    got = both(sl, sr, nb, outer=outer)
    assert [x[1:] for x in got if x[0] == "W"] == [(0, e * 10)
                                                   for e in range(6)]
    assert rows(got)


def test_temporal_left_must_be_append_only_in_both():
    sl = [B(1), C([(1, 10)], ops=[DELETE]), B(2)]
    sr = [B(1), B(2)]
    for m in PKGS.values():
        with pytest.raises(AssertionError, match="append-only"):
            run(m, sl, sr, 2)
