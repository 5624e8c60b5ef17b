"""The join's cold tier (``state_cap``) on the PyTorch port against the JAX
reference, on the CPU (every kernel's plain version).

The port's ``HashJoinExecutor(state_cap=...)`` (``device="cpu"``) and the
reference's run the same scripts: join state far past the resident cap,
so the tier's sweeps evict keys (their rows leave the arena and the
device but stay in the state table) and later probes reload them (K1 +
K5 at seq 0; for outer joins the reloaded rows' degrees recompute by one
probe against pre-epoch state, K6, written by K7). The emitted streams,
both state tables, each side's cold keys and the tier's eviction and
reload counts must be equal, and the results equal the uncapped run's:

- ``tests/test_join_cold_state.py:76`` (600 keys through a 64-key cap,
  every key probed again long after its eviction), :115 (recovery over
  the same store), :148 (the construction guards), :197 (a row inserted
  after its key went cold is not re-added on reload) and :231 (a
  retraction for an evicted key fails loud);
- ``tests/test_state_tier.py:329`` (LEFT OUTER: evicted unmatched rows
  matched after reload retract their padding) and :372 (a matched row
  evicted on both sides reloads with degree 1, not 0);
- join-key watermark expiry of cold keys (their durable rows delete, the
  tier forgets them) and the key interner's GC, which must keep the
  interned values of cold keys.
"""

import asyncio
import collections

import numpy as np
import pytest
import torch

from risingwave_tpu.stream.executors import hash_join as ref_hj
from risingwave_tpu_torch.parallel import ShardMesh
from risingwave_tpu_torch.stream.executors import hash_join as port_hj
from tests.test_torch_e2e_q8_mesh import PKG, _schema

torch.set_num_threads(2)

CAP = 64
SCHEMAS = ({"k": "INT64", "lv": "INT64", "lid": "INT64"},
           {"k": "INT64", "rv": "INT64", "rid": "INT64"})
STR_SCHEMAS = ({"k": "VARCHAR", "lv": "INT64", "lid": "INT64"},
               {"k": "VARCHAR", "rv": "INT64", "rid": "INT64"})


def _messages(m, schema, events):
    """('b', n) | ('w', value) (a join-key watermark) | (rows, ops) →
    the package's messages."""
    out = []
    names = [f.name for f in schema]
    for e in events:
        if e[0] == "b":
            ep = m["epoch"]
            prev = ep.Epoch.from_physical(e[1] - 1) if e[1] > 1 \
                else ep.Epoch.INVALID
            out.append(m["msg"].Barrier(
                ep.EpochPair(ep.Epoch.from_physical(e[1]), prev),
                m["msg"].BarrierKind.CHECKPOINT))
        elif e[0] == "w":
            out.append(m["msg"].Watermark(0, m["types"].DataType.INT64,
                                          e[1]))
        else:
            rows, ops = e
            out.append(m["chunk"].StreamChunk.from_pydict(
                schema, {nm: [r[i] for r in rows]
                         for i, nm in enumerate(names)}, ops=ops))
    return out


def run(pkg, lmsgs, rmsgs, nb, cap=CAP, jt="inner", store=None,
        schemas=SCHEMAS, pks=([0, 2], [0, 2])):
    """One package's capped join: (records, executor, state rows)."""
    m = PKG[pkg]
    store = store or m["Store"]()
    ls, rs = _schema(m, schemas[0]), _schema(m, schemas[1])
    # state-table pk = (join key, row id): the key prefix is what the
    # cold tier prefix-scans on reload
    lt = m["Table"](11, ls, pks[0], store, dist_key_indices=[0])
    rt = m["Table"](12, rs, pks[1], store, dist_key_indices=[0])
    mod = port_hj if pkg == "port" else ref_hj
    kw = {"device": "cpu"} if pkg == "port" else {}
    ex = mod.HashJoinExecutor(
        m["utils"].MockSource(ls, _messages(m, ls, lmsgs)),
        m["utils"].MockSource(rs, _messages(m, rs, rmsgs)),
        left_keys=[0], right_keys=[0], left_table=lt, right_table=rt,
        join_type=mod.JoinType(jt), state_cap=cap, **kw)
    msgs = asyncio.run(m["utils"].collect_until_n_barriers(ex, nb))
    records = []
    for msg in msgs:
        if hasattr(msg, "to_records"):
            records.append([(int(op), tuple(row))
                            for op, row in msg.to_records()])
        elif m["msg"].is_barrier(msg):
            records.append("b")
        else:
            records.append(("w", msg.col_idx, msg.value))
    return records, ex, (list(lt.iter_rows()), list(rt.iter_rows()))


def tier_counts(ex) -> list:
    return [(p.evicted_total, p.reload_total) for p in ex._tier_parts]


def both(lmsgs, rmsgs, nb, stores=(None, None), **kw):
    """The port's and the reference's capped runs: records, state
    tables, cold keys and tier counts equal. Returns the port's."""
    port = run("port", lmsgs, rmsgs, nb, store=stores[0], **kw)
    ref = run("ref", lmsgs, rmsgs, nb, store=stores[1], **kw)
    assert port[0] == ref[0]
    assert port[2] == ref[2]
    assert [s.cold_keys for s in port[1].sides] == \
        [s.cold_keys for s in ref[1].sides]
    assert tier_counts(port[1]) == tier_counts(ref[1])
    return port


def signed(records) -> collections.Counter:
    """(row, is_insert) counts."""
    out = collections.Counter()
    for rec in records:
        if isinstance(rec, list):
            for op, row in rec:
                out[(row, op in (1, 4))] += 1
    return out


def view(records) -> collections.Counter:
    out = collections.Counter()
    for rec in records:
        if isinstance(rec, list):
            for op, row in rec:
                out[row] += 1 if op in (1, 4) else -1
    return +out


def inner_oracle(left_rows, right_rows) -> collections.Counter:
    by_key = collections.defaultdict(list)
    for r in right_rows:
        by_key[r[0]].append(r)
    out = collections.Counter()
    for lrow in left_rows:
        for r in by_key.get(lrow[0], ()):
            out[lrow + r] += 1
    return out


def over_cap_script(n_keys=600):
    """``test_join_cold_state.py:76``: rights arrive in key order (old
    keys go cold), then lefts probe every key, oldest first."""
    lmsgs, rmsgs = [("b", 1)], [("b", 1)]
    left_rows, right_rows = [], []
    epoch = 2
    for lo in range(0, n_keys, 100):
        rows = [(k, k * 10, k) for k in range(lo, lo + 100)]
        right_rows += rows
        rmsgs += [(rows, None), ("b", epoch)]
        lmsgs += [("b", epoch)]
        epoch += 1
    for lo in range(0, n_keys, 100):
        rows = [(k, k + 1, 10_000 + k) for k in range(lo, lo + 100)]
        left_rows += rows
        lmsgs += [(rows, None), ("b", epoch)]
        rmsgs += [("b", epoch)]
        epoch += 1
    return lmsgs, rmsgs, epoch - 1, left_rows, right_rows


@pytest.mark.parametrize("jt", ["inner", "left_outer", "right_outer",
                                "full_outer"])
def test_cold_state_10x_over_cap_matches_reference(jt):
    lm, rm, nb, left_rows, right_rows = over_cap_script()
    rec, ex, _st = both(lm, rm, nb, jt=jt)
    assert all(len(s.pk_to_ref) <= 2 * CAP for s in ex.sides)
    assert sum(len(s.cold_keys) for s in ex.sides) > 0
    assert all(e > 0 for e, _r in tier_counts(ex)[1:])
    assert sum(r for _e, r in tier_counts(ex)) > 0
    uncapped = run("port", lm, rm, nb, cap=None, jt=jt)
    assert view(rec) == view(uncapped[0])
    if jt == "inner":
        assert view(rec) == inner_oracle(left_rows, right_rows)


@pytest.mark.parametrize("jt", ["inner", "full_outer"])
def test_cold_state_survives_recovery(jt):
    """``test_join_cold_state.py:115``: restart over the same store, then
    probe keys that were cold before the crash (recovery loads resident
    and evicted rows alike and recomputes degrees)."""
    n_keys, epoch = 400, 2
    rmsgs, right_rows = [("b", 1)], []
    for lo in range(0, n_keys, 100):
        rows = [(k, k * 7, k) for k in range(lo, lo + 100)]
        right_rows += rows
        rmsgs += [(rows, None), ("b", epoch)]
        epoch += 1
    lmsgs = [("b", e) for e in range(1, epoch)]
    stores = (PKG["port"]["Store"](), PKG["ref"]["Store"]())
    a = both(lmsgs, rmsgs, epoch - 1, stores=stores, jt=jt)
    left_rows = [(k, 1, 10_000 + k) for k in range(0, n_keys, 3)]
    b = both([("b", epoch), (left_rows, None), ("b", epoch + 1)],
             [("b", epoch), ("b", epoch + 1)], 2, stores=stores, jt=jt)
    if jt == "inner":
        assert view(b[0]) == inner_oracle(left_rows, right_rows)
    # both phases fold to the MV of one uninterrupted, uncapped run
    whole = run("port", *_joined(lmsgs, rmsgs, epoch, left_rows), epoch,
                cap=None, jt=jt)
    assert view(a[0] + b[0]) == view(whole[0])


def _joined(lmsgs, rmsgs, epoch, left_rows):
    """The two phases as one uninterrupted stream."""
    return (lmsgs + [(left_rows, None), ("b", epoch)],
            rmsgs + [("b", epoch)])


def test_cold_state_guards():
    """``test_join_cold_state.py:148``: the reference's ValueErrors
    stand: pks the join keys do not prefix, a semi or anti join, a
    mesh."""
    m = PKG["port"]
    store = m["Store"]()
    ls, rs = _schema(m, SCHEMAS[0]), _schema(m, SCHEMAS[1])

    def build(lpk, **kw):
        return port_hj.HashJoinExecutor(
            m["utils"].MockSource(ls, []), m["utils"].MockSource(rs, []),
            [0], [0], m["Table"](1, ls, lpk, store),
            m["Table"](2, rs, [0, 2], store), device="cpu", state_cap=8,
            **kw)
    with pytest.raises(ValueError, match="prefixed"):
        build([2])
    for jt in ("left_semi", "left_anti", "right_semi", "right_anti"):
        with pytest.raises(ValueError, match="semi"):
            build([0, 2], join_type=port_hj.JoinType(jt))
    with pytest.raises(ValueError, match="single-device"):
        build([0, 2], mesh=ShardMesh(8, "cpu"))
    for jt in ("inner", "left_outer", "right_outer", "full_outer"):
        ex = build([0, 2], join_type=port_hj.JoinType(jt))
        assert [s.state_cap for s in ex.sides] == [8, 8]


def test_cold_state_insert_after_evict_no_duplicates():
    """``test_join_cold_state.py:197``: a row arriving for an already
    cold key is resident; the later probe's reload must not re-add
    it."""
    rmsgs, right_rows, epoch = [("b", 1)], [], 2
    for lo in range(0, 300, 100):
        rows = [(k, k, k) for k in range(lo, lo + 100)]
        right_rows += rows
        rmsgs += [(rows, None), ("b", epoch)]
        epoch += 1
    late = (0, 999, 9000)
    right_rows.append(late)
    rmsgs += [([late], None), ("b", epoch)]
    lmsgs = [("b", e) for e in range(1, epoch + 1)]
    epoch += 1
    probe = (0, 5, 7777)
    lmsgs += [([probe], None), ("b", epoch)]
    rmsgs += [("b", epoch)]
    rec, _ex, _st = both(lmsgs, rmsgs, epoch)
    got = view(rec)
    assert got == inner_oracle([probe], right_rows)
    assert got[probe + late] == 1


def test_cold_state_retracting_input_fails_loud():
    """``test_join_cold_state.py:231``: a retraction for an evicted key
    raises RuntimeError in both packages."""
    rmsgs, epoch = [("b", 1)], 2
    for lo in range(0, 300, 100):
        rmsgs += [([(k, k, k) for k in range(lo, lo + 100)], None),
                  ("b", epoch)]
        epoch += 1
    rmsgs += [([(0, 0, 0)], [2]), ("b", epoch)]
    lmsgs = [("b", e) for e in range(1, epoch + 1)]
    for pkg in ("port", "ref"):
        with pytest.raises(RuntimeError, match="evicted"):
            run(pkg, lmsgs, rmsgs, epoch)


def _evicted_then_matched():
    """``test_state_tier.py:329``: 300 unmatched left rows (their
    padding emitted), then right rows match the first 100 of them."""
    lmsgs, rmsgs, epoch = [("b", 1)], [("b", 1)], 2
    for lo in range(0, 300, 100):
        lmsgs += [([(k, k * 2, k) for k in range(lo, lo + 100)], None),
                  ("b", epoch)]
        rmsgs += [("b", epoch)]
        epoch += 1
    rmsgs += [([(k, k * 7, 1000 + k) for k in range(100)], None),
              ("b", epoch)]
    lmsgs += [("b", epoch)]
    return lmsgs, rmsgs, epoch


def _matched_then_evicted():
    """``test_state_tier.py:372``: key 0 matched at once, both sides
    flooded until it evicts everywhere, then a second right row for
    key 0."""
    lmsgs, rmsgs, epoch = [("b", 1)], [("b", 1)], 2
    lmsgs += [([(0, 5, 0)], None), ("b", epoch)]
    rmsgs += [([(0, 50, 100)], None), ("b", epoch)]
    epoch += 1
    for lo in range(1, 301, 100):
        lmsgs += [([(k, k, k) for k in range(lo, lo + 100)], None),
                  ("b", epoch)]
        rmsgs += [([(k, k, 500 + k) for k in range(lo, lo + 100)], None),
                  ("b", epoch)]
        epoch += 1
    rmsgs += [([(0, 51, 101)], None), ("b", epoch)]
    lmsgs += [("b", epoch)]
    return lmsgs, rmsgs, epoch


@pytest.mark.parametrize("jt", ["left_outer", "full_outer"])
@pytest.mark.parametrize("script", ["evicted_then_matched",
                                    "matched_then_evicted"])
def test_outer_join_reload_recomputes_degrees(jt, script):
    lm, rm, nb = {"evicted_then_matched": _evicted_then_matched,
                  "matched_then_evicted": _matched_then_evicted}[script]()
    rec, ex, _st = both(lm, rm, nb, cap=32, jt=jt)
    got_c = signed(rec)
    got_u = signed(run("port", lm, rm, nb, cap=None, jt=jt)[0])
    assert got_c == got_u
    assert sum(e for e, _r in tier_counts(ex)) > 0
    assert sum(r for _e, r in tier_counts(ex)) > 0
    if script == "evicted_then_matched":
        # key 0's padded row was emitted, then retracted once its
        # evicted left row matched after the reload
        pad = ((0, 0, 0, None, None, None), False)
        assert got_c[pad] == 1
    else:
        assert got_c[((0, 5, 0, 0, 50, 100), True)] == 1
        assert got_c[((0, 5, 0, 0, 51, 101), True)] == 1
        pad = (0, 5, 0, None, None, None)
        assert got_c[(pad, True)] == got_c[(pad, False)]


def test_cold_keys_expire_below_the_watermark():
    """Join-key watermarks under the cap: cold keys below the combined
    watermark expire too (their durable rows delete and the tier forgets
    them), so neither the state table nor the cold set keeps them."""
    lmsgs, rmsgs, epoch = [("b", 1)], [("b", 1)], 2
    for lo in range(0, 400, 100):
        rmsgs += [([(k, k, k) for k in range(lo, lo + 100)], None),
                  ("b", epoch)]
        lmsgs += [([(k, k, 5000 + k) for k in range(lo + 50, lo + 60)],
                   None), ("b", epoch)]
        epoch += 1
    lmsgs += [("w", 250), ("b", epoch)]
    rmsgs += [("w", 300), ("b", epoch)]
    epoch += 1
    lmsgs += [([(k, 0, 9000 + k) for k in (10, 260, 390)], None),
              ("b", epoch)]
    rmsgs += [("b", epoch)]
    rec, ex, (lrows, rrows) = both(lmsgs, rmsgs, epoch, jt="full_outer")
    assert min(r[0] for _pk, r in rrows) >= 250
    assert min(r[0] for _pk, r in lrows) >= 10
    assert all(vt[0] >= 250 for s in ex.sides for vt in s.cold_keys.values())
    assert ("w", 0, 250) in rec


def test_interner_gc_pins_cold_keys(monkeypatch):
    """Varchar join keys under the cap: the interner's GC runs (its gate
    lowered to 8 entries) while keys are cold; a cold key's interned id
    must survive, or its reload would miss. Both packages emit the same
    stream and keep the same interner."""
    for mod in (port_hj, ref_hj):
        monkeypatch.setattr(mod.HashJoinExecutor, "INTERNER_GC_MIN", 8)
    lmsgs, rmsgs, epoch = [("b", 1)], [("b", 1)], 2
    rng = np.random.default_rng(5)
    for lo in range(0, 300, 100):
        rmsgs += [([(f"k{k}", k, k) for k in range(lo, lo + 100)], None),
                  ("b", epoch)]
        lmsgs += [("b", epoch)]
        epoch += 1
    keys = rng.choice(300, 60, replace=False).tolist()
    lmsgs += [([(f"k{k}", 1, 7000 + k) for k in keys], None),
              ("b", epoch)]
    rmsgs += [("b", epoch)]
    rec, ex, _st = both(lmsgs, rmsgs, epoch, schemas=STR_SCHEMAS)
    assert len(view(rec)) == 60
    assert sum(r for _e, r in tier_counts(ex)) > 0
