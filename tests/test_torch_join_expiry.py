"""Join-key watermarks and state expiry on the PyTorch port against the
JAX reference, on the CPU (every kernel's plain version).

The port's ``HashJoinExecutor`` (``device="cpu"``) and the reference's
run the same scripts, with watermarks on the join key, on one device and
over 8 shards (``ShardMesh(8, "cpu")`` against the reference's 8-device
CPU mesh), for every join type. The emitted streams (chunks, forwarded
watermarks, barriers) and both state tables must be equal:

- ``tests/test_hash_join.py:244``: the combined watermark (the min
  across sides) forwards on both output key columns (the subject's key
  column alone for semi and anti joins) and expires the stored rows
  below it from both state tables at the barrier;
- ``tests/test_hash_join.py:268``: a key that survived expiry still
  matches afterwards;
- ``tests/test_multichip_join_exec.py:106``: expired keys find nothing
  in the next epoch; on a mesh each tombstone routes to its key's owner
  shard, and the message sequence steps past the tombstones;
- a watermark on a non-key column is dropped, and one that does not
  advance the combined watermark forwards nothing.
"""

import asyncio

import pytest
import torch

from risingwave_tpu.stream.executors import hash_join as ref_hj
from risingwave_tpu_torch.stream.executors import hash_join as port_hj
from tests.test_torch_e2e_q8_mesh import PKG, _mesh, _schema
from tests.test_torch_join_types import TYPES, view

torch.set_num_threads(2)

LR = ({"lk": "INT64", "lv": "INT64"}, {"rk": "INT64", "rv": "VARCHAR"})


def _messages(m, schema, events):
    """('b', n) | ('w', col, value) | (column dict, ops) → messages."""
    out = []
    for e in events:
        if e[0] == "b":
            ep = m["epoch"]
            prev = ep.Epoch.from_physical(e[1] - 1) if e[1] > 1 \
                else ep.Epoch.INVALID
            out.append(m["msg"].Barrier(
                ep.EpochPair(ep.Epoch.from_physical(e[1]), prev),
                m["msg"].BarrierKind.CHECKPOINT))
        elif e[0] == "w":
            out.append(m["msg"].Watermark(
                e[1], m["types"].DataType.INT64, e[2]))
        else:
            out.append(m["chunk"].StreamChunk.from_pydict(schema, e[0],
                                                          ops=e[1]))
    return out


def run(pkg, jt, sl, sr, nb, devs=None, n_shards=None, store=None):
    """(stream records, executor, state rows): records are one list of
    (op, row) per chunk, ("w", col, value) per watermark, "b" per
    barrier."""
    m = PKG[pkg]
    store = store or m["Store"]()
    ls, rs = _schema(m, LR[0]), _schema(m, LR[1])
    lt = m["Table"](21, ls, [1], store, dist_key_indices=[])
    rt = m["Table"](22, rs, [1], store, dist_key_indices=[])
    kw = dict(join_type=(port_hj if pkg == "port" else ref_hj).JoinType(jt),
              mesh=_mesh(pkg, devs, n_shards))
    if pkg == "port":
        kw["device"] = "cpu"
    ex = m["hj"].HashJoinExecutor(
        m["utils"].MockSource(ls, _messages(m, ls, sl)),
        m["utils"].MockSource(rs, _messages(m, rs, sr)),
        left_keys=[0], right_keys=[0], left_table=lt, right_table=rt, **kw)
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


def both(jt, sl, sr, nb, devs, n_shards):
    port = run("port", jt, sl, sr, nb, devs, n_shards)
    ref = run("ref", jt, sl, sr, nb, devs, n_shards)
    assert port[0] == ref[0]
    assert port[2] == ref[2]
    return port


def _lc(ks, vs, ops=None):
    return ({"lk": ks, "lv": vs}, ops)


def _rc(ks, vs, ops=None):
    return ({"rk": ks, "rv": vs}, ops)


def _wms(records):
    return [r for r in records if isinstance(r, tuple) and r[0] == "w"]


SHARDS = {"one": None, "mesh": 8}


@pytest.mark.parametrize("arm", list(SHARDS))
@pytest.mark.parametrize("jt", TYPES)
def test_key_watermark_forwards_and_expires_state(eight_devices, jt, arm):
    """``test_hash_join.py:244``: min(6, 8) = 6 forwards on the left key
    column 0 and the right one (column 2), or on the subject's key
    column 0 alone; keys 1 and 5 leave both state tables."""
    sl = [("b", 1), _lc([1, 5, 9], [10, 50, 90]), ("w", 0, 6), ("b", 2),
          ("b", 3)]
    sr = [("b", 1), _rc([1, 5, 9], ["a", "e", "i"]), ("w", 0, 8),
          ("b", 2), ("b", 3)]
    rec, ex, (lrows, rrows) = both(jt, sl, sr, 3, eight_devices,
                                   SHARDS[arm])
    want = {("w", 0, 6)} if ex.join_type.subject is not None \
        else {("w", 0, 6), ("w", 2, 6)}
    assert set(_wms(rec)) == want and len(_wms(rec)) == len(want)
    assert sorted(r[0] for _pk, r in lrows) == [9]
    assert sorted(r[0] for _pk, r in rrows) == [9]
    assert [len(s.pk_to_ref) for s in ex.sides] == [1, 1]


@pytest.mark.parametrize("arm", list(SHARDS))
@pytest.mark.parametrize("jt", TYPES)
def test_expiry_then_survivor_still_matches(eight_devices, jt, arm):
    """``test_hash_join.py:268`` with ``test_multichip_join_exec.py:106``'s
    third epoch: after expiry at combined watermark 9 (left) and 6
    (mesh script), new rows for the expired keys find nothing, the
    survivor matches old and new rows, and every message equals the
    reference's."""
    sl = [("b", 1), _lc([1, 5, 9], [10, 50, 90]), ("w", 0, 6), ("b", 2),
          _lc([9], [91]), ("b", 3)]
    sr = [("b", 1), _rc([9], ["i"]), ("w", 0, 8), ("b", 2),
          _rc([1, 5, 9], ["a2", "e2", "i2"]), ("b", 3)]
    rec, ex, (lrows, _r) = both(jt, sl, sr, 3, eight_devices, SHARDS[arm])
    got = view(rec)
    if jt == "inner":
        assert got == {(9, 90, 9, "i"): 1, (9, 91, 9, "i"): 1,
                       (9, 90, 9, "i2"): 1, (9, 91, 9, "i2"): 1}
    assert sorted(r[0] for _pk, r in lrows) == [9, 9]
    # the expiry's tombstones took one sequence of their own
    assert ex._seq == 1 + 4 + 1


@pytest.mark.parametrize("arm", list(SHARDS))
def test_non_key_and_stale_watermarks_forward_nothing(eight_devices, arm):
    """A watermark on a non-key column is dropped (reference behavior);
    one that does not advance the combined watermark forwards nothing
    and expires nothing more."""
    sl = [("b", 1), _lc([1, 4], [10, 40]), ("w", 1, 100), ("w", 0, 3),
          ("b", 2), ("w", 0, 2), ("b", 3)]
    sr = [("b", 1), _rc([1, 4], ["a", "d"]), ("w", 0, 5), ("b", 2),
          ("w", 0, 9), ("b", 3)]
    rec, ex, (lrows, rrows) = both("full_outer", sl, sr, 3, eight_devices,
                                   SHARDS[arm])
    # only min(3, 5) = 3 forwards; left's 2 does not advance it
    assert _wms(rec) == [("w", 0, 3), ("w", 2, 3)]
    assert sorted(r[0] for _pk, r in lrows) == [4]
    assert sorted(r[0] for _pk, r in rrows) == [4]
    assert view(rec) == {(4, 40, 4, "d"): 1, (1, 10, 1, "a"): 1}
