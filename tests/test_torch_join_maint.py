"""K7 ``masked_scatter`` and the join maintenance built on it, on the
PyTorch port against the JAX reference, on the CPU (plain versions).

- Each K7 mode's plain version against the reference's
  ``_masked_scatter`` (``risingwave_tpu/ops/hash_join.py:361``): every
  row visible (no visibility array), masked rows, out-of-range refs,
  negative refs (dropped by the port, wrapped by the reference: ROADMAP
  queue C, so the reference gets those rows hidden), values read with a
  row stride from a column of a wider matrix, and the gather-carry mode
  against the reference's read-then-write of compaction (a host read at
  the live refs, then ``_masked_scatter`` at the dense new refs).
- ``JoinSideKernel.rebuild`` (one upload applied as an epoch: K1 + K5,
  the payload in K5's launch) against the reference's (insert at seq 0,
  then ``_masked_scatter``): key table, chains in their order, payload
  and degrees exact, with and without payload, and with the degree
  carry of a compaction.
- The whole executor, against the reference's records and both state
  tables: forced compaction (monkeypatched thresholds) and a kill and
  rebuild for every degree-tracked join type, and a cold-tier reload for
  the outer joins. The live rows' device degrees must equal the
  reference's, and the port's paths must make no host read of the degree
  array (``read_degrees``) and no host-collected probe for degrees.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.ops import hash_join as RJ
from risingwave_tpu.stream.executors import hash_join as ref_hj
from risingwave_tpu_torch.ops import hash_join as PJ
from risingwave_tpu_torch.stream.executors import hash_join as port_hj
from tests import test_torch_join_cold as cold
from tests.test_torch_hash_join import KW, P, _key_lanes, _same_chains, \
    _same_table
from tests.test_torch_e2e_q8_mesh import run_join
from tests.test_torch_join_types import (
    PKG, _lc, _rc, oracle_view, random_stream, view,
)

torch.set_num_threads(2)

TRACKED = [t.value for t in port_hj.JoinType if t.value != "inner"]
ROWS = 512
N = 300


def _ref_scatter(arr, refs, vis, vals):
    return np.asarray(RJ._masked_scatter(jnp.asarray(arr), jnp.asarray(refs),
                                         jnp.asarray(vis), jnp.asarray(vals)))


def _scatter_case(kind: str, width: int, seed: int):
    """(arr, refs, vis | None, vals) for one scatter case, numpy."""
    rng = np.random.default_rng(seed)
    shape = (ROWS,) if width == 1 else (ROWS, width)
    arr = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    refs = rng.permutation(ROWS)[:N].astype(np.int32)
    vals = rng.integers(-2**31, 2**31, (N,) + shape[1:]).astype(np.int32)
    vis = None
    if kind == "masked":
        vis = rng.random(N) < 0.7
    elif kind == "out_of_range":
        refs[rng.random(N) < 0.2] = ROWS + rng.integers(0, 9)
    elif kind == "negative":
        refs[rng.random(N) < 0.2] = -1 - rng.integers(0, 5)
    return arr, refs, vis, vals


@pytest.mark.parametrize("width", [1, P])
@pytest.mark.parametrize("kind", ["visible", "masked", "out_of_range",
                                  "negative", "strided"])
def test_masked_scatter_matches_reference(kind, width):
    """K7's scatter mode (the wrapper, which runs the plain version on a
    CPU tensor) against the reference's ``_masked_scatter``."""
    arr, refs, vis, vals = _scatter_case(kind, width, 3 + width)
    ref_vis = np.ones(N, bool) if vis is None else vis
    # the reference wraps a negative ref; the port drops it (queue C)
    want = _ref_scatter(arr, refs, ref_vis & (refs >= 0), vals)
    refs_t, vals_t = torch.from_numpy(refs), torch.from_numpy(vals)
    if kind == "strided":
        # refs as a column of a staged aux matrix, values as K6's degree
        # column (or payload lanes inside wider rows): any row stride
        aux = torch.zeros((N, 4), dtype=torch.int32)
        aux[:, PJ.AUX_INS_REF] = refs_t
        refs_t = aux[:, PJ.AUX_INS_REF]
        wide = torch.zeros((N + 1, width + 3), dtype=torch.int32)
        wide[1:, 1:1 + width] = vals_t.reshape(N, width)
        vals_t = wide[1:, 1] if width == 1 else wide[1:, 1:1 + width]
        assert refs_t.stride(0) == 4 and vals_t.stride(0) == width + 3
    got = PJ._masked_scatter(torch.from_numpy(arr.copy()), refs_t,
                             None if vis is None else torch.from_numpy(vis),
                             vals_t)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [1, P])
@pytest.mark.parametrize("kind", ["visible", "masked", "out_of_range",
                                  "strided"])
def test_gather_carry_matches_reference_read_then_write(kind, width):
    """K7's gather mode, dst[i] := src[idx[i]], against the reference's
    compaction: ``read_degrees`` at the live refs (a host read) then
    ``_masked_scatter`` of those values at the dense refs 0..n-1 of a
    fresh array. Hidden rows and refs outside the old array leave their
    dense row as it was (the reference gets them hidden)."""
    rng = np.random.default_rng(17 + width)
    shape = (ROWS,) if width == 1 else (ROWS, width)
    old = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    live = np.sort(rng.choice(ROWS, N, replace=False)).astype(np.int32)
    vis = rng.random(N) < 0.7 if kind == "masked" else None
    if kind == "out_of_range":
        live[rng.random(N) < 0.2] = ROWS + 3
    ok = (live >= 0) & (live < ROWS) & \
        (np.ones(N, bool) if vis is None else vis)
    fresh = np.zeros((2 * ROWS,) + shape[1:], np.int32)
    read = old[np.where(ok, live, 0)]                 # the host read
    want = _ref_scatter(fresh, np.arange(N, dtype=np.int32), ok, read)
    idx = torch.from_numpy(live)
    if kind == "strided":
        m = torch.zeros((N, 6), dtype=torch.int32)
        m[:, 5] = idx
        idx = m[:, 5]
    got = PJ._gather_carry(torch.from_numpy(fresh.copy()),
                           torch.from_numpy(old), idx,
                           None if vis is None else torch.from_numpy(vis))
    np.testing.assert_array_equal(got.numpy(), want)


def _kernels(row_capacity=64, payload_width=P):
    ref = RJ.JoinSideKernel(KW, key_capacity=1 << 10,
                            row_capacity=row_capacity,
                            payload_width=payload_width)
    port = PJ.JoinSideKernel(KW, key_capacity=1 << 10,
                             row_capacity=row_capacity,
                             payload_width=payload_width, device="cpu")
    return ref, port


def _same_side(port, ref):
    _same_table(port.table.state, ref.table.state)
    _same_chains(port.chains, ref.chains)
    np.testing.assert_array_equal(port.pay.numpy(), np.asarray(ref.pay))
    np.testing.assert_array_equal(port.deg.numpy(), np.asarray(ref.deg))


@pytest.mark.parametrize("case", ["payload", "no_payload", "carry",
                                  "duplicate_keys", "empty"])
def test_rebuild_matches_reference(monkeypatch, case):
    """The new rebuild (one upload, applied as an epoch: K1 + K5 with the
    payload in K5's launch) against the reference's insert at seq 0 then
    ``_masked_scatter``: the key table, every chain array (so each key's
    chain order), payload and degrees exact. ``carry``: a compaction's
    degrees, carried on the device by K7's gather, equal the reference's
    read-then-write. No rebuild writes its payload through K7."""
    rng = np.random.default_rng(29)
    width = 0 if case == "no_payload" else P
    ref, port = _kernels(payload_width=width)
    # some state first: a rebuild replaces it whole
    keys0 = _key_lanes(rng.integers(0, 40, 120))
    refs0 = np.arange(120, dtype=np.int32)
    ref.insert(jnp.asarray(keys0), refs0, jnp.ones(120, bool), seq=1)
    port.insert(torch.from_numpy(keys0), refs0,
                torch.ones(120, dtype=torch.bool), seq=1)
    dv = rng.integers(0, 7, 120).astype(np.int32)
    ref.write_degrees(refs0, dv)
    port.write_degrees(torch.from_numpy(refs0), torch.from_numpy(dv))
    _same_side(port, ref)
    n = {"empty": 0, "duplicate_keys": 200}.get(case, 90)
    key_range = 7 if case == "duplicate_keys" else 500
    keys = _key_lanes(rng.integers(0, key_range, n))
    pay = rng.integers(-2**31, 2**31, (n, width)).astype(np.int32) \
        if width else None
    k7 = []
    real = PJ._masked_scatter
    monkeypatch.setattr(PJ, "_masked_scatter",
                        lambda *a: k7.append(a) or real(*a))
    if case == "carry":
        live = np.sort(rng.choice(120, n, replace=False)).astype(np.int32)
        refs = np.arange(n, dtype=np.int32)
        read = ref.read_degrees(live)
        ref.rebuild(keys, refs, pay)
        ref.write_degrees(refs, read.astype(np.int32))
        port.rebuild(keys, refs, pay, carry=live)
        assert port.deg[:n].any()
    else:
        # recovery's refs: not dense, any order
        refs = rng.permutation(4 * n)[:n].astype(np.int32)
        ref.rebuild(keys, refs, pay)
        port.rebuild(keys, refs, pay)
    _same_side(port, ref)
    assert k7 == []


def test_rebuild_carry_needs_dense_refs():
    _ref, port = _kernels()
    keys = _key_lanes(np.arange(4))
    with pytest.raises(ValueError):
        port.rebuild(keys, np.array([0, 1, 3, 2], np.int32),
                     carry=np.arange(4, dtype=np.int32))


# -- the executor: compaction, recovery and reload against the reference ----

def _degrees(ex) -> list:
    """Each tracked side's degrees at its live refs (pk order), read to
    the host: the check's own read, after the run."""
    return [s.kernel.read_degrees(np.fromiter(
        s.pk_to_ref.values(), dtype=np.int64, count=len(s.pk_to_ref)))
        if s.track_degrees and s.pk_to_ref else None for s in ex.sides]


def _same_degrees(port_ex, ref_ex) -> int:
    """Asserts equal live degrees; returns how many sides had any."""
    n = 0
    for a, b in zip(_degrees(port_ex), _degrees(ref_ex)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
            n += int(a.any())
    return n


def _pair(sl, sr, nb, jt, stores=(None, None)):
    """The port's and the reference's one-device run of one script:
    records and both state tables equal. -> (port run, reference run)."""
    out = [run_join(pkg, sl, sr, nb, None, n_shards=None, store=st,
                    join_type=mod.JoinType(jt))
           for pkg, mod, st in (("port", port_hj, stores[0]),
                                ("ref", ref_hj, stores[1]))]
    assert out[0][0] == out[1][0]
    assert out[0][2] == out[1][2]
    return out


@pytest.fixture
def no_host_degrees(monkeypatch):
    """While armed, the port's paths must not fetch the degree array to
    the host (``read_degrees``) or collect a probe on the host for
    degrees (``probe``): compaction carries degrees on the card, and
    recovery and reload write K6's degree column as it lies."""
    armed = [True]
    for name in ("read_degrees", "probe"):
        real = getattr(PJ.JoinSideKernel, name)

        def guard(self, *a, _real=real, _name=name, **k):
            assert not armed[0], f"JoinSideKernel.{_name} on a device path"
            return _real(self, *a, **k)
        monkeypatch.setattr(PJ.JoinSideKernel, name, guard)
    return armed


def _churn(n_epochs=16, seed=3):
    """Both sides churn, so every barrier past the threshold compacts
    rows whose degrees are then read: a stable left row on each key 0-4
    (matched, unmatched and flipped again by the right side's inserts and
    deletes, each at a key's stable row), a left row moved to another key
    each epoch (a dead ref an epoch) and a NULL-key row; the right side
    inserts a row and deletes an older one most epochs."""
    rng = np.random.default_rng(seed)
    sl = [("b", 1), _lc([0, 1, 2, 3, 4, 0, None],
                        [100, 101, 102, 103, 104, 5, 6])]
    sr = [("b", 1), _rc([3, None], ["z", "n"])]
    live_r = [(3, "z")]
    b, k_cur = 2, 0
    for _ in range(n_epochs):
        sl.append(("b", b))
        sr.append(("b", b))
        b += 1
        k_new = int(rng.integers(0, 5))
        sl.append(_lc([k_cur, k_new, None], [5, 5, 1000 + b], [3, 4, 1]))
        k_cur = k_new
        ks, vs, ops = [int(rng.integers(0, 5))], [f"x{b}"], [1]
        if len(live_r) > 1 and rng.random() < 0.7:
            k, v = live_r.pop(int(rng.integers(len(live_r))))
            ks.append(k)
            vs.append(v)
            ops.append(2)
        live_r.append((ks[0], vs[0]))
        sr.append(_rc(ks, vs, ops))
    sl.append(("b", b))
    sr.append(("b", b))
    return sl, sr, b


@pytest.mark.parametrize("jt", TRACKED)
def test_forced_compaction_matches_reference(monkeypatch, no_host_degrees,
                                             jt):
    """Compaction at every barrier (monkeypatched thresholds, both
    packages) under each degree-tracked join type: records, both state
    tables and the live rows' degrees equal the reference's, the refs
    were compacted, and no degree left the card on the way."""
    for mod in (port_hj, ref_hj):
        monkeypatch.setattr(mod._JoinSide, "COMPACT_MIN_REFS", 4)
        monkeypatch.setattr(mod._JoinSide, "COMPACT_DEAD_RATIO", 0.05)
    compactions = []
    real = port_hj._JoinSide.compact
    monkeypatch.setattr(port_hj._JoinSide, "compact",
                        lambda self: compactions.append(1) or real(self))
    sl, sr, nb = _churn()
    port, ref = _pair(sl, sr, nb, jt)
    no_host_degrees[0] = False
    assert len(compactions) >= 4
    assert all(s.next_ref < sum(len(e[0][c]) for e in x if e[0] != "b")
               for s, x, c in zip(port[1].sides, (sl, sr), ("lk", "rk")))
    assert _same_degrees(port[1], ref[1]) > 0


def _renumbered(events, first: int):
    """A later executor's script: a first barrier ``first``, then the
    events with every barrier renumbered after it."""
    out, b = [("b", first)], first
    for e in events:
        if e[0] == "b":
            b += 1
            e = ("b", b)
        out.append(e)
    return out, b


@pytest.mark.parametrize("jt", TRACKED)
def test_recovery_writes_degrees_on_the_card_matches_reference(
        no_host_degrees, jt):
    """Kill and rebuild over the same store under each degree-tracked
    join type, NULL keys on both sides: recovery rebuilds through the
    epoch path and writes K6's degree column (0 for a NULL key) by ref.
    The resumed records and state equal the reference's, the view its
    oracle, and the degrees of a recovery with nothing after it the
    reference's."""
    sl, sr, nb, left, right = random_stream(41, null_p=0.25)
    cut = 5               # b1, chunk, b2, chunk, b3: then a new executor
    stores = (PKG["port"]["Store"](), PKG["ref"]["Store"]())
    p1, _r1 = _pair(sl[:cut], sr[:cut], 3, jt, stores)
    l2, last = _renumbered(sl[cut:], 4)
    r2, _last = _renumbered(sr[cut:], 4)
    p2, _r2 = _pair(l2, r2, last - 3, jt, stores)
    assert view(p1[0] + p2[0]) == oracle_view(jt, left, right)
    p3, r3 = _pair([("b", last + 1)], [("b", last + 1)], 1, jt, stores)
    no_host_degrees[0] = False
    assert _same_degrees(p3[1], r3[1]) > 0


@pytest.mark.parametrize("jt", ["left_outer", "right_outer", "full_outer"])
def test_cold_reload_writes_degrees_on_the_card_matches_reference(
        no_host_degrees, jt):
    """An outer join under a 32-key cold tier: keys evict (compaction
    carrying degrees on the card) and reload (K1 + K5 at seq 0, then the
    staged key lanes probe the other side and K6's degree column is
    written at the staged refs). Records, state tables, cold keys, tier
    counts and live degrees equal the reference's. (The cold tier is
    refused for semi and anti joins, as in the reference.)"""
    lm, rm, nb = cold._matched_then_evicted()
    port = cold.run("port", lm, rm, nb, cap=32, jt=jt)
    ref = cold.run("ref", lm, rm, nb, cap=32, jt=jt)
    no_host_degrees[0] = False
    assert port[0] == ref[0] and port[2] == ref[2]
    assert [s.cold_keys for s in port[1].sides] == \
        [s.cold_keys for s in ref[1].sides]
    counts = cold.tier_counts(port[1])
    assert counts == cold.tier_counts(ref[1])
    assert sum(e for e, _r in counts) > 0 and sum(r for _e, r in counts) > 0
    assert _same_degrees(port[1], ref[1]) > 0
