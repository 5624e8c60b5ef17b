"""Join matcher parity: the port's ``ops/hash_join.py`` (plain versions of
K5, K6, K7 and K4's head remap, on the CPU) against the JAX reference's
jitted functions, and the port's HashJoinExecutor against the
reference's on the reference tests' scripted streams.

Inputs are made from a seed with numpy and handed to both packages. On
the CPU the port's probe_insert keeps the reference's slot rule, so every
compared array is int32 and must match exactly: key tables, chains,
sequences, payload, degree arrays and packed probe matrices. Sizes are
small: key capacity 2^10, 2^8 stored rows.
"""

import asyncio
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common.chunk import StreamChunk as RefChunk
from risingwave_tpu.common.epoch import Epoch as RefEpoch
from risingwave_tpu.common.epoch import EpochPair as RefEpochPair
from risingwave_tpu.common.types import DataType as RefDT
from risingwave_tpu.common.types import Schema as RefSchema
from risingwave_tpu.ops import hash_join as RJ
from risingwave_tpu.ops import hash_table as R_ht
from risingwave_tpu.state.state_table import StateTable as RefTable
from risingwave_tpu.state.store import MemoryStateStore as RefStore
from risingwave_tpu.stream.executors import hash_join as RX
from risingwave_tpu.stream.executors.test_utils import (
    MockSource as RefMock, collect_until_n_barriers as ref_collect,
)
from risingwave_tpu.stream.message import Barrier as RefBarrier
from risingwave_tpu.stream.message import BarrierKind as RefKind
from risingwave_tpu_torch.common.chunk import Op, StreamChunk
from risingwave_tpu_torch.common.epoch import Epoch, EpochPair
from risingwave_tpu_torch.common.types import DataType, Schema
from risingwave_tpu_torch.ops import hash_join as PJ
from risingwave_tpu_torch.ops import hash_table as P_ht
from risingwave_tpu_torch.ops import kernel_cases as KC
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.state.store import MemoryStateStore
from risingwave_tpu_torch.stream.executors import hash_join as PX
from risingwave_tpu_torch.stream.executors.test_utils import (
    MockSource, collect_until_n_barriers,
)
from risingwave_tpu_torch.stream.message import (
    Barrier, BarrierKind, Watermark, is_chunk,
)

# Under pytest-xdist these tests share the host's cores with timing-bound
# tests on other workers (tests/test_chaos.py's 8 s barrier timeouts), so
# torch's intra-op pool stays small.
torch.set_num_threads(2)

CPU = torch.device("cpu")
CAP = 1 << 10
ROWS = 1 << 8
KW = 3            # one int64 key: (hi, lo, valid)
P = 6             # two payload columns: (hi, lo, valid) each


def _key_lanes(g: np.ndarray) -> np.ndarray:
    g = g.astype(np.int64)
    hi = (g >> 32).astype(np.int32)
    lo = (g & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return np.stack([hi, lo, np.ones(len(g), np.int32)], axis=1)


def _tables(keys: np.ndarray, valid: np.ndarray):
    """Both packages' key tables after one probe_insert of the same rows;
    returns (ref table, ref slots, port table, port slots)."""
    rt, rs, _ = R_ht._probe_insert_jit(R_ht.make_state(CAP, KW),
                                       jnp.asarray(keys), jnp.asarray(valid))
    pt, ps, _ = P_ht.probe_insert(P_ht.make_state(CAP, KW, CPU),
                                  torch.from_numpy(keys),
                                  torch.from_numpy(valid))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    return rt, rs, pt, ps


def _ref_chains(cap=CAP, rows=ROWS):
    full = lambda n, v: jnp.full(n, v, dtype=jnp.int32)  # noqa: E731
    return RJ.ChainState(full(cap, -1), full(rows, -1),
                         full(rows, RJ.I32_MAX), full(rows, RJ.I32_MAX))


def _same_chains(pc, rc):
    for a, b in zip(pc, rc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _same_table(pt, rt):
    np.testing.assert_array_equal(pt.keys.numpy(), np.asarray(rt.keys))
    np.testing.assert_array_equal(pt.occ.numpy() != 0, np.asarray(rt.occ))


# -- kernel functions ---------------------------------------------------------

@pytest.mark.parametrize("seq_kind", ["none", "scalar", "vector"])
def test_link_rows_keeps_batch_order_among_duplicate_keys(seq_kind):
    rng = np.random.default_rng(1)
    rc, pc = _ref_chains(), PJ.make_chains(CAP, ROWS, CPU)
    next_ref = 0
    for batch in range(3):
        n = 64
        keys = _key_lanes(rng.integers(0, 12, n))      # many duplicates
        valid = rng.random(n) < 0.9
        rt, rs, pt, ps = _tables(keys, valid)
        # link a subset of the probe-inserted rows
        vis = valid & (rng.random(n) < 0.85)
        refs = np.arange(next_ref, next_ref + n, dtype=np.int32)
        next_ref += n
        if seq_kind == "none":
            rseq, pseq = None, None
        elif seq_kind == "scalar":
            rseq, pseq = jnp.int32(batch + 5), batch + 5
        else:
            sv = rng.integers(1, 100, n).astype(np.int32)
            rseq, pseq = jnp.asarray(sv), torch.from_numpy(sv)
        rc = RJ._link_jit(rc, rs, jnp.asarray(refs), jnp.asarray(vis),
                          CAP, rseq)
        pc = PJ.link_rows(pc, ps, torch.from_numpy(refs),
                          torch.from_numpy(vis), CAP, pseq)
        _same_chains(pc, rc)


def test_tombstone_rows():
    rng = np.random.default_rng(2)
    rc, pc = _ref_chains(), PJ.make_chains(CAP, ROWS, CPU)
    for seq in (3, 9):
        refs = rng.integers(0, ROWS, 40).astype(np.int32)
        vis = rng.random(40) < 0.7
        rc = RJ._tombstone_jit(rc, jnp.asarray(refs), jnp.asarray(vis),
                               jnp.int32(seq))
        pc = PJ.tombstone_rows(pc, torch.from_numpy(refs),
                               torch.from_numpy(vis), seq)
        _same_chains(pc, rc)


def k5_reference(c: dict) -> list:
    """The reference's link_rows, tombstone_rows and _masked_scatter on
    one of ``KC.k5_case``'s launches, shard by shard: the chain arrays
    (and payload) they leave, stacked [S, ...], as numpy."""
    out = []
    for d in range(c["flags"].shape[0]):
        ch = RJ.ChainState(*(jnp.asarray(c[k][d]) for k in (
            "head", "next", "ins_seq", "del_seq")))
        f = c["flags"][d]
        seq = jnp.asarray(c["seq"][d]) if isinstance(c["seq"], np.ndarray) \
            else jnp.int32(c["seq"])
        ins = jnp.asarray((f & KC.FLAG_INS) != 0)
        if c["slots"] is not None:
            ch = RJ._link_jit(ch, jnp.asarray(c["slots"][d]),
                              jnp.asarray(c["ins_ref"][d]), ins, c["cap"],
                              seq)
        ch = RJ._tombstone_jit(ch, jnp.asarray(c["del_ref"][d]),
                               jnp.asarray((f & KC.FLAG_DEL) != 0), seq)
        arrs = [np.asarray(x) for x in ch]
        if c["pay"] is not None:
            arrs.append(np.asarray(RJ._masked_scatter_jit(
                jnp.asarray(c["pay"][d]), jnp.asarray(c["ins_ref"][d]), ins,
                jnp.asarray(c["pay_src"][d]))))
        out.append(arrs)
    return [np.stack(x) for x in zip(*out)]


@pytest.mark.parametrize("case", [c for c in KC.K5_CASES
                                  if c != "sharded_8"])
def test_join_apply_kernel_cases_match_reference(case):
    """K5's edge cases (``ops/kernel_cases.py``: one slot over many warps
    and blocks, q8's 400-row hot key, an insert and a delete of one ref,
    slot -1 rows, refs past row_cap, P = 0 and an odd P, link only,
    tombstone only, a batch past one wave of resident blocks) through the
    single-device wrappers on the CPU (link_rows, tombstone_rows, the
    payload scatter: the plain versions) equal the reference's, every
    array exactly."""
    c = KC.k5_case(case)
    chains, pay, parts = KC.k5_tensors(c, CPU)
    ch = PJ.ChainState(*(x[0] for x in chains))
    seq = parts["seq"][0] if isinstance(parts["seq"], torch.Tensor) \
        else parts["seq"]
    ins = (parts["ins_ok"][0] & KC.FLAG_INS) != 0
    if parts["slots"] is not None:
        ch = PJ.link_rows(ch, parts["slots"][0], parts["ins_ref"][0], ins,
                          c["cap"], seq)
    ch = PJ.tombstone_rows(ch, parts["del_ref"][0],
                           (parts["del_ok"][0] & KC.FLAG_DEL) != 0, seq)
    got = [x.numpy()[None] for x in ch]
    if pay is not None:
        got.append(PJ._masked_scatter(pay[0], parts["ins_ref"][0], ins,
                                      parts["pay_src"][0]).numpy()[None])
    want = k5_reference(c)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _epoch(rng, n, next_ref, live, key_range=20):
    """One side's epoch matrices: [key lanes | payload] and aux, with
    per-row seqs, inserts, deletes of live refs and negative rows."""
    keys = _key_lanes(rng.integers(0, key_range, n))
    pay = rng.integers(-2**31, 2**31, (n, P)).astype(np.int32)
    up = np.concatenate([keys, pay], axis=1)
    aux = np.zeros((n, 4), np.int32)
    ins = rng.random(n) < 0.6
    dels = ~ins & (rng.random(n) < 0.5)
    cand = list(live)
    rng.shuffle(cand)
    k = min(int(dels.sum()), len(cand))
    del_rows = np.flatnonzero(dels)[:k]
    dels[:] = False
    dels[del_rows] = True
    aux[del_rows, PJ.AUX_DEL_REF] = np.asarray(cand[:k], np.int32)
    ins_rows = np.flatnonzero(ins)
    aux[ins_rows, PJ.AUX_INS_REF] = np.arange(
        next_ref, next_ref + len(ins_rows), dtype=np.int32)
    probe = rng.random(n) < 0.9
    neg = dels | (rng.random(n) < 0.1)
    aux[:, PJ.AUX_FLAGS] = (probe * PJ.FLAG_PROBE + ins * PJ.FLAG_INS
                            + dels * PJ.FLAG_DEL + neg * PJ.FLAG_NEG)
    aux[:, PJ.AUX_SEQ] = np.sort(rng.integers(1, 1000, n)).astype(np.int32)
    new_live = (set(live) - set(cand[:k])) | set(
        aux[ins_rows, PJ.AUX_INS_REF].tolist())
    return up, aux, next_ref + len(ins_rows), new_live


def _apply_both(rng, epochs):
    """Apply the epochs in both packages; returns both sides' state."""
    rt, rc = R_ht.make_state(CAP, KW), _ref_chains()
    rpay = jnp.zeros((ROWS, P), jnp.int32)
    pt = P_ht.make_state(CAP, KW, CPU)
    pc, ppay = PJ.make_chains(CAP, ROWS, CPU), torch.zeros((ROWS, P),
                                                           dtype=torch.int32)
    next_ref, live = 0, set()
    for n in epochs:
        up, aux, next_ref, live = _epoch(rng, n, next_ref, live)
        rt, rc, rpay, r_ins = RJ._epoch_apply_jit(
            rt, rc, rpay, jnp.asarray(up), jnp.asarray(aux), KW)
        pt, pc, ppay, p_stats = PJ.epoch_apply(
            pt, pc, ppay, torch.from_numpy(up), torch.from_numpy(aux), KW)
        assert int(p_stats[0]) == int(r_ins) and int(p_stats[1]) == 0
        _same_table(pt, rt)
        _same_chains(pc, rc)
        np.testing.assert_array_equal(ppay.numpy(), np.asarray(rpay))
    return (rt, rc, rpay), (pt, pc, ppay), up, aux


def test_epoch_apply():
    _apply_both(np.random.default_rng(3), [64, 64, 32])


@pytest.mark.parametrize("with_degrees", [False, True])
@pytest.mark.parametrize("out_cap", [1 << 4, 1 << 9])
def test_epoch_probe(with_degrees, out_cap):
    """Both branches, and a pair buffer too small for the epoch (the
    header still carries the true total)."""
    rng = np.random.default_rng(4)
    (rt, rc, rpay), (pt, pc, ppay), _up, _aux = _apply_both(rng, [64, 64])
    up, aux, _n, _l = _epoch(rng, 48, ROWS - 64, set())
    deg_self = rng.integers(0, 5, ROWS).astype(np.int32)
    deg_sink = rng.integers(0, 5, ROWS).astype(np.int32)
    r = RJ._epoch_probe_jit(rt, rc, rpay, jnp.asarray(deg_self),
                            jnp.asarray(deg_sink), jnp.asarray(up),
                            jnp.asarray(aux), KW, out_cap, with_degrees)
    mat, ds, dk, stats = PJ.epoch_probe(
        pt, pc, ppay, torch.from_numpy(deg_self),
        torch.from_numpy(deg_sink), torch.from_numpy(up),
        torch.from_numpy(aux), KW, out_cap, with_degrees)
    assert int(stats[1]) == 0
    if with_degrees:
        r_mat, r_ds, r_dk = r
        np.testing.assert_array_equal(ds.numpy(), np.asarray(r_ds))
        np.testing.assert_array_equal(dk.numpy(), np.asarray(r_dk))
    else:
        r_mat = r
        assert ds is None and dk is None
    np.testing.assert_array_equal(mat.numpy(), np.asarray(r_mat))
    total = int(mat[0, 0])
    assert total > 0
    if out_cap < 64:
        assert total > out_cap


@pytest.mark.parametrize("case", KC.K6_CASES)
def test_epoch_probe_kernel_cases(case):
    """epoch_probe on K6's edge cases (``ops/kernel_cases.py``): chains of
    0, 1 and 60 refs, refs invisible at the row's seq on either side, a
    pair buffer the pairs fill exactly or overflow by one, rows that fill
    no tile, no rows, the degree branch, absent keys whose probe wraps.
    Matrix and degree arrays bit for bit."""
    c = KC.k6_cases()[case]
    cap, rows = c["cap"], c["rows"]
    rt, rc = R_ht.make_state(cap, KW), _ref_chains(cap, rows)
    rpay = jnp.zeros((rows, P), jnp.int32)
    pt, pc = P_ht.make_state(cap, KW, CPU), PJ.make_chains(cap, rows, CPU)
    ppay = torch.zeros((rows, P), dtype=torch.int32)
    for up, aux in c["stored"]:
        rt, rc, rpay, _r = RJ._epoch_apply_jit(
            rt, rc, rpay, jnp.asarray(up), jnp.asarray(aux), KW)
        pt, pc, ppay, _p = PJ.epoch_apply(
            pt, pc, ppay, torch.from_numpy(up), torch.from_numpy(aux), KW)
    _same_table(pt, rt)
    _same_chains(pc, rc)
    up, aux = c["probe"]
    rng = np.random.default_rng(10)
    ds = rng.integers(0, 5, rows).astype(np.int32)
    dk = rng.integers(0, 5, rows).astype(np.int32)
    args = (torch.from_numpy(ds), torch.from_numpy(dk),
            torch.from_numpy(up), torch.from_numpy(aux), KW)
    total = int(PJ.epoch_probe(pt, pc, ppay, *args, 1 << 14, False)[0][0, 0])
    out_cap = KC.resolve_out_cap(c["out_cap"], total)
    wd = c["with_degrees"]
    r = RJ._epoch_probe_jit(rt, rc, rpay, jnp.asarray(ds), jnp.asarray(dk),
                            jnp.asarray(up), jnp.asarray(aux), KW, out_cap,
                            wd)
    mat, pds, pdk, stats = PJ.epoch_probe(pt, pc, ppay, *args, out_cap, wd)
    assert int(stats[1]) == 0
    r_mat = r[0] if wd else r
    np.testing.assert_array_equal(mat.numpy(), np.asarray(r_mat))
    if wd:
        np.testing.assert_array_equal(pds.numpy(), np.asarray(r[1]))
        np.testing.assert_array_equal(pdk.numpy(), np.asarray(r[2]))
    assert int(mat[0, 0]) == total
    if case in ("exact_fit", "one_over"):
        assert total > 0 and total - out_cap == int(case == "one_over")


@pytest.mark.parametrize("with_degrees", [False, True])
def test_probe_pairs(with_degrees):
    rng = np.random.default_rng(5)
    (rt, rc, _rp), (pt, pc, _pp), _up, _aux = _apply_both(rng, [64, 64])
    keys = _key_lanes(rng.integers(0, 24, 40))
    vis = rng.random(40) < 0.9
    for seq, out_cap in ((RJ.I32_MAX, 1 << 9), (500, 1 << 3)):
        r = RJ._probe_pairs_jit(rt, rc, jnp.asarray(keys), jnp.asarray(vis),
                                jnp.int32(seq), out_cap, with_degrees)
        p, stats = PJ.probe_pairs(pt, pc, torch.from_numpy(keys),
                                  torch.from_numpy(vis), seq, out_cap,
                                  with_degrees)
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
        assert int(stats[1]) == 0


def test_lookup():
    rng = np.random.default_rng(6)
    keys = _key_lanes(rng.integers(0, 300, 200))
    rt, _rs, pt, _ps = _tables(keys, np.ones(200, bool))
    q = _key_lanes(rng.integers(0, 600, 128))
    valid = rng.random(128) < 0.9
    r = R_ht._lookup_jit(rt, jnp.asarray(q), jnp.asarray(valid))
    p, stats = P_ht.lookup(pt, torch.from_numpy(q), torch.from_numpy(valid))
    np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    assert int(stats[1]) == 0 and (p.numpy() >= 0).any()


@pytest.mark.parametrize("width", [0, P])
def test_masked_scatter(width):
    rng = np.random.default_rng(7)
    shape = (ROWS,) if width == 0 else (ROWS, width)
    arr = rng.integers(-9, 9, shape).astype(np.int32)
    refs = rng.permutation(ROWS)[:100].astype(np.int32)
    refs[:5] = ROWS + np.arange(5)          # out of range: dropped
    vis = rng.random(100) < 0.8
    vals = rng.integers(-2**31, 2**31, (100,) + shape[1:]).astype(np.int32)
    r = RJ._masked_scatter_jit(jnp.asarray(arr), jnp.asarray(refs),
                               jnp.asarray(vis), jnp.asarray(vals))
    p = PJ._masked_scatter(torch.from_numpy(arr.copy()),
                           torch.from_numpy(refs), torch.from_numpy(vis),
                           torch.from_numpy(vals))
    np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def test_remap_head_on_growth():
    """Growth through the port's DeviceHashTable: the head remap hook
    gives the reference's _remap_head of the same old→new slots."""
    rng = np.random.default_rng(8)
    keys = _key_lanes(rng.integers(0, 10**6, 600))
    rt, _rs, pt, _ps = _tables(keys, np.ones(600, bool))
    head = rng.integers(-1, ROWS, CAP).astype(np.int32)
    new = P_ht.make_state(2 * CAP, KW, CPU)
    new, o2n, _st = P_ht.probe_insert(new, pt.keys, pt.occ)
    r = RJ._remap_head_jit(jnp.asarray(head), jnp.asarray(o2n.numpy()),
                           2 * CAP)
    p = PJ._remap_head(torch.from_numpy(head), o2n, 2 * CAP, new.occ)
    np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def test_rebase():
    rng = np.random.default_rng(9)

    def arr():
        a = rng.integers(0, 1 << 30, ROWS).astype(np.int32)
        a[rng.random(ROWS) < 0.3] = RJ.I32_MAX
        return a
    head, nxt, ins, dele = (rng.integers(-1, ROWS, CAP).astype(np.int32),
                            rng.integers(-1, ROWS, ROWS).astype(np.int32),
                            arr(), arr())
    r = RJ._rebase_jit(RJ.ChainState(*map(jnp.asarray,
                                          (head, nxt, ins, dele))))
    p = PJ._rebase(PJ.ChainState(*map(torch.from_numpy,
                                      (head, nxt, ins, dele))))
    _same_chains(p, r)


def test_join_side_kernel_overflow_redispatch():
    """A pair buffer of 1: collect re-dispatches with a doubled buffer
    until the header's total fits, and the kernel remembers the size."""
    rng = np.random.default_rng(10)
    ref = RJ.JoinSideKernel(KW, key_capacity=CAP, row_capacity=ROWS,
                            probe_capacity=1, payload_width=P)
    port = PJ.JoinSideKernel(KW, key_capacity=CAP, row_capacity=ROWS,
                             probe_capacity=1, payload_width=P, device="cpu")
    up, aux, _n, _l = _epoch(rng, 64, 0, set(), key_range=6)
    for k in (ref, port):
        k.apply_epoch(k.stage_epoch(up, aux, 64, 63)[0],
                      k.stage_epoch(up, aux, 64, 63)[1], 64, 63)
    up2, aux2, _n, _l = _epoch(rng, 32, 64, set(), key_range=6)
    r = ref.probe_epoch(*ref.stage_epoch(up2, aux2, 32, 95)[:2],
                        False).collect()
    p = port.probe_epoch(*port.stage_epoch(up2, aux2, 32, 95),
                         False).collect()
    assert port._probe_cap == ref._probe_cap > 1
    assert len(p[1]) > 1
    for a, b in zip(p, r):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


def test_join_side_kernel_insert_delete_rebuild_degrees_rebase():
    """JoinSideKernel's host API against the reference's, state compared
    after every call: insert (growing the rows 4x), delete, write/read
    degrees, rebase_seq, and rebuild with payload."""
    rng = np.random.default_rng(11)
    ref = RJ.JoinSideKernel(KW, key_capacity=CAP, row_capacity=64,
                            payload_width=P)
    port = PJ.JoinSideKernel(KW, key_capacity=CAP, row_capacity=64,
                             payload_width=P, device="cpu")

    def same():
        _same_table(port.table.state, ref.table.state)
        _same_chains(port.chains, ref.chains)
        np.testing.assert_array_equal(port.pay.numpy(), np.asarray(ref.pay))
        np.testing.assert_array_equal(port.deg.numpy(), np.asarray(ref.deg))

    for seq in (1, 2):
        keys = _key_lanes(rng.integers(0, 30, 96))
        vis = rng.random(96) < 0.9
        refs = np.arange((seq - 1) * 96, seq * 96, dtype=np.int32)
        ref.insert(jnp.asarray(keys), refs, jnp.asarray(vis), seq=seq)
        port.insert(torch.from_numpy(keys), refs, torch.from_numpy(vis),
                    seq=seq)
        same()
    kill = rng.choice(192, 40, replace=False).astype(np.int32)
    kvis = rng.random(40) < 0.8
    ref.delete(kill, jnp.asarray(kvis), seq=3)
    port.delete(kill, kvis, seq=3)
    same()
    drefs = rng.choice(192, 50, replace=False).astype(np.int32)
    dvals = rng.integers(0, 9, 50).astype(np.int32)
    ref.write_degrees(drefs, dvals)
    # the port's write takes device tensors (a staged column, K6's
    # degree column); on the CPU they are CPU tensors
    port.write_degrees(torch.from_numpy(drefs), torch.from_numpy(dvals))
    same()
    np.testing.assert_array_equal(port.read_degrees(drefs),
                                  ref.read_degrees(drefs))
    ref.rebase_seq()
    port.rebase_seq()
    same()
    keys = _key_lanes(rng.integers(0, 500, 300))
    refs = rng.permutation(300).astype(np.int32)
    pay = rng.integers(-2**31, 2**31, (300, P)).astype(np.int32)
    ref.rebuild(keys, refs, pay)
    port.rebuild(keys, refs, pay)
    same()
    assert port.row_capacity == ref.row_capacity >= 300


# -- executor, against the reference on its own test scripts --------------

L_COLS = dict(lk=DataType.INT64, lv=DataType.INT64)
R_COLS = dict(rk=DataType.INT64, rv=DataType.VARCHAR)
REF_L = RefSchema.of(lk=RefDT.INT64, lv=RefDT.INT64)
REF_R = RefSchema.of(rk=RefDT.INT64, rv=RefDT.VARCHAR)


def _barrier(n, port=True):
    E, EP, B, K = (Epoch, EpochPair, Barrier, BarrierKind) if port else \
        (RefEpoch, RefEpochPair, RefBarrier, RefKind)
    prev = E.from_physical(n - 1) if n > 1 else E.INVALID
    return B(EP(E.from_physical(n), prev), K.CHECKPOINT)


def _script(events, side, port):
    """('b', n) | (keys, vals, ops) → the package's messages."""
    schema = (Schema.of(**L_COLS) if side == 0 else Schema.of(**R_COLS)) \
        if port else (REF_L if side == 0 else REF_R)
    chunk_t = StreamChunk if port else RefChunk
    names = ("lk", "lv") if side == 0 else ("rk", "rv")
    out = []
    for e in events:
        if e[0] == "b":
            out.append(_barrier(e[1], port))
        else:
            ks, vs, ops = e
            out.append(chunk_t.from_pydict(schema, {names[0]: ks,
                                                    names[1]: vs}, ops=ops))
    return schema, out


def _run(script_l, script_r, n_barriers, port, compact_min=None,
         monkeypatch=None):
    if compact_min is not None:
        monkeypatch.setattr(PX._JoinSide if port else RX._JoinSide,
                            "COMPACT_MIN_REFS", compact_min)
    store = MemoryStateStore() if port else RefStore()
    table = StateTable if port else RefTable
    mock = MockSource if port else RefMock
    ls, lmsgs = _script(script_l, 0, port)
    rs, rmsgs = _script(script_r, 1, port)
    lt = table(21, ls, [1], store, dist_key_indices=[])
    rt = table(22, rs, [1], store, dist_key_indices=[])
    kw = {"device": "cpu"} if port else {}
    ex = (PX if port else RX).HashJoinExecutor(
        mock(ls, lmsgs), mock(rs, rmsgs), left_keys=[0], right_keys=[0],
        left_table=lt, right_table=rt, **kw)
    collect = collect_until_n_barriers if port else ref_collect
    msgs = asyncio.run(collect(ex, n_barriers))
    records = [[(int(op), row) for op, row in m.to_records()]
               for m in msgs if is_chunk(m) or isinstance(m, RefChunk)]
    return records, ex, (list(lt.iter_rows()), list(rt.iter_rows()))


def _view(records) -> Counter:
    view = Counter()
    for chunk in records:
        for op, row in chunk:
            view[row] += 1 if op in (int(Op.INSERT),
                                     int(Op.UPDATE_INSERT)) else -1
    return +view


def _same_run(script_l, script_r, n, **kw):
    p_rec, p_ex, p_state = _run(script_l, script_r, n, True, **kw)
    r_rec, r_ex, r_state = _run(script_l, script_r, n, False, **kw)
    assert p_rec == r_rec
    assert p_state == r_state
    return p_rec, p_ex, r_ex


def _random_scripts(seed, n_barriers=8):
    rng = np.random.default_rng(seed)
    sl, sr = [("b", 1)], [("b", 1)]
    live = {0: [], 1: []}
    for b in range(2, n_barriers + 1):
        for side, script in ((0, sl), (1, sr)):
            for _ in range(rng.integers(0, 3)):
                ks, vs, ops = [], [], []
                for _r in range(rng.integers(1, 6)):
                    if live[side] and rng.random() < 0.3:
                        k, v = live[side].pop(rng.integers(len(live[side])))
                        ks.append(k)
                        vs.append(v)
                        ops.append(Op.DELETE)
                    else:
                        k = int(rng.integers(0, 5))
                        if rng.random() < 0.1:
                            k = None
                        v = int(rng.integers(0, 10**6)) if side == 0 \
                            else f"s{int(rng.integers(0, 10**6))}"
                        ks.append(k)
                        vs.append(v)
                        ops.append(Op.INSERT)
                        if k is not None:
                            live[side].append((k, v))
                script.append((ks, vs, ops))
        sl.append(("b", b))
        sr.append(("b", b))
    return sl, sr, n_barriers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_executor_random_stream_matches_reference(seed):
    sl, sr, n = _random_scripts(seed)
    rec, _p, _r = _same_run(sl, sr, n)
    assert sum(len(c) for c in rec) > 0


def test_executor_update_pair_same_pk_one_chunk():
    sl = [("b", 1), ([1], [10], [Op.INSERT]), ("b", 2),
          ([1, 2], [10, 10], [Op.UPDATE_DELETE, Op.UPDATE_INSERT]),
          ("b", 3)]
    sr = [("b", 1), ([1, 2], ["a", "b"], [Op.INSERT, Op.INSERT]), ("b", 2),
          ("b", 3)]
    rec, _p, _r = _same_run(sl, sr, 3)
    assert _view(rec) == Counter({(2, 10, 2, "b"): 1})


def test_executor_compaction_matches_reference(monkeypatch):
    """Update churn leaves dead refs; the barrier-time compaction (a
    rebuild: probe_insert + link + payload scatter) keeps the results."""
    sl, sr = [("b", 1), ([0], [5], [Op.INSERT])], [("b", 1),
                                                   ([3], ["z"], [Op.INSERT])]
    b, k_cur = 2, 0
    for _ in range(20):
        sl.append(("b", b))
        sr.append(("b", b))
        b += 1
        k_new = (k_cur + 1) % 4
        sl.append(([k_cur, k_new], [5, 5],
                   [Op.UPDATE_DELETE, Op.UPDATE_INSERT]))
        k_cur = k_new
    sl.append(("b", b))
    sr.append(("b", b))
    rec, p_ex, r_ex = _same_run(sl, sr, b, compact_min=8,
                                monkeypatch=monkeypatch)
    left = p_ex.sides[0]
    assert left.next_ref < 21 and left.next_ref == r_ex.sides[0].next_ref
    assert _view(rec) == (Counter({(k_cur, 5, 3, "z"): 1}) if k_cur == 3
                          else Counter())


def test_executor_recovery_resumes():
    for port in (True, False):
        store = MemoryStateStore() if port else RefStore()
        table = StateTable if port else RefTable
        mock = MockSource if port else RefMock
        collect = collect_until_n_barriers if port else ref_collect
        mod = PX if port else RX
        kw = {"device": "cpu"} if port else {}

        def build(sl, sr):
            ls, lm = _script(sl, 0, port)
            rs, rm = _script(sr, 1, port)
            return mod.HashJoinExecutor(
                mock(ls, lm), mock(rs, rm), left_keys=[0], right_keys=[0],
                left_table=table(21, ls, [1], store, dist_key_indices=[]),
                right_table=table(22, rs, [1], store, dist_key_indices=[]),
                **kw)
        asyncio.run(collect(build(
            [("b", 1), ([1], [10], [Op.INSERT]), ("b", 2)],
            [("b", 1), ([1], ["a"], [Op.INSERT]), ("b", 2)]), 2))
        msgs = asyncio.run(collect(build(
            [("b", 3), ("b", 4)],
            [("b", 3), ([1], ["b"], [Op.INSERT]), ("b", 4)]), 2))
        rec = [[(int(op), row) for op, row in m.to_records()]
               for m in msgs if hasattr(m, "to_records")]
        assert _view(rec) == Counter({(1, 10, 1, "b"): 1})


def test_executor_refuses_unported_options():
    """Every join type and the cold tier now build; the reference's own
    ValueErrors for ``state_cap`` stand (a semi or anti join, state-table
    pks the join keys do not prefix), as do the port's argument checks."""
    ls, rs = Schema.of(**L_COLS), Schema.of(**R_COLS)
    store = MemoryStateStore()

    def build(lpk=(0, 1), **kw):
        return PX.HashJoinExecutor(
            MockSource(ls, []), MockSource(rs, []), [0], [0],
            StateTable(21, ls, list(lpk), store),
            StateTable(22, rs, [0, 1], store), device="cpu", **kw)
    for jt in PX.JoinType:
        ex = build(join_type=jt)
        assert ex.join_type is jt
        assert len(ex.schema) == (2 if jt.is_semi_or_anti else 4)
        if not jt.is_semi_or_anti:
            assert [s.state_cap for s in build(join_type=jt,
                                               state_cap=8).sides] == [8, 8]
    for jt in (PX.JoinType.LEFT_SEMI, PX.JoinType.RIGHT_ANTI):
        with pytest.raises(ValueError, match="semi"):
            build(join_type=jt, state_cap=8)
    with pytest.raises(ValueError, match="prefixed"):
        build(lpk=(1,), state_cap=8)
    with pytest.raises(TypeError):          # a mesh is a ShardMesh
        build(mesh=object())
    with pytest.raises(ValueError):         # the per-chunk arm needs a mesh
        build(epoch_batch=False)
    build(device_payload=False)


def test_executor_key_watermark_raises_other_watermark_dropped():
    """A join-key watermark on both sides forwards their min on BOTH
    output key columns (left 0, right 2), as the reference's does; a
    watermark on a non-key column is still dropped."""
    ls, rs = Schema.of(**L_COLS), Schema.of(**R_COLS)

    def run(col, both_sides):
        store = MemoryStateStore()
        wm = Watermark(col, DataType.INT64, 5)
        rwm = [Watermark(col, DataType.INT64, 7)] if both_sides else []
        ex = PX.HashJoinExecutor(
            MockSource(ls, [_barrier(1), wm, _barrier(2)]),
            MockSource(rs, [_barrier(1), *rwm, _barrier(2)]), [0], [0],
            StateTable(21, ls, [1], store), StateTable(22, rs, [1], store),
            device="cpu")
        return [(m.col_idx, m.value) for m in
                asyncio.run(collect_until_n_barriers(ex, 2))
                if isinstance(m, Watermark)]
    assert run(1, True) == []
    assert run(0, False) == []              # the other side has none yet
    assert run(0, True) == [(0, 5), (2, 5)]


def test_deviation_negative_ref_dropped_where_reference_wraps(monkeypatch):
    """Declared deviation (ROADMAP.md queue C): a negative row ref. The
    reference's ``link_rows``, ``tombstone_rows`` and ``_masked_scatter``
    scatter with ``.at[ref].set(mode="drop")``, and JAX wraps a negative
    index first, so a ref of -1 writes element row_cap - 1. The port's
    plain versions (and K5 and K7, held to them on the card) drop it and
    write nothing. No path reaches it: the executor's refs count up from
    0 (``alloc_refs``), and a delete names a ref it allocated."""
    keys = _key_lanes(np.asarray([3, 4]))
    valid = np.ones(2, bool)
    _rt, rs, _pt, ps = _tables(keys, valid)
    last = ROWS - 1
    # key 3 already heads a chain at ref 9; then a batch links ref -1 to
    # it and ref 5 to key 4
    first = np.asarray([9, 8], np.int32)
    rc = RJ._link_jit(_ref_chains(), rs, jnp.asarray(first),
                      jnp.asarray(valid), CAP, jnp.int32(2))
    pc = PJ.link_rows(PJ.make_chains(CAP, ROWS, CPU), ps,
                      torch.from_numpy(first), torch.from_numpy(valid), CAP,
                      2)
    _same_chains(pc, rc)
    refs = np.asarray([-1, 5], np.int32)
    rc = RJ._link_jit(rc, rs, jnp.asarray(refs), jnp.asarray(valid), CAP,
                      jnp.int32(7))
    pc = PJ.link_rows(pc, ps, torch.from_numpy(refs),
                      torch.from_numpy(valid), CAP, 7)
    assert int(rc.next[last]) == 9 and int(rc.ins_seq[last]) == 7
    assert int(pc.next[last]) == -1 and int(pc.ins_seq[last]) == PJ.I32_MAX
    rc = RJ._tombstone_jit(rc, jnp.asarray(refs), jnp.asarray(valid),
                           jnp.int32(11))
    pc = PJ.tombstone_rows(pc, torch.from_numpy(refs),
                           torch.from_numpy(valid), 11)
    assert int(rc.del_seq[last]) == 11
    assert int(pc.del_seq[last]) == PJ.I32_MAX
    # every other element is the reference's
    for a, b in zip(pc, rc):
        a, b = a.numpy().copy(), np.asarray(b).copy()
        if a.shape[0] == ROWS:
            a[last] = b[last] = 0
        np.testing.assert_array_equal(a, b)
    arr = np.arange(ROWS * 2, dtype=np.int32).reshape(ROWS, 2)
    vals = np.asarray([[70, 71], [50, 51]], np.int32)
    r = np.asarray(RJ._masked_scatter_jit(jnp.asarray(arr),
                                          jnp.asarray(refs),
                                          jnp.asarray(valid),
                                          jnp.asarray(vals)))
    p = PJ._masked_scatter(torch.from_numpy(arr.copy()),
                           torch.from_numpy(refs), torch.from_numpy(valid),
                           torch.from_numpy(vals)).numpy()
    assert r[last].tolist() == [70, 71] and p[last].tolist() == arr[
        last].tolist()
    assert r[5].tolist() == p[5].tolist() == [50, 51]
    # the port never makes such a ref: every visible ref its executor
    # hands the three scatters, through inserts, deletes, updates and a
    # compaction, is >= 0
    seen = []

    def spy(fn, ref_pos, vis_pos):
        def wrapped(*a, **kw):
            refs_, vis_ = a[ref_pos], a[vis_pos]
            seen.append(refs_.to(torch.int64)[vis_.to(torch.bool)].clone())
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(PJ, "link_rows_plain",
                        spy(PJ.link_rows_plain, 2, 3))
    monkeypatch.setattr(PJ, "tombstone_rows_plain",
                        spy(PJ.tombstone_rows_plain, 1, 2))
    monkeypatch.setattr(PJ, "_masked_scatter_plain",
                        spy(PJ._masked_scatter_plain, 1, 2))
    sl, sr, n = _random_scripts(5)
    _run(sl, sr, n, True)
    sl = [("b", 1), ([0], [5], [Op.INSERT])]
    sr = [("b", 1), ([3], ["z"], [Op.INSERT])]
    k_cur = 0
    for b in range(2, 14):
        sl.append(("b", b))
        sr.append(("b", b))
        sl.append(([k_cur, (k_cur + 1) % 4], [5, 5],
                   [Op.UPDATE_DELETE, Op.UPDATE_INSERT]))
        k_cur = (k_cur + 1) % 4
    sl.append(("b", 14))
    sr.append(("b", 14))
    _run(sl, sr, 14, True, compact_min=8, monkeypatch=monkeypatch)
    allrefs = torch.cat(seen)
    assert allrefs.numel() > 20 and int(allrefs.min()) >= 0
