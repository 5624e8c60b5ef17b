"""The vnode-sharded join matcher of the PyTorch port against the JAX
reference's, on the CPU (every kernel's plain version).

- the sharded K5 plain version (``join_apply_sharded_plain``) against the
  reference's jitted ``link_rows`` + ``tombstone_rows`` shard by shard,
  and the sharded K6 plain version (``join_probe_sharded_plain``, behind
  the port's routed probe steps) against the reference's jitted SPMD
  probe steps (``parallel/join.py:450``, :717), packed per-shard matrices
  bit for bit, a forced pair-buffer overflow included;
- ``apply_and_probe_plain`` (B16) against the reference's jitted
  ``apply_and_probe``, and ``JoinSideKernel``'s per-chunk API
  (apply_and_probe, probe_submit, probe) with an overflow re-dispatch;
- ``ShardedJoinKernel`` against the reference's over 8 and 4 shards,
  shard by shard (key table keys and occupancy, head, next, ins_seq,
  del_seq) and every probe output, through insert, apply_and_probe,
  probe, delete, the epoch apply and probe with the skew-exact bucket,
  key and row growth, the sequence rebase and a rebuild;
- the reference's ``tests/test_multichip_join.py`` (three tests) and
  ``tests/test_multichip_join_exec.py:162`` (probe overflow retries);
- a forced route overflow raising at collect, not at dispatch.

On the CPU the port's probe_insert keeps the reference's slot rule, so
every compared array is int32 and must match exactly. Inputs are made
from seeds with numpy and handed to both packages.
"""

from collections import defaultdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from risingwave_tpu.ops import hash_join as RJ
from risingwave_tpu.ops import hash_table as R_ht
from risingwave_tpu.parallel.join import ShardedJoinKernel as RefKernel
from risingwave_tpu_torch.ops import hash_join as PJ
from risingwave_tpu_torch.ops import hash_table as P_ht
from risingwave_tpu_torch.ops import kernel_cases as KC
from risingwave_tpu_torch.ops import lanes
from risingwave_tpu_torch.parallel import ShardedJoinKernel, ShardMesh

torch.set_num_threads(2)

CPU = torch.device("cpu")
KW = 3                         # one int64 key: (hi, lo, valid)


def _lanes(g) -> np.ndarray:
    hi, lo = lanes.split_i64(np.asarray(g).astype(np.int64))
    return np.stack([hi, lo, np.ones(len(hi), np.int32)], axis=1)


def _mesh(devs, n):
    return Mesh(np.asarray(devs[:n]), ("d",))


def _pair(devs, n, **caps):
    return (RefKernel(_mesh(devs, n), key_width=KW, **caps),
            ShardedJoinKernel(ShardMesh(n, "cpu"), KW, **caps))


def _same_state(p: ShardedJoinKernel, r: RefKernel) -> None:
    assert p.key_capacity == r.key_capacity
    assert p.row_capacity == r.row_capacity
    np.testing.assert_array_equal(p.table.keys.numpy(),
                                  np.asarray(r.table.keys))
    np.testing.assert_array_equal(p.table.occ.numpy() != 0,
                                  np.asarray(r.table.occ))
    for a, b in zip(p.chains, r.chains):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _same_out(p, r) -> None:
    assert len(p) == len(r)
    for a, b in zip(p, r):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- the sharded kernels' plain versions --------------------------------------

@pytest.mark.parametrize("n_shards", [8, 4])
@pytest.mark.parametrize("seq_kind", ["scalar", "vector"])
def test_join_apply_sharded_plain_matches_reference(n_shards, seq_kind):
    """Receive blocks as route leaves them (zero rows between the valid
    ones, whose ref 0 is a real ref), duplicate keys, inserts, deletes of
    stored refs: the port's one sharded call against the reference's
    link_rows + tombstone_rows on each shard."""
    rng = np.random.default_rng(n_shards)
    s, n, cap, rows = n_shards, 96, 256, 1024
    r_tables = [R_ht.make_state(cap, KW) for _ in range(s)]
    r_chains = [RJ.ChainState(jnp.full(cap, -1, jnp.int32),
                              jnp.full(rows, -1, jnp.int32),
                              jnp.full(rows, RJ.I32_MAX, jnp.int32),
                              jnp.full(rows, RJ.I32_MAX, jnp.int32))
                for _ in range(s)]
    p_table = P_ht.TableState(torch.zeros((s, cap, KW), dtype=torch.int32),
                              torch.zeros((s, cap), dtype=torch.int32))
    p_chains = PJ.ChainState(*(torch.from_numpy(np.stack(
        [np.asarray(c[i]) for c in r_chains])) for i in range(4)))
    next_ref, live = 0, []
    for rnd in range(3):
        valid = rng.random((s, n)) < 0.6            # the rest: zero rows
        keys = _lanes(rng.integers(0, 40, s * n)).reshape(s, n, KW)
        ins = valid & (rng.random((s, n)) < 0.7)
        dels = valid & ~ins & (rng.random((s, n)) < 0.6)
        ins_ref = np.zeros((s, n), np.int32)
        ins_ref[ins] = np.arange(next_ref, next_ref + int(ins.sum()))
        next_ref += int(ins.sum())
        del_ref = np.zeros((s, n), np.int32)
        k = min(int(dels.sum()), len(live))
        rng.shuffle(live)
        dpos = np.argwhere(dels)[:k]
        dels[:] = False
        dels[tuple(dpos.T)] = True
        flags = (ins * PJ.FLAG_INS + dels * PJ.FLAG_DEL).astype(np.int32)
        del_ref[tuple(dpos.T)] = live[:k]
        live = live[k:] + ins_ref[ins].tolist()
        keys[~valid] = 0
        seq = rng.integers(1, 100, (s, n)).astype(np.int32) \
            if seq_kind == "vector" else 7 + rnd
        p_slots, _st = P_ht.probe_insert_sharded_plain(
            p_table, torch.from_numpy(keys), torch.from_numpy(ins))
        for d in range(s):
            sq = jnp.asarray(seq[d]) if seq_kind == "vector" \
                else jnp.int32(seq)
            r_tables[d], slots, _ins = R_ht._probe_insert_jit(
                r_tables[d], jnp.asarray(keys[d]), jnp.asarray(ins[d]))
            np.testing.assert_array_equal(p_slots[d].numpy(),
                                          np.asarray(slots))
            c = RJ._link_jit(r_chains[d], slots, jnp.asarray(ins_ref[d]),
                             jnp.asarray(ins[d]), cap, sq)
            r_chains[d] = RJ._tombstone_jit(c, jnp.asarray(del_ref[d]),
                                            jnp.asarray(dels[d]), sq)
        f = torch.from_numpy(flags)
        PJ.join_apply_sharded_plain(
            p_chains, p_slots, ins_ok=f, ins_bits=PJ.FLAG_INS,
            ins_ref=torch.from_numpy(ins_ref), del_ok=f,
            del_bits=PJ.FLAG_DEL, del_ref=torch.from_numpy(del_ref),
            seq=torch.from_numpy(seq) if seq_kind == "vector" else seq)
        for i in range(4):
            np.testing.assert_array_equal(
                p_chains[i].numpy(),
                np.stack([np.asarray(c[i]) for c in r_chains]))


def _filled(devs, n_shards, seed, n_keys=60, rows=600, **caps):
    """Both kernels after the same routed inserts and some deletes."""
    rng = np.random.default_rng(seed)
    r, p = _pair(devs, n_shards, **caps)
    g = rng.integers(0, n_keys, rows)
    kl = _lanes(g)
    refs = np.arange(rows, dtype=np.int32)
    vis = rng.random(rows) < 0.9
    for k in (r, p):
        k.insert(kl[:rows // 2], refs[:rows // 2], vis[:rows // 2], seq=1)
        k.insert(kl[rows // 2:], refs[rows // 2:], vis[rows // 2:], seq=2)
    dm = vis & (rng.random(rows) < 0.2)
    for k in (r, p):
        k.delete(refs, dm, seq=3, key_lanes=kl)
    _same_state(p, r)
    return r, p, rng


@pytest.mark.parametrize("n_shards", [8, 4])
def test_join_probe_sharded_plain_matches_reference_steps(eight_devices,
                                                          n_shards):
    """The routed probe-only step (route + sharded K6) and the epoch
    probe step, with and without degree rows, at sequences between the
    inserts and deletes: every shard's packed matrix bit for bit,
    including a pair buffer too small (each header keeps its TRUE
    total)."""
    r, p, rng = _filled(eight_devices, n_shards, 3, key_capacity=256,
                        row_capacity=1024, probe_capacity=1 << 10)
    m = 16 * n_shards
    q = _lanes(rng.integers(0, 80, m))
    vis = rng.random(m) < 0.85
    for seq, out_cap in ((2, 1 << 10), (RJ.I32_MAX, 1 << 10), (3, 4)):
        step = r._build_probe_only(m // n_shards, out_cap)
        want, _ovf = step(r.table, r.chains, jnp.asarray(q),
                          jnp.arange(m, dtype=jnp.int32), jnp.asarray(vis),
                          jnp.int32(seq), r.owner_map)
        got, _povf = p._dispatch_probe(q, vis, seq, out_cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if out_cap == 4:
            assert int(got[:, 0, 0].max()) > out_cap
    # the epoch probe: per-row sequences, the probe flag, a skew bucket
    aux = np.zeros((m, 4), np.int32)
    aux[:, PJ.AUX_FLAGS] = vis * PJ.FLAG_PROBE
    aux[:, PJ.AUX_SEQ] = rng.integers(1, 5, m)
    owners = p.owners_of(q)
    for with_degrees in (False, True):
        ru, ra, rb = r.stage_epoch(q, aux, m, -1, owners=owners)
        pu, pa, pb = p.stage_epoch(q, aux, m, -1, owners=owners)
        assert pb == rb
        want = r.probe_epoch(ru, ra, with_degrees, bucket=rb)
        got = p.probe_epoch(pu, pa, with_degrees, bucket=pb)
        np.testing.assert_array_equal(got.mats.numpy(),
                                      np.asarray(want.mats))
        _same_out(got.collect(), want.collect())


@pytest.mark.parametrize("n_shards", KC.K1_SHARDS)
def test_join_probe_sharded_plain_edge_cases(eight_devices, n_shards):
    """The routed probe-only step on ``kernel_cases``' sharded batch:
    receive blocks that are mostly empty (one probe row in ten), chains
    of 0, 1 and 40 refs, at a seq between the two inserts and after, with
    the case's pair buffer and one too small. Every shard's matrix bit
    for bit."""
    c = KC.k6_sharded_case(n_shards)
    r, p = _pair(eight_devices, n_shards, key_capacity=256,
                 row_capacity=1024, probe_capacity=c["out_cap"])
    kl, refs = c["stored"]
    half = len(refs) // 2
    every = np.ones(len(refs), bool)
    for k in (r, p):
        k.insert(kl[:half], refs[:half], every[:half], seq=1)
        k.insert(kl[half:], refs[half:], every[half:], seq=2)
    _same_state(p, r)
    q, vis = c["probe"]
    m = len(q)
    for seq in c["seqs"]:
        for out_cap in (c["out_cap"], 4):
            step = r._build_probe_only(m // n_shards, out_cap)
            want, _ovf = step(r.table, r.chains, jnp.asarray(q),
                              jnp.arange(m, dtype=jnp.int32),
                              jnp.asarray(vis), jnp.int32(seq), r.owner_map)
            got, _povf = p._dispatch_probe(q, vis, seq, out_cap)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_and_probe_plain_matches_reference():
    """B16 on one device, several chunks: the probe of the other side at
    the chunk's sequence, then this side's inserts and deletes at it."""
    rng = np.random.default_rng(12)
    cap, rows, n = 1 << 10, 1 << 9, 48
    full = lambda k, v: jnp.full(k, v, dtype=jnp.int32)  # noqa: E731
    r_side = [(R_ht.make_state(cap, KW),
               RJ.ChainState(full(cap, -1), full(rows, -1),
                             full(rows, RJ.I32_MAX), full(rows, RJ.I32_MAX)))
              for _ in range(2)]
    p_side = [(P_ht.make_state(cap, KW, CPU), PJ.make_chains(cap, rows, CPU))
              for _ in range(2)]
    next_ref, live = [0, 0], [[], []]
    for seq in range(1, 9):
        me = seq % 2
        keys = _lanes(rng.integers(0, 12, n))
        pvis = rng.random(n) < 0.9
        ins = pvis & (rng.random(n) < 0.7)
        dels = pvis & ~ins
        refs = np.zeros(n, np.int32)
        refs[ins] = np.arange(next_ref[me], next_ref[me] + int(ins.sum()))
        next_ref[me] += int(ins.sum())
        drefs = np.zeros(n, np.int32)
        k = min(int(dels.sum()), len(live[me]))
        pos = np.flatnonzero(dels)
        dels[pos[k:]] = False
        drefs[pos[:k]] = live[me][:k]
        live[me] = live[me][k:] + refs[ins].tolist()
        (rt, rc), (ot, oc) = r_side[me], r_side[1 - me]
        rt, rc, r_ins, r_mat = RJ._apply_and_probe_jit(
            rt, rc, ot, oc, jnp.asarray(keys), jnp.asarray(pvis),
            jnp.asarray(refs), jnp.asarray(ins), jnp.asarray(drefs),
            jnp.asarray(dels), jnp.int32(seq), 1 << 8)
        r_side[me] = (rt, rc)
        (pt, pc), (qt, qc) = p_side[me], p_side[1 - me]
        pt, pc, stats, p_mat = PJ.apply_and_probe_plain(
            pt, pc, qt, qc, *map(torch.from_numpy,
                                 (keys, pvis, refs, ins, drefs, dels)),
            seq, 1 << 8)
        assert int(stats[0]) == int(r_ins) and int(stats[1]) == 0
        np.testing.assert_array_equal(p_mat.numpy(), np.asarray(r_mat))
        np.testing.assert_array_equal(pt.keys.numpy(), np.asarray(rt.keys))
        for a, b in zip(pc, rc):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_join_side_kernel_per_chunk_api_matches_reference():
    """JoinSideKernel.apply_and_probe / probe_submit / probe against the
    reference's, with a pair buffer of 1 that must re-dispatch (the
    probed kernel remembers the grown size) and a probe collected after
    later applies (sequence versioning)."""
    rng = np.random.default_rng(13)
    ref = [RJ.JoinSideKernel(KW, key_capacity=1 << 10, row_capacity=1 << 9,
                             probe_capacity=1) for _ in range(2)]
    port = [PJ.JoinSideKernel(KW, key_capacity=1 << 10, row_capacity=1 << 9,
                              probe_capacity=1, device="cpu")
            for _ in range(2)]
    n, next_ref = 32, [0, 0]
    pending = []
    for seq in range(1, 7):
        me = seq % 2
        keys = _lanes(rng.integers(0, 6, n))
        pvis = rng.random(n) < 0.9
        refs = np.zeros(n, np.int32)
        refs[pvis] = np.arange(next_ref[me], next_ref[me] + int(pvis.sum()))
        next_ref[me] += int(pvis.sum())
        none = np.zeros(n, bool)
        args = (keys, pvis, refs, pvis, np.zeros(n, np.int32), none, seq)
        pending.append((
            ref[me].apply_and_probe(ref[1 - me], jnp.asarray(keys),
                                    *args[1:]),
            port[me].apply_and_probe(port[1 - me], *args)))
    for r_h, p_h in pending:
        _same_out(p_h.collect(), r_h.collect())
    assert [k._probe_cap for k in port] == [k._probe_cap for k in ref]
    assert port[0]._probe_cap > 1
    q = _lanes(rng.integers(0, 8, 20))
    vis = rng.random(20) < 0.9
    for seq in (None, 4):
        _same_out(port[0].probe(q, vis, seq),
                  ref[0].probe(jnp.asarray(q), jnp.asarray(vis), seq))


# -- ShardedJoinKernel against the reference ----------------------------------

@pytest.mark.parametrize("n_shards", [8, 4])
def test_sharded_kernel_matches_reference_through_every_step(eight_devices,
                                                             n_shards):
    """Per shard, bit for bit, after each of: per-chunk apply_and_probe
    steps (inserts, deletes, probes) whose keys outgrow the key tables
    (4x growth under pending probes) and whose refs outgrow the row
    arrays, probe and probe_submit, delete, two epochs of both sides'
    stage/apply/probe with the skew-exact bucket, the sequence rebase,
    and a rebuild from the live rows."""
    rng = np.random.default_rng(20 + n_shards)
    caps = dict(key_capacity=64, row_capacity=256, probe_capacity=32)
    r = [RefKernel(_mesh(eight_devices, n_shards), key_width=KW, **caps)
         for _ in range(2)]
    p = [ShardedJoinKernel(ShardMesh(n_shards, "cpu"), KW, **caps)
         for _ in range(2)]
    n = 16 * n_shards
    next_ref, live, keys_of = [0, 0], [[], []], [{}, {}]
    pending = []
    for seq in range(1, 13):
        me = seq % 2
        g = rng.integers(0, 40 + 40 * seq, n)
        kl = _lanes(g)
        pvis = rng.random(n) < 0.9
        ins = pvis & (rng.random(n) < 0.8)
        dels = pvis & ~ins
        refs = np.zeros(n, np.int32)
        refs[ins] = np.arange(next_ref[me], next_ref[me] + int(ins.sum()))
        next_ref[me] += int(ins.sum())
        drefs = np.zeros(n, np.int32)
        pos = np.flatnonzero(dels)
        k = min(len(pos), len(live[me]))
        dels[pos[k:]] = False
        drefs[pos[:k]] = live[me][:k]
        if k:
            kl[pos[:k]] = [keys_of[me][x] for x in live[me][:k]]
        live[me] = live[me][k:]
        for x, row in zip(refs[ins], kl[ins]):
            live[me].append(int(x))
            keys_of[me][int(x)] = row
        args = (kl, pvis, refs, ins, drefs, dels, seq)
        pending.append((r[me].apply_and_probe(r[1 - me], *args),
                        p[me].apply_and_probe(p[1 - me], *args)))
        for a, b in zip(p, r):
            _same_state(a, b)
    assert p[0].key_capacity > 64 and p[0].row_capacity > 256
    for r_h, p_h in pending:          # collected after every later apply
        _same_out(p_h.collect(), r_h.collect())
    assert [k.probe_capacity for k in p] == [k.probe_capacity for k in r]
    q = _lanes(rng.integers(0, 400, 3 * n_shards + 1))
    qv = rng.random(len(q)) < 0.9
    for seq in (None, 6):
        _same_out(p[0].probe(q, qv, seq), r[0].probe(q, qv, seq))
    dk = np.asarray(live[0][:5], np.int32)
    dl = np.stack([keys_of[0][x] for x in dk.tolist()])
    for k in (r[0], p[0]):
        k.delete(dk, np.ones(5, bool), seq=13, key_lanes=dl)
    _same_state(p[0], r[0])
    # two epochs of both sides, each row at its own sequence
    seq = 14
    for _epoch in range(2):
        staged = {}
        for side in (0, 1):
            m = 5 * n_shards + 3
            kl = _lanes(rng.integers(0, 500, m))
            aux = np.zeros((m, 4), np.int32)
            ins = rng.random(m) < 0.7
            aux[ins, PJ.AUX_INS_REF] = np.arange(
                next_ref[side], next_ref[side] + int(ins.sum()))
            next_ref[side] += int(ins.sum())
            aux[:, PJ.AUX_FLAGS] = PJ.FLAG_PROBE + ins * PJ.FLAG_INS
            aux[:, PJ.AUX_SEQ] = seq + np.arange(m) // 8
            seq += m // 8 + 1
            mr = int(aux[:, 0].max())
            owners = p[side].owners_of(kl)
            staged[side] = (r[side].stage_epoch(kl, aux, m, mr, owners),
                            p[side].stage_epoch(kl, aux, m, mr, owners))
            assert staged[side][0][2] == staged[side][1][2]
        for side, (rs, ps) in staged.items():
            r[side].apply_epoch(rs[0], rs[1], 0, -1, bucket=rs[2])
            p[side].apply_epoch(ps[0], ps[1], 0, -1, bucket=ps[2])
        probes = {side: (r[1 - side].probe_epoch(rs[0], rs[1], False,
                                                 bucket=rs[2]),
                         p[1 - side].probe_epoch(ps[0], ps[1], False,
                                                 bucket=ps[2]))
                  for side, (rs, ps) in staged.items()}
        for rp, pp in probes.values():
            _same_out(pp.collect(), rp.collect())
        for a, b in zip(p, r):
            _same_state(a, b)
    for k in (*r, *p):
        k.rebase_seq()
    for a, b in zip(p, r):
        _same_state(a, b)
    # a rebuild of side 1 from its live rows (compaction's dense refs)
    rows = np.stack([keys_of[1][x] for x in live[1]])
    new_refs = np.arange(len(rows), dtype=np.int32)
    for k in (r[1], p[1]):
        k.rebuild(rows, new_refs)
    _same_state(p[1], r[1])
    _same_out(p[1].probe(rows[:20], np.ones(20, bool)),
              r[1].probe(rows[:20], np.ones(20, bool)))


# -- the reference's tests/test_multichip_join.py -----------------------------

def test_sharded_join_matches_single_chip(eight_devices):
    """``test_multichip_join.py:15``: the sharded kernel over 8 shards
    finds the single-device kernel's pairs, batch after batch."""
    sharded = ShardedJoinKernel(ShardMesh(8, "cpu"), key_width=2,
                                key_capacity=1 << 10, row_capacity=1 << 10,
                                probe_capacity=1 << 10)
    single = PJ.JoinSideKernel(key_width=2, device="cpu")
    rng = np.random.default_rng(11)
    next_ref = 0
    for _round in range(3):
        n = 64
        keys = rng.integers(0, 23, n).astype(np.int64) * 5_000_000_017
        kl = np.stack(lanes.split_i64(keys), axis=1)
        refs = np.arange(next_ref, next_ref + n, dtype=np.int32)
        next_ref += n
        vis = rng.random(n) > 0.15
        sharded.insert(kl, refs, vis)
        single.insert(torch.from_numpy(kl), refs, torch.from_numpy(vis))
        pk = rng.integers(0, 30, 64).astype(np.int64) * 5_000_000_017
        pkl = np.stack(lanes.split_i64(pk), axis=1)
        pvis = np.ones(64, dtype=bool)
        _gdeg, gp, gr = sharded.probe(pkl, pvis)
        deg, sp, sr = single.probe(pkl, pvis)
        got, want = defaultdict(set), defaultdict(set)
        for pr, rf in zip(gp.tolist(), gr.tolist()):
            got[pr].add(rf)
        for pr, rf in zip(sp.tolist(), sr.tolist()):
            want[pr].add(rf)
        assert got == want
        assert sum(len(v) for v in got.values()) == int(deg.sum())


def test_sharded_join_state_is_sharded():
    """``test_multichip_join.py:50``: every state array has the leading
    shard axis (the port's stand-in for a sharded jax array)."""
    s = ShardedJoinKernel(ShardMesh(8, "cpu"), key_width=2,
                          key_capacity=1 << 10)
    assert s.table.keys.shape[:2] == (8, 1 << 10)
    assert s.chains.head.shape == (8, 1 << 10)
    assert s.chains.next.shape == (8, s.row_capacity)


def test_sharded_join_recurring_keys_do_not_trip_guard():
    """``test_multichip_join.py:58``: keys recurring across many batches
    do not grow the tables: the bound collapses to the true
    occupancy."""
    s = ShardedJoinKernel(ShardMesh(8, "cpu"), key_width=2,
                          key_capacity=256, row_capacity=1 << 14)
    ref = 0
    for _ in range(40):                  # 40*64 rows, only 10 keys
        keys = (np.arange(64, dtype=np.int64) % 10) * 999_999_937
        kl = np.stack(lanes.split_i64(keys), axis=1)
        s.insert(kl, np.arange(ref, ref + 64, dtype=np.int32),
                 np.ones(64, dtype=bool))
        ref += 64
    _d, gp, _gr = s.probe(kl, np.ones(64, dtype=bool))
    assert len(gp) > 0
    assert s.key_capacity == 256


def test_sharded_probe_overflow_retries():
    """``test_multichip_join_exec.py:162``: a pair buffer of 1 per shard
    forces the grow-and-redispatch loop."""
    mesh = ShardMesh(8, "cpu")
    k = ShardedJoinKernel(mesh, key_width=1, probe_capacity=1)
    other = ShardedJoinKernel(mesh, key_width=1, probe_capacity=1)
    lanes_ = np.asarray([[3]] * 9 + [[4]] * 7, dtype=np.int32)
    refs = np.arange(16, dtype=np.int32)
    h = k.apply_and_probe(other, lanes_, np.zeros(16, dtype=bool), refs,
                          np.ones(16, dtype=bool),
                          np.zeros(16, dtype=np.int32),
                          np.zeros(16, dtype=bool), seq=1)
    h.collect()
    probe = np.asarray([[3], [4], [5], [6]], dtype=np.int32)
    deg, pidx, prefs = k.probe(probe, np.ones(4, dtype=bool))
    assert deg.tolist() == [9, 7, 0, 0]
    assert k.probe_capacity >= 9
    assert {int(r) for p, r in zip(pidx, prefs) if p == 0} == set(range(9))
    assert {int(r) for p, r in zip(pidx, prefs) if p == 1} == \
        set(range(9, 16))


def test_route_overflow_raises_at_collect_not_dispatch():
    """A bucket too small for the epoch: the apply and the probe still
    dispatch (the rows that fit are routed), and the overflow surfaces
    when the probe is collected."""
    k = ShardedJoinKernel(ShardMesh(4, "cpu"), key_width=KW)
    m = 64
    kl = _lanes(np.full(m, 7))                  # one key: one owner shard
    aux = np.zeros((m, 4), np.int32)
    aux[:, PJ.AUX_INS_REF] = np.arange(m)
    aux[:, PJ.AUX_FLAGS] = PJ.FLAG_PROBE | PJ.FLAG_INS
    aux[:, PJ.AUX_SEQ] = 1
    up, ax, bucket = k.stage_epoch(kl, aux, m, m - 1)
    assert bucket == m // 4
    k.apply_epoch(up, ax, m, m - 1, bucket=2)
    pend = k.probe_epoch(up, ax, False, bucket=2)
    with pytest.raises(RuntimeError, match="bucket overflow"):
        pend.collect()
    # the 2 rows per sender that fit were applied
    deg, _p, _r = k.probe(kl, np.ones(m, bool))   # bucket = local: fits
    assert (deg == 2 * 4).all()


@pytest.mark.parametrize("case", KC.K5_CASES)
def test_join_apply_sharded_plain_kernel_cases(case):
    """Every K5 edge case (``ops/kernel_cases.py``; ``sharded_8`` is 8
    shards of mostly empty received rows, the rest one shard) through the
    sharded plain version with its payload scatter (``KC.k5_plain``, the
    oracle the kernel is held to on the card) equals the reference's
    link_rows, tombstone_rows and _masked_scatter shard by shard, every
    array exactly."""
    from tests.test_torch_hash_join import k5_reference
    c = KC.k5_case(case)
    chains, pay, parts = KC.k5_tensors(c, torch.device("cpu"))
    PJ.join_apply_sharded(chains, parts["slots"], ins_ok=parts["ins_ok"],
                          ins_bits=parts["ins_bits"],
                          ins_ref=parts["ins_ref"], del_ok=parts["del_ok"],
                          del_bits=parts["del_bits"],
                          del_ref=parts["del_ref"], seq=parts["seq"])
    got = [x.numpy() for x in chains]
    if pay is not None:
        _c2, pay2, _p2 = KC.k5_tensors(c, torch.device("cpu"))
        KC.k5_plain(PJ.ChainState(*(x.clone() for x in _c2)), pay2, parts)
        got.append(pay2.numpy())
    want = k5_reference(c)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
