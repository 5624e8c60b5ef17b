#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and the CUDA toolkit (nvcc), and imports nothing of JAX. Five
phases, any failure of which exits non-zero:

1. build: every kernel of ``risingwave_tpu_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, all started together) into build/kernels;
2. the card's name and power limit, as nvidia-smi prints them;
3. each kernel against its plain PyTorch version on the card, at the q7
   slice's shapes (table capacity 2^18, 2^15 rows per step, 3 key lanes,
   q7's MAX(price) + COUNT(*) plan, plus a SUM(int) / SUM(float) / MIN /
   COUNT plan over ~20K groups): integers exact, K1 (probe_insert) by the
   table invariants, float SUM's hi and lo rows each within rel 1e-6 of
   the group's summed magnitudes in that row;
   then each kernel's time and its plain version's (CUDA events, median
   of 21 samples of 10 calls queued behind a device sleep) and its bound;
4. Nexmark q7-core end to end through ``build_q7`` + ``drive_to_completion``
   at 10M events (bench.py's q7 shape: 8192-row chunks, 32 chunks per
   epoch, watermark retirement on), with every kernel's launch count
   reset just before and read just after; the MV must equal a vectorized
   oracle exactly;
5. where the time goes: q7-core again at 2M events under torch.profiler
   (the device's busy time and idle share) and cProfile (host self-time by
   module), after the main path's launch counts were read.

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CAP = 1 << 18                 # GroupedAggKernel.DEFAULT_CAPACITY
N = 1 << 15                   # GroupedAggKernel.BATCH_ROWS
KW = 3                        # one int64 group column: (hi, lo, valid)
Q7_EVENTS = 10_000_000
Q7_TRACE_EVENTS = 2_000_000  # bench.py's q7 size
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
INT_OPS_PER_S = 67e12         # non-tensor 32-bit rate (fp32 data sheet)
FLOAT_SUM_RTOL = 1e-6         # of Σ|terms| per group: atomic order varies
SAMPLES = 21                  # timing: median of 21 samples ...
PER_SAMPLE = 10               # ... of 10 back-to-back calls each
SLEEP_CYCLES = 20_000_000     # ~10 ms device sleep ahead of each sample

KERNELS = {
    # name: (source, reference program it replaces)
    "probe_insert": ("risingwave_tpu_torch/csrc/probe_insert.cu",
                     "risingwave_tpu/ops/hash_table.py:88"),
    "agg_apply": ("risingwave_tpu_torch/csrc/agg_apply.cu",
                  "risingwave_tpu/ops/hash_agg.py:519"),
    "flush_gather": ("risingwave_tpu_torch/csrc/flush.cu",
                     "risingwave_tpu/ops/hash_agg.py:596"),
    "advance": ("risingwave_tpu_torch/csrc/flush.cu",
                "risingwave_tpu/ops/hash_agg.py:744"),
    "live_mask": ("risingwave_tpu_torch/csrc/rebuild.cu",
                  "risingwave_tpu/ops/hash_agg.py:676"),
    "remap": ("risingwave_tpu_torch/csrc/rebuild.cu",
              "risingwave_tpu/ops/hash_agg.py:795"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, samples: int = SAMPLES, per: int = PER_SAMPLE) -> float:
    """Device time of one fn call: the median over `samples` of CUDA-event
    time around `per` back-to-back calls, divided by `per`. Each sample
    first queues a device sleep, so the calls are enqueued while the card
    is busy and run back to back: a µs-scale kernel is then timed, not
    the host's launch rate. Plain versions that wait on the device inside
    still include those waits, as they do on the main path."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# -- inputs at the slice's shapes ---------------------------------------------

def _key_lanes(g: np.ndarray) -> np.ndarray:
    from risingwave_tpu_torch.ops import lanes
    hi, lo = lanes.split_i64(g.astype(np.int64))
    return np.stack([hi, lo, np.ones(len(g), np.int32)], axis=1)


def q7_batch(n: int, specs, window_us: int = 10_000_000) -> np.ndarray:
    """A q7 step: 2^15 bids of bench.py's stream span about a third of a
    10 s window, so nearly every row hits the same one or two groups."""
    from risingwave_tpu_torch.ops import hash_agg as H
    base = 1_436_918_400_000_000
    ts = base + 7_000_000 + np.arange(n, dtype=np.int64) * 108
    win = ts - ts % window_us
    rng = np.random.default_rng(7)
    price = np.maximum(1, (10.0 ** (rng.random(n) * 6) * 100)).astype(
        np.int64)
    inputs = tuple((s.encode_input(price), np.ones(n, bool))
                   if s.in_dtype is not None else ((), None) for s in specs)
    return H.pack_chunk(KW, specs, _key_lanes(win), np.ones(n, np.int32),
                        np.ones(n, bool), inputs)


def mixed_batch(n: int, specs, groups: int = 20_000, seed: int = 11):
    """Many groups (inserts, probe collisions, in-batch duplicates),
    invisible rows, NULL inputs and retractions (none for MIN, which is
    append-only on the device)."""
    from risingwave_tpu_torch.ops import hash_agg as H
    rng = np.random.default_rng(seed)
    g = rng.integers(0, groups, n).astype(np.int64) * 7_919 - 3
    signs = np.where(rng.random(n) < 0.15, -1, 1).astype(np.int32)
    vis = rng.random(n) < 0.95
    ints = rng.integers(-10**12, 10**12, n)
    floats = rng.standard_normal(n) * 1e3
    inputs = []
    for s in specs:
        if s.in_dtype is None:
            inputs.append(((), None))
            continue
        ok = rng.random(n) < 0.9
        if s.kind == H.AggKind.MIN:
            ok &= signs > 0
        vals = floats if np.issubdtype(s.in_dtype, np.floating) else ints
        inputs.append((s.encode_input(vals), ok))
    return H.pack_chunk(KW, specs, _key_lanes(g), signs, vis, inputs)


def make_specs(H, pairs):
    return tuple(H.AggSpec(H.AggKind(k), None if d is None else np.dtype(d))
                 for k, d in pairs)


def abs_err(x, y) -> float:
    """Largest |x - y| of two integer arrays of one shape, in int64."""
    x, y = np.asarray(x), np.asarray(y)
    assert x.shape == y.shape, (x.shape, y.shape)
    return float(np.abs(x.astype(np.int64) - y.astype(np.int64)).max(
        initial=0))


def float_sum_err(H, a, b, packed, slots, specs, call, rows, cap) -> float:
    """Float SUM of call `call`: the kernel's state `a` against the plain
    version's `b`, its hi row and its lo row each on its own. Each row
    may differ from the other version's by rel FLOAT_SUM_RTOL of its
    group's Σ|terms| in that row (summation order); a kernel that drops
    either lane misses by the whole lane. Returns the largest error."""
    cols, vc = H.packed_layout(KW, specs)[call]
    live = (packed[:, KW + 1] != 0) & (packed[:, vc] != 0)
    worst = 0.0
    for row, col in zip(rows, cols):
        mag = np.zeros(cap)
        np.add.at(mag, slots[live],
                  np.abs(packed[live, col].view(np.float32)
                         .astype(np.float64)))
        err = np.abs(a[row].view(np.float32).astype(np.float64)
                     - b[row].view(np.float32).astype(np.float64))
        assert (err <= FLOAT_SUM_RTOL * mag).all(), \
            (row, float(err.max()))
        worst = max(worst, float(err.max()))
    return worst


# -- phase 3: each kernel against its plain version ------------------------------

def check_probe_insert(dev, cap: int, n: int) -> dict:
    """K1 by the table invariants (its slot rule is not the plain
    version's). Its max_abs_err is the largest gap between a valid row's
    key and the key its slot holds, between the two tables' sorted key
    sets, and between their insert and overflow counts."""
    from risingwave_tpu_torch.ops import hash_table as ht
    rng = np.random.default_rng(3)
    pre = _key_lanes(rng.integers(0, 10**9, cap // 4).astype(np.int64))
    t0 = ht.make_state(cap, KW, dev)
    ht.probe_insert_plain(t0, torch.from_numpy(pre).to(dev),
                          torch.ones(len(pre), dtype=torch.int32,
                                     device=dev))
    # the batch: existing keys, new keys with in-batch duplicates, and
    # invalid rows
    new = _key_lanes(rng.integers(10**9, 10**9 + n // 3, n // 2)
                     .astype(np.int64))
    keys = np.concatenate([pre[rng.integers(0, len(pre), n - n // 2)], new])
    keys = keys[rng.permutation(n)]
    valid = (rng.random(n) < 0.97).astype(np.int32)
    bk = torch.from_numpy(keys).to(dev)
    bv = torch.from_numpy(valid).to(dev)
    tk = ht.TableState(t0.keys.clone(), t0.occ.clone())
    tp = ht.TableState(t0.keys.clone(), t0.occ.clone())
    _s, slots_k, stats_k = ht.probe_insert(tk, bk, bv)
    slots_p, stats_p = ht.probe_insert_plain(tp, bk, bv)
    sk, kk, ok = slots_k.cpu().numpy(), tk.keys.cpu().numpy(), \
        tk.occ.cpu().numpy()
    err = abs_err(stats_k.cpu().numpy(), stats_p.cpu().numpy())
    assert err == 0, (stats_k, stats_p)
    assert int(stats_k[1]) == 0, "probe overflow"
    v = valid != 0
    assert (sk[~v] == -1).all()
    assert (sk[v] >= 0).all()
    err = max(err, abs_err(kk[sk[v]], keys[v]))
    assert err == 0, "a row's slot does not hold its key"
    assert (ok[sk[v]] == 1).all()
    _u, inv = np.unique(keys[v], axis=0, return_inverse=True)
    first = np.full(inv.max() + 1, -1)
    first[inv[::-1]] = sk[v][::-1]
    assert (first[inv] == sk[v]).all(), "equal keys on two slots"
    occ0 = t0.occ.cpu().numpy() != 0
    assert (kk[occ0] == t0.keys.cpu().numpy()[occ0]).all() and \
        (ok[occ0] == 1).all(), "an existing slot changed"

    def keyset(t):
        k = t.keys.cpu().numpy()[t.occ.cpu().numpy() != 0]
        return k[np.lexsort(k.T[::-1])]
    err = max(err, abs_err(keyset(tk), keyset(tp)))
    assert err == 0, "the tables hold different keys"

    # timing at the q7 shape: the step's one or two window keys already
    # sit in the table (steady state)
    from risingwave_tpu_torch.ops import hash_agg as H
    specs = make_specs(H, [("max", np.int64), ("count", None)])
    packed = torch.from_numpy(q7_batch(n, specs)).to(dev)
    tq = ht.make_state(cap, KW, dev)
    ht.probe_insert(tq, packed[:, :KW], packed[:, KW + 1])
    ms = time_ms(lambda: ht.probe_insert(tq, packed[:, :KW],
                                         packed[:, KW + 1]))
    tq2 = ht.TableState(tq.keys.clone(), tq.occ.clone())
    plain_ms = time_ms(lambda: ht.probe_insert_plain(
        tq2, packed[:, :KW], packed[:, KW + 1]))
    distinct = len(np.unique(packed[:, :KW].cpu().numpy(), axis=0))
    nbytes = n * (KW + 1) * 4 + n * 4 + 8 + distinct * (KW + 1) * 4
    b, by = bound_ms(nbytes, n * (12 * KW + 2 * KW))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


def _state_after(dev, specs, packed_t, cap):
    from risingwave_tpu_torch.ops import hash_agg as H
    st = H.make_agg_state(cap, KW, specs, dev)
    _t, slots, stats = H.ht.probe_insert(st.table, packed_t[:, :KW],
                                         packed_t[:, KW + 1])
    assert int(stats[1]) == 0
    return st, slots


def check_agg_apply(dev, cap: int, n: int) -> dict:
    from risingwave_tpu_torch.ops import hash_agg as H
    specs = make_specs(H, [("sum", np.int64), ("sum", np.float64),
                           ("min", np.int64), ("count", None)])
    plan = H.ApplyPlan(KW, specs, dev)
    packed_np = mixed_batch(n, specs)
    packed = torch.from_numpy(packed_np).to(dev)
    st, slots = _state_after(dev, specs, packed, cap)
    sk = H.AggState(st.table, st.st.clone())
    sp = H.AggState(st.table, st.st.clone())
    H.agg_apply(sk, packed, slots, plan)
    H.agg_apply_plain(sp, packed, slots, plan)
    a, b = sk.st.cpu().numpy(), sp.st.cpu().numpy()
    frows = [H.ROW_ACC0 + 4 + 1, H.ROW_ACC0 + 4 + 1 + 1]   # float hi, lo
    ints = [r for r in range(a.shape[0]) if r not in frows]
    int_err = abs_err(a[ints], b[ints])
    assert int_err == 0, int_err
    err = float_sum_err(H, a, b, packed_np, slots.cpu().numpy(), specs, 1,
                        frows, cap)
    # the q7 plan at the q7 shape: exact, then timed
    q7 = make_specs(H, [("max", np.int64), ("count", None)])
    qplan = H.ApplyPlan(KW, q7, dev)
    qpacked = torch.from_numpy(q7_batch(n, q7)).to(dev)
    qs, qslots = _state_after(dev, q7, qpacked, cap)
    snap = qs.st.clone()
    q_k = H.AggState(qs.table, snap.clone())
    q_p = H.AggState(qs.table, snap.clone())
    H.agg_apply(q_k, qpacked, qslots, qplan)
    H.agg_apply_plain(q_p, qpacked, qslots, qplan)
    int_err = max(int_err, abs_err(q_k.st.cpu().numpy(),
                                   q_p.st.cpu().numpy()))
    assert int_err == 0, int_err
    # repeated steps redo the same atomics (the counts just grow)
    ms = time_ms(lambda: H.agg_apply(q_k, qpacked, qslots, qplan))
    plain_ms = time_ms(lambda: H.agg_apply_plain(q_p, qpacked, qslots,
                                                 qplan))
    w = qpacked.shape[1]
    touched = len(np.unique(qslots.cpu().numpy()))
    nbytes = n * w * 4 + n * 4 + touched * (2 + 4) * 4 * 2
    b, by = bound_ms(nbytes, n * 12)
    return dict(max_abs_err=max(err, int_err), ms=ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by)


def _mixed_state(dev, cap, n):
    """The SUM/MIN/COUNT plan's state after one applied batch (kernels)."""
    from risingwave_tpu_torch.ops import hash_agg as H
    specs = make_specs(H, [("sum", np.int64), ("sum", np.float64),
                           ("min", np.int64), ("count", None)])
    packed = torch.from_numpy(mixed_batch(n, specs)).to(dev)
    st, slots = _state_after(dev, specs, packed, cap)
    H.agg_apply(st, packed, slots, H.ApplyPlan(KW, specs, dev))
    return specs, st


def _q7_state(dev, cap, n):
    """The q7 plan's state after one applied q7 step (kernels)."""
    from risingwave_tpu_torch.ops import hash_agg as H
    specs = make_specs(H, [("max", np.int64), ("count", None)])
    packed = torch.from_numpy(q7_batch(n, specs)).to(dev)
    st, slots = _state_after(dev, specs, packed, cap)
    H.agg_apply(st, packed, slots, H.ApplyPlan(KW, specs, dev))
    return specs, st


def check_flush_gather(dev, cap: int, n: int) -> dict:
    from risingwave_tpu_torch.ops import hash_agg as H
    _specs, st = _mixed_state(dev, cap, n)
    err = 0.0
    for flush_cap in (1 << 15, 1 << 10):     # the second one overflows
        k = H.flush_gather(st, flush_cap).cpu().numpy()
        p = H.flush_gather_plain(st, flush_cap).cpu().numpy()
        err = max(err, abs_err(k, p))
    assert err == 0, err
    assert k[0, 0] > (1 << 10), "header must carry the true n_dirty"
    _q7, qs = _q7_state(dev, cap, n)
    flush_cap = 1 << 10                        # the kernel's default
    ms = time_ms(lambda: H.flush_gather(qs, flush_cap))
    plain_ms = time_ms(lambda: H.flush_gather_plain(qs, flush_cap))
    n_dirty = int((qs.st[H.ROW_DIRTY] != 0).sum())
    w = H.flush_width(KW, qs.n_acc)
    nbytes = cap * 4 * 2 + n_dirty * w * 4 + (1 + flush_cap) * w * 4
    b, by = bound_ms(nbytes, cap * 4)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


def check_advance(dev, cap: int, n: int) -> dict:
    from risingwave_tpu_torch.ops import hash_agg as H
    _specs, st = _mixed_state(dev, cap, n)
    k = H.AggState(st.table, st.st.clone())
    p = H.AggState(st.table, st.st.clone())
    H.advance(k)
    H.advance_plain(p)
    err = abs_err(k.st.cpu().numpy(), p.st.cpu().numpy())
    assert err == 0, err
    _q7, qs = _q7_state(dev, cap, n)
    n_dirty = int((qs.st[H.ROW_DIRTY] != 0).sum())
    # after the first call no slot is dirty; the q7 step dirties one or
    # two, so each call still reads the whole dirty row, as on the path
    ms = time_ms(lambda: H.advance(qs))
    plain_ms = time_ms(lambda: H.advance_plain(qs))
    nacc = qs.n_acc
    nbytes = cap * 4 + n_dirty * (1 + nacc) * 4 + n_dirty * (3 + nacc) * 4
    b, by = bound_ms(nbytes, cap)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


def check_live_mask(dev, cap: int, n: int) -> dict:
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.ops import lanes
    _specs, st = _mixed_state(dev, cap, n)
    H.advance(st)
    hi, lo = lanes.split_i64(np.asarray([10_000 * 7_919], dtype=np.int64))
    err = 0.0
    for mode in (H.LIVE_GROW, H.LIVE_RETIRE):
        k = H.live_mask(st, mode, 0, int(hi[0]), int(lo[0]))
        p = H.live_mask_plain(st, mode, 0, int(hi[0]), int(lo[0]))
        err = max(err, abs_err(k.cpu().numpy(), p.cpu().numpy()))
    assert err == 0, err
    assert 0 < int(k.sum()) < int((st.table.occ != 0).sum())
    _q7, qs = _q7_state(dev, cap, n)
    ms = time_ms(lambda: H.live_mask(qs, H.LIVE_RETIRE, 0, 0, 0))
    plain_ms = time_ms(lambda: H.live_mask_plain(qs, H.LIVE_RETIRE, 0, 0, 0))
    n_occ = int((qs.table.occ != 0).sum())
    nbytes = cap * 4 + n_occ * (3 + KW) * 4 + cap * 4
    b, by = bound_ms(nbytes, cap * 8)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


def check_remap(dev, cap: int, n: int) -> dict:
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.ops import lanes
    specs, st = _mixed_state(dev, cap, n)
    H.advance(st)
    fill = torch.tensor(H.state_fills(specs), dtype=torch.int32, device=dev)
    hi, lo = lanes.split_i64(np.asarray([10_000 * 7_919], dtype=np.int64))
    live = H.live_mask(st, H.LIVE_RETIRE, 0, int(hi[0]), int(lo[0]))
    err = 0.0
    for new_cap in (cap, 2 * cap):
        table = H.ht.make_state(new_cap, KW, dev)
        _t, o2n, stats = H.ht.probe_insert(table, st.table.keys, live)
        assert int(stats[1]) == 0 and int(stats[0]) == int(live.sum())
        k = H.remap(st.st, o2n, table.occ, fill, new_cap).cpu().numpy()
        p = H.remap_plain(st.st, o2n, table.occ, fill,
                          new_cap).cpu().numpy()
        err = max(err, abs_err(k, p))
    assert err == 0, err
    # the whole retirement, kernels vs plain versions, as key → state
    # columns (slot numbers may differ: K1's slot rule)
    ret_k, _ = H.retire_state(st, int(hi[0]), int(lo[0]), 0, fill)
    ref_t = H.ht.make_state(cap, KW, dev)
    o2n_p, _s = H.ht.probe_insert_plain(ref_t, st.table.keys, live)
    ret_p = H.AggState(ref_t, H.remap_plain(st.st, o2n_p, ref_t.occ, fill,
                                            cap))

    def by_key(s):
        occ = s.table.occ.cpu().numpy() != 0
        keys = s.table.keys.cpu().numpy()[occ]
        cols = s.st.cpu().numpy()[:, occ].T
        order = np.lexsort(keys.T[::-1])
        return keys[order], cols[order]
    for x, y in zip(by_key(ret_k), by_key(ret_p)):
        err = max(err, abs_err(x, y))
    assert err == 0, err
    # timing: a q7 retirement (the state's one or two groups survive)
    q7, qs = _q7_state(dev, cap, n)
    H.advance(qs)
    qfill = torch.tensor(H.state_fills(q7), dtype=torch.int32, device=dev)
    qlive = H.live_mask(qs, H.LIVE_RETIRE, 0, 0, 0)
    qt = H.ht.make_state(cap, KW, dev)
    _t, qo2n, _s = H.ht.probe_insert(qt, qs.table.keys, qlive)
    ms = time_ms(lambda: H.remap(qs.st, qo2n, qt.occ, qfill, cap))
    plain_ms = time_ms(lambda: H.remap_plain(qs.st, qo2n, qt.occ, qfill,
                                             cap))
    r = qs.st.shape[0]
    n_live = int(qlive.sum())
    nbytes = cap * 4 * 2 + r * 4 + n_live * r * 4 + r * cap * 4
    b, by = bound_ms(nbytes, cap * r)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


def launch_floor_ms(dev) -> float:
    """Back-to-back time of the cheapest launch the port makes: advance
    over a 1024-slot table with nothing dirty. No kernel of the path can
    take less per launch, whatever its bytes."""
    from risingwave_tpu_torch.ops import hash_agg as H
    specs = make_specs(H, [("count", None)])
    st = H.make_agg_state(1024, KW, specs, dev)
    return time_ms(lambda: H.advance(st))


CHECKS = {
    "probe_insert": check_probe_insert, "agg_apply": check_agg_apply,
    "flush_gather": check_flush_gather, "advance": check_advance,
    "live_mask": check_live_mask, "remap": check_remap,
}


# -- phase 4: q7-core end to end ---------------------------------------------------

def q7_oracle(cfg, n_bids: int, block: int = 1 << 20) -> dict:
    """window_start → (MAX(price), COUNT(*)), vectorized per block (bid
    event time is monotone, so windows are contiguous runs)."""
    from risingwave_tpu_torch.connectors.nexmark import gen_bids
    from risingwave_tpu_torch.models.nexmark import DEFAULT_WINDOW
    w_us = DEFAULT_WINDOW.usecs
    out: dict = {}
    for lo in range(0, n_bids, block):
        b = gen_bids(np.arange(lo, min(lo + block, n_bids), dtype=np.int64),
                     cfg)
        w = b["date_time"] - b["date_time"] % w_us
        starts = np.flatnonzero(np.r_[True, w[1:] != w[:-1]])
        mx = np.maximum.reduceat(b["price"], starts)
        cnt = np.diff(np.r_[starts, len(w)])
        for wi, m, c in zip(w[starts].tolist(), mx.tolist(), cnt.tolist()):
            pm, pc = out.get(wi, (0, 0))
            out[wi] = (max(pm, m), pc + c)
    return out


def host_split(stats, top: int = 8) -> dict:
    """Host self-time (s) of a cProfile run by source: each port module,
    then torch, numpy, asyncio and the rest; the `top` largest."""
    out: dict = {}
    for (path, _line, fn), (_cc, _nc, tt, _ct, _callers) in \
            stats.stats.items():
        where = fn if path == "~" else path       # "~": a builtin
        if "risingwave_tpu_torch" in where:
            key = where.split("risingwave_tpu_torch")[-1].strip("/")
        else:
            key = next((k for k in ("torch", "numpy", "asyncio")
                        if k in where), "other")
        out[key] = out.get(key, 0.0) + tt
    ranked = sorted(out.items(), key=lambda kv: -kv[1])
    return dict(ranked[:top])


def run_q7(dev, events: int, trace: bool = False) -> dict:
    """q7-core through build_q7 + drive_to_completion; the MV must equal
    the oracle. With ``trace``, the drive runs under torch.profiler (device
    busy time: the kernels' and copies' self device time) and cProfile
    (host self-time by source)."""
    from risingwave_tpu_torch.common.types import Interval
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.models.nexmark import (
        build_q7, drive_to_completion,
    )
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from risingwave_tpu_torch.utils.device import LAUNCHES

    cfg = NexmarkConfig(event_num=events, max_chunk_size=8192,
                        generate_strings=False)
    p = build_q7(MemoryStateStore(), cfg, rate_limit=32, min_chunks=32,
                 watermark_delay=Interval(usecs=0), device=dev)
    n_bids = events * 46 // 50

    def drive():
        out = asyncio.run(drive_to_completion(p, {1: n_bids}, in_flight=2))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    traced = {}
    LAUNCHES.reset()
    if trace:
        import cProfile
        import pstats
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        host = cProfile.Profile()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            host.enable()
            elapsed, rows = drive()
            host.disable()
            wall = time.perf_counter() - t0     # not the trace's teardown
        # the rule of the profiler's own table: device events' self time
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        traced = dict(device_busy_ms=busy_us / 1e3 if busy_us else None,
                      device_idle_share=(1 - busy_us / 1e6 / wall
                                         if busy_us else None),
                      host_self_s=host_split(pstats.Stats(host)))
    else:
        t0 = time.perf_counter()
        elapsed, rows = drive()
        wall = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    got = {r[0]: (r[1], r[2]) for _pk, r in p.mv_table.iter_rows()}
    want = q7_oracle(cfg, n_bids)
    assert got == want, "q7 MV differs from the oracle"
    assert p.reader.offset == n_bids
    return dict(events=rows, elapsed_s=elapsed, wall_s=wall,
                events_per_s=rows / elapsed,
                p99_barrier_latency_s=p.loop.stats.p99_latency_s(),
                barriers=len(p.loop.stats.latencies_s), windows=len(got),
                launches=launches, **traced)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from risingwave_tpu_torch.ops import cuda as kcuda
    dev = torch.device("cuda")

    # 1. build
    t0 = time.perf_counter()
    took = kcuda.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s "
        + json.dumps({k: round(v, 3) for k, v in took.items()}))
    for name in kcuda.LIBRARIES:
        for line in kcuda.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 2. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", cuda {torch.version.cuda}")

    # 3. kernels against their plain versions
    results = {}
    for name, check in CHECKS.items():
        results[name] = check(dev, CAP, N)
        log(f"kernel {name}: " + json.dumps(results[name]))

    floor = launch_floor_ms(dev)
    log(f"launch floor (advance, 1024 slots, nothing dirty): {floor} ms")

    # 4. q7-core end to end
    q7 = run_q7(dev, Q7_EVENTS)
    missing = [k for k in KERNELS if q7["launches"].get(k, 0) == 0]
    assert not missing, f"main path never launched {missing}"
    busy_ms = sum(q7["launches"][k] * results[k]["ms"] for k in KERNELS)
    log("q7: " + json.dumps(q7))
    log(f"q7: kernel busy estimate (launches x phase-3 medians) "
        f"{busy_ms:.3f} ms of {q7['elapsed_s'] * 1e3:.3f} ms timed wall")

    # 5. where the time goes: a shorter traced run (its launches are not
    # the main path's and are not reported)
    traced = run_q7(dev, Q7_TRACE_EVENTS, trace=True)
    log("q7 traced: " + json.dumps(traced))

    assert "jax" not in sys.modules, "the smoke run imported JAX"

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        rows.append({"name": name, "status": "ported, matches plain",
                     "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": q7["launches"][name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None})
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
