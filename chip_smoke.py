#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and the CUDA toolkit (nvcc), and imports nothing of JAX. Five
phases, any failure of which exits non-zero:

1. build: every kernel of ``risingwave_tpu_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, all started together) into build/kernels;
2. the card's name and power limit, as nvidia-smi prints them;
3. each kernel against its plain PyTorch version on the card, then its
   time and its plain version's (CUDA events, median of 21 samples of 10
   calls queued behind a device sleep) and its bound:
   - the hash-agg kernels at the q7 slice's shapes (table capacity 2^18,
     2^15 rows per step, 3 key lanes, q7's MAX(price) + COUNT(*) plan,
     plus a SUM(int) / SUM(float) / MIN / COUNT plan over ~20K groups):
     integers exact, K1 (probe_insert) by the table invariants, float
     SUM's hi and lo rows each within rel 1e-6 of the group's summed
     magnitudes in that row;
   - the join kernels at q8's shapes (6 key lanes, 6 payload lanes,
     2^16 rows per side-epoch, ~2M stored rows built through the growth
     ladder 2^20 → 2^22 slots, a 2^16-row pair buffer): K5 (join_apply)
     exact per key (each key's chain of refs, ins/del sequences, payload),
     K6 (join_probe) exact, with and without degrees, including a forced
     overflow (a 2^10-row buffer) that must re-dispatch to the same pairs,
     K7 and the head remap on K4 exact;
   - the fused preludes (fused_chain, agg_prelude, join_prelude of
     csrc/fused.cu) bit for bit against the plain program on random
     expression trees that cover every opcode, with edge values (a NaN
     equal to a NaN), and on q1's, q7's and q8's own programs at the
     path's shapes (a 2^15-row agg backlog, 2^16-row join side-epochs,
     q1's 4096-row chunks); q7's agg prelude also in the 8 segments of
     the q7-mesh fused step, with U-/U+ pairs across every block edge;
   - the sharded path at q7-mesh's shapes: route (csrc/route.cu) bit for
     bit against route_plain on a 2^15-row step in 8 blocks (bucket =
     the block), and with a forced overflow; the shard axis of K1-K4 at
     8 shards x 2^15 slots on q7's step and on the mixed plan over ~120K
     groups (K1 by the table invariants shard by shard, K2-K4 exact on
     the same slots, q7's whole step against its plain twin as
     key-sorted flushes), then a reshard to a rotated owner map with
     equal snapshots before and after;
   - the sharded join at q8-mesh's shapes (8 shards, 2^16-row
     side-epochs, ~2M stored refs built through key growth): K5 and K6
     with a shard axis exact per shard against their plain twins
     (ShardedJoinKernel through the plain versions), with hot keys,
     deletes and a forced per-shard pair-buffer overflow; then the
     per-chunk step B16 (route, K6 with its degree block at the chunk's
     scalar seq, K1, K5) on the per-chunk arm's own 4,096-row chunks
     (deletes, U-/U+ pairs, NULL keys), every step's per-shard matrices
     and both sides' state exact against the plain twin;
   - the agg's cold tier and patch (B9, B10), at the large shape (a
     2^20-slot table holding 600K groups of the SUM/SUM(float)/MIN/COUNT
     plan, 2^16 keys evicted, 2^16 rows patched and reloaded) and at the
     capped maxbids arm's own sizes: K8 (lookup) and K4's evict mode
     exact, B9 (evict_state) and the reload (K1 + K9) key-sorted against
     their plain twins, K9 (scatter_rows) exact, also with its shard
     axis at 8 x 2^15 slots, with ``index_put_`` timed beside it; a
     patch_accs that must pass the integer SUM limbs and the float SUM
     (hi, lo) bits through; K2 with a kNone lane;
4. the main paths end to end, each with every launch count reset just
   before and read just after, each MV equal to a vectorized oracle,
   with the plan checker strict (a rewrite that breaks an invariant
   raises instead of falling back):
   - Nexmark q7-core through ``build_q7`` + ``drive_to_completion`` at
     10M events (bench.py's q7 shape: 8192-row chunks, 32 chunks per
     epoch, watermark retirement on), unfused and with ``fusion=True``
     (the agg absorbs the tumble projection: agg_prelude); the fused MV
     equals the unfused one;
   - Nexmark q8 at 100M events, unfused and fused (both join sides
     absorb their projections: join_prelude; the dedup agg its tumble
     projection: agg_prelude); the fused MV equals the unfused one;
   - Nexmark q1 at 4M events (bench.py's bench_q1 shape: 4096-row
     chunks, 16 per epoch, strings on), unfused and fused (row-id
     generation and the DECIMAL projection as one block: fused_chain),
     the MVs compared without ``_row_id``;
   - q7-core over 8 logical shards (``build_q7(mesh=ShardMesh(8))``,
     bench.py's bench_q7_mesh shape: 4096-row chunks, 16 per epoch, no
     strings, watermark retirement on) at 10M events, unfused and fused
     (the prelude on the sharded kernel), each MV equal to the oracle and
     to the single-device q7's; then q7-mesh at 2M events killed halfway
     and rebuilt on the same store, equal to the oracle;
   - q8 over 8 logical shards (``build_q8(mesh=ShardMesh(8))``) at 100M
     events, unfused and fused, each MV equal to the oracle and to the
     single-device q8's; and the per-chunk arm
     (``HashJoinExecutor(mesh=ShardMesh(8), epoch_batch=False)``, one
     apply_and_probe per chunk) equal to its epoch-batched twin and to
     an oracle on a script with updates, deletes, NULL keys and growth;
   - Nexmark q5's MaxBids over 10 s tumbling windows (two aggs: COUNT(*)
     per (window, auction), then MAX/MIN/COUNT/SUM of the counts per
     window, retractable MIN/MAX patched by scatter_rows every barrier)
     at 10M events, and at 2M with a tier cap of 64 groups on the first
     agg (evictions and reloads must both happen), bench_q8's chunking;
   - Nexmark q15's distinct counts per 10 s window (COUNT(*), two
     COUNT(DISTINCT) and approx_count_distinct, K2 with a kNone lane) at
     10M events, q7's chunking: exact counts equal the oracle, the
     estimate equals this script's own dense-HLL registers and is within
     2% of the exact count;
   - q7-core under a tier cap of 8 groups at 2M events (watermark
     retirement on), its MV equal to the oracle and to the uncapped q7's
     (phase 5's traced run at the same size);
5. where the time goes: q7-core at 2M events and q8 at 2M and 20M
   events, fused q7 and q8 at 2M, q7-mesh and q8-mesh at 2M unfused
   and fused, and maxbids (uncapped and capped) and distinct at 2M,
   under torch.profiler (the device's busy time and idle share) and
   cProfile (host self-time by module; the sharded path's own host
   functions by cumulative time), after the main paths' counts were
   read.

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``; ``launches`` is the sum of the main paths'
counts) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import contextlib
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
L2_FLUSH_BYTES = 128 << 20    # > the H100's 50 MB L2
Q8_EVENTS = 100_000_000       # nexmark-flink's nexmark.events.num
Q8_TRACE_EVENTS = (2_000_000,   # bench.py's q8 size
                   20_000_000)  # a tenth of the main run: bigger state
JKW = 6                       # q8 join key: two int64 columns
JP = 6                        # q8 payload: two device-typed columns
J_N = 1 << 16                 # rows per side-epoch: 16 chunks x 4096
J_EPOCHS = 31                 # ~2M stored rows: q8's persons at 100M
J_CAP0 = 1 << 20              # build_q8's presized key/row capacity
OUT_CAP = 1 << 16             # build_q8's probe_capacity
OVERFLOW_CAP = 1 << 10
Q1_EVENTS = 4_000_000         # 3.68M bids; bench.py's bench_q1 shape
FUSED_SEEDS = 12              # random programs: every opcode appears
FUSED_ROWS = 1 << 15
MESH_SHARDS = 8               # bench.py's bench_q7_mesh parallelism
MESH_CAP = 1 << 15            # slots per shard in the kernel checks
MESH_GROUPS = 120_000         # the mixed plan's groups: ~15K per shard
MESH_ROWS = 1 << 18           # its batch: ~106K distinct groups
Q7_MESH_EVENTS = 10_000_000
Q7_MESH_RECOVERY_EVENTS = 2_000_000
Q7_MESH_TRACE_EVENTS = 2_000_000
Q8_MESH_TRACE_EVENTS = 2_000_000
MESH_CHUNK_ROWS = 4096        # bench.py's q8 lane chunks
PERCHUNK_CHUNKS = 96          # per side: 393,216 rows
PERCHUNK_EPOCH = 8            # chunks per side between barriers
PERCHUNK_STEP_CHUNKS = 16     # per side in the B16 step check: 2 epochs

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
    "join_apply": ("risingwave_tpu_torch/csrc/join_apply.cu",
                   "risingwave_tpu/ops/hash_join.py:68"),
    "join_probe": ("risingwave_tpu_torch/csrc/join_probe.cu",
                   "risingwave_tpu/ops/hash_join.py:237"),
    "join_probe_deg": ("risingwave_tpu_torch/csrc/join_probe.cu",
                       "risingwave_tpu/ops/hash_join.py:237"),
    "masked_scatter": ("risingwave_tpu_torch/csrc/join_maint.cu",
                       "risingwave_tpu/ops/hash_join.py:361"),
    "rebase": ("risingwave_tpu_torch/csrc/join_maint.cu",
               "risingwave_tpu/ops/hash_join.py:457"),
    "fused_chain": ("risingwave_tpu_torch/csrc/fused.cu",
                    "risingwave_tpu/ops/fused.py:839"),
    "agg_prelude": ("risingwave_tpu_torch/csrc/fused.cu",
                    "risingwave_tpu/ops/fused.py:877"),
    "join_prelude": ("risingwave_tpu_torch/csrc/fused.cu",
                     "risingwave_tpu/ops/fused.py:930"),
    "route": ("risingwave_tpu_torch/csrc/route.cu",
              "risingwave_tpu/parallel/exchange.py:72"),
    "lookup": ("risingwave_tpu_torch/csrc/probe_insert.cu",
               "risingwave_tpu/ops/hash_table.py:137"),
    "scatter_rows": ("risingwave_tpu_torch/csrc/scatter.cu",
                     "risingwave_tpu/ops/hash_agg.py:783"),
}
# the kernels each main path must have launched (the others run off
# these paths: degrees serve outer/semi/anti joins, masked_scatter the
# compaction q8's insert-only join never reaches, rebase past 2^30
# messages)
Q7_PATH = ("probe_insert", "agg_apply", "flush_gather", "advance",
           "live_mask", "remap")
Q8_PATH = ("probe_insert", "agg_apply", "flush_gather", "advance",
           "join_apply", "join_probe", "remap")
Q7_FUSED_PATH = Q7_PATH + ("agg_prelude",)
Q8_FUSED_PATH = Q8_PATH + ("agg_prelude", "join_prelude")
Q1_FUSED_PATH = ("fused_chain",)
Q7_MESH_PATH = ("route", "probe_insert", "agg_apply", "flush_gather",
                "advance", "live_mask", "remap")
Q7_MESH_FUSED_PATH = Q7_MESH_PATH + ("agg_prelude",)
Q8_MESH_PATH = ("route",) + Q8_PATH
Q8_MESH_FUSED_PATH = Q8_MESH_PATH + ("agg_prelude", "join_prelude")
# B16 per chunk: route, K6 on the other side, K1 + K5 on this side
PERCHUNK_PATH = ("route", "join_probe", "probe_insert", "join_apply")
# maxbids: the second agg's retractable MIN/MAX patch (K9) every barrier;
# the capped arm adds the eviction (K8, K4's evict mode, K1 + K4 remap)
MAXBIDS_PATH = ("probe_insert", "agg_apply", "flush_gather", "advance",
                "scatter_rows")
MAXBIDS_CAPPED_PATH = MAXBIDS_PATH + ("lookup", "live_mask", "remap")
# q7 under the tier: q7's own kernels, each sweep's eviction (K8, then
# K4 and K1 + K4 as q7 has them) and each reload (K1 + K9)
Q7_TIER_PATH = Q7_PATH + ("lookup", "scatter_rows")
DISTINCT_PATH = ("probe_insert", "agg_apply", "flush_gather", "advance")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, samples: int = SAMPLES, per: int = PER_SAMPLE,
            cold: bool = False) -> float:
    """Device time of one fn call: the median over `samples` of CUDA-event
    time around `per` back-to-back calls, divided by `per`. Each sample
    first queues a device sleep, so the calls are enqueued while the card
    is busy and run back to back: a µs-scale kernel is then timed, not
    the host's launch rate. Plain versions that wait on the device inside
    still include those waits, as they do on the main path. With
    ``cold``, each call is timed alone right after a write of
    L2_FLUSH_BYTES has evicted the 50 MB L2 cache, for work the main
    path meets cold (growth, compaction, the sequence rebase)."""
    for _ in range(3):
        fn()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda") if cold else None
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        torch.cuda._sleep(SLEEP_CYCLES)
        pairs = []
        for i in range(per):
            if cold:
                flush.zero_()
            if cold or i == 0:
                pairs.append((torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True)))
                pairs[-1][0].record()
            fn()
            if cold or i == per - 1:
                pairs[-1][1].record()
        pairs[-1][1].synchronize()
        times.append(sum(a.elapsed_time(b) for a, b in pairs) / per)
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


# -- phase 3, join kernels at q8's shapes -------------------------------------

W_US = 10_000_000                       # q8's tumbling window
BASE_US = 1_436_918_400_000_000         # Nexmark's event-time origin


def _join_up(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[key lanes | payload lanes] of rows keyed (a, b), both int64
    columns also stored as payload, as q8's join sides store them."""
    from risingwave_tpu_torch.ops import lanes
    keys = np.concatenate([_key_lanes(a), _key_lanes(b)], axis=1)
    pay = lanes.payload_lanes([(a, None), (b, None)])
    return np.ascontiguousarray(np.concatenate([keys, pay], axis=1))


def _person(i: np.ndarray):
    """q8's persons-side keys for stored row i: (id, window)."""
    i = i.astype(np.int64)
    return 1000 + i, BASE_US + (i // 2000) * W_US


def _aux(n, ins_ref, flags, seq0):
    aux = np.zeros((n, 4), np.int32)
    aux[:, 0] = ins_ref
    aux[:, 2] = flags
    aux[:, 3] = seq0 + np.arange(n) // 4096        # one seq per chunk
    return aux


def join_epochs(n_stored_epochs: int, n: int, seed: int = 21):
    """q8-shaped epochs of one join side (the persons side):

    - stored: persons-like epochs, every row a new key;
    - mixed: runs of rows on 8 hot stored keys (chains of ~400 refs),
      new keys, deletes of stored refs and probe-only rows — K5's check;
    - fresh: one more persons-like epoch (K5 timed at q8's shape);
    - probe: auctions-like, 30% of rows on stored keys (q8's chains hold
      one ref), with insert and negative flags for the degree adds;
    - probe_hot: the same with 2% of rows on the hot keys."""
    from risingwave_tpu_torch.ops import hash_join as J
    rng = np.random.default_rng(seed)
    stored = []
    for e in range(n_stored_epochs):
        i = np.arange(e * n, (e + 1) * n)
        stored.append((_join_up(*_person(i)),
                       _aux(n, i, J.FLAG_PROBE | J.FLAG_INS, 1 + e * 16)))
    n_st = n_stored_epochs * n
    u = rng.random(n)
    hot = rng.choice(n_st, 8, replace=False)
    src = np.where(u < 0.05, hot[rng.integers(0, 8, n)],
                   np.where(u < 0.60, n_st + np.arange(n),
                            rng.integers(0, n_st, n)))
    dels = (u >= 0.60) & (u < 0.70)
    # deleted rows carry their own stored row's key, one delete per ref
    del_refs = rng.choice(np.setdiff1d(np.arange(n_st), hot),
                          int(dels.sum()), replace=False)
    src[dels] = del_refs
    ins = u < 0.60
    flags = (J.FLAG_PROBE + ins * J.FLAG_INS + dels * (J.FLAG_DEL
                                                        | J.FLAG_NEG))
    ins_ref = np.zeros(n, np.int64)
    ins_ref[ins] = n_st + np.arange(int(ins.sum()))
    m_aux = _aux(n, ins_ref, flags, 10_000)
    m_aux[dels, 1] = del_refs
    mixed = (_join_up(*_person(src)), m_aux)
    i = 2 * n_st + np.arange(n)
    fresh = (_join_up(*_person(i)),
             _aux(n, n_st + n + np.arange(n), J.FLAG_PROBE | J.FLAG_INS,
                  15_000))

    def probe_epoch(hot_share):
        v = rng.random(n)
        src = np.where(v < hot_share, hot[rng.integers(0, 8, n)],
                       np.where(v < 0.30, rng.integers(0, n_st, n),
                                3 * n_st + rng.integers(0, 10**7, n)))
        flags = J.FLAG_PROBE + J.FLAG_INS + (rng.random(n) < 0.1) \
            * J.FLAG_NEG
        return _join_up(*_person(src)), _aux(n, np.arange(n), flags,
                                             20_000)
    return stored, mixed, fresh, probe_epoch(0.0), probe_epoch(0.02)


def build_join_states(dev, n_stored_epochs: int = J_EPOCHS, n: int = J_N,
                      cap0: int = J_CAP0) -> dict:
    """The kernel side: a JoinSideKernel on the card fed the stored
    epochs through its own apply_epoch (K1 + K5; the key table grows
    from build_q8's presized 2^20 through K1 rehashes and K4 head remaps,
    the row arrays grow too). The plain side: the plain versions on a
    table and row arrays sized to the kernel side's final capacity. Both
    then take the mixed epoch, which is K5's check."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import hash_table as ht
    stored, mixed, fresh, probe, probe_hot = join_epochs(n_stored_epochs, n)
    ks = J.JoinSideKernel(JKW, key_capacity=cap0, row_capacity=cap0,
                          probe_capacity=OUT_CAP, payload_width=JP,
                          device=dev)
    caps = [ks.table.capacity]
    for up, aux in stored:
        mr = int(aux[:, 0].max())
        ks.apply_epoch(*ks.stage_epoch(up, aux, n, mr), n, mr)
        caps.append(ks.table.capacity)
    cap, rows = ks.table.capacity, ks.row_capacity
    pt = ht.make_state(cap, JKW, dev)
    pc = J.make_chains(cap, rows, dev)
    ppay = torch.zeros((rows, JP), dtype=torch.int32, device=dev)
    for up, aux in stored:
        J.epoch_apply_plain(pt, pc, ppay, torch.from_numpy(up).to(dev),
                            torch.from_numpy(aux).to(dev), JKW)
    mu, ma = (torch.from_numpy(x).to(dev) for x in mixed)
    mr = int(mixed[1][:, 0].max())
    def dev_pair(e):
        return tuple(torch.from_numpy(x).to(dev) for x in e)
    return dict(ks=ks, plain=(pt, pc, ppay), mixed=(mu, ma, mr),
                fresh=dev_pair(fresh), probe=dev_pair(probe),
                probe_hot=dev_pair(probe_hot), caps=caps, n=n)


def _clone_side(table, chains, pay):
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import hash_table as ht
    return (ht.TableState(table.keys.clone(), table.occ.clone()),
            J.ChainState(*(t.clone() for t in chains)), pay.clone())


def _by_key(table, chains) -> tuple:
    """(keys, head) of the occupied slots, sorted by key: the per-key
    view of the slot-indexed arrays, free of slot numbering."""
    occ = table.occ.cpu().numpy() != 0
    keys = table.keys.cpu().numpy()[occ]
    head = chains.head.cpu().numpy()[occ]
    order = np.lexsort(keys.T[::-1])
    return keys[order], head[order]


def _k5_times(js, up, aux) -> tuple:
    """(K1 ms, K5 ms, plain K5 ms) of one epoch's apply on copies of
    both sides (K5 repeated on the slots K1 gave: it never walks the
    chains it rewrites)."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import hash_table as ht
    ks = js["ks"]
    ins = aux[:, J.AUX_FLAGS] & J.FLAG_INS
    kt, kc, kp = _clone_side(ks.table.state, ks.chains, ks.pay)
    _t, kslots, _s = ht.probe_insert(kt, up[:, :JKW], ins)
    k1_ms = time_ms(lambda: ht.probe_insert(kt, up[:, :JKW], ins))
    ms = time_ms(lambda: J.join_apply(kc, kp, kslots, up, aux, JKW,
                                      scratch=ks._link_scratch))
    qt, qc, qp = _clone_side(*js["plain"])
    qslots, _s = ht.probe_insert_plain(qt, up[:, :JKW], ins != 0)
    plain_ms = time_ms(lambda: J.join_apply_plain(qc, qp, qslots, up, aux,
                                                  JKW))
    f = aux[:, J.AUX_FLAGS].cpu().numpy()
    insm = (f & J.FLAG_INS) != 0
    n_ins, n_del = int(insm.sum()), int(((f & J.FLAG_DEL) != 0).sum())
    n_slots = len(np.unique(kslots.cpu().numpy()[insm]))
    nbytes = (len(f) * 16 + n_ins * (4 + JP * 4) + n_slots * 4
              + n_ins * (8 + JP * 4) + n_slots * 4 + n_del * 4)
    return k1_ms, ms, plain_ms, nbytes


def check_join_apply(dev, js: dict) -> dict:
    """K5, exact per key: after the stored epochs and the mixed epoch,
    each occupied key's head and the ref-indexed next (so each key's
    chain of refs), ins/del sequences and payload. Timed on the fresh
    epoch (q8's shape: every row a new key); the mixed epoch's time (hot
    keys: ~400 rows of one key in one epoch) is logged."""
    from risingwave_tpu_torch.ops import hash_join as J
    ks = js["ks"]
    pt, pc, ppay = js["plain"]
    mu, ma, mr = js["mixed"]
    _k1, hot_ms, hot_plain_ms, _b = _k5_times(js, mu, ma)
    ks.apply_epoch(mu, ma, js["n"], mr)
    J.epoch_apply_plain(pt, pc, ppay, mu, ma, JKW)
    ks.table.sync_count()
    err = 0.0
    for a, b in zip(_by_key(ks.table.state, ks.chains), _by_key(pt, pc)):
        err = max(err, abs_err(a, b))
    for a, b in zip((*ks.chains[1:], ks.pay), (*pc[1:], ppay)):
        err = max(err, abs_err(a.cpu().numpy(), b.cpu().numpy()))
    assert err == 0, f"join_apply differs from the plain chains: {err}"
    k1_ms, ms, plain_ms, nbytes = _k5_times(js, *js["fresh"])
    b, by = bound_ms(nbytes, js["n"] * 16)
    log(f"join_apply, mixed epoch with hot keys: {hot_ms} ms (plain "
        f"{hot_plain_ms} ms); probe_insert at q8's apply shape "
        f"({js['n']} rows, {ks.table.capacity} slots, 6 lanes, keys "
        f"already placed): {k1_ms} ms; key table capacities while "
        f"building: {sorted(set(js['caps']))}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, epoch_apply=_epoch_apply_times(js, nbytes))


def _epoch_apply_times(js, k5_bytes: float) -> dict:
    """B14 (epoch_apply) as the port runs it: K1 inserting a fresh
    side-epoch's keys (every row a new key, q8's shape), then K5 linking
    the rows, each launch on a fresh copy of the side; the plain pair
    beside it. Bound: K1's key lanes, flags and slot writes plus the new
    keys' table writes, and K5's bytes (``_k5_times``)."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import hash_table as ht
    ks = js["ks"]
    up, aux = js["fresh"]
    ins = aux[:, J.AUX_FLAGS] & J.FLAG_INS

    def kernels():
        t, c, pay = _clone_side(ks.table.state, ks.chains, ks.pay)
        torch.cuda._sleep(SLEEP_CYCLES // 4)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        _t, slots, _s = ht.probe_insert(t, up[:, :JKW], ins)
        J.join_apply(c, pay, slots, up, aux, JKW, scratch=ks._link_scratch)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    def plain():
        t, c, pay = _clone_side(*js["plain"])
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        slots, _s = ht.probe_insert_plain(t, up[:, :JKW], ins != 0)
        J.join_apply_plain(c, pay, slots, up, aux, JKW)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    kernels()
    ms = statistics.median(kernels() for _ in range(SAMPLES))
    plain_ms = statistics.median(plain() for _ in range(5))
    n = js["n"]
    n_ins = int((ins != 0).sum())
    k1_bytes = n * (JKW * 4 + 4 + 4) + n_ins * (JKW * 4 + 4)
    b, by = bound_ms(k1_bytes + k5_bytes, n * (12 * JKW + 16))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by)


def _probe_bytes(js, mat, with_degrees, rows) -> float:
    """K6's byte bound on one probe epoch: the header and the pairs it
    writes are charged, not the unwritten rest of the pair buffer."""
    n = js["n"]
    _pu, pa = js["probe"]
    vis = int(((pa[:, 2] & 1) != 0).sum())
    total = int(mat[0, 0])
    w = 2 + JP + int(with_degrees)
    nbytes = (n * (JKW * 4 + 16) + vis * (JKW * 4 + 4 + 4)
              + total * (12 + JP * 4) + (1 + total) * w * 4)
    if with_degrees:
        nbytes += n * w * 4 + total * 4 + 4 * rows * 4 + n * 4
    return nbytes


def _probe_fns(js, which, out_cap, with_degrees, degs=None):
    """(kernel call, plain call) of one probe epoch."""
    from risingwave_tpu_torch.ops import hash_join as J
    ks = js["ks"]
    pt, pc, ppay = js["plain"]
    pu, pa = js[which]
    ds0, dk0 = degs if degs is not None else (ks.deg, ks.deg)

    def k(cap=out_cap):
        return J.epoch_probe(ks.table.state, ks.chains, ks.pay, ds0, dk0,
                             pu, pa, JKW, cap, with_degrees)

    def p():
        return J.epoch_probe_plain(pt, pc, ppay, ds0, dk0, pu, pa, JKW,
                                   out_cap, with_degrees)
    return k, p


def _same(k, p) -> float:
    err = 0.0
    for a, b in zip(k[:3], p[:3]):
        assert (a is None) == (b is None)
        if a is not None:
            err = max(err, abs_err(a.cpu().numpy(), b.cpu().numpy()))
    return err


def check_join_probe(dev, js: dict) -> dict:
    """K6 without degrees, exact, on the q8-like and the hot-key probe
    epochs; then a 2^10-row pair buffer that must re-dispatch
    (PendingEpochProbe) to the same pairs. Timed on the q8-like epoch;
    the hot-key epoch's time is logged."""
    from risingwave_tpu_torch.ops import hash_join as J
    err = 0.0
    times = {}
    for which in ("probe", "probe_hot"):
        k, p = _probe_fns(js, which, OUT_CAP, False)
        km, pm = k(), p()
        assert km[3].tolist() == [0, 0], km[3]
        err = max(err, _same(km, pm))
        assert err == 0, f"join_probe differs on {which}: {err}"
        times[which] = (time_ms(k), time_ms(p), km[0])
    k, p = _probe_fns(js, "probe", OUT_CAP, False)
    total = int(times["probe"][2][0, 0])
    assert OVERFLOW_CAP < total <= OUT_CAP, total
    pend = J.PendingEpochProbe(k(OVERFLOW_CAP)[0], js["n"], OVERFLOW_CAP,
                               lambda cap: k(cap)[0], JP, False, None, None)
    got = pend.collect()
    assert pend.cap > OVERFLOW_CAP, "the small buffer did not overflow"
    want = J.PendingEpochProbe(p()[0], js["n"], OUT_CAP, None, JP, False,
                               None, None).collect()
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            err = max(err, abs_err(a, b))
    assert err == 0, f"the re-dispatched probe differs: {err}"
    ms, plain_ms, mat = times["probe"]
    b, by = bound_ms(_probe_bytes(js, mat, False, js["ks"].row_capacity),
                     js["n"] * 64)
    log(f"join_probe: {total} pairs of {js['n']} probe rows; overflow at "
        f"{OVERFLOW_CAP} re-dispatched at {pend.cap}; hot-key epoch "
        f"({int(times['probe_hot'][2][0, 0])} pairs): "
        f"{times['probe_hot'][0]} ms (plain {times['probe_hot'][1]} ms)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


def check_join_probe_deg(dev, js: dict) -> dict:
    """K6 with degrees (outer/semi/anti; no ported join type reaches it):
    matrix, deg_self' and deg_sink' exact on both probe epochs."""
    rng = np.random.default_rng(5)
    rows = js["ks"].row_capacity
    degs = tuple(torch.from_numpy(rng.integers(0, 4, rows).astype(np.int32))
                 .to(dev) for _ in range(2))
    err = 0.0
    for which in ("probe_hot", "probe"):
        k, p = _probe_fns(js, which, OUT_CAP, True, degs)
        km = k()
        err = max(err, _same(km, p()))
        assert err == 0, f"join_probe (degrees) differs on {which}: {err}"
    b, by = bound_ms(_probe_bytes(js, km[0], True, rows), js["n"] * 64)
    return dict(max_abs_err=err, ms=time_ms(k), plain_ms=time_ms(p),
                bound_ms=b, bound_by=by)


def check_masked_scatter(dev, js: dict) -> dict:
    """K7 masked_scatter at a q8-sized compaction: the payload lanes of
    2^20 live rows into a fresh [row_cap, 6] store."""
    from risingwave_tpu_torch.ops import hash_join as J
    rows = js["ks"].row_capacity
    n = min(1 << 20, rows)
    rng = np.random.default_rng(9)
    refs = torch.arange(n, dtype=torch.int32, device=dev)
    vis = torch.ones(n, dtype=torch.int32, device=dev)
    vals = torch.from_numpy(rng.integers(-2**31, 2**31, (n, JP))
                            .astype(np.int32)).to(dev)
    arr = torch.zeros((rows, JP), dtype=torch.int32, device=dev)
    k = J._masked_scatter(arr.clone(), refs, vis, vals)
    p = J._masked_scatter_plain(arr.clone(), refs, vis, vals)
    err = abs_err(k.cpu().numpy(), p.cpu().numpy())
    assert err == 0, f"masked_scatter differs: {err}"
    ms = time_ms(lambda: J._masked_scatter(arr, refs, vis, vals),
                 cold=True)
    plain_ms = time_ms(lambda: J._masked_scatter_plain(arr, refs, vis,
                                                       vals), cold=True)
    b, by = bound_ms(n * (8 + JP * 4) + n * JP * 4, n * JP)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


def check_rebase(dev, js: dict) -> dict:
    from risingwave_tpu_torch.ops import hash_join as J
    c = js["ks"].chains
    k = J._rebase(J.ChainState(*(t.clone() for t in c)))
    p = J._rebase_plain(J.ChainState(*(t.clone() for t in c)))
    err = max(abs_err(a.cpu().numpy(), b.cpu().numpy())
              for a, b in zip(k, p))
    assert err == 0, f"rebase differs: {err}"
    ms = time_ms(lambda: J._rebase(k), cold=True)
    plain_ms = time_ms(lambda: J._rebase_plain(p), cold=True)
    rows = int(c.ins_seq.shape[0])
    b, by = bound_ms(rows * 4 * 4, rows * 4)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


def check_remap_head(dev, js: dict, old_cap: int = 1 << 21) -> dict:
    """The head remap of q8's last key-table growth (2^21 → 2^22 slots,
    ~1.4M keys) on K4's remap: exact against the plain _remap_head, and
    per key the same head. Logged beside K4's q7-shaped row."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import hash_table as ht
    n = int(old_cap * ht.MAX_LOAD)
    keys = torch.from_numpy(_join_up(*_person(np.arange(n)))[:, :JKW]) \
        .to(dev)
    old = ht.make_state(old_cap, JKW, dev)
    ht.probe_insert(old, keys, torch.ones(n, dtype=torch.int32, device=dev))
    rng = np.random.default_rng(4)
    head = torch.from_numpy(np.where(old.occ.cpu().numpy() != 0,
                                     rng.integers(0, n, old_cap), -1)
                            .astype(np.int32)).to(dev)
    new = ht.make_state(2 * old_cap, JKW, dev)
    _n, o2n, _s = ht.probe_insert(new, old.keys, old.occ)
    k = J._remap_head(head, o2n, 2 * old_cap, new.occ)
    p = J._remap_head_plain(head, o2n, 2 * old_cap)
    err = abs_err(k.cpu().numpy(), p.cpu().numpy())
    c0 = J.ChainState(head, head, head, head)
    for a, b in zip(_by_key(new, c0._replace(head=k)), _by_key(old, c0)):
        err = max(err, abs_err(a, b))
    assert err == 0, f"head remap differs: {err}"
    ms = time_ms(lambda: J._remap_head(head, o2n, 2 * old_cap, new.occ),
                 cold=True)
    plain_ms = time_ms(lambda: J._remap_head_plain(head, o2n, 2 * old_cap),
                       cold=True)
    b, by = bound_ms(old_cap * 8 + 2 * old_cap * 4 * 2 + 4, old_cap)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


JOIN_CHECKS = {
    "join_apply": check_join_apply, "join_probe": check_join_probe,
    "join_probe_deg": check_join_probe_deg,
    "masked_scatter": check_masked_scatter, "rebase": check_rebase,
}


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


def drive(p, targets: dict, dev, trace: bool) -> dict:
    """drive_to_completion with every launch count reset just before and
    read just after. With ``trace``, the drive runs under torch.profiler
    (device busy time: the kernels' and copies' self device time) and
    cProfile (host self-time by source)."""
    from risingwave_tpu_torch.models.nexmark import drive_to_completion
    from risingwave_tpu_torch.utils.device import LAUNCHES

    def run():
        out = asyncio.run(drive_to_completion(p, targets, in_flight=2))
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
            elapsed, rows = run()
            host.disable()
            wall = time.perf_counter() - t0     # not the trace's teardown
        # the rule of the profiler's own table: device events' self time
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        stats = pstats.Stats(host)
        traced = dict(device_busy_ms=busy_us / 1e3 if busy_us else None,
                      device_idle_share=(1 - busy_us / 1e6 / wall
                                         if busy_us else None),
                      host_self_s=host_split(stats))
        parallel = mesh_host_fns(stats)
        if parallel:
            traced["parallel_cum_s"] = parallel
    else:
        t0 = time.perf_counter()
        elapsed, rows = run()
        wall = time.perf_counter() - t0
    lat = np.asarray(p.loop.stats.latencies_s)
    return dict(events=rows, elapsed_s=elapsed, wall_s=wall,
                events_per_s=rows / elapsed,
                p99_barrier_latency_s=p.loop.stats.p99_latency_s(),
                barrier_latency_s={
                    "p50": float(np.percentile(lat, 50)),
                    "p90": float(np.percentile(lat, 90)),
                    "max": float(lat.max())},
                barriers=len(lat), launches=LAUNCHES.snapshot(), **traced)


def mv_digest(rows) -> str:
    """Order-free digest of MV rows (fused and unfused runs compare by
    it)."""
    import hashlib
    h = hashlib.sha256()
    for r in sorted(rows):
        h.update(repr(r).encode())
    return h.hexdigest()[:16]


def run_q7(dev, events: int, trace: bool = False,
           fusion: bool = False, tier_cap=None) -> dict:
    """q7-core through build_q7 + drive_to_completion; the MV must equal
    the oracle. With ``fusion`` the agg must have absorbed the tumble
    projection; with ``tier_cap`` the agg runs under the cold tier."""
    from risingwave_tpu_torch.common.types import Interval
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.models.nexmark import build_q7
    from risingwave_tpu_torch.state.store import MemoryStateStore

    cfg = NexmarkConfig(event_num=events, max_chunk_size=8192,
                        generate_strings=False)
    p = build_q7(MemoryStateStore(), cfg, rate_limit=32, min_chunks=32,
                 watermark_delay=Interval(usecs=0), device=dev,
                 fusion=fusion, tier_cap=tier_cap)
    agg = p.actor.consumer.input
    assert (agg.fused_stages is not None) == fusion, "fusion did not fire"
    n_bids = events * 46 // 50
    out = drive(p, {1: n_bids}, dev, trace)
    got = {r[0]: (r[1], r[2]) for _pk, r in p.mv_table.iter_rows()}
    want = q7_oracle(cfg, n_bids)
    assert got == want, "q7 MV differs from the oracle"
    assert p.reader.offset == n_bids
    extra = {}
    if tier_cap is not None:
        part = agg._tier_part
        assert part.evicted_total > 0 and part.reload_total > 0, \
            "q7 under the tier neither evicted nor reloaded"
        extra = dict(evicted=part.evicted_total, reloaded=part.reload_total,
                     resident=len(part.keys))
    return dict(out, windows=len(got), mv_digest=mv_digest(got.items()),
                **extra)


_ORACLES: dict = {}       # one oracle per path and size, shared by its arms


def q8_oracle(cfg, n_persons: int, n_auctions: int,
              block: int = 1 << 21) -> set:
    """persons ⋈ distinct (seller, window) of auctions on id = seller and
    the same window, vectorized per block: (id, name, window) rows;
    computed once per size (the four q8 arms share it)."""
    key = ("q8", cfg.event_num, n_persons, n_auctions)
    if key not in _ORACLES:
        _ORACLES[key] = _q8_oracle(cfg, n_persons, n_auctions, block)
    return _ORACLES[key]


def _q8_oracle(cfg, n_persons: int, n_auctions: int, block: int) -> set:
    from risingwave_tpu_torch.connectors.nexmark import (
        gen_auctions, gen_persons,
    )
    from risingwave_tpu_torch.models.nexmark import DEFAULT_WINDOW
    w = DEFAULT_WINDOW.usecs
    sellers = []
    for lo in range(0, n_auctions, block):
        a = gen_auctions(np.arange(lo, min(lo + block, n_auctions),
                                   dtype=np.int64), cfg)
        sellers.append(np.unique((a["seller"] << 32)
                                 | (a["date_time"] // w)))
    sellers = np.unique(np.concatenate(sellers))
    out = set()
    for lo in range(0, n_persons, block):
        ps = gen_persons(np.arange(lo, min(lo + block, n_persons),
                                   dtype=np.int64), cfg)
        m = np.isin((ps["id"] << 32) | (ps["date_time"] // w), sellers)
        win = (ps["date_time"][m] // w) * w
        out.update(zip(ps["id"][m].tolist(), ps["name"][m].tolist(),
                       win.tolist()))
    return out


def run_q8(dev, events: int, trace: bool = False,
           fusion: bool = False, mesh: bool = False) -> dict:
    """q8 through build_q8 + drive_to_completion at bench.py's q8 shape;
    the MV must equal the oracle exactly. With ``fusion`` both join sides
    and the dedup agg must have absorbed their projections; with ``mesh``
    the join runs over MESH_SHARDS logical shards (ShardedJoinKernel at
    its defaults) and launches are also given per barrier."""
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.models.nexmark import build_q8
    from risingwave_tpu_torch.parallel import ShardedJoinKernel, ShardMesh
    from risingwave_tpu_torch.state.store import MemoryStateStore

    base = NexmarkConfig(event_num=events, max_chunk_size=4096,
                         generate_strings=False)
    cfg_p = NexmarkConfig(**{**base.__dict__, "table_type": "person"})
    cfg_a = NexmarkConfig(**{**base.__dict__, "table_type": "auction"})
    p = build_q8(MemoryStateStore(), cfg_p, cfg_a, rate_limit=16,
                 min_chunks=16, device=dev, fusion=fusion,
                 mesh=ShardMesh(MESH_SHARDS, dev) if mesh else None)
    join = p.actor.consumer.input.input
    assert all(isinstance(s.kernel, ShardedJoinKernel) == mesh
               for s in join.sides)
    fired = [s.fused_input is not None for s in join.sides] + \
        [getattr(join.right_in, "fused_stages", None) is not None]
    assert fired == [fusion] * 3, f"fusion fired as {fired}"
    n_p, n_a = events // 50, events * 3 // 50
    out = drive(p, {1: n_p, 2: n_a}, dev, trace)
    rows = [tuple(r) for _pk, r in p.mv_table.iter_rows()]
    want = q8_oracle(base, n_p, n_a)
    assert len(rows) == len(want) and set(rows) == want, \
        "q8 MV differs from the oracle"
    assert p.readers[1].offset == n_p and p.readers[2].offset == n_a
    extra = {}
    if mesh:
        extra = dict(shards=MESH_SHARDS, per_barrier={
            k: v / out["barriers"] for k, v in out["launches"].items()},
            routed_steps=[s.kernel.dispatches for s in join.sides])
    return dict(out, mv_rows=len(rows), mv_digest=mv_digest(rows),
                key_capacity=[getattr(s.kernel, "key_capacity", None)
                              or s.kernel.table.capacity
                              for s in join.sides],
                row_capacity=[s.kernel.row_capacity for s in join.sides],
                stored_rows=[s.next_ref for s in join.sides],
                dead_refs=[len(s.free) for s in join.sides], **extra)


def run_q1(dev, events: int, fusion: bool) -> dict:
    """q1 through build_q1 + drive_to_completion at bench.py's bench_q1
    shape (strings on); the MV, read without ``_row_id``, must equal the
    oracle (0.908 * price as DECIMAL: price * 9080 scaled), and the row
    ids must be unique. With ``fusion`` the row-id generation and the
    projection must be one FusedFragmentExecutor."""
    from risingwave_tpu_torch.connectors.nexmark import (
        NexmarkConfig, gen_bids,
    )
    from risingwave_tpu_torch.models.nexmark import build_q1
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from risingwave_tpu_torch.stream.executors.fused import (
        FusedFragmentExecutor,
    )

    cfg = NexmarkConfig(event_num=events, max_chunk_size=4096)
    p = build_q1(MemoryStateStore(), cfg, rate_limit=16, min_chunks=16,
                 device=dev, fusion=fusion)
    assert isinstance(p.actor.consumer.input, FusedFragmentExecutor) \
        == fusion, "fusion did not fire"
    n_bids = events * 46 // 50
    out = drive(p, {1: n_bids}, dev, trace=False)
    t0 = time.perf_counter()
    rows = np.asarray([r for _pk, r in p.mv_table.iter_rows()],
                      dtype=np.int64)
    got = rows[np.lexsort(rows[:, :4].T[::-1]), :4]
    key = ("q1", events)
    if key not in _ORACLES:             # both q1 arms share the oracle
        b = gen_bids(np.arange(n_bids, dtype=np.int64), cfg)
        want = np.stack([b["auction"], b["bidder"], b["price"] * 9080,
                         b["date_time"]], axis=1)
        _ORACLES[key] = want[np.lexsort(want.T[::-1])]
    want = _ORACLES[key]
    assert got.shape == want.shape and (got == want).all(), \
        "q1 MV differs from the oracle"
    assert len(np.unique(rows[:, 4])) == n_bids, "row ids not unique"
    h = __import__("hashlib").sha256(got.tobytes()).hexdigest()[:16]
    return dict(out, mv_rows=len(rows), mv_digest=h,
                mv_check_s=time.perf_counter() - t0)


# -- phase 3, the fused preludes ----------------------------------------------

def _fused_time(fn, plain, prog, n_rows) -> dict:
    from risingwave_tpu_torch.ops import fused as F
    b, by = bound_ms(F.bound_bytes(prog, n_rows), 0)
    return dict(ms=time_ms(fn), plain_ms=time_ms(plain), bound_ms=b,
                bound_by=by)


def check_fused_random(dev) -> dict:
    """Each entry point on random expression trees over every device type
    (every opcode appears across the seeds), edge values included, 2^15
    rows with U-/U+ pairs and separator rows: the kernel against the
    plain program on the same card tensors, exact (a NaN equal to a
    NaN), the stage counts exact; agg_prelude also in MESH_SHARDS
    segments (a pair may start at every fifth row, so some seeds put one
    across a block edge; check_prelude_segments puts one on each)."""
    from risingwave_tpu_torch.ops import fused as F
    from risingwave_tpu_torch.ops import fused_cases as FC
    err = {"fused_chain": 0.0, "agg_prelude": 0.0, "join_prelude": 0.0}
    ops = set()
    for seed in range(FUSED_SEEDS):
        fs, chunk = FC.port_case(seed, FUSED_ROWS, True, separators=64,
                                 subnormals=True)
        raw = torch.from_numpy(F.encode_raw_chunk(chunk, fs.ref_cols)) \
            .to(dev)
        hs = fs.host_noop_eq(chunk)
        hs = torch.from_numpy(hs.astype(np.int8)).to(dev)
        nan_rows = FC.nan_rows_of(fs, chunk)
        progs = {"fused_chain": F.compile_program(fs, F.MODE_CHAIN)}
        g, calls, specs = FC.agg_plan(fs, seed)
        progs["agg_prelude"] = F.compile_program(
            fs, F.MODE_AGG, group_indices=g, agg_calls=calls, specs=specs)
        keys, pays = FC.join_plan(fs, seed)
        progs["join_prelude"] = F.compile_program(
            fs, F.MODE_JOIN, key_indices=keys, pay_indices=pays)
        for name, prog in progs.items():
            ops |= prog.opcodes()
            ck = torch.zeros(prog.n_counts, dtype=torch.int64,
                             device=dev)
            cp = ck.clone()
            if name == "fused_chain":
                got = F.fused_chain(prog, raw, hs, ck)
            elif name == "agg_prelude":
                got = F.agg_prelude(prog, raw, ck)
            else:
                got = F.join_prelude(prog, raw)
            want = F.run_program_plain(
                prog, raw, hs if name == "fused_chain" else None, cp)
            e = FC.mismatch(prog, got.cpu().numpy(), want.cpu().numpy(),
                            nan_rows)
            e = max(e, abs_err(ck.cpu().numpy(), cp.cpu().numpy()))
            assert e == 0, f"{name} differs from its plain version " \
                f"on seed {seed}: {e}"
            if name == "agg_prelude":
                # the q7-mesh fused step's form: each shard block a ring
                seg = FUSED_ROWS // MESH_SHARDS
                ck.zero_()
                cp.zero_()
                got = F.agg_prelude(prog, raw, ck, seg=seg)
                want = F.run_program_plain(prog, raw, None, cp, seg=seg)
                e = max(e, FC.mismatch(prog, got.cpu().numpy(),
                                       want.cpu().numpy(), nan_rows),
                        abs_err(ck.cpu().numpy(), cp.cpu().numpy()))
                assert e == 0, f"segmented agg_prelude differs from its " \
                    f"plain version on seed {seed}: {e}"
            err[name] = max(err[name], e)
    assert ops == set(range(F.OP_EXTRACT_EPOCH + 1)), \
        f"opcodes not covered: {set(range(F.OP_EXTRACT_EPOCH + 1)) - ops}"
    return err


def _source_chunks(cfg, n_chunks: int) -> list:
    from risingwave_tpu_torch.connectors.nexmark import NexmarkSplitReader
    reader = NexmarkSplitReader(cfg)
    return [reader.next_chunk() for _ in range(n_chunks)]


def path_programs(dev) -> dict:
    """The fused path's own programs, each with a raw input at the
    path's shape: q7's agg prelude over a 2^15-row backlog (three
    8192-row bid chunks, separator rows, zero padding), q8's dedup agg
    prelude over a 2^15-row auction backlog, q8's two join preludes over
    2^16-row side-epochs, q1's block over one 4096-row bid chunk."""
    from risingwave_tpu_torch.common.chunk import (
        Column, StreamChunk, next_pow2,
    )
    from risingwave_tpu_torch.common.types import Interval
    from risingwave_tpu_torch.connectors.nexmark import (
        NexmarkConfig, gen_auctions,
    )
    from risingwave_tpu_torch.models.nexmark import (
        DEFAULT_WINDOW, build_q1, build_q7, build_q8,
    )
    from risingwave_tpu_torch.ops import fused as F
    from risingwave_tpu_torch.state.store import MemoryStateStore

    def backlog(chunks, fs, rows):
        mats = []
        for c in chunks:
            mats.append(F.encode_raw_chunk(c, fs.ref_cols))
            mats.append(np.zeros((1, mats[-1].shape[1]), np.int64))
        m = np.concatenate(mats)
        out = np.zeros((rows, m.shape[1]), np.int64)
        out[:min(rows, len(m))] = m[:rows]
        return torch.from_numpy(out).to(dev)

    def agg_prog(agg):
        return F.compile_program(agg.fused_stages, F.MODE_AGG,
                                 group_indices=agg.group_indices,
                                 agg_calls=agg.agg_calls, specs=agg.specs)

    bid = NexmarkConfig(event_num=1 << 40, max_chunk_size=8192,
                        generate_strings=False)
    q7 = build_q7(MemoryStateStore(), bid, watermark_delay=Interval(usecs=0),
                  device=dev, fusion=True).actor.consumer.input
    out = {"q7 agg_prelude": (agg_prog(q7), backlog(
        _source_chunks(bid, 3), q7.fused_stages, N))}
    base = NexmarkConfig(event_num=1 << 40, max_chunk_size=4096,
                         generate_strings=False)
    cfg_p = NexmarkConfig(**{**base.__dict__, "table_type": "person"})
    cfg_a = NexmarkConfig(**{**base.__dict__, "table_type": "auction"})
    join = build_q8(MemoryStateStore(), cfg_p, cfg_a, device=dev,
                    fusion=True).actor.consumer.input.input
    dedup = join.right_in
    out["q8 dedup agg_prelude"] = (agg_prog(dedup), backlog(
        _source_chunks(cfg_a, 7), dedup.fused_stages, N))
    left, right = join.sides
    p_chunks = _source_chunks(cfg_p, J_N // 4096)
    out["q8 persons join_prelude"] = (left.prelude, torch.from_numpy(
        np.concatenate([F.encode_raw_chunk(c, left.fused_input.ref_cols)
                        for c in p_chunks])).to(dev))
    a = gen_auctions(np.arange(J_N, dtype=np.int64), cfg_a)
    w = DEFAULT_WINDOW.usecs
    sch = right.fused_input.in_schema
    agg_out = StreamChunk(sch, [
        Column(sch[0].data_type, a["seller"]),
        Column(sch[1].data_type, a["date_time"] - a["date_time"] % w),
        Column(sch[2].data_type, np.ones(J_N, np.int64))],
        np.ones(J_N, bool), np.ones(J_N, np.int8))
    out["q8 auctions join_prelude"] = (right.prelude, torch.from_numpy(
        F.encode_raw_chunk(agg_out, right.fused_input.ref_cols)).to(dev))
    q1cfg = NexmarkConfig(event_num=1 << 40, max_chunk_size=4096)
    block = build_q1(MemoryStateStore(), q1cfg, device=dev,
                     fusion=True).actor.consumer.input
    fs = block.fused_stages
    for st in fs.stages:
        if st.kind == "row_id_gen":
            st.runtime._rebase(1 << 32)
    aug = fs.augment(_source_chunks(q1cfg, 1)[0])
    assert next_pow2(aug.capacity) == 4096
    out["q1 fused_chain"] = (F.compile_program(fs, F.MODE_CHAIN),
                             torch.from_numpy(F.encode_raw_chunk(
                                 aug, fs.ref_cols)).to(dev))
    return out


def check_fused_paths(dev, err: dict) -> dict:
    """q1's, q7's and q8's programs at the path's shapes: exact against
    the plain program, then timed (the kernel and its plain version on
    the card) beside the byte bound. The entry point's reported time is
    the main path's: q7's agg prelude, q8's persons-side join prelude,
    q1's block; the others are logged."""
    from risingwave_tpu_torch.ops import fused as F
    results = {}
    for label, (prog, raw) in path_programs(dev).items():
        name = label.split()[-1]
        fn = {"fused_chain": F.fused_chain, "agg_prelude": F.agg_prelude,
              "join_prelude": F.join_prelude}[name]
        got = fn(prog, raw)
        want = F.run_program_plain(prog, raw)
        e = abs_err(got.cpu().numpy(), want.cpu().numpy())
        assert e == 0, f"{label} differs from its plain version: {e}"
        t = _fused_time(lambda: fn(prog, raw),
                        lambda: F.run_program_plain(prog, raw), prog,
                        int(raw.shape[0]))
        log(f"{label}: {int(raw.shape[0])} raw rows of width "
            f"{int(raw.shape[1])} -> {prog.out_width} lanes: "
            + json.dumps(t))
        if label == "q7 agg_prelude":
            e = max(e, check_prelude_segments(prog, raw))
        if label in ("q7 agg_prelude", "q8 persons join_prelude",
                     "q1 fused_chain"):
            results[name] = dict(max_abs_err=max(err[name], e), **t)
    return results


def check_prelude_segments(prog, raw) -> float:
    """q7's agg prelude as the q7-mesh fused step launches it: the 2^15-row
    backlog as MESH_SHARDS rings of N / MESH_SHARDS rows (each shard
    block's ±1 neighbour rolls wrap inside the block), exact against the
    plain program with the same segments, outputs and stage counts. Twice:
    on the backlog as it is (insert-only), and with visible U-/U+ pairs
    straddling every block edge and the batch's wrap (half of them equal
    in every column, noop pairs) plus one inside each block. Then timed."""
    from risingwave_tpu_torch.ops import fused as F
    seg = N // MESH_SHARDS
    paired = raw.cpu().numpy().copy()
    edges = [k * seg for k in range(MESH_SHARDS)]
    for j, e in enumerate(edges):
        for a in (e - 1, e + seg // 2):
            b = (a + 1) % N
            paired[a, 0], paired[b, 0] = 3, 4
            paired[a, 1] = paired[b, 1] = 1
            if j % 2:
                paired[b, 2:] = paired[a, 2:]
    err = 0.0
    for x in (raw, torch.from_numpy(paired).to(raw.device)):
        ck = torch.zeros(prog.n_counts, dtype=torch.int64, device=x.device)
        cp = ck.clone()
        got = F.agg_prelude(prog, x, ck, seg=seg)
        want = F.run_program_plain(prog, x, None, cp, seg=seg)
        err = max(err, abs_err(got.cpu().numpy(), want.cpu().numpy()),
                  abs_err(ck.cpu().numpy(), cp.cpu().numpy()))
        assert err == 0, f"q7's segmented agg_prelude differs: {err}"
    t = _fused_time(lambda: F.agg_prelude(prog, raw, seg=seg),
                    lambda: F.run_program_plain(prog, raw, seg=seg), prog,
                    int(raw.shape[0]))
    log(f"q7 agg_prelude in {MESH_SHARDS} segments of {seg} rows, "
        f"U-/U+ pairs across every block edge: exact; " + json.dumps(t))
    return err


# -- phase 3, the sharded path: route and the shard axis of K1-K4 ----------------

def _mesh_step(dev, specs, packed_np, kernels: bool):
    """One routed step of the sharded agg at MESH_SHARDS shards of
    MESH_CAP slots, all through the kernels or all through the plain
    versions: (state, recv, rvalid, slots)."""
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.parallel import exchange as X
    from risingwave_tpu_torch.parallel.mesh import contiguous_owner_map
    s = MESH_SHARDS
    packed = torch.from_numpy(packed_np).to(dev)
    omap = torch.from_numpy(contiguous_owner_map(s)).to(dev)
    route = X.route if kernels else X.route_plain
    recv, rvalid, ovf = route(packed, packed[:, KW + 1], omap, s,
                              packed.shape[0] // s, KW)
    assert not bool(ovf.any())
    st = H.make_sharded_agg_state(s, MESH_CAP, KW, specs, dev)
    probe = H.ht.probe_insert_sharded if kernels \
        else H.ht.probe_insert_sharded_plain
    slots, stats = probe(st.table, recv[:, :, :KW], rvalid)
    assert not bool(stats[:, 1].any()), "probe overflow"
    plan = H.ApplyPlan(KW, specs, dev)
    (H.agg_apply_sharded if kernels else H.agg_apply_sharded_plain)(
        st, recv, slots, plan)
    return st, recv, rvalid, slots


def _flush_rows(H, st, fc) -> np.ndarray:
    """Every shard's flushed dirty rows, without the slot column, sorted
    by key: the kernels' slots differ from the plain rule's (K1)."""
    mats = H.flush_gather_sharded(st, fc).cpu().numpy()
    out = []
    for d in range(mats.shape[0]):
        assert mats[d, 0, 0] <= fc
        out.append(mats[d, 1:1 + mats[d, 0, 0], 1:])
    st_rows = np.concatenate(out)
    return st_rows[np.lexsort(st_rows[:, :KW].T[::-1])]


def check_route(dev) -> dict:
    """route against route_plain bit for bit on a q7-mesh step (a 2^15-row
    packed batch in 8 blocks, bucket = local), on the mixed plan's batch
    and with a forced overflow (bucket 64); timed on the q7 step."""
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.parallel import exchange as X
    from risingwave_tpu_torch.parallel.mesh import contiguous_owner_map
    s = MESH_SHARDS
    omap = torch.from_numpy(contiguous_owner_map(s)).to(dev)
    q7 = make_specs(H, [("max", np.int64), ("count", None)])
    mixed = make_specs(H, [("sum", np.int64), ("sum", np.float64),
                           ("min", np.int64), ("count", None)])
    err = 0.0
    for packed_np, bucket in ((q7_batch(N, q7), N // s),
                              (mixed_batch(N, mixed, groups=MESH_GROUPS),
                               N // s),
                              (mixed_batch(N, mixed, groups=MESH_GROUPS),
                               64)):
        packed = torch.from_numpy(packed_np).to(dev)
        got = X.route(packed, packed[:, KW + 1], omap, s, bucket, KW)
        want = X.route_plain(packed, packed[:, KW + 1], omap, s, bucket, KW)
        for g, w in zip(got, want):
            err = max(err, abs_err(g.cpu().numpy(), w.cpu().numpy()))
        assert err == 0, f"route differs from route_plain: {err}"
        assert bool(got[2].any()) == (bucket == 64), "overflow flag"
    packed = torch.from_numpy(q7_batch(N, q7)).to(dev)
    valid = packed[:, KW + 1]
    ms = time_ms(lambda: X.route(packed, valid, omap, s, N // s, KW))
    plain_ms = time_ms(lambda: X.route_plain(packed, valid, omap, s,
                                             N // s, KW))
    b, by = bound_ms(X.bound_bytes(N, packed.shape[1], s, N // s), N * 16)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


def check_sharded(dev) -> dict:
    """The shard axis of K1-K4 at MESH_SHARDS x MESH_CAP slots: on q7's
    step and on the mixed plan over MESH_GROUPS groups. K1 by the table
    invariants shard by shard; K2-K4 exact against their plain versions
    on the same slots (float SUM within rel FLOAT_SUM_RTOL of Σ|terms|);
    the whole q7 step through the kernels against it through the plain
    versions as key-sorted flushes; then a reshard to a rotated owner
    map, snapshots equal before and after. Returns per-kernel timings at
    q7's step (logged beside the single-device rows)."""
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.parallel import ShardedAggKernel, ShardMesh
    s, cap = MESH_SHARDS, MESH_CAP
    mixed = make_specs(H, [("sum", np.int64), ("sum", np.float64),
                           ("min", np.int64), ("count", None)])
    mixed_np = mixed_batch(MESH_ROWS, mixed, groups=MESH_GROUPS)
    st, recv, rvalid, slots = _mesh_step(dev, mixed, mixed_np, True)
    ref, _r, _v, _sl = _mesh_step(dev, mixed, mixed_np, False)
    occ = (st.table.occ != 0).sum(dim=1).cpu().numpy()
    assert (occ == (ref.table.occ != 0).sum(dim=1).cpu().numpy()).all()
    err = 0.0
    for d in range(s):
        sl = slots[d].cpu().numpy()
        v = rvalid[d].cpu().numpy() != 0
        keys = recv[d, :, :KW].cpu().numpy()
        tk = st.table.keys[d].cpu().numpy()
        assert (sl[~v] == -1).all() and (sl[v] >= 0).all()
        err = max(err, abs_err(tk[sl[v]], keys[v]))

        def keyset(t):
            x = t.keys[d].cpu().numpy()[t.occ[d].cpu().numpy() != 0]
            return x[np.lexsort(x.T[::-1])]
        err = max(err, abs_err(keyset(st.table), keyset(ref.table)))
    assert err == 0, "a shard's table differs from the plain version's"
    log(f"sharded state: {int(occ.sum())} groups over {s} shards of {cap} "
        f"slots (fullest {int(occ.max())})")
    # K2 again on the kernel's slots: exact integers, float SUM bounded
    plan = H.ApplyPlan(KW, mixed, dev)
    fresh = H.make_sharded_agg_state(s, cap, KW, mixed, dev).st
    a = H.ShardedAggState(st.table, fresh.clone())
    b = H.ShardedAggState(st.table, fresh.clone())
    H.agg_apply_sharded(a, recv, slots, plan)
    H.agg_apply_sharded_plain(b, recv, slots, plan)
    x, y = a.st.cpu().numpy(), b.st.cpu().numpy()
    frows = [H.ROW_ACC0 + 4 + 1, H.ROW_ACC0 + 4 + 1 + 1]
    ints = [r for r in range(x.shape[1]) if r not in frows]
    err = max(err, abs_err(x[:, ints], y[:, ints]))
    assert err == 0, "sharded agg_apply integers differ"
    fe = 0.0
    for d in range(s):
        fe = max(fe, float_sum_err(H, x[d], y[d], recv[d].cpu().numpy(),
                                   slots[d].cpu().numpy(), mixed, 1, frows,
                                   cap))
    for fc in (1 << 14, 1 << 10):      # the second one overflows
        err = max(err, abs_err(H.flush_gather_sharded(b, fc).cpu().numpy(),
                               H.flush_gather_sharded_plain(b, fc)
                               .cpu().numpy()))
    c = H.ShardedAggState(b.table, b.st.clone())
    H.advance_sharded(c)
    for d in range(s):
        H.advance_plain(b.shard(d))
    err = max(err, abs_err(c.st.cpu().numpy(), b.st.cpu().numpy()))
    hi, lo = lanes_split(10_000 * 7_919)
    fill = torch.tensor(H.state_fills(mixed), dtype=torch.int32, device=dev)
    for mode in (H.LIVE_GROW, H.LIVE_RETIRE):
        live = H.live_mask_sharded(b, mode, 0, hi, lo)
        want = torch.stack([H.live_mask_plain(b.shard(d), mode, 0, hi, lo)
                            for d in range(s)])
        err = max(err, abs_err(live.cpu().numpy(), want.cpu().numpy()))
    table = H.ht.TableState(
        torch.zeros((s, 2 * cap, KW), dtype=torch.int32, device=dev),
        torch.zeros((s, 2 * cap), dtype=torch.int32, device=dev))
    o2n, _st = H.ht.probe_insert_sharded(table, b.table.keys, live)
    err = max(err, abs_err(
        H.remap_sharded(b.st, o2n, table.occ, fill, 2 * cap).cpu().numpy(),
        torch.stack([H.remap_plain(b.st[d], o2n[d], table.occ[d], fill,
                                   2 * cap) for d in range(s)])
        .cpu().numpy()))
    assert err == 0, f"sharded K3/K4 differ from their plain versions: {err}"
    # q7's step, kernels end to end against plain versions end to end
    q7 = make_specs(H, [("max", np.int64), ("count", None)])
    q7_np = q7_batch(N, q7)
    qk, qrecv, qvalid, qslots = _mesh_step(dev, q7, q7_np, True)
    qp, _r, _v, _s = _mesh_step(dev, q7, q7_np, False)
    err = max(err, abs_err(_flush_rows(H, qk, 1 << 10),
                           _flush_rows(H, qp, 1 << 10)))
    assert err == 0, "q7's sharded step differs from the plain versions'"
    # reshard of the mixed state to a rotated owner map: every group's
    # whole state row moves, bit for bit
    kern = ShardedAggKernel(ShardMesh(s, dev), KW, mixed, capacity=cap)
    kern.state = H.ShardedAggState(a.table, a.st.clone())
    before = _groups(kern.state)
    t0 = time.perf_counter()
    kern.reshard(np.roll(kern.mesh.owner_map(), 37))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    reshard_s = time.perf_counter() - t0
    after = _groups(kern.state)
    err = max(err, abs_err(before, after))
    assert err == 0, "reshard changed the groups"
    log(f"reshard of {len(before)} groups to a rotated owner map: "
        f"{reshard_s:.6f} s wall; snapshots equal")
    # timings at q7's step (8 shards: each shard receives the whole
    # 2^15-row batch, most of it rows routed elsewhere)
    # The byte bounds charge every received row its valid flag (K1) or
    # its slot (K2) and its slot write (K1), and only the valid rows
    # their key lanes (K1) or their whole packed row (K2): with bucket =
    # local, about 7/8 of each shard's m received rows are empty.
    qplan = H.ApplyPlan(KW, q7, dev)
    w = qrecv.shape[2]
    m = qrecv.shape[1]
    valid = int(qvalid.sum())
    qsl = qslots.cpu().numpy()
    distinct = sum(len(np.unique(qsl[d][qsl[d] >= 0])) for d in range(s))
    t = {}

    def timed(name, fn, plain, nbytes, ops):
        bd, by = bound_ms(nbytes, ops)
        t[name] = dict(ms=time_ms(fn), plain_ms=time_ms(plain), bound_ms=bd,
                       bound_by=by)
    timed("probe_insert",
          lambda: H.ht.probe_insert_sharded(qk.table, qrecv[:, :, :KW],
                                            qvalid),
          lambda: H.ht.probe_insert_sharded_plain(qk.table, qrecv[:, :, :KW],
                                                  qvalid),
          s * m * 4 + valid * KW * 4 + s * m * 4 + s * 8
          + distinct * (KW + 1) * 4, valid * 14 * KW)
    qa = H.ShardedAggState(qk.table, qk.st.clone())
    timed("agg_apply",
          lambda: H.agg_apply_sharded(qa, qrecv, qslots, qplan),
          lambda: H.agg_apply_sharded_plain(qa, qrecv, qslots, qplan),
          s * m * 4 + valid * w * 4 + distinct * (2 + 4) * 4 * 2,
          valid * 12)
    r = qk.st.shape[1]
    wout = H.flush_width(KW, qk.n_acc)
    timed("flush_gather", lambda: H.flush_gather_sharded(qk, 1 << 10),
          lambda: H.flush_gather_sharded_plain(qk, 1 << 10),
          s * cap * 8 + s * (1 + (1 << 10)) * wout * 4, s * cap * 4)
    timed("advance", lambda: H.advance_sharded(qa),
          lambda: [H.advance_plain(qa.shard(d)) for d in range(s)],
          s * cap * 4, s * cap)
    timed("live_mask", lambda: H.live_mask_sharded(qk, H.LIVE_RETIRE, 0),
          lambda: torch.stack([H.live_mask_plain(qk.shard(d),
                                                 H.LIVE_RETIRE, 0)
                               for d in range(s)]),
          s * cap * 8, s * cap * 8)
    qlive = H.live_mask_sharded(qk, H.LIVE_RETIRE, 0)
    qt = H.ht.TableState(
        torch.zeros((s, cap, KW), dtype=torch.int32, device=dev),
        torch.zeros((s, cap), dtype=torch.int32, device=dev))
    qo2n, _q = H.ht.probe_insert_sharded(qt, qk.table.keys, qlive)
    qfill = torch.tensor(H.state_fills(q7), dtype=torch.int32, device=dev)
    timed("remap", lambda: H.remap_sharded(qk.st, qo2n, qt.occ, qfill, cap),
          lambda: torch.stack([H.remap_plain(qk.st[d], qo2n[d], qt.occ[d],
                                             qfill, cap) for d in range(s)]),
          s * cap * 8 + s * r * cap * 4, s * cap * r)
    return dict(max_abs_err=max(err, fe), timings=t, reshard_s=reshard_s)


def _groups(st) -> np.ndarray:
    """Every occupied slot's key lanes and state column, over all
    shards, sorted by key: the sharded state's snapshot, slot-free."""
    keys = st.table.keys.cpu().numpy()
    occ = st.table.occ.cpu().numpy() != 0
    cols = st.st.cpu().numpy().transpose(0, 2, 1)
    rows = np.concatenate([keys[occ], cols[occ]], axis=1)
    return rows[np.lexsort(rows[:, :KW].T[::-1])]


def lanes_split(v: int) -> tuple:
    from risingwave_tpu_torch.ops import lanes
    hi, lo = lanes.split_i64(np.asarray([v], dtype=np.int64))
    return int(hi[0]), int(lo[0])


# -- phase 4: q7 over 8 shards ----------------------------------------------------

def _q7_mesh(dev, store, events: int, fusion: bool):
    from risingwave_tpu_torch.common.types import Interval
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.models.nexmark import build_q7
    from risingwave_tpu_torch.parallel import ShardedAggKernel, ShardMesh
    cfg = NexmarkConfig(event_num=events, max_chunk_size=4096,
                        generate_strings=False)
    p = build_q7(store, cfg, rate_limit=16, min_chunks=16,
                 watermark_delay=Interval(usecs=0), device=dev,
                 fusion=fusion, mesh=ShardMesh(MESH_SHARDS, dev))
    agg = p.actor.consumer.input
    assert isinstance(agg.kernel, ShardedAggKernel)
    assert (agg.fused_stages is not None) == fusion, "fusion did not fire"
    return p, cfg, agg


def run_q7_mesh(dev, events: int, trace: bool = False,
                fusion: bool = False) -> dict:
    """q7-core over MESH_SHARDS logical shards through build_q7(mesh=...)
    + drive_to_completion at bench.py's mesh lane shape (4096-row chunks,
    16 per epoch, no strings, watermark retirement on, two barriers in
    flight); the MV must equal the oracle. With ``fusion`` the prelude
    must sit on the sharded kernel."""
    from risingwave_tpu_torch.state.store import MemoryStateStore
    p, cfg, agg = _q7_mesh(dev, MemoryStateStore(), events, fusion)
    n_bids = events * 46 // 50
    out = drive(p, {1: n_bids}, dev, trace)
    assert (agg.kernel._prelude is not None) == fusion, \
        "the prelude is not on the sharded kernel"
    got = {r[0]: (r[1], r[2]) for _pk, r in p.mv_table.iter_rows()}
    assert got == q7_oracle(cfg, n_bids), "q7-mesh MV differs from the oracle"
    k = agg.kernel
    return dict(out, windows=len(got), mv_digest=mv_digest(got.items()),
                shards=k.n_dev, shard_capacity=k.capacity,
                routed_steps_and_gathers=k.dispatches)


def run_q7_mesh_recovery(dev, events: int) -> dict:
    """q7-mesh killed halfway and rebuilt on the same store: a fresh
    pipeline and sharded kernel reload the committed groups, run to the
    end, and the MV equals the oracle. Launch counts cover both halves."""
    from risingwave_tpu_torch.models.nexmark import drive_to_completion
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from risingwave_tpu_torch.utils.device import LAUNCHES
    store = MemoryStateStore()
    n_bids = events * 46 // 50
    LAUNCHES.reset()
    t0 = time.perf_counter()
    p1, _c, _a = _q7_mesh(dev, store, events, False)
    asyncio.run(drive_to_completion(p1, {1: n_bids // 2}, in_flight=2))
    del p1
    p2, cfg, agg = _q7_mesh(dev, store, events, False)
    asyncio.run(drive_to_completion(p2, {1: n_bids}, in_flight=2))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    got = {r[0]: (r[1], r[2]) for _pk, r in p2.mv_table.iter_rows()}
    assert got == q7_oracle(cfg, n_bids), \
        "q7-mesh after recovery differs from the oracle"
    # both halves, set-up included: no warmup epoch is split off here
    return dict(events=n_bids, elapsed_s=wall, windows=len(got),
                launches=LAUNCHES.snapshot(), mv_digest=mv_digest(got.items()))


# -- phase 3, the sharded join: K5 and K6 with a shard axis -------------------

@contextlib.contextmanager
def plain_join_steps():
    """Run ShardedJoinKernel's routed steps through the plain versions
    (route_plain, the sharded K1/K4/K5/K6 plain versions) on the card's
    tensors: a twin of the kernel path with the same host logic."""
    import risingwave_tpu_torch.parallel.join as PJ
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.parallel import exchange as X

    def apply_plain(chains, slots, scratch=None, **kw):
        return J.join_apply_sharded_plain(chains, slots, **kw)

    def remap_plain(src, o2n, occ, fill, cap):
        return torch.stack([H.remap_plain(src[s], o2n[s], occ[s], fill, cap)
                            for s in range(src.shape[0])])
    saved = (PJ.route, PJ.join_apply_sharded, PJ.join_probe_sharded,
             PJ.remap_sharded, ht.probe_insert_sharded)
    PJ.route, PJ.join_apply_sharded = X.route_plain, apply_plain
    PJ.join_probe_sharded = J.join_probe_sharded_plain
    PJ.remap_sharded = remap_plain
    ht.probe_insert_sharded = ht.probe_insert_sharded_plain
    try:
        yield
    finally:
        (PJ.route, PJ.join_apply_sharded, PJ.join_probe_sharded,
         PJ.remap_sharded, ht.probe_insert_sharded) = saved


def _mesh_stage_apply(k, up, aux):
    """One side-epoch through a ShardedJoinKernel's staging (guards,
    skew-exact bucket from per-row owners) and apply; returns the
    staging."""
    up_np, aux_np = up.cpu().numpy(), aux.cpu().numpy()
    mr = int(aux_np[:, 0].max())
    staged = k.stage_epoch(up_np, aux_np, len(up_np), mr,
                           owners=k.owners_of(up_np[:, :JKW]))
    k.apply_epoch(staged[0], staged[1], len(up_np), mr, bucket=staged[2])
    return staged


def build_mesh_join_states(dev) -> dict:
    """q8-mesh's join side: a ShardedJoinKernel over MESH_SHARDS shards at
    its defaults (2^15 slots, 2^17 rows per shard) fed the ~2M stored rows
    of join_epochs through stage_epoch + apply_epoch (route, K1, K5; the
    key tables grow 4x twice: K1 + K4), and its twin through the plain
    versions; then both take the mixed epoch (hot keys, deletes), which
    is K5's check."""
    from risingwave_tpu_torch.parallel import ShardedJoinKernel, ShardMesh
    stored, mixed, fresh, probe, probe_hot = join_epochs(J_EPOCHS, J_N)
    mesh = ShardMesh(MESH_SHARDS, dev)
    ks, kp = ShardedJoinKernel(mesh, JKW), ShardedJoinKernel(mesh, JKW)
    caps = [ks.key_capacity]
    t0 = time.perf_counter()
    for up, aux in stored:
        _mesh_stage_apply(ks, *(torch.from_numpy(x) for x in (up, aux)))
        caps.append(ks.key_capacity)
    ks.drain_overflows()
    built_s = time.perf_counter() - t0
    with plain_join_steps():
        for up, aux in stored:
            _mesh_stage_apply(kp, *(torch.from_numpy(x) for x in (up, aux)))
        kp.drain_overflows()

    def dev_pair(e):
        return tuple(torch.from_numpy(x).to(dev) for x in e)
    return dict(ks=ks, kp=kp, mixed=dev_pair(mixed), fresh=dev_pair(fresh),
                probe=dev_pair(probe), probe_hot=dev_pair(probe_hot),
                caps=caps, built_s=built_s)


def _shard_by_key(k, s) -> tuple:
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import hash_table as ht
    return _by_key(ht.TableState(k.table.keys[s], k.table.occ[s]),
                   J.ChainState(*(c[s] for c in k.chains)))


def _mesh_routed(k, up, aux, bits, probe: bool):
    """The receive block of one side-epoch as the kernel's step routes
    it, with the skew-exact bucket of its routed rows: (recv, rvalid,
    bucket)."""
    from risingwave_tpu_torch.parallel import exchange as X
    up_np, aux_np = up.cpu().numpy(), aux.cpu().numpy()
    m = up.shape[0]
    ow = k.owners_of(up_np[:, :JKW]).astype(np.int64)
    ow[(aux_np[:, 2] & bits) == 0] = -1
    bucket = X.skew_bucket(ow, ow >= 0, k.n_dev, m // k.n_dev)
    if probe:
        rows = torch.cat([up[:, :JKW], torch.arange(
            m, dtype=torch.int32, device=up.device)[:, None], aux[:, 3:4]],
            dim=1)
    else:
        rows = torch.cat([up[:, :JKW], aux], dim=1)
    recv, rvalid, ovf = X.route(rows, (aux[:, 2] & bits) != 0, k.owner_map,
                                k.n_dev, bucket, JKW)
    assert not bool(ovf.any())
    return recv, rvalid, bucket


def check_mesh_join_apply(dev, mj: dict) -> dict:
    """Sharded K5, exact per shard: after the stored epochs and the mixed
    epoch (runs of rows on 8 hot keys, deletes of stored refs, new keys),
    each shard's per-key heads and its ref-indexed next, ins_seq and
    del_seq equal the plain twin's. Timed on the fresh epoch (q8's shape,
    every row a new key) on the slots K1 gave, beside its byte bound:
    every received row is charged its flags, the insert rows their slot,
    ref, sequence and two chain writes, the delete rows their ref,
    sequence and one write, the distinct slots a head read and write."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import hash_table as ht
    ks, kp = mj["ks"], mj["kp"]
    _mesh_stage_apply(ks, *mj["mixed"])
    with plain_join_steps():
        _mesh_stage_apply(kp, *mj["mixed"])
    ks.drain_overflows()
    assert (ks.key_capacity, ks.row_capacity) == \
        (kp.key_capacity, kp.row_capacity)
    err = 0.0
    for s in range(ks.n_dev):
        for a, b in zip(_shard_by_key(ks, s), _shard_by_key(kp, s)):
            err = max(err, abs_err(a, b))
    for a, b in zip(ks.chains[1:], kp.chains[1:]):
        err = max(err, abs_err(a.cpu().numpy(), b.cpu().numpy()))
    assert err == 0, f"sharded join_apply differs from the plain twin: {err}"
    fresh_refs = int(mj["fresh"][1][:, 0].max())
    ks.reserve_rows(fresh_refs)
    kp.reserve_rows(fresh_refs)
    recv, _rv, bucket = _mesh_routed(ks, *mj["fresh"], J.FLAG_INS
                                     | J.FLAG_DEL, probe=False)
    f = recv[:, :, JKW + 2]
    table = ht.TableState(ks.table.keys.clone(), ks.table.occ.clone())
    slots, _st = ht.probe_insert_sharded(table, recv[:, :, :JKW],
                                         f & J.FLAG_INS)
    kw = dict(ins_ok=f, ins_bits=J.FLAG_INS, ins_ref=recv[:, :, JKW],
              del_ok=f, del_bits=J.FLAG_DEL, del_ref=recv[:, :, JKW + 1],
              seq=recv[:, :, JKW + 3])
    kc = J.ChainState(*(t.clone() for t in ks.chains))
    scratch = torch.full(ks.chains.head.shape, -1, dtype=torch.int32,
                         device=dev)
    ms = time_ms(lambda: J.join_apply_sharded(kc, slots, scratch=scratch,
                                              **kw))
    pc = J.ChainState(*(t.clone() for t in kp.chains))
    plain_ms = time_ms(lambda: J.join_apply_sharded_plain(pc, slots, **kw),
                       samples=5, per=1)
    fl = f.cpu().numpy()
    sl = slots.cpu().numpy()
    ins = (fl & J.FLAG_INS) != 0
    n_ins, n_del = int(ins.sum()), int(((fl & J.FLAG_DEL) != 0).sum())
    n_slots = sum(len(np.unique(sl[d][ins[d]])) for d in range(ks.n_dev))
    nbytes = (fl.size * 4 + n_ins * (4 + 4 + 4 + 8) + n_del * (4 + 4 + 4)
              + n_slots * 8)
    b, by = bound_ms(nbytes, fl.size * 4)
    log(f"sharded join_apply: {ks.n_dev} shards, bucket {bucket}, "
        f"{fl.shape[1]} received rows per shard ({n_ins} inserts); key "
        f"slots per shard while building {sorted(set(mj['caps']))}, "
        f"{ks.row_capacity} rows per shard; the stored epochs applied in "
        f"{mj['built_s']:.3f} s wall")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


def check_mesh_join_probe(dev, mj: dict) -> dict:
    """Sharded K6, exact: the q8-like and the hot-key probe epochs through
    the kernel's probe_epoch (route + K6) against the plain twin's, every
    shard's packed matrix; then a per-shard pair buffer of 2^8 that must
    grow and re-dispatch to the same pairs. Timed on the q8-like epoch's
    receive block, beside its byte bound: every received row is charged
    its flag, the probe rows their key lanes, sequence, row id and the
    table's lanes, occupancy and head at their slot, every visited chain
    entry its next, ins_seq and del_seq, and each shard's header and
    each pair written one write (not the unwritten rest of the
    buffer)."""
    from risingwave_tpu_torch.common.chunk import next_pow2
    from risingwave_tpu_torch.ops import hash_join as J
    ks, kp = mj["ks"], mj["kp"]
    cap0 = ks.probe_capacity           # q8-mesh's per-shard pair buffer
    err = 0.0

    def staged(k, which):
        """The probe epoch staged for a probe only (its insert flags
        dropped: nothing here applies it)."""
        up_np, aux_np = (x.cpu().numpy() for x in mj[which])
        aux_np = aux_np.copy()
        aux_np[:, 2] &= J.FLAG_PROBE
        return k.stage_epoch(up_np, aux_np, len(up_np), -1,
                             owners=k.owners_of(up_np[:, :JKW]))
    for which in ("probe", "probe_hot"):
        got, want = [], []
        for k, out in ((ks, got), (kp, want)):
            ctx = plain_join_steps() if k is kp else contextlib.nullcontext()
            with ctx:
                u, a, bucket = staged(k, which)
                pend = k.probe_epoch(u, a, False, bucket=bucket)
                out.append(pend.mats.cpu().numpy())
                out.append(pend.collect())
        err = max(err, abs_err(got[0], want[0]))
        for x, y in zip(got[1], want[1]):
            assert (x is None) == (y is None)
            if x is not None:
                err = max(err, abs_err(x, y))
        assert err == 0, f"sharded join_probe differs on {which}: {err}"
        if which == "probe":
            totals = got[0][:, 0, 0]
            want_pairs = want[1]
    small = max(1, next_pow2(int(totals.max())) // 8)
    ks.probe_capacity = small
    u, a, bucket = staged(ks, "probe")
    got = ks.probe_epoch(u, a, False, bucket=bucket).collect()
    grown = ks.probe_capacity
    assert grown > small, "the per-shard buffer did not overflow"
    for x, y in zip(got, want_pairs):
        if x is not None:
            err = max(err, abs_err(x, y))
    assert err == 0, f"the re-dispatched sharded probe differs: {err}"
    # the hot-key epoch grew the buffer; time at q8-mesh's own
    ks.probe_capacity = cap0
    recv, rv, bucket = _mesh_routed(ks, *mj["probe"], J.FLAG_PROBE,
                                    probe=True)
    out_cap = ks.probe_capacity
    args = (recv[:, :, :JKW], rv, -1, recv[:, :, JKW + 1], out_cap, False)
    kw = dict(rid=recv[:, :, JKW], rvalid=rv)
    ms = time_ms(lambda: J.join_probe_sharded(ks.table, ks.chains, *args,
                                              **kw))
    plain_ms = time_ms(lambda: J.join_probe_sharded_plain(
        kp.table, kp.chains, *args, **kw), samples=5, per=1)
    s, m = rv.shape
    valid = int(rv.sum())
    total = int(totals.sum())
    nbytes = (s * m * 4 + valid * (JKW * 4 + 4 + 4 + JKW * 4 + 4 + 4)
              + total * 12 + s * 2 * 4 + total * 2 * 4)
    b, by = bound_ms(nbytes, valid * 64)
    log(f"sharded join_probe: {total} pairs (worst shard "
        f"{int(totals.max())}) of {valid} probe rows in {s} x {m} received "
        f"rows (bucket {bucket}); a per-shard buffer of {small} grew to "
        f"{grown} and re-dispatched to the same pairs")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


def record_perchunk_steps(dev) -> list:
    """The per-chunk arm's apply_and_probe calls, in order, on the first
    PERCHUNK_STEP_CHUNKS chunks per side of perchunk_script: [(side,
    host arguments)]."""
    from risingwave_tpu_torch.parallel import ShardedJoinKernel
    from risingwave_tpu_torch.stream.executors.test_utils import (
        collect_until_n_barriers,
    )
    sl, sr, nb, _view = perchunk_script(PERCHUNK_STEP_CHUNKS)
    ex = _join_executor(dev, sl, sr, epoch_batch=False)
    calls = []
    orig = ShardedJoinKernel.apply_and_probe

    def recording(self, other, *args):
        calls.append((self, tuple(np.array(a, copy=True) if isinstance(
            a, np.ndarray) else a for a in args)))
        return orig(self, other, *args)
    ShardedJoinKernel.apply_and_probe = recording
    try:
        asyncio.run(collect_until_n_barriers(ex, nb))
    finally:
        ShardedJoinKernel.apply_and_probe = orig
    sides = [side.kernel for side in ex.sides]
    return [(sides.index(k), args) for k, args in calls]


def _kernel_copy(k):
    """A ShardedJoinKernel sharing nothing mutable with ``k``: its table
    and chains cloned, for timing steps that must not touch ``k``."""
    import copy
    from risingwave_tpu_torch.ops import hash_table as ht
    c = copy.copy(k)
    c.table = ht.TableState(k.table.keys.clone(), k.table.occ.clone())
    c.chains = type(k.chains)(*(t.clone() for t in k.chains))
    c._apply_overflows = []
    c._new_scratch()
    return c


def check_mesh_apply_and_probe(dev) -> dict:
    """B16 on the mesh, exact: the per-chunk arm's recorded
    apply_and_probe steps (route; K6 on the other side at the chunk's
    scalar seq, with the degree block and the rid / rvalid row map; K1
    and K5 on this side at that seq) replayed on two fresh pairs of
    ShardedJoinKernel, one through the kernels and one through the plain
    twin. Every step's per-shard matrices (headers, degree blocks,
    pairs) are equal before collect, and so are the collected degrees,
    probe rows and refs; after the last step each side's per-key heads
    per shard and its ref-indexed next, ins_seq and del_seq. The last
    step's device half is timed on a copy of its side's state, whole and
    launch by launch, beside
    its byte bound: the chunk's rows read once, each probe row its
    table slot (lanes, occupancy, head) and degree row, each pair its
    chain entry (next, ins_seq, del_seq) and its write, each shard's
    header, each insert its table slot and two chain writes, each
    distinct insert key a head read and write, each delete one write.
    The receive block is the step's own intermediate and not
    charged."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.parallel import ShardedJoinKernel, ShardMesh
    t0 = time.perf_counter()
    steps = record_perchunk_steps(dev)
    mesh = ShardMesh(MESH_SHARDS, dev)
    kw = steps[0][1][0].shape[1]
    ks = [ShardedJoinKernel(mesh, kw) for _ in range(2)]
    kp = [ShardedJoinKernel(mesh, kw) for _ in range(2)]
    err = 0.0
    n_del = n_null = 0
    for me, args in steps:
        hk = ks[me].apply_and_probe(ks[1 - me], *args)
        with plain_join_steps():
            hp = kp[me].apply_and_probe(kp[1 - me], *args)
        err = max(err, abs_err(hk.mats.cpu().numpy(), hp.mats.cpu().numpy()))
        with plain_join_steps():
            want = hp.collect()
        for a, b in zip(hk.collect(), want):
            err = max(err, abs_err(a, b))
        assert err == 0, f"the sharded apply_and_probe step differs: {err}"
        n_del += int(np.asarray(args[5]).sum())
        n_null += int((~np.asarray(args[1], bool)).sum())
    for side in (0, 1):
        a, b = ks[side], kp[side]
        assert (a.key_capacity, a.row_capacity) == \
            (b.key_capacity, b.row_capacity)
        for d in range(a.n_dev):
            for x, y in zip(_shard_by_key(a, d), _shard_by_key(b, d)):
                err = max(err, abs_err(x, y))
        for x, y in zip(a.chains[1:], b.chains[1:]):
            err = max(err, abs_err(x.cpu().numpy(), y.cpu().numpy()))
    assert err == 0, f"the per-chunk sharded state differs: {err}"
    assert n_del > 0 and n_null > 0, (n_del, n_null)
    checked_s = time.perf_counter() - t0
    me, args = steps[-1]
    lanes, pvis, refs, ins, drefs, dels, seq = args
    kc, pc = _kernel_copy(ks[me]), _kernel_copy(kp[me])
    rows = kc._stage_chunk(lanes, pvis, refs, ins, drefs, dels)[0]
    out_cap = ks[1 - me].probe_capacity
    ms = time_ms(lambda: kc._chunk_step(ks[1 - me], rows, seq, out_cap))
    with plain_join_steps():
        plain_ms = time_ms(lambda: pc._chunk_step(kp[1 - me], rows, seq,
                                                  out_cap),
                           samples=5, per=1)
    mats = kc._chunk_step(ks[1 - me], rows, seq, out_cap)[0].cpu().numpy()
    total = int(mats[:, 0, 0].sum())
    m, s = int(rows.shape[0]), ks[me].n_dev
    # the step's launches one by one, on the same routed rows
    recv, rvalid, _ovf = kc._route(rows, rows[:, kw + 3] != 0, m // s)
    fl = recv[:, :, kw + 3]
    split = {
        "route": time_ms(lambda: kc._route(rows, rows[:, kw + 3] != 0,
                                           m // s)),
        "join_probe": time_ms(lambda: ks[1 - me]._probe_routed(
            recv, rvalid, fl, J.FLAG_PROBE, kw, seq, out_cap, True)),
        "probe_insert + join_apply": time_ms(lambda: kc._apply_routed(
            recv, (fl, J.FLAG_INS), kw + 1, (fl, J.FLAG_DEL), kw + 2,
            seq))}
    ins, dels = np.asarray(ins, bool), np.asarray(dels, bool)
    n_probe, n_ins = int(np.asarray(pvis, bool).sum()), int(ins.sum())
    n_keys = len(np.unique(np.asarray(lanes)[ins], axis=0))
    nbytes = (m * rows.shape[1] * 4 + n_probe * (kw * 4 + 4 + 4 + 8)
              + total * (12 + 8) + s * 8 + n_ins * (kw * 4 + 4 + 8)
              + n_keys * 8 + int(dels.sum()) * 4)
    b, by = bound_ms(nbytes, m * 64)
    log(f"sharded apply_and_probe (B16): {len(steps)} steps of "
        f"{MESH_CHUNK_ROWS}-row chunks ({n_del} deletes, {n_null} rows "
        f"not probed: NULL keys or invisible) exact against the plain twin"
        f" in {checked_s:.3f} s; the last step: {m} rows, {n_probe} "
        f"probes, {n_ins} inserts, {total} pairs, {s} x {m} received rows "
        f"per kernel")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, steps=len(steps), split_ms=split)


# -- phase 4: the per-chunk arm of the sharded join ---------------------------

def perchunk_script(n_chunks: int = PERCHUNK_CHUNKS, seed: int = 41):
    """Both sides' streams: n_chunks chunks of 4,096 rows per side,
    PERCHUNK_EPOCH chunks per side between barriers. Each chunk deletes
    live rows, moves live rows to another key with a U-/U+ pair, and
    inserts new rows; 5% of keys are NULL, and the key range widens each
    epoch so the sharded key tables grow. Returns (left messages, right
    messages, barriers, the oracle's view as sorted rows [lk, lv, rk,
    rv])."""
    from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk
    from risingwave_tpu_torch.common.epoch import Epoch, EpochPair
    from risingwave_tpu_torch.common.types import DataType, Schema
    from risingwave_tpu_torch.stream.message import Barrier, BarrierKind
    rng = np.random.default_rng(seed)
    n = MESH_CHUNK_ROWS
    schemas = (Schema.of(lk=DataType.INT64, lv=DataType.INT64),
               Schema.of(rk=DataType.INT64, rv=DataType.INT64))
    live = [dict(k=np.zeros(0, np.int64), null=np.zeros(0, bool),
                 pk=np.zeros(0, np.int64)) for _ in range(2)]
    next_pk = [0, 10**9]
    msgs = ([], [])

    def barrier(b):
        prev = Epoch.from_physical(b - 1) if b > 1 else Epoch.INVALID
        return Barrier(EpochPair(Epoch.from_physical(b), prev),
                       BarrierKind.CHECKPOINT)

    def keys(m, hi):
        """30% on 50K hot keys (matches), 70% over a widening range."""
        k = np.where(rng.random(m) < 0.3, rng.integers(0, 50_000, m),
                     50_000 + rng.integers(0, hi, m))
        return k.astype(np.int64), rng.random(m) < 0.05
    b = 1
    for side in (0, 1):
        msgs[side].append(barrier(b))
    for c in range(n_chunks):
        hi = 200_000 * (c // PERCHUNK_EPOCH + 1)
        for side in (0, 1):
            lv = live[side]
            d = min(400, len(lv["pk"]) // 4)
            u = min(300, len(lv["pk"]) // 4)
            pick = rng.choice(len(lv["pk"]), d + u, replace=False)
            dl, up = pick[:d], pick[d:]
            nk, nn = keys(u, hi)
            i = n - d - 2 * u
            ik, inn = keys(i, hi)
            ipk = next_pk[side] + np.arange(i)
            next_pk[side] += i
            k = np.concatenate([lv["k"][dl], np.stack(
                [lv["k"][up], nk], 1).reshape(-1), ik])
            null = np.concatenate([lv["null"][dl], np.stack(
                [lv["null"][up], nn], 1).reshape(-1), inn])
            pk = np.concatenate([lv["pk"][dl], np.repeat(lv["pk"][up], 2),
                                 ipk])
            ops = np.concatenate([
                np.full(d, int(Op.DELETE)),
                np.tile([int(Op.UPDATE_DELETE), int(Op.UPDATE_INSERT)], u),
                np.full(i, int(Op.INSERT))]).astype(np.int8)
            msgs[side].append(StreamChunk(
                schemas[side],
                [Column(DataType.INT64, np.where(null, 0, k), ~null),
                 Column(DataType.INT64, pk)], np.ones(n, bool), ops))
            lv["k"][up], lv["null"][up] = nk, nn
            keep = np.ones(len(lv["pk"]), bool)
            keep[dl] = False
            for name, new in (("k", ik), ("null", inn), ("pk", ipk)):
                lv[name] = np.concatenate([lv[name][keep], new])
        if (c + 1) % PERCHUNK_EPOCH == 0:
            b += 1
            for side in (0, 1):
                msgs[side].append(barrier(b))
    # the oracle: every (left, right) pair of live rows on one non-NULL key
    lk, rk = (np.where(x["null"], -1, x["k"]) for x in live)
    order = np.argsort(rk, kind="stable")
    rs = rk[order]
    lo = np.searchsorted(rs, lk, "left")
    hi_ = np.searchsorted(rs, lk, "right")
    cnt = np.where(lk >= 0, hi_ - lo, 0)
    li = np.repeat(np.arange(len(lk)), cnt)
    ri = order[np.concatenate([np.arange(a, a + c_) for a, c_ in
                               zip(lo[cnt > 0], cnt[cnt > 0])])
               if cnt.any() else np.zeros(0, np.int64)]
    view = np.stack([lk[li], live[0]["pk"][li], rk[ri], live[1]["pk"][ri]],
                    axis=1)
    return msgs[0], msgs[1], b, view[np.lexsort(view.T[::-1])]


def _chunk_arrays(c) -> tuple:
    vis = np.asarray(c.visibility)
    return (np.asarray(c.ops)[vis],) + tuple(
        np.asarray(col.values)[vis] for col in c.columns) + tuple(
        np.ones(int(vis.sum()), bool) if col.validity is None
        else np.asarray(col.validity)[vis] for col in c.columns)


def _chunk_rows(c) -> np.ndarray:
    """A chunk's visible rows (op, values, validity) as one sorted int64
    matrix: its records as a multiset."""
    rows = np.stack([a.astype(np.int64) for a in _chunk_arrays(c)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def _view_of(chunks) -> np.ndarray:
    """The join's output folded into its view (sorted rows; each joined
    row's count must end at 0 or 1: the pks are unique)."""
    rows, sign = [], []
    for c in chunks:
        a = _chunk_arrays(c)
        rows.append(np.stack(a[1:5], axis=1))
        sign.append(np.where((a[0] == 1) | (a[0] == 4), 1, -1))
    rows = np.concatenate(rows)
    uniq, inv = np.unique(rows, axis=0, return_inverse=True)
    cnt = np.bincount(inv.reshape(-1), weights=np.concatenate(sign),
                      minlength=len(uniq)).astype(np.int64)
    assert ((cnt == 0) | (cnt == 1)).all(), "a joined row counted twice"
    return uniq[cnt == 1]


def _join_executor(dev, sl, sr, epoch_batch: bool):
    """The inner join of perchunk_script's two streams over MESH_SHARDS
    shards."""
    from risingwave_tpu_torch.parallel import ShardMesh
    from risingwave_tpu_torch.state.state_table import StateTable
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from risingwave_tpu_torch.stream.executors.hash_join import (
        HashJoinExecutor,
    )
    from risingwave_tpu_torch.stream.executors.test_utils import MockSource
    ls, rs = sl[1].schema, sr[1].schema
    store = MemoryStateStore()
    return HashJoinExecutor(
        MockSource(ls, sl), MockSource(rs, sr), [0], [0],
        StateTable(21, ls, [1], store, dist_key_indices=[]),
        StateTable(22, rs, [1], store, dist_key_indices=[]),
        mesh=ShardMesh(MESH_SHARDS, dev), epoch_batch=epoch_batch,
        device=dev)


def run_join_perchunk(dev, n_chunks: int = PERCHUNK_CHUNKS) -> dict:
    """HashJoinExecutor over MESH_SHARDS shards, per-chunk arm
    (``epoch_batch=False``: one apply_and_probe per chunk, B16) against
    its epoch-batched twin on perchunk_script: the same output chunks,
    each the same multiset of records (the order of one probe row's
    matches is its chain's, and the arms link a key's rows in another
    order: the epoch arm a whole epoch in batch order, the per-chunk arm
    each chunk ahead of the earlier ones, as in the reference), and the
    view equal to the oracle. Launch counts are the per-chunk arm's."""
    from risingwave_tpu_torch.stream.executors.test_utils import (
        collect_until_n_barriers,
    )
    from risingwave_tpu_torch.utils.device import LAUNCHES
    sl, sr, nb, want = perchunk_script(n_chunks)
    out = {}
    for arm in ("epoch", "per-chunk"):
        ex = _join_executor(dev, sl, sr, epoch_batch=arm == "epoch")
        LAUNCHES.reset()
        t0 = time.perf_counter()
        msgs = asyncio.run(collect_until_n_barriers(ex, nb))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[arm] = dict(wall_s=time.perf_counter() - t0,
                        launches=LAUNCHES.snapshot(),
                        chunks=[m for m in msgs if hasattr(m, "ops")],
                        key_capacity=ex.sides[0].kernel.key_capacity,
                        row_capacity=ex.sides[0].kernel.row_capacity)
    a, b = out["epoch"]["chunks"], out["per-chunk"]["chunks"]
    assert len(a) == len(b), "the arms emitted different chunk counts"
    for x, y in zip(a, b):
        assert np.array_equal(_chunk_rows(x), _chunk_rows(y)), \
            "the arms' messages differ"
    got = _view_of(b)
    assert got.shape == want.shape and (got == want).all(), \
        "the per-chunk arm's view differs from the oracle"
    steps = 2 * n_chunks
    pc = out["per-chunk"]
    assert pc["key_capacity"] > 1 << 15, "the key tables did not grow"
    return dict(rows_per_side=n_chunks * MESH_CHUNK_ROWS,
                barriers=nb, joined_rows=len(got), out_chunks=len(b),
                epoch_wall_s=out["epoch"]["wall_s"], wall_s=pc["wall_s"],
                key_capacity=pc["key_capacity"],
                row_capacity=pc["row_capacity"],
                launches=pc["launches"],
                epoch_arm_launches=out["epoch"]["launches"],
                per_chunk={k: v / steps for k, v in pc["launches"].items()},
                elapsed_s=pc["wall_s"])


def mesh_host_fns(stats) -> dict:
    """Cumulative host time (s) of the sharded paths' own host work: the
    routing's host twin and bucket sizing, the agg's step and flush, the
    join's guards, staging, steps and collects."""
    want = ("owners_host", "skew_bucket", "_dispatch_backlog", "flush",
            "apply", "apply_raw", "_guard_keys", "_guard_keys_blind",
            "stage_epoch", "apply_epoch", "probe_epoch", "collect", "read",
            "drain_overflows", "apply_and_probe")
    out: dict = {}
    for (path, _line, fn), (_cc, _nc, _tt, ct, _callers) in \
            stats.stats.items():
        if "parallel" in path and fn in want:
            key = f"parallel/{path.split('parallel/')[-1]}:{fn}"
            out[key] = out.get(key, 0.0) + ct
    return out


# -- phase 3, the agg's cold tier and patch: K8, K4 (evict), K9, K2 (kNone) ------

COLD_CAP = 1 << 20            # the large shape: ~600K groups, as maxbids'
COLD_GROUPS = 600_000         # first agg holds at 10M events
COLD_KEYS = 1 << 16           # keys evicted, rows patched and reloaded
CAPPED_CAP = 1 << 18          # the capped arm's table (the default size)
CAPPED_GROUPS = 4_418         # resident before a sweep at 2M events (CPU
CAPPED_SWEEP = 4_370          # rehearsal: the median sweep evicts 4,370
CAPPED_RELOAD = 30            # groups; a reload brings back ~30)
CAPPED_PATCH = 8              # the second agg's patch: 1-2 windows, padded
MIXED_PLAN = [("sum", np.int64), ("sum", np.float64), ("min", np.int64),
              ("count", None)]


def _cold_state(dev, cap: int, groups: int, seed: int = 31):
    """The mixed plan's state holding `groups` clean groups (each applied
    through K1 + K2 in 2^15-row steps, then advanced), with the groups'
    key lanes."""
    from risingwave_tpu_torch.ops import hash_agg as H
    specs = make_specs(H, MIXED_PLAN)
    plan = H.ApplyPlan(KW, specs, dev)
    st = H.make_agg_state(cap, KW, specs, dev)
    rng = np.random.default_rng(seed)
    g = rng.permutation(groups * 4)[:groups].astype(np.int64) * 7_919 - 3
    for lo in range(0, groups, N):
        gg = g[lo:lo + N]
        n = len(gg)
        ints = rng.integers(-10**12, 10**12, n)
        floats = rng.standard_normal(n) * 1e3
        inputs = tuple(
            ((), None) if s_.in_dtype is None else
            (s_.encode_input(floats if s_.is_float_sum else ints),
             np.ones(n, bool)) for s_ in specs)
        packed = H.pack_chunk(KW, specs, _key_lanes(gg), np.ones(n, np.int32),
                              np.ones(n, bool), inputs)
        stats = H.apply_batch(st, torch.from_numpy(packed).to(dev), plan)
        assert int(stats[1]) == 0
    H.advance(st)
    return specs, st, _key_lanes(g)


def _sorted_groups(state) -> tuple:
    """(keys, state columns) of the occupied slots, sorted by key: state
    free of slot numbering (K1 numbers slots its own way)."""
    occ = state.table.occ.cpu().numpy() != 0
    keys = state.table.keys.cpu().numpy()[occ]
    cols = state.st.cpu().numpy()[:, occ].T
    order = np.lexsort(keys.T[::-1])
    return keys[order], cols[order]


def _evict_query(rng, keys: np.ndarray, n: int) -> np.ndarray:
    """n query rows: 7/8 resident keys (some twice), 1/8 absent."""
    q = keys[rng.choice(len(keys), n - n // 8, replace=False)]
    d = n // 32
    q[:d] = q[d:2 * d]                                      # duplicates
    absent = _key_lanes(rng.integers(10**13, 10**14, n // 8))
    out = np.concatenate([q, absent])
    return out[rng.permutation(n)]


def _check_evict(dev, specs, st, keys, n_evict: int, seed: int) -> dict:
    """K8, K4 (evict) and the whole B9 against their plain versions on
    the card; times of K8, K4 (evict) and B9."""
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.ops import hash_table as ht
    rng = np.random.default_rng(seed)
    cap = st.capacity
    q = torch.from_numpy(_evict_query(rng, keys, n_evict)).to(dev)
    v = torch.ones(n_evict, dtype=torch.int32, device=dev)
    fill = torch.tensor(H.state_fills(specs), dtype=torch.int32, device=dev)
    dk = torch.zeros(cap, dtype=torch.int32, device=dev)
    dp = torch.zeros(cap, dtype=torch.int32, device=dev)
    sk, lk = ht.lookup(st.table, q, v, dk)
    sp, lp = ht.lookup_plain(st.table, q, v, dp)
    err = abs_err(sk.cpu().numpy(), sp.cpu().numpy())
    err = max(err, abs_err(dk.cpu().numpy(), dp.cpu().numpy()),
              abs_err(lk.cpu().numpy(), lp.cpu().numpy()))
    found = int((sk >= 0).sum())
    assert err == 0 and int(lk[1]) == 0 and found > n_evict // 2, err
    lv_k = H.live_mask(st, H.LIVE_EVICT, dropped=dk)
    lv_p = H.live_mask_plain(st, H.LIVE_EVICT, dropped=dp)
    err = max(err, abs_err(lv_k.cpu().numpy(), lv_p.cpu().numpy()))
    assert err == 0, err
    new_k, stats, _ls = H.evict_state(st, q, v, fill)

    def plain_twin():
        d = torch.zeros(cap, dtype=torch.int32, device=dev)
        ht.lookup_plain(st.table, q, v, d)
        live = H.live_mask_plain(st, H.LIVE_EVICT, dropped=d)
        t = ht.make_state(cap, KW, dev)
        o2n_, s_ = ht.probe_insert_plain(t, st.table.keys, live)
        return H.AggState(t, H.remap_plain(st.st, o2n_, t.occ, fill,
                                           cap)), s_
    new_p, pstats = plain_twin()
    err = max(err, abs_err(stats.cpu().numpy(), pstats.cpu().numpy()))
    for a, b in zip(_sorted_groups(new_k), _sorted_groups(new_p)):
        err = max(err, abs_err(a, b))
    assert err == 0, f"evict_state differs from its plain twin: {err}"
    n_occ = int((st.table.occ != 0).sum())
    assert int(stats[0]) == n_occ - len(np.unique(
        sk.cpu().numpy()[sk.cpu().numpy() >= 0]))
    absent = n_evict - found
    lk_bytes = n_evict * (KW * 4 + 4 + 4) + found * (KW * 4 + 4 + 4) \
        + absent * 4
    lb, lby = bound_ms(lk_bytes, n_evict * 12 * KW)
    lookup = dict(ms=time_ms(lambda: ht.lookup(st.table, q, v, dk)),
                  plain_ms=time_ms(lambda: ht.lookup_plain(st.table, q, v,
                                                           dp), 5, 1),
                  bound_ms=lb, bound_by=lby, rows=n_evict, found=found)
    mb, mby = bound_ms(cap * 4 * 3 + n_occ * 4, cap * 4)
    evict_mode = dict(
        ms=time_ms(lambda: H.live_mask(st, H.LIVE_EVICT, dropped=dk)),
        plain_ms=time_ms(lambda: H.live_mask_plain(st, H.LIVE_EVICT,
                                                   dropped=dp), 5, 1),
        bound_ms=mb, bound_by=mby)
    r = st.st.shape[0]
    n_live = int(lv_k.sum())
    eb, eby = bound_ms(lk_bytes + cap * 4 * 3 + n_occ * 4
                       + n_occ * (KW + 1) * 4 * 2 + n_live * r * 4
                       + r * cap * 4, cap * r)
    b9 = dict(ms=time_ms(lambda: H.evict_state(st, q, v, fill), 5, 1,
                         cold=True),
              plain_ms=time_ms(plain_twin, 3, 1, cold=True),
              bound_ms=eb, bound_by=eby, evicted=n_occ - n_live)
    return dict(max_abs_err=err, lookup=lookup, evict_mode=evict_mode,
                evict_state=b9)


def _check_patch(dev, st, n: int, seed: int) -> dict:
    """K9 at a patch's shape: every accumulator row at n distinct
    occupied slots (padding to a power of two with cap), exact against
    its plain version; kernel, plain and ``index_put_`` times."""
    from risingwave_tpu_torch.common.chunk import next_pow2
    from risingwave_tpu_torch.ops import hash_agg as H
    rng = np.random.default_rng(seed)
    cap = st.capacity
    occ = np.flatnonzero(st.table.occ.cpu().numpy())
    pad = next_pow2(n)
    idx = np.full(pad, cap, np.int32)
    idx[:n] = rng.choice(occ, n, replace=False)
    src = rng.integers(-2**31, 2**31, (st.n_acc, pad)).astype(np.int32)
    it, srct = torch.from_numpy(idx).to(dev), torch.from_numpy(src).to(dev)
    rows = H.patch_rows(st.n_acc, dev)
    a, b = st.st.clone(), st.st.clone()
    H.scatter_rows(a, it, rows, srct)
    H.scatter_rows_plain(b[None], it[None], rows, srct[None])
    err = abs_err(a.cpu().numpy(), b.cpu().numpy())
    assert err == 0, f"scatter_rows differs from its plain version: {err}"
    r64 = rows.to(torch.int64)[:, None]
    i64 = it[:n].to(torch.int64)[None, :]
    sub = srct[:, :n].contiguous()
    nb, nby = bound_ms(pad * 4 + 2 * st.n_acc * n * 4 + st.n_acc * 4, n)
    return dict(max_abs_err=err,
                ms=time_ms(lambda: H.scatter_rows(a, it, rows, srct)),
                plain_ms=time_ms(lambda: H.scatter_rows_plain(
                    b[None], it[None], rows, srct[None]), 5, 1),
                library_ms=time_ms(lambda: a.index_put_((r64, i64), sub)),
                bound_ms=nb, bound_by=nby, rows=n)


def _check_reload(dev, specs, st, keys, n: int, seed: int) -> dict:
    """load_groups' device half (K1 inserting the keys, K9 setting every
    row but dirty) on an evicted state, against its plain twin, compared
    key-sorted; both timed on fresh copies of the evicted state."""
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.ops import hash_table as ht
    rng = np.random.default_rng(seed)
    gone = keys[rng.choice(len(keys), n, replace=False)]
    q = torch.from_numpy(gone).to(dev)
    fill = torch.tensor(H.state_fills(specs), dtype=torch.int32, device=dev)
    ev, _s, _l = H.evict_state(st, q, torch.ones(n, dtype=torch.int32,
                                                 device=dev), fill)
    rows32 = rng.integers(1, 50, n).astype(np.int64)
    cols = [rng.integers(-2**20, 2**20, n).astype(np.int32)
            for _ in range(ev.n_acc)]
    src = torch.from_numpy(H.load_src(rows32, cols)).to(dev)
    lr = H.load_rows(ev.n_acc, dev)
    one = torch.ones(n, dtype=torch.int32, device=dev)
    def fresh():
        return H.AggState(ht.TableState(ev.table.keys.clone(),
                                        ev.table.occ.clone()), ev.st.clone())

    def kernels(a):
        _t, sk_, _s = ht.probe_insert(a.table, q, one)
        H.scatter_rows(a.st, sk_, lr, src)
        return sk_

    def plain(b):
        sp_, _s = ht.probe_insert_plain(b.table, q, one)
        H.scatter_rows_plain(b.st[None], sp_[None], lr, src[None])

    a, b = fresh(), fresh()
    sk = kernels(a)
    plain(b)
    err = 0.0
    for x, y in zip(_sorted_groups(a), _sorted_groups(b)):
        err = max(err, abs_err(x, y))
    assert err == 0, f"the reload differs from its plain twin: {err}"
    assert int((a.st[H.ROW_EMITTED_VALID][sk.to(torch.int64)] == 1).all())
    copies = [fresh() for _ in range(8)]
    ms = statistics.median(_timed(lambda: kernels(c)) for c in copies[:5])
    plain_ms = statistics.median(_timed(lambda: plain(c))
                                 for c in copies[5:])
    r = len(lr)
    nb, nby = bound_ms(n * (KW * 4 + 4 + 4) + n * (KW + 1) * 4
                       + 2 * r * n * 4 + r * 4, n * 12 * KW)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=nb,
                bound_by=nby, rows=n)


def _timed(fn) -> float:
    """Device time (ms) of one call, by CUDA events when on the card; the
    call is queued behind a device sleep, so its launches run back to
    back (as in ``time_ms``)."""
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES // 4)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


def _check_passthrough(dev) -> float:
    """GroupedAggKernel.patch_accs on the card: a corrected MIN beside an
    integer SUM, a float SUM and a COUNT; the untouched calls' rows keep
    K2's limbs and (hi, lo) bits exactly, the MIN rows take the corrected
    values at the flushed slots, and no other slot moves."""
    from risingwave_tpu_torch.ops import hash_agg as H
    specs = make_specs(H, MIXED_PLAN)
    k = H.GroupedAggKernel(KW, specs, capacity=CAPPED_CAP, device=dev)
    packed = mixed_batch(N, specs, groups=CAPPED_GROUPS, seed=5)
    packed[:, KW] = 1              # inserts only: no group below 0 rows
    stats = H.apply_batch(k.state, torch.from_numpy(packed).to(dev),
                          k._plan)
    assert int(stats[1]) == 0
    fr = k.flush()
    idx = k._flush_idx.astype(np.int64)
    before = k.state.st.cpu().numpy()
    v = np.random.default_rng(6).integers(-10**12, 10**12, fr.n)
    nn = fr.nns[2]
    k.patch_accs([None, None, (v, nn), None], fr.raw_accs)
    after = k.state.st.cpu().numpy()
    k.advance()
    sl = H._call_slices(specs)[2]
    min_rows = [H.ROW_ACC0 + i for i in range(sl.start, sl.stop)]
    other = [r for r in range(after.shape[0]) if r not in min_rows]
    err = abs_err(after[other], before[other])
    want = np.stack(H.as_i32_cols(specs[2].encode_acc(v, nn)))
    err = max(err, abs_err(after[min_rows][:, idx], want))
    untouched = np.setdiff1d(np.arange(after.shape[1]), idx)
    err = max(err, abs_err(after[min_rows][:, untouched],
                           before[min_rows][:, untouched]))
    assert err == 0, f"patch_accs moved an untouched row: {err}"
    return err


def _check_scatter_sharded(dev) -> dict:
    """K9 with its shard axis at q7-mesh's shapes (8 shards x 2^15
    slots): each shard's own slots and its own padding (cap) exact
    against the plain version; times and bound."""
    from risingwave_tpu_torch.ops import hash_agg as H
    rng = np.random.default_rng(17)
    specs = make_specs(H, MIXED_PLAN)
    r = len(H.state_fills(specs))
    st = torch.from_numpy(rng.integers(-2**31, 2**31, (
        MESH_SHARDS, r, MESH_CAP)).astype(np.int32)).to(dev)
    m, n = 1 << 12, 3000
    idx = np.full((MESH_SHARDS, m), MESH_CAP, np.int32)
    for d in range(MESH_SHARDS):
        idx[d, :n - 100 * d] = rng.permutation(MESH_CAP)[:n - 100 * d]
    nacc = (r - H.ROW_ACC0) // 2
    src = rng.integers(-2**31, 2**31, (MESH_SHARDS, nacc, m)) \
        .astype(np.int32)
    it, srct = torch.from_numpy(idx).to(dev), torch.from_numpy(src).to(dev)
    rows = H.patch_rows(nacc, dev)
    a, b = st.clone(), st.clone()
    H.scatter_rows_sharded(a, it, rows, srct)
    H.scatter_rows_plain(b, it, rows, srct)
    err = abs_err(a.cpu().numpy(), b.cpu().numpy())
    assert err == 0, f"sharded scatter_rows differs: {err}"
    real = int((idx < MESH_CAP).sum())
    nb, nby = bound_ms(idx.size * 4 + 2 * nacc * real * 4, real)
    return dict(max_abs_err=err,
                ms=time_ms(lambda: H.scatter_rows_sharded(a, it, rows, srct)),
                plain_ms=time_ms(lambda: H.scatter_rows_plain(
                    b, it, rows, srct), 5, 1),
                bound_ms=nb, bound_by=nby, rows=real)


def _check_none_kind(dev) -> dict:
    """K2 with the distinct path's plan (COUNT(*), two COUNT(col) calls
    and approx_count_distinct's dummy lane, kNone) at q7's step: exact
    against the plain version, the dummy lane untouched; timed."""
    from risingwave_tpu_torch.ops import hash_agg as H
    specs = make_specs(H, [("count", None), ("count", np.int64),
                           ("count", np.int64),
                           ("approx_count_distinct", np.int64)])
    plan = H.ApplyPlan(KW, specs, dev)
    assert plan.desc[3, 0] == H._K_NONE
    packed = torch.from_numpy(q7_batch(N, specs)).to(dev)
    st, slots = _state_after(dev, specs, packed, CAP)
    a = H.AggState(st.table, st.st.clone())
    b = H.AggState(st.table, st.st.clone())
    H.agg_apply(a, packed, slots, plan)
    H.agg_apply_plain(b, packed, slots, plan)
    err = abs_err(a.st.cpu().numpy(), b.st.cpu().numpy())
    assert err == 0 and not bool(a.st[H.ROW_ACC0 + 3].any()), err
    w = packed.shape[1]
    touched = len(np.unique(slots.cpu().numpy()))
    nb, nby = bound_ms(N * w * 4 + N * 4 + touched * 5 * 4 * 2, N * 8)
    return dict(max_abs_err=err,
                ms=time_ms(lambda: H.agg_apply(a, packed, slots, plan)),
                plain_ms=time_ms(lambda: H.agg_apply_plain(b, packed, slots,
                                                           plan)),
                bound_ms=nb, bound_by=nby)


def check_cold(dev) -> dict:
    """The cold tier's and the patch's kernels against their plain
    versions at the capped arm's shapes and at the large shape."""
    t0 = time.perf_counter()
    out = {}
    specs, st, keys = _cold_state(dev, COLD_CAP, COLD_GROUPS)
    large = _check_evict(dev, specs, st, keys, COLD_KEYS, 1)
    large["patch"] = _check_patch(dev, st, COLD_KEYS, 2)
    large["reload"] = _check_reload(dev, specs, st, keys, COLD_KEYS, 3)
    del st
    torch.cuda.empty_cache()
    specs, st, keys = _cold_state(dev, CAPPED_CAP, CAPPED_GROUPS)
    capped = _check_evict(dev, specs, st, keys, CAPPED_SWEEP, 4)
    capped["patch"] = _check_patch(dev, st, CAPPED_PATCH, 5)
    capped["reload"] = _check_reload(dev, specs, st, keys, CAPPED_RELOAD,
                                     6)
    sharded = _check_scatter_sharded(dev)
    passthrough = _check_passthrough(dev)
    err = max(large["max_abs_err"], capped["max_abs_err"],
              large["patch"]["max_abs_err"], capped["patch"]["max_abs_err"],
              large["reload"]["max_abs_err"],
              capped["reload"]["max_abs_err"],
              sharded["max_abs_err"], passthrough)
    out["lookup"] = dict(large["lookup"], max_abs_err=err,
                         capped_shape=capped["lookup"])
    out["scatter_rows"] = dict(large["patch"], max_abs_err=err,
                               capped_shape=capped["patch"],
                               sharded=sharded)
    out["evict_mode"] = dict(large["evict_mode"],
                             capped_shape=capped["evict_mode"])
    out["evict_state"] = dict(large["evict_state"],
                              capped_shape=capped["evict_state"])
    out["load_groups"] = dict(large["reload"],
                              capped_shape=capped["reload"])
    out["none_kind"] = _check_none_kind(dev)
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phase 4: Nexmark q5's MaxBids, q15's distinct counts, q7 under the tier -----

MAXBIDS_EVENTS = 10_000_000
MAXBIDS_CAPPED_EVENTS = 2_000_000
MAXBIDS_TRACE_EVENTS = 2_000_000     # maxbids both ways, distinct: traced
# below Nexmark's 100 in-flight auctions: only their groups are touched
# again after a barrier, and a sweep keeps 3/4 of the cap (48 groups), so
# the next barrier's bids reload some. A cap of 128 or more (2048
# included) evicts every sweep and never reloads (CPU rehearsal at 2M)
MAXBIDS_TIER_CAP = 64
DISTINCT_EVENTS = 10_000_000
Q7_TIER_EVENTS = 2_000_000
# retirement leaves one window live at each sweep, so only a cap of 0
# binds: every checkpoint evicts the open window, and the next barrier's
# bids reload it (a window that closes while cold is forgotten instead)
Q7_TIER_CAP = 0


def build_maxbids(dev, store, cfg, tier_cap=None, capacity=None):
    """Nexmark q5's MaxBids subquery over 10 s tumbling windows, from the
    port's executors: bid source → project(window_start, auction) → A:
    COUNT(*) AS num per (window_start, auction), append-only → B:
    MAX(num), MIN(num), COUNT(*), SUM(num) per window_start, MAX and MIN
    retractable over materialized-input tables (A emits U-/U+ pairs) →
    materialize. bench_q8's chunking: 4096-row chunks, 16 a barrier."""
    from risingwave_tpu_torch.common.types import DataType
    from risingwave_tpu_torch.expr.expr import InputRef, tumble_start
    from risingwave_tpu_torch.models import nexmark as M
    from risingwave_tpu_torch.stream.executors.hash_agg import (
        AggCall, HashAggExecutor, agg_aux_tables, agg_state_schema,
    )
    local = M.LocalBarrierManager()
    source = M._source(local, store, 1, cfg, 1, 16, 16)
    s = source.schema
    project = M.ProjectExecutor(
        source, exprs=[tumble_start(InputRef(s.index_of("date_time"),
                                             DataType.TIMESTAMP),
                                    M.DEFAULT_WINDOW),
                       InputRef(s.index_of("auction"), DataType.INT64)],
        names=["window_start", "auction"])
    calls_a = [AggCall(M.AggKind.COUNT)]
    sch_a, pk_a = agg_state_schema(project.schema, [0, 1], calls_a)
    agg_a = HashAggExecutor(
        project, [0, 1], calls_a,
        M.StateTable(2, sch_a, pk_a, store, dist_key_indices=[0, 1]),
        append_only=True, output_names=["num"], tier_cap=tier_cap,
        kernel_capacity=capacity, device=dev)
    k = M.AggKind
    calls_b = [AggCall(k.MAX, 2), AggCall(k.MIN, 2), AggCall(k.COUNT),
               AggCall(k.SUM, 2)]
    sch_b, pk_b = agg_state_schema(agg_a.schema, [0], calls_b)
    dist, minput = agg_aux_tables(agg_a.schema, [0], calls_b, False, store,
                                  lambda c: 10 + c, lambda j: 20 + j)
    agg_b = HashAggExecutor(
        agg_a, [0], calls_b,
        M.StateTable(3, sch_b, pk_b, store, dist_key_indices=[0]),
        output_names=["max_num", "min_num", "auctions", "bids"],
        minput_tables=minput, distinct_tables=dist, device=dev)
    mv = M.StateTable(4, agg_b.schema, [0], store)
    mat = M.MaterializeExecutor(agg_b, mv)
    p = M._finish(local, store, mat, mv, 1, {1: source.reader}, "maxbids",
                  False, dev)
    return p, agg_a, agg_b


def maxbids_oracle(cfg, n_bids: int, block: int = 1 << 21) -> dict:
    """window_start → (MAX, MIN, COUNT, SUM) of the per-auction bid
    counts, vectorized: one int64 (window, auction) code per bid."""
    from risingwave_tpu_torch.connectors.nexmark import gen_bids
    from risingwave_tpu_torch.models.nexmark import DEFAULT_WINDOW
    w = DEFAULT_WINDOW.usecs
    codes = []
    for lo in range(0, n_bids, block):
        b = gen_bids(np.arange(lo, min(lo + block, n_bids), dtype=np.int64),
                     cfg)
        codes.append(((b["date_time"] // w) << 32) | b["auction"])
    u, num = np.unique(np.concatenate(codes), return_counts=True)
    win = u >> 32
    starts = np.flatnonzero(np.r_[True, win[1:] != win[:-1]])
    mx = np.maximum.reduceat(num, starts)
    mn = np.minimum.reduceat(num, starts)
    cnt = np.diff(np.r_[starts, len(u)])
    tot = np.add.reduceat(num, starts)
    return {int(ws) * w: (int(a), int(b), int(c), int(d))
            for ws, a, b, c, d in zip(win[starts].tolist(), mx.tolist(),
                                      mn.tolist(), cnt.tolist(),
                                      tot.tolist())}


def run_maxbids(dev, events: int, tier_cap=None, trace: bool = False
                ) -> dict:
    """maxbids through drive_to_completion; the MV must equal the oracle.
    With a tier cap on A, evictions and reloads must both happen."""
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.state.store import MemoryStateStore
    cfg = NexmarkConfig(event_num=events, max_chunk_size=4096,
                        generate_strings=False)
    cap = None if tier_cap is not None else 1 << 20
    p, agg_a, agg_b = build_maxbids(dev, MemoryStateStore(), cfg, tier_cap,
                                    cap)
    n_bids = events * 46 // 50
    out = drive(p, {1: n_bids}, dev, trace)
    t0 = time.perf_counter()
    got = {r[0]: tuple(r[1:]) for _pk, r in p.mv_table.iter_rows()}
    want = maxbids_oracle(cfg, n_bids)
    assert got == want, "maxbids MV differs from the oracle"
    assert p.reader.offset == n_bids
    extra = dict(windows=len(got), mv_digest=mv_digest(got.items()),
                 groups_a=int((agg_a.kernel.state.table.occ != 0).sum()),
                 capacity_a=agg_a.kernel.capacity,
                 oracle_s=time.perf_counter() - t0)
    if tier_cap is not None:
        part = agg_a._tier_part
        assert part.evicted_total > 0 and part.reload_total > 0, \
            "the capped arm neither evicted nor reloaded"
        extra.update(evicted=part.evicted_total, reloaded=part.reload_total,
                     resident=len(part.keys))
    return dict(out, **extra)


HLL_B = 16                     # the dense sketch: 2^16 registers


def hll_estimate(values: np.ndarray) -> int:
    """The dense HyperLogLog estimate of an int64 value set, from this
    script's own registers: splitmix64, the top HLL_B bits as the
    register, the rank of the rest; the bias-corrected harmonic mean
    with linear counting below 2.5 m (approx_count_distinct/mod.rs)."""
    m = 1 << HLL_B
    with np.errstate(over="ignore"):
        z = values.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        h = z ^ (z >> np.uint64(31))
    reg = (h >> np.uint64(64 - HLL_B)).astype(np.int64)
    rest = h << np.uint64(HLL_B)
    bits = np.zeros(len(rest), dtype=np.int64)
    x = rest.copy()
    for s_ in (32, 16, 8, 4, 2, 1):
        big = x >= (np.uint64(1) << np.uint64(s_))
        bits = np.where(big, bits + s_, bits)
        x = np.where(big, x >> np.uint64(s_), x)
    bits = bits + (rest > 0)                 # bit length
    rho = np.where(rest == 0, 65 - HLL_B, 64 - bits + 1)
    rho = np.minimum(rho, 65 - HLL_B)
    regs = np.zeros(m, dtype=np.int64)
    np.maximum.at(regs, reg, rho)
    alpha = 0.7213 / (1 + 1.079 / m)
    e = alpha * m * m / np.power(2.0, -regs.astype(np.float64)).sum()
    zeros = int((regs == 0).sum())
    if e <= 2.5 * m and zeros > 0:
        e = m * np.log(m / zeros)
    return int(np.round(e))


def run_distinct(dev, events: int, trace: bool = False) -> dict:
    """Nexmark q15's distinct counts per 10 s tumbling window: COUNT(*),
    COUNT(DISTINCT bidder), COUNT(DISTINCT auction) and
    approx_count_distinct(bidder) over bids (append-only; dedup tables,
    one HLL sketch table), at q7's chunking. The exact counts must equal
    the oracle, and the estimate this script's own HLL registers, within
    2% of the exact count."""
    from risingwave_tpu_torch.common.types import DataType
    from risingwave_tpu_torch.connectors.nexmark import (
        NexmarkConfig, gen_bids,
    )
    from risingwave_tpu_torch.expr.expr import InputRef, tumble_start
    from risingwave_tpu_torch.models import nexmark as M
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from risingwave_tpu_torch.stream.executors.hash_agg import (
        AggCall, HashAggExecutor, agg_aux_tables, agg_state_schema,
    )
    cfg = NexmarkConfig(event_num=events, max_chunk_size=8192,
                        generate_strings=False)
    store = MemoryStateStore()
    local = M.LocalBarrierManager()
    source = M._source(local, store, 1, cfg, 1, 32, 32)
    s = source.schema
    project = M.ProjectExecutor(
        source, exprs=[tumble_start(InputRef(s.index_of("date_time"),
                                             DataType.TIMESTAMP),
                                    M.DEFAULT_WINDOW),
                       InputRef(s.index_of("bidder"), DataType.INT64),
                       InputRef(s.index_of("auction"), DataType.INT64)],
        names=["window_start", "bidder", "auction"])
    k = M.AggKind
    calls = [AggCall(k.COUNT), AggCall(k.COUNT, 1, distinct=True),
             AggCall(k.COUNT, 2, distinct=True),
             AggCall(k.APPROX_COUNT_DISTINCT, 1)]
    sch, pk = agg_state_schema(project.schema, [0], calls)
    dist, minput = agg_aux_tables(project.schema, [0], calls, True, store,
                                  lambda c: 10 + c, lambda j: 20 + j)
    agg = HashAggExecutor(project, [0], calls,
                          M.StateTable(2, sch, pk, store,
                                       dist_key_indices=[0]),
                          append_only=True,
                          output_names=["bids", "bidders", "auctions",
                                        "approx_bidders"],
                          minput_tables=minput, distinct_tables=dist,
                          device=dev)
    mv = M.StateTable(4, agg.schema, [0], store)
    p = M._finish(local, store, M.MaterializeExecutor(agg, mv), mv, 1,
                  {1: source.reader}, "distinct", False, dev)
    n_bids = events * 46 // 50
    out = drive(p, {1: n_bids}, dev, trace)
    t0 = time.perf_counter()
    got = {r[0]: tuple(r[1:]) for _pk, r in mv.iter_rows()}
    b = gen_bids(np.arange(n_bids, dtype=np.int64), cfg)
    w = M.DEFAULT_WINDOW.usecs
    win = b["date_time"] - b["date_time"] % w
    starts = np.flatnonzero(np.r_[True, win[1:] != win[:-1]])
    ends = np.r_[starts[1:], len(win)]
    worst = 0.0
    for lo, hi in zip(starts.tolist(), ends.tolist()):
        bidders = np.unique(b["bidder"][lo:hi])
        want = (hi - lo, len(bidders), len(np.unique(b["auction"][lo:hi])))
        row = got.pop(int(win[lo]))
        assert row[:3] == want, ("distinct counts differ", row, want)
        est = hll_estimate(bidders)
        assert row[3] == est, ("the estimate differs from the dense HLL",
                               row[3], est)
        worst = max(worst, abs(est - want[1]) / want[1])
    assert not got, "the MV holds windows the oracle has not"
    assert worst < 0.02, f"the estimate is {worst:.4f} off the exact count"
    return dict(out, windows=len(starts), hll_worst_rel_err=worst,
                oracle_s=time.perf_counter() - t0)


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
    t_start = time.perf_counter()
    results = {}
    for name, check in CHECKS.items():
        results[name] = check(dev, CAP, N)
        log(f"kernel {name}: " + json.dumps(results[name]))
    t0 = time.perf_counter()
    js = build_join_states(dev)
    log(f"join state at q8's shape: {js['ks'].table.capacity} slots, "
        f"{js['ks'].row_capacity} rows, built in "
        f"{time.perf_counter() - t0:.3f} s")
    for name, check in JOIN_CHECKS.items():
        results[name] = check(dev, js)
        log(f"kernel {name}: " + json.dumps(results[name]))
    log("remap (head, q8's growth 2^21 -> 2^22 slots): "
        + json.dumps(check_remap_head(dev, js)))
    del js
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    fused_err = check_fused_random(dev)
    log(f"fused preludes on {FUSED_SEEDS} random programs x {FUSED_ROWS} "
        f"rows (every opcode, edge values): max_abs_err "
        f"{json.dumps(fused_err)} in {time.perf_counter() - t0:.3f} s")
    results.update(check_fused_paths(dev, fused_err))
    for name in ("fused_chain", "agg_prelude", "join_prelude"):
        log(f"kernel {name}: " + json.dumps(results[name]))
    torch.cuda.empty_cache()

    results["route"] = check_route(dev)
    log("kernel route: " + json.dumps(results["route"]))
    t0 = time.perf_counter()
    sharded = check_sharded(dev)
    log(f"sharded K1-K4 at {MESH_SHARDS} shards x {MESH_CAP} slots (q7 "
        f"plan and the mixed plan over {MESH_GROUPS} groups) match their "
        f"plain versions: max_abs_err {sharded['max_abs_err']} in "
        f"{time.perf_counter() - t0:.3f} s")
    for name, t in sharded["timings"].items():
        log(f"sharded {name} at q7's routed step: " + json.dumps(t))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mj = build_mesh_join_states(dev)
    mesh_join = {"join_apply": check_mesh_join_apply(dev, mj),
                 "join_probe": check_mesh_join_probe(dev, mj)}
    for name, r in mesh_join.items():
        log(f"sharded {name} at q8-mesh's side-epoch ({MESH_SHARDS} "
            f"shards, {J_N} rows): " + json.dumps(r))
    del mj
    torch.cuda.empty_cache()
    step = check_mesh_apply_and_probe(dev)
    log(f"sharded apply_and_probe (B16) at the per-chunk arm's chunks "
        f"({MESH_SHARDS} shards, {MESH_CHUNK_ROWS} rows): "
        + json.dumps(step))
    log(f"sharded join kernels checked in {time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()

    cold = check_cold(dev)
    for name in ("lookup", "scatter_rows", "evict_mode", "evict_state",
                 "load_groups", "none_kind"):
        log(f"cold tier {name}: " + json.dumps(cold[name]))
    log(f"cold-tier kernels checked in {cold['seconds']:.3f} s")
    results["lookup"] = cold["lookup"]
    results["scatter_rows"] = cold["scatter_rows"]
    torch.cuda.empty_cache()

    floor = launch_floor_ms(dev)
    log(f"launch floor (advance, 1024 slots, nothing dirty): {floor} ms")

    # 4. the main paths end to end, the plan checker strict
    from risingwave_tpu_torch.frontend.opt import set_strict_checker
    set_strict_checker(True)
    paths = {}
    for label, run, events, path in (
            ("q7", run_q7, Q7_EVENTS, Q7_PATH),
            ("q8", run_q8, Q8_EVENTS, Q8_PATH),
            ("q7 fused", lambda d, e: run_q7(d, e, fusion=True), Q7_EVENTS,
             Q7_FUSED_PATH),
            ("q8 fused", lambda d, e: run_q8(d, e, fusion=True), Q8_EVENTS,
             Q8_FUSED_PATH),
            ("q1", lambda d, e: run_q1(d, e, fusion=False), Q1_EVENTS, ()),
            ("q1 fused", lambda d, e: run_q1(d, e, fusion=True), Q1_EVENTS,
             Q1_FUSED_PATH),
            ("q7 mesh", run_q7_mesh, Q7_MESH_EVENTS, Q7_MESH_PATH),
            ("q7 mesh fused", lambda d, e: run_q7_mesh(d, e, fusion=True),
             Q7_MESH_EVENTS, Q7_MESH_FUSED_PATH),
            ("q7 mesh recovery", run_q7_mesh_recovery,
             Q7_MESH_RECOVERY_EVENTS, Q7_MESH_PATH + ("scatter_rows",)),
            ("q8 mesh", lambda d, e: run_q8(d, e, mesh=True), Q8_EVENTS,
             Q8_MESH_PATH),
            ("q8 mesh fused", lambda d, e: run_q8(d, e, fusion=True,
                                                  mesh=True), Q8_EVENTS,
             Q8_MESH_FUSED_PATH),
            ("q8 mesh per-chunk", lambda d, e: run_join_perchunk(d), 0,
             PERCHUNK_PATH),
            ("maxbids", run_maxbids, MAXBIDS_EVENTS, MAXBIDS_PATH),
            ("maxbids capped", lambda d, e: run_maxbids(
                d, e, tier_cap=MAXBIDS_TIER_CAP), MAXBIDS_CAPPED_EVENTS,
             MAXBIDS_CAPPED_PATH),
            ("distinct", run_distinct, DISTINCT_EVENTS, DISTINCT_PATH),
            ("q7 tier", lambda d, e: run_q7(d, e, tier_cap=Q7_TIER_CAP),
             Q7_TIER_EVENTS, Q7_TIER_PATH)):
        t_path = time.perf_counter()
        out = run(dev, events)
        out["path_s"] = time.perf_counter() - t_path
        paths[label] = out
        missing = [k for k in path if out["launches"].get(k, 0) == 0]
        assert not missing, f"{label} never launched {missing}"
        busy_ms = sum(n * results[k]["ms"]
                      for k, n in out["launches"].items() if k in results)
        log(f"{label}: " + json.dumps(out))
        log(f"{label}: kernel busy estimate (launches x phase-3 medians) "
            f"{busy_ms:.3f} ms of {out['elapsed_s'] * 1e3:.3f} ms timed "
            f"wall")
    for q in ("q7", "q8", "q1"):
        assert paths[q]["mv_digest"] == paths[f"{q} fused"]["mv_digest"], \
            f"{q}: the fused MV differs from the unfused one"
        a, b = paths[q], paths[f"{q} fused"]
        log(f"{q} fused vs unfused: events/s {b['events_per_s']} vs "
            f"{a['events_per_s']}, p99 barrier latency "
            f"{b['p99_barrier_latency_s']} vs {a['p99_barrier_latency_s']}")
    for label in ("q7 mesh", "q7 mesh fused"):
        m, one = paths[label], paths[label.replace(" mesh", "")]
        assert m["mv_digest"] == one["mv_digest"], \
            f"{label}: the MV differs from the single-device q7's"
        steps = m["launches"]["route"]
        log(f"{label}: {MESH_SHARDS} shards vs one device: events/s "
            f"{m['events_per_s']} vs {one['events_per_s']}, p99 barrier "
            f"latency {m['p99_barrier_latency_s']} vs "
            f"{one['p99_barrier_latency_s']}; per routed step "
            + json.dumps({k: v / steps for k, v in m["launches"].items()}))
    for label in ("q8 mesh", "q8 mesh fused"):
        m, one = paths[label], paths[label.replace(" mesh", "")]
        assert m["mv_digest"] == paths["q8"]["mv_digest"], \
            f"{label}: the MV differs from the single-device q8's"
        log(f"{label}: {MESH_SHARDS} shards vs one device: events/s "
            f"{m['events_per_s']} vs {one['events_per_s']}, p99 barrier "
            f"latency {m['p99_barrier_latency_s']} vs "
            f"{one['p99_barrier_latency_s']}; per barrier "
            + json.dumps(m["per_barrier"]))

    # 5. where the time goes: shorter traced runs (their launches are not
    # the main paths' and are not reported)
    q7_traced = run_q7(dev, Q7_TRACE_EVENTS, trace=True)
    log("q7 traced: " + json.dumps(q7_traced))
    assert Q7_TRACE_EVENTS == Q7_TIER_EVENTS
    assert paths["q7 tier"]["mv_digest"] == q7_traced["mv_digest"], \
        "q7 under the tier differs from the uncapped q7"
    log("q7 fused traced: " + json.dumps(run_q7(dev, Q7_TRACE_EVENTS,
                                                trace=True, fusion=True)))
    for events in Q8_TRACE_EVENTS:
        log(f"q8 traced at {events} events: "
            + json.dumps(run_q8(dev, events, trace=True)))
    log(f"q8 fused traced at {Q8_TRACE_EVENTS[0]} events: "
        + json.dumps(run_q8(dev, Q8_TRACE_EVENTS[0], trace=True,
                            fusion=True)))
    for fusion in (False, True):
        log(f"q7 mesh{' fused' if fusion else ''} traced at "
            f"{Q7_MESH_TRACE_EVENTS} events: "
            + json.dumps(run_q7_mesh(dev, Q7_MESH_TRACE_EVENTS, trace=True,
                                     fusion=fusion)))
    for fusion in (False, True):
        log(f"q8 mesh{' fused' if fusion else ''} traced at "
            f"{Q8_MESH_TRACE_EVENTS} events: "
            + json.dumps(run_q8(dev, Q8_MESH_TRACE_EVENTS, trace=True,
                                fusion=fusion, mesh=True)))

    for label, traced in (
            ("maxbids", lambda: run_maxbids(dev, MAXBIDS_TRACE_EVENTS,
                                            trace=True)),
            ("maxbids capped", lambda: run_maxbids(
                dev, MAXBIDS_TRACE_EVENTS, tier_cap=MAXBIDS_TIER_CAP,
                trace=True)),
            ("distinct", lambda: run_distinct(dev, MAXBIDS_TRACE_EVENTS,
                                              trace=True))):
        log(f"{label} traced at {MAXBIDS_TRACE_EVENTS} events: "
            + json.dumps(traced()))

    assert "jax" not in sys.modules, "the smoke run imported JAX"

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        row = {"name": name, "status": "ported, matches plain",
               "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(p["launches"].get(name, 0)
                               for p in paths.values()),
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"],
               "library_ms": r.get("library_ms")}
        for extra in ("capped_shape", "sharded", "epoch_apply"):
            if extra in r:
                row[extra] = r[extra]
        if name == "live_mask":
            row["evict_mode"] = cold["evict_mode"]
            row["evict_state"] = cold["evict_state"]
        if name == "scatter_rows":
            row["load_groups"] = cold["load_groups"]
        if name == "agg_apply":
            row["none_kind"] = cold["none_kind"]
        if name in mesh_join:
            # the shard axis (B24) at q8-mesh's side-epoch
            m = mesh_join[name]
            row["max_abs_err"] = max(row["max_abs_err"], m["max_abs_err"])
            row["sharded"] = {k: m[k] for k in ("ms", "plain_ms",
                                                "bound_ms", "bound_by")}
        if name in PERCHUNK_PATH:
            # the per-chunk step B16 that launches this kernel: its
            # device half at the per-chunk arm's chunk, all four kernels
            row["max_abs_err"] = max(row["max_abs_err"],
                                     step["max_abs_err"])
            row["per_chunk_step"] = {k: step[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")}
        rows.append(row)
    log(f"smoke run (phases 3-5): {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
