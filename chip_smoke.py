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
     plus a SUM(int) / SUM(float) / MIN / COUNT plan over ~20K groups;
     K3's gather also on ``ops/kernel_cases.py``'s edge cases, three calls
     a case, and timed with ``n_dirty`` and its split by kernel; K3's
     advance on each flush's own list, on the advance cases and timed at
     q7's, q7-mesh's and maxbids' states):
     integers exact, K1 (probe_insert) by the table invariants, float
     SUM's hi and lo rows each within rel 1e-6 of the group's summed
     magnitudes in that row; K4's mask, which also zeroes the
     rebuild's fresh table, in every mode with the table at cap and 2 x
     cap, and the rebuilds it serves (retirement and growth at q7's
     2^18 slots, eviction at the capped maxbids arm's sizes, the sharded
     retirement at 8 x 2^15) key-sorted against their plain twins with
     their launches counted; the patched advance (the barrier's
     retractable MIN/MAX write-back in advance's launch) at maxbids' and
     q7-mesh's states; K2 (agg_apply) also on the batches of
     ``ops/kernel_cases.py`` (the edges of its warp aggregation, and its
     shard axis at 8 and 3 shards), and timed at q7's step, the ~20K
     group plan, maxbids' first agg (a 2^20-slot table holding 600K
     groups, a step of Nexmark's own bids) and q7-mesh's routed step;
   - the join kernels at q8's shapes (6 key lanes, 6 payload lanes,
     2^16 rows per side-epoch, ~2M stored rows built through the growth
     ladder 2^20 → 2^22 slots, a 2^16-row pair buffer): K5 (join_apply)
     exact per key (each key's chain of refs, ins/del sequences, payload)
     and on ``ops/kernel_cases.py``'s K5 batches, timed at the fresh and
     the hot-key epochs with its launches a call and its split,
     K6 (join_probe) exact, with and without degrees, including a forced
     overflow (a 2^10-row buffer) that must re-dispatch to the same pairs,
     K7's masked mode and the head remap on K4 exact, K7's scatter and
     gather-carry at each shape the outer arms' compactions, reloads and
     recovery give it (``MASKED_SCATTER_SHAPES``: 1-D degree writes and
     carries with no vis array, from strided columns), and each rebuild
     those paths make (``REBUILD_SHAPES``: K1 + K5 with the payload in
     K5's launch, and K7's carry) against the plain versions;
   - K1 (probe_insert) alone at each shape of its paths, each against the
     plain version by the table invariants and timed beside its byte
     bound: q7's step and q7-mesh's routed step (keys placed), q8's
     side-epoch apply into the ~2M-key table with the keys placed and
     fresh (a copy of the table made anew before each call, L2 flushed),
     and q8-mesh's side-epoch apply (fresh); K8 (lookup) at q8's placed
     keys; K6 (join_probe) split by kernel (torch.profiler) at q8's and
     q8-mesh's epochs and the per-chunk step; and how far a probe walks
     in q8's and q8-mesh's tables (``probe_lengths``);
   - the fused preludes (fused_chain, agg_prelude, join_prelude of
     csrc/fused.cu) bit for bit against the plain program on random
     expression trees that cover every opcode, with edge values (a NaN
     equal to a NaN), and on q1's, q7's and q8's own programs at the
     path's shapes (a 2^15-row agg backlog, 2^16-row join side-epochs,
     q1's 4096-row chunks); q7's agg prelude also in the 8 segments of
     the q7-mesh fused step, with U-/U+ pairs across every block edge;
     on ``ops/fused_cases.py``'s tile-edge cases; and agg_prelude on
     q5-hot's own program (a hop of 5 copies, then (window_start,
     auction)) over a 2^15-row bid batch (163,840 expanded rows) and on
     q3's DECIMAL revenue program (OP_DECMUL) over its second join's
     whole SF1 output, stage counts exact; K2 also exact at q3's DECIMAL
     SUM step (nine key lanes, a 2^20-slot table, the second join's SF1
     output in one 2^15-row step);
   - the sharded path at q7-mesh's shapes: route (csrc/route.cu) bit for
     bit against route_plain on a 2^15-row step in 8 blocks (bucket =
     the block), with a forced overflow and on ``ops/kernel_cases.py``'s
     edge cases, timed with its split by kernel (torch.profiler), and at
     q8-mesh's side-epoch; the shard axis of K1-K4 at
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
     axis at 8 x 2^15 slots and alone at the capped maxbids arm's and
     q7-tier's reload shapes, with ``index_put_`` timed beside it; a
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
   - Nexmark q8 at 100M events, and fused at 20M (both join sides
     absorb their projections: join_prelude; the dedup agg its tumble
     projection: agg_prelude), the fused MV equal to phase 5's unfused
     20M q8 trace;
   - Nexmark q1 at 2M events (bench.py's bench_q1 shape: 4096-row
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
     events, its MV equal to the oracle and to the single-device q8's,
     and fused at 20M, its MV equal to phase 5's 20M q8 trace; and the
     per-chunk arm
     (``HashJoinExecutor(mesh=ShardMesh(8), epoch_batch=False)``, one
     apply_and_probe per chunk) equal to its epoch-batched twin and to
     an oracle on a script with updates, deletes, NULL keys and growth;
   - Nexmark q5's MaxBids over 10 s tumbling windows (two aggs: COUNT(*)
     per (window, auction), then MAX/MIN/COUNT/SUM of the counts per
     window, retractable MIN/MAX patched every barrier in advance's
     launch: the path must launch no scatter_rows)
     at 10M events, and at 2M with a tier cap of 64 groups on the first
     agg (evictions and reloads must both happen), bench_q8's chunking;
   - Nexmark q15's distinct counts per 10 s window (COUNT(*), two
     COUNT(DISTINCT) and approx_count_distinct, K2 with a kNone lane) at
     2M events, q7's chunking: exact counts equal the oracle, the
     estimate equals this script's own dense-HLL registers and is within
     2% of the exact count;
   - q7-core under a tier cap of 8 groups at 2M events (watermark
     retirement on), its MV equal to the oracle and to the uncapped q7's
     (phase 5's traced run at the same size);
   - q8 FULL OUTER (``build_q8_outer``: q8's sources, projections and
     seller dedup joined FULL OUTER, the join's whole output
     materialized, keyed by both sides' pks): on one device at 20M
     events (cut from 100M for q5-hot's and q3's room; the stored rows
     and table slots per side logged), over 8 shards at 20M, under a
     cold-tier cap of 2048 keys a side at 2M (evictions and reloads
     must both happen; K7 masked_scatter carries the compactions'
     degrees and writes the reloads') and killed halfway and rebuilt
     on the same store at 2M (degrees recomputed through K6 and written
     by K7), each MV equal to a vectorized oracle, the capped and
     recovered MVs equal, and the one-device MV equal to the 8-shard
     one (both at 20M); every probe of the one-device arms is K6's
     degree branch (``join_probe_deg``);
   - join modes: all 8 join types on one device and over 8 shards on
     the per-chunk arm's script at 16 chunks a side, with a join-key
     watermark after epoch 1 (state expiry on both kinds of table), each
     view equal to its oracle; plus FULL OUTER with a 1024-row pair
     buffer (a degree-tracked epoch overflows) and LEFT OUTER with
     compaction forced every barrier (degrees carried by K7's gather);
     K7's launches on the three arms must be the rehearsal's
     (``K7_PATH_LAUNCHES``), and no phase-4 path reads the degree array
     to the host (``read_degrees``);
   - Nexmark q5-hot (``build_q5``: hop windows of 10 s sliding by 2 s,
     COUNT(*) per (window_start, auction), the top auction per window
     by GroupTopN) at 1M events with bench_q5's chunking (4096-row
     chunks, 16 a barrier), unfused, fused (the agg absorbs the hop and
     the projection: agg_prelude makes 5 copies of every uploaded row,
     and K1 + K2 must take 5 rows for each) and under a tier cap on
     both stateful stages (each must evict and reload), each MV equal
     to a vectorized oracle (per window the auction with the most bids,
     ties to the smallest id) and the agg's counts summing to 5 x the
     bids; after the unfused arm's check, outside its timed drive, the
     ``q5 hot batch`` step reads the committed agg state (~308K groups)
     and the MV through the batch engine (``batch/``: RowSeqScan,
     BatchHashAgg, the staged BatchTaskManager at parallelism 4,
     BatchOrderBy + BatchLimit, StorageTable.get_row), each read held to
     its oracle, and logs the rows and seconds of each read beside the
     card's name and power limit (``q5_hot_batch``);
   - TPC-H q3 (``build_q3``: customer ⋈ orders ⋈ lineitem, the DECIMAL
     revenue summed per order, the top 10) at SF1 (150,000 customers,
     1,500,000 orders, 6,000,000 lineitems; bench_q3's 1024-row chunks,
     64 a barrier a source), where the second join's right side grows
     its key table to 2^21 slots and its rows to 2^22, and fused at SF0.1 (the
     agg absorbs the revenue projection, OP_DECMUL; the orders and
     lineitem sides their filters and row ids), each MV equal to a
     vectorized oracle with exact DECIMAL revenue, every group of the
     agg's state table (sum and counts) the oracle's, and every join
     side's stored rows the oracle's;
   - the SQL front door (``Frontend(device="cuda")``, the session's
     default rules and fusion): Nexmark q4 in bench_q4's SQL, session
     and sources (4096-row chunks, 16 a barrier, no strings) at 2M
     events (120,000 auctions and 1,840,000 bids, the join holding both
     sides on the card; cut from 100M), its MV equal to a vectorized
     oracle exactly (the MAX bid per auction within its window, then the
     binder's AVG per category: the integer SUM and the COUNT as FLOAT64,
     divided), its inner MAX planned append-only and its outer AVG
     retractable; and TPC-H q3 in tests/test_tpch.py's SQL at SF0.1 with
     build_q3's chunking, its MV equal to the oracle and to the
     ``q3 fused`` arm's; each logs events/s, the p99 barrier latency,
     CREATE's planning seconds, the rules and fusion that fired and
     each kernel's launches; the same q4 with its MV's empty broadcast
     dispatcher removed (the dispatch's cost, same MV and launches);
   - tables, DML, MV on MV and the filelog source in SQL: ad-ctr
     (bench.py's bench_adctr DDL and producer: two filelog topics of
     JSON records, HOP windows, a join, a temporal join against the
     ad_dim MV, a sliding-window agg) at 200,000 impressions and
     parallelism 1, its MV equal to a vectorized oracle and ad_dim
     counting every impression; and an MV chain over 2M events' bids:
     m1 counts bids per auction, m2 (its histogram with MIN) backfills
     m1's committed snapshot mid-stream, then a table filled by INSERT
     ... SELECT from m1, an agg MV over it, a DELETE and an UPDATE, each
     MV equal to its oracle after each statement, with the backfill's
     rows and seconds and each agg's K2 mode;
   - the session at parallelism > 1 (``Frontend(parallelism=n)``: n
     logical shards of the card): ad-ctr as above at bench_adctr's
     parallelism 4, both aggs on ShardedAggKernel(4) and the
     impression-click join on the sharded join kernel, its MV equal to
     the oracle and to parallelism 1's digest; ``ALTER MATERIALIZED VIEW
     ... SET PARALLELISM`` on an agg MV over 2M events' bids, 1 -> 8 at
     half and 8 -> 1 at three quarters, its MV equal to the oracle and to
     an uninterrupted run's, each ALTER's seconds and K9 reload logged;
     and the SQL q4 at 200,000 events on a ``PgServer`` over a
     parallelism-4 session, its DDL and SELECT sent with the extended
     protocol over a loopback socket, the wire's rows equal to the
     session's and to the oracle;
5. where the time goes: q7-core at 2M events and q8 at 2M and 20M
   events, fused q7 and q8 at 2M, q7-mesh and q8-mesh at 2M unfused
   and fused, q8 FULL OUTER at 2M (its MV equal to the capped arm's)
   and under its cold-tier cap (the join's own host functions by
   cumulative time),
   maxbids (uncapped and capped) and distinct at 2M, q5-hot at 1M (its
   MV equal to the fused and capped arms'), q3 at SF0.1 (equal to the
   fused arm's), the SQL q4 at 500K events and ad-ctr at 100,000
   impressions (the sources' read and parse by cumulative time),
   under torch.profiler (the device's busy time and idle share) and
   cProfile (host self-time by module; the sharded path's own host
   functions by cumulative time), after the main paths' counts were
   read.

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``; ``launches`` is the sum of the main paths'
counts) and ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --against DIR [GROUPS]`` runs no phase: it times
K3 (flush_gather, advance), the three fused entries, K2 (agg_apply),
route, K1 (probe_insert), K8 (lookup), K6 (join_probe), K5 (join_apply),
the rebuild chains (K4's mask and fills or its mask-and-table launch,
K1, K4's remap), the patch chain (K9 then advance, or the patched
advance) and the chains K7 serves (a join compaction, recovery's and a
reload's degree write, as host wall time in alternating pairs, DIR's
K7 inside the parent's host code written out) of this checkout against
the same kernels built from DIR's
``risingwave_tpu_torch/csrc`` (the parent commit, unpacked with ``git
archive`` into a directory git ignores), in turns, at the shapes above,
each build first held to the plain version; the other build is compiled
and bound by this script alone. GROUPS, comma-separated, keeps only some
of ``AB_GROUPS`` (and builds only their libraries).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import shutil
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
# q7 coalesced: the connector's default chunk (NexmarkConfig.max_chunk_size),
# 256 a barrier (q7's 32 x 8,192 rows), merged to q7's usual 8,192 rows
Q7_COALESCE_CHUNK = 1024
Q7_COALESCE_CHUNKS = 256
Q7_COALESCE_ROWS = 8192
Q7_COALESCED_EVENTS = Q7_TRACE_EVENTS
Q7_2M_DIGEST = "ec6c64105f800241"   # q7's MV at 2M events (PERF.md)
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
Q1_EVENTS = 2_000_000         # 1.84M bids at bench.py's bench_q1 shape
                              # (cut from 4M: the q8-outer arms' room)
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
# q8-mesh unfused at q8's 100M, its MV held to q8's; q8 fused and q8-mesh
# fused at phase 5's 20M q8 trace (cut from 100M: the q8-outer arms'
# room), each held to that trace's
Q8_FUSED_EVENTS = 20_000_000
MESH_CHUNK_ROWS = 4096        # bench.py's q8 lane chunks
PERCHUNK_CHUNKS = 96          # per side: 393,216 rows
PERCHUNK_EPOCH = 8            # chunks per side between barriers
PERCHUNK_STEP_CHUNKS = 16     # per side in the B16 step check: 2 epochs
HOT_KEYS = 50_000             # perchunk_script's hot key band

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
# fused q8 runs at 20M, where the presized join table never grows: no remap
Q8_FUSED_PATH = tuple(k for k in Q8_PATH if k != "remap") + (
    "agg_prelude", "join_prelude")
Q1_FUSED_PATH = ("fused_chain",)
Q7_MESH_PATH = ("route", "probe_insert", "agg_apply", "flush_gather",
                "advance", "live_mask", "remap")
Q7_MESH_FUSED_PATH = Q7_MESH_PATH + ("agg_prelude",)
Q8_MESH_PATH = ("route",) + Q8_PATH
Q8_MESH_FUSED_PATH = Q8_MESH_PATH + ("agg_prelude", "join_prelude")
# B16 per chunk: route, K6 on the other side, K1 + K5 on this side
PERCHUNK_PATH = ("route", "join_probe", "probe_insert", "join_apply")
# maxbids: the second agg's retractable MIN/MAX patch every barrier, in
# advance's launch (no K9); the capped arm adds the eviction (K8, K4's
# evict mode, K1 + K4 remap) and the reload (K1 + K9)
MAXBIDS_PATH = ("probe_insert", "agg_apply", "flush_gather", "advance")
MAXBIDS_CAPPED_PATH = MAXBIDS_PATH + ("lookup", "live_mask", "remap",
                                      "scatter_rows")
# q8 FULL OUTER: every probe tracks degrees (K6's degree branch); the
# capped arm's evictions compact (K1 + K5, the payload in K5's launch)
# with the degrees carried by K7's gather, and its reloads recompute
# degrees with K6 written by K7; recovery rebuilds (K1 + K5) and
# recomputes degrees (K6, then K7); the mesh's probes carry degree rows
# under the sharded K6's name
# (at 20M, as q8 fused, the presized join table never grows: no remap)
Q8_OUTER_PATH = ("probe_insert", "agg_apply", "flush_gather", "advance",
                 "join_apply", "join_probe_deg")
Q8_OUTER_MESH_PATH = ("route", "probe_insert", "agg_apply", "flush_gather",
                      "advance", "join_apply", "join_probe")
Q8_OUTER_CAPPED_PATH = ("probe_insert", "agg_apply", "flush_gather",
                        "advance", "join_apply", "join_probe_deg",
                        "masked_scatter")
Q8_OUTER_RECOVERY_PATH = Q8_OUTER_CAPPED_PATH
# every join type on one device and 8 shards, expiry, a forced overflow
# and a forced compaction (its degrees carried by K7)
JOIN_MODES_PATH = ("route", "probe_insert", "join_apply", "join_probe",
                   "join_probe_deg", "masked_scatter", "remap")
# K7 masked_scatter's launches on the arms that make any: degree writes
# and carries only (MASKED_SCATTER_SHAPES), the payload riding in K5
K7_PATH_LAUNCHES = {"q8 outer capped": 5, "q8 outer recovery": 2,
                    "join modes": 2}
# kernels a path must not launch: uncapped maxbids' patch rides in advance;
# a FULL OUTER join probes with degrees only
OFF_PATH = {"maxbids": ("scatter_rows",), "q8 outer": ("join_probe",)}
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


def launches_of(fn, name: str) -> int:
    """Launches of kernel `name` that one call of fn makes, as its
    wrapper counts them (K2's wrapper counts each device launch)."""
    from risingwave_tpu_torch.utils.device import LAUNCHES
    before = LAUNCHES.snapshot().get(name, 0)
    fn()
    return LAUNCHES.snapshot().get(name, 0) - before


def _k2_input(state, packed, slots, specs, kw: int = KW) -> dict:
    from risingwave_tpu_torch.ops import hash_agg as H
    return dict(state=state, packed=packed, slots=slots, specs=specs, kw=kw,
                plan=H.ApplyPlan(kw, specs, packed.device))


def _k2_fns(inp) -> tuple:
    """(kernel state, plain state, kernel step, plain step) on two copies
    of the input's state; [S, m, W] rows take the sharded K2."""
    from risingwave_tpu_torch.ops import hash_agg as H
    packed, slots, plan = inp["packed"], inp["slots"], inp["plan"]
    sharded = packed.dim() == 3
    cls = H.ShardedAggState if sharded else H.AggState
    k = cls(inp["state"].table, inp["state"].st.clone())
    p = cls(inp["state"].table, inp["state"].st.clone())
    kern = H.agg_apply_sharded if sharded else H.agg_apply
    plain = H.agg_apply_sharded_plain if sharded else H.agg_apply_plain
    return (k, p, lambda: kern(k, packed, slots, plan),
            lambda: plain(p, packed, slots, plan))


def k2_check(inp, times: int = 1) -> float:
    """K2 against its plain version on copies of one state, `times`
    steps: integers exact, float SUM within rel FLOAT_SUM_RTOL of its
    group's Σ|terms| per lane (shard by shard). Returns the largest
    float error."""
    from risingwave_tpu_torch.ops import kernel_cases as KC
    k, p, fk, fp = _k2_fns(inp)
    packed = inp["packed"].cpu().numpy()
    slots = inp["slots"].cpu().numpy()
    if packed.ndim == 2:
        packed, slots = packed[None], slots[None]
    err = 0.0
    for _ in range(times):
        fk()
        fp()
        x, y = k.st.cpu().numpy(), p.st.cpu().numpy()
        if x.ndim == 2:
            x, y = x[None], y[None]
        for s in range(len(x)):
            err = max(err, KC.agg_state_err(inp["specs"], x[s], y[s],
                                            packed[s], slots[s], inp["kw"]))
    return err


def k2_timed(inp) -> dict:
    """K2's time per call and its plain version's, repeated steps on one
    state (the counts just grow), beside its bound: every row its slot,
    the live rows their packed row, each touched slot its group_rows,
    dirty and accumulator rows read and written."""
    _k, _p, fk, fp = _k2_fns(inp)
    sl = inp["slots"].cpu().numpy()
    sl2 = sl.reshape(-1, sl.shape[-1])
    live = int((sl >= 0).sum())
    touched = sum(len(np.unique(r[r >= 0])) for r in sl2)
    w = inp["packed"].shape[-1]
    nacc = inp["state"].n_acc
    b, by = bound_ms(sl.size * 4 + live * w * 4 + touched * (2 + nacc) * 8,
                     live * 12)
    return dict(ms=time_ms(fk), plain_ms=time_ms(fp), bound_ms=b,
                bound_by=by, launches_per_call=launches_of(fk, "agg_apply"),
                groups_touched=touched)


def maxbids_agg_input(dev) -> dict:
    """MaxBids' first agg at 10M events: COUNT(*) per (window_start,
    auction) (two int64 key columns: six lanes) on a 2^20-slot table
    holding COLD_GROUPS groups (put there by K1), and a 2^15-row step of
    Nexmark's own bids from the middle of the stream (half of them on
    the hot auction, the rest over the 100 in-flight ones), placed by
    K1."""
    from risingwave_tpu_torch.connectors.nexmark import (NexmarkConfig,
                                                         gen_bids)
    from risingwave_tpu_torch.ops import hash_agg as H
    kw = 2 * KW
    specs = make_specs(H, [("count", None)])
    st = H.make_agg_state(COLD_CAP, kw, specs, dev)
    idx = np.arange(COLD_GROUPS, dtype=np.int64)
    keys = np.concatenate([_key_lanes(BASE_US + idx // 100 * W_US),
                           _key_lanes(1000 + idx)], axis=1)
    for lo in range(0, COLD_GROUPS, N):
        kk = torch.from_numpy(keys[lo:lo + N]).to(dev)
        _t, _sl, stats = H.ht.probe_insert(st.table, kk, torch.ones(
            len(kk), dtype=torch.int32, device=dev))
        assert int(stats[1]) == 0
    bids = gen_bids(np.arange(N, dtype=np.int64) + 4_600_000,
                    NexmarkConfig(event_num=MAXBIDS_EVENTS,
                                  generate_strings=False))
    ts = bids["date_time"]
    bkeys = np.concatenate([_key_lanes(ts - ts % W_US),
                            _key_lanes(bids["auction"])], axis=1)
    packed = torch.from_numpy(H.pack_chunk(
        kw, specs, bkeys, np.ones(N, np.int32), np.ones(N, bool),
        (((), None),))).to(dev)
    _t, slots, stats = H.ht.probe_insert(st.table, packed[:, :kw],
                                         packed[:, kw + 1])
    assert int(stats[1]) == 0
    return _k2_input(st, packed, slots, specs, kw)


def k2_inputs(dev) -> dict:
    """K2's timed shapes: q7's step (MAX(price) + COUNT(*), nearly every
    row on one or two slots), the mixed plan over ~20K groups (mostly one
    row a slot), maxbids' first agg, and q7-mesh's routed step (8 shards
    of 8 x 4,096 received rows, one shard taking the whole batch)."""
    from risingwave_tpu_torch.ops import hash_agg as H
    out = {}
    q7 = make_specs(H, [("max", np.int64), ("count", None)])
    q7_np = q7_batch(N, q7)
    p = torch.from_numpy(q7_np).to(dev)
    st, slots = _state_after(dev, q7, p, CAP)
    out["q7"] = _k2_input(st, p, slots, q7)
    mixed = make_specs(H, MIXED_PLAN)
    p = torch.from_numpy(mixed_batch(N, mixed)).to(dev)
    st, slots = _state_after(dev, mixed, p, CAP)
    out["mixed"] = _k2_input(st, p, slots, mixed)
    out["maxbids"] = maxbids_agg_input(dev)
    st, recv, _rv, slots = _mesh_step(dev, q7, q7_np, True)
    out["q7_mesh"] = _k2_input(st, recv, slots, q7)
    return out


def check_agg_cases(dev) -> float:
    """K2 against its plain version on ops/kernel_cases.py's batches (the
    edges of warp aggregation), each applied twice, and on its sharded
    batches at S = 8 and S = 3."""
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.ops import kernel_cases as KC
    err = 0.0
    for specs, packed_np in KC.agg_cases().values():
        packed = torch.from_numpy(packed_np).to(dev)
        st, slots = _state_after(dev, specs, packed, 1 << 14)
        err = max(err, k2_check(_k2_input(st, packed, slots, specs), 2))
    for s in (8, 3):
        specs, packed_np = KC.sharded_agg_batch(s)
        packed = torch.from_numpy(packed_np).to(dev)
        st = H.make_sharded_agg_state(s, 1 << 14, KW, specs, dev)
        slots, stats = H.ht.probe_insert_sharded(
            st.table, packed[:, :, :KW], packed[:, :, KW + 1])
        assert not bool(stats[:, 1].any())
        err = max(err, k2_check(_k2_input(st, packed, slots, specs)))
    return err


def q3_agg_input(dev) -> dict:
    """q3's agg at SF1: SUM over DECIMAL (a scaled int64) per
    (l_orderkey, o_orderdate, o_shippriority), nine key lanes, on its
    presized 2^20-slot table; one step of the second join's whole output
    (30,135 rows at SF1, padded to 2^15 as the kernel pads a step), keys
    and inputs encoded by the executor's own codec, placed by K1."""
    from risingwave_tpu_torch.common.chunk import Column, StreamChunk
    from risingwave_tpu_torch.models.tpch import build_q3
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from risingwave_tpu_torch.stream.executors.keys import LANES_PER_KEY
    agg = build_q3(MemoryStateStore(), customers=10, orders=100,
                   device=dev).actor.consumer.input.input
    cols, _facts = q3_join_rows(*Q3_SF1)
    n = len(cols["l_orderkey"])
    assert n <= N
    vals = {"l_orderkey": cols["l_orderkey"],
            "o_orderdate": cols["o_orderdate"],
            "o_shippriority": cols["o_shippriority"],
            "revenue": cols["l_extendedprice"]
            * (10_000 - cols["l_discount"]) // 10_000}
    sch = agg.input.schema
    cs = []
    for f in sch:
        v = np.zeros(N, f.data_type.np_dtype)
        v[:n] = vals[f.name]
        cs.append(Column(f.data_type, v))
    vis = np.zeros(N, bool)
    vis[:n] = True
    chunk = StreamChunk(sch, cs, vis, np.ones(N, np.int8))
    kw = LANES_PER_KEY * len(agg.group_indices)
    packed = torch.from_numpy(H.pack_chunk(
        kw, agg.specs, agg.key_codec.build(chunk, agg.group_indices),
        chunk.signs(), chunk.visibility, agg._inputs(chunk))).to(dev)
    st = H.make_agg_state(1 << 20, kw, agg.specs, dev)
    _t, slots, stats = H.ht.probe_insert(st.table, packed[:, :kw],
                                         packed[:, kw + 1])
    assert int(stats[1]) == 0
    return _k2_input(st, packed, slots, agg.specs, kw)


def check_agg_apply(dev, cap: int, n: int) -> dict:
    """K2 on the edge cases, then at each timed shape (q3's DECIMAL SUM
    step too): exact against the plain version, then timed. The row's
    own numbers are q7's step."""
    assert (cap, n) == (CAP, N)
    err = check_agg_cases(dev)
    out = {}
    inputs = k2_inputs(dev)
    inputs["q3"] = q3_agg_input(dev)
    for name, inp in inputs.items():
        e = k2_check(inp)
        if name == "q3":
            assert e == 0, f"K2's DECIMAL SUM at q3's step differs: {e}"
        err = max(err, e)
        out[name] = k2_timed(inp)
    return dict(out.pop("q7"), max_abs_err=err, mixed_shape=out["mixed"],
                maxbids_shape=out["maxbids"], sharded=out["q7_mesh"],
                q3_shape=out["q3"])


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


def _maxbids_state(dev):
    """maxbids' first agg after one applied step (kernels): a 2^20-slot
    state, more tiles than the card holds K3 blocks."""
    from risingwave_tpu_torch.ops import hash_agg as H
    inp = maxbids_agg_input(dev)
    H.agg_apply(inp["state"], inp["packed"], inp["slots"], inp["plan"])
    return inp["state"]


def check_flush_gather(dev, cap: int, n: int) -> dict:
    from risingwave_tpu_torch.ops import hash_agg as H
    _specs, st = _mixed_state(dev, cap, n)
    err = check_k3_edges(dev)
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
    b, by = k3_bound(qs.st[None], qs.table.keys[None], flush_cap)
    mbs = _maxbids_state(dev)
    k = H.flush_gather(mbs, flush_cap)
    err = max(err, abs_err(k.cpu().numpy(), H.flush_gather_plain(
        mbs, flush_cap).cpu().numpy()))
    assert err == 0, f"flush_gather differs at maxbids' state: {err}"
    mb, mby = k3_bound(mbs.st[None], mbs.table.keys[None], flush_cap)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by,
                n_dirty=int((qs.st[H.ROW_DIRTY] != 0).sum()),
                split=kernel_split(lambda: H.flush_gather(qs, flush_cap)),
                maxbids_shape=dict(
                    ms=time_ms(lambda: H.flush_gather(mbs, flush_cap)),
                    plain_ms=time_ms(lambda: H.flush_gather_plain(
                        mbs, flush_cap)),
                    bound_ms=mb, bound_by=mby, cap=int(mbs.st.shape[1]),
                    n_dirty=int(k[0, 0])))


def check_k3_edges(dev) -> float:
    """K3's gather on ``kernel_cases``' edge cases and its shard axis at
    1, 3 and 8 shards, three calls a case (each launch on the scan words
    the one before it zeroed), bit for bit against the plain version."""
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.ops import kernel_cases as KC
    cases = dict(KC.k3_cases())
    cases.update({f"{s} shards": KC.k3_sharded_case(s)
                  for s in KC.K3_SHARDS})
    err = 0.0
    for name, (fc, st, keys, occ) in cases.items():
        state = H.ShardedAggState(
            H.ht.TableState(torch.from_numpy(keys).to(dev),
                            torch.from_numpy(occ).to(dev)),
            torch.from_numpy(st).to(dev))
        want = H.flush_gather_sharded_plain(state, fc).cpu().numpy()
        for _ in range(3):
            err = max(err, abs_err(
                H.flush_gather_sharded(state, fc).cpu().numpy(), want))
        assert err == 0, f"flush_gather differs on the {name} case: {err}"
    return err


def check_advance(dev, cap: int, n: int) -> dict:
    """K3's advance on the flush's own list: exact against the plain
    sweep on the mixed plan's state and on ``kernel_cases``' advance
    cases, then timed at q7's state (2^18 slots), q7-mesh's (8 x 2^15)
    and maxbids' (2^20, ~2,200 dirty) beside the plain version of the
    list-driven advance and the bound of its bytes; its patched mode at
    q7-mesh's and maxbids' states, exact against scatter_rows_plain at
    the list's slots then advance_listed_plain, timed alone and as the
    barrier's chain (the columns' upload, then the launch)."""
    from risingwave_tpu_torch.ops import hash_agg as H
    _specs, st = _mixed_state(dev, cap, n)
    k = H.AggState(st.table, st.st.clone())
    p = H.AggState(st.table, st.st.clone())
    H.advance(k, H.flush_gather(k, 1 << 15))
    H.advance_plain(p)
    err = max(abs_err(k.st.cpu().numpy(), p.st.cpu().numpy()),
              check_advance_edges(dev))
    assert err == 0, err
    out = {}
    cases = advance_ab_cases(dev)
    for name, (state, mats) in cases.items():
        k = H.ShardedAggState(state.table, state.st.clone())
        p = H.ShardedAggState(state.table, state.st.clone())
        k2 = H.ShardedAggState(state.table, state.st.clone())
        H.advance_sharded(k, mats, current=True)
        H.advance_sharded(k2, mats)
        H.advance_sharded(p)
        err = max(err, abs_err(k.st.cpu().numpy(), p.st.cpu().numpy()),
                  abs_err(k2.st.cpu().numpy(), p.st.cpu().numpy()))
        assert err == 0, f"advance differs at {name}: {err}"
        # timed in place: after the first call the listed slots are no
        # longer dirty, and each call advances them again (with the
        # matrix's values, as when no patch ran; patched_ms: from the
        # state's rows, as after a patch written alone)
        ms = time_ms(lambda: H.advance_sharded(k, mats, current=True))
        patched_ms = time_ms(lambda: H.advance_sharded(k2, mats))
        plain_ms = time_ms(lambda: [H.advance_listed_plain(
            p.shard(s), mats[s]) for s in range(p.n_shards)])
        b, by = advance_bound(state)
        out[name] = dict(ms=ms, patched_ms=patched_ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by,
                         n_dirty=(state.st[:, H.ROW_DIRTY] != 0).sum(
                             dim=1).tolist(),
                         flush_cap=int(mats.shape[1]) - 1,
                         split=kernel_split(lambda: H.advance_sharded(
                             k, mats, current=True)))
    # the patched mode: the list's slots take the patch's columns in the
    # same launch, exact against K9's plain version at the list's slots
    # followed by the listed advance's
    for name, (state, mats, idx, src) in patch_ab_cases(dev, cases).items():
        col = torch.from_numpy(src).to(dev)
        k = H.ShardedAggState(state.table, state.st.clone())
        p = H.ShardedAggState(state.table, state.st.clone())
        H.advance_sharded(k, mats, patch=col)
        patch_plain(p, mats, idx, src)
        err = max(err, abs_err(k.st.cpu().numpy(), p.st.cpu().numpy()))
        assert err == 0, f"the patched advance differs at {name}: {err}"
        n = int(mats[:, 0, 0].sum())
        b, by = bound_ms(src.size * 4 + n * 2 * 4
                         + n * (2 * state.n_acc + 3) * 4, n)
        out[name]["patch"] = dict(
            ms=time_ms(lambda: H.advance_sharded(k, mats, patch=col)),
            chain_ms=time_ms(lambda: patch_mine(k, mats, idx, src)),
            plain_ms=time_ms(lambda: patch_plain(p, mats, idx, src)),
            bound_ms=b, bound_by=by, pad=int(src.shape[2]),
            launches_per_call=launches_of(
                lambda: H.advance_sharded(k, mats, patch=col), "advance"))
    q7, mesh, mb = out.values()
    return dict(q7, max_abs_err=err, mesh_shape=mesh, maxbids_shape=mb)


def check_advance_edges(dev) -> float:
    """advance on ``kernel_cases``' advance cases, on each flush's own
    list and as a sweep, against the plain sweep."""
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.ops import kernel_cases as KC
    err = 0.0
    for name in KC.ADVANCE_CASES:
        fc, st, keys, occ = KC.advance_case(name)

        def state():
            return H.ShardedAggState(
                H.ht.TableState(torch.from_numpy(keys).to(dev),
                                torch.from_numpy(occ).to(dev)),
                torch.from_numpy(st).to(dev))
        a, b, c, d = state(), state(), state(), state()
        H.advance_sharded(a, H.flush_gather_sharded(a, fc))
        H.advance_sharded(d, H.flush_gather_sharded(d, fc), current=True)
        H.advance_sharded(b)
        for s in range(c.n_shards):
            H.advance_plain(c.shard(s))
        for x in (a, b, d):
            err = max(err, abs_err(x.st.cpu().numpy(), c.st.cpu().numpy()))
        assert err == 0, f"advance differs on the {name} case: {err}"
    return err


def check_live_mask(dev, cap: int, n: int) -> dict:
    """K4's mask launch, which also zeroes the rebuild's fresh table: in
    every mode (growth, retirement, eviction, every occupied slot), with
    the table at cap and at 2 x cap slots, exact against live_mask_plain
    and a zeroed table (the launch's table memory first holds garbage);
    timed at a q7 retirement (2^18 slots, K = 3) with the table, its
    bound the mask's bytes and the cleared table's, and without it (the
    mask alone)."""
    from risingwave_tpu_torch.ops import cuda as kcuda
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.ops import lanes
    _specs, st = _mixed_state(dev, cap, n)
    H.advance(st)
    hi, lo = lanes.split_i64(np.asarray([10_000 * 7_919], dtype=np.int64))
    dropped = torch.from_numpy((np.random.default_rng(9).random(cap) < 0.3)
                               .astype(np.int32)).to(dev)
    err = 0.0
    for mode in (H.LIVE_GROW, H.LIVE_RETIRE, H.LIVE_EVICT, H.LIVE_OCCUPIED):
        d = dropped if mode == H.LIVE_EVICT else None
        p = H.live_mask_plain(st, mode, 0, int(hi[0]), int(lo[0]), d)
        for new_cap in (cap, 2 * cap):
            k, table = H.live_and_table(st, mode, new_cap, 0, int(hi[0]),
                                        int(lo[0]), d)
            err = max(err, abs_err(k.cpu().numpy(), p.cpu().numpy()),
                      float(table.keys.abs().max()),
                      float(table.occ.abs().max()))
            if dev.type != "cuda":
                continue
            # the entry point on a table that holds garbage before it
            live = torch.empty(cap, dtype=torch.int32, device=dev)
            keys = torch.full((new_cap, KW), -7, dtype=torch.int32,
                              device=dev)
            occ = torch.full((new_cap,), -7, dtype=torch.int32, device=dev)
            kcuda.call("rebuild", "rw_live_mask", mode, st.st.data_ptr(),
                       st.table.keys.data_ptr(), st.table.occ.data_ptr(),
                       cap, KW, 0, int(hi[0]), int(lo[0]), st.st.numel(), 1,
                       None if d is None else d.data_ptr(), live.data_ptr(),
                       keys.data_ptr(), occ.data_ptr(), new_cap)
            err = max(err, abs_err(live.cpu().numpy(), p.cpu().numpy()),
                      float(keys.abs().max()), float(occ.abs().max()))
        err = max(err, abs_err(H.live_mask(st, mode, 0, int(hi[0]),
                                           int(lo[0]), d).cpu().numpy(),
                               p.cpu().numpy()))
        if mode == H.LIVE_RETIRE:
            assert 0 < int(k.sum()) < int((st.table.occ != 0).sum())
    assert err == 0, err
    _q7, qs = _q7_state(dev, cap, n)
    ms = time_ms(lambda: H.live_and_table(qs, H.LIVE_RETIRE, cap, 0, 0, 0))
    plain_ms = time_ms(lambda: (H.live_mask_plain(qs, H.LIVE_RETIRE, 0, 0,
                                                  0),
                                H.ht.make_state(cap, KW, dev)))
    n_occ = int((qs.table.occ != 0).sum())
    mask_bytes = cap * 4 + n_occ * (3 + KW) * 4 + cap * 4
    b, by = bound_ms(mask_bytes + cap * (KW + 1) * 4, cap * 8)
    mb, mby = bound_ms(mask_bytes, cap * 8)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None,
                mask_only=dict(ms=time_ms(lambda: H.live_mask(
                    qs, H.LIVE_RETIRE, 0, 0, 0)), bound_ms=mb,
                    bound_by=mby),
                split=kernel_split(lambda: H.live_and_table(
                    qs, H.LIVE_RETIRE, cap, 0, 0, 0)))


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


def check_rebuild_chains(dev) -> dict:
    """retire_state and grow_state at q7's 2^18 slots (growth to 2^19),
    evict_state at the capped maxbids arm's sizes and the sharded
    retirement (``rebuild_sharded``) at q7-mesh's 8 x 2^15 slots, each
    key-sorted exact against its plain twin, with its launches a call by
    kernel (LAUNCHES, and every device activity by torch.profiler), its
    time, its plain twin's and the bound of its bytes."""
    out = {}
    for name, case in rebuild_ab_cases(dev).items():
        got, stats = rebuild_mine(case)
        err = abs_err(_groups(got), _groups(rebuild_plain(case)))
        assert err == 0 and not bool(stats[:, 1].any()), \
            f"the rebuild differs from its plain twin at {name}: {err}"
        b, by = bound_ms(rebuild_bytes(case, got), 0)
        out[name] = dict(
            max_abs_err=err, ms=time_ms(lambda c=case: rebuild_mine(c)),
            plain_ms=time_ms(lambda c=case: rebuild_plain(c), 3, 1),
            bound_ms=b, bound_by=by,
            launches_per_call={k: launches_of(
                lambda c=case: rebuild_mine(c), k)
                for k in ("lookup", "live_mask", "probe_insert", "remap")},
            split=launch_split(lambda c=case: rebuild_mine(c)))
    return out


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


def _k5_call(js, up, aux):
    """One K5 wrapper call of an epoch's apply, on copies of the side (K1
    gave the slots on a copy of its table)."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import hash_table as ht
    ks = js["ks"]
    ins = aux[:, J.AUX_FLAGS] & J.FLAG_INS
    kt, kc, kp = _clone_side(ks.table.state, ks.chains, ks.pay)
    _t, kslots, _s = ht.probe_insert(kt, up[:, :JKW], ins)
    return lambda: J.join_apply(kc, kp, kslots, up, aux, JKW,
                                scratch=ks._link_scratch)


def _k5_times(js, up, aux) -> tuple:
    """(K5 ms, plain K5 ms, K5 bytes) of one epoch's apply on copies of
    both sides (K5 repeated on the slots K1 gave: it never walks the
    chains it rewrites)."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import hash_table as ht
    ins = aux[:, J.AUX_FLAGS] & J.FLAG_INS
    ms = time_ms(_k5_call(js, up, aux))
    qt, qc, qp = _clone_side(*js["plain"])
    qslots, _s = ht.probe_insert_plain(qt, up[:, :JKW], ins != 0)
    plain_ms = time_ms(lambda: J.join_apply_plain(qc, qp, qslots, up, aux,
                                                  JKW))
    return ms, plain_ms, k5_bytes(_epoch_parts(qslots, up, aux))


def _epoch_parts(slots, up, aux) -> dict:
    """One epoch's K5 row inputs (the aux columns, the payload lanes) on
    the slots K1 gave."""
    from risingwave_tpu_torch.ops import hash_join as J
    f = aux[:, J.AUX_FLAGS]
    return dict(slots=slots, ins_ok=f, ins_bits=J.FLAG_INS,
                ins_ref=aux[:, J.AUX_INS_REF], seq=aux[:, J.AUX_SEQ],
                del_ok=f, del_bits=J.FLAG_DEL, del_ref=aux[:, J.AUX_DEL_REF],
                pay_src=up[:, JKW:])


def check_join_apply(dev, js: dict) -> dict:
    """K5, exact per key: after the stored epochs and the mixed epoch,
    each occupied key's head and the ref-indexed next (so each key's
    chain of refs), ins/del sequences and payload; and exact on
    ``kernel_cases``' K5 batches (``check_k5_edges``). Timed on the fresh
    epoch (q8's shape: every row a new key) and on the mixed epoch (the
    hot-key epoch: ~400 rows of each of 8 keys in one epoch), with its
    launches a wrapper call and its split by kernel."""
    from risingwave_tpu_torch.ops import hash_join as J
    ks = js["ks"]
    pt, pc, ppay = js["plain"]
    mu, ma, mr = js["mixed"]
    edge_err = check_k5_edges(dev)
    hot_ms, hot_plain_ms, hot_bytes = _k5_times(js, mu, ma)
    ks.apply_epoch(mu, ma, js["n"], mr)
    J.epoch_apply_plain(pt, pc, ppay, mu, ma, JKW)
    ks.table.sync_count()
    err = 0.0
    for a, b in zip(_by_key(ks.table.state, ks.chains), _by_key(pt, pc)):
        err = max(err, abs_err(a, b))
    for a, b in zip((*ks.chains[1:], ks.pay), (*pc[1:], ppay)):
        err = max(err, abs_err(a.cpu().numpy(), b.cpu().numpy()))
    assert err == 0, f"join_apply differs from the plain chains: {err}"
    err = max(err, edge_err)
    ms, plain_ms, nbytes = _k5_times(js, *js["fresh"])
    b, by = bound_ms(nbytes, js["n"] * 16)
    hb, hby = bound_ms(hot_bytes, js["n"] * 16)
    log(f"join_apply key table capacities while building: "
        f"{sorted(set(js['caps']))}")
    call = _k5_call(js, *js["fresh"])
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, epoch_apply=_epoch_apply_times(js, nbytes),
                hot_key_shape=dict(ms=hot_ms, plain_ms=hot_plain_ms,
                                   bound_ms=hb, bound_by=hby),
                launches_per_call=launches_of(call, "join_apply"),
                split=kernel_split(call))


def check_k5_edges(dev) -> float:
    """K5 on ``kernel_cases``' K5 batches, twice on one scratch (the
    second launch's generation makes the first's bucket words stale),
    exact against the plain version."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import kernel_cases as KC
    err = 0.0
    for name in KC.K5_CASES:
        c = KC.k5_case(name)
        chains, pay, parts = KC.k5_tensors(c, dev)
        want_c, want_p, _p = KC.k5_tensors(c, dev)
        scratch = J.link_scratch(chains.head)
        for _ in range(2):
            KC.k5_launch(chains, pay, parts, scratch)
            KC.k5_plain(want_c, want_p, parts)
            for x, y in zip(KC.k5_result(chains, pay),
                            KC.k5_result(want_c, want_p)):
                err = max(err, abs_err(x, y))
        assert err == 0, f"join_apply differs on the {name} case: {err}"
    return err


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


def _probe_bytes(js, mat, with_degrees, rows, which="probe") -> float:
    """K6's byte bound on one probe epoch (js[which]): the header and the
    pairs it writes are charged, not the unwritten rest of the pair
    buffer."""
    n = js["n"]
    _pu, pa = js[which]
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
        # the hot-key epoch's plain walk takes ~0.5 s a call: 5 calls
        times[which] = (time_ms(k), time_ms(p, *(
            (5, 1) if which == "probe_hot" else ())), km[0])
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
    """K6 with degrees, as outer, semi and anti joins probe on one device
    (phase 4's q8-outer arm, its capped and recovered arms and the join
    modes): at q8's degree epoch (the 2^16-row side-epoch against the
    other side's ~2M stored rows) and its hot-key epoch, the matrix,
    deg_self' and deg_sink' exact on both."""
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


# K7 masked_scatter at each shape phase 4's paths give it: name -> (mode,
# rows of the array written, rows of the array read (the carry's old
# degree array; a scatter reads its n values), refs, the span they lie
# in, the index's and the values' row strides as the path passes them,
# launches of that shape a smoke run makes). A CPU rehearsal of the
# capped and recovered q8-outer arms and the join modes (2M events; every
# call's refs sorted and distinct, every row visible: no vis array)
# gives 9 launches: the capped arm's 4 compactions carry 1,536 live
# rows' degrees (the index the 17th lane of the rebuild's one upload),
# its reload writes 6,931 degrees in 8,467 rows (refs the staged aux's
# column, values K6's degree column); recovery writes 40,000 and 15,115
# degrees a side (K6's column); the join modes' compaction run carries
# 15,104 and 35,693 rows of 2^16 (14 lanes a row). The payload goes
# with K5 (REBUILD_SHAPES).
MASKED_SCATTER_SHAPES = {
    "capped compaction carry": ("gather", 1 << 18, 1 << 18, 1536, 40000,
                                17, 1, 4),
    "capped reload degrees": ("scatter", 1 << 18, 6931, 6931, 8467, 4, 2,
                              1),
    "recovery degrees 40,000": ("scatter", 1 << 18, 40000, 40000, 40000,
                                1, 2, 1),
    "recovery degrees 15,115": ("scatter", 1 << 18, 15115, 15115, 15115,
                                1, 2, 1),
    "join modes carry 15,104": ("gather", 1 << 16, 1 << 16, 15104, 26456,
                                14, 1, 1),
    "join modes carry 35,693": ("gather", 1 << 16, 1 << 16, 35693, 40934,
                                14, 1, 1),
}
# JoinSideKernel.rebuild at each rebuild phase 4's paths make (the same
# rehearsal): name -> (rows rebuilt, the side's row capacity, whether it
# carries degrees, launches). Each is one K1 + one K5, the payload lanes
# written in K5's launch: 10 rebuilds, none launching K7 for payload
REBUILD_SHAPES = {
    "capped compaction 1,536": (1536, 1 << 18, True, 4),
    "recovery 40,000": (40000, 1 << 18, False, 1),
    "recovery 15,115": (15115, 1 << 18, False, 1),
    "join modes 15,104": (15104, 1 << 16, True, 1),
    "join modes 15,133": (15133, 1 << 16, False, 1),
    "join modes 35,693": (35693, 1 << 16, True, 1),
    "join modes 35,712": (35712, 1 << 16, False, 1),
}


def _column(t: torch.Tensor, stride: int) -> torch.Tensor:
    """t ([n]) as the last column of an [n, stride] matrix, rows `stride`
    ints apart (1: t itself)."""
    if stride == 1:
        return t.contiguous()
    m = torch.zeros((int(t.shape[0]), stride), dtype=torch.int32,
                    device=t.device)
    m[:, -1] = t
    return m[:, -1]


def _payload_scatter_case(dev, cap: int, width: int, n: int, seed: int
                          ) -> dict:
    """K7's masked mode (a vis array) on payload rows against its plain
    version: n sorted distinct refs of a [cap, width] array with every
    row visible, then a tenth hidden, refs shuffled and some out of
    range. Its times after an L2 flush."""
    from risingwave_tpu_torch.ops import hash_join as J
    rng = np.random.default_rng(seed)
    arr = torch.from_numpy(rng.integers(-2**31, 2**31, (cap, width))
                           .astype(np.int32)).to(dev)
    ref_np = np.sort(rng.choice(n, n, replace=False)).astype(np.int32)
    refs = torch.from_numpy(ref_np).to(dev)
    vis = torch.ones(n, dtype=torch.int32, device=dev)
    vals = torch.from_numpy(rng.integers(-2**31, 2**31, (n, width))
                            .astype(np.int32)).to(dev)
    err = abs_err(J._masked_scatter(arr.clone(), refs, vis, vals)
                  .cpu().numpy(),
                  J._masked_scatter_plain(arr.clone(), refs, vis, vals)
                  .cpu().numpy())
    odd = rng.permutation(ref_np)
    odd[rng.random(n) < 0.02] = -1
    odd[rng.random(n) < 0.02] = cap + 7
    odd_t = torch.from_numpy(odd).to(dev)
    hid = torch.from_numpy((rng.random(n) >= 0.1).astype(np.int32)).to(dev)
    err = max(err, abs_err(
        J._masked_scatter(arr.clone(), odd_t, hid, vals).cpu().numpy(),
        J._masked_scatter_plain(arr.clone(), odd_t, hid, vals)
        .cpu().numpy()))
    r64 = refs.to(torch.int64)
    b, by = bound_ms(n * (8 + width * 4) + n * width * 4, n * width)
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: J._masked_scatter(arr, refs, vis, vals),
                   cold=True),
        plain_ms=time_ms(lambda: J._masked_scatter_plain(arr, refs, vis,
                                                         vals), cold=True),
        library_ms=time_ms(lambda: arr.index_put_((r64,), vals), cold=True),
        bound_ms=b, bound_by=by)


def _k7_path_case(dev, mode: str, rows: int, src_rows: int, n: int,
                  span: int, i_stride: int, v_stride: int, seed: int
                  ) -> dict:
    """K7 in one mode against its plain version as a path calls it: n
    sorted distinct refs in [0, span), no vis array, the index and the
    values at the path's row strides; then exact with a tenth of the rows
    hidden (a vis array), refs shuffled and some negative or out of
    range. Its times after an L2 flush (the paths meet it after a
    rebuild or a probe), its byte bound (each index and value read once,
    each value written once) and the one PyTorch call that computes the
    same function: index_put_ for the scatter, index_select into the
    fresh array for the carry (their int64 index made beforehand)."""
    from risingwave_tpu_torch.ops import hash_join as J
    rng = np.random.default_rng(seed)
    gather = mode == "gather"
    dst = torch.from_numpy(rng.integers(-2**31, 2**31, rows)
                           .astype(np.int32)).to(dev)
    src = _column(torch.from_numpy(rng.integers(-2**31, 2**31, src_rows)
                                   .astype(np.int32)).to(dev), v_stride)
    ref_np = np.sort(rng.choice(span, n, replace=False)).astype(np.int32)
    idx = _column(torch.from_numpy(ref_np).to(dev), i_stride)

    def kern(d, i, v=None):
        return J._gather_carry(d, src, i, v) if gather \
            else J._masked_scatter(d, i, v, src)

    def plain(d, i, v=None):
        return J._gather_carry_plain(d, src, i, v) if gather \
            else J._masked_scatter_plain(d, i, v, src)
    err = abs_err(kern(dst.clone(), idx).cpu().numpy(),
                  plain(dst.clone(), idx).cpu().numpy())
    odd = rng.permutation(ref_np)
    odd[rng.random(n) < 0.02] = -1
    odd[rng.random(n) < 0.02] = (src_rows if gather else rows) + 7
    odd_t = _column(torch.from_numpy(odd).to(dev), i_stride)
    hid = torch.from_numpy((rng.random(n) >= 0.1).astype(np.int32)).to(dev)
    err = max(err, abs_err(kern(dst.clone(), odd_t, hid).cpu().numpy(),
                           plain(dst.clone(), odd_t, hid).cpu().numpy()))
    i64 = torch.from_numpy(ref_np.astype(np.int64)).to(dev)
    head = dst[:n]
    b, by = bound_ms(3 * n * 4, n)
    return dict(
        mode=mode, max_abs_err=err,
        ms=time_ms(lambda: kern(dst, idx), cold=True),
        plain_ms=time_ms(lambda: plain(dst, idx), cold=True),
        library_ms=time_ms(
            (lambda: torch.index_select(src, 0, i64, out=head)) if gather
            else (lambda: dst.index_put_((i64,), src)), cold=True),
        bound_ms=b, bound_by=by)


def check_rebuild_payload(dev) -> dict:
    """JoinSideKernel.rebuild at each shape of REBUILD_SHAPES on the card
    (q8-outer's 6 key and 6 payload lanes): one K1 and one K5 (the
    payload lanes in K5's launch), plus one K7 gather when it carries
    degrees, and no other launch; heads per key, next, the sequences, the
    payload and the degrees exact against the plain versions on the same
    upload (K1, K5 and K7's carry written out), on the card. Timed as a
    wrapper call (the chain's device time, its upload included)."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.utils.device import LAUNCHES
    out = {}
    for i, (name, (n, row_cap, carry, launches)) in enumerate(
            REBUILD_SHAPES.items()):
        rng = np.random.default_rng(60 + i)
        up = _join_up(*_person(rng.permutation(4 * n)[:n]))
        keys, pay = up[:, :JKW], rng.integers(-2**31, 2**31, (n, JP)) \
            .astype(np.int32)
        refs = np.arange(n, dtype=np.int32)
        live = np.sort(rng.choice(min(row_cap, 41000), n,
                                  replace=False)) \
            .astype(np.int32) if carry else None
        k = J.JoinSideKernel(JKW, key_capacity=ht.MIN_CAPACITY,
                             row_capacity=row_cap, payload_width=JP,
                             device=dev)
        old = torch.from_numpy(rng.integers(0, 50, row_cap)
                               .astype(np.int32)).to(dev)
        k.deg = old.clone()
        LAUNCHES.reset()
        k.rebuild(keys, refs, pay, carry=live)
        got = LAUNCHES.snapshot()
        want = {"probe_insert": 1, "join_apply": 1}
        if carry:
            want["masked_scatter"] = 1
        assert got == want, f"rebuild at {name} launched {got}"
        cap = k.table.capacity
        table = ht.make_state(cap, JKW, dev)
        chains = J.make_chains(cap, k.row_capacity, dev)
        ppay = torch.zeros((k.row_capacity, JP), dtype=torch.int32,
                           device=dev)
        aux = np.zeros((n, 4), np.int32)
        aux[:, J.AUX_INS_REF] = refs
        aux[:, J.AUX_DEL_REF] = -1
        aux[:, J.AUX_FLAGS] = J.FLAG_INS
        J.epoch_apply_plain(table, chains, ppay, torch.from_numpy(
            np.concatenate([keys, pay], axis=1)).to(dev),
            torch.from_numpy(aux).to(dev), JKW)
        pdeg = torch.zeros(k.row_capacity, dtype=torch.int32, device=dev)
        if carry:
            J._gather_carry_plain(pdeg, old, torch.from_numpy(live).to(dev))
        err = max(abs_err(a, b) for a, b in zip(_by_key(k.table.state,
                                                        k.chains),
                                                _by_key(table, chains)))
        for a, b in zip((*k.chains[1:], k.pay, k.deg),
                        (*chains[1:], ppay, pdeg)):
            err = max(err, abs_err(a.cpu().numpy(), b.cpu().numpy()))
        assert err == 0, f"the rebuild differs at {name}: {err}"
        out[name] = dict(
            rows=n, row_capacity=row_cap, carry=carry, launches=launches,
            max_abs_err=err, launches_per_call=got,
            ms=time_ms(lambda: k.rebuild(keys, refs, pay, carry=live)))
        log(f"rebuild at {name}: " + json.dumps(out[name]))
    return out


def check_masked_scatter(dev, js: dict) -> dict:
    """K7 masked_scatter's masked mode at a q8-sized compaction of payload
    lanes (2^20 live rows into a fresh [row_cap, 6] store: on no path
    since the payload rides in K5, kept as the masked mode's check), then
    each mode at each shape of MASKED_SCATTER_SHAPES, where
    ``path_loss_ms`` sums launches x (ms - bound) over them: the loss its
    paths' launches make; and the rebuilds (K5's payload) of
    REBUILD_SHAPES."""
    rows = js["ks"].row_capacity
    n = min(1 << 20, rows)
    out = _payload_scatter_case(dev, rows, JP, n, 9)
    shapes, loss = {}, 0.0
    for i, (name, (mode, cap, src_rows, k, span, i_stride, v_stride,
                   launches)) in enumerate(MASKED_SCATTER_SHAPES.items()):
        c = _k7_path_case(dev, mode, cap, src_rows, k, span, i_stride,
                          v_stride, 40 + i)
        assert c["max_abs_err"] == 0, \
            f"masked_scatter differs at {name}: {c['max_abs_err']}"
        shapes[name] = dict(c, rows=cap, refs=k, span=span,
                            strides=[i_stride, v_stride], launches=launches)
        loss += launches * (c["ms"] - c["bound_ms"])
        log(f"masked_scatter at {name}: " + json.dumps(shapes[name]))
    assert out["max_abs_err"] == 0, \
        f"masked_scatter differs: {out['max_abs_err']}"
    return dict(out, path_shapes=shapes, path_loss_ms=loss,
                rebuild_payload=check_rebuild_payload(dev))


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


def traced_summary(prof, host, wall: float) -> dict:
    """Device busy time and idle share of a torch.profiler run (the rule
    of the profiler's own table: device events' self time), and the host
    self-time by source of its cProfile run over ``wall`` seconds."""
    import pstats
    from torch.autograd import DeviceType
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    stats = pstats.Stats(host)
    traced = dict(device_busy_ms=busy_us / 1e3 if busy_us else None,
                  device_idle_share=(1 - busy_us / 1e6 / wall
                                     if busy_us else None),
                  host_self_s=host_split(stats))
    ingest = ingest_host_fns(stats)
    if ingest:
        traced["ingest_cum_s"] = ingest
        traced["ingest_share_of_wall"] = sum(
            v for k, v in ingest.items() if k.endswith(":next_chunk")) / wall
    parallel = mesh_host_fns(stats)
    if parallel:
        traced["parallel_cum_s"] = parallel
    joined = join_host_fns(stats)
    if joined:
        traced["join_cum_s"] = joined
    return traced


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
        from torch.profiler import ProfilerActivity, profile
        host = cProfile.Profile()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            host.enable()
            elapsed, rows = run()
            host.disable()
            wall = time.perf_counter() - t0     # not the trace's teardown
        traced = traced_summary(prof, host, wall)
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
           fusion: bool = False, tier_cap=None,
           coalesce: bool = False) -> dict:
    """q7-core through build_q7 + drive_to_completion; the MV must equal
    the oracle. With ``fusion`` the agg must have absorbed the tumble
    projection; with ``tier_cap`` the agg runs under the cold tier. With
    ``coalesce`` the source cuts the connector's default 1,024-row chunks
    (256 a barrier: q7's 32 x 8,192 rows) and a CoalesceExecutor merges
    them into Q7_COALESCE_ROWS-row chunks in front of the agg; the
    coalescer must merge at least 4:1 and the agg's device steps
    (apply_batch: one K1 + K2 step each) be no more than its output
    chunks."""
    from risingwave_tpu_torch.common.types import Interval
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.models.nexmark import build_q7
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from risingwave_tpu_torch.stream.coalesce import CoalesceExecutor
    from risingwave_tpu_torch.utils.metrics import STREAMING

    chunk_rows, per_barrier = (Q7_COALESCE_CHUNK, Q7_COALESCE_CHUNKS) \
        if coalesce else (8192, 32)
    cfg = NexmarkConfig(event_num=events, max_chunk_size=chunk_rows,
                        generate_strings=False)
    p = build_q7(MemoryStateStore(), cfg, rate_limit=per_barrier,
                 min_chunks=per_barrier,
                 watermark_delay=Interval(usecs=0), device=dev,
                 fusion=fusion, tier_cap=tier_cap,
                 coalesce_rows=Q7_COALESCE_ROWS if coalesce else None)
    agg = p.actor.consumer.input
    assert (agg.fused_stages is not None) == fusion, "fusion did not fire"
    assert isinstance(agg.input, CoalesceExecutor) == coalesce
    n_bids = events * 46 // 50
    counters = (STREAMING.coalesce_chunks_in, STREAMING.coalesce_chunks_out,
                STREAMING.device_dispatch)
    before = [c.total() for c in counters]
    steps = []
    plain_apply = H.apply_batch
    H.apply_batch = lambda *a: steps.append(1) or plain_apply(*a)
    try:
        out = drive(p, {1: n_bids}, dev, trace)
    finally:
        H.apply_batch = plain_apply
    c_in, c_out, dispatch = (int(c.total() - b)
                             for c, b in zip(counters, before))
    got = {r[0]: (r[1], r[2]) for _pk, r in p.mv_table.iter_rows()}
    want = q7_oracle(cfg, n_bids)
    assert got == want, "q7 MV differs from the oracle"
    assert p.reader.offset == n_bids
    extra = dict(device_dispatch=dispatch, agg_steps=len(steps))
    if coalesce:
        assert c_in >= 4 * c_out > 0, \
            f"the coalescer merged {c_in} chunks into {c_out}"
        assert len(steps) <= c_out, \
            f"{len(steps)} agg steps for {c_out} coalesced chunks"
        extra.update(coalesce_chunks_in=c_in, coalesce_chunks_out=c_out)
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


# -- phase 4: q8 FULL OUTER (the join's other modes) --------------------------

# cut from 100M (q8's size) to make room for q5-hot and q3 under the
# phases' time limit (PERF.md §4); the 8-shard arm's size, so the two MVs
# are held to each other
Q8_OUTER_EVENTS = 20_000_000
Q8_OUTER_MESH_EVENTS = 20_000_000
Q8_OUTER_CAPPED_EVENTS = 2_000_000
Q8_OUTER_RECOVERY_EVENTS = 2_000_000
Q8_OUTER_TRACE_EVENTS = 2_000_000
Q8_OUTER_CAP = 2048               # resident keys a side: 40K persons at 2M


def build_q8_outer(dev, store, base, state_cap=None, mesh=None,
                   rate_limit: int = 16):
    """q8 as build_q8 builds it (its sources, projections and seller
    dedup, at its capacities), with the inner join replaced by a FULL
    OUTER join over the same inputs and state tables whose whole output
    is materialized: both sides' columns, keyed by both sides' pks, so
    the NULL-padded rows stay distinct. In words: persons who registered
    in a 10 s window, each with whether they opened an auction in it,
    and each seller-window with no registration in it. Both join inputs
    are append-only (the dedup's projection drops its no-op updates) and
    both state tables' pks start with the join keys, so the cold tier
    applies (``state_cap``)."""
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.models.nexmark import Pipeline, build_q8
    from risingwave_tpu_torch.parallel import ShardMesh
    from risingwave_tpu_torch.state.state_table import StateTable
    from risingwave_tpu_torch.stream.actor import Actor
    from risingwave_tpu_torch.stream.executors.hash_join import (
        HashJoinExecutor, JoinType,
    )
    from risingwave_tpu_torch.stream.executors.materialize import (
        MaterializeExecutor,
    )
    q8 = build_q8(store,
                  NexmarkConfig(**{**base.__dict__, "table_type": "person"}),
                  NexmarkConfig(**{**base.__dict__,
                                   "table_type": "auction"}),
                  rate_limit=rate_limit, min_chunks=rate_limit,
                  mesh=ShardMesh(MESH_SHARDS, dev) if mesh else None,
                  device=dev)
    inner = q8.actor.consumer.input.input
    left, right = inner.sides
    # build_q8's presized capacities (a mesh keeps the kernel's defaults)
    opts = None if mesh else {"key_capacity": left.kernel.table.capacity,
                              "row_capacity": left.kernel.row_capacity,
                              "probe_capacity": left.kernel._probe_cap}
    join = HashJoinExecutor(
        inner.left_in, inner.right_in, left.key_indices, right.key_indices,
        left.table, right.table, join_type=JoinType.FULL_OUTER,
        output_names=["id", "name", "starttime", "seller", "a_starttime"],
        mesh=left.mesh, shard_opts=opts, state_cap=state_cap, device=dev)
    mv = StateTable(6, join.schema, join.pk_indices, store)
    actor = Actor(q8.actor.actor_id, MaterializeExecutor(join, mv),
                  barrier_manager=q8.actor.barrier_manager,
                  fragment="nexmark-q8-outer")
    return Pipeline(actor, q8.loop, mv, q8.readers)


def q8_outer_oracle(cfg, n_persons: int, n_auctions: int,
                    block: int = 1 << 21) -> set:
    """persons FULL OUTER JOIN distinct (seller, window) of auctions on id
    = seller and the same window, vectorized per block: (id, name,
    window, seller, window) rows, None where a side is padded; computed
    once per size."""
    key = ("q8 outer", cfg.event_num, n_persons, n_auctions)
    if key in _ORACLES:
        return _ORACLES[key]
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
    out, hit = set(), []
    for lo in range(0, n_persons, block):
        ps = gen_persons(np.arange(lo, min(lo + block, n_persons),
                                   dtype=np.int64), cfg)
        pkey = (ps["id"] << 32) | (ps["date_time"] // w)
        m = np.isin(pkey, sellers)
        hit.append(pkey[m])
        win = ((ps["date_time"] // w) * w).tolist()
        ids = ps["id"].tolist()
        for i, nm, wi, ok in zip(ids, ps["name"].tolist(), win,
                                 m.tolist()):
            out.add((i, nm, wi, i, wi) if ok else (i, nm, wi, None, None))
    alone = sellers[~np.isin(sellers, np.concatenate(hit))]
    out.update((None, None, None, s, wi * w) for s, wi in
               zip((alone >> 32).tolist(), (alone & 0xFFFFFFFF).tolist()))
    _ORACLES[key] = out
    return out


def mv_digest_nullable(rows) -> str:
    """mv_digest for rows that hold None (sorted by their repr)."""
    import hashlib
    h = hashlib.sha256()
    for r in sorted(map(repr, rows)):
        h.update(r.encode())
    return h.hexdigest()[:16]


def _q8_outer_check(p, base, n_p: int, n_a: int, what: str) -> dict:
    """The MV against the oracle, and the join's state at the end of the
    run: stored rows and table slots per side."""
    rows = [tuple(r) for _pk, r in p.mv_table.iter_rows()]
    want = q8_outer_oracle(base, n_p, n_a)
    assert len(rows) == len(want) and set(rows) == want, \
        f"{what} MV differs from the oracle"
    assert p.readers[1].offset == n_p and p.readers[2].offset == n_a
    join = p.actor.consumer.input
    return dict(mv_rows=len(rows), mv_digest=mv_digest_nullable(rows),
                padded_rows=sum(r[0] is None or r[3] is None for r in rows),
                stored_rows=[len(s.pk_to_ref) for s in join.sides],
                next_ref=[s.next_ref for s in join.sides],
                key_capacity=[getattr(s.kernel, "key_capacity", None)
                              or s.kernel.table.capacity
                              for s in join.sides],
                row_capacity=[s.kernel.row_capacity for s in join.sides])


def run_q8_outer(dev, events: int, trace: bool = False, mesh: bool = False,
                 state_cap=None) -> dict:
    """q8 FULL OUTER through build_q8_outer + drive_to_completion at the
    q8 arm's chunking (4096-row chunks, 16 a barrier per source, two
    barriers in flight); the MV must equal the oracle exactly. With
    ``mesh`` the join runs over MESH_SHARDS logical shards; with
    ``state_cap`` under the cold tier, which must both evict and reload."""
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.parallel import ShardedJoinKernel, ShardMesh
    from risingwave_tpu_torch.state.store import MemoryStateStore

    base = NexmarkConfig(event_num=events, max_chunk_size=4096,
                         generate_strings=False)
    p = build_q8_outer(dev, MemoryStateStore(), base, state_cap=state_cap,
                       mesh=ShardMesh(MESH_SHARDS, dev) if mesh else None)
    join = p.actor.consumer.input
    assert all(isinstance(s.kernel, ShardedJoinKernel) == mesh
               for s in join.sides)
    n_p, n_a = events // 50, events * 3 // 50
    out = drive(p, {1: n_p, 2: n_a}, dev, trace)
    extra = _q8_outer_check(p, base, n_p, n_a, "q8-outer")
    if state_cap is not None:
        ev = sum(t.evicted_total for t in join._tier_parts)
        rl = sum(t.reload_total for t in join._tier_parts)
        assert ev > 0 and rl > 0, \
            f"q8-outer under the tier evicted {ev} and reloaded {rl} keys"
        extra.update(state_cap=state_cap, evicted_keys=ev,
                     reloaded_keys=rl,
                     cold_keys=[len(s.cold_keys) for s in join.sides])
    return dict(out, **extra)


def run_q8_outer_recovery(dev, events: int) -> dict:
    """q8-outer killed halfway and rebuilt on the same store: a fresh
    pipeline reloads both join sides and recomputes their degrees (K6 +
    K7), runs to the end, and the MV equals the oracle. Launch counts
    cover both halves. Its sources read 4 chunks a barrier (at the
    arm's 16 the warmup epoch alone would read half the auctions) and
    the first half runs to half the auctions with one barrier in flight:
    the persons (a third of the auctions' rows) are all in by then, the
    auctions are not."""
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.models.nexmark import drive_to_completion
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from risingwave_tpu_torch.utils.device import LAUNCHES
    base = NexmarkConfig(event_num=events, max_chunk_size=4096,
                         generate_strings=False)
    store = MemoryStateStore()
    n_p, n_a = events // 50, events * 3 // 50
    LAUNCHES.reset()
    t0 = time.perf_counter()
    p1 = build_q8_outer(dev, store, base, rate_limit=4)
    asyncio.run(drive_to_completion(p1, {2: n_a // 2}, in_flight=1))
    half = [len(s.pk_to_ref) for s in p1.actor.consumer.input.sides]
    at_kill = p1.readers[2].offset
    assert at_kill < n_a, "the kill fell after the last auction"
    del p1
    p2 = build_q8_outer(dev, store, base, rate_limit=4)
    asyncio.run(drive_to_completion(p2, {1: n_p, 2: n_a}, in_flight=2))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    extra = _q8_outer_check(p2, base, n_p, n_a, "q8-outer after recovery")
    # both halves, set-up included: no warmup epoch is split off here
    return dict(events=n_p + n_a, elapsed_s=wall, wall_s=wall,
                auctions_at_kill=at_kill, stored_at_kill=half,
                launches=LAUNCHES.snapshot(), **extra)


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


def check_fused_edges(dev) -> float:
    """The fused kernel at its tile edges (``fused_cases.EDGE_CASES`` at
    their card sizes, edge and subnormal values): every entry point a
    case allows against the plain program, bit for bit (a NaN equal to a
    NaN), stage counts exact."""
    from risingwave_tpu_torch.ops import fused as F
    from risingwave_tpu_torch.ops import fused_cases as FC
    err = 0.0
    for name in FC.EDGE_CASES:
        fs, chunk, seg = FC.edge_case(name, True, True, subnormals=True)
        raw = torch.from_numpy(F.encode_raw_chunk(chunk, fs.ref_cols)) \
            .to(dev)
        hs = torch.from_numpy(fs.host_noop_eq(chunk).astype(np.int8)) \
            .to(dev)
        nan_rows = FC.nan_rows_of(fs, chunk)
        for entry, prog in FC.edge_programs(name, fs).items():
            e = fused_err(entry, prog, raw, hs, seg, nan_rows)
            assert e == 0, f"{entry} differs from its plain version on " \
                f"the {name} edge case: {e}"
            err = max(err, e)
    return err


def fused_err(entry, prog, raw, host_same=None, seg=0, nan_rows=None,
              call=None) -> float:
    """One fused entry point (through ``call``, by default this build's
    wrapper) against the plain program on the same tensors: outputs bit
    for bit (a NaN equal to a NaN on ``nan_rows``), stage counts
    exact."""
    from risingwave_tpu_torch.ops import fused_cases as FC
    (got, ck), (want, cp) = FC.run_both(entry, prog, raw, host_same, seg,
                                        call or FC.call_entry)
    e = FC.mismatch(prog, got.cpu().numpy(), want.cpu().numpy(), nan_rows)
    if ck is not None:
        e = max(e, abs_err(ck.cpu().numpy(), cp.cpu().numpy()))
    return e


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


def pipeline_programs(dev) -> dict:
    """q5-hot's and q3's fused agg preludes at their path shapes: q5-hot's
    (5 hop copies, then (window_start, auction)) over 7 bid chunks of
    4,096 rows from the middle of the stream with separators, a 2^15-row
    batch (163,840 expanded rows); q3's (the DECIMAL revenue, OP_DECMUL)
    over its second join's whole SF1 output in 4,096-row chunks."""
    from risingwave_tpu_torch.models import prelude_cases as PC
    prog5, raw5, _fs = PC.q5_hot_agg_case(first=4_600_000)
    assert prog5.units == Q5_UNITS
    cols, _facts = q3_join_rows(*Q3_SF1)
    prog3, raw3, _fs = PC.q3_revenue_agg_case(cols)
    return {"q5-hot agg_prelude": (prog5, torch.from_numpy(raw5).to(dev)),
            "q3 agg_prelude": (prog3, torch.from_numpy(raw3).to(dev))}


def check_pipeline_preludes(dev) -> tuple:
    """Each pipeline program of ``pipeline_programs``: agg_prelude bit for
    bit against the plain program, stage counts exact, then timed beside
    its byte bound. Returns (max error, timings by label)."""
    from risingwave_tpu_torch.ops import fused as F
    err, out = 0.0, {}
    for label, (prog, raw) in pipeline_programs(dev).items():
        ck = torch.zeros(prog.n_counts, dtype=torch.int64, device=dev)
        cp = ck.clone()
        got = F.agg_prelude(prog, raw, ck)
        want = F.run_program_plain(prog, raw, None, cp)
        e = max(abs_err(got.cpu().numpy(), want.cpu().numpy()),
                abs_err(ck.cpu().numpy(), cp.cpu().numpy()))
        assert e == 0 and got.shape[0] == prog.units * raw.shape[0], \
            f"{label} differs from its plain version: {e}"
        err = max(err, e)
        out[label] = dict(raw_rows=int(raw.shape[0]),
                          rows=int(got.shape[0]), **_fused_time(
                              lambda: F.agg_prelude(prog, raw),
                              lambda: F.run_program_plain(prog, raw), prog,
                              int(raw.shape[0])))
        log(f"{label}: {out[label]['raw_rows']} raw rows of width "
            f"{int(raw.shape[1])} -> {out[label]['rows']} rows of "
            f"{prog.out_width} lanes: exact; " + json.dumps(out[label]))
    return err, out


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


def launch_split(fn, calls: int = 100) -> dict:
    """Every device activity one fn call makes (kernels, fills, copies),
    by name: [ms a call, launches a call], from torch.profiler's
    per-kernel device time over `calls` calls (the split of a wrapper or
    a chain that launches several kernels, which CUDA events around the
    call cannot give)."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.self_device_time_total:
            continue
        m = re.search(r"(\w+)(<[^(]*)?\(", e.key)
        name = m.group(1) if m else e.key
        if "FillFunctor" in e.key:
            name += ":fill"
        ms, n = out.get(name, (0.0, 0.0))
        out[name] = [ms + e.self_device_time_total / 1e3 / calls,
                     n + e.count / calls]
    return out


def kernel_split(fn, calls: int = 100) -> dict:
    """Device time per call of each kernel that fn launches, by name."""
    return {k: v[0] for k, v in launch_split(fn, calls).items()}


def route_timed(rows, valid, omap, s, bucket, kw) -> dict:
    """route's time and route_plain's on one step (a call: its count is
    one a call, whatever the call launches), its byte bound, and its
    per-kernel split."""
    from risingwave_tpu_torch.parallel import exchange as X
    n, w = rows.shape
    b, by = bound_ms(X.bound_bytes(n, w, s, bucket), n * 16)
    return dict(ms=time_ms(lambda: X.route(rows, valid, omap, s, bucket, kw)),
                plain_ms=time_ms(lambda: X.route_plain(rows, valid, omap, s,
                                                       bucket, kw)),
                bound_ms=b, bound_by=by,
                split=kernel_split(lambda: X.route(rows, valid, omap, s,
                                                   bucket, kw)))


def check_route(dev) -> dict:
    """route against route_plain bit for bit on a q7-mesh step (a 2^15-row
    packed batch in 8 blocks, bucket = local), on the mixed plan's batch,
    with a forced overflow (bucket 64) and on ops/kernel_cases.py's edge
    cases; timed on the q7 step."""
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.ops import kernel_cases as KC
    from risingwave_tpu_torch.parallel import exchange as X
    from risingwave_tpu_torch.parallel.mesh import contiguous_owner_map
    s = MESH_SHARDS
    omap = torch.from_numpy(contiguous_owner_map(s)).to(dev)
    q7 = make_specs(H, [("max", np.int64), ("count", None)])
    mixed = make_specs(H, [("sum", np.int64), ("sum", np.float64),
                           ("min", np.int64), ("count", None)])
    # (rows, bucket, shards, valid or None, whether a bucket overflows)
    cases = [(q7_batch(N, q7), N // s, s, None, False),
             (mixed_batch(N, mixed, groups=MESH_GROUPS), N // s, s, None,
              False),
             (mixed_batch(N, mixed, groups=MESH_GROUPS), 64, s, None, True)]
    cases += [(r, b, ns, v, name in ("overflow", "bucket_0"))
              for name, (r, v, ns, b) in KC.route_cases().items()]
    err = 0.0
    for packed_np, bucket, ns, valid_np, over in cases:
        packed = torch.from_numpy(packed_np).to(dev)
        valid = packed[:, KW + 1] if valid_np is None else \
            torch.from_numpy(valid_np).to(dev)
        om = torch.from_numpy(contiguous_owner_map(ns)).to(dev)
        got = X.route(packed, valid, om, ns, bucket, KW)
        want = X.route_plain(packed, valid, om, ns, bucket, KW)
        for g, w in zip(got, want):
            err = max(err, abs_err(g.cpu().numpy(), w.cpu().numpy()))
        assert err == 0, f"route differs from route_plain: {err}"
        assert bool(got[2].any()) == over, "route's overflow flag"
    packed = torch.from_numpy(q7_batch(N, q7)).to(dev)
    return dict(route_timed(packed, packed[:, KW + 1], omap, s, N // s, KW),
                max_abs_err=err)


def check_route_q8(dev, mj: dict) -> dict:
    """route at q8-mesh's side-epoch (the fresh epoch's 2^16 rows in 8
    senders, with the skew-exact bucket): bit for bit against
    route_plain, then timed."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.parallel import exchange as X
    k = mj["ks"]
    rows, valid, bucket = _mesh_route_args(k, *mj["fresh"],
                                           J.FLAG_INS | J.FLAG_DEL,
                                           probe=False)
    got = X.route(rows, valid, k.owner_map, k.n_dev, bucket, JKW)
    want = X.route_plain(rows, valid, k.owner_map, k.n_dev, bucket, JKW)
    err = max(abs_err(g.cpu().numpy(), w.cpu().numpy())
              for g, w in zip(got, want))
    assert err == 0, f"route differs from route_plain at q8-mesh: {err}"
    return dict(route_timed(rows, valid, k.owner_map, k.n_dev, bucket, JKW),
                max_abs_err=err, bucket=bucket)


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
    c2 = H.ShardedAggState(b.table, b.st.clone())
    H.advance_sharded(c)
    H.advance_sharded(c2, H.flush_gather_sharded(c2, 1 << 14))
    for d in range(s):
        H.advance_plain(b.shard(d))
    err = max(err, abs_err(c.st.cpu().numpy(), b.st.cpu().numpy()),
              abs_err(c2.st.cpu().numpy(), b.st.cpu().numpy()))
    hi, lo = lanes_split(10_000 * 7_919)
    fill = torch.tensor(H.state_fills(mixed), dtype=torch.int32, device=dev)
    for mode in (H.LIVE_GROW, H.LIVE_OCCUPIED, H.LIVE_RETIRE):
        # the mask launch with the fresh tables at 2 x cap (growth)
        live, table = H.live_and_table_sharded(b, mode, 2 * cap, 0, hi, lo)
        want = torch.stack([H.live_mask_plain(b.shard(d), mode, 0, hi, lo)
                            for d in range(s)])
        err = max(err, abs_err(live.cpu().numpy(), want.cpu().numpy()),
                  abs_err(H.live_mask_sharded(b, mode, 0, hi, lo)
                          .cpu().numpy(), want.cpu().numpy()),
                  float(table.keys.abs().max()),
                  float(table.occ.abs().max()))
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
    # K1's byte bound charges every received row its valid flag and its
    # slot write, and only the valid rows their key lanes: with bucket =
    # local, about 7/8 of each shard's m received rows are empty.
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
    # K2 at this step: check_agg_apply's "sharded" shape
    qa = H.ShardedAggState(qk.table, qk.st.clone())
    r = qk.st.shape[1]
    t["flush_gather"] = dict(
        ms=time_ms(lambda: H.flush_gather_sharded(qk, 1 << 10)),
        plain_ms=time_ms(lambda: H.flush_gather_sharded_plain(qk, 1 << 10)),
        n_dirty=(qk.st[:, H.ROW_DIRTY] != 0).sum(dim=1).tolist(),
        split=kernel_split(lambda: H.flush_gather_sharded(qk, 1 << 10)))
    t["flush_gather"]["bound_ms"], t["flush_gather"]["bound_by"] = \
        k3_bound(qk.st, qk.table.keys, 1 << 10)
    qmats = H.flush_gather_sharded(qa, 1 << 10)
    timed("advance", lambda: H.advance_sharded(qa, qmats),
          lambda: [H.advance_listed_plain(qa.shard(d), qmats[d])
                   for d in range(s)],
          *advance_bytes(qa))
    # the retirement's mask launch with its fresh tables: the mask's
    # bytes and the cleared (K + 1) words a slot
    q_occ = int((qk.table.occ != 0).sum())
    timed("live_mask", lambda: H.live_and_table_sharded(
        qk, H.LIVE_RETIRE, cap, 0),
        lambda: (torch.stack([H.live_mask_plain(qk.shard(d),
                                                H.LIVE_RETIRE, 0)
                              for d in range(s)]),
                 H.ht.TableState(
                     torch.zeros((s, cap, KW), dtype=torch.int32,
                                 device=dev),
                     torch.zeros((s, cap), dtype=torch.int32,
                                 device=dev))),
        s * cap * 8 + q_occ * (3 + KW) * 4 + s * cap * (KW + 1) * 4,
        s * cap * 8)
    qlive, qt = H.live_and_table_sharded(qk, H.LIVE_RETIRE, cap, 0)
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


def build_mesh_join_states(dev, twin: bool = True) -> dict:
    """q8-mesh's join side: a ShardedJoinKernel over MESH_SHARDS shards at
    its defaults (2^15 slots, 2^17 rows per shard) fed the ~2M stored rows
    of join_epochs through stage_epoch + apply_epoch (route, K1, K5; the
    key tables grow 4x twice: K1 + K4), and, with `twin`, its twin
    through the plain versions (without, the twin stays empty); then both
    take the mixed epoch (hot keys, deletes), which is K5's check."""
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
        for up, aux in stored if twin else ():
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
    rows, valid, bucket = _mesh_route_args(k, up, aux, bits, probe)
    recv, rvalid, ovf = X.route(rows, valid, k.owner_map, k.n_dev, bucket,
                                JKW)
    assert not bool(ovf.any())
    return recv, rvalid, bucket


def _mesh_route_args(k, up, aux, bits, probe: bool):
    """The rows one side-epoch routes, their valid flags and the
    skew-exact bucket: (rows, valid, bucket)."""
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
    return rows, (aux[:, 2] & bits) != 0, bucket


def check_mesh_join_apply(dev, mj: dict) -> dict:
    """Sharded K5, exact per shard: after the stored epochs and the mixed
    epoch (runs of rows on 8 hot keys, deletes of stored refs, new keys),
    each shard's per-key heads and its ref-indexed next, ins_seq and
    del_seq equal the plain twin's. Timed on the fresh epoch (q8's shape,
    every row a new key) on the slots K1 gave, beside its byte bound
    (``k5_bytes``)."""
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
    scratch = J.link_scratch(kc.head)

    def call():
        J.join_apply_sharded(kc, slots, scratch=scratch, **kw)
    ms = time_ms(call)
    pc = J.ChainState(*(t.clone() for t in kp.chains))
    plain_ms = time_ms(lambda: J.join_apply_sharded_plain(pc, slots, **kw),
                       samples=5, per=1)
    fl = f.cpu().numpy()
    n_ins = int(((fl & J.FLAG_INS) != 0).sum())
    b, by = bound_ms(k5_bytes(dict(kw, slots=slots, pay_src=None)),
                     fl.size * 4)
    split = kernel_split(call)
    log(f"sharded join_apply: {ks.n_dev} shards, bucket {bucket}, "
        f"{fl.shape[1]} received rows per shard ({n_ins} inserts); key "
        f"slots per shard while building {sorted(set(mj['caps']))}, "
        f"{ks.row_capacity} rows per shard; the stored epochs applied in "
        f"{mj['built_s']:.3f} s wall")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, split=split)


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
    k6 = k6_cases_perchunk(perchunk_probe_input(ks, steps))["per_chunk"]
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, steps=len(steps), split_ms=split,
                join_probe_split=kernel_split(k6[0]))


# -- phase 4: the per-chunk arm of the sharded join ---------------------------

def perchunk_script(n_chunks: int = PERCHUNK_CHUNKS, seed: int = 41,
                    wm_epoch=None):
    """Both sides' streams: n_chunks chunks of 4,096 rows per side,
    PERCHUNK_EPOCH chunks per side between barriers. Each chunk deletes
    live rows, moves live rows to another key with a U-/U+ pair, and
    inserts new rows; 5% of keys are NULL, and the key range widens each
    epoch so the key tables grow. With ``wm_epoch`` both sides send a
    join-key watermark of HOT_KEYS after that epoch's chunks: the hot
    band moves to [HOT_KEYS, 2 HOT_KEYS), so no later row has a key
    below it, and no later delete or update touches a row below it (the
    join expires those rows at the next barrier). Returns (left
    messages, right messages, barriers, live rows per side as (key,
    NULL mask, pk)); ``perchunk_oracle`` folds them to the inner join's
    view."""
    from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk
    from risingwave_tpu_torch.common.epoch import Epoch, EpochPair
    from risingwave_tpu_torch.common.types import DataType, Schema
    from risingwave_tpu_torch.stream.message import (
        Barrier, BarrierKind, Watermark,
    )
    rng = np.random.default_rng(seed)
    n = MESH_CHUNK_ROWS
    schemas = (Schema.of(lk=DataType.INT64, lv=DataType.INT64),
               Schema.of(rk=DataType.INT64, rv=DataType.INT64))
    live = [dict(k=np.zeros(0, np.int64), null=np.zeros(0, bool),
                 pk=np.zeros(0, np.int64)) for _ in range(2)]
    next_pk = [0, 10**9]
    msgs = ([], [])
    hot = [0]                       # the hot band's first key

    def barrier(b):
        prev = Epoch.from_physical(b - 1) if b > 1 else Epoch.INVALID
        return Barrier(EpochPair(Epoch.from_physical(b), prev),
                       BarrierKind.CHECKPOINT)

    def keys(m, hi):
        """30% on HOT_KEYS hot keys (matches), 70% over a widening
        range."""
        k = np.where(rng.random(m) < 0.3,
                     hot[0] + rng.integers(0, HOT_KEYS, m),
                     HOT_KEYS + rng.integers(0, hi, m))
        return k.astype(np.int64), rng.random(m) < 0.05
    b = 1
    for side in (0, 1):
        msgs[side].append(barrier(b))
    for c in range(n_chunks):
        hi = 200_000 * (c // PERCHUNK_EPOCH + 1)
        for side in (0, 1):
            lv = live[side]
            # after the watermark only rows at or above it may change
            elig = np.flatnonzero(lv["null"] | (lv["k"] >= hot[0]))
            d = min(400, len(elig) // 4)
            u = min(300, len(elig) // 4)
            pick = elig[rng.choice(len(elig), d + u, replace=False)]
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
            if wm_epoch is not None and (c + 1) // PERCHUNK_EPOCH == wm_epoch:
                hot[0] = HOT_KEYS
                for side in (0, 1):
                    msgs[side].append(Watermark(0, DataType.INT64,
                                                HOT_KEYS))
            b += 1
            for side in (0, 1):
                msgs[side].append(barrier(b))
    return msgs[0], msgs[1], b, live


def perchunk_oracle(live, join_type: str = "inner") -> np.ndarray:
    """The join of perchunk_script's live rows as sorted int64 rows, -1
    for NULL: [lk, lv, rk, rv] (both sides' columns; outer joins pad the
    unmatched side) or the subject's [k, v] (semi and anti joins). A
    NULL key matches nothing."""
    lk, rk = (np.where(x["null"], -1, x["k"]) for x in live)
    lpk, rpk = live[0]["pk"], live[1]["pk"]
    order = np.argsort(rk, kind="stable")
    rs = rk[order]
    lo = np.searchsorted(rs, lk, "left")
    cnt_l = np.where(lk >= 0, np.searchsorted(rs, lk, "right") - lo, 0)
    ls_ = np.sort(lk)
    cnt_r = np.where(rk >= 0, np.searchsorted(ls_, rk, "right")
                     - np.searchsorted(ls_, rk, "left"), 0)
    if join_type in ("left_semi", "left_anti", "right_semi", "right_anti"):
        k, v, cnt = (lk, lpk, cnt_l) if join_type.startswith("left") \
            else (rk, rpk, cnt_r)
        m = (cnt > 0) if join_type.endswith("semi") else (cnt == 0)
        view = np.stack([k[m], v[m]], axis=1)
        return view[np.lexsort(view.T[::-1])]
    li = np.repeat(np.arange(len(lk)), cnt_l)
    ri = order[np.concatenate([np.arange(a, a + c_) for a, c_ in
                               zip(lo[cnt_l > 0], cnt_l[cnt_l > 0])])
               if cnt_l.any() else np.zeros(0, np.int64)]
    parts = [np.stack([lk[li], lpk[li], rk[ri], rpk[ri]], axis=1)]
    if join_type in ("left_outer", "full_outer"):
        m = cnt_l == 0
        parts.append(np.stack([lk[m], lpk[m], np.full(m.sum(), -1),
                               np.full(m.sum(), -1)], axis=1))
    if join_type in ("right_outer", "full_outer"):
        m = cnt_r == 0
        parts.append(np.stack([np.full(m.sum(), -1), np.full(m.sum(), -1),
                               rk[m], rpk[m]], axis=1))
    view = np.concatenate(parts)
    return view[np.lexsort(view.T[::-1])]


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


def _view_of(chunks, width: int = 4) -> np.ndarray:
    """The join's output folded into its view as sorted int64 rows, -1
    for NULL (each row's count must end at 0 or 1: the pks are
    unique)."""
    rows, sign = [], []
    for c in chunks:
        a = _chunk_arrays(c)
        vals = np.stack(a[1:1 + width], axis=1)
        ok = np.stack(a[1 + width:1 + 2 * width], axis=1)
        rows.append(np.where(ok, vals, -1).astype(np.int64))
        sign.append(np.where((a[0] == 1) | (a[0] == 4), 1, -1))
    if not rows:
        return np.zeros((0, width), np.int64)
    rows = np.concatenate(rows)
    uniq, inv = np.unique(rows, axis=0, return_inverse=True)
    cnt = np.bincount(inv.reshape(-1), weights=np.concatenate(sign),
                      minlength=len(uniq)).astype(np.int64)
    assert ((cnt == 0) | (cnt == 1)).all(), "a joined row counted twice"
    return uniq[cnt == 1]


def _join_executor(dev, sl, sr, epoch_batch: bool = True,
                   join_type: str = "inner", mesh: bool = True,
                   shard_opts=None):
    """The join of perchunk_script's two streams, over MESH_SHARDS shards
    or on one device."""
    from risingwave_tpu_torch.parallel import ShardMesh
    from risingwave_tpu_torch.state.state_table import StateTable
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from risingwave_tpu_torch.stream.executors.hash_join import (
        HashJoinExecutor, JoinType,
    )
    from risingwave_tpu_torch.stream.executors.test_utils import MockSource
    ls, rs = sl[1].schema, sr[1].schema
    store = MemoryStateStore()
    return HashJoinExecutor(
        MockSource(ls, sl), MockSource(rs, sr), [0], [0],
        StateTable(21, ls, [1], store, dist_key_indices=[]),
        StateTable(22, rs, [1], store, dist_key_indices=[]),
        join_type=JoinType(join_type),
        mesh=ShardMesh(MESH_SHARDS, dev) if mesh else None,
        shard_opts=shard_opts, epoch_batch=epoch_batch, device=dev)


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
    sl, sr, nb, live = perchunk_script(n_chunks)
    want = perchunk_oracle(live)
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


# -- phase 4: every join type on perchunk_script ---------------------------------

JOIN_TYPES = ("inner", "left_outer", "right_outer", "full_outer",
              "left_semi", "left_anti", "right_semi", "right_anti")
MODES_CHUNKS = 16             # per side: 2 epochs of 8 chunks
MODES_WM_EPOCH = 1            # the join-key watermark after epoch 1
MODES_OVERFLOW_CAP = 1 << 10  # the forced pair-buffer overflow run
MODES_COMPACT_RATIO = 0.05    # the forced compaction run's dead share


def run_join_modes(dev) -> dict:
    """Every JoinType on one device and over MESH_SHARDS shards (epoch
    arm) on perchunk_script's streams at MODES_CHUNKS chunks a side,
    with a join-key watermark after epoch MODES_WM_EPOCH (expiry on the
    single-device and the sharded tables), each view equal to its
    oracle; then FULL OUTER on one device with a MODES_OVERFLOW_CAP pair
    buffer (a degree-tracked epoch overflows and re-dispatches) and LEFT
    OUTER on one device with compaction forced at every barrier
    (degrees carried by K7's gather). Launch counts are the whole
    arm's."""
    from risingwave_tpu_torch.stream.executors.test_utils import (
        collect_until_n_barriers,
    )
    from risingwave_tpu_torch.utils.device import LAUNCHES
    sl, sr, nb, live = perchunk_script(MODES_CHUNKS, seed=43,
                                       wm_epoch=MODES_WM_EPOCH)
    runs = [(jt, mesh, None) for jt in JOIN_TYPES for mesh in (False, True)]
    runs += [("full_outer", False, "overflow"),
             ("left_outer", False, "compaction")]
    LAUNCHES.reset()
    t0 = time.perf_counter()
    out, views = {}, {}
    for jt, mesh, special in runs:
        opts = {"probe_capacity": MODES_OVERFLOW_CAP} \
            if special == "overflow" else None
        ex = _join_executor(dev, sl, sr, join_type=jt, mesh=mesh,
                            shard_opts=opts)
        compactions = [0]
        if special == "compaction":
            for side in ex.sides:
                side.COMPACT_DEAD_RATIO = MODES_COMPACT_RATIO
                real = side.compact

                def counted(real=real):
                    compactions[0] += 1
                    real()
                side.compact = counted
        t1 = time.perf_counter()
        msgs = asyncio.run(collect_until_n_barriers(ex, nb))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        width = 2 if jt.endswith(("semi", "anti")) else 4
        got = _view_of([m for m in msgs if hasattr(m, "ops")], width)
        want = perchunk_oracle(live, jt)
        label = f"{jt} {special or ('mesh' if mesh else 'one')}"
        assert got.shape == want.shape and (got == want).all(), \
            f"join modes: {label} differs from the oracle"
        k = ex.sides[0].kernel
        r = dict(view_rows=len(got), wall_s=time.perf_counter() - t1,
                 key_capacity=getattr(k, "key_capacity", None)
                 or k.table.capacity,
                 expired_to=[int(min(s.arena.cols[0][s.live_refs()],
                                     default=-1)) for s in ex.sides])
        assert all(x >= HOT_KEYS for x in r["expired_to"]), \
            f"join modes: {label} kept rows below the watermark"
        if special == "overflow":
            r["probe_capacity"] = [s.kernel._probe_cap for s in ex.sides]
            assert max(r["probe_capacity"]) > MODES_OVERFLOW_CAP, \
                "the forced pair-buffer overflow did not happen"
        if special == "compaction":
            r["compactions"] = compactions[0]
            assert compactions[0] > 0, "no compaction ran"
        out[label] = r
        views[label] = got
    for jt in JOIN_TYPES:
        assert np.array_equal(views[f"{jt} one"], views[f"{jt} mesh"])
    wall = time.perf_counter() - t0
    return dict(runs=out, rows_per_side=MODES_CHUNKS * MESH_CHUNK_ROWS,
                barriers=nb, elapsed_s=wall, wall_s=wall,
                launches=LAUNCHES.snapshot())


def join_host_fns(stats) -> dict:
    """Cumulative host time (s) of the join executor's own barrier work:
    the epoch dispatch and emission (the degree replay in it), and the
    cold tier's and expiry's state moves (a compaction's degree read
    included)."""
    want = {"stream/executors/hash_join.py": (
        "_dispatch_epoch", "_emit_pending", "_emit_one", "_reload_cold",
        "reload_keys", "evict_keys", "compact", "expire_below",
        "_recover_degrees"),
        "ops/hash_join.py": ("read_degrees", "write_degrees", "rebuild")}
    out: dict = {}
    for (path, _line, fn), (_cc, _nc, _tt, ct, _callers) in \
            stats.stats.items():
        for mod, fns in want.items():
            if path.endswith(mod) and fn in fns:
                key = f"{mod}:{fn}"
                out[key] = out.get(key, 0.0) + ct
    return out


def ingest_host_fns(stats) -> dict:
    """Cumulative host time (s) of the sources: each reader's
    ``next_chunk`` (generation, or for filelog the file read and the
    parse) and, within it, the parser's ``build_chunk`` (the JSON decode
    and the columns' coercion)."""
    out: dict = {}
    for (path, _line, fn), (_cc, _nc, _tt, ct, _callers) in \
            stats.stats.items():
        if "risingwave_tpu_torch/connectors/" in path and fn in (
                "next_chunk", "build_chunk"):
            key = path.split("risingwave_tpu_torch/")[-1] + ":" + fn
            out[key] = out.get(key, 0.0) + ct
    return out


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
# K9 alone: name -> (slots, accumulators, capacity, a patch (else a
# reload)); the reloads as the capped maxbids arm (28 reloads of 21-33
# groups, median 29, into its first agg's 2^18 slots) and q7-tier (7
# reloads of one group) give them at 2M events (run on the CPU)
RELOAD_SHAPES = {
    "capped maxbids reload (29 groups, 2^18 slots)": (29, 1, 1 << 18, False),
    "q7-tier reload (1 group, 2^18 slots)": (1, 4, 1 << 18, False),
    "the table's patch (2^16 slots x 12 rows, 2^20 slots)": (
        1 << 16, 12, 1 << 20, True),
}
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
    lv_k, fresh = H.live_and_table(st, H.LIVE_EVICT, cap, dropped=dk)
    lv_p = H.live_mask_plain(st, H.LIVE_EVICT, dropped=dp)
    err = max(err, abs_err(lv_k.cpu().numpy(), lv_p.cpu().numpy()),
              float(fresh.keys.abs().max()), float(fresh.occ.abs().max()))
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
    # the mode's launch: the mask and the fresh table it zeroes
    mb, mby = bound_ms(cap * 4 * 2 + n_occ * 4 * 4
                       + cap * (KW + 1) * 4, cap * 4)
    evict_mode = dict(
        ms=time_ms(lambda: H.live_and_table(st, H.LIVE_EVICT, cap,
                                            dropped=dk)),
        plain_ms=time_ms(lambda: (H.live_mask_plain(
            st, H.LIVE_EVICT, dropped=dp), ht.make_state(cap, KW, dev)),
            5, 1),
        bound_ms=mb, bound_by=mby, library_ms=None)
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


def _check_patch(dev, st, n: int, seed: int, slots=None) -> dict:
    """K9 at a patch's shape: every accumulator row at n distinct
    occupied slots (or at `slots`, a flush's dirty slots; padding to a
    power of two with cap), exact against its plain version; kernel,
    plain and ``index_put_`` times."""
    from risingwave_tpu_torch.common.chunk import next_pow2
    from risingwave_tpu_torch.ops import hash_agg as H
    rng = np.random.default_rng(seed)
    cap = st.capacity
    occ = np.flatnonzero(st.table.occ.cpu().numpy())
    if slots is not None:
        n = len(slots)
    pad = next_pow2(n)
    idx = np.full(pad, cap, np.int32)
    idx[:n] = rng.choice(occ, n, replace=False) if slots is None else slots
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
    # each 4-byte store at a scattered slot moves a 32-byte sector
    sector_ms = (pad * 4 + st.n_acc * n * (4 + 32) + st.n_acc * 4) \
        / HBM_BYTES_PER_S * 1e3
    return dict(max_abs_err=err, sector_ms=sector_ms,
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


def maxbids_patch(dev) -> dict:
    """K9 at maxbids' patch shape: one flush's dirty slots of maxbids'
    first agg after one step (a 2^20-slot state, ~2,200 dirty) and its
    accumulator rows."""
    from risingwave_tpu_torch.ops import hash_agg as H
    mb = _maxbids_state(dev)
    dirty = np.flatnonzero(mb.st[H.ROW_DIRTY].cpu().numpy()).astype(np.int32)
    return _check_patch(dev, mb, 0, 7, slots=dirty)


def check_cold(dev) -> dict:
    """The cold tier's and the patch's kernels against their plain
    versions at the capped arm's shapes and at the large shape, and K9
    alone at the reload shapes of the capped maxbids arm and q7-tier."""
    from risingwave_tpu_torch.ops import hash_agg as H
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
    maxbids = maxbids_patch(dev)
    passthrough = _check_passthrough(dev)
    reload_shapes = {}
    for name, (rst, idx, rows, src) in reload_ab_cases(dev).items():
        a, b = rst.clone(), rst.clone()
        H.scatter_rows_sharded(a, idx, rows, src)
        H.scatter_rows_plain(b, idx, rows, src)
        e = abs_err(a.cpu().numpy(), b.cpu().numpy())
        assert e == 0, f"scatter_rows differs at {name}: {e}"
        n, k = int(idx.shape[1]), int(rows.shape[0])
        rb, rby = bound_ms(n * 4 + 2 * k * n * 4 + k * 4, n)
        reload_shapes[name] = dict(
            max_abs_err=e,
            ms=time_ms(lambda a=(a, idx, rows, src):
                       H.scatter_rows_sharded(*a)),
            plain_ms=time_ms(lambda a=(b, idx, rows, src):
                             H.scatter_rows_plain(*a), 5, 1),
            library_ms=time_ms(lambda a=(a, idx, rows, src): a[0][
                0].index_put_((a[2].to(torch.int64)[:, None],
                               a[1][0].to(torch.int64)[None, :]), a[3][0])),
            bound_ms=rb, bound_by=rby,
            sector_ms=(n * 4 + k * n * (4 + 32) + k * 4)
            / HBM_BYTES_PER_S * 1e3, slots=n, rows=k)
    err = max(large["max_abs_err"], capped["max_abs_err"],
              large["patch"]["max_abs_err"], capped["patch"]["max_abs_err"],
              large["reload"]["max_abs_err"],
              capped["reload"]["max_abs_err"],
              sharded["max_abs_err"], maxbids["max_abs_err"],
              passthrough)
    out["lookup"] = dict(large["lookup"], max_abs_err=err,
                         capped_shape=capped["lookup"])
    out["scatter_rows"] = dict(large["patch"], max_abs_err=err,
                               capped_shape=capped["patch"],
                               sharded=sharded, maxbids_shape=maxbids,
                               reload_shapes=reload_shapes)
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
DISTINCT_EVENTS = 2_000_000   # cut from 10M: the q8-outer arms' room
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


# -- phase 4: Nexmark q5-hot and TPC-H q3 -------------------------------------

Q5_EVENTS = 1_000_000         # every arm and the trace; bench_q5's chunking:
                              # 4096-row chunks, 16 a barrier
Q5_UNITS = 5                  # hop: slide 2 s, size 10 s
# resident groups on both stateful stages: a barrier's bids touch ~8
# windows, so a TopN cap of 8 (a sweep keeps 6) evicts windows still
# open and the next barrier reloads them; at 64 the TopN evicts only
# closed windows and never reloads (CPU rehearsal at 1M: agg 308,712
# groups evicted and 5,271 reloaded, TopN 66 and 19)
Q5_TIER_CAP = 8
Q3_SF1 = (150_000, 1_500_000)       # TPC-H SF1: customers, orders
Q3_SF01 = (15_000, 150_000)         # SF0.1: the fused arm and the trace
Q3_CHUNKS = 64                # 1024-row chunks (bench_q3's), 64 a barrier
                              # a source: 4x bench_q3's 16, for time
# the agg's table grows from its 2^18 slots (~308K groups at 1M events)
Q5_PATH = ("probe_insert", "agg_apply", "flush_gather", "advance",
           "live_mask", "remap")
Q5_FUSED_PATH = Q5_PATH + ("agg_prelude",)
# the agg's tier: each sweep's eviction (K8, then K4's evict mode, K1 and
# K4's remap) and each reload (K1 + K9)
Q5_CAPPED_PATH = Q5_PATH + ("lookup", "scatter_rows")
# two chained inner joins; join 2's right side grows its key table past
# the presized 2^20 slots at SF1 (K1 rehashes the keys, K4's remap moves
# the chain heads)
Q3_PATH = ("probe_insert", "agg_apply", "flush_gather", "advance",
           "join_apply", "join_probe", "remap")
# SF0.1 stays inside the presized tables; the agg absorbs the revenue
# projection, the orders and lineitem sides their filters and row ids
Q3_FUSED_PATH = ("probe_insert", "agg_apply", "flush_gather", "advance",
                 "join_apply", "join_probe", "agg_prelude", "join_prelude")


def q5_hot_oracle(cfg, n_bids: int, block: int = 1 << 21) -> dict:
    """window_start → (auction, bids) of the window's top auction (the
    most bids, ties to the smallest id), vectorized: bids counted per
    (2 s slide, auction), each slide's counts added to the 5 windows that
    cover it; computed once per size."""
    key = ("q5", cfg.event_num, n_bids)
    if key in _ORACLES:
        return _ORACLES[key]
    from risingwave_tpu_torch.connectors.nexmark import gen_bids
    slide = 2_000_000
    codes = []
    for lo in range(0, n_bids, block):
        b = gen_bids(np.arange(lo, min(lo + block, n_bids), dtype=np.int64),
                     cfg)
        codes.append(((b["date_time"] // slide) << 32) | b["auction"])
    u, c = np.unique(np.concatenate(codes), return_counts=True)
    u5, inv = np.unique(np.concatenate([u - (i << 32)
                                        for i in range(Q5_UNITS)]),
                        return_inverse=True)
    cnt = np.bincount(inv, weights=np.tile(c, Q5_UNITS)).astype(np.int64)
    win, auc = u5 >> 32, u5 & 0xFFFFFFFF
    o = np.lexsort((auc, -cnt, win))
    first = o[np.flatnonzero(np.r_[True, win[o][1:] != win[o][:-1]])]
    _ORACLES[key] = {w * slide: (a, n) for w, a, n in zip(
        win[first].tolist(), auc[first].tolist(), cnt[first].tolist())}
    return _ORACLES[key]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip()


def q5_hot_batch(p, agg, n_bids: int) -> dict:
    """The batch engine's reads of q5-hot's state at the committed epoch:
    the agg's state table (one row per (window_start, auction) group:
    window_start, auction, _group_rows, _acc0; ~308K rows at 1M events)
    and the MV, each read held to its oracle:

    (a) RowSeqScan → BatchHashAgg by window_start of MAX, SUM and
        COUNT(*) of column 2 (the group's bid count): each window's MAX
        is the MV's count for it, the SUMs total Q5_UNITS x n_bids, the
        COUNT(*)s are the groups of each window in a plain scan;
    (b) BatchTaskManager(parallelism=4).run_agg with the same calls: the
        rows of (a) as a set;
    (c) RowSeqScan → BatchOrderBy(count DESC, window, auction) →
        BatchLimit(10): a numpy top 10 of the scanned rows;
    (d) StorageTable.get_row of every MV row's (window, auction) pk: the
        MV row.

    Host code: nothing here launches a kernel. Returns the rows read and
    the seconds of each read."""
    from risingwave_tpu_torch import batch as BT
    from risingwave_tpu_torch.batch.task import BatchTaskManager
    from risingwave_tpu_torch.ops.hash_agg import AggKind
    from risingwave_tpu_torch.stream.executors.hash_agg import AggCall
    epoch = agg.table.store.committed_epoch()
    table = BT.StorageTable.of(agg.table)
    mv = BT.StorageTable.of(p.mv_table)
    calls = [AggCall(AggKind.MAX, 2), AggCall(AggKind.SUM, 2),
             AggCall(AggKind.COUNT)]
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out

    a = timed("a_hash_agg", lambda: BT.collect(BT.BatchHashAgg(
        BT.RowSeqScan(table, epoch), [0], calls)))
    b = timed("b_run_agg", lambda: asyncio.run(
        BatchTaskManager(parallelism=4).run_agg(table, epoch, [0], calls)))
    c = timed("c_top10", lambda: BT.collect(BT.BatchLimit(BT.BatchOrderBy(
        BT.RowSeqScan(table, epoch), [(2, True), (0, False), (1, False)]),
        10)))
    mv_rows = {r[:2]: r for _pk, r in p.mv_table.iter_rows()}
    d = timed("d_get_row", lambda: {pk: mv.get_row(pk, epoch)
                                    for pk in mv_rows})
    # the oracles, from a plain scan of the same snapshot
    scanned = np.asarray([r for r in table.iter_rows(epoch)], dtype=np.int64)
    windows, groups = np.unique(scanned[:, 0], return_counts=True)
    want_a = {w: n for w, n in zip(windows.tolist(), groups.tolist())}
    assert {w: mx for w, mx, _s, _n in a} == \
        {w: r[2] for (w, _a), r in mv_rows.items()}, \
        "q5 hot batch (a): a window's MAX differs from the MV's count"
    assert sum(s for _w, _m, s, _n in a) == Q5_UNITS * n_bids, \
        "q5 hot batch (a): the SUMs do not count 5 copies of every bid"
    assert {w: n for w, _m, _s, n in a} == want_a, \
        "q5 hot batch (a): COUNT(*) differs from the scan's groups"
    assert sorted(b) == sorted(a), "q5 hot batch (b): run_agg differs"
    top = np.lexsort((scanned[:, 1], scanned[:, 0], -scanned[:, 2]))[:10]
    assert c == [tuple(r) for r in scanned[top].tolist()], \
        "q5 hot batch (c): the top 10 differs from numpy's"
    assert d == mv_rows, "q5 hot batch (d): a point get differs from the MV"
    return dict(epoch=epoch, agg_rows=len(scanned), windows=len(a),
                run_agg_rows=len(b), top10=len(c), mv_gets=len(d),
                seconds=seconds, total_s=sum(seconds.values()))


def run_q5_hot(dev, events: int, trace: bool = False, fusion: bool = False,
               tier_cap=None, batch: bool = False) -> dict:
    """q5-hot through build_q5 + drive_to_completion at bench_q5's
    chunking; the MV must equal the oracle, and the agg's state must
    count 5 copies of every bid. With ``fusion`` the agg must have
    absorbed the hop and the projection (agg_prelude in hop mode), and
    every K1 + K2 step must take 5 rows for each uploaded row; with
    ``tier_cap`` both stateful stages run under the cold tier, and each
    must both evict and reload; with ``batch``, the batch engine then
    reads the committed state (``q5_hot_batch``, outside the timed
    drive)."""
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.models.nexmark import build_q5
    from risingwave_tpu_torch.ops import fused as F
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.state.store import MemoryStateStore

    cfg = NexmarkConfig(event_num=events, max_chunk_size=4096,
                        generate_strings=False)
    p = build_q5(MemoryStateStore(), cfg, rate_limit=16, min_chunks=16,
                 tier_cap=tier_cap, fusion=fusion, device=dev)
    topn = p.actor.consumer.input
    agg = topn.input
    assert (agg.fused_stages is not None) == fusion, "fusion did not fire"
    n_bids = events * 46 // 50
    steps = {"raw": 0, "applied": 0}
    prelude, apply_batch = F.agg_prelude, H.apply_batch
    if fusion:
        assert agg.fused_stages.hop.units == Q5_UNITS

        def counted_prelude(prog, raw, *a, **k):
            steps["raw"] += int(raw.shape[0])
            return prelude(prog, raw, *a, **k)

        def counted_apply(state, packed, plan):
            steps["applied"] += int(packed.shape[0])
            return apply_batch(state, packed, plan)
        F.agg_prelude, H.apply_batch = counted_prelude, counted_apply
    try:
        out = drive(p, {1: n_bids}, dev, trace)
    finally:
        F.agg_prelude, H.apply_batch = prelude, apply_batch
    t0 = time.perf_counter()
    got = {r[0]: (r[1], r[2]) for _pk, r in p.mv_table.iter_rows()}
    want = q5_hot_oracle(cfg, n_bids)
    assert got == want, "q5-hot MV differs from the oracle"
    assert p.reader.offset == n_bids
    # the agg's state table read on the host: ~308K rows at 1M
    counted = sum(r[2] for _pk, r in agg.table.iter_rows())
    assert counted == Q5_UNITS * n_bids, \
        f"the agg counted {counted} rows, not {Q5_UNITS} x {n_bids}"
    if fusion:
        assert steps["raw"] and steps["applied"] == Q5_UNITS * steps["raw"], \
            f"K1 + K2 took {steps['applied']} rows for {steps['raw']} raw"
    extra = dict(windows=len(got), mv_digest=mv_digest(got.items()),
                 agg_rows_counted=counted, capacity=agg.kernel.capacity,
                 oracle_s=time.perf_counter() - t0, **(
                     dict(raw_rows=steps["raw"], applied_rows=steps["applied"])
                     if fusion else {}))
    if tier_cap is not None:
        parts = {"agg": agg._tier_part, "topn": topn._tier_part}
        for k, t in parts.items():
            assert t.evicted_total > 0 and t.reload_total > 0, \
                f"q5-hot's {k} under the tier evicted {t.evicted_total} " \
                f"and reloaded {t.reload_total} groups"
        extra["tier"] = {k: dict(evicted=t.evicted_total,
                                 reloaded=t.reload_total,
                                 resident=len(t.keys))
                         for k, t in parts.items()}
    if batch:
        extra["batch"] = q5_hot_batch(p, agg, n_bids)
        log(f"q5 hot batch at {events} events: "
            + json.dumps(extra["batch"]) + f"; card {card_line()}")
    return dict(out, **extra)


def q3_join_rows(customers: int, orders: int, block: int = 1 << 21) -> dict:
    """q3's second join output, vectorized: the columns the agg reads
    (l_orderkey, o_orderdate, o_shippriority, l_extendedprice,
    l_discount) of every lineitem shipped after the cutoff whose order
    was placed before it by a BUILDING customer, plus the stage counts;
    computed once per size."""
    key = ("q3", customers, orders)
    if key in _ORACLES:
        return _ORACLES[key]
    from risingwave_tpu_torch.connectors import tpch as T
    from risingwave_tpu_torch.models.tpch import CUTOFF
    cfg = T.TpchConfig(customers=customers, orders=orders)
    c = T.gen_customer(np.arange(customers, dtype=np.int64), cfg)
    building = np.zeros(customers + 1, bool)
    building[c["c_custkey"][c["c_mktsegment"] == "BUILDING"]] = True
    o = T.gen_orders(np.arange(orders, dtype=np.int64), cfg)
    early = o["o_orderdate"] < CUTOFF
    valid = np.zeros(orders + 1, bool)
    valid[o["o_orderkey"][early & building[o["o_custkey"]]]] = True
    odate = np.zeros(orders + 1, np.int64)
    odate[o["o_orderkey"]] = o["o_orderdate"]
    prio = np.zeros(orders + 1, np.int64)
    prio[o["o_orderkey"]] = o["o_shippriority"]
    parts, late, late_keys = [], 0, []
    n_line = orders * T.LINES_PER_ORDER
    for lo in range(0, n_line, block):
        li = T.gen_lineitem(np.arange(lo, min(lo + block, n_line),
                                      dtype=np.int64), cfg)
        shipped = li["l_shipdate"] > CUTOFF
        late += int(shipped.sum())
        late_keys.append(np.unique(li["l_orderkey"][shipped]))
        m = shipped & valid[li["l_orderkey"]]
        parts.append({k: li[k][m] for k in ("l_orderkey", "l_extendedprice",
                                            "l_discount")})
    cols = {k: np.concatenate([q[k] for q in parts]) for k in parts[0]}
    cols["o_orderdate"] = odate[cols["l_orderkey"]]
    cols["o_shippriority"] = prio[cols["l_orderkey"]]
    facts = dict(building=int(building.sum()), orders_early=int(early.sum()),
                 join1_rows=int(valid.sum()), lineitems_late=late,
                 late_orderkeys=len(np.unique(np.concatenate(late_keys))),
                 join2_rows=len(cols["l_orderkey"]))
    _ORACLES[key] = (cols, facts)
    return _ORACLES[key]


def q3_oracle(customers: int, orders: int, top: int = 10) -> tuple:
    """The top 10 (l_orderkey, o_orderdate, o_shippriority, revenue)
    rows: revenue = SUM(l_extendedprice * (1 - l_discount)) as scaled
    int64, exact (the product truncated toward zero), ordered by revenue
    DESC, o_orderdate, then the pk; the stage counts; and every group's
    row of the agg's state table, sorted (group keys, _group_rows, the
    sum, its non-NULL count)."""
    cols, facts = q3_join_rows(customers, orders)
    rev = cols["l_extendedprice"] * (10_000 - cols["l_discount"]) // 10_000
    keys, inv = np.unique(cols["l_orderkey"], return_inverse=True)
    tot = np.zeros(len(keys), np.int64)
    np.add.at(tot, inv, rev)
    first = np.zeros(len(keys), np.int64)
    first[inv] = np.arange(len(inv))
    od, pr = cols["o_orderdate"][first], cols["o_shippriority"][first]
    o = np.lexsort((pr, keys, od, -tot))[:top]
    rows = sorted(zip(keys[o].tolist(), od[o].tolist(), pr[o].tolist(),
                      tot[o].tolist()))
    cnt = np.bincount(inv).tolist()
    groups = list(zip(keys.tolist(), od.tolist(), pr.tolist(), cnt,
                      tot.tolist(), cnt))
    return rows, dict(facts, agg_groups=len(keys)), groups


def run_q3(dev, customers: int, orders: int, trace: bool = False,
           fusion: bool = False) -> dict:
    """TPC-H q3 through build_q3 + drive_to_completion (1024-row chunks,
    Q3_CHUNKS a barrier a source, two barriers in flight); the MV must
    equal the oracle exactly, so must every group's row of the agg's
    state table (its sum, its counts), and each join side must hold the
    oracle's count of rows. With ``fusion`` the agg must
    have absorbed the revenue projection and the orders and lineitem
    sides their filters and row ids, the customer side staying on the
    host (its VARCHAR predicate)."""
    from risingwave_tpu_torch.connectors.tpch import LINES_PER_ORDER
    from risingwave_tpu_torch.models.tpch import build_q3
    from risingwave_tpu_torch.state.store import MemoryStateStore

    p = build_q3(MemoryStateStore(), customers=customers, orders=orders,
                 rate_limit=Q3_CHUNKS, min_chunks=Q3_CHUNKS, fusion=fusion,
                 device=dev)
    agg = p.actor.consumer.input.input
    j2 = agg.input if fusion else agg.input.input
    j1 = j2.left_in
    fired = [agg.fused_stages is not None] + [
        s.fused_input is not None for s in j1.sides + j2.sides]
    assert fired == [fusion, False, fusion, False, fusion], \
        f"fusion fired as {fired}"
    out = drive(p, {1: customers, 2: orders,
                    3: orders * LINES_PER_ORDER}, dev, trace)
    t0 = time.perf_counter()
    rows = sorted(tuple(r) for _pk, r in p.mv_table.iter_rows())
    want, facts, groups = q3_oracle(customers, orders)
    assert rows == want, "q3 MV differs from the oracle"
    agg_rows = sorted(tuple(r) for _pk, r in agg.table.iter_rows())
    assert agg_rows == groups, \
        f"q3's agg state differs from the oracle's {len(groups)} groups " \
        f"({len(agg_rows)} rows)"
    stored = [[s.next_ref - len(s.free) for s in j.sides] for j in (j1, j2)]
    assert stored == [[facts["building"], facts["orders_early"]],
                      [facts["join1_rows"], facts["lineitems_late"]]], \
        f"join state {stored} differs from the oracle's {facts}"
    return dict(out, mv_rows=len(rows), mv_digest=mv_digest(rows),
                stored_rows=stored,
                key_capacity=[[s.kernel.table.capacity for s in j.sides]
                              for j in (j1, j2)],
                row_capacity=[[s.kernel.row_capacity for s in j.sides]
                              for j in (j1, j2)],
                agg_capacity=agg.kernel.capacity, agg_rows=len(agg_rows),
                agg_digest=mv_digest(agg_rows), oracle=facts,
                oracle_s=time.perf_counter() - t0)


# -- phase 4: the SQL front door (Frontend) ------------------------------------

SQL_Q4_EVENTS = 2_000_000     # 120,000 auctions, 1,840,000 bids (cut from 100M)
SQL_Q4_TRACE_EVENTS = 500_000
SQL_Q4_CHUNK = 4096           # bench_q4's sources and session
SQL_Q4_RATE = 16
# bench.py:374-380, letter for letter
SQL_Q4 = ("CREATE MATERIALIZED VIEW q4 AS "
          "SELECT category, AVG(final) AS avg_final FROM ("
          "  SELECT a.category AS category, MAX(b.price) AS final"
          "  FROM auction AS a JOIN bid AS b ON a.id = b.auction"
          "  WHERE b.date_time BETWEEN a.date_time AND a.expires"
          "  GROUP BY a.id, a.category) AS q "
          "GROUP BY category")
# tests/test_tpch.py:86-95's statement
SQL_Q3 = ("CREATE MATERIALIZED VIEW q3 AS SELECT "
          "o.o_orderkey, o.o_orderdate, o.o_shippriority, "
          "sum(l.l_extendedprice * (1 - l.l_discount)) AS revenue "
          "FROM customer AS c "
          "JOIN orders AS o ON c.c_custkey = o.o_custkey "
          "JOIN lineitem AS l ON o.o_orderkey = l.l_orderkey "
          "WHERE c.c_mktsegment = 'BUILDING' "
          "AND o.o_orderdate < {cutoff} AND l.l_shipdate > {cutoff} "
          "GROUP BY o.o_orderkey, o.o_orderdate, o.o_shippriority "
          "ORDER BY revenue DESC, o_orderdate ASC LIMIT 10")
# the session's defaults fuse: the join sides absorb their projections
# and row ids (join_prelude), the aggs their filters and projections
# (agg_prelude)
SQL_PATH = ("probe_insert", "agg_apply", "flush_gather", "advance",
            "join_apply", "join_probe", "agg_prelude", "join_prelude")


def q4_oracle(events: int, block: int = 1 << 21) -> list:
    """(category, AVG(final)) of Nexmark q4, vectorized: final is the
    MAX bid price per auction over its bids with a.date_time <=
    b.date_time <= a.expires; the AVG is the binder's: the integer SUM
    and the COUNT, each cast to FLOAT64, divided."""
    key = ("q4", events)
    if key in _ORACLES:
        return _ORACLES[key]
    from risingwave_tpu_torch.connectors.nexmark import (
        NexmarkConfig, gen_auctions, gen_bids,
    )
    cfg = NexmarkConfig(event_num=events, max_chunk_size=SQL_Q4_CHUNK,
                        generate_strings=False)
    n_auc, n_bid = events * 3 // 50, events * 46 // 50
    a = gen_auctions(np.arange(n_auc, dtype=np.int64), cfg)
    order = np.argsort(a["id"], kind="stable")
    ids = a["id"][order]
    final = np.full(n_auc, -1, np.int64)
    for lo in range(0, n_bid, block):
        b = gen_bids(np.arange(lo, min(lo + block, n_bid), dtype=np.int64),
                     cfg)
        pos = np.minimum(np.searchsorted(ids, b["auction"]), n_auc - 1)
        k = order[pos]
        ok = ((ids[pos] == b["auction"])
              & (a["date_time"][k] <= b["date_time"])
              & (b["date_time"] <= a["expires"][k]))
        np.maximum.at(final, k[ok], b["price"][ok])
    has = final >= 0
    cats, inv = np.unique(a["category"][has], return_inverse=True)
    tot = np.zeros(len(cats), np.int64)
    np.add.at(tot, inv, final[has])
    cnt = np.bincount(inv, minlength=len(cats))
    avg = tot.astype(np.float64) / cnt.astype(np.float64)
    _ORACLES[key] = (sorted(zip(cats.tolist(), avg.tolist())),
                     dict(auctions_with_final=int(has.sum()),
                          categories=len(cats)))
    return _ORACLES[key]


async def drive_frontend(fe, expected: int, dev, trace: bool,
                         in_flight: int = 2, max_epochs: int = 2000) -> dict:
    """bench.py's _drive_frontend on a port session: one warmup step,
    then barriers pipelined ``in_flight`` deep until the sources have
    read ``expected`` rows; events/s and the barrier latencies count
    after the warmup. Every launch count is reset just before the warmup
    and read just after the last collect. With ``trace``, the drive runs
    under torch.profiler and cProfile, as ``drive``'s."""
    from risingwave_tpu_torch.utils.device import LAUNCHES

    readers = [r for d in fe.readers.values() for r in d.values()]

    def rows_seen() -> int:
        return sum(_reader_rows(r) for r in readers)

    async def run():
        await fe.step(1)
        warm = rows_seen()
        assert warm < expected, "warmup consumed every row"
        loop = fe.loop
        warm_epochs = len(loop.stats.latencies_s)
        t0 = time.perf_counter()
        injected = 0
        while rows_seen() < expected:
            assert injected < max_epochs, \
                f"sources stalled at {rows_seen()}/{expected}"
            while loop.in_flight_count < in_flight:
                await loop.inject()
                injected += 1
            await loop.collect_next()
        while loop.in_flight_count:
            await loop.collect_next()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
        loop.stats.latencies_s = loop.stats.latencies_s[warm_epochs:]
        loop.profiler.drop_first(warm_epochs)
        return elapsed, rows_seen() - warm

    traced = {}
    LAUNCHES.reset()
    if trace:
        import cProfile
        from torch.profiler import ProfilerActivity, profile
        host = cProfile.Profile()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            host.enable()
            elapsed, rows = await run()
            host.disable()
            wall = time.perf_counter() - t0
        traced = traced_summary(prof, host, wall)
    else:
        t0 = time.perf_counter()
        elapsed, rows = await run()
        wall = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    lat = np.asarray(fe.loop.stats.latencies_s)
    return dict(events=rows, elapsed_s=elapsed, wall_s=wall,
                events_per_s=rows / elapsed,
                p99_barrier_latency_s=fe.loop.stats.p99_latency_s(),
                barrier_latency_s={
                    "p50": float(np.percentile(lat, 50)),
                    "p90": float(np.percentile(lat, 90)),
                    "max": float(lat.max())},
                barrier_breakdown_p99=fe.loop.profiler.p99_breakdown(),
                barriers=len(lat), launches=launches, **traced)


def plan_facts(fe, name: str) -> dict:
    """What CREATE did for one MV: planning + rewrite seconds, the rules
    and fusion that fired, the K2 mode of each agg, and each keyed
    executor's kernel class and shard count, top down."""
    report = fe.mv_reports[name]
    modes = []
    kernels = []

    def walk(ex):
        if type(ex).__name__ == "HashAggExecutor":
            modes.append("append-only" if ex.append_only
                         else "retractable")
            k = ex.kernel
            kernels.append(("agg", type(k).__name__, getattr(k, "n_dev", 1)))
        if type(ex).__name__ == "HashJoinExecutor":
            k = ex.sides[0].kernel
            kernels.append(("join", type(k).__name__,
                            getattr(k, "n_dev", 1)))
        for attr in ("input", "left_in", "right_in"):
            c = getattr(ex, attr, None)
            if c is not None and hasattr(c, "execute"):
                walk(c)
    walk(fe.actors[fe.catalog.mvs[name].actor_id].consumer)
    return dict(plan_s=fe.mv_plan_seconds[name], rules=report.summary(),
                rule_details=[f"{r}: {d}" for r, d in report.details],
                fallbacks=report.fallbacks, agg_modes=modes,
                kernels=kernels)


def sharded_kernels(parallelism: int, aggs: int = 0, joins: int = 0) -> list:
    """The kernels a plan of ``aggs`` aggs and ``joins`` joins gets at one
    parallelism, sorted as ``plan_facts`` lists them."""
    if parallelism > 1:
        return sorted([("agg", "ShardedAggKernel", parallelism)] * aggs
                      + [("join", "ShardedJoinKernel", parallelism)] * joins)
    return sorted([("agg", "GroupedAggKernel", 1)] * aggs
                  + [("join", "JoinSideKernel", 1)] * joins)


def run_sql_q4(dev, events: int, trace: bool = False,
               bare: bool = False) -> dict:
    """Nexmark q4 through ``Frontend(device=dev)``: bench_q4's session
    (rate_limit=16, min_chunks=16), sources (4096-row chunks, no strings)
    and SQL, the session's default rules and fusion, driven two barriers
    in flight to every event; the MV equal to the oracle exactly. With
    ``bare`` the MV's actor ends without its (empty) broadcast
    dispatcher, as before MV on MV: the dispatch's own cost is the
    difference."""
    from risingwave_tpu_torch.frontend import Frontend

    async def main():
        fe = Frontend(rate_limit=SQL_Q4_RATE, min_chunks=SQL_Q4_RATE,
                      device=dev)
        for t in ("auction", "bid"):
            await fe.execute(
                f"CREATE SOURCE {t} WITH (connector='nexmark', "
                f"nexmark.table.type='{t}', "
                f"nexmark.event.num={events}, "
                f"nexmark.max.chunk.size={SQL_Q4_CHUNK}, "
                f"nexmark.generate.strings='false')")
        t0 = time.perf_counter()
        await fe.execute(SQL_Q4)
        create_s = time.perf_counter() - t0
        if bare:
            fe.actors[fe.catalog.mvs["q4"].actor_id].dispatchers.clear()
        facts = plan_facts(fe, "q4")
        out = await drive_frontend(fe, events * 3 // 50 + events * 46 // 50,
                                   dev, trace)
        rows = await fe.execute("SELECT category, avg_final FROM q4")
        await fe.close()
        return out, facts, create_s, rows

    out, facts, create_s, rows = asyncio.run(main())
    rows = sorted((int(c), float(v)) for c, v in rows)
    want, ofacts = q4_oracle(events)
    assert rows == want, "sql q4: the MV differs from the oracle"
    assert facts["agg_modes"] == ["retractable", "append-only"], \
        f"sql q4 planned its aggs as {facts['agg_modes']}"
    return dict(out, create_s=create_s, **facts, mv_rows=len(rows),
                mv_digest=mv_digest(rows), oracle=ofacts)


def run_sql_q3(dev, customers: int, orders: int) -> dict:
    """TPC-H q3 in SQL through ``Frontend(device=dev)`` with build_q3's
    chunking (1024-row chunks, Q3_CHUNKS a barrier a source), fused as
    the session defaults; the MV's rows (physical: the revenue a scaled
    int64) equal to the oracle, digested for the build_q3 arm's."""
    from risingwave_tpu_torch.connectors.tpch import LINES_PER_ORDER
    from risingwave_tpu_torch.frontend import Frontend
    from risingwave_tpu_torch.models.tpch import CUTOFF

    async def main():
        fe = Frontend(rate_limit=Q3_CHUNKS, min_chunks=Q3_CHUNKS,
                      device=dev)
        for t in ("customer", "orders", "lineitem"):
            await fe.execute(
                f"CREATE SOURCE {t} WITH (connector='tpch', "
                f"tpch.table='{t}', tpch.customers={customers}, "
                f"tpch.orders={orders})")
        t0 = time.perf_counter()
        await fe.execute(SQL_Q3.format(cutoff=CUTOFF))
        create_s = time.perf_counter() - t0
        facts = plan_facts(fe, "q3")
        out = await drive_frontend(
            fe, customers + orders + orders * LINES_PER_ORDER, dev, False)
        mat = fe.actors[fe.catalog.mvs["q3"].actor_id].consumer
        phys = sorted(tuple(r) for _pk, r in mat.table.iter_rows())
        await fe.close()
        return out, facts, create_s, phys

    out, facts, create_s, rows = asyncio.run(main())
    want, _facts, _groups = q3_oracle(customers, orders)
    assert rows == want, "sql q3: the MV differs from the oracle"
    return dict(out, create_s=create_s, **facts, mv_rows=len(rows),
                mv_digest=mv_digest(rows))



# -- phase 4: tables, DML, MV on MV, the temporal join and filelog in SQL ----

ADCTR_IMPRESSIONS = 200_000   # bench_adctr's: 66,667 clicks, 466,667 rows read
ADCTR_TRACE_IMPRESSIONS = 100_000   # the CREATEs and the warmup read ~70%
ADCTR_ADS = 100
ADCTR_RATE = 8                # bench_adctr's session: rate_limit = min_chunks
ADCTR_BASE_US = 1_700_000_000_000_000
ADCTR_SLIDE_US = 2_000_000
ADCTR_SIZE_US = 10_000_000
ADCTR_DIR = os.path.join("build", "adctr")   # the topics, under build/
# both aggs and the join on the card; the fusion rule absorbs the join
# sides' row ids and the aggs' projections
ADCTR_PATH = ("probe_insert", "agg_apply", "flush_gather", "advance",
              "join_apply", "join_probe", "agg_prelude", "join_prelude")
CHAIN_EVENTS = 2_000_000      # sql q4's bid source: 1,840,000 bids
CHAIN_M1 = ("CREATE MATERIALIZED VIEW m1 AS SELECT auction, count(*) AS c "
            "FROM bid GROUP BY auction")
# tests/test_frontend.py:504's m2
CHAIN_M2 = ("CREATE MATERIALIZED VIEW m2 AS SELECT c, count(*) AS n, "
            "min(auction) AS ma FROM m1 GROUP BY c")
CHAIN_TM = ("CREATE MATERIALIZED VIEW tm AS SELECT k, sum(v) AS s, "
            "count(*) AS n FROM t GROUP BY k")
CHAIN_PATH = ("probe_insert", "agg_apply", "flush_gather", "advance",
              "agg_prelude")
# ad-ctr at bench_adctr's parallelism 4: both aggs and the join on the
# shard axis of K1-K6 behind route
ADCTR_P4 = 4
ADCTR_P4_PATH = ("route", "probe_insert", "agg_apply", "flush_gather",
                 "advance", "join_apply", "join_probe")
# ALTER ... SET PARALLELISM on tests/test_reschedule.py's MV over sql q4's
# bid source: 1 -> 8 at half the bids, 8 -> 1 at three quarters; each
# redeploy reloads the kept agg table through K1 + K9
ALTER_EVENTS = 2_000_000
ALTER_SHARDS = 8
ALTER_MV = ("CREATE MATERIALIZED VIEW v AS SELECT auction, count(*) AS c, "
            "max(price) AS m FROM bid GROUP BY auction")
ALTER_PATH = ("route", "probe_insert", "agg_apply", "flush_gather",
              "advance", "scatter_rows")
# sql q4 over the PostgreSQL wire on a Frontend(parallelism=4)
PGWIRE_EVENTS = 200_000
PGWIRE_P = 4
PGWIRE_PATH = ADCTR_P4_PATH


def adctr_produce(path: str, n_impressions: int, n_ads: int = 100):
    """bench.py's _adctr_produce, letter for letter: filelog topics
    standing in for the ad-ctr demo's Kafka topics."""
    import json as _json
    import os

    import numpy as np
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(42)
    ads = rng.integers(0, n_ads, n_impressions)
    base = 1_700_000_000_000_000
    with open(os.path.join(path, "impressions-0.log"), "wb") as f:
        for i in range(n_impressions):
            f.write(_json.dumps({
                "bid_id": i, "ad_id": int(ads[i]),
                "its": base + i * 10_000}).encode() + b"\n")
    with open(os.path.join(path, "clicks-0.log"), "wb") as f:
        for i in range(0, n_impressions, 3):
            f.write(_json.dumps({
                "cbid": i, "cts": base + i * 10_000 + 500}).encode()
                + b"\n")


def adctr_ddl(path: str) -> list:
    """bench.py's _adctr_ddl, letter for letter."""
    return [
        f"CREATE SOURCE impression (bid_id BIGINT, ad_id BIGINT, "
        f"its TIMESTAMP) WITH (connector='filelog', "
        f"path='{path}', topic='impressions', "
        f"max.chunk.size=4096)",
        f"CREATE SOURCE click (cbid BIGINT, cts TIMESTAMP) WITH "
        f"(connector='filelog', path='{path}', topic='clicks', "
        f"max.chunk.size=4096)",
        "CREATE MATERIALIZED VIEW ad_dim AS SELECT ad_id, "
        "count(*) AS seen FROM impression GROUP BY ad_id",
        "CREATE MATERIALIZED VIEW ad_ctr AS SELECT i.ad_id, "
        "i.window_start, count(*) AS clicked "
        "FROM HOP(impression, its, INTERVAL '2' SECOND, "
        "INTERVAL '10' SECOND) AS i "
        "JOIN click AS c ON i.bid_id = c.cbid "
        "JOIN ad_dim AS d FOR SYSTEM_TIME AS OF PROCTIME() "
        "ON i.ad_id = d.ad_id "
        "GROUP BY i.ad_id, i.window_start",
    ]


def adctr_oracle(n_impressions: int, n_ads: int = ADCTR_ADS) -> dict:
    """tests/test_adctr.py's _oracle without its Python loop: per (ad,
    window_start) the clicked impressions (every third), each in the
    size/slide HOP windows that hold its timestamp."""
    ads = np.random.default_rng(42).integers(0, n_ads, n_impressions)
    i = np.arange(0, n_impressions, 3, dtype=np.int64)
    base = (ADCTR_BASE_US + i * 10_000) // ADCTR_SLIDE_US * ADCTR_SLIDE_US
    k = np.arange(ADCTR_SIZE_US // ADCTR_SLIDE_US, dtype=np.int64)
    w = (base[:, None] - k[None, :] * ADCTR_SLIDE_US).ravel()
    a = np.repeat(ads[i], len(k))
    keys, cnt = np.unique(np.stack([a, w], 1), axis=0, return_counts=True)
    return {(int(x), int(y)): int(c) for (x, y), c in zip(keys, cnt)}


def _reader_rows(r) -> int:
    """Rows a source reader has read: a filelog reader counts them, a
    generator's offset is its row offset (bench.py's rows_seen)."""
    return r.rows_read if hasattr(r, "rows_read") else r.offset


def run_sql_adctr(dev, n_impressions: int, trace: bool = False,
                  parallelism: int = 1) -> dict:
    """ad-ctr (BASELINE.md's named configuration) through
    ``Frontend(device=dev, rate_limit=8, min_chunks=8, parallelism=...)``:
    bench_adctr's DDL and producer, two filelog sources (JSON parsed on
    the host), HOP windows, the impression-click join, the temporal join
    against the ad_dim MV and the sliding-window agg, driven two barriers
    in flight to every row of the three readers. ad_ctr equals the
    vectorized oracle exactly and ad_dim's ``seen`` sums to the
    impressions. At parallelism n > 1 (bench_adctr's own is 4) both aggs
    run on ShardedAggKernel(n) and the impression-click join on the
    sharded join kernel."""
    from risingwave_tpu_torch.frontend import Frontend

    path = os.path.abspath(ADCTR_DIR)
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    adctr_produce(path, n_impressions, ADCTR_ADS)
    produce_s = time.perf_counter() - t0

    async def main():
        fe = Frontend(rate_limit=ADCTR_RATE, min_chunks=ADCTR_RATE,
                      device=dev, parallelism=parallelism)
        t0 = time.perf_counter()
        for sql in adctr_ddl(path):
            await fe.execute(sql)
        create_s = time.perf_counter() - t0
        facts = {n: plan_facts(fe, n) for n in ("ad_dim", "ad_ctr")}
        expected = 2 * n_impressions + (n_impressions + 2) // 3
        out = await drive_frontend(fe, expected, dev, trace)
        rows = await fe.execute("SELECT * FROM ad_ctr")
        dim = await fe.execute("SELECT ad_id, seen FROM ad_dim")
        await fe.close()
        return out, facts, create_s, rows, dim

    try:
        out, facts, create_s, rows, dim = asyncio.run(main())
    finally:
        shutil.rmtree(path, ignore_errors=True)
    got = {(int(a), int(w)): int(c) for a, w, c in rows}
    want = adctr_oracle(n_impressions)
    assert got == want, (f"sql adctr: {len(got)} (ad, window) rows, the "
                         f"oracle has {len(want)}")
    seen = sum(int(s) for _a, s in dim)
    assert seen == n_impressions, f"sql adctr: ad_dim saw {seen}"
    modes = [m for n in ("ad_dim", "ad_ctr") for m in facts[n]["agg_modes"]]
    assert modes == ["append-only", "append-only"], \
        f"sql adctr planned its aggs as {modes}"
    kernels = sorted(k for n in ("ad_dim", "ad_ctr")
                     for k in facts[n]["kernels"])
    want_k = sharded_kernels(parallelism, aggs=2, joins=1)
    assert kernels == want_k, \
        f"sql adctr at parallelism {parallelism} planned {kernels}"
    return dict(out, produce_s=produce_s, create_s=create_s,
                parallelism=parallelism, kernels=kernels,
                plan_s={n: f["plan_s"] for n, f in facts.items()},
                rules={n: f["rules"] for n, f in facts.items()},
                rule_details={n: f["rule_details"]
                              for n, f in facts.items()},
                fallbacks={n: f["fallbacks"] for n, f in facts.items()},
                agg_modes={n: f["agg_modes"] for n, f in facts.items()},
                mv_rows=len(got), ad_dim_seen=seen,
                mv_digest=mv_digest(sorted(
                    (a, w, c) for (a, w), c in got.items())))


def chain_oracle(events: int) -> dict:
    """m1 (count per auction over every bid), m2 (m1's histogram: per
    count the auctions and the smallest one) and the table MV over
    (k = c, v = auction) rows: as inserted, after DELETE WHERE k = 1,
    after UPDATE SET v = v + 1 WHERE k > 1."""
    from risingwave_tpu_torch.connectors.nexmark import (
        NexmarkConfig, gen_bids,
    )
    cfg = NexmarkConfig(event_num=events, max_chunk_size=SQL_Q4_CHUNK,
                        generate_strings=False)
    b = gen_bids(np.arange(events * 46 // 50, dtype=np.int64), cfg)
    auc, c = np.unique(b["auction"], return_counts=True)
    m1 = sorted(zip(auc.tolist(), c.tolist()))
    cs, inv, n = np.unique(c, return_inverse=True, return_counts=True)
    ma = np.full(len(cs), np.iinfo(np.int64).max)
    np.minimum.at(ma, inv, auc)
    s = np.zeros(len(cs), np.int64)
    np.add.at(s, inv, auc)
    m2 = sorted(zip(cs.tolist(), n.tolist(), ma.tolist()))
    tm = sorted(zip(cs.tolist(), s.tolist(), n.tolist()))
    deleted = [r for r in tm if r[0] != 1]
    updated = [(k, sv + nv, nv) for k, sv, nv in deleted]
    return dict(m1=m1, m2=m2, tm=tm, tm_deleted=deleted,
                tm_updated=updated)


def _backfill_of(fe, name: str):
    """The BackfillExecutor of one MV's chain."""
    ex = fe.actors[fe.catalog.mvs[name].actor_id].consumer
    while type(ex).__name__ != "BackfillExecutor":
        ex = next(getattr(ex, a) for a in ("input", "upstream")
                  if hasattr(ex, a))
    return ex


def _count_backfill(bf) -> dict:
    """Count the snapshot rows a backfill emits and stamp when it is
    done (the executor's own slice reader, wrapped on the instance)."""
    got = dict(rows=0, slices=0, done_at=None)
    read = bf._read_snapshot_slice

    def counted():
        rows = read()
        got["rows"] += len(rows)
        got["slices"] += 1
        if bf.done and got["done_at"] is None:
            got["done_at"] = time.perf_counter()
        return rows
    bf._read_snapshot_slice = counted
    return got


def run_sql_mv_chain(dev, events: int) -> dict:
    """MV on MV and a table through ``Frontend(device=dev)``: sql q4's
    bid source (4096-row chunks, 16 a barrier, no strings); m1 counts
    bids per auction over half the bids, then m2 (m1's histogram)
    backfills m1's committed snapshot while m1 keeps running, and both
    run to the end; then a table t filled by INSERT ... SELECT from m1,
    an agg MV over t (backfilled), DELETE and UPDATE. Every MV equals its
    oracle after each statement commits. Launch counts are reset before
    each drive and before the steps that follow them (the backfill's
    tail, then the table step), and summed."""
    from risingwave_tpu_torch.frontend import Frontend
    from risingwave_tpu_torch.utils.device import LAUNCHES

    n_bids = events * 46 // 50
    oracle = chain_oracle(events)

    def norm(rows):
        return sorted(tuple(int(x) for x in r) for r in rows)

    async def main():
        fe = Frontend(rate_limit=SQL_Q4_RATE, min_chunks=SQL_Q4_RATE,
                      device=dev)
        await fe.execute(
            f"CREATE SOURCE bid WITH (connector='nexmark', "
            f"nexmark.table.type='bid', nexmark.event.num={events}, "
            f"nexmark.max.chunk.size={SQL_Q4_CHUNK}, "
            f"nexmark.generate.strings='false')")
        await fe.execute(CHAIN_M1)
        first = await drive_frontend(fe, n_bids // 2, dev, False)
        t_m2 = time.perf_counter()
        await fe.execute(CHAIN_M2)
        m2_create_s = time.perf_counter() - t_m2
        m2_bf = _count_backfill(_backfill_of(fe, "m2"))
        m2_bf["t_create"] = t_m2
        second = await drive_frontend(fe, n_bids, dev, False)
        # the source is spent; the backfill reads 8,192 snapshot rows a
        # barrier until it has covered m1 (counted from here on)
        LAUNCHES.reset()
        while m2_bf["done_at"] is None:
            await fe.step(1)
        await fe.step(1)
        checks = dict(m1=norm(await fe.execute("SELECT * FROM m1"))
                      == oracle["m1"],
                      m2=norm(await fe.execute("SELECT * FROM m2"))
                      == oracle["m2"])
        # the table step
        t0 = time.perf_counter()
        await fe.execute("CREATE TABLE t (k BIGINT, v BIGINT)")
        inserted = await fe.execute("INSERT INTO t SELECT c, auction "
                                    "FROM m1")
        insert_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        await fe.execute(CHAIN_TM)
        tm_bf = _count_backfill(_backfill_of(fe, "tm"))
        while tm_bf["done_at"] is None:
            await fe.step(1)
        await fe.step(1)
        tm_backfill_s = time.perf_counter() - t0
        checks["tm"] = norm(await fe.execute("SELECT * FROM tm")) \
            == oracle["tm"]
        t0 = time.perf_counter()
        deleted = await fe.execute("DELETE FROM t WHERE k = 1")
        delete_s = time.perf_counter() - t0
        checks["tm_deleted"] = norm(await fe.execute(
            "SELECT * FROM tm")) == oracle["tm_deleted"]
        t0 = time.perf_counter()
        updated = await fe.execute("UPDATE t SET v = v + 1 WHERE k > 1")
        update_s = time.perf_counter() - t0
        checks["tm_updated"] = norm(await fe.execute(
            "SELECT * FROM tm")) == oracle["tm_updated"]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        table_launches = LAUNCHES.snapshot()
        facts = {n: plan_facts(fe, n) for n in ("m1", "m2", "tm")}
        await fe.close()
        return (first, second, m2_create_s, m2_bf, checks, table_launches,
                facts, dict(insert=inserted, insert_s=insert_s,
                            tm_backfill_s=tm_backfill_s,
                            tm_backfill_rows=tm_bf["rows"],
                            delete=deleted, delete_s=delete_s,
                            update=updated, update_s=update_s))

    (first, second, m2_create_s, m2_bf, checks, table_launches, facts,
     table) = asyncio.run(main())
    bad = [k for k, ok in checks.items() if not ok]
    assert not bad, f"sql mv chain: {bad} differ from the oracle"
    modes = {n: f["agg_modes"] for n, f in facts.items()}
    assert modes == {"m1": ["append-only"], "m2": ["retractable"],
                     "tm": ["retractable"]}, \
        f"sql mv chain planned its aggs as {modes}"
    launches = {}
    for part in (first["launches"], second["launches"], table_launches):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    events_total = first["events"] + second["events"]
    elapsed = first["elapsed_s"] + second["elapsed_s"]
    return dict(events=events_total, elapsed_s=elapsed,
                wall_s=first["wall_s"] + second["wall_s"],
                events_per_s=events_total / elapsed,
                events_per_s_m1_alone=first["events_per_s"],
                events_per_s_with_m2=second["events_per_s"],
                p99_barrier_latency_s=max(first["p99_barrier_latency_s"],
                                          second["p99_barrier_latency_s"]),
                p99_barrier_latency_s_m1_alone=first[
                    "p99_barrier_latency_s"],
                p99_barrier_latency_s_with_m2=second[
                    "p99_barrier_latency_s"],
                m2_create_s=m2_create_s,
                m2_backfill_rows=m2_bf["rows"],
                m2_backfill_slices=m2_bf["slices"],
                m2_backfill_s=(m2_bf["done_at"] - m2_bf["t_create"])
                if m2_bf["done_at"] is not None else None,
                table=table, agg_modes=modes,
                plan_s={n: f["plan_s"] for n, f in facts.items()},
                rules={n: f["rules"] for n, f in facts.items()},
                launches=launches, mv_rows=len(oracle["m1"]),
                mv_digest=mv_digest(oracle["m2"]))


def alter_oracle(events: int) -> list:
    """(auction, count, max price) over every bid of ``events``."""
    from risingwave_tpu_torch.connectors.nexmark import (
        NexmarkConfig, gen_bids,
    )
    cfg = NexmarkConfig(event_num=events, max_chunk_size=SQL_Q4_CHUNK,
                        generate_strings=False)
    b = gen_bids(np.arange(events * 46 // 50, dtype=np.int64), cfg)
    auc, inv, cnt = np.unique(b["auction"], return_inverse=True,
                              return_counts=True)
    mx = np.full(len(auc), np.iinfo(np.int64).min)
    np.maximum.at(mx, inv, b["price"])
    return sorted(zip(auc.tolist(), cnt.tolist(), mx.tolist()))


def run_sql_alter(dev, events: int) -> dict:
    """ALTER MATERIALIZED VIEW ... SET PARALLELISM through
    ``Frontend(device=dev)``: sql q4's bid source and session,
    ``ALTER_MV`` created at parallelism 1, driven to half the bids, altered
    to 8 shards, driven to three quarters, altered back to 1, driven to
    the end. The MV equals the oracle and an uninterrupted parallelism-1
    run's digest from the same call. Each ALTER's seconds (what a user
    waits for a reschedule: the stop barrier, the replan, the reload of
    the kept tables and the activation barrier) and its launches (K1 + K9
    for the reload) are kept; the path's launches are the drives' and the
    ALTERs' summed."""
    from risingwave_tpu_torch.frontend import Frontend
    from risingwave_tpu_torch.utils.device import LAUNCHES

    n_bids = events * 46 // 50
    want = alter_oracle(events)

    async def one(alters):
        fe = Frontend(rate_limit=SQL_Q4_RATE, min_chunks=SQL_Q4_RATE,
                      device=dev)
        await fe.execute(
            f"CREATE SOURCE bid WITH (connector='nexmark', "
            f"nexmark.table.type='bid', nexmark.event.num={events}, "
            f"nexmark.max.chunk.size={SQL_Q4_CHUNK}, "
            f"nexmark.generate.strings='false')")
        await fe.execute(ALTER_MV)
        drives, steps = [], []
        for upto, n in alters:
            drives.append(await drive_frontend(fe, int(n_bids * upto), dev,
                                               False))
            LAUNCHES.reset()
            t0 = time.perf_counter()
            await fe.execute(
                f"ALTER MATERIALIZED VIEW v SET PARALLELISM = {n}")
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            steps.append(dict(to=n, seconds=time.perf_counter() - t0,
                              launches=LAUNCHES.snapshot(),
                              kernels=plan_facts(fe, "v")["kernels"]))
        drives.append(await drive_frontend(fe, n_bids, dev, False))
        rows = await fe.execute("SELECT * FROM v")
        await fe.close()
        return drives, steps, sorted(tuple(int(x) for x in r)
                                     for r in rows)

    straight, _none, rows0 = asyncio.run(one([]))
    drives, steps, rows = asyncio.run(one([(0.5, ALTER_SHARDS),
                                           (0.75, 1)]))
    assert rows0 == want, "sql alter: the uninterrupted MV differs"
    assert rows == want, "sql alter: the altered MV differs from the oracle"
    assert mv_digest(rows) == mv_digest(rows0)
    assert [s["kernels"] for s in steps] == [
        sharded_kernels(ALTER_SHARDS, aggs=1), sharded_kernels(1, aggs=1)], \
        f"sql alter: the ALTERs planned {[s['kernels'] for s in steps]}"
    for s in steps:
        # (a CPU rehearsal launches nothing: the plain versions run)
        assert dev.type != "cuda" or s["launches"].get("scatter_rows", 0), \
            f"sql alter: the ALTER to {s['to']} reloaded no state (K9)"
    launches = {}
    for part in [d["launches"] for d in drives] + \
            [s["launches"] for s in steps]:
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    events_total = sum(d["events"] for d in drives)
    elapsed = sum(d["elapsed_s"] for d in drives)
    return dict(events=events_total, elapsed_s=elapsed,
                wall_s=sum(d["wall_s"] for d in drives),
                events_per_s=events_total / elapsed,
                events_per_s_by_drive=[d["events_per_s"] for d in drives],
                p99_barrier_latency_s=max(d["p99_barrier_latency_s"]
                                          for d in drives),
                p99_by_drive=[d["p99_barrier_latency_s"] for d in drives],
                alters=[{k: s[k] for k in ("to", "seconds", "launches")}
                        for s in steps],
                uninterrupted_events_per_s=straight[0]["events_per_s"],
                uninterrupted_p99_s=straight[0]["p99_barrier_latency_s"],
                launches=launches, mv_rows=len(rows),
                mv_digest=mv_digest(rows))


class PgClient:
    """A PostgreSQL v3 client over one loopback connection: the startup
    handshake (the SSL probe first), simple queries and the extended
    protocol, every value read in text format."""

    def __init__(self, reader, writer):
        self.r, self.w = reader, writer

    @classmethod
    async def connect(cls, port: int) -> "PgClient":
        import struct
        r, w = await asyncio.open_connection("127.0.0.1", port)
        c = cls(r, w)
        w.write(struct.pack(">II", 8, 80877103))
        await w.drain()
        assert await r.readexactly(1) == b"N", "pgwire: SSL not declined"
        params = b"user\x00smoke\x00database\x00dev\x00\x00"
        w.write(struct.pack(">II", 8 + len(params), 196608) + params)
        await w.drain()
        msgs = await c.read_until(b"Z")
        assert msgs[0] == (b"R", struct.pack(">I", 0)), msgs[0]
        return c

    async def read_until(self, tag: bytes) -> list:
        import struct
        out = []
        while True:
            hdr = await self.r.readexactly(5)
            n = struct.unpack(">I", hdr[1:5])[0]
            out.append((hdr[0:1], await self.r.readexactly(n - 4)))
            if out[-1][0] == tag:
                return out

    def _send(self, tag: bytes, body: bytes) -> None:
        import struct
        self.w.write(tag + struct.pack(">I", len(body) + 4) + body)

    async def extended(self, sql: str) -> list:
        """Parse, Bind, Describe (portal), Execute and Sync of one
        unnamed statement; the messages up to ReadyForQuery."""
        import struct
        self._send(b"P", b"\x00" + sql.encode() + b"\x00"
                   + struct.pack(">H", 0))
        self._send(b"B", b"\x00\x00" + struct.pack(">HHH", 0, 0, 0))
        self._send(b"D", b"P\x00")
        self._send(b"E", b"\x00" + struct.pack(">I", 0))
        self._send(b"S", b"")
        await self.w.drain()
        msgs = await self.read_until(b"Z")
        errs = [p for t, p in msgs if t == b"E"]
        assert not errs, f"pgwire: {sql[:60]!r} answered {errs[0]!r}"
        return msgs

    @staticmethod
    def rows(msgs) -> list:
        import struct
        out = []
        for t, p in msgs:
            if t != b"D":
                continue
            n, at, row = struct.unpack(">H", p[:2])[0], 2, []
            for _ in range(n):
                ln = struct.unpack(">i", p[at:at + 4])[0]
                at += 4
                row.append(None if ln < 0 else p[at:at + ln].decode())
                at += max(ln, 0)
            out.append(tuple(row))
        return out

    async def close(self) -> None:
        self._send(b"X", b"")
        await self.w.drain()
        self.w.close()
        await self.w.wait_closed()


def run_pgwire(dev, events: int) -> dict:
    """sql q4 over the PostgreSQL wire: a ``PgServer`` on
    ``Frontend(device=dev, parallelism=4)`` (sql q4's session) at a
    loopback port; its sources and MV created with the extended protocol,
    the session driven two barriers in flight to every event, the MV read
    back with the extended protocol. The wire's rows equal the session's
    direct ``execute`` of the same SELECT and sql q4's oracle."""
    from risingwave_tpu_torch.frontend import Frontend
    from risingwave_tpu_torch.frontend.pgwire import PgServer

    async def main():
        fe = Frontend(rate_limit=SQL_Q4_RATE, min_chunks=SQL_Q4_RATE,
                      device=dev, parallelism=PGWIRE_P)
        srv = PgServer(fe)
        await srv.serve(port=0)
        try:
            c = await PgClient.connect(srv.port)
            t0 = time.perf_counter()
            done = []
            for t in ("auction", "bid"):
                done += await c.extended(
                    f"CREATE SOURCE {t} WITH (connector='nexmark', "
                    f"nexmark.table.type='{t}', "
                    f"nexmark.event.num={events}, "
                    f"nexmark.max.chunk.size={SQL_Q4_CHUNK}, "
                    f"nexmark.generate.strings='false')")
            done += await c.extended(SQL_Q4)
            create_s = time.perf_counter() - t0
            tags = [p for t, p in done if t == b"C"]
            assert tags == [b"CREATE SOURCE\x00"] * 2 + [
                b"CREATE MATERIALIZED VIEW\x00"], tags
            facts = plan_facts(fe, "q4")
            out = await drive_frontend(
                fe, events * 3 // 50 + events * 46 // 50, dev, False)
            t0 = time.perf_counter()
            msgs = await c.extended("SELECT category, avg_final FROM q4")
            select_s = time.perf_counter() - t0
            direct = await fe.execute("SELECT category, avg_final FROM q4")
            await c.close()
        finally:
            await srv.close()
            await fe.close()
        return out, facts, create_s, select_s, PgClient.rows(msgs), direct

    out, facts, create_s, select_s, wire_rows, direct = asyncio.run(main())
    rows = sorted((int(c), float(v)) for c, v in wire_rows)
    assert rows == sorted((int(c), float(v)) for c, v in direct), \
        "pgwire: the wire's rows differ from the session's"
    want, _facts = q4_oracle(events)
    assert rows == want, "pgwire: the MV differs from sql q4's oracle"
    assert facts["kernels"] == sharded_kernels(PGWIRE_P, aggs=2, joins=1), \
        f"pgwire: sql q4 at parallelism {PGWIRE_P} planned {facts['kernels']}"
    return dict(out, create_s=create_s, select_s=select_s,
                kernels=facts["kernels"], agg_modes=facts["agg_modes"],
                rules=facts["rules"], mv_rows=len(rows),
                mv_digest=mv_digest(rows))


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
        for line in ptxas_figures(kcuda.build_log(name)):
            log(f"  {name}: {line}")

    # 2. the card
    card = card_line()
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", cuda {torch.version.cuda}")

    # 3. kernels against their plain versions
    t_start = time.perf_counter()
    floor = launch_floor_ms(dev)
    log(f"launch floor (advance, 1024 slots, nothing dirty): {floor} ms")
    results = {}
    for name, check in CHECKS.items():
        t0 = time.perf_counter()
        results[name] = check(dev, CAP, N)
        log(f"kernel {name}: " + json.dumps(
            dict(results[name], check_s=time.perf_counter() - t0)))
    chains = check_rebuild_chains(dev)
    for name, r in chains.items():
        log(f"rebuild at {name}: " + json.dumps(r))
    results["live_mask"]["max_abs_err"] = max(
        results["live_mask"]["max_abs_err"],
        max(r["max_abs_err"] for r in chains.values()))
    results["live_mask"]["rebuild_chains"] = {
        k: {x: r[x] for x in ("ms", "bound_ms", "launches_per_call")}
        for k, r in chains.items()}
    t0 = time.perf_counter()
    js = build_join_states(dev)
    log(f"join state at q8's shape: {js['ks'].table.capacity} slots, "
        f"{js['ks'].row_capacity} rows, built in "
        f"{time.perf_counter() - t0:.3f} s")
    for name, check in JOIN_CHECKS.items():
        t0 = time.perf_counter()
        results[name] = check(dev, js)
        log(f"kernel {name}: " + json.dumps(
            dict(results[name], check_s=time.perf_counter() - t0)))
    log("remap (head, q8's growth 2^21 -> 2^22 slots): "
        + json.dumps(check_remap_head(dev, js)))
    # K1 alone at q8's apply shapes, K8 at its keys, K6 by kernel
    log("probe lengths, q8's join table: "
        + json.dumps(probe_lengths(js["ks"].table.state)))
    k1_shapes = {"q7_step": {k: results["probe_insert"][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by")}}
    k1_shapes.update(k1_readings(k1_cases_q8(js)))
    for name, case in k8_cases_q8(js).items():
        k8_q8 = dict(max_abs_err=k8_check(case), ms=k8_time(case))
        k8_q8["bound_ms"], k8_q8["bound_by"] = k8_bound(case)
        log(f"lookup at {name}: " + json.dumps(k8_q8))
    k6 = k6_cases_q8(js)
    for name, which in (("join_probe", "q8"), ("join_probe_deg", "q8_deg")):
        results[name]["split"] = kernel_split(k6[which][0])
    log("join_probe byte bounds (ms) at q8's, the hot-key and the degree "
        "epochs: " + json.dumps({w: fns[2]() for w, fns in k6.items()}))
    del js, k6
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    fused_err = check_fused_random(dev)
    log(f"fused preludes on {FUSED_SEEDS} random programs x {FUSED_ROWS} "
        f"rows (every opcode, edge values): max_abs_err "
        f"{json.dumps(fused_err)} in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    edge_err = check_fused_edges(dev)
    log(f"fused preludes on the tile-edge cases: max_abs_err {edge_err} in "
        f"{time.perf_counter() - t0:.3f} s")
    fused_err = {k: max(v, edge_err) for k, v in fused_err.items()}
    results.update(check_fused_paths(dev, fused_err))
    e, shapes = check_pipeline_preludes(dev)
    results["agg_prelude"]["max_abs_err"] = max(
        results["agg_prelude"]["max_abs_err"], e)
    results["agg_prelude"]["pipeline_shapes"] = shapes
    for name in ("fused_chain", "agg_prelude", "join_prelude"):
        log(f"kernel {name}: " + json.dumps(results[name]))
    torch.cuda.empty_cache()

    results["route"] = check_route(dev)
    log("kernel route: " + json.dumps(results["route"]))
    log("route split at q7-mesh's step (ms a call, by kernel): "
        + json.dumps(results["route"]["split"]))
    t0 = time.perf_counter()
    sharded = check_sharded(dev)
    log(f"sharded K1-K4 at {MESH_SHARDS} shards x {MESH_CAP} slots (q7 "
        f"plan and the mixed plan over {MESH_GROUPS} groups) match their "
        f"plain versions: max_abs_err {sharded['max_abs_err']} in "
        f"{time.perf_counter() - t0:.3f} s")
    for name, t in sharded["timings"].items():
        log(f"sharded {name} at q7's routed step: " + json.dumps(t))
    k1_shapes["q7_mesh_step"] = sharded["timings"]["probe_insert"]
    results["flush_gather"]["sharded"] = sharded["timings"]["flush_gather"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mj = build_mesh_join_states(dev)
    results["route"]["q8_mesh_shape"] = check_route_q8(dev, mj)
    log("route at q8-mesh's side-epoch: "
        + json.dumps(results["route"]["q8_mesh_shape"]))
    mesh_join = {"join_apply": check_mesh_join_apply(dev, mj),
                 "join_probe": check_mesh_join_probe(dev, mj)}
    log(f"probe lengths, q8-mesh's join tables ({MESH_SHARDS} shards): "
        + json.dumps(probe_lengths(mj["ks"].table)))
    k1_shapes.update(k1_readings(k1_cases_mesh(mj)))
    mesh_join["join_probe"]["split"] = kernel_split(
        k6_cases_mesh(mj)["q8_mesh"][0])
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

    for name in ("flush_gather", "fused_chain", "agg_prelude",
                 "join_prelude"):
        results[name]["launch_floor_ms"] = floor
    for name, r in k1_shapes.items():
        log(f"probe_insert at {name}: " + json.dumps(r))

    log(f"phase 3: {time.perf_counter() - t_start:.1f} s")

    # 4. the main paths end to end, the plan checker strict
    t_phase = time.perf_counter()
    from risingwave_tpu_torch.frontend.opt import set_strict_checker
    from risingwave_tpu_torch.ops import hash_join as J
    set_strict_checker(True)
    # a read of the degree array to the host counts here: no path makes
    # one (compaction carries degrees on the card, recovery and reloads
    # write K6's degree column)
    degree_reads = []
    host_read = J.JoinSideKernel.read_degrees
    J.JoinSideKernel.read_degrees = \
        lambda self, refs: degree_reads.append(len(refs)) or \
        host_read(self, refs)
    paths = {}
    for label, run, events, path in (
            ("q7", run_q7, Q7_EVENTS, Q7_PATH),
            ("q8", run_q8, Q8_EVENTS, Q8_PATH),
            ("q7 fused", lambda d, e: run_q7(d, e, fusion=True), Q7_EVENTS,
             Q7_FUSED_PATH),
            ("q7 coalesced", lambda d, e: run_q7(d, e, coalesce=True),
             Q7_COALESCED_EVENTS, Q7_PATH),
            ("q8 fused", lambda d, e: run_q8(d, e, fusion=True),
             Q8_FUSED_EVENTS, Q8_FUSED_PATH),
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
                                                  mesh=True),
             Q8_FUSED_EVENTS, Q8_MESH_FUSED_PATH),
            ("q8 mesh per-chunk", lambda d, e: run_join_perchunk(d), 0,
             PERCHUNK_PATH),
            ("maxbids", run_maxbids, MAXBIDS_EVENTS, MAXBIDS_PATH),
            ("maxbids capped", lambda d, e: run_maxbids(
                d, e, tier_cap=MAXBIDS_TIER_CAP), MAXBIDS_CAPPED_EVENTS,
             MAXBIDS_CAPPED_PATH),
            ("distinct", run_distinct, DISTINCT_EVENTS, DISTINCT_PATH),
            ("q7 tier", lambda d, e: run_q7(d, e, tier_cap=Q7_TIER_CAP),
             Q7_TIER_EVENTS, Q7_TIER_PATH),
            ("q8 outer", run_q8_outer, Q8_OUTER_EVENTS, Q8_OUTER_PATH),
            ("q8 outer mesh", lambda d, e: run_q8_outer(d, e, mesh=True),
             Q8_OUTER_MESH_EVENTS, Q8_OUTER_MESH_PATH),
            ("q8 outer capped", lambda d, e: run_q8_outer(
                d, e, state_cap=Q8_OUTER_CAP), Q8_OUTER_CAPPED_EVENTS,
             Q8_OUTER_CAPPED_PATH),
            ("q8 outer recovery", run_q8_outer_recovery,
             Q8_OUTER_RECOVERY_EVENTS, Q8_OUTER_RECOVERY_PATH),
            ("join modes", lambda d, e: run_join_modes(d), 0,
             JOIN_MODES_PATH),
            ("q5 hot", lambda d, e: run_q5_hot(d, e, batch=True),
             Q5_EVENTS, Q5_PATH),
            ("q5 hot fused", lambda d, e: run_q5_hot(d, e, fusion=True),
             Q5_EVENTS, Q5_FUSED_PATH),
            ("q5 hot capped", lambda d, e: run_q5_hot(
                d, e, tier_cap=Q5_TIER_CAP), Q5_EVENTS, Q5_CAPPED_PATH),
            ("q3", lambda d, e: run_q3(d, *Q3_SF1), 0, Q3_PATH),
            ("q3 fused", lambda d, e: run_q3(d, *Q3_SF01, fusion=True), 0,
             Q3_FUSED_PATH),
            ("sql q4", run_sql_q4, SQL_Q4_EVENTS, SQL_PATH),
            ("sql q4 bare", lambda d, e: run_sql_q4(d, e, bare=True),
             SQL_Q4_EVENTS, SQL_PATH),
            ("sql q3", lambda d, e: run_sql_q3(d, *Q3_SF01), 0, SQL_PATH),
            ("sql adctr", run_sql_adctr, ADCTR_IMPRESSIONS, ADCTR_PATH),
            ("sql mv chain", run_sql_mv_chain, CHAIN_EVENTS, CHAIN_PATH),
            ("sql adctr p4", lambda d, e: run_sql_adctr(
                d, e, parallelism=ADCTR_P4), ADCTR_IMPRESSIONS,
             ADCTR_P4_PATH),
            ("sql alter", run_sql_alter, ALTER_EVENTS, ALTER_PATH),
            ("pgwire", run_pgwire, PGWIRE_EVENTS, PGWIRE_PATH)):
        t_path = time.perf_counter()
        out = run(dev, events)
        out["path_s"] = time.perf_counter() - t_path
        paths[label] = out
        missing = [k for k in path if out["launches"].get(k, 0) == 0]
        assert not missing, f"{label} never launched {missing}"
        extra = [k for k in OFF_PATH.get(label, ())
                 if out["launches"].get(k, 0)]
        assert not extra, f"{label} launched {extra}"
        k7 = out["launches"].get("masked_scatter", 0)
        assert k7 == K7_PATH_LAUNCHES.get(label, 0), \
            f"{label} launched masked_scatter {k7} times"
        # per launch: K2's count is of its launches, its time of a call
        busy_ms = sum(n * results[k]["ms"]
                      / results[k].get("launches_per_call", 1)
                      for k, n in out["launches"].items() if k in results)
        log(f"{label}: " + json.dumps(out))
        log(f"{label}: kernel busy estimate (launches x phase-3 medians) "
            f"{busy_ms:.3f} ms of {out['elapsed_s'] * 1e3:.3f} ms timed "
            f"wall")
    for q in ("q7", "q1"):
        assert paths[q]["mv_digest"] == paths[f"{q} fused"]["mv_digest"], \
            f"{q}: the fused MV differs from the unfused one"
        a, b = paths[q], paths[f"{q} fused"]
        log(f"{q} fused vs unfused: events/s {b['events_per_s']} vs "
            f"{a['events_per_s']}, p99 barrier latency "
            f"{b['p99_barrier_latency_s']} vs {a['p99_barrier_latency_s']}")
    c = paths["q7 coalesced"]
    assert c["mv_digest"] == Q7_2M_DIGEST, \
        f"q7 coalesced: MV digest {c['mv_digest']}, not {Q7_2M_DIGEST}"
    log(f"q7 coalesced ({Q7_COALESCED_EVENTS} events, "
        f"{Q7_COALESCE_CHUNK}-row chunks to {Q7_COALESCE_ROWS}): chunks in "
        f"{c['coalesce_chunks_in']}, out {c['coalesce_chunks_out']}, agg "
        f"steps {c['agg_steps']}, probe_insert "
        f"{c['launches'].get('probe_insert', 0)}, agg_apply "
        f"{c['launches'].get('agg_apply', 0)}, device_dispatch "
        f"{c['device_dispatch']}, events/s {c['events_per_s']}, path_s "
        f"{c['path_s']}")
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
    assert Q8_OUTER_CAPPED_EVENTS == Q8_OUTER_RECOVERY_EVENTS
    assert paths["q8 outer capped"]["mv_digest"] == \
        paths["q8 outer recovery"]["mv_digest"], \
        "q8-outer under the tier differs from its recovered run"
    assert Q8_OUTER_EVENTS == Q8_OUTER_MESH_EVENTS
    assert paths["q8 outer"]["mv_digest"] == \
        paths["q8 outer mesh"]["mv_digest"], \
        "q8-outer over 8 shards differs from the one-device q8-outer"
    o, q = paths["q8 outer"], paths["q8"]
    log(f"q8 outer ({Q8_OUTER_EVENTS} events) vs q8 ({Q8_EVENTS} events), "
        f"one device: events/s {o['events_per_s']} vs {q['events_per_s']}, "
        f"p99 barrier latency {o['p99_barrier_latency_s']} vs "
        f"{q['p99_barrier_latency_s']}; MV rows {o['mv_rows']} "
        f"({o['padded_rows']} padded) vs {q['mv_rows']}")
    assert paths["q8 mesh"]["mv_digest"] == paths["q8"]["mv_digest"], \
        "q8 mesh: the MV differs from the single-device q8's"
    for label in ("q8 mesh", "q8 mesh fused"):
        # the fused mesh MV is held to phase 5's q8 trace at its size
        m, one = paths[label], paths[label.replace(" mesh", "")]
        log(f"{label}: {MESH_SHARDS} shards vs one device: events/s "
            f"{m['events_per_s']} vs {one['events_per_s']}, p99 barrier "
            f"latency {m['p99_barrier_latency_s']} vs "
            f"{one['p99_barrier_latency_s']}; per barrier "
            + json.dumps(m["per_barrier"]))

    assert paths["sql q3"]["mv_digest"] == paths["q3 fused"]["mv_digest"], \
        "sql q3: the MV differs from build_q3's at the same size"
    for label in ("sql q4", "sql q3", "sql adctr"):
        r = paths[label]
        log(f"{label}: events/s {r['events_per_s']}, p99 barrier latency "
            f"{r['p99_barrier_latency_s']} s, CREATE {r['create_s']} s "
            f"(planning + rewrite {r['plan_s']} s), rules "
            f"{r['rules']}, aggs {r['agg_modes']}, launches "
            + json.dumps(r["launches"]) + f"; {card}")
    a, b = paths["sql q4"], paths["sql q4 bare"]
    assert a["mv_digest"] == b["mv_digest"] and \
        a["launches"] == b["launches"], \
        "sql q4: the MV or its launches differ without the dispatcher"
    log(f"sql q4 with its empty broadcast dispatcher vs without: events/s "
        f"{a['events_per_s']} vs {b['events_per_s']}, p99 barrier latency "
        f"{a['p99_barrier_latency_s']} vs {b['p99_barrier_latency_s']}")
    r = paths["sql adctr"]
    log(f"sql adctr ({ADCTR_IMPRESSIONS} impressions, {ADCTR_ADS} ads, "
        f"parallelism 1): {r['mv_rows']} (ad, window) rows equal the "
        f"oracle, ad_dim saw {r['ad_dim_seen']}; produce {r['produce_s']} "
        f"s; {card}")
    r = paths["sql mv chain"]
    log(f"sql mv chain ({CHAIN_EVENTS} events): m1 alone events/s "
        f"{r['events_per_s_m1_alone']} (p99 "
        f"{r['p99_barrier_latency_s_m1_alone']} s), with m2 backfilling "
        f"and following {r['events_per_s_with_m2']} (p99 "
        f"{r['p99_barrier_latency_s_with_m2']} s); m2's backfill "
        f"{r['m2_backfill_rows']} rows in {r['m2_backfill_slices']} slices, "
        f"{r['m2_backfill_s']} s from CREATE; the table step "
        + json.dumps(r["table"]) + f"; aggs {r['agg_modes']}, launches "
        + json.dumps(r["launches"]) + f"; {card}")

    a, p4 = paths["sql adctr"], paths["sql adctr p4"]
    assert p4["mv_digest"] == a["mv_digest"], \
        "sql adctr p4: the MV differs from parallelism 1's"
    log(f"sql adctr at parallelism {ADCTR_P4} vs 1 ({ADCTR_IMPRESSIONS} "
        f"impressions): events/s {p4['events_per_s']} vs "
        f"{a['events_per_s']}, p99 barrier latency "
        f"{p4['p99_barrier_latency_s']} vs {a['p99_barrier_latency_s']} s; "
        f"kernels {p4['kernels']}; launches " + json.dumps(p4["launches"])
        + f"; {card}")
    r = paths["sql alter"]
    log(f"sql alter ({ALTER_EVENTS} events, 1 -> {ALTER_SHARDS} -> 1): "
        f"ALTERs " + json.dumps(r["alters"]) + f"; events/s by drive "
        f"{r['events_per_s_by_drive']} (p99 {r['p99_by_drive']}) against "
        f"the uninterrupted run's {r['uninterrupted_events_per_s']} (p99 "
        f"{r['uninterrupted_p99_s']}); digest {r['mv_digest']}; {card}")
    r = paths["pgwire"]
    log(f"pgwire (sql q4 at {PGWIRE_EVENTS} events, parallelism "
        f"{PGWIRE_P}, the extended protocol on a loopback socket): "
        f"events/s {r['events_per_s']}, p99 barrier latency "
        f"{r['p99_barrier_latency_s']} s, CREATE {r['create_s']} s, the "
        f"SELECT over the wire {r['select_s']} s; {r['mv_rows']} rows equal "
        f"the session's and the oracle; kernels {r['kernels']}; {card}")

    J.JoinSideKernel.read_degrees = host_read
    assert not degree_reads, \
        f"phase 4 read degrees to the host {len(degree_reads)} times"
    log(f"phase 4: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # 5. where the time goes: shorter traced runs (their launches are not
    # the main paths' and are not reported)
    q7_traced = run_q7(dev, Q7_TRACE_EVENTS, trace=True)
    log("q7 traced: " + json.dumps(q7_traced))
    assert q7_traced["mv_digest"] == paths["q7 coalesced"]["mv_digest"], \
        "q7 coalesced differs from the uncoalesced q7 at its size"
    assert Q7_TRACE_EVENTS == Q7_TIER_EVENTS
    assert paths["q7 tier"]["mv_digest"] == q7_traced["mv_digest"], \
        "q7 under the tier differs from the uncapped q7"
    log("q7 fused traced: " + json.dumps(run_q7(dev, Q7_TRACE_EVENTS,
                                                trace=True, fusion=True)))
    for events in Q8_TRACE_EVENTS:
        q8_traced = run_q8(dev, events, trace=True)
        log(f"q8 traced at {events} events: " + json.dumps(q8_traced))
    assert Q8_TRACE_EVENTS[-1] == Q8_FUSED_EVENTS
    for label in ("q8 fused", "q8 mesh fused"):
        assert paths[label]["mv_digest"] == q8_traced["mv_digest"], \
            f"{label}: the MV differs from the single-device q8's"
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

    q8o_traced = run_q8_outer(dev, Q8_OUTER_TRACE_EVENTS, trace=True)
    log(f"q8 outer traced at {Q8_OUTER_TRACE_EVENTS} events: "
        + json.dumps(q8o_traced))
    # where the cold tier's time goes (its compactions carry degrees on
    # the card: no read_degrees)
    log(f"q8 outer capped traced at {Q8_OUTER_TRACE_EVENTS} events: "
        + json.dumps(run_q8_outer(dev, Q8_OUTER_TRACE_EVENTS, trace=True,
                                  state_cap=Q8_OUTER_CAP)))
    assert Q8_OUTER_TRACE_EVENTS == Q8_OUTER_CAPPED_EVENTS
    assert q8o_traced["mv_digest"] == paths["q8 outer capped"]["mv_digest"], \
        "q8-outer under the tier differs from the uncapped q8-outer"
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

    q5_traced = run_q5_hot(dev, Q5_EVENTS, trace=True)
    log(f"q5 hot traced at {Q5_EVENTS} events: " + json.dumps(q5_traced))
    for label in ("q5 hot fused", "q5 hot capped"):
        assert paths[label]["mv_digest"] == q5_traced["mv_digest"] \
            == paths["q5 hot"]["mv_digest"], \
            f"{label}: the MV differs from the unfused q5-hot's"
    q3_traced = run_q3(dev, *Q3_SF01, trace=True)
    log(f"q3 traced at {Q3_SF01[0]} customers, {Q3_SF01[1]} orders: "
        + json.dumps(q3_traced))
    assert paths["q3 fused"]["mv_digest"] == q3_traced["mv_digest"], \
        "q3 fused: the MV differs from the unfused q3's"
    log(f"sql q4 traced at {SQL_Q4_TRACE_EVENTS} events: "
        + json.dumps(run_sql_q4(dev, SQL_Q4_TRACE_EVENTS, trace=True)))
    log(f"sql adctr traced at {ADCTR_TRACE_IMPRESSIONS} impressions: "
        + json.dumps(run_sql_adctr(dev, ADCTR_TRACE_IMPRESSIONS,
                                   trace=True)))
    log(f"phase 5: {time.perf_counter() - t_phase:.1f} s")
    assert "jax" not in sys.modules, "the smoke run imported JAX"

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        row = {"name": name, "status": "ported, matches plain",
               "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(p["launches"].get(name, 0)
                               for p in paths.values()),
               "launches_by_arm": {label: p["launches"][name]
                                   for label, p in paths.items()
                                   if p["launches"].get(name, 0)},
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"],
               "library_ms": r.get("library_ms")}
        for extra in ("capped_shape", "sharded", "epoch_apply",
                      "launches_per_call", "mixed_shape", "maxbids_shape",
                      "q8_mesh_shape", "split", "n_dirty",
                      "launch_floor_ms", "hot_key_shape", "mesh_shape",
                      "path_shapes", "path_loss_ms", "rebuild_payload",
                      "q3_shape", "pipeline_shapes"):
            if extra in r:
                row[extra] = r[extra]
        if name == "live_mask":
            row["evict_mode"] = cold["evict_mode"]
            row["evict_state"] = cold["evict_state"]
        if name == "scatter_rows":
            row["load_groups"] = cold["load_groups"]
            row["reload_shapes"] = r["reload_shapes"]
            row["sector_ms"] = r["sector_ms"]
        if name == "live_mask":
            row["mask_only"] = r["mask_only"]
            row["rebuild_chains"] = r["rebuild_chains"]
        if name == "agg_apply":
            row["none_kind"] = cold["none_kind"]
        if name == "probe_insert":
            # K1 alone at each shape of its paths (phase 3's readings)
            row["shapes"] = k1_shapes
        if name == "lookup":
            row["q8_shape"] = k8_q8
        if name == "join_probe":
            row["per_chunk_split"] = step["join_probe_split"]
        if name in mesh_join:
            # the shard axis (B24) at q8-mesh's side-epoch
            m = mesh_join[name]
            row["max_abs_err"] = max(row["max_abs_err"], m["max_abs_err"])
            row["sharded"] = {k: m[k] for k in ("ms", "plain_ms",
                                                "bound_ms", "bound_by",
                                                "split") if k in m}
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


# -- K1, K8 and K6 at the shapes their paths give them ---------------------------

def time_fresh(reset, fn, samples: int = SAMPLES) -> float:
    """Device time of one fn call on state that reset() makes anew before
    each call (a copy of a table as it stood before a side-epoch), with
    the L2 cache flushed after the reset, so that fn meets the table
    cold, as a side-epoch's apply does: the median over `samples` calls,
    each timed alone with CUDA events (two untimed calls first) and queued
    behind a device sleep, so the host's wrapper time stays out."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")
    times = []
    for i in range(samples + 2):
        reset()
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES // 4)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        if i >= 2:
            times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def probe_lengths(table) -> dict:
    """How far a probe walks in a table (keys [(S,) cap, K], occ [(S,)
    cap]), over every shard: the load, the mean and largest number of
    slots from a stored key's home slot to its slot, and the mean number
    from a stored key's home slot to the first empty slot (what a fresh
    key homed there walks)."""
    from risingwave_tpu_torch.common.hash import hash_lanes_plain
    keys, occ = table
    if keys.dim() == 2:
        keys, occ = keys[None], occ[None]
    cap = occ.shape[1]
    to_key, to_empty = [], []
    for s in range(keys.shape[0]):
        o = occ[s] != 0
        slot = torch.nonzero(o).flatten()
        home = hash_lanes_plain(keys[s][slot]).to(torch.int64) & (cap - 1)
        to_key.append((slot - home) & (cap - 1))
        empty = torch.nonzero(~o).flatten()
        i = torch.searchsorted(empty, home)
        nxt = torch.where(i < len(empty),
                          empty[i.clamp(max=len(empty) - 1)], empty[0] + cap)
        to_empty.append(nxt - home)
    k, e = torch.cat(to_key).double(), torch.cat(to_empty).double()
    return dict(load=float((occ != 0).double().mean()),
                slots_to_key=float(k.mean()) + 1,
                slots_to_key_max=int(k.max()) + 1,
                slots_to_empty=float(e.mean()) + 1)


def _table_copy(t):
    from risingwave_tpu_torch.ops import hash_table as ht
    return ht.TableState(t.keys.clone(), t.occ.clone())


def k1_call(table, keys, valid):
    """K1 through the port's wrapper: [S, ...] table, keys and valid."""
    from risingwave_tpu_torch.ops import hash_table as ht
    return ht.probe_insert_sharded(table, keys, valid)


def k1_cases_q7(dev) -> dict:
    """K1 at q7's step (2^15 rows on one or two windows, 2^18 slots, 3
    lanes; keys placed) and at q7-mesh's routed step (the same batch
    routed to 8 shards of 2^15 slots: 8 x 32,768 received rows, 1/8 of
    them valid; placed). A case is (base, keys, valid, fresh): the table
    before the batch and the batch, with a leading shard axis (S = 1 on
    one device); a case that is not fresh is timed with its keys already
    placed, a fresh one on a copy of base made anew before each call."""
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.parallel import exchange as X
    from risingwave_tpu_torch.parallel.mesh import contiguous_owner_map
    specs = make_specs(H, [("max", np.int64), ("count", None)])
    p = torch.from_numpy(q7_batch(N, specs)).to(dev)
    t1 = ht.make_state(CAP, KW, dev)
    out = {"q7_step": (ht.TableState(t1.keys[None], t1.occ[None]),
                       p[None, :, :KW], p[None, :, KW + 1], False)}
    s = MESH_SHARDS
    omap = torch.from_numpy(contiguous_owner_map(s)).to(dev)
    recv, rvalid, _o = X.route(p, p[:, KW + 1], omap, s, N // s, KW)
    tm = ht.TableState(
        torch.zeros((s, MESH_CAP, KW), dtype=torch.int32, device=dev),
        torch.zeros((s, MESH_CAP), dtype=torch.int32, device=dev))
    out["q7_mesh_step"] = (tm, recv[:, :, :KW], rvalid, False)
    return out


def k1_cases_q8(js: dict) -> dict:
    """K1 at q8's side-epoch apply: 2^16 new persons (6 lanes) into the
    ~2M-key table of build_join_states (2^22 slots), with the keys placed
    (q8_apply) and fresh (q8_fresh)."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import hash_table as ht
    t = js["ks"].table.state
    base = ht.TableState(t.keys.clone()[None], t.occ.clone()[None])
    up, aux = js["fresh"]
    ins = (aux[:, J.AUX_FLAGS] & J.FLAG_INS)[None]
    return {"q8_apply": (base, up[None, :, :JKW], ins, False),
            "q8_fresh": (base, up[None, :, :JKW], ins, True)}


def k1_cases_mesh(mj: dict) -> dict:
    """K1 at q8-mesh's side-epoch apply: the fresh epoch of 2^16 new
    persons routed to the 8 shards of build_mesh_join_states (fresh)."""
    from risingwave_tpu_torch.ops import hash_join as J
    ks = mj["ks"]
    recv, _rv, _b = _mesh_routed(ks, *mj["fresh"], J.FLAG_INS | J.FLAG_DEL,
                                 probe=False)
    return {"q8_mesh_apply": (_table_copy(ks.table), recv[:, :, :JKW],
                              recv[:, :, JKW + 2] & J.FLAG_INS, True)}


def k1_check(case, call=k1_call) -> tuple:
    """K1 through `call` on a copy of the case's base against the plain
    version on another: stats exact and no overflow, invalid rows -1,
    each valid row's slot occupied and holding its key, equal keys on one
    slot, the slots occupied before unchanged, and the same keys newly
    inserted. Returns (largest gap: 0, byte bound of the call)."""
    from risingwave_tpu_torch.ops import hash_table as ht
    base, keys, valid, _f = case
    tk, tp = _table_copy(base), _table_copy(base)
    slots, stats = call(tk, keys, valid)
    _ps, pstats = ht.probe_insert_sharded_plain(tp, keys, valid)
    err = abs_err(stats.cpu().numpy(), pstats.cpu().numpy())
    assert err == 0 and not bool(stats[:, 1].any()), (stats, pstats)
    s_, k_ = keys.shape[0], keys.shape[2]
    n_valid = distinct = 0
    for d in range(s_):
        sl = slots[d].cpu().numpy()
        v = valid[d].cpu().numpy() != 0
        kk = keys[d].cpu().numpy()
        tkk, tko = tk.keys[d].cpu().numpy(), tk.occ[d].cpu().numpy()
        b_occ = base.occ[d].cpu().numpy() != 0
        assert (sl[~v] == -1).all() and (sl[v] >= 0).all()
        err = max(err, abs_err(tkk[sl[v]], kk[v]))
        assert err == 0 and (tko[sl[v]] == 1).all(), "a slot lost its key"
        if v.any():
            _u, inv = np.unique(kk[v], axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            first = np.full(inv.max() + 1, -1)
            first[inv[::-1]] = sl[v][::-1]
            assert (first[inv] == sl[v]).all(), "equal keys on two slots"
        assert (tkk[b_occ] == base.keys[d].cpu().numpy()[b_occ]).all() and \
            (tko[b_occ] == 1).all(), "an occupied slot changed"
        assert set(np.unique(tko).tolist()) <= {0, 1}

        def new_keys(t):
            o = t.occ[d].cpu().numpy() != 0
            x = t.keys[d].cpu().numpy()[o & ~b_occ]
            return x[np.lexsort(x.T[::-1])]
        err = max(err, abs_err(new_keys(tk), new_keys(tp)))
        assert err == 0, "the tables gained different keys"
        n_valid += int(v.sum())
        distinct += len(np.unique(sl[v]))
    rows = valid.numel()
    inserted = int(stats[:, 0].sum())
    nbytes = (rows * 4 + n_valid * k_ * 4 + rows * 4 + distinct * (k_ + 1)
              * 4 + inserted * (k_ + 1) * 4 + s_ * 8)
    return err, bound_ms(nbytes, n_valid * 14 * k_)


def k1_time(case, call=k1_call, samples: int = SAMPLES,
            per: int = PER_SAMPLE) -> float:
    """µs-scale device time of one K1 call at the case's shape: keys
    placed (back to back, ``time_ms``) or fresh (``time_fresh``)."""
    base, keys, valid, fresh = case
    t = _table_copy(base)
    if not fresh:
        call(t, keys, valid)
        return time_ms(lambda: call(t, keys, valid), samples, per)

    def reset():
        t.keys.copy_(base.keys)
        t.occ.copy_(base.occ)
    return time_fresh(reset, lambda: call(t, keys, valid), samples)


def k1_readings(cases: dict) -> dict:
    """Each K1 case checked against the plain version, then timed beside
    the plain version and its byte bound."""
    from risingwave_tpu_torch.ops import hash_table as ht
    out = {}
    for name, case in cases.items():
        err, (b, by) = k1_check(case)
        out[name] = dict(
            max_abs_err=err, ms=k1_time(case),
            plain_ms=k1_time(case, ht.probe_insert_sharded_plain, 3, 1),
            bound_ms=b, bound_by=by, rows=int(case[2].numel()))
    return out


def k8_call(table, keys, valid, dropped=None):
    from risingwave_tpu_torch.ops import hash_table as ht
    return ht.lookup(table, keys, valid, dropped)


def k8_cases_q8(js: dict) -> dict:
    """K8 (lookup) at q8's side-epoch: the 2^16 persons of the fresh epoch
    looked up in the table after K1 placed them (the read-only twin of
    K1's q8_apply case)."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import hash_table as ht
    t = _table_copy(js["ks"].table.state)
    up, aux = js["fresh"]
    ins = aux[:, J.AUX_FLAGS] & J.FLAG_INS
    ht.probe_insert(t, up[:, :JKW], ins)
    return {"q8_placed": (t, up[:, :JKW], ins, None)}


def k8_cases_cold(dev) -> dict:
    """K8 at B9's shape: 2^16 keys (7/8 resident) off 600K groups in 2^20
    slots, with the eviction mask."""
    _specs, st, keys = _cold_state(dev, COLD_CAP, COLD_GROUPS)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(_evict_query(rng, keys, COLD_KEYS)).to(dev)
    v = torch.ones(COLD_KEYS, dtype=torch.int32, device=dev)
    return {"evict_2^16": (st.table, q, v,
                           torch.zeros(COLD_CAP, dtype=torch.int32,
                                       device=dev))}


def k8_check(case, call=k8_call) -> float:
    """K8 through `call` against lookup_plain: slots, stats and the
    dropped mask exact."""
    from risingwave_tpu_torch.ops import hash_table as ht
    table, q, v, dropped = case
    dk = None if dropped is None else torch.zeros_like(dropped)
    dp = None if dropped is None else torch.zeros_like(dropped)
    got, want = call(table, q, v, dk), ht.lookup_plain(table, q, v, dp)
    err = max(abs_err(a.cpu().numpy(), b.cpu().numpy())
              for a, b in zip(got, want))
    if dropped is not None:
        err = max(err, abs_err(dk.cpu().numpy(), dp.cpu().numpy()))
    assert err == 0 and int(got[1][1]) == 0, f"lookup differs: {err}"
    return err


def k8_bound(case) -> tuple:
    """K8's byte bound: each key its lanes and valid flag read and its
    slot written, each found key the table's lanes, occupancy and slot
    at its slot, each absent one the empty slot's occupancy."""
    from risingwave_tpu_torch.ops import hash_table as ht
    table, q, v, _dropped = case
    n, k = q.shape
    slots, _s = ht.lookup_plain(table, q, v)
    valid = int((v != 0).sum())
    found = int((slots >= 0).sum())
    nbytes = n * (k * 4 + 4 + 4) + found * (k * 4 + 4 + 4) \
        + (valid - found) * 4
    return bound_ms(nbytes, valid * 12 * k)


def k8_time(case, call=k8_call) -> float:
    table, q, v, dropped = case
    return time_ms(lambda: call(table, q, v, dropped))


def k6_cases_q8(js: dict) -> dict:
    """K6 at q8's probe side-epoch (2^16 rows, ~19.6K pairs, 2^16-row pair
    buffer), at the hot-key epoch (chains of ~400 refs, ~540K pairs) and
    with degrees (random degree arrays): name -> (kernel call, plain
    call), both through the port's wrappers."""
    rng = np.random.default_rng(5)
    rows = js["ks"].row_capacity
    dev = js["ks"].table.state.keys.device
    degs = tuple(torch.from_numpy(rng.integers(0, 4, rows).astype(np.int32))
                 .to(dev) for _ in range(2))
    out = {"q8": _probe_fns(js, "probe", OUT_CAP, False),
           "q8_hot": _probe_fns(js, "probe_hot", OUT_CAP, False),
           "q8_deg": _probe_fns(js, "probe", OUT_CAP, True, degs)}
    for name, which, deg in (("q8", "probe", False),
                             ("q8_hot", "probe_hot", False),
                             ("q8_deg", "probe", True)):
        k = out[name][0]
        out[name] = out[name] + (
            lambda k=k, which=which, deg=deg: bound_ms(
                _probe_bytes(js, k()[0], deg, rows, which), js["n"] * 64),)
    return out


def k6_sharded_bound(rv, mats, kw: int, with_degrees: bool) -> tuple:
    """Sharded K6's byte bound on one receive block (rvalid [S, m], the
    kernel's matrices [S, 1 + cap, W]): every received row its flag, each
    probe row its key lanes, sequence and row id and the table's lanes,
    occupancy and head at its slot, each pair its chain entry (next,
    ins_seq, del_seq) and its two-word write, each shard's header; with
    degrees, each probe row its degree written and each pair the build
    side's degree updated (read and written)."""
    s, m = rv.shape
    valid = int(rv.sum())
    total = int(mats[:, 0, 0].sum())
    nbytes = (s * m * 4 + valid * (kw * 4 + 4 + 4 + kw * 4 + 4 + 4)
              + total * 12 + s * 2 * 4 + total * 2 * 4)
    if with_degrees:
        nbytes += valid * 4 + total * 8
    return bound_ms(nbytes, valid * 64)


def k6_cases_mesh(mj: dict) -> dict:
    """K6 with a shard axis at q8-mesh's probe side-epoch: the probe epoch
    routed to 8 shards (8 x 16,384 received rows, 2^16 of them real), at
    the kernel's per-shard pair buffer."""
    from risingwave_tpu_torch.ops import hash_join as J
    ks = mj["ks"]
    recv, rv, _b = _mesh_routed(ks, *mj["probe"], J.FLAG_PROBE, probe=True)
    args = (recv[:, :, :JKW], rv, -1, recv[:, :, JKW + 1], ks.probe_capacity,
            False)
    kw = dict(rid=recv[:, :, JKW], rvalid=rv)

    def k():
        return J.join_probe_sharded(ks.table, ks.chains, *args, **kw)
    return {"q8_mesh": (
        k, lambda: J.join_probe_sharded_plain(ks.table, ks.chains, *args,
                                              **kw),
        lambda: k6_sharded_bound(rv, k()[0], JKW, False))}


def k6_cases_perchunk(pc: dict) -> dict:
    """K6 in the per-chunk step B16: the last recorded chunk's rows routed
    to 8 shards (8 x 4,096 received rows), probing the other side at the
    chunk's scalar seq with the degree block and the rid/rvalid map."""
    from risingwave_tpu_torch.ops import hash_join as J
    k, recv, rv = pc["other"], pc["recv"], pc["rvalid"]
    kw = pc["kw"]
    args = (recv[:, :, :kw], recv[:, :, kw + 3], J.FLAG_PROBE, pc["seq"],
            pc["out_cap"], True)
    rid = dict(rid=recv[:, :, kw], rvalid=rv)

    def kern():
        return J.join_probe_sharded(k.table, k.chains, *args, **rid)
    return {"per_chunk": (
        kern, lambda: J.join_probe_sharded_plain(k.table, k.chains, *args,
                                                 **rid),
        lambda: k6_sharded_bound(rv, kern()[0], kw, True))}


def k6_check(fns) -> float:
    """Every output of the kernel call equal to the plain call's."""
    got, want = fns[0](), fns[1]()
    err = 0.0
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            err = max(err, abs_err(a.cpu().numpy(), b.cpu().numpy()))
    assert err == 0, f"join_probe differs from its plain version: {err}"
    return err


def replay_perchunk(dev, steps) -> dict:
    """The per-chunk arm's recorded steps replayed through the kernels on
    a fresh pair of ShardedJoinKernel; returns the last step's K6 inputs
    (the other side, its routed receive block, seq and pair buffer)."""
    from risingwave_tpu_torch.parallel import ShardedJoinKernel, ShardMesh
    mesh = ShardMesh(MESH_SHARDS, dev)
    kw = steps[0][1][0].shape[1]
    ks = [ShardedJoinKernel(mesh, kw) for _ in range(2)]
    for me, args in steps:
        ks[me].apply_and_probe(ks[1 - me], *args).collect()
    return perchunk_probe_input(ks, steps)


def perchunk_probe_input(ks, steps) -> dict:
    """The last step's K6 inputs on sides `ks` (after every step)."""
    me, args = steps[-1]
    lanes, pvis, refs, ins, drefs, dels, seq = args
    kc = _kernel_copy(ks[me])
    kw = ks[me].key_width
    rows = kc._stage_chunk(lanes, pvis, refs, ins, drefs, dels)[0]
    m, s = int(rows.shape[0]), ks[me].n_dev
    recv, rvalid, _o = kc._route(rows, rows[:, kw + 3] != 0, m // s)
    return dict(other=ks[1 - me], me=kc, recv=recv, rvalid=rvalid,
                seq=seq, out_cap=ks[1 - me].probe_capacity, kw=kw)


# -- --against DIR: this checkout's kernels against another's -------------------

def _other_lib(csrc: str, name: str, argtypes: dict):
    """Library `name` built by nvcc from another checkout's ``csrc/`` with
    this checkout's flags (into build/kernels/, beside this checkout's
    own) and bound with `argtypes` (entry point -> argument types)."""
    import ctypes
    import hashlib
    import os
    from risingwave_tpu_torch.ops import cuda as kcuda
    os.makedirs(kcuda.BUILD_DIR, exist_ok=True)
    # one file a source: a path dlopen has loaded is not loaded again
    with open(os.path.join(csrc, f"{name}.cu"), "rb") as f:
        tag = hashlib.sha256(os.path.abspath(csrc).encode() + f.read())
    out = os.path.join(kcuda.BUILD_DIR,
                       f"against-{name}-{tag.hexdigest()[:12]}.so")
    r = subprocess.run([kcuda.nvcc_path(), *kcuda.NVCC_FLAGS,
                        *kcuda.EXTRA_FLAGS.get(name, []), "-I", csrc, "-o",
                        out, os.path.join(csrc, f"{name}.cu")],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {csrc}/{name}.cu:\n"
                           + r.stdout + r.stderr)
    for line in ptxas_figures(r.stdout + r.stderr):
        log(f"  DIR's {name}: {line}")
    lib = ctypes.CDLL(out)
    for fn, types in argtypes.items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def _bound_to(name: str, lib):
    """Inside the block the port's wrappers launch `name` through `lib`
    (same C interface)."""
    from risingwave_tpu_torch.ops import cuda as kcuda
    mine = kcuda.load(name)
    kcuda._loaded[name] = lib
    try:
        yield
    finally:
        kcuda._loaded[name] = mine


def _route_raw(lib, rows, valid, omap, s, bucket, kw):
    """One rw_route call through `lib` (this build's or DIR's: one C
    interface), with counts for 64 tiles a sender or 1,024-row tiles,
    whichever is more."""
    from risingwave_tpu_torch.ops import cuda as kcuda
    n, w = rows.shape
    local = n // s
    i32 = dict(dtype=torch.int32, device=rows.device)
    own = torch.empty(n, **i32)
    counts = torch.empty(s * max(64, -(-local // 1024)) * s, **i32)
    recv = torch.empty((s, s * bucket, w), **i32)
    rvalid = torch.empty((s, s * bucket), **i32)
    ovf = torch.empty(s, **i32)
    rc = lib.rw_route(rows.data_ptr(), rows.stride(0), valid.data_ptr(),
                      valid.stride(0), s, local, kw, w, omap.data_ptr(),
                      bucket, own.data_ptr(), counts.data_ptr(),
                      recv.data_ptr(), rvalid.data_ptr(), ovf.data_ptr(),
                      kcuda.stream_ptr())
    assert rc == 0, f"rw_route failed: CUDA error {rc}"
    return recv, rvalid, ovf


def route_inputs(dev) -> dict:
    """route's timed shapes: q7-mesh's step (2^15 packed rows in 8
    senders, bucket = the block; one window, so every row goes to one
    shard) and q8-mesh's side-epoch (the fresh persons-like epoch of
    2^16 join rows, skew-exact bucket): name -> (rows, int32 valid,
    owner map, S, bucket, kw)."""
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.parallel import ShardedJoinKernel, ShardMesh
    from risingwave_tpu_torch.parallel.mesh import contiguous_owner_map
    q7 = make_specs(H, [("max", np.int64), ("count", None)])
    p = torch.from_numpy(q7_batch(N, q7)).to(dev)
    omap = torch.from_numpy(contiguous_owner_map(MESH_SHARDS)).to(dev)
    out = {"q7_mesh": (p, p[:, KW + 1], omap, MESH_SHARDS,
                       N // MESH_SHARDS, KW)}
    fresh = join_epochs(J_EPOCHS, J_N)[2]
    k = ShardedJoinKernel(ShardMesh(MESH_SHARDS, dev), JKW)
    up, aux = (torch.from_numpy(x).to(dev) for x in fresh)
    rows, valid, bucket = _mesh_route_args(k, up, aux,
                                           J.FLAG_INS | J.FLAG_DEL, False)
    out["q8_mesh"] = (rows, valid.to(torch.int32), k.owner_map, k.n_dev,
                      bucket, JKW)
    return out


def _other_stats():
    """stats(n) -> (stats, extra arguments) for another build's K1 and K8:
    the launch sums into zeroed stats and zeroes the next block, the
    build's own chain."""
    held = {}

    def stats(n, device):
        cur = held.get("next")
        if cur is None:
            cur = torch.zeros(64, dtype=torch.int32, device=device)
        held["next"] = torch.empty(64, dtype=torch.int32, device=device)
        return cur[:n], [held["next"].data_ptr(), 64]
    return stats


def _k1_other(lib):
    """K1 through another build's rw_probe_insert (k1_call's signature,
    [S, ...] tensors)."""
    from risingwave_tpu_torch.ops import cuda as kcuda
    stats_of = _other_stats()

    def call(table, keys, valid):
        s, n, k = keys.shape
        valid = valid.to(torch.int32) if valid.dtype == torch.bool else valid
        slots = torch.empty((s, n), dtype=torch.int32, device=keys.device)
        stats, extra = stats_of(2 * s, keys.device)
        rc = lib.rw_probe_insert(
            keys.data_ptr(), keys.stride(1), keys.stride(0),
            valid.data_ptr(), valid.stride(1), valid.stride(0), n, k,
            table.keys.data_ptr(), table.occ.data_ptr(),
            table.keys.shape[1], s, slots.data_ptr(), stats.data_ptr(),
            *extra, kcuda.stream_ptr())
        assert rc == 0, f"rw_probe_insert failed: CUDA error {rc}"
        return slots, stats.view(s, 2)
    return call


def _k8_other(lib):
    """K8 through another build's rw_lookup, as ``_k1_other``."""
    from risingwave_tpu_torch.ops import cuda as kcuda
    stats_of = _other_stats()

    def call(table, keys, valid, dropped=None):
        n, k = keys.shape
        valid = valid.to(torch.int32) if valid.dtype == torch.bool else valid
        slots = torch.empty(n, dtype=torch.int32, device=keys.device)
        stats, extra = stats_of(2, keys.device)
        rc = lib.rw_lookup(
            keys.data_ptr(), keys.stride(0), valid.data_ptr(),
            valid.stride(0), n, k, table.keys.data_ptr(),
            table.occ.data_ptr(), table.keys.shape[0], slots.data_ptr(),
            stats.data_ptr(), None if dropped is None else dropped.data_ptr(),
            *extra, kcuda.stream_ptr())
        assert rc == 0, f"rw_lookup failed: CUDA error {rc}"
        return slots, stats
    return call


def ptxas_figures(text: str) -> list:
    """The lines of an nvcc -Xptxas -v log that give each kernel's
    registers, stack frame and spills, each tagged with its kernel."""
    import re
    out, fn = [], "?"
    for line in text.splitlines():
        m = re.search(r"(?:entry function|Function properties for) "
                      r"'?(\w+)", line)
        if m:
            fn = m.group(1)
        elif "registers" in line or "stack frame" in line:
            out.append(f"{fn}: {line.strip()}")
    return out


def k3_cases(dev) -> dict:
    """K3's timed shapes: q7's state after one step (2^18 slots) and
    q7-mesh's (MESH_SHARDS x MESH_CAP slots), each at flush_cap 1024
    (the kernel's default) and 64 (the padding rows' share), and
    maxbids' first agg after one step (2^20 slots: a block takes several
    tiles) at 1024: name -> (st [S, R, cap], keys [S, cap, k], occ [S,
    cap], flush_cap)."""
    from risingwave_tpu_torch.ops import hash_agg as H
    _q7, qs = _q7_state(dev, CAP, N)
    q7 = make_specs(H, [("max", np.int64), ("count", None)])
    qk = _mesh_step(dev, q7, q7_batch(N, q7), True)[0]
    out = {}
    for fc in (1 << 10, 1 << 6):
        out[f"q7 flush_cap {fc}"] = (qs.st[None], qs.table.keys[None],
                                     qs.table.occ[None], fc)
        out[f"q7_mesh flush_cap {fc}"] = (qk.st, qk.table.keys,
                                          qk.table.occ, fc)
    mb = _maxbids_state(dev)
    out["maxbids flush_cap 1024"] = (mb.st[None], mb.table.keys[None],
                                     mb.table.occ[None], 1 << 10)
    return out


def k3_bound(st, keys, fc) -> tuple:
    """K3's bytes: dirty and occ read once, each dirty row's columns
    read once, the [S, 1 + flush_cap, W'] matrix written once."""
    from risingwave_tpu_torch.ops import hash_agg as H
    s, r, cap = st.shape
    wout = H.flush_width(keys.shape[2], (r - H.ROW_ACC0) // 2)
    n_dirty = int((st[:, H.ROW_DIRTY] != 0).sum())
    nbytes = s * cap * 8 + n_dirty * wout * 4 + s * (1 + fc) * wout * 4
    return bound_ms(nbytes, s * cap * 4)


def _k3_other(lib):
    """K3's gather through another build's rw_flush_gather, [S, ...]
    tensors, with a status block from a stats chain of its own."""
    from risingwave_tpu_torch.ops import cuda as kcuda
    from risingwave_tpu_torch.ops import hash_agg as H

    def call(st, keys, occ, fc):
        s, r, cap = st.shape
        k = keys.shape[2]
        nacc = (r - H.ROW_ACC0) // 2
        wout = H.flush_width(k, nacc)
        out = torch.empty((s, 1 + fc, wout), dtype=torch.int32,
                          device=st.device)
        n = H.flush_status_words(s, cap)
        cur, nxt = kcuda.stats_chain(st.device, n, "against-flush")
        rc = lib.rw_flush_gather(st.data_ptr(), keys.data_ptr(),
                                 occ.data_ptr(), cap, k, nacc, s,
                                 cur.data_ptr(), nxt.data_ptr(), nxt.numel(),
                                 fc, out.data_ptr(), wout,
                                 kcuda.stream_ptr())
        assert rc == 0, f"rw_flush_gather failed: CUDA error {rc}"
        kcuda.chain_next(st.device, nxt, "against-flush")
        return out
    return call


def fused_cases(dev) -> dict:
    """The fused entries' timed shapes: the five path programs of
    ``path_programs`` and q7's agg prelude in the MESH_SHARDS segments of
    the q7-mesh fused step: name -> (entry, program, raw, seg)."""
    out = {}
    for label, (prog, raw) in path_programs(dev).items():
        out[label] = (label.split()[-1], prog, raw, 0)
        if label == "q7 agg_prelude":
            out[f"q7 agg_prelude in {MESH_SHARDS} segments"] = (
                "agg_prelude", prog, raw, N // MESH_SHARDS)
    return out


def _fused_other(lib):
    """The fused entries through another build's rw_* entry points (the
    program's device copy and its host words), with
    ``fused_cases.call_entry``'s signature."""
    from risingwave_tpu_torch.ops import cuda as kcuda

    def call(entry, prog, raw, host_same=None, counts=None, seg=0):
        m = raw.shape[0] * prog.units
        dt = torch.int64 if entry == "fused_chain" else torch.int32
        out = torch.empty((m, prog.out_width), dtype=dt, device=raw.device)
        pw = prog.on(raw.device)
        args = [pw.data_ptr(), prog.words.ctypes.data, int(pw.shape[0]),
                raw.data_ptr(), int(raw.shape[0]), int(raw.shape[1]),
                None if host_same is None else host_same.data_ptr(),
                out.data_ptr(), prog.out_width,
                None if counts is None else counts.data_ptr()]
        if entry == "agg_prelude":
            args.append(int(seg))
        rc = getattr(lib, f"rw_{entry}")(*args, kcuda.stream_ptr())
        assert rc == 0, f"rw_{entry} failed: CUDA error {rc}"
        return out
    return call


def k5_ab_cases(dev) -> dict:
    """K5's timed shapes: q8's fresh side-epoch (2^16 rows, every row a
    new key, 6 payload lanes), q8's mixed epoch (the hot-key epoch:
    ~400 rows on each of 8 keys among new keys, deletes and probe-only
    rows), q8-mesh's routed apply of the fresh epoch (8 shards, route's
    receive block) and the per-chunk step's (the last recorded chunk, 8
    x 4,096 received rows, a scalar seq): name -> (chains, pay, parts,
    nbytes). ``parts`` are one launch's row inputs ([n] or [S, n], any
    strides: aux or receive-block columns) on the slots K1 gave, on
    copies of the side's table; the byte bound charges each received row
    its flag word, each insert its slot, ref and sequence, its next and
    ins_seq writes and its payload read and write, each delete its ref,
    sequence and write, and each distinct slot a head read and write."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import hash_table as ht
    out = {}
    js = build_join_states(dev)
    ks = js["ks"]
    for name, (up, aux) in (("q8 fresh", js["fresh"]),
                            ("q8 hot-key (mixed)", js["mixed"][:2])):
        t = ht.TableState(ks.table.state.keys.clone(),
                          ks.table.state.occ.clone())
        _t, slots, _s = ht.probe_insert(t, up[:, :JKW],
                                        aux[:, J.AUX_FLAGS] & J.FLAG_INS)
        parts = _epoch_parts(slots, up, aux)
        out[name] = (ks.chains, ks.pay, parts, k5_bytes(parts))
    del js
    mj = build_mesh_join_states(dev, twin=False)
    ms = mj["ks"]
    ms.reserve_rows(int(mj["fresh"][1][:, 0].max()))
    recv, _rv, _b = _mesh_routed(ms, *mj["fresh"], J.FLAG_INS | J.FLAG_DEL,
                                 probe=False)
    out["q8-mesh routed"] = (ms.chains, None, _routed_parts(
        ms, recv, JKW, JKW + 1, JKW + 2, recv[:, :, JKW + 3]), None)
    del mj
    pc = replay_perchunk(dev, record_perchunk_steps(dev))
    me, kw = pc["me"], pc["kw"]
    out["per-chunk step"] = (me.chains, None, _routed_parts(
        me, pc["recv"], kw + 1, kw + 2, kw + 3, pc["seq"]), None)
    for name in ("q8-mesh routed", "per-chunk step"):
        c = out[name]
        out[name] = c[:3] + (k5_bytes(c[2]),)
    return out


def _routed_parts(k, recv, ins_col, del_col, flag_col, seq) -> dict:
    """One routed apply's K5 row inputs on a ShardedJoinKernel's receive
    block, on the slots K1 gives on a copy of its table."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import hash_table as ht
    f = recv[:, :, flag_col]
    t = ht.TableState(k.table.keys.clone(), k.table.occ.clone())
    slots, _s = ht.probe_insert_sharded(t, recv[:, :, :k.key_width],
                                        f & J.FLAG_INS)
    return dict(slots=slots, ins_ok=f, ins_bits=J.FLAG_INS,
                ins_ref=recv[:, :, ins_col], seq=seq, del_ok=f,
                del_bits=J.FLAG_DEL, del_ref=recv[:, :, del_col],
                pay_src=None)


def k5_bytes(parts) -> float:
    """K5's bytes on one launch's row inputs: each received row its flag
    word, each insert on a slot its slot, ref and sequence, its next and
    ins_seq writes and its payload read and written, each delete its ref,
    sequence and write, each distinct slot a head read and write."""
    f = parts["ins_ok"].cpu().numpy()
    ins = (f & parts["ins_bits"]) != 0
    dels = (f & parts["del_bits"]) != 0
    sl = parts["slots"].cpu().numpy()
    ins &= sl >= 0
    p = 0 if parts["pay_src"] is None else int(parts["pay_src"].shape[-1])
    sl2, ins2 = sl.reshape(-1, sl.shape[-1]), ins.reshape(-1, sl.shape[-1])
    n_slots = sum(len(np.unique(a[m])) for a, m in zip(sl2, ins2))
    return (f.size * 4 + int(ins.sum()) * (12 + 8 + 8 * p)
            + int(dels.sum()) * 12 + n_slots * 8)


def advance_ab_cases(dev) -> dict:
    """advance's timed shapes: q7's state after one step (2^18 slots),
    q7-mesh's (8 x 2^15) and maxbids' first agg's (2^20, 2,214 dirty):
    name -> (ShardedAggState ([S, ...] tensors), the flush matrices its
    flush leaves: at the kernel's flush_cap, 1,024 or the power of two
    that holds every shard's dirty slots)."""
    from risingwave_tpu_torch.ops import hash_agg as H
    _q7, qs = _q7_state(dev, CAP, N)
    q7 = make_specs(H, [("max", np.int64), ("count", None)])
    qk = _mesh_step(dev, q7, q7_batch(N, q7), True)[0]
    mb = _maxbids_state(dev)

    def sharded(a):
        return H.ShardedAggState(H.ht.TableState(a.table.keys[None],
                                                 a.table.occ[None]),
                                 a.st[None])
    out = {}
    for name, state in (("q7 (2^18 slots)", sharded(qs)),
                        ("q7-mesh (8 x 2^15)", qk),
                        ("maxbids (2^20)", sharded(mb))):
        worst = int((state.st[:, H.ROW_DIRTY] != 0).sum(dim=1).max())
        fc = max(1 << 10, 1 << max(0, worst - 1).bit_length())
        out[name] = (state, H.flush_gather_sharded(state, fc))
    return out


def advance_bytes(state) -> tuple:
    """(bytes, operations) of advance on its flush's list: each dirty
    slot's index, group_rows and accumulators read, and its emitted
    row, emitted accumulators and dirty word written."""
    from risingwave_tpu_torch.ops import hash_agg as H
    n_dirty = int((state.st[:, H.ROW_DIRTY] != 0).sum())
    nacc = (state.st.shape[1] - H.ROW_ACC0) // 2
    return n_dirty * (4 + (1 + nacc) * 4 + (3 + nacc) * 4), n_dirty


def advance_bound(state) -> tuple:
    return bound_ms(*advance_bytes(state))


def advance_mine(state, mats, current: bool = True) -> None:
    """advance through this checkout's wrapper on the flush's list (with
    ``current``, nothing patched since the flush, as on q7's paths)."""
    from risingwave_tpu_torch.ops import hash_agg as H
    H.advance_sharded(state, mats, current=current)


def _advance_other(lib):
    """advance through another build's rw_advance (the listed advance's
    interface: the flush matrix, no patch)."""
    from risingwave_tpu_torch.ops import cuda as kcuda
    from risingwave_tpu_torch.ops import hash_agg as H

    def call(state, mats, current: bool = True):
        st = state.st
        rc = lib.rw_advance(st.data_ptr(), st.shape[2],
                            (st.shape[1] - H.ROW_ACC0) // 2, st.shape[0],
                            mats.data_ptr(), int(mats.shape[1]) - 1,
                            int(mats.shape[2]), int(current),
                            kcuda.stream_ptr())
        assert rc == 0, f"rw_advance failed: CUDA error {rc}"
    return call


def _live_other(lib):
    """K4's live mask through another build's rw_live_mask (the interface
    that writes the mask alone), on [S, ...] state."""
    from risingwave_tpu_torch.ops import cuda as kcuda

    def call(state, mode, lane_off=0, wm_hi=0, wm_lo=0, dropped=None):
        st, keys, occ = state.st, state.table.keys, state.table.occ
        ns, _r, cap = st.shape
        live = torch.empty((ns, cap), dtype=torch.int32, device=st.device)
        rc = lib.rw_live_mask(mode, st.data_ptr(), keys.data_ptr(),
                              occ.data_ptr(), cap, keys.shape[2], lane_off,
                              wm_hi, wm_lo, st.stride(0), ns,
                              None if dropped is None else dropped.data_ptr(),
                              live.data_ptr(), kcuda.stream_ptr())
        assert rc == 0, f"rw_live_mask failed: CUDA error {rc}"
        return live
    return call


def _rebuild_other(lib):
    """The rebuild chain with another build's K4 live mask: the mask, two
    fills of a fresh table, K1, K4 remap (K1 and remap this checkout's),
    on [S, ...] state; the eviction first marks its keys with K8 in a
    zeroed mask. -> (ShardedAggState, K1 stats)."""
    from risingwave_tpu_torch.ops import hash_agg as H
    live_of = _live_other(lib)

    def call(case):
        state, new_cap, fill = case["state"], case["new_cap"], case["fill"]
        s, _r, cap = state.st.shape
        dropped = None
        if case.get("evict") is not None:
            q, v = case["evict"]
            dropped = torch.zeros((1, cap), dtype=torch.int32,
                                  device=state.st.device)
            H.ht.lookup(H.ht.TableState(state.table.keys[0],
                                        state.table.occ[0]), q, v,
                        dropped[0])
        live = live_of(state, case["mode"], case.get("lane_off", 0),
                       case.get("wm_hi", 0), case.get("wm_lo", 0), dropped)
        kw = state.table.keys.shape[2]
        table = H.ht.TableState(
            torch.zeros((s, new_cap, kw), dtype=torch.int32,
                        device=state.st.device),
            torch.zeros((s, new_cap), dtype=torch.int32,
                        device=state.st.device))
        o2n, stats = H.ht.probe_insert_sharded(table, state.table.keys,
                                               live)
        return H.ShardedAggState(table, H.remap_sharded(
            state.st, o2n, table.occ, fill, new_cap)), stats
    return call


def rebuild_mine(case):
    """The rebuild chain through this checkout's entry points: retire,
    growth or eviction on one device, the sharded retire on [S, ...]
    state. -> (ShardedAggState, K1 stats)."""
    from risingwave_tpu_torch.ops import hash_agg as H
    state, new_cap, fill = case["state"], case["new_cap"], case["fill"]
    if state.n_shards > 1:
        return H.rebuild_sharded(state, case["mode"], new_cap, fill,
                                 case["lane_off"], case["wm_hi"],
                                 case["wm_lo"])
    one = state.shard(0)
    if case.get("evict") is not None:
        new, stats, _l = H.evict_state(one, *case["evict"], fill)
    elif case["mode"] == H.LIVE_RETIRE:
        new, stats = H.retire_state(one, case["wm_hi"], case["wm_lo"],
                                    case["lane_off"], fill)
    else:
        new, stats = H.grow_state(one, new_cap, fill)
    return H.ShardedAggState(H.ht.TableState(new.table.keys[None],
                                             new.table.occ[None]),
                             new.st[None]), stats[None]


def rebuild_plain(case):
    """The same rebuild through the plain versions, shard by shard."""
    from risingwave_tpu_torch.ops import hash_agg as H
    state, new_cap, fill = case["state"], case["new_cap"], case["fill"]
    outs = []
    for d in range(state.n_shards):
        one = state.shard(d)
        dropped = None
        if case.get("evict") is not None:
            dropped = torch.zeros(one.capacity, dtype=torch.int32,
                                  device=one.st.device)
            H.ht.lookup_plain(one.table, *case["evict"], dropped)
        live = H.live_mask_plain(one, case["mode"], case.get("lane_off", 0),
                                 case.get("wm_hi", 0), case.get("wm_lo", 0),
                                 dropped)
        t = H.ht.make_state(new_cap, one.table.key_width, one.st.device)
        o2n, _s = H.ht.probe_insert_plain(t, one.table.keys, live)
        outs.append(H.AggState(t, H.remap_plain(one.st, o2n, t.occ, fill,
                                                new_cap)))
    return H.ShardedAggState(
        H.ht.TableState(torch.stack([o.table.keys for o in outs]),
                        torch.stack([o.table.occ for o in outs])),
        torch.stack([o.st for o in outs]))


def rebuild_bytes(case, out) -> float:
    """Bytes the rebuild must move, as a function of its inputs and
    outputs: every slot's occ word, the occupied slots' three rule rows
    and key lanes (the dropped mask when evicting, and K8's query rows),
    the live slots' state columns read, and the fresh table and state
    matrix written whole."""
    st = case["state"].st
    s, r, cap = st.shape
    kw = case["state"].table.keys.shape[2]
    new_cap = case["new_cap"]
    n_occ = int((case["state"].table.occ != 0).sum())
    n_live = int((out.table.occ != 0).sum())
    b = s * cap * 4 + n_occ * (3 + kw) * 4 + n_live * r * 4
    b += s * new_cap * (kw + 1 + r) * 4
    if case.get("evict") is not None:
        b += s * cap * 4 + int(case["evict"][0].shape[0]) * (kw + 1) * 4
    return b


def rebuild_ab_cases(dev) -> dict:
    """The rebuild chains' timed shapes: q7's retirement and growth at
    2^18 slots (2^18 -> 2^19), the capped maxbids arm's eviction (2^18
    slots, CAPPED_GROUPS groups, CAPPED_SWEEP keys) and q7-mesh's sharded
    retirement (8 x 2^15 slots), each on an advanced state."""
    from risingwave_tpu_torch.ops import hash_agg as H
    q7, qs = _q7_state(dev, CAP, N)
    H.advance(qs)
    qfill = torch.tensor(H.state_fills(q7), dtype=torch.int32, device=dev)
    qk = _mesh_step(dev, q7, q7_batch(N, q7), True)[0]
    H.advance_sharded(qk)
    specs, cs, keys = _cold_state(dev, CAPPED_CAP, CAPPED_GROUPS)
    cfill = torch.tensor(H.state_fills(specs), dtype=torch.int32, device=dev)
    rng = np.random.default_rng(4)
    q = torch.from_numpy(_evict_query(rng, keys, CAPPED_SWEEP)).to(dev)
    v = torch.ones(CAPPED_SWEEP, dtype=torch.int32, device=dev)

    def sharded(a):
        return H.ShardedAggState(H.ht.TableState(a.table.keys[None],
                                                 a.table.occ[None]),
                                 a.st[None])
    retire = dict(mode=H.LIVE_RETIRE, lane_off=0, wm_hi=0, wm_lo=0)
    return {
        "q7 retire (2^18)": dict(retire, state=sharded(qs), new_cap=CAP,
                                 fill=qfill),
        "q7 growth (2^18 -> 2^19)": dict(mode=H.LIVE_GROW,
                                         state=sharded(qs),
                                         new_cap=2 * CAP, fill=qfill),
        "capped maxbids evict (2^18)": dict(mode=H.LIVE_EVICT,
                                            state=sharded(cs),
                                            new_cap=CAPPED_CAP, fill=cfill,
                                            evict=(q, v)),
        "q7-mesh retire (8 x 2^15)": dict(retire, state=qk,
                                          new_cap=MESH_CAP, fill=qfill),
    }


def _scatter_other(lib):
    """K9 through another build's rw_scatter_rows, [S, ...] tensors."""
    from risingwave_tpu_torch.ops import cuda as kcuda

    def call(st, idx, rows, src):
        rc = lib.rw_scatter_rows(st.data_ptr(), st.shape[2], st.stride(0),
                                 idx.data_ptr(), idx.stride(0), idx.shape[1],
                                 rows.data_ptr(), rows.shape[0],
                                 src.data_ptr(), src.stride(0), st.shape[0],
                                 kcuda.stream_ptr())
        assert rc == 0, f"rw_scatter_rows failed: CUDA error {rc}"
    return call


def patch_ab_cases(dev, cases=None) -> dict:
    """The patch chain's timed shapes, from ``advance_ab_cases`` (or
    `cases`, its result): maxbids' first agg after one step (2^20 slots,
    one accumulator, ~2,200 dirty slots) and q7-mesh's state (8 x 2^15
    slots, four accumulators) -> (state [S, ...], its flush matrices, the
    patch's slots int32[S, m] padded with cap, its columns int32[S,
    n_acc, m], m the fullest shard's count, as patch_accs lays them out;
    the last two as numpy, uploaded by each call as the barrier does)."""
    out = {}
    for name, (state, mats) in (cases or advance_ab_cases(dev)).items():
        if name.startswith("q7 "):
            continue
        m = mats.cpu().numpy()
        ns = [int(m[d, 0, 0]) for d in range(m.shape[0])]
        pad = max(ns)
        idx = np.full((m.shape[0], pad), state.capacity, np.int32)
        for d, n in enumerate(ns):
            idx[d, :n] = m[d, 1:1 + n, 0]
        rng = np.random.default_rng(len(out) + 3)
        src = rng.integers(-2**31, 2**31, (m.shape[0], state.n_acc, pad)) \
            .astype(np.int32)
        out[name] = (state, mats, idx, src)
    return out


def patch_plain(state, mats, idx, src) -> None:
    """The patch then the listed advance through the plain versions."""
    from risingwave_tpu_torch.ops import hash_agg as H
    dev = state.st.device
    H.scatter_rows_plain(state.st, torch.from_numpy(idx).to(dev),
                         H.patch_rows(state.n_acc, dev),
                         torch.from_numpy(src).to(dev))
    for d in range(state.n_shards):
        H.advance_listed_plain(state.shard(d), mats[d])


def patch_mine(state, mats, idx, src) -> None:
    """The patch chain through this checkout's wrappers: the upload of
    the columns, then advance on the flush's list carrying them (one
    launch; the slots are the list's own)."""
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.utils.device import upload
    H.advance_sharded(state, mats, patch=upload(src, state.st.device))


def _patch_other(f_lib, s_lib):
    """The patch chain with another build's K9 and advance."""
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.utils.device import upload
    adv, scat = _advance_other(f_lib), _scatter_other(s_lib)

    def call(state, mats, idx, src):
        dev = state.st.device
        scat(state.st, upload(idx, dev), H.patch_rows(state.n_acc, dev),
             upload(src, dev))
        adv(state, mats, current=False)
    return call


def reload_ab_cases(dev) -> dict:
    """K9 alone at the reload shapes the capped maxbids arm and q7-tier
    give (RELOAD_SHAPES: slots, state rows written, capacity) and at the
    table's patch shape (2^16 slots x 12 accumulator rows of 2^20): name
    -> (st [1, R, cap], idx [1, n], rows, src [1, k, n])."""
    from risingwave_tpu_torch.ops import hash_agg as H
    out = {}
    rng = np.random.default_rng(23)
    for name, (n, nacc, cap, patch) in RELOAD_SHAPES.items():
        r = H.ROW_ACC0 + 2 * nacc
        st = torch.from_numpy(rng.integers(-2**31, 2**31, (1, r, cap))
                              .astype(np.int32)).to(dev)
        rows = (H.patch_rows(nacc, dev) if patch
                else H.load_rows(nacc, dev))
        idx = torch.from_numpy(rng.permutation(cap)[:n].astype(np.int32)
                               [None]).to(dev)
        src = torch.from_numpy(rng.integers(
            -2**31, 2**31, (1, int(rows.shape[0]), n)).astype(np.int32)
        ).to(dev)
        out[name] = (st, idx, rows, src)
    return out


def _k7_other(lib):
    """K7 through another build's rw_masked_scatter at the interface
    before the null vis, the row strides and the carry (contiguous refs,
    vis array and values): (arr, refs, vis, vals) -> arr."""
    from risingwave_tpu_torch.ops import cuda as kcuda

    def call(arr, refs, vis, vals):
        n = int(refs.shape[0])
        if n:
            rc = lib.rw_masked_scatter(
                arr.data_ptr(), arr.shape[0],
                1 if arr.dim() == 1 else arr.shape[1], refs.data_ptr(),
                vis.data_ptr(), vals.data_ptr(), n, kcuda.stream_ptr())
            assert rc == 0, f"rw_masked_scatter failed: CUDA error {rc}"
        return arr
    return call


def _k7_parent_rebuild(k, key_lanes, row_refs, payload, k7) -> None:
    """The parent's JoinSideKernel.rebuild written out: a fresh state,
    the insert at seq 0 (uploads of the key lanes and the refs, a ones
    fill, K1 + K5 link), then the payload by K7 (uploads of the refs and
    the payload lanes)."""
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.utils.device import upload
    n = len(row_refs)
    key_cap = max(k.table.capacity, 1 << int(np.ceil(np.log2(max(
        n / ht.MAX_LOAD, 1)))))
    row_cap = max(k.row_capacity, 1 << int(np.ceil(np.log2(max(n + 1,
                                                                2)))))
    k._init_state(key_cap, row_cap)
    ones = torch.ones(n, dtype=torch.int32, device=k.device)
    k.insert(upload(np.asarray(key_lanes, np.int32), k.device), row_refs,
             ones, seq=0)
    k.pay = k7(k.pay, upload(np.asarray(row_refs, np.int32), k.device),
               ones, upload(np.asarray(payload, np.int32), k.device))


def _k7_parent_write(k, refs, vals, k7) -> None:
    """The parent's write_degrees: uploads of the refs and the values, a
    ones fill, K7."""
    from risingwave_tpu_torch.utils.device import upload
    n = len(refs)
    k.deg = k7(k.deg, upload(np.asarray(refs, np.int32), k.device),
               torch.ones(n, dtype=torch.int32, device=k.device),
               upload(np.asarray(vals, np.int32), k.device))


# the chains K7 serves, at the paths' shapes (MASKED_SCATTER_SHAPES,
# REBUILD_SHAPES): compactions -> (live rows, row capacity, the span of
# the live refs, carries degrees)
K7_COMPACTIONS = {
    "capped compaction 1,536 of 2^18": (1536, 1 << 18, 40000, True),
    "join modes compaction 35,693 of 2^16": (35693, 1 << 16, 40934, True),
    "join modes compaction 35,712 of 2^16": (35712, 1 << 16, 40934,
                                             False),
}


def _k7_side(dev, n: int, row_cap: int, seed: int, keys=None):
    """A JoinSideKernel on the card holding n rows (refs 0..n-1) keyed as
    q8's persons (6 key lanes, 6 payload lanes), or by the given `keys`
    lanes, its degrees random; -> (kernel, key lanes, payload)."""
    from risingwave_tpu_torch.ops import hash_join as J
    rng = np.random.default_rng(seed)
    up = _join_up(*_person(rng.permutation(4 * n)[:n]))
    if keys is not None:
        up[:, :JKW] = keys
    k = J.JoinSideKernel(JKW, key_capacity=1 << 10, row_capacity=row_cap,
                         probe_capacity=OUT_CAP, payload_width=JP,
                         device=dev)
    k.rebuild(up[:, :JKW], np.arange(n, dtype=np.int32), up[:, JKW:])
    k.deg = torch.from_numpy(rng.integers(0, 50, k.row_capacity)
                             .astype(np.int32)).to(dev)
    return k, up[:, :JKW], up[:, JKW:]


def k7_chain_cases(dev, k7) -> dict:
    """name -> make(mine) -> (chain, result): the three chains K7 serves,
    this checkout's (``mine``) or the parent's (its host code written out
    around DIR's K7 through `k7`), each on state built the same way from
    a seed; result() reads what the chain wrote. Compactions at
    K7_COMPACTIONS; recovery's degree write for 40,000 rows probed
    against the other side's 15,115; the capped arm's reload: 6,931 rows
    reloaded into 8,467 (refs 1,536-8,466, staged as the executor stages
    them) probed against the other side's 8,467."""
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.utils.device import fetch, upload
    cases = {}
    for i, (name, (n, row_cap, span, carry)) in enumerate(
            K7_COMPACTIONS.items()):
        def make(mine, n=n, row_cap=row_cap, span=span, carry=carry,
                 seed=70 + i):
            k, keys, pay = _k7_side(dev, span, row_cap, seed)
            rng = np.random.default_rng(seed + 1)
            live = np.sort(rng.choice(span, n, replace=False)) \
                .astype(np.int32)
            keys, pay = keys[live], pay[live]
            dense = np.arange(n, dtype=np.int32)

            def chain():
                if mine:
                    k.rebuild(keys, dense, pay,
                              carry=live if carry else None)
                    return
                deg = fetch(k.deg)[live] if carry else None
                _k7_parent_rebuild(k, keys, dense, pay, k7)
                if carry:
                    _k7_parent_write(k, dense, deg, k7)
            return chain, lambda: [*_by_key(k.table.state, k.chains),
                                   *(a.cpu().numpy() for a in (
                                       *k.chains[1:], k.pay, k.deg))]
        cases[name] = make

    def recovery(mine):
        a, lanes_a, _p = _k7_side(dev, 40000, 1 << 18, 80)
        rng = np.random.default_rng(81)
        # the other side keyed by persons the first side holds: some rows
        # match several, most none
        b, _l, _p = _k7_side(dev, 15115, 1 << 18, 82,
                             keys=lanes_a[rng.choice(40000, 15115)])
        refs = np.arange(40000, dtype=np.int32)
        nonnull = np.ones(40000, dtype=bool)
        a.deg.zero_()

        def chain():
            if mine:
                a.write_degrees(upload(refs, dev),
                                b.probe_degrees(lanes_a, nonnull))
                return
            deg, _pi, _r = b.probe(lanes_a, nonnull)
            _k7_parent_write(a, refs, np.where(nonnull, deg[:40000], 0), k7)
        return chain, lambda: [a.deg.cpu().numpy()]
    cases["recovery degrees 40,000 against 15,115"] = recovery

    def reload(mine):
        t, lanes_t, _p = _k7_side(dev, 8467, 1 << 18, 90)
        t.deg.zero_()
        rng = np.random.default_rng(92)
        o, _l, _p = _k7_side(dev, 8467, 1 << 18, 91,
                             keys=lanes_t[rng.choice(8467, 8467)])
        n = 6931
        refs = np.arange(8467 - n, 8467, dtype=np.int32)
        cap = 8192
        up = np.zeros((cap, JKW + JP), np.int32)
        up[:n, :JKW] = lanes_t[refs]
        aux = np.zeros((cap, 4), np.int32)
        aux[:n, J.AUX_INS_REF] = refs
        aux[:n, J.AUX_FLAGS] = J.FLAG_INS
        up_dev, aux_dev = upload(up, dev), upload(aux, dev)

        def chain():
            if mine:
                t.write_degrees(aux_dev[:n, J.AUX_INS_REF], o.probe_degrees(
                    up_dev[:n, :JKW], aux_dev[:n, J.AUX_FLAGS]))
                return
            deg, _pi, _r = o.probe(up[:n, :JKW], np.ones(n, dtype=bool))
            _k7_parent_write(t, aux[:n, J.AUX_INS_REF], deg[:n], k7)
        return chain, lambda: [t.deg.cpu().numpy()]
    cases["reload degrees 6,931 of 8,467"] = reload
    return cases


def chain_host_fns(fn, calls: int = 20, top: int = 10) -> dict:
    """Host self-time of one chain call by function (ms a call, the `top`
    largest) from cProfile over `calls` calls, each synchronized: where a
    host-bound chain's wall time goes."""
    import cProfile
    import os
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
        torch.cuda.synchronize()
    prof.disable()
    out = {}
    for (path, _line, name), (_cc, _nc, tt, _ct, _callers) in \
            pstats.Stats(prof).stats.items():
        key = name if path == "~" else f"{os.path.basename(path)}:{name}"
        out[key] = out.get(key, 0.0) + tt * 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:top])


def paired_wall_ms(fa, fb, rounds: int = 41) -> tuple:
    """Host wall time of two chains to their end (the card idle before
    each call, synchronized after it), in `rounds` pairs whose order
    alternates (a then b, b then a, ...): the measure of chains whose
    parts wait on the host (uploads, fills, a fetch), paired so that the
    host's drift falls on both. -> (median ms of a, of b, the share of
    pairs in which b took less time)."""
    for _ in range(3):
        fa()
        fb()
    ta, tb = [], []
    for i in range(rounds):
        for f, t in ((fa, ta), (fb, tb))[::1 if i % 2 == 0 else -1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f()
            torch.cuda.synchronize()
            t.append((time.perf_counter() - t0) * 1e3)
    return (statistics.median(ta), statistics.median(tb),
            sum(b < a for a, b in zip(ta, tb)) / rounds)


AB_GROUPS = ("agg_apply", "route", "probe_insert", "lookup", "join_probe",
             "flush_gather", "fused", "join_apply", "advance", "rebuild",
             "patch", "masked_scatter")


def ab_main(base: str, only: tuple = AB_GROUPS) -> int:
    """``python3 chip_smoke.py --against DIR``: K2 (agg_apply), route, K1
    (probe_insert), K8 (lookup), K6 (join_probe), K3 (flush_gather and
    advance), K5 (join_apply), the fused entries, the rebuild chains,
    the patch chain (and K9 alone at the reload shapes) and the chains
    K7 serves (``k7_chain_cases``) of this checkout against the same
    kernels built from DIR's
    ``risingwave_tpu_torch/csrc`` (the parent commit unpacked with ``git
    archive``), at the timed shapes of phase 3 on one card. K2, K5 and
    K6 run behind this checkout's wrappers (their C interfaces are
    shared); route, K1 and K8 through each build's own entry points (one
    interface); DIR's K3, K4's mask, K9 and fused entries through its own
    entry points, at their interfaces before the mask cleared the fresh
    table and advance carried the patch. Each build is first held to the
    plain version, then timed in turns (DIR's, this, this, DIR's); the
    per-kernel splits of route, K3, K5, K6 and the chains are read for
    both (torch.profiler), and launches a wrapper call."""
    import ctypes
    import functools
    import os
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from risingwave_tpu_torch.ops import cuda as kcuda
    from risingwave_tpu_torch.ops import fused as F
    from risingwave_tpu_torch.ops import fused_cases as FC
    from risingwave_tpu_torch.ops import hash_agg as H
    from risingwave_tpu_torch.ops import hash_join as J
    from risingwave_tpu_torch.ops import kernel_cases as KC
    from risingwave_tpu_torch.parallel import exchange as X
    dev = torch.device("cuda")
    kcuda.build_all()
    csrc = os.path.join(base, "risingwave_tpu_torch", "csrc")
    need = set(only)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if "agg_apply" in need:
        k2_other = _other_lib(csrc, "agg_apply",
                              kcuda.LIBRARIES["agg_apply"])
    if "route" in need:
        route_libs = {True: kcuda.load("route"), False: _other_lib(
            csrc, "route", kcuda.LIBRARIES["route"])}
    if need & {"probe_insert", "lookup"}:
        p_other = _other_lib(csrc, "probe_insert",
                             kcuda.LIBRARIES["probe_insert"])
        k1_calls = {True: k1_call, False: _k1_other(p_other)}
        k8_calls = {True: k8_call, False: _k8_other(p_other)}
    if "join_probe" in need:
        k6_other = _other_lib(csrc, "join_probe",
                              kcuda.LIBRARIES["join_probe"])
    # K3's gather and advance and the fused entries: DIR's through its
    # own C entry points (the listed advance's interface, without a
    # patch); K5 behind this checkout's wrapper (one interface); K4's
    # live mask and K9 for the rebuild and patch chains
    if need & {"flush_gather", "advance", "patch"}:
        f_other = _other_lib(csrc, "flush", {
            "rw_flush_gather": [P, P, P, L, I, I, I, P, P, I, I, P, I, P],
            "rw_advance": [P, L, I, I, P, I, I, I, P]})
        k3_calls = {True: H._flush_gather_cuda, False: _k3_other(f_other)}
        adv_calls = {True: advance_mine, False: _advance_other(f_other)}
    if "join_apply" in need:
        k5_other = _other_lib(csrc, "join_apply",
                              kcuda.LIBRARIES["join_apply"])

        def k5_base(*args):
            with _bound_to("join_apply", k5_other):
                KC.k5_launch(*args)
        k5_calls = {True: KC.k5_launch, False: k5_base}
    if "fused" in need:
        fz = {"rw_fused_chain": [P, P, I, P, L, I, P, P, I, P, P],
              "rw_agg_prelude": [P, P, I, P, L, I, P, P, I, P, L, P],
              "rw_join_prelude": [P, P, I, P, L, I, P, P, I, P, P]}
        fused_calls = {True: FC.call_entry,
                       False: _fused_other(_other_lib(csrc, "fused", fz))}
    if "rebuild" in need:
        rebuild_calls = {True: rebuild_mine, False: _rebuild_other(
            _other_lib(csrc, "rebuild", {
                "rw_live_mask": [I, P, P, P, L, I, I, I, I, L, I, P, P, P],
                "rw_remap": [P, L, P, P, L, P, I, I, P, P]}))}
    if "patch" in need:
        s_other = _other_lib(csrc, "scatter", kcuda.LIBRARIES["scatter"])
        patch_calls = {True: patch_mine,
                       False: _patch_other(f_other, s_other)}
        scatter_calls = {True: H.scatter_rows_sharded,
                         False: _scatter_other(s_other)}
    if "masked_scatter" in need:
        k7_other = _k7_other(_other_lib(csrc, "join_maint", {
            "rw_masked_scatter": [P, L, I, P, P, P, I, P],
            "rw_rebase": [P, P, L, P]}))
    for name in ("flush", "fused", "join_apply", "rebuild", "scatter",
                 "join_maint"):
        for line in ptxas_figures(kcuda.build_log(name)):
            log(f"  this {name}: {line}")
    log(f"ncu on the PATH: {shutil.which('ncu')}")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True).stdout.strip())
    log(f"launch floor (advance, 1024 slots, nothing dirty): "
        f"{launch_floor_ms(dev)} ms")

    def turns(check, timed) -> dict:
        """check(mine) -> err, then timed(mine) -> ms in turns: DIR's,
        this, this, DIR's."""
        err = max(check(False), check(True))
        t = [timed(mine) for mine in (False, True, True, False)]
        return dict(base_ms=[t[0], t[3]], ms=[t[1], t[2]], max_abs_err=err)

    def k6_ctx(mine):
        return contextlib.nullcontext() if mine \
            else _bound_to("join_probe", k6_other)

    def k6_turns(cases):
        for name, fns in cases.items():
            def check(mine, fns=fns):
                with k6_ctx(mine):
                    return k6_check(fns)

            def timed(mine, fns=fns):
                with k6_ctx(mine):
                    return time_ms(fns[0])
            r = turns(check, timed)
            r["bound_ms"], r["bound_by"] = fns[2]()
            with k6_ctx(False):
                r["base_split"] = kernel_split(fns[0])
            r["split"] = kernel_split(fns[0])
            log(f"join_probe at {name}: " + json.dumps(r))

    def k1_turns(cases):
        for name, case in cases.items():
            r = turns(lambda mine, c=case: k1_check(c, k1_calls[mine])[0],
                      lambda mine, c=case: k1_time(c, k1_calls[mine]))
            r["bound_ms"], r["bound_by"] = k1_check(case)[1]
            log(f"probe_insert at {name}: " + json.dumps(r))

    def k8_turns(cases):
        for name, case in cases.items():
            r = turns(lambda mine, c=case: k8_check(c, k8_calls[mine]),
                      lambda mine, c=case: k8_time(c, k8_calls[mine]))
            r["bound_ms"], r["bound_by"] = k8_bound(case)
            log(f"lookup at {name}: " + json.dumps(r))

    if "flush_gather" in only:
        # one 2,048-slot tile (two dirty slots): one block's latency
        one = H.make_agg_state(2048, KW, make_specs(
            H, [("max", np.int64), ("count", None)]), dev)
        one.st[H.ROW_DIRTY, :2] = 1
        log("flush_gather on one tile, flush_cap 64 (DIR's, this): " +
            json.dumps([time_ms(lambda mine=mine: k3_calls[mine](
                one.st[None], one.table.keys[None], one.table.occ[None], 64))
                for mine in (False, True)]))
        for name, (st, keys, occ, fc) in k3_cases(dev).items():
            want = H.flush_gather_sharded_plain(H.ShardedAggState(
                H.ht.TableState(keys, occ), st), fc)

            def k3_checked(mine, a=(st, keys, occ, fc), want=want):
                e = abs_err(k3_calls[mine](*a).cpu().numpy(),
                            want.cpu().numpy())
                assert e == 0, f"flush_gather differs from its plain " \
                    f"version: {e}"
                return e
            r = turns(k3_checked, lambda mine, a=(st, keys, occ, fc):
                      time_ms(lambda: k3_calls[mine](*a)))
            r["n_dirty"] = (st[:, H.ROW_DIRTY] != 0).sum(dim=1).tolist()
            r["bound_ms"], r["bound_by"] = k3_bound(st, keys, fc)
            r["base_split"] = kernel_split(
                lambda a=(st, keys, occ, fc): k3_calls[False](*a))
            r["split"] = kernel_split(
                lambda a=(st, keys, occ, fc): k3_calls[True](*a))
            log(f"flush_gather at {name}: " + json.dumps(r))
        torch.cuda.empty_cache()
    if "fused" in only:
        for name, (entry, prog, raw, seg) in fused_cases(dev).items():
            def checked(mine, c=(entry, prog, raw, seg)):
                e = fused_err(*c[:3], seg=c[3], call=fused_calls[mine])
                assert e == 0, f"{c[0]} differs from its plain version: {e}"
                return e
            r = turns(checked, lambda mine, c=(entry, prog, raw, seg):
                      time_ms(lambda: fused_calls[mine](
                          c[0], c[1], c[2], seg=c[3])))
            r["bound_ms"], r["bound_by"] = bound_ms(
                F.bound_bytes(prog, int(raw.shape[0])), 0)
            r.update(rows=int(raw.shape[0]) * prog.units,
                     raw_width=int(raw.shape[1]), out_width=prog.out_width)
            # one block's work (32 rows): the latency a block's phases
            # cost, against the path shape's time
            one = raw[:32].contiguous()
            r["one_block_ms"] = [time_ms(lambda mine=mine: fused_calls[mine](
                entry, prog, one)) for mine in (False, True)]
            log(f"{entry} at {name}: " + json.dumps(r))
        torch.cuda.empty_cache()
    for name, inp in (k2_inputs(dev).items() if "agg_apply" in only
                      else ()):
        fk = _k2_fns(inp)[2]

        def k2_timed(mine, fk=fk):
            with contextlib.nullcontext() if mine \
                    else _bound_to("agg_apply", k2_other):
                return time_ms(fk)

        def k2_checked(mine, inp=inp):
            with contextlib.nullcontext() if mine \
                    else _bound_to("agg_apply", k2_other):
                return k2_check(inp)
        r = turns(k2_checked, k2_timed)
        r.update(launches_per_call=launches_of(fk, "agg_apply"))
        log(f"agg_apply at {name}: " + json.dumps(r))
    for name, args in (route_inputs(dev).items() if "route" in only
                       else ()):
        def side(mine, args=args):
            return functools.partial(_route_raw, route_libs[mine], *args)

        def check(mine, args=args):
            got, want = side(mine)(), X.route_plain(*args)
            err = max(abs_err(g.cpu().numpy(), w.cpu().numpy())
                      for g, w in zip(got, want))
            assert err == 0, f"route differs from route_plain: {err}"
            return err
        r = turns(check, lambda mine, side=side: time_ms(side(mine)))
        r["base_split"] = kernel_split(side(False))
        r["split"] = kernel_split(side(True))
        log(f"route at {name}: " + json.dumps(r))
    torch.cuda.empty_cache()

    k1, k8, k6 = ("probe_insert" in only, "lookup" in only,
                  "join_probe" in only)
    if k1:
        k1_turns(k1_cases_q7(dev))
    if k1 or k8 or k6:
        js = build_join_states(dev)
        log("probe lengths, q8's join table: "
            + json.dumps(probe_lengths(js["ks"].table.state)))
        if k1:
            k1_turns(k1_cases_q8(js))
        if k8:
            k8_turns(k8_cases_q8(js))
        if k6:
            k6_turns(k6_cases_q8(js))
        del js
        torch.cuda.empty_cache()
    if k1 or k6:
        mj = build_mesh_join_states(dev, twin=False)
        log("probe lengths, q8-mesh's join tables (8 shards): "
            + json.dumps(probe_lengths(mj["ks"].table)))
        if k1:
            k1_turns(k1_cases_mesh(mj))
        if k6:
            k6_turns(k6_cases_mesh(mj))
        del mj
        torch.cuda.empty_cache()
    if k6:
        k6_turns(k6_cases_perchunk(replay_perchunk(
            dev, record_perchunk_steps(dev))))
        torch.cuda.empty_cache()
    if k8:
        k8_turns(k8_cases_cold(dev))
    if "join_apply" in only:
        for name, (chains, pay, parts, nbytes) in k5_ab_cases(dev).items():
            side = {mine: (J.ChainState(*(t.clone() for t in chains)),
                           None if pay is None else pay.clone(),
                           J.link_scratch(chains.head))
                    for mine in (False, True)}

            def k5_checked(mine, c=(chains, pay, parts)):
                kc = J.ChainState(*(t.clone() for t in c[0]))
                kp = None if c[1] is None else c[1].clone()
                k5_calls[mine](kc, kp, c[2], J.link_scratch(kc.head))
                pc = J.ChainState(*(t.clone() for t in c[0]))
                pp = None if c[1] is None else c[1].clone()
                KC.k5_plain(pc, pp, c[2])
                e = max(abs_err(a.cpu().numpy(), b.cpu().numpy())
                        for a, b in zip((*kc, *([kp] if c[1] is not None
                                                else [])),
                                        (*pc, *([pp] if c[1] is not None
                                                else []))))
                assert e == 0, f"join_apply differs from its plain " \
                    f"version at {name}: {e}"
                return e

            def k5_call(mine, parts=parts):
                return lambda: k5_calls[mine](*side[mine][:2], parts,
                                              side[mine][2])
            r = turns(k5_checked, lambda mine: time_ms(k5_call(mine)))
            r["bound_ms"], r["bound_by"] = bound_ms(nbytes, 0)
            r["rows"] = list(parts["slots"].shape)
            r["launches_per_call"] = launches_of(k5_call(True),
                                                 "join_apply")
            r["base_split"] = kernel_split(k5_call(False))
            r["split"] = kernel_split(k5_call(True))
            log(f"join_apply at {name}: " + json.dumps(r))
        torch.cuda.empty_cache()
    if "advance" in only:
        for name, (state, mats) in advance_ab_cases(dev).items():
            def adv_checked(mine, state=state, mats=mats):
                k = H.ShardedAggState(state.table, state.st.clone())
                p = H.ShardedAggState(state.table, state.st.clone())
                adv_calls[mine](k, mats)
                for s in range(p.n_shards):
                    H.advance_plain(p.shard(s))
                e = abs_err(k.st.cpu().numpy(), p.st.cpu().numpy())
                assert e == 0, f"advance differs from advance_plain at " \
                    f"{name}: {e}"
                return e
            # timed in place: after the first call nothing is dirty (the
            # sweep still reads every dirty word; the list still names the
            # slots, which are advanced again)
            work = H.ShardedAggState(state.table, state.st.clone())
            r = turns(adv_checked, lambda mine: time_ms(
                lambda: adv_calls[mine](work, mats)))
            r["n_dirty"] = (state.st[:, H.ROW_DIRTY] != 0).sum(
                dim=1).tolist()
            r["bound_ms"], r["bound_by"] = advance_bound(state)
            r["flush_cap"] = int(mats.shape[1]) - 1
            r["patched_ms"] = time_ms(lambda: advance_mine(work, mats,
                                                           False))
            r["base_split"] = kernel_split(
                lambda: adv_calls[False](work, mats))
            r["split"] = kernel_split(lambda: adv_calls[True](work, mats))
            log(f"advance at {name}: " + json.dumps(r))
        log("scatter_rows at maxbids' patch shape: "
            + json.dumps(maxbids_patch(dev)))
    if "rebuild" in need:
        for name, case in rebuild_ab_cases(dev).items():
            want = _groups(rebuild_plain(case))

            def rb_checked(mine, case=case, want=want):
                got, stats = rebuild_calls[mine](case)
                e = abs_err(_groups(got), want)
                assert e == 0 and not bool(stats[:, 1].any()), \
                    f"the rebuild differs from its plain twin at {name}: {e}"
                return e
            r = turns(rb_checked, lambda mine, case=case: time_ms(
                lambda: rebuild_calls[mine](case)))
            out = rebuild_calls[True](case)[0]
            r["bound_ms"], r["bound_by"] = bound_ms(
                rebuild_bytes(case, out), 0)
            r["groups"] = [int((case["state"].table.occ != 0).sum()),
                           int((out.table.occ != 0).sum())]
            r["base_split"] = launch_split(lambda c=case: rebuild_calls[
                False](c))
            r["split"] = launch_split(lambda c=case: rebuild_calls[True](c))
            r["launches_per_call"] = {k: launches_of(
                lambda c=case: rebuild_calls[True](c), k)
                for k in ("live_mask", "probe_insert", "remap", "lookup")}
            log(f"rebuild at {name}: " + json.dumps(r))
        torch.cuda.empty_cache()
    if "patch" in need:
        for name, (state, mats, idx, src) in patch_ab_cases(dev).items():
            want = H.ShardedAggState(state.table, state.st.clone())
            patch_plain(want, mats, idx, src)

            def pt_checked(mine, a=(state, mats, idx, src), want=want):
                k = H.ShardedAggState(a[0].table, a[0].st.clone())
                patch_calls[mine](k, *a[1:])
                e = abs_err(k.st.cpu().numpy(), want.st.cpu().numpy())
                assert e == 0, f"the patch differs from its plain twin " \
                    f"at {name}: {e}"
                return e
            # timed in place: each call writes the same columns and
            # advances the listed slots again
            work = H.ShardedAggState(state.table, state.st.clone())
            r = turns(pt_checked, lambda mine: time_ms(
                lambda: patch_calls[mine](work, mats, idx, src)))
            n_dirty = [int(x) for x in mats[:, 0, 0].cpu().tolist()]
            n = sum(n_dirty)
            nacc = state.n_acc
            # uploaded columns, the list's slot and group_rows read, the
            # accumulator and emitted rows and dirty written
            r["bound_ms"], r["bound_by"] = bound_ms(
                idx.size * 4 + src.size * 4 + n * 2 * 4
                + n * (2 * nacc + 3) * 4, n)
            r["n_dirty"] = n_dirty
            r["base_split"] = launch_split(lambda: patch_calls[False](
                work, mats, idx, src))
            r["split"] = launch_split(lambda: patch_calls[True](
                work, mats, idx, src))
            r["launches_per_call"] = {k: launches_of(
                lambda: patch_calls[True](work, mats, idx, src), k)
                for k in ("scatter_rows", "advance")}
            log(f"patch at {name}: " + json.dumps(r))
        for name, (st, idx, rows, src) in reload_ab_cases(dev).items():
            want = st.clone()
            H.scatter_rows_plain(want, idx, rows, src)

            def k9_checked(mine, a=(st, idx, rows, src), want=want):
                x = a[0].clone()
                scatter_calls[mine](x, *a[1:])
                e = abs_err(x.cpu().numpy(), want.cpu().numpy())
                assert e == 0, f"scatter_rows differs at {name}: {e}"
                return e
            r = turns(k9_checked, lambda mine, a=(st, idx, rows, src):
                      time_ms(lambda: scatter_calls[mine](*a)))
            n, k = int(idx.shape[1]), int(rows.shape[0])
            r["bound_ms"], r["bound_by"] = bound_ms(
                n * 4 + 2 * k * n * 4 + k * 4, n)
            # each 4-byte store at a random slot moves a 32-byte sector
            r["sector_ms"] = (n * 4 + k * n * 4 + k * n * 32 + k * 4) \
                / HBM_BYTES_PER_S * 1e3
            r["library_ms"] = time_ms(lambda a=(st, idx, rows, src): a[0][
                0].index_put_((a[2].to(torch.int64)[:, None],
                               a[1][0].to(torch.int64)[None, :]), a[3][0]))
            r["slots"], r["rows"] = n, k
            log(f"scatter_rows at {name}: " + json.dumps(r))
    if "masked_scatter" in need:
        for name, make in k7_chain_cases(dev, k7_other).items():
            # each build's chain once from the same state: equal results
            results = []
            for mine in (True, False):
                chain, result = make(mine)
                chain()
                results.append(result())
            err = max(abs_err(a, b) for a, b in zip(*results))
            assert err == 0, f"the K7 chain differs from the other " \
                f"build's at {name}: {err}"
            runs = {mine: make(mine) for mine in (False, True)}
            base, ms, won = paired_wall_ms(runs[False][0], runs[True][0])
            r = dict(base_ms=base, ms=ms, pairs_won=won, max_abs_err=err,
                     unit="host wall ms a chain, synchronized, median "
                          "of 41 alternating pairs")
            r["base_split"] = launch_split(runs[False][0], calls=20)
            r["split"] = launch_split(runs[True][0], calls=20)
            r["base_host"] = chain_host_fns(runs[False][0])
            r["host"] = chain_host_fns(runs[True][0])
            r["launches_per_call"] = {k: launches_of(runs[True][0], k)
                                      for k in ("masked_scatter",
                                                "join_apply",
                                                "probe_insert",
                                                "join_probe_deg")}
            log(f"masked_scatter chain at {name}: " + json.dumps(r))
            del runs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--against"] and len(sys.argv) in (3, 4):
        groups = AB_GROUPS if len(sys.argv) == 3 \
            else tuple(sys.argv[3].split(","))
        assert set(groups) <= set(AB_GROUPS), groups
        sys.exit(ab_main(sys.argv[2], groups))
    sys.exit(main())
