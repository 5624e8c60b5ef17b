"""Two pipelines' own fused agg preludes, with a raw input at the path's
shape, for holding ``agg_prelude`` to its plain program: q5-hot's (a hop
of 5 copies, then the (window_start, auction) projection) over Nexmark
bid chunks, and q3's (the DECIMAL revenue ``l_extendedprice * (1 -
l_discount)``, ``OP_DECMUL``) over rows of its second join's output.
Each program is taken from the pipeline that ``build_q5`` / ``build_q3``
build with fusion on, so it is the one the path runs.
"""

from __future__ import annotations

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, StreamChunk
from risingwave_tpu_torch.connectors.nexmark import (
    NexmarkConfig, NexmarkSplitReader,
)
from risingwave_tpu_torch.models.nexmark import build_q5
from risingwave_tpu_torch.models.tpch import build_q3
from risingwave_tpu_torch.ops.fused import (
    MODE_AGG, compile_program, encode_raw_chunk,
)
from risingwave_tpu_torch.state.store import MemoryStateStore



def agg_backlog(chunks, ref_cols, rows: int) -> np.ndarray:
    """A raw backlog as ``GroupedAggKernel.apply_raw`` builds it: each
    chunk's raw matrix followed by an always-invisible separator row,
    zero-padded (vis 0) or cut to ``rows`` rows."""
    mats = []
    for c in chunks:
        mats.append(encode_raw_chunk(c, ref_cols))
        mats.append(np.zeros((1, mats[-1].shape[1]), np.int64))
    m = np.concatenate(mats)
    out = np.zeros((rows, m.shape[1]), np.int64)
    out[:min(rows, len(m))] = m[:rows]
    return out


def _agg_program(agg):
    return compile_program(agg.fused_stages, MODE_AGG,
                           group_indices=agg.group_indices,
                           agg_calls=agg.agg_calls, specs=agg.specs)


def q5_hot_agg_case(n_chunks: int = 7, chunk_rows: int = 4096,
                    rows: int = 1 << 15, first: int = 0):
    """(program, raw backlog, fused stages) of q5-hot's fused agg: its
    prelude expands each raw row into 5 hop copies and projects
    (window_start, auction). The backlog is ``n_chunks`` Nexmark bid
    chunks of ``chunk_rows`` rows from bid ``first`` on, as the fused
    agg's kernel receives them (7 chunks of 4,096 fill its 2^15-row
    batch)."""
    cfg = NexmarkConfig(event_num=1 << 40, max_chunk_size=chunk_rows,
                        generate_strings=False)
    agg = build_q5(MemoryStateStore(), cfg, fusion=True,
                   device="cpu").actor.consumer.input.input
    reader = NexmarkSplitReader(cfg, offset=first)
    chunks = [reader.next_chunk() for _ in range(n_chunks)]
    return (_agg_program(agg),
            agg_backlog(chunks, agg.fused_stages.ref_cols, rows),
            agg.fused_stages)


def q3_revenue_agg_case(cols: dict, chunk_rows: int = 4096,
                        rows: int = 1 << 15):
    """(program, raw backlog, fused stages) of q3's fused agg: its prelude
    computes the DECIMAL revenue (``OP_DECMUL``) and the three group-key
    lanes. ``cols`` gives the second join's output columns the program
    reads (l_orderkey, o_orderdate, o_shippriority, l_extendedprice,
    l_discount; DECIMALs as scaled int64) for each row; the rows go in
    ``chunk_rows``-row chunks, as the join emits them."""
    agg = build_q3(MemoryStateStore(), customers=10, orders=100,
                   fusion=True, device="cpu").actor.consumer.input.input
    fs = agg.fused_stages
    sch = fs.in_schema
    n = len(next(iter(cols.values())))
    chunks = []
    for lo in range(0, n, chunk_rows):
        m = min(chunk_rows, n - lo)
        cs = []
        for f in sch:
            if f.name in cols:
                v = np.asarray(cols[f.name][lo:lo + m],
                               dtype=f.data_type.np_dtype)
            elif f.data_type.is_device:
                v = np.zeros(m, f.data_type.np_dtype)
            else:
                v = np.full(m, "", dtype=object)
            cs.append(Column(f.data_type, v))
        chunks.append(StreamChunk(sch, cs, np.ones(m, bool),
                                  np.ones(m, np.int8)))
    return _agg_program(agg), agg_backlog(chunks, fs.ref_cols, rows), fs


def signed_revenue_cols(n: int, seed: int = 0) -> dict:
    """q3's revenue inputs with both signs and wide magnitudes (the
    product truncates toward zero), and random keys."""
    rng = np.random.default_rng(seed)
    return {"l_orderkey": rng.integers(1, 1 << 20, n),
            "o_orderdate": rng.integers(8035, 10440, n),
            "o_shippriority": rng.integers(-3, 3, n),
            "l_extendedprice": rng.integers(-(1 << 40), 1 << 40, n),
            "l_discount": rng.integers(-(1 << 20), 1 << 20, n)}
