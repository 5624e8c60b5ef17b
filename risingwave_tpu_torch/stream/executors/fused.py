"""FusedFragmentExecutor: a filter/project run as one device pass.

Port of ``risingwave_tpu/stream/executors/fused.py``. The reference
interprets its operator graph one executor per stage; this executor
collapses a maximal fusable run (``frontend/opt/fusion.py`` marks them)
into one launch of ``fused_chain`` (``ops/fused.py``, B18) per chunk: the
chunk's referenced device columns ship as one raw int64 matrix, the
composed filters, projection and noop-pair drop run on the card, and the
output columns come back to the host for the consumer (a materialize, a
join side the rule did not absorb). Host-typed passthrough columns ride
around the device pass. Absorbed row_id_gen and watermark_filter stages
keep their host runtime: ids and thresholds enter the raw matrix as
synthetic columns (``FusedStages.augment``), and watermarks and barriers
flow through ``FusedStages.derive_watermarks`` / ``on_barrier`` as the
sequential executors would have handled them.
"""

from __future__ import annotations

from typing import AsyncIterator, List, Optional

import numpy as np
import torch

from risingwave_tpu_torch.common.chunk import Column, StreamChunk
from risingwave_tpu_torch.ops.fused import (
    MODE_CHAIN, FusedStages, Program, compile_program, decode_chain_output,
    encode_raw_chunk, fused_chain,
)
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import (
    Message, Watermark, is_barrier, is_chunk,
)
from risingwave_tpu_torch.utils.device import fetch, resolve_device, upload
from risingwave_tpu_torch.utils.metrics import STREAMING as _METRICS


class FusedFragmentExecutor(Executor):
    """One fused_chain launch per chunk for a fused filter/project run.

    ``device=None`` means the card; ``device="cpu"`` runs the plain
    version."""

    def __init__(self, input_: Executor, stages: FusedStages,
                 device=None):
        self.input = input_
        self.fused_stages = stages
        assert len(stages.in_schema) == len(input_.schema), \
            "fused stage chain planned against a different input"
        super().__init__(ExecutorInfo(
            stages.out_schema, [],
            f"FusedFragmentExecutor[{stages.describe()}]"))
        self._device_arg = device
        self._prog: Optional[Program] = None

    def _run_step(self, chunk: StreamChunk):
        """One chunk (over ext_schema) → (out columns, vis, ops, stage
        row counts)."""
        fs = self.fused_stages
        if self._prog is None:
            self._device = resolve_device(self._device_arg)
            self._prog = compile_program(fs, MODE_CHAIN)
        prog, dev = self._prog, self._device
        raw = upload(encode_raw_chunk(chunk, fs.ref_cols), dev)
        # host passthrough columns bypass the device pass, but the
        # noop-pair drop must still see their adjacent equality
        hs = fs.host_noop_eq(chunk)
        host_same = None if hs is None else upload(hs.astype(np.int8), dev)
        counts = torch.zeros(prog.n_counts, dtype=torch.int64, device=dev)
        # one chain step per chunk is one device step
        _METRICS.device_dispatch.inc(1, executor=self.identity)
        mat = fused_chain(prog, raw, host_same, counts)
        cols, vis, ops = decode_chain_output(prog, fs, fetch(mat))
        return cols, vis, ops, fs.stage_rows_of(fetch(counts))

    async def execute(self) -> AsyncIterator[Message]:
        fs = self.fused_stages
        out_schema = fs.out_schema
        wm_cols = set(fs.wm_time_cols())
        first_seen = False
        async for msg in self.input.execute():
            if is_chunk(msg):
                aug = fs.augment(msg)
                dev_cols, vis, ops, stage_rows = self._run_step(aug)
                fs.note_stage_rows(stage_rows, 1)
                if not vis.any():
                    # empty-suppression contract: the sequential chain
                    # would have emitted nothing either
                    continue
                units = 1 if fs.hop is None else fs.hop.units
                cols: List[Column] = []
                for j, f in enumerate(out_schema):
                    host_src = fs.host_out.get(j)
                    if host_src is None:
                        cols.append(dev_cols[j])
                        continue
                    src = msg.columns[host_src]
                    if units > 1:
                        # hop: host columns tile copy-major to stay
                        # aligned with the expanded rows
                        cols.append(Column(
                            f.data_type, np.tile(np.asarray(src.values),
                                                 units),
                            None if src.validity is None else
                            np.tile(np.asarray(src.validity), units)))
                    else:
                        cols.append(Column(f.data_type, src.values,
                                           src.validity))
                yield StreamChunk(out_schema, cols, vis, ops)
                for wm in fs.post_chunk_watermarks():
                    for d in fs.derive_watermarks(wm):
                        yield d
            elif isinstance(msg, Watermark):
                if msg.col_idx in wm_cols:
                    # an absorbed watermark_filter owns this column
                    continue
                for wm in fs.derive_watermarks(msg):
                    yield wm
            elif is_barrier(msg):
                wms = fs.on_barrier(msg, first=not first_seen)
                first_seen = True
                yield msg
                for wm in wms:
                    for d in fs.derive_watermarks(wm):
                        yield d
            else:
                yield msg
