"""Nexmark q1 end to end on the PyTorch port, both arms, against the JAX
reference pipeline and an oracle.

q1 (currency conversion, stateless): SELECT auction, bidder, 0.908 *
price, date_time FROM bid, with a generated ``_row_id`` as the MV's pk.
With ``fusion=True`` the row-id generation and the projection become one
FusedFragmentExecutor (one ``fused_chain`` launch per chunk). Row ids
come from the epoch, which comes from the wall clock, so the MVs are
compared without ``_row_id`` (as tests/test_e2e_q1.py reads it), plus the
ids' count and uniqueness.
"""

import asyncio
import decimal

import numpy as np
import pytest
import torch

from risingwave_tpu.connectors.nexmark import NexmarkConfig as RefConfig
from risingwave_tpu.models import nexmark as ref_models
from risingwave_tpu.state.store import MemoryStateStore as RefStore
from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, gen_bids
from risingwave_tpu_torch.models.nexmark import build_q1, drive_to_completion
from risingwave_tpu_torch.state.store import MemoryStateStore
from risingwave_tpu_torch.stream.executors.fused import (
    FusedFragmentExecutor,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _strict_port_checker():
    """The port's plan checker in assert-don't-fallback mode: a fused
    path that breaks a plan invariant fails instead of falling back to
    the unfused plan."""
    from risingwave_tpu_torch.frontend.opt import set_strict_checker
    set_strict_checker(True)
    yield
    set_strict_checker(False)

N_EPOCHS = 100
CFG = dict(event_num=50 * N_EPOCHS, max_chunk_size=512)
N_BIDS = 46 * N_EPOCHS


def _rows(build, drive, store, config, **kw):
    p = build(store, config(**CFG), **kw)
    asyncio.run(drive(p, {1: N_BIDS}))
    rows = [tuple(r) for _pk, r in p.mv_table.iter_rows()]
    return p, sorted(r[:4] for r in rows), [r[4] for r in rows]


@pytest.mark.parametrize("fusion", [False, True])
def test_q1_port_matches_oracle_and_reference(fusion):
    p, rows, ids = _rows(build_q1, drive_to_completion, MemoryStateStore(),
                         NexmarkConfig, fusion=fusion, device="cpu")
    assert isinstance(p.actor.consumer.input, FusedFragmentExecutor) \
        == fusion
    _rp, ref_rows, ref_ids = _rows(ref_models.build_q1,
                                   ref_models.drive_to_completion,
                                   RefStore(), RefConfig, fusion=fusion)
    bids = gen_bids(np.arange(N_BIDS, dtype=np.int64), NexmarkConfig(**CFG))
    rate = decimal.Decimal("0.908")
    # the MV holds DECIMAL as its scaled int64: 0.908 * price, truncated
    want = sorted(
        (int(a), int(b),
         int((rate * int(x) * 10000).to_integral_value(
             rounding=decimal.ROUND_DOWN)), int(t))
        for a, b, x, t in zip(bids["auction"], bids["bidder"],
                              bids["price"], bids["date_time"]))
    assert rows == want
    assert rows == ref_rows
    assert len(ids) == len(set(ids)) == N_BIDS == len(ref_ids)


def test_q1_fused_block_counts_its_stages():
    p, rows, _ids = _rows(build_q1, drive_to_completion, MemoryStateStore(),
                          NexmarkConfig, fusion=True, device="cpu")
    block = p.actor.consumer.input
    stages = dict((n, r) for n, r, _c in block.fused_stages.drain_stage_metrics())
    assert stages == {"RowIdGenExecutor": N_BIDS, "ProjectExecutor": N_BIDS}
    assert len(rows) == N_BIDS
