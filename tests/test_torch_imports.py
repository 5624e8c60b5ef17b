"""The PyTorch port stands alone: importing it loads no JAX and nothing
of the JAX package (checked in a fresh interpreter), and its entry points
run on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import risingwave_tpu_torch.models.nexmark
import risingwave_tpu_torch.ops.cuda
import risingwave_tpu_torch.ops.hash_join
import risingwave_tpu_torch.stream.executors.hash_join
import risingwave_tpu_torch.stream.merge
import risingwave_tpu_torch.stream.executors.test_utils
import risingwave_tpu_torch.expr.expr
import risingwave_tpu_torch.frontend.opt
import risingwave_tpu_torch.frontend.opt.fusion
import risingwave_tpu_torch.ops.fused
import risingwave_tpu_torch.ops.fused_cases
import risingwave_tpu_torch.stream.executors.fused
import risingwave_tpu_torch.stream.executors.row_id_gen
import risingwave_tpu_torch.stream.executors.simple
import risingwave_tpu_torch.parallel
import risingwave_tpu_torch.parallel.agg
import risingwave_tpu_torch.parallel.exchange
import risingwave_tpu_torch.parallel.join
import risingwave_tpu_torch.parallel.mesh
import risingwave_tpu_torch.state.tier
import risingwave_tpu_torch.utils.memory
import risingwave_tpu_torch.stream.executors.hash_agg
import risingwave_tpu_torch.connectors.tpch
import risingwave_tpu_torch.models.tpch
import risingwave_tpu_torch.models.prelude_cases
import risingwave_tpu_torch.stream.executors.hop_window
import risingwave_tpu_torch.stream.executors.top_n
import risingwave_tpu_torch.utils.metrics
import risingwave_tpu_torch.stream.coalesce
import risingwave_tpu_torch.stream.exchange
import risingwave_tpu_torch.stream.executors
import risingwave_tpu_torch.stream.executors.union
import risingwave_tpu_torch.stream.executors.expand
import risingwave_tpu_torch.stream.executors.wrapper
import risingwave_tpu_torch.stream.executors.dedup
import risingwave_tpu_torch.stream.executors.simple_agg
import risingwave_tpu_torch.stream.executors.dynamic_filter
import risingwave_tpu_torch.stream.executors.project_set
import risingwave_tpu_torch.stream.executors.eowc
import risingwave_tpu_torch.state.state_table
import risingwave_tpu_torch.expr.window
import risingwave_tpu_torch.stream.executors.over_window
import risingwave_tpu_torch.stream.executors.temporal_join
import risingwave_tpu_torch.batch
import risingwave_tpu_torch.batch.task
import risingwave_tpu_torch.frontend
import risingwave_tpu_torch.frontend.ast
import risingwave_tpu_torch.frontend.parser
import risingwave_tpu_torch.frontend.catalog
import risingwave_tpu_torch.frontend.session_vars
import risingwave_tpu_torch.frontend.binder
import risingwave_tpu_torch.frontend.opt.rules
import risingwave_tpu_torch.frontend.opt.engine
import risingwave_tpu_torch.frontend.planner
import risingwave_tpu_torch.frontend.session
import risingwave_tpu_torch.meta.barrier
import risingwave_tpu_torch.stream.actor
import risingwave_tpu_torch.connectors.base
import risingwave_tpu_torch.connectors.parser
import risingwave_tpu_torch.connectors.filelog
import risingwave_tpu_torch.connectors.datagen
import risingwave_tpu_torch.connectors.dml
import risingwave_tpu_torch.stream.dispatch
import risingwave_tpu_torch.stream.executors.backfill
import risingwave_tpu_torch.stream.executors.source
import risingwave_tpu_torch.frontend.pgwire
import risingwave_tpu_torch.common.config
import risingwave_tpu_torch.common.hash
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "risingwave_tpu" or m.startswith("risingwave_tpu."))
print(",".join(bad))
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_entry_points_default_to_the_card():
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.models.nexmark import build_q7
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from risingwave_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_q7(MemoryStateStore(), NexmarkConfig(event_num=100))
    assert resolve_device("cpu").type == "cpu"


def test_mesh_entry_points_default_to_the_card():
    """A ShardMesh, the sharded join and build_q8(mesh=...) without a
    device run on the card, and raise without one."""
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.models.nexmark import build_q8
    from risingwave_tpu_torch.parallel import ShardedJoinKernel, ShardMesh
    from risingwave_tpu_torch.state.store import MemoryStateStore

    if torch.cuda.is_available():
        assert ShardMesh(8).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardMesh(8)
    cfg = NexmarkConfig(event_num=100)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_q8(MemoryStateStore(), cfg, cfg, mesh=ShardMesh(8, "cpu"))
    assert ShardedJoinKernel(ShardMesh(8, "cpu"), 3).device.type == "cpu"


def test_tier_defaults_to_the_process_memory_context():
    """The port's tier reads the port's own memory context (a copy, not
    the reference's), and an agg with a tier cap builds its kernel on the
    card unless asked for the CPU."""
    from risingwave_tpu_torch.ops.hash_agg import AggKind
    from risingwave_tpu_torch.state import tier
    from risingwave_tpu_torch.utils import memory
    from risingwave_tpu_torch.stream.executors.hash_agg import (
        AggCall, HashAggExecutor,
    )
    from risingwave_tpu_torch.stream.executors.test_utils import MockSource
    from risingwave_tpu_torch.common.types import DataType, Schema

    assert tier.StateTier()._mem() is memory.GLOBAL
    assert memory.GLOBAL.soft_limit is None
    ex = HashAggExecutor(MockSource(Schema.of(g=DataType.INT64), []), [0],
                         [AggCall(AggKind.COUNT)], None, append_only=True,
                         tier_cap=4)
    if torch.cuda.is_available():
        assert ex.kernel.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex.kernel


def test_q5_and_q3_entry_points_default_to_the_card():
    """build_q5 and build_q3 without a device run on the card, and raise
    without one."""
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.models.nexmark import build_q5
    from risingwave_tpu_torch.models.tpch import build_q3
    from risingwave_tpu_torch.state.store import MemoryStateStore

    if torch.cuda.is_available():
        p = build_q3(MemoryStateStore(), customers=10, orders=100)
        agg = p.actor.consumer.input.input
        assert torch.device(agg._kern_kw["device"]).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_q5(MemoryStateStore(), NexmarkConfig(event_num=100))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_q3(MemoryStateStore(), customers=10, orders=100)
    p = build_q3(MemoryStateStore(), customers=10, orders=100, device="cpu")
    agg = p.actor.consumer.input.input
    assert torch.device(agg._kern_kw["device"]).type == "cpu"


def test_sql_frontend_defaults_to_the_card():
    """Frontend() without a device runs its MVs on the card, and raises
    without one; the planner and the rewrite's fused blocks take the
    session's device."""
    from risingwave_tpu_torch.frontend import Frontend
    from risingwave_tpu_torch.frontend.planner import StreamPlanner

    if torch.cuda.is_available():
        assert Frontend().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Frontend()
    fe = Frontend(device="cpu")
    assert fe.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamPlanner(fe.catalog, fe.store, fe.local, definition="")


def test_tables_and_chains_take_the_session_device():
    """With no card, Frontend() raises before any table or chain exists;
    on the CPU (asked for), an agg MV over a table and an MV over that
    MV both run their keyed executors on the session's device."""
    import asyncio

    from risingwave_tpu_torch.frontend import Frontend

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Frontend(rate_limit=2)

    async def run():
        fe = Frontend(device="cpu")
        await fe.execute("CREATE TABLE t (k BIGINT, v BIGINT)")
        await fe.execute("INSERT INTO t VALUES (1, 2), (1, 3)")
        await fe.execute("CREATE MATERIALIZED VIEW m AS SELECT k, "
                         "sum(v) AS s FROM t GROUP BY k")
        await fe.execute("CREATE MATERIALIZED VIEW m2 AS SELECT s, "
                         "count(*) AS n FROM m GROUP BY s")
        await fe.step(2)
        devs = []
        for name in ("m", "m2"):
            ex = fe.actors[fe.catalog.mvs[name].actor_id].consumer
            while type(ex).__name__ != "HashAggExecutor":
                ex = ex.input
            devs.append(torch.device(ex._kern_kw["device"]).type)
        rows = await fe.execute("SELECT * FROM m2")
        await fe.close()
        return devs, rows
    devs, rows = asyncio.run(run())
    assert devs == ["cpu", "cpu"] and rows == [(5, 1)]

