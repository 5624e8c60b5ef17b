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
