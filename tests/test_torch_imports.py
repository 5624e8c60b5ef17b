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
import risingwave_tpu_torch.stream.executors.test_utils
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
