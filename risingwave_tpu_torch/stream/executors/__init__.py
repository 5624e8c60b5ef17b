"""Stream operator executors.

Each module ports one executor family of ``risingwave_tpu/stream/
executors`` (reference parity: src/stream/src/executor/*); see the
module docstrings for file:line parity.
"""

from risingwave_tpu_torch.stream.executors.simple import (
    FilterExecutor, ProjectExecutor, ReceiverExecutor,
)
from risingwave_tpu_torch.stream.executors.materialize import (
    MaterializeExecutor,
)
from risingwave_tpu_torch.stream.executors.test_utils import MockSource

__all__ = [
    "FilterExecutor", "ProjectExecutor", "ReceiverExecutor",
    "MaterializeExecutor", "MockSource",
]
