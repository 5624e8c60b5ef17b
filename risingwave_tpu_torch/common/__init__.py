"""Foundation: types, chunks, epochs, hashing, config."""

from risingwave_tpu_torch.common.config import (
    RwConfig, StorageConfig, StreamingConfig,
)

__all__ = ["RwConfig", "StreamingConfig", "StorageConfig"]
