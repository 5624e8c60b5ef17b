"""Layered configuration system.

Port of ``risingwave_tpu/common/config.py``, which imports nothing of its
package: the same dataclasses, defaults, TOML loader and override
validation. Reference parity: src/common/src/config.rs:133
(RwConfig{server, meta, batch, streaming, storage, system}) +
runtime-mutable SystemParams (src/common/src/system_param/). Python
re-design: frozen dataclasses with a TOML loader and override dicts;
SystemParams mutable + versioned for the meta notification channel.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ServerConfig:
    heartbeat_interval_ms: int = 1000
    connection_pool_size: int = 16
    metrics_level: int = 1


@dataclass
class MetaConfig:
    barrier_interval_ms: int = 1000          # system heartbeat (meta config)
    in_flight_barrier_nums: int = 10         # concurrent barrier window
    checkpoint_frequency: int = 1            # every Nth barrier is a checkpoint
    max_heartbeat_interval_secs: int = 300   # worker expiry
    enable_recovery: bool = True


@dataclass
class StreamingConfig:
    actor_runtime_worker_threads: Optional[int] = None
    # permit-based exchange budgets (exchange/permit.rs:35 analog)
    exchange_max_chunk_permits: int = 2048
    exchange_max_barrier_permits: int = 128
    exchange_rows_per_permit: int = 256
    # device chunk shaping
    chunk_capacity: int = 4096               # max rows per StreamChunk bucket
    hash_table_load_factor: float = 0.5
    unique_user_stream_errors: int = 10


@dataclass
class StorageConfig:
    shared_buffer_capacity_mb: int = 1024
    block_size_kb: int = 64
    bloom_false_positive: float = 0.001
    object_store_url: str = "memory://"
    sstable_size_mb: int = 256
    imm_merge_threshold: int = 4
    data_directory: str = "hummock_001"


@dataclass
class BatchConfig:
    worker_threads_num: Optional[int] = None
    chunk_size: int = 1024


@dataclass
class SystemParams:
    """Runtime-mutable cluster params, versioned (system_param/ analog)."""

    barrier_interval_ms: int = 1000
    checkpoint_frequency: int = 1
    sstable_size_mb: int = 256
    block_size_kb: int = 64
    bloom_false_positive: float = 0.001
    state_store: str = "hummock+memory://"
    data_directory: str = "hummock_001"
    parallel_compact_size_mb: int = 512
    version: int = 1

    def set(self, name: str, value: Any) -> "SystemParams":
        out = dataclasses.replace(self, **{name: value})
        out.version = self.version + 1
        return out


@dataclass
class RwConfig:
    """Top-level layered config (config.rs:133 RwConfig analog)."""

    server: ServerConfig = field(default_factory=ServerConfig)
    meta: MetaConfig = field(default_factory=MetaConfig)
    streaming: StreamingConfig = field(default_factory=StreamingConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    batch: BatchConfig = field(default_factory=BatchConfig)
    system: SystemParams = field(default_factory=SystemParams)

    @staticmethod
    def from_toml(path: str, overrides: Optional[Dict[str, Any]] = None
                  ) -> "RwConfig":
        try:
            import tomllib
        except ModuleNotFoundError:      # Python < 3.11
            import tomli as tomllib
        with open(path, "rb") as f:
            raw = tomllib.load(f)
        cfg = RwConfig()
        for section, cls_field in (
            ("server", "server"), ("meta", "meta"),
            ("streaming", "streaming"), ("storage", "storage"),
            ("batch", "batch"), ("system", "system"),
        ):
            if section in raw:
                cur = getattr(cfg, cls_field)
                known = {f.name for f in dataclasses.fields(cur)}
                for k, v in raw[section].items():
                    if k in known:
                        setattr(cur, k, v)
        for dotted, v in (overrides or {}).items():
            section, key = dotted.split(".", 1)
            target = getattr(cfg, section)
            known = {f.name for f in dataclasses.fields(target)}
            if key not in known:
                raise KeyError(f"unknown config key {dotted!r}; "
                               f"known: {sorted(known)}")
            setattr(target, key, v)
        return cfg
