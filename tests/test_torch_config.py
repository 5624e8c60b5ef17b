"""The port's ``RwConfig`` against the reference's.

Twins of ``tests/test_common.py:135`` (defaults, a TOML file and dotted
overrides, ``SystemParams.set`` bumping its version) and :246 (an
unknown override key raises ``KeyError``), plus the exports of
``risingwave_tpu_torch.common`` that the reference's
``risingwave_tpu.common`` has.
"""

import dataclasses

import pytest

from risingwave_tpu.common import config as r_config
from risingwave_tpu_torch.common import config as p_config


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


def test_config_defaults_and_toml_twin(tmp_path):
    """:135 — the same defaults, the same TOML sections read (an unknown
    key in a section is skipped), the same overrides applied."""
    assert _as_dict(p_config.RwConfig()) == _as_dict(r_config.RwConfig())
    toml = tmp_path / "rw.toml"
    toml.write_text("[meta]\nbarrier_interval_ms = 250\n"
                    "[streaming]\nchunk_capacity = 1024\nnot_a_key = 1\n"
                    "[storage]\nobject_store_url = 'memory://x'\n"
                    "[unknown_section]\na = 1\n")
    over = {"meta.checkpoint_frequency": 5, "batch.chunk_size": 7}
    p = p_config.RwConfig.from_toml(str(toml), overrides=over)
    r = r_config.RwConfig.from_toml(str(toml), overrides=over)
    assert _as_dict(p) == _as_dict(r)
    assert p.meta.barrier_interval_ms == 250
    assert p.streaming.chunk_capacity == 1024
    assert p.meta.checkpoint_frequency == 5
    assert not hasattr(p.streaming, "not_a_key")
    sp2 = p.system.set("checkpoint_frequency", 10)
    assert sp2.version == p.system.version + 1
    assert _as_dict(sp2) == _as_dict(r.system.set("checkpoint_frequency",
                                                  10))


@pytest.mark.parametrize("key", ["meta.barier_interval_ms",
                                 "streaming.nope", "system.versions"])
def test_config_override_validation_twin(tmp_path, key):
    """:246 — an unknown override key raises KeyError naming it and the
    known keys, as the reference's does."""
    toml = tmp_path / "rw.toml"
    toml.write_text("")
    errs = []
    for mod in (p_config, r_config):
        with pytest.raises(KeyError) as ei:
            mod.RwConfig.from_toml(str(toml), overrides={key: 1})
        errs.append(str(ei.value))
    assert errs[0] == errs[1] and key in errs[0]


def test_common_exports_the_config():
    """risingwave_tpu_torch.common exports RwConfig, StreamingConfig and
    StorageConfig, as the reference's common package does."""
    import risingwave_tpu.common as r_common
    import risingwave_tpu_torch.common as p_common

    for name in ("RwConfig", "StreamingConfig", "StorageConfig"):
        assert getattr(p_common, name) is getattr(p_config, name)
        assert hasattr(r_common, name)
