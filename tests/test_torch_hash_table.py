"""probe_insert parity: the port's K1 (plain version here) against the
JAX reference (B1 + B2), bit for bit.

On the CPU the port runs K1's plain PyTorch version, which keeps the
reference's slot rule (the lowest row index wins a contested slot), so
keys, occupancy, slots and insert counts must be identical. The CUDA
kernel is held to the table invariants instead (tests/
test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.ops import hash_table as ref_ht
from risingwave_tpu_torch.ops import hash_table as port_ht
from risingwave_tpu_torch.ops import kernel_cases as KC

# Under pytest-xdist these tests share the host's cores with timing-bound
# tests on other workers (tests/test_chaos.py's 8 s barrier timeouts), so
# torch's intra-op pool stays small.
torch.set_num_threads(2)


def _both(cap, k, batches):
    """Run the same batches through both tables; return both states and
    the per-batch (slots, n_ins) pairs."""
    ref = ref_ht.make_state(cap, k)
    port = port_ht.make_state(cap, k, torch.device("cpu"))
    outs = []
    for keys, valid in batches:
        ref, r_slots, r_ins = ref_ht.probe_insert(
            ref, jnp.asarray(keys), jnp.asarray(valid))
        port, p_slots, p_stats = port_ht.probe_insert(
            port, torch.from_numpy(keys), torch.from_numpy(valid))
        outs.append((np.asarray(r_slots), int(r_ins),
                     p_slots.numpy(), p_stats.numpy()))
    return ref, port, outs


def _assert_same(ref, port, outs):
    np.testing.assert_array_equal(port.keys.numpy(), np.asarray(ref.keys))
    np.testing.assert_array_equal(port.occ.numpy() != 0, np.asarray(ref.occ))
    for r_slots, r_ins, p_slots, p_stats in outs:
        np.testing.assert_array_equal(p_slots, r_slots)
        assert int(p_stats[0]) == r_ins
        assert int(p_stats[1]) == 0


@pytest.mark.parametrize("case", ["duplicates", "invalid_rows",
                                  "near_max_load", "existing_keys"]
                         + [f"kernel_{c}" for c in KC.K1_CASES])
def test_probe_insert_matches_reference(case):
    """The port's own batches, and K1's edge cases from
    ``ops/kernel_cases.py`` (``kernel_*``: one key raced by 32K rows,
    every row new, duplicates across warps and blocks, a table just under
    MAX_LOAD, wrapping probes, interleaved invalid rows and all-zero
    keys, 1 and 6 lanes, no rows, rows that fill no block)."""
    if case.startswith("kernel_"):
        cap, batches = KC.k1_cases()[case[len("kernel_"):]]
        _assert_same(*_both(cap, batches[0][0].shape[1], batches))
        return
    rng = np.random.default_rng({"duplicates": 1, "invalid_rows": 2,
                                 "near_max_load": 3,
                                 "existing_keys": 4}[case])
    cap, k = 1024, 3
    if case == "duplicates":
        # few distinct keys, many repeats inside one batch
        base = rng.integers(-50, 50, (40, k)).astype(np.int32)
        keys = base[rng.integers(0, 40, 512)]
        batches = [(keys, np.ones(512, dtype=bool))]
    elif case == "invalid_rows":
        keys = rng.integers(-2**31, 2**31 - 1, (512, k)).astype(np.int32)
        batches = [(keys, rng.random(512) < 0.6)]
    elif case == "near_max_load":
        # fill to just under MAX_LOAD in three batches: long probe chains
        n = int(port_ht.MAX_LOAD * cap) - 1
        uniq = rng.permutation(1 << 20)[:n]
        keys = np.stack([uniq, uniq * 7, np.ones(n)], axis=1) \
            .astype(np.int32)
        parts = np.array_split(np.arange(n), 3)
        batches = [(keys[p], np.ones(len(p), dtype=bool)) for p in parts]
    else:
        keys = rng.integers(0, 300, (256, k)).astype(np.int32)
        again = np.concatenate([keys[:128], rng.integers(
            0, 300, (128, k)).astype(np.int32)])
        batches = [(keys, np.ones(256, dtype=bool)),
                   (again, np.ones(256, dtype=bool))]
    _assert_same(*_both(cap, k, batches))


@pytest.mark.parametrize("n_shards", KC.K1_SHARDS)
def test_probe_insert_sharded_plain_matches_reference(n_shards):
    """The shard axis of K1's plain version against the reference's
    probe_insert shard by shard (the sharded agg's per-shard probe), on
    ``kernel_cases``' sharded batches: every shard's table, slots and
    insert count."""
    cap, batches = KC.k1_sharded_case(n_shards)
    k = batches[0][0].shape[2]
    port = port_ht.make_state(cap, k, torch.device("cpu"))
    port = port_ht.TableState(port.keys[None].repeat(n_shards, 1, 1),
                              port.occ[None].repeat(n_shards, 1))
    refs = [ref_ht.make_state(cap, k) for _ in range(n_shards)]
    for keys, valid in batches:
        slots, stats = port_ht.probe_insert_sharded(
            port, torch.from_numpy(keys), torch.from_numpy(valid))
        for s in range(n_shards):
            refs[s], r_slots, r_ins = ref_ht.probe_insert(
                refs[s], jnp.asarray(keys[s]), jnp.asarray(valid[s]))
            np.testing.assert_array_equal(slots[s].numpy(),
                                          np.asarray(r_slots))
            assert stats[s].tolist() == [int(r_ins), 0]
    for s in range(n_shards):
        np.testing.assert_array_equal(port.keys[s].numpy(),
                                      np.asarray(refs[s].keys))
        np.testing.assert_array_equal(port.occ[s].numpy() != 0,
                                      np.asarray(refs[s].occ))


def test_probe_insert_overflow_sets_flag():
    """A full table cannot place a new key: the row gets -1 and the
    overflow flag is set (the reference would loop to its bound)."""
    cap, k = 1024, 1
    state = port_ht.make_state(cap, k, torch.device("cpu"))
    full = torch.arange(cap, dtype=torch.int32)[:, None]
    state, _slots, stats = port_ht.probe_insert(
        state, full, torch.ones(cap, dtype=torch.bool))
    assert stats.tolist() == [cap, 0]
    state, slots, stats = port_ht.probe_insert(
        state, torch.tensor([[cap + 5]], dtype=torch.int32),
        torch.ones(1, dtype=torch.bool))
    assert slots.tolist() == [-1] and stats.tolist() == [0, 1]


def test_device_hash_table_grows_like_reference():
    """DeviceHashTable growth: the rehashed table equals the
    reference's after the same inserts."""
    rng = np.random.default_rng(5)
    ref = ref_ht.DeviceHashTable(2)
    port = port_ht.DeviceHashTable(2, device="cpu")
    for _ in range(4):
        keys = rng.integers(-10**6, 10**6, (400, 2)).astype(np.int32)
        valid = np.ones(400, dtype=bool)
        r = np.asarray(ref.probe_insert(jnp.asarray(keys),
                                        jnp.asarray(valid)))
        p = port.probe_insert(torch.from_numpy(keys),
                              torch.from_numpy(valid)).numpy()
        np.testing.assert_array_equal(p, r)
    assert port.capacity == ref.capacity > port_ht.MIN_CAPACITY
    np.testing.assert_array_equal(port.state.keys.numpy(),
                                  np.asarray(ref.state.keys))
    assert port.sync_count() == ref.sync_count()
