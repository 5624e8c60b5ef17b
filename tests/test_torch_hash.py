"""Row hash parity: the PyTorch port against the JAX reference (B1).

``hash_columns`` / ``vnodes_of`` of ``risingwave_tpu_torch.common.hash``
must give the reference's bits for every key dtype, including the
f64-through-f32 rule and -0.0 hashing as 0.0; so must the port's numpy
host twin, which state tables use for vnode placement. Inputs are made
from a seed with numpy and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common import hash as ref_hash
from risingwave_tpu_torch.common import hash as port_hash

# Under pytest-xdist these tests share the host's cores with timing-bound
# tests on other workers (tests/test_chaos.py's 8 s barrier timeouts), so
# torch's intra-op pool stays small.
torch.set_num_threads(2)

N = 2048


def _column(dtype: str, rng: np.random.Generator) -> np.ndarray:
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, N, dtype=np.int64) \
            .astype(np.int32)
    if dtype == "int64":
        return rng.integers(-2**63, 2**63 - 1, N, dtype=np.int64)
    if dtype == "bool":
        return rng.random(N) < 0.5
    if dtype == "float32":
        v = rng.standard_normal(N).astype(np.float32)
        v[:4] = [0.0, -0.0, np.inf, -np.inf]
        return v
    v = rng.standard_normal(N) * 1e6
    v[:4] = [0.0, -0.0, 1.0 + 2**-40, 1.0]     # nearby doubles share f32
    return v


@pytest.mark.parametrize("dtype", ["int32", "int64", "bool", "float32",
                                   "float64"])
def test_hash_columns_single_dtype(dtype):
    col = _column(dtype, np.random.default_rng(7))
    want = np.asarray(ref_hash.hash_columns([jnp.asarray(col)])) \
        .astype(np.int64)
    got = port_hash.hash_columns([torch.from_numpy(col)]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port_hash.vnodes_of([torch.from_numpy(col)]).numpy(),
        np.asarray(ref_hash.vnodes_of([jnp.asarray(col)])))
    np.testing.assert_array_equal(
        port_hash.hash_columns_host([col]).astype(np.int64), want)


def test_hash_columns_multi_column_and_host_twin():
    rng = np.random.default_rng(11)
    cols = [_column(d, rng) for d in
            ("int64", "int32", "bool", "float32", "float64")]
    want = np.asarray(ref_hash.hash_columns(
        [jnp.asarray(c) for c in cols])).astype(np.int64)
    got = port_hash.hash_columns([torch.from_numpy(c) for c in cols])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        port_hash.vnodes_of_host(cols), ref_hash.vnodes_of_host(cols))
    strs = np.asarray(["a", None, "", "αβγ" * 9, "x\x00y"], dtype=object)
    np.testing.assert_array_equal(
        port_hash.hash_strings_host(strs, 4),
        ref_hash.hash_strings_host(strs, 4))


def test_float_keys_hash_through_f32():
    """Nearby doubles share an f32 image and so a hash (the reference's
    rule); -0.0 and 0.0 hash alike."""
    v = torch.tensor([1.0, 1.0 + 2**-40, 0.0, -0.0], dtype=torch.float64)
    h = port_hash.hash_columns([v]).numpy()
    assert h[0] == h[1] and h[2] == h[3]


def test_deviation_f32_subnormal_key_hashes_its_bits():
    """Declared deviation (ROADMAP.md queue C): an f32 subnormal key
    hashes its own bits on the port, as the reference's numpy twin
    ``hash_columns_host`` does; the reference's jitted ``hash_columns``
    on XLA:CPU reads it as 0.0 (flush to zero). No executor reaches the
    jitted float hash (device paths hash int32 lanes)."""
    col = np.asarray([1e-40, -1e-40, 0.0, 1.0], dtype=np.float32)
    got = port_hash.hash_columns([torch.from_numpy(col)]).numpy()
    bits = np.asarray(ref_hash.hash_columns_host([col])).astype(np.int64)
    np.testing.assert_array_equal(got, bits)
    np.testing.assert_array_equal(
        port_hash.hash_columns_host([col]).astype(np.int64), bits)
    assert got[0] != got[2] and got[1] != got[2]
    traced = np.asarray(ref_hash.hash_columns([jnp.asarray(col)]))
    assert traced[0] == traced[2]        # the reference's flush
