"""Consistent hashing: 256 virtual nodes, the row hash (B1).

Port of ``risingwave_tpu/common/hash.py``. The row hash is a seeded
boost-style combine folded through murmur3 fmix32 over the uint32 lanes
of each key column (f64 keys hash through their f32 image, -0.0 as 0.0);
vnode = hash & 255. Three copies of it live in the port, bit-identical to
the reference's ``hash_columns`` (:58):

- ``hash_columns_host`` / ``vnodes_of_host``: numpy, for host-side state
  partitioning (StateTable) — the reference's host twins (:86-134);
- ``hash_columns_plain``: plain PyTorch on any device, used by
  ``probe_insert``'s plain version;
- ``rw_hash_lanes`` in ``csrc/common.cuh``: the card's copy, run inside
  kernel K1 (``probe_insert``). The card never hashes on its own, so
  ``hash_columns`` on a CUDA tensor raises instead of running the plain
  version there.

Torch has no full uint32 arithmetic, so the plain version works in int64
masked to 32 bits: int64 products wrap mod 2^64, which keeps the low 32
bits exact.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

VNODE_BITS = 8
VNODE_COUNT = 1 << VNODE_BITS  # 256
HASH_SEED = 0x9E3779B9
_M32 = 0xFFFFFFFF


# -- host (numpy) twins ------------------------------------------------------

def _mix32_np(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x85EBCA6B)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(0xC2B2AE35)
        x = x ^ (x >> np.uint32(16))
    return x


def _to_u32_lanes_np(col: np.ndarray) -> List[np.ndarray]:
    dt = col.dtype
    if dt == np.bool_:
        return [col.astype(np.uint32)]
    if np.issubdtype(dt, np.floating):
        col = np.where(col == 0, np.zeros_like(col), col)
        return [col.astype(np.float32).view(np.uint32)]
    if dt.itemsize <= 4:
        return [col.astype(np.uint32)]
    u = col.astype(np.uint64)
    return [(u & np.uint64(_M32)).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32)]


def hash_columns_host(cols: Sequence[np.ndarray],
                      seed: int = HASH_SEED) -> np.ndarray:
    """Row hash of host columns → uint32 [n]."""
    assert len(cols) > 0
    n = cols[0].shape[0]
    h = np.full((n,), np.uint32(seed))
    with np.errstate(over="ignore"):
        for col in cols:
            for lane in _to_u32_lanes_np(np.asarray(col)):
                h = _mix32_np(h ^ (lane + np.uint32(0x9E3779B9) +
                                   (h << np.uint32(6)) + (h >> np.uint32(2))))
    return h


def vnodes_of_host(cols: Sequence[np.ndarray]) -> np.ndarray:
    return (hash_columns_host(cols) &
            np.uint32(VNODE_COUNT - 1)).astype(np.int32)


_STR_HASH_WIDTH = 16  # codepoints of prefix hashed (+ length)


def hash_strings_host(values: np.ndarray, n: int) -> np.ndarray:
    """Host-side stable hash for varchar key columns → uint32 [n]: the
    first 16 codepoints plus the exact length, Horner-folded (the
    reference's rule, so state-table vnodes agree)."""
    if n == 0:
        return np.zeros(len(values), dtype=np.uint32)
    vals = np.asarray(values[:n], dtype=object)
    null_mask = vals == None  # noqa: E711
    if null_mask.any():
        vals = vals.copy()
        vals[null_mask] = ""
    u = vals.astype(str)
    lengths = np.char.str_len(u).astype(np.uint32)
    w = _STR_HASH_WIDTH
    uw = np.ascontiguousarray(u.astype(f"U{w}"))
    mat = uw.view(np.uint32).reshape(n, w)
    h = lengths.copy()
    with np.errstate(over="ignore"):
        for j in range(w):
            h = h * np.uint32(31) + mat[:, j]
    h[null_mask] = 0
    out = np.zeros(len(values), dtype=np.uint32)
    out[:n] = h
    return out


# -- plain PyTorch version -----------------------------------------------------

def _mix32_plain(x: torch.Tensor) -> torch.Tensor:
    """fmix32 on int64 tensors holding values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def _to_u32_lanes_plain(col: torch.Tensor) -> List[torch.Tensor]:
    """A column → its uint32 lanes, each as int64 in [0, 2^32)."""
    if col.dtype == torch.bool:
        return [col.to(torch.int64)]
    if col.dtype.is_floating_point:
        col = torch.where(col == 0, torch.zeros_like(col), col)
        bits = col.to(torch.float32).view(torch.int32)
        return [bits.to(torch.int64) & _M32]
    if col.element_size() <= 4:
        return [col.to(torch.int64) & _M32]
    u = col.to(torch.int64)
    return [u & _M32, (u >> 32) & _M32]


def hash_columns_plain(cols: Sequence[torch.Tensor],
                       seed: int = HASH_SEED) -> torch.Tensor:
    """Row hash over key columns → int64 [n] holding the uint32 hash."""
    assert len(cols) > 0, "hash_columns needs at least one key column"
    n = cols[0].shape[0]
    h = torch.full((n,), seed, dtype=torch.int64, device=cols[0].device)
    for col in cols:
        for lane in _to_u32_lanes_plain(col):
            h = _mix32_plain(
                h ^ ((lane + 0x9E3779B9 + (h << 6) + (h >> 2)) & _M32))
    return h


def hash_lanes_plain(batch_keys: torch.Tensor) -> torch.Tensor:
    """Hash of int32[N, K] key lanes (``ops/hash_table.py:77``)."""
    return hash_columns_plain([batch_keys[:, i]
                               for i in range(batch_keys.shape[1])])


def hash_columns(cols: Sequence[torch.Tensor],
                 seed: int = HASH_SEED) -> torch.Tensor:
    """Row hash → int64 [n] holding the uint32 hash (``common/hash.py:58``).

    Runs the plain version for CPU tensors only: on the card the hash is
    part of kernel K1 (``ops.hash_table.probe_insert``)."""
    if any(c.device.type == "cuda" for c in cols):
        raise NotImplementedError(
            "on the card the row hash runs inside probe_insert (kernel "
            "K1); hash_columns takes CPU tensors")
    return hash_columns_plain(cols, seed)


def vnodes_of(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row → vnode in [0, 256) (``common/hash.py:75``)."""
    return (hash_columns(cols) & (VNODE_COUNT - 1)).to(torch.int32)


class VnodeMapping:
    """vnode → owner (actor or worker) mapping with rebalance support.

    Port of ``risingwave_tpu/common/hash.py``'s (:164) without its
    ``to_device`` (the hash dispatcher routes on the host). Reference
    parity: src/common/src/hash/consistent_hash/mapping.rs and the
    bitmap math in src/meta/src/stream/scale.rs:174. Stored dense:
    int32[256].
    """

    def __init__(self, owners: np.ndarray):
        owners = np.asarray(owners, dtype=np.int32)
        assert owners.shape == (VNODE_COUNT,)
        self.owners = owners

    @staticmethod
    def new_uniform(num_owners: int) -> "VnodeMapping":
        """Contiguous even split of 256 vnodes over `num_owners`."""
        assert num_owners >= 1
        base = VNODE_COUNT // num_owners
        rem = VNODE_COUNT % num_owners
        owners = np.repeat(np.arange(num_owners, dtype=np.int32),
                           np.asarray([base + (i < rem)
                                       for i in range(num_owners)]))
        return VnodeMapping(owners)

    def owner_of(self, vnode: int) -> int:
        return int(self.owners[vnode])

    def bitmap_of(self, owner: int) -> np.ndarray:
        """bool[256] ownership bitmap for one owner (state-table vnodes)."""
        return self.owners == owner

    def num_owners(self) -> int:
        return int(self.owners.max()) + 1 if len(self.owners) else 0

    def rebalance(self, new_num_owners: int) -> "VnodeMapping":
        """Minimal-movement rebalance to a new owner count.

        Mirrors rebalance_actor_vnode (scale.rs:174): move just enough
        vnodes from over-loaded owners to under-loaded ones.
        """
        target = [VNODE_COUNT // new_num_owners +
                  (i < VNODE_COUNT % new_num_owners)
                  for i in range(new_num_owners)]
        owners = self.owners.copy()
        # Clamp removed owners to -1 (to be redistributed).
        owners[owners >= new_num_owners] = -1
        counts = [int((owners == i).sum()) for i in range(new_num_owners)]
        surplus: List[int] = []  # vnode indices to reassign
        for i in range(new_num_owners):
            if counts[i] > target[i]:
                idxs = np.flatnonzero(owners == i)[: counts[i] - target[i]]
                surplus.extend(idxs.tolist())
        surplus.extend(np.flatnonzero(owners == -1).tolist())
        k = 0
        for i in range(new_num_owners):
            while counts[i] < target[i]:
                owners[surplus[k]] = i
                counts[i] += 1
                k += 1
        return VnodeMapping(owners)
