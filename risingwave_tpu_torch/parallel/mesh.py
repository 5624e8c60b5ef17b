"""Logical shards on one card: the port's stand-in for the reference's
``jax.sharding.Mesh`` (``risingwave_tpu/parallel/agg.py``).

A ``ShardMesh`` is ``n_shards`` logical shards on one device. Sharded
operators keep their state with a leading shard axis, and the hash
exchange is a layout on the device (``exchange.route``). Each shard owns a
contiguous range of the 256 vnodes; when the shard count does not divide
256, the last shard also takes the remainder (``agg.py:190-196``).
"""

from __future__ import annotations

import numpy as np

from risingwave_tpu_torch.common.hash import VNODE_COUNT
from risingwave_tpu_torch.utils.device import resolve_device


def contiguous_owner_map(n_shards: int) -> np.ndarray:
    """int32[256] vnode → owning shard: an even contiguous split, the
    remainder on the last shard."""
    if not 1 <= n_shards <= VNODE_COUNT:
        raise ValueError(f"{n_shards} shards: 1 to {VNODE_COUNT} allowed")
    owners = np.repeat(np.arange(n_shards, dtype=np.int32),
                       VNODE_COUNT // n_shards)
    pad = VNODE_COUNT - len(owners)
    if pad:
        owners = np.concatenate(
            [owners, np.full(pad, n_shards - 1, np.int32)])
    return owners


class ShardMesh:
    """``n_shards`` logical shards on one device (``None``: the card;
    ``"cpu"`` runs the kernels' plain versions)."""

    def __init__(self, n_shards: int, device=None):
        contiguous_owner_map(n_shards)          # range check
        self.n_shards = int(n_shards)
        self.device = resolve_device(device)

    def owner_map(self) -> np.ndarray:
        return contiguous_owner_map(self.n_shards)
