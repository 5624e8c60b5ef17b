"""The hash exchange of the vnode-sharded operators: rows route by
hash(key lanes) → vnode → owning shard.

Port of ``risingwave_tpu/parallel/exchange.py``. The reference packs each
shard's rows into per-target buckets (``bucketize_by_owner``, :72) and an
``all_to_all`` transposes them (``exchange``, :104). On one card the
shards are a leading axis of one tensor, so both are one layout step:
``route`` writes each valid row straight into its receiving shard's block
of ``recv[S, S * bucket, W]``, sender-major inside each shard and in input
order inside each bucket, with zeros in the unused rows. That is the
reference's receive buffer exactly. ``route`` launches the hand-written
kernel (``csrc/route.cu``) on a CUDA tensor and runs ``route_plain`` on a
CPU tensor.

The bucket bounds rows per (sender, target) pair. The default (the
sender's whole block) cannot overflow; a smaller one sets the sender's
overflow flag when a bucket fills, and the rows that fit are still
routed (the caller raises once the step has applied them).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from risingwave_tpu_torch.common.chunk import next_pow2
from risingwave_tpu_torch.common.hash import (
    VNODE_COUNT, hash_columns_host, hash_lanes_plain,
)
from risingwave_tpu_torch.ops import cuda
from risingwave_tpu_torch.utils.device import LAUNCHES


def vnodes_from_lanes(key_lanes: torch.Tensor) -> torch.Tensor:
    """int32 vnode in [0, 256) of int32[N, K] key lanes (B1's row hash,
    ``exchange.py:31``; plain version: on the card the hash runs inside
    ``route`` and K1)."""
    return (hash_lanes_plain(key_lanes) & (VNODE_COUNT - 1)).to(torch.int32)


def owners_host(key_lanes: np.ndarray,
                owner_map_host: np.ndarray) -> np.ndarray:
    """Host twin of the device routing (same hash → same owner,
    ``exchange.py:41``): the one copy the sharded kernel uses for its
    capacity guards and the skew-exact bucket."""
    lanes = np.asarray(key_lanes)
    h = hash_columns_host([lanes[:, i] for i in range(lanes.shape[1])])
    return owner_map_host[(h & np.uint32(VNODE_COUNT - 1)).astype(np.int64)]


def skew_bucket(owner: np.ndarray, mask: np.ndarray, n_dev: int,
                local: int) -> int:
    """Skew-exact per-(sender, target) bound for one batch of
    ``n_dev * local`` rows (``exchange.py:54``): the largest bucket any
    sender fills, pow2-quantized and clamped to [local / n_dev, local],
    so overflow stays impossible."""
    worst = 1
    for s in range(n_dev):
        sl = owner[s * local:(s + 1) * local]
        sl = sl[mask[s * local:(s + 1) * local]]
        if len(sl):
            worst = max(worst, int(np.bincount(
                sl, minlength=n_dev).max()))
    return min(local, max(local // n_dev, next_pow2(worst)))


def _check(rows: torch.Tensor, valid: torch.Tensor, owner_map: torch.Tensor,
           n_shards: int, bucket: int, kw: int) -> int:
    n, w = rows.shape
    if rows.dtype != torch.int32 or owner_map.dtype != torch.int32 or \
            valid.dtype not in (torch.int32, torch.bool):
        raise TypeError("route takes int32 rows and owner map, an int32 or "
                        "bool valid mask")
    if not 1 <= n_shards <= VNODE_COUNT or n % n_shards or \
            valid.shape != (n,) or owner_map.shape != (VNODE_COUNT,) or \
            not 0 < kw <= w or bucket < 0:
        raise ValueError(f"route: {n} rows of width {w} in {n_shards} "
                         f"blocks, valid {tuple(valid.shape)}, owner map "
                         f"{tuple(owner_map.shape)}, kw {kw}, bucket "
                         f"{bucket}")
    return n // n_shards


def route_plain(rows: torch.Tensor, valid: torch.Tensor,
                owner_map: torch.Tensor, n_shards: int, bucket: int,
                kw: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``route``: the reference's one-hot cumsum
    positions per sender block (``bucketize_by_owner``), then the
    all_to_all's layout."""
    local = _check(rows, valid, owner_map, n_shards, bucket, kw)
    n, w = rows.shape
    dev = rows.device
    v = (valid != 0).view(n_shards, local)
    owner = owner_map[vnodes_from_lanes(rows[:, :kw]).to(torch.int64)]
    owner = owner.to(torch.int64).view(n_shards, local)
    onehot = (owner[:, :, None] == torch.arange(n_shards, device=dev)) \
        & v[:, :, None]
    pos = torch.cumsum(onehot.to(torch.int64), dim=1) - 1
    row_pos = torch.where(onehot, pos, 0).sum(dim=2)
    fits = v & (row_pos < bucket)
    sender = torch.arange(n_shards, device=dev)[:, None]
    dest = owner * (n_shards * bucket) + sender * bucket + row_pos
    m = n_shards * n_shards * bucket
    recv = torch.zeros((m, w), dtype=torch.int32, device=dev)
    rvalid = torch.zeros(m, dtype=torch.int32, device=dev)
    d = dest[fits]
    recv[d] = rows.view(n_shards, local, w)[fits]
    rvalid[d] = 1
    overflow = (v & ~fits).any(dim=1).to(torch.int32)
    return (recv.view(n_shards, n_shards * bucket, w),
            rvalid.view(n_shards, n_shards * bucket), overflow)


def route(rows: torch.Tensor, valid: torch.Tensor, owner_map: torch.Tensor,
          n_shards: int, bucket: int, kw: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The exchange of one step: ``rows`` int32[S * local, W] (contiguous
    lanes, any row stride) in S sender blocks, ``valid`` [S * local] (any
    stride), ``owner_map`` int32[256]. Each valid row's owner is the B1
    hash of its first ``kw`` lanes, & 255, through the owner map. Returns
    (recv int32[S, S * bucket, W], rvalid int32[S, S * bucket], overflow
    int32[S] per sender)."""
    if rows.device.type != "cuda":
        return route_plain(rows, valid, owner_map, n_shards, bucket, kw)
    local = _check(rows, valid, owner_map, n_shards, bucket, kw)
    n, w = rows.shape
    if (n and rows.stride(1) != 1) or not owner_map.is_contiguous():
        raise ValueError("route needs contiguous lanes and owner map")
    if not rows.device == valid.device == owner_map.device:
        raise ValueError("route tensors must share one device")
    if valid.dtype == torch.bool:
        valid = valid.to(torch.int32)
    dev = rows.device
    i32 = dict(dtype=torch.int32, device=dev)
    own = torch.empty(n, **i32)
    # the kernel's tile counts, sized for its most tiles a sender (64)
    counts = torch.empty(n_shards * 64 * n_shards, **i32)
    m = n_shards * bucket
    recv = torch.empty((n_shards, m, w), **i32)
    rvalid = torch.empty((n_shards, m), **i32)
    overflow = torch.empty(n_shards, **i32)
    cuda.call("route", "rw_route", rows.data_ptr(), rows.stride(0),
              valid.data_ptr(), valid.stride(0), n_shards, local, kw, w,
              owner_map.data_ptr(), bucket, own.data_ptr(),
              counts.data_ptr(), recv.data_ptr(),
              rvalid.data_ptr(), overflow.data_ptr())
    LAUNCHES.add("route")
    return recv, rvalid, overflow


def bound_bytes(n_rows: int, w: int, n_shards: int, bucket: int) -> int:
    """Bytes ``route`` must move: its rows and valid flags read once, the
    receive buffer, its flags and the overflow flags written once (the
    byte bound a timing divides by the card's memory rate)."""
    m = n_shards * n_shards * bucket
    return n_rows * (w + 1) * 4 + m * (w + 1) * 4 + n_shards * 4
