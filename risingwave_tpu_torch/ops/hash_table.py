"""Device-resident open-addressing hash table of int32 key lanes.

Port of ``risingwave_tpu/ops/hash_table.py``. State is a pair of tensors,
``keys: int32[cap, K]`` and ``occ: int32[cap]`` (0 empty, 1 occupied; the
reference's ``bool[cap]``, widened so the CUDA kernel can claim a slot
with ``atomicCAS``). Capacity is a power of two; probing is linear with
stride 1; deletion is logical (slots are reclaimed by a rebuild).

``probe_insert`` is kernel K1 (``csrc/probe_insert.cu``) on a CUDA tensor
and its plain PyTorch version on a CPU tensor; ``probe_insert_sharded``
launches the same kernel over S independent tables with a leading shard
axis (the vnode-sharded agg, ``parallel/agg.py``). ``lookup`` (the read-only
probe, B3) is kernel K8 (``rw_lookup`` in ``csrc/probe_insert.cu``), which
the agg's cold-tier eviction (B9) launches; the join's probe runs its own
copy of the probe inside K6 (``csrc/join_probe.cu``). Where the reference
donates the state to a pure function (``donate_argnums=(0,)``), the port
updates ``keys`` and ``occ`` in place.

Slot assignment: the plain version keeps the reference's rule exactly
(claim rounds in which the LOWEST row index wins a contested slot, by
``scatter_reduce(amin)``), so on the CPU the port's tables are bit-for-bit
the reference's. The CUDA kernel lets the first atomicCAS win instead; it
is held to the table invariants, not to the reference's slot numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from risingwave_tpu_torch.common.hash import hash_lanes_plain
from risingwave_tpu_torch.ops import cuda
from risingwave_tpu_torch.utils.device import (
    LAUNCHES, PendingCounters, resolve_device,
)

MAX_LOAD = 0.70          # grow when the occupancy upper bound crosses this
MIN_CAPACITY = 1 << 10


class TableState(NamedTuple):
    """Hash-table state (device tensors, updated in place)."""

    keys: torch.Tensor    # int32[cap, K]
    occ: torch.Tensor     # int32[cap]

    @property
    def capacity(self) -> int:
        return int(self.keys.shape[0])

    @property
    def key_width(self) -> int:
        return int(self.keys.shape[1])


def make_state(capacity: int, key_width: int,
               device: torch.device) -> TableState:
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    return TableState(
        keys=torch.zeros((capacity, key_width), dtype=torch.int32,
                         device=device),
        occ=torch.zeros((capacity,), dtype=torch.int32, device=device),
    )


def probe_insert_plain(state: TableState, batch_keys: torch.Tensor,
                       valid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: the reference's claim-round loop
    (``hash_table.py:88``), step for step. Returns (slots int32[N],
    stats int32[2] = [n_inserted, overflow])."""
    keys, occ = state
    cap = keys.shape[0]
    mask = cap - 1
    n = batch_keys.shape[0]
    dev = batch_keys.device
    bk = batch_keys.to(torch.int32)
    row_ids = torch.arange(n, dtype=torch.int64, device=dev)
    slot = hash_lanes_plain(bk) & mask
    valid_b = valid.to(torch.bool)
    done = ~valid_b
    occ_b = occ != 0
    ins = 0
    steps = 0

    def match(s):
        return occ_b[s] & (keys[s] == bk).all(dim=1)

    while not bool(done.all()) and steps < cap:
        done = done | match(slot)
        want = ~done & ~occ_b[slot]
        claim_idx = torch.where(want, slot, cap)
        claim = torch.full((cap + 1,), n, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, claim_idx, row_ids, reduce="amin",
                              include_self=True)
        won = want & (claim[slot] == row_ids)
        won_slots = slot[won]
        keys[won_slots] = bk[won]
        occ_b[won_slots] = True
        ins += int(won.sum())
        done = done | match(slot)
        slot = torch.where(done, slot, (slot + 1) & mask)
        steps += 1
    occ.copy_(occ_b.to(torch.int32))
    # a row left unplaced (overflow) gets -1, like the kernel's
    overflow = int(not bool(done.all()))
    slots = torch.where(valid_b & done, slot, -1).to(torch.int32)
    stats = torch.tensor([ins, overflow], dtype=torch.int32, device=dev)
    return slots, stats


def probe_insert(state: TableState, batch_keys: torch.Tensor,
                 valid: torch.Tensor
                 ) -> Tuple[TableState, torch.Tensor, torch.Tensor]:
    """Find-or-insert every valid row of the batch (kernel K1).

    ``batch_keys`` is int32[N, K] with contiguous lanes (any row stride,
    so a column slice of a packed batch needs no copy); ``valid`` is
    int32 or bool [N] with any stride. Returns (state, slots int32[N],
    stats int32[2]): rows with ``valid == 0`` get slot -1; stats holds
    the insert count and an overflow flag (a row found no slot within
    ``cap`` steps — the load-factor contract was broken; callers turn it
    into an error, see ``PendingCounters``)."""
    if batch_keys.device.type != "cuda":
        slots, stats = probe_insert_plain(state, batch_keys, valid)
        return state, slots, stats
    keys, occ = state
    slots, stats = _probe_insert_cuda(keys[None], occ[None], batch_keys[None],
                                      valid[None])
    return state, slots[0], stats[0]


def probe_insert_sharded_plain(state: TableState, batch_keys: torch.Tensor,
                               valid: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the sharded K1: the single-table plain
    version on each shard's table and batch in turn."""
    keys, occ = state
    out = [probe_insert_plain(TableState(keys[s], occ[s]), batch_keys[s],
                              valid[s]) for s in range(keys.shape[0])]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


def probe_insert_sharded(state: TableState, batch_keys: torch.Tensor,
                         valid: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 over S independent tables in one launch (the per-shard probe of
    ``risingwave_tpu/parallel/agg.py:304``): ``state`` holds keys
    int32[S, cap, K] and occ int32[S, cap], ``batch_keys`` int32[S, N, K]
    (contiguous lanes, any row and shard strides) and ``valid`` [S, N].
    Shard s probes only its own table. Returns (slots int32[S, N], stats
    int32[S, 2])."""
    if batch_keys.device.type != "cuda":
        return probe_insert_sharded_plain(state, batch_keys, valid)
    return _probe_insert_cuda(state.keys, state.occ, batch_keys, valid)


def _probe_insert_cuda(keys: torch.Tensor, occ: torch.Tensor,
                       batch_keys: torch.Tensor, valid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    s, n, k = batch_keys.shape
    if batch_keys.dtype != torch.int32 or valid.dtype not in (
            torch.int32, torch.bool):
        raise TypeError("probe_insert takes int32 key lanes and an "
                        "int32/bool valid mask")
    if k != keys.shape[2] or valid.shape != (s, n) or \
            keys.shape[0] != s or occ.shape != keys.shape[:2]:
        raise ValueError(f"shape mismatch: batch {tuple(batch_keys.shape)}"
                         f", valid {tuple(valid.shape)}, table "
                         f"{tuple(keys.shape)}")
    if batch_keys.stride(2) != 1 or not keys.is_contiguous() or \
            not occ.is_contiguous():
        raise ValueError("probe_insert needs contiguous key lanes")
    if not (keys.device == occ.device == batch_keys.device ==
            valid.device):
        raise ValueError("probe_insert tensors must share one device")
    if valid.dtype == torch.bool:
        valid = valid.to(torch.int32)
    slots = torch.empty((s, n), dtype=torch.int32, device=keys.device)
    stats = torch.empty((s, 2), dtype=torch.int32, device=keys.device)
    cuda.call("probe_insert", "rw_probe_insert",
              batch_keys.data_ptr(), batch_keys.stride(1),
              batch_keys.stride(0), valid.data_ptr(), valid.stride(1),
              valid.stride(0), n, k, keys.data_ptr(), occ.data_ptr(),
              keys.shape[1], s, slots.data_ptr(), stats.data_ptr())
    if n:
        LAUNCHES.add("probe_insert")
    return slots, stats


def lookup_plain(state: TableState, batch_keys: torch.Tensor,
                 valid: torch.Tensor, dropped: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K8 ``lookup`` (``hash_table.py:137``): the
    reference's loop, step for step. Returns (slots int32[N], stats
    int32[2] = [0, overflow]): -1 for absent or invalid rows; overflow
    is set when a row ran ``cap`` steps without meeting its key or an
    empty slot (a full table: the load-factor contract was broken). With
    ``dropped`` (int32[cap]), found slots are set to 1 in it."""
    keys, occ = state
    cap = keys.shape[0]
    mask = cap - 1
    bk = batch_keys.to(torch.int32)
    slot = hash_lanes_plain(bk) & mask
    valid_b = valid.to(torch.bool)
    done = ~valid_b
    found = torch.zeros_like(valid_b)
    occ_b = occ != 0
    steps = 0
    while not bool(done.all()) and steps < cap:
        m = occ_b[slot] & (keys[slot] == bk).all(dim=1)
        empty = ~occ_b[slot]
        found = found | (~done & m)
        done = done | m | empty
        slot = torch.where(done, slot, (slot + 1) & mask)
        steps += 1
    overflow = int(not bool(done.all()))
    slots = torch.where(valid_b & found, slot, -1).to(torch.int32)
    if dropped is not None:
        dropped[slots[slots >= 0].to(torch.int64)] = 1
    stats = torch.tensor([0, overflow], dtype=torch.int32,
                         device=batch_keys.device)
    return slots, stats


def lookup(state: TableState, batch_keys: torch.Tensor,
           valid: torch.Tensor, dropped: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K8: slots of existing keys, -1 for absent or invalid rows;
    the table is read only (B3). ``batch_keys`` int32[N, K] (contiguous
    lanes, any row stride), ``valid`` int32 or bool [N]. With ``dropped``
    (int32[cap]), each found slot is also set to 1 there (the eviction
    mask of B9). Returns (slots int32[N], stats int32[2] = [0,
    overflow]); callers check the overflow flag lazily
    (``PendingCounters.watch``), as K1's."""
    if batch_keys.device.type != "cuda":
        return lookup_plain(state, batch_keys, valid, dropped)
    keys, occ = state
    n, k = batch_keys.shape
    if batch_keys.dtype != torch.int32 or valid.dtype not in (
            torch.int32, torch.bool):
        raise TypeError("lookup takes int32 key lanes and an int32/bool "
                        "valid mask")
    if k != keys.shape[1] or valid.shape != (n,):
        raise ValueError(f"shape mismatch: batch {tuple(batch_keys.shape)}"
                         f", valid {tuple(valid.shape)}, table "
                         f"{tuple(keys.shape)}")
    if batch_keys.stride(1) != 1 or not keys.is_contiguous() or \
            not occ.is_contiguous():
        raise ValueError("lookup needs contiguous key lanes")
    if dropped is not None and (dropped.dtype != torch.int32
                                or dropped.shape != occ.shape
                                or not dropped.is_contiguous()):
        raise ValueError("dropped must be a contiguous int32[cap]")
    if not all(t.device == keys.device for t in (
            occ, batch_keys, valid,
            *(() if dropped is None else (dropped,)))):
        raise ValueError("lookup tensors must share one device")
    if valid.dtype == torch.bool:
        valid = valid.to(torch.int32)
    slots = torch.empty(n, dtype=torch.int32, device=keys.device)
    stats = torch.empty(2, dtype=torch.int32, device=keys.device)
    cuda.call("probe_insert", "rw_lookup", batch_keys.data_ptr(),
              batch_keys.stride(0), valid.data_ptr(), valid.stride(0), n, k,
              keys.data_ptr(), occ.data_ptr(), keys.shape[0],
              slots.data_ptr(), stats.data_ptr(),
              None if dropped is None else dropped.data_ptr())
    if n:
        LAUNCHES.add("lookup")
    return slots, stats


class DeviceHashTable:
    """Host wrapper: owns growth scheduling and the sync-free load bound.

    ``probe_insert`` never waits on the device; occupancy is tracked as
    an upper bound (each batch inserts at most its row count) that
    ``sync_count()`` collapses to the exact count."""

    def __init__(self, key_width: int, capacity: int = MIN_CAPACITY,
                 device=None):
        self.device = resolve_device(device)
        self.state = make_state(max(capacity, MIN_CAPACITY), key_width,
                                self.device)
        self._counters = PendingCounters()
        self._on_grow: list = []

    @property
    def capacity(self) -> int:
        return self.state.capacity

    def probe_insert(self, batch_keys: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
        n = int(batch_keys.shape[0])
        self.reserve(n)
        self.state, slots, stats = probe_insert(self.state, batch_keys,
                                                valid)
        self._counters.push(stats, n)
        return slots

    def reserve(self, n: int) -> bool:
        """Grow (rehash) until `n` more insertions respect MAX_LOAD.
        Returns True if a rehash happened (earlier slots are invalid —
        callers that cache slots subscribe via on_grow)."""
        grew = False
        self._counters.drain_ready()
        while self._counters.bound() + n > MAX_LOAD * self.capacity:
            if self._counters.pending_rows():
                self.sync_count()
                if self._counters.bound() + n <= MAX_LOAD * self.capacity:
                    break
            self._grow()
            grew = True
        return grew

    def _grow(self) -> None:
        old = self.state
        new = make_state(old.capacity * 2, old.key_width, self.device)
        new, slots, stats = probe_insert(new, old.keys, old.occ)
        self._counters.watch(stats)
        self.state = new
        for hook in self._on_grow:
            hook(slots, old.capacity)

    def on_grow(self, hook) -> None:
        """Register `hook(old_to_new_slots, old_capacity)` called on rehash."""
        self._on_grow.append(hook)

    def sync_count(self) -> int:
        """Collapse the occupancy bound to the exact device count."""
        return self._counters.drain_all()
