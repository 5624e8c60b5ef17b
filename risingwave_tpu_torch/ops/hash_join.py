"""Device-resident join-side state (the q8 kernel's matcher).

Port of the single-device half of ``risingwave_tpu/ops/hash_join.py``
(reference parity: JoinHashMap, src/stream/src/executor/managed_state/
join/mod.rs:228, and the probe loop of hash_join.rs:990). The device owns
the MATCH structure; row payloads of host-typed columns stay in host
arenas (stream/executors/hash_join.py):

    table    DeviceHashTable   join-key lanes → key slot
    head     int32[cap]        key slot → first row ref (-1 end)
    next     int32[row_cap]    row ref → next row ref in its key chain
    ins_seq  int32[row_cap]    message sequence that inserted the row
    del_seq  int32[row_cap]    message sequence that deleted it (MAX=∞)
    pay      int32[row_cap,P]  payload lanes of the stored rows
    deg      int32[row_cap]    per-ref match degree (outer/semi/anti)

SEQUENCE-VERSIONED state: every message carries a monotone sequence
number, and a probe at sequence s sees exactly the rows with
``ins_seq < s <= del_seq``, so a whole epoch's inserts, tombstones and
probes each run as one batched dispatch, and a probe whose pair buffer
overflowed is re-dispatched to the same result.

Kernels (each wrapper launches its CUDA kernel on a CUDA tensor and runs
the plain PyTorch version beside it on a CPU tensor; nothing falls back):

    K5 join_apply   csrc/join_apply.cu   link_rows (B11), tombstone_rows
                                         (B12), epoch_apply's rest (B14)
    K6 join_probe   csrc/join_probe.cu   epoch_probe (B15) with lookup
                                         (B3) inside, probe_pairs (B13)
    K7 join_maint   csrc/join_maint.cu   _masked_scatter, _rebase (B17)
    K4 remap        csrc/rebuild.cu      _remap_head (B17) on growth

K5 and K6 also take a leading shard axis (``join_apply_sharded``,
``join_probe_sharded``: one launch serves every shard of the
vnode-sharded join, ``parallel/join.py``; one device is S = 1). The
per-chunk step ``apply_and_probe`` (B16) is the launch sequence K6, K1,
K5.

Where the reference donates state to a pure function, the port updates
it in place. The degree arrays of ``epoch_probe`` are NOT updated in
place (the reference does not donate them either): an overflow
redispatch recomputes from the originals.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from risingwave_tpu_torch.common.chunk import next_pow2
from risingwave_tpu_torch.ops import cuda
from risingwave_tpu_torch.ops import hash_table as ht
from risingwave_tpu_torch.ops.hash_agg import remap
from risingwave_tpu_torch.utils.device import (
    LAUNCHES, fetch, resolve_device, send, staging, start_fetch, upload,
)

I32_MAX = (1 << 31) - 1

# aux int32[n, 4] columns and flag bits (one aux matrix per side per
# epoch feeds both the apply and the probe)
AUX_INS_REF, AUX_DEL_REF, AUX_FLAGS, AUX_SEQ = 0, 1, 2, 3
FLAG_PROBE, FLAG_INS, FLAG_DEL = 1, 2, 4
# probe row's op sign is negative (DELETE / UPDATE_DELETE): the
# device-side degree scatter needs it
FLAG_NEG = 8


class ChainState(NamedTuple):
    """Chain arrays (the non-key half of a join side), device tensors."""

    head: torch.Tensor     # int32[cap]
    next: torch.Tensor     # int32[row_cap]
    ins_seq: torch.Tensor  # int32[row_cap] (I32_MAX = never inserted)
    del_seq: torch.Tensor  # int32[row_cap] (I32_MAX = live)


def make_chains(cap: int, row_cap: int, device) -> ChainState:
    def full(n, v):
        return torch.full((n,), v, dtype=torch.int32, device=device)
    return ChainState(full(cap, -1), full(row_cap, -1),
                      full(row_cap, I32_MAX), full(row_cap, I32_MAX))


def _seq_rows(seq, n: int, device) -> torch.Tensor:
    """A per-row int32 sequence vector from None (0), a scalar or a
    vector."""
    if seq is None:
        seq = 0
    if isinstance(seq, torch.Tensor) and seq.dim() == 1:
        return seq.to(torch.int32)
    return torch.full((n,), int(seq), dtype=torch.int32, device=device)


# -- plain PyTorch versions (the reference functions written out) ----------

def link_rows_plain(chains: ChainState, slots: torch.Tensor,
                    row_refs: torch.Tensor, vis: torch.Tensor, cap: int,
                    seq=None) -> ChainState:
    """``link_rows`` (``hash_join.py:68``): front-insert a batch of rows
    into their key chains; rows sharing a slot keep BATCH ORDER (stable
    sort by slot), the last one pointing at the old head."""
    n = int(slots.shape[0])
    if n == 0:
        return chains
    row_cap = int(chains.next.shape[0])
    s64 = slots.to(torch.int64)
    skey = torch.where(vis.to(torch.bool) & (s64 >= 0), s64, cap)
    order = torch.argsort(skey, stable=True)
    s = skey[order]
    r = row_refs.to(torch.int64)[order]
    valid = s < cap
    diff = s[1:] != s[:-1]
    one = torch.ones(1, dtype=torch.bool, device=s.device)
    first = torch.cat([one, diff])
    last = torch.cat([diff, one])
    succ = torch.roll(r, -1)
    old_head = chains.head[torch.clamp(s, max=cap - 1)].to(torch.int64)
    nxt_val = torch.where(last, old_head, succ).to(torch.int32)
    sv = _seq_rows(seq, n, s.device)[order]
    w = valid & (r >= 0) & (r < row_cap)        # mode="drop"
    chains.next[r[w]] = nxt_val[w]
    hw = valid & first
    chains.head[s[hw]] = r[hw].to(torch.int32)
    chains.ins_seq[r[w]] = sv[w]
    return chains


def tombstone_rows_plain(chains: ChainState, row_refs: torch.Tensor,
                         vis: torch.Tensor, seq=None) -> ChainState:
    """``tombstone_rows`` (:106): del_seq[ref] := seq."""
    n = int(row_refs.shape[0])
    row_cap = int(chains.del_seq.shape[0])
    r = row_refs.to(torch.int64)
    m = vis.to(torch.bool) & (r >= 0) & (r < row_cap)
    chains.del_seq[r[m]] = _seq_rows(seq, n, r.device)[m]
    return chains


def _probe_walk(table: ht.TableState, chains: ChainState,
                key_lanes: torch.Tensor, vis: torch.Tensor, seq):
    """Lookup + degree-count walk: (cur0, deg, lookup stats)."""
    n = int(key_lanes.shape[0])
    slots, stats = ht.lookup_plain(table, key_lanes, vis)
    s = slots.to(torch.int64)
    cur0 = torch.where(s >= 0, chains.head[torch.clamp(s, min=0)]
                       .to(torch.int64), -1)
    seq = _seq_rows(seq, n, s.device)
    deg = torch.zeros(n, dtype=torch.int32, device=s.device)
    cur = cur0
    while bool((cur >= 0).any()):
        safe = torch.clamp(cur, min=0)
        m = (cur >= 0) & (chains.ins_seq[safe] < seq) & \
            (chains.del_seq[safe] >= seq)
        deg += m.to(torch.int32)
        cur = torch.where(cur >= 0, chains.next[safe].to(torch.int64), -1)
    return cur0, deg, seq, stats


def _emit_walk(chains: ChainState, cur0, deg, seq, out_cap: int,
               pay: Optional[torch.Tensor], old_src: Optional[torch.Tensor]):
    """Emit walk at the exclusive-cumsum offsets of ``deg``: pair rows
    [probe_row, ref, pay lanes..., old] (drop past ``out_cap``)."""
    n = int(cur0.shape[0])
    dev = cur0.device
    P = 0 if pay is None else int(pay.shape[1])
    w = 2 + P + (old_src is not None)
    out = torch.zeros((out_cap, w), dtype=torch.int32, device=dev)
    out[:, :2] = -1
    wp = (torch.cumsum(deg, 0) - deg).to(torch.int64)
    row_ids = torch.arange(n, dtype=torch.int32, device=dev)
    cur = cur0
    while bool((cur >= 0).any()):
        safe = torch.clamp(cur, min=0)
        m = (cur >= 0) & (chains.ins_seq[safe] < seq) & \
            (chains.del_seq[safe] >= seq)
        sel = m & (wp < out_cap)
        dest = wp[sel]
        out[dest, 0] = row_ids[sel]
        out[dest, 1] = cur[sel].to(torch.int32)
        if P:
            out[dest, 2:2 + P] = pay[safe[sel]]
        if old_src is not None:
            out[dest, 2 + P] = old_src[safe[sel]]
        wp = wp + m.to(torch.int64)
        cur = torch.where(cur >= 0, chains.next[safe].to(torch.int64), -1)
    return out


def probe_pairs_plain(table: ht.TableState, chains: ChainState,
                      key_lanes: torch.Tensor, vis: torch.Tensor, seq,
                      out_cap: int, with_degrees: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``probe_pairs`` (:116): int32[1 (+ n) + out_cap, 2] — header
    [total, 0], (degree rows), then (probe_row, ref) pairs at cumsum
    offsets. Returns (matrix, lookup stats)."""
    n = int(key_lanes.shape[0])
    cur0, deg, seq_v, stats = _probe_walk(table, chains, key_lanes, vis,
                                          seq)
    pairs = _emit_walk(chains, cur0, deg, seq_v, out_cap, None, None)
    header = torch.zeros((1, 2), dtype=torch.int32, device=pairs.device)
    header[0, 0] = int(deg.sum())
    if not with_degrees:
        return torch.cat([header, pairs]), stats
    degs = torch.zeros((n, 2), dtype=torch.int32, device=pairs.device)
    degs[:, 0] = deg
    return torch.cat([header, degs, pairs]), stats


def epoch_probe_plain(table: ht.TableState, chains: ChainState,
                      pay: torch.Tensor, deg_self: torch.Tensor,
                      deg_sink: torch.Tensor, up: torch.Tensor,
                      aux: torch.Tensor, key_width: int, out_cap: int,
                      with_degrees: bool):
    """``epoch_probe`` (:237): probe a whole epoch's rows, each at its
    own sequence. Returns (matrix, deg_self', deg_sink', lookup stats);
    the degree outputs are None without degrees. Matrix layout: header
    [total, 0, ...], (n degree rows [deg, 0, ...]), out_cap pair rows
    [probe_row, ref, pay lanes..., (old degree)]."""
    key_lanes = up[:, :key_width]
    flags = aux[:, AUX_FLAGS]
    vis = (flags & FLAG_PROBE) != 0
    n = int(key_lanes.shape[0])
    P = int(pay.shape[1])
    cur0, deg, seq_v, stats = _probe_walk(table, chains, key_lanes, vis,
                                          aux[:, AUX_SEQ])
    pairs = _emit_walk(chains, cur0, deg, seq_v, out_cap,
                       pay if P else None,
                       deg_self if with_degrees else None)
    W = int(pairs.shape[1])
    header = torch.zeros((1, W), dtype=torch.int32, device=pairs.device)
    header[0, 0] = int(deg.sum())
    if not with_degrees:
        return torch.cat([header, pairs]), None, None, stats
    out_probe, out_ref = pairs[:, 0].to(torch.int64), pairs[:, 1]
    pm = out_ref >= 0
    sgn_row = torch.where((flags & FLAG_NEG) != 0, -1, 1).to(torch.int32)
    ds = deg_self.clone()
    ds.index_add_(0, out_ref[pm].to(torch.int64),
                  sgn_row[out_probe[pm]])
    ins_ref = aux[:, AUX_INS_REF].to(torch.int64)
    im = ((flags & FLAG_INS) != 0) & (ins_ref >= 0) & \
        (ins_ref < deg_sink.shape[0])
    dk = deg_sink.clone()
    dk.index_add_(0, ins_ref[im], deg[im])
    degs = torch.zeros((n, W), dtype=torch.int32, device=pairs.device)
    degs[:, 0] = deg
    return torch.cat([header, degs, pairs]), ds, dk, stats


def join_apply_plain(chains: ChainState, pay: torch.Tensor,
                     slots: torch.Tensor, up: torch.Tensor, aux: torch.Tensor,
                     key_width: int,
                     pay_src: Optional[torch.Tensor] = None) -> None:
    """The rest of ``epoch_apply`` (:203) after the key probe-insert:
    link the insert rows, tombstone the delete rows, scatter the insert
    rows' payload lanes (in place)."""
    flags = aux[:, AUX_FLAGS]
    ins_mask = (flags & FLAG_INS) != 0
    seq = aux[:, AUX_SEQ]
    link_rows_plain(chains, slots, aux[:, AUX_INS_REF], ins_mask,
                    int(chains.head.shape[0]), seq)
    tombstone_rows_plain(chains, aux[:, AUX_DEL_REF],
                         (flags & FLAG_DEL) != 0, seq)
    if pay.shape[1]:
        _masked_scatter_plain(pay, aux[:, AUX_INS_REF], ins_mask,
                              up[:, key_width:] if pay_src is None
                              else pay_src)


def epoch_apply_plain(table: ht.TableState, chains: ChainState,
                      pay: torch.Tensor, up: torch.Tensor, aux: torch.Tensor,
                      key_width: int, pay_src: Optional[torch.Tensor] = None):
    """``epoch_apply`` (:203): probe-insert the insert rows' keys, then
    join_apply_plain. Returns (table, chains, pay, K1 stats). With
    ``pay_src`` the payload lanes come from there, not from ``up``."""
    slots, stats = ht.probe_insert_plain(
        table, up[:, :key_width], (aux[:, AUX_FLAGS] & FLAG_INS) != 0)
    join_apply_plain(chains, pay, slots, up, aux, key_width, pay_src)
    return table, chains, pay, stats


def _masked_scatter_plain(arr: torch.Tensor, refs: torch.Tensor,
                          vis: Optional[torch.Tensor], vals: torch.Tensor
                          ) -> torch.Tensor:
    """``_masked_scatter`` (:361): arr[ref] := val for visible rows (in
    place; out-of-range and negative refs dropped). ``vis`` None: every
    row is visible."""
    r = refs.to(torch.int64)
    m = (r >= 0) & (r < arr.shape[0])
    if vis is not None:
        m &= vis.to(torch.bool)
    arr[r[m]] = vals[m].to(arr.dtype)
    return arr


def _gather_carry_plain(dst: torch.Tensor, src: torch.Tensor,
                        idx: torch.Tensor,
                        vis: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7's carry, the reference's read-then-write of compaction
    (``stream/executors/hash_join.py:504-543``: ``read_degrees`` at the
    live refs, then ``_masked_scatter`` at the dense new refs):
    dst[i] := src[idx[i]] for the visible rows i < len(idx), in place; an
    idx outside src's rows is dropped."""
    s = idx.to(torch.int64)
    m = (s >= 0) & (s < src.shape[0])
    if vis is not None:
        m &= vis.to(torch.bool)
    rows = torch.arange(int(idx.shape[0]), device=dst.device)[m]
    dst[rows] = src[s[m]].to(dst.dtype)
    return dst


def _remap_head_plain(head: torch.Tensor, old_to_new: torch.Tensor,
                      new_cap: int) -> torch.Tensor:
    """``_remap_head`` (:446): a fresh -1 head with
    head'[old_to_new[i]] := head[i]."""
    out = torch.full((new_cap,), -1, dtype=torch.int32, device=head.device)
    o = old_to_new.to(torch.int64)
    m = (o >= 0) & (o < new_cap)
    out[o[m]] = head[m]
    return out


def _rebase_plain(chains: ChainState) -> ChainState:
    """``_rebase_jit`` (:457): every finite ins/del sequence becomes 0
    (in place)."""
    for a in (chains.ins_seq, chains.del_seq):
        a.copy_(torch.where(a == I32_MAX, I32_MAX, 0).to(torch.int32))
    return chains


def _bits(t: Optional[torch.Tensor], bits: int) -> Optional[torch.Tensor]:
    return None if t is None else (t & bits) != 0


def _shard_seq(seq, s: int):
    return seq[s] if isinstance(seq, torch.Tensor) and seq.dim() == 2 \
        else seq


def _shard(chains: ChainState, s: int) -> ChainState:
    """Shard s's chain arrays (views: writes land in the [S, ...]
    arrays)."""
    return ChainState(*(a[s] for a in chains))


def join_apply_sharded_plain(chains: ChainState,
                             slots: Optional[torch.Tensor], *, ins_ok=None,
                             ins_bits: int = -1, ins_ref=None, del_ok=None,
                             del_bits: int = -1, del_ref=None, seq=None
                             ) -> ChainState:
    """Plain version of the sharded K5: the reference's per-shard
    ``link_rows`` then ``tombstone_rows`` (``parallel/join.py:419-420``),
    shard by shard, in place."""
    cap = int(chains.head.shape[-1])
    im, dm = _bits(ins_ok, ins_bits), _bits(del_ok, del_bits)
    for s in range(int(chains.head.shape[0])):
        c = _shard(chains, s)
        sq = _shard_seq(seq, s)
        if slots is not None:
            link_rows_plain(c, slots[s], ins_ref[s], im[s], cap, sq)
        if dm is not None:
            tombstone_rows_plain(c, del_ref[s], dm[s], sq)
    return chains


def join_probe_sharded_plain(table: ht.TableState, chains: ChainState,
                             key_lanes: torch.Tensor, vis: torch.Tensor,
                             vis_bits: int, seq, out_cap: int,
                             with_degrees: bool,
                             rid: Optional[torch.Tensor] = None,
                             rvalid: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the sharded K6: ``probe_pairs`` on each shard's
    received rows, then the reference's map back to global rows
    (``parallel/join.py:421-432``): pair rows carry rid[probe row],
    degree rows (deg, rvalid ? rid : -1)."""
    mats, stats = [], []
    m = int(key_lanes.shape[1])
    for s in range(int(key_lanes.shape[0])):
        mat, st = probe_pairs_plain(
            ht.TableState(table.keys[s], table.occ[s]), _shard(chains, s),
            key_lanes[s], (vis[s] & vis_bits) != 0, _shard_seq(seq, s),
            out_cap, with_degrees)
        if rid is not None:
            r = rid[s].to(torch.int32)
            p0 = 1 + (m if with_degrees else 0)
            pr = mat[p0:, 0].to(torch.int64)
            mat[p0:, 0] = torch.where(pr >= 0, r[torch.clamp(pr, min=0)],
                                      -1)
            if with_degrees:
                mat[1:1 + m, 1] = torch.where(rvalid[s] != 0, r, -1)
        mats.append(mat)
        stats.append(st)
    return torch.stack(mats), torch.stack(stats)


def apply_and_probe_plain(my_table: ht.TableState, my_chains: ChainState,
                          other_table: ht.TableState,
                          other_chains: ChainState, key_lanes: torch.Tensor,
                          probe_vis: torch.Tensor, ins_refs: torch.Tensor,
                          ins_mask: torch.Tensor, del_refs: torch.Tensor,
                          del_mask: torch.Tensor, seq, out_cap: int):
    """``apply_and_probe`` (:415) written out: probe_pairs on the other
    side, then probe_insert, link_rows and tombstone_rows on this side.
    Returns (my_table, my_chains, K1 stats, probe matrix)."""
    mat, _st = probe_pairs_plain(other_table, other_chains, key_lanes,
                                 probe_vis, seq, out_cap)
    slots, stats = ht.probe_insert_plain(my_table, key_lanes, ins_mask)
    link_rows_plain(my_chains, slots, ins_refs, ins_mask,
                    my_table.capacity, seq)
    tombstone_rows_plain(my_chains, del_refs, del_mask, seq)
    return my_table, my_chains, stats, mat


# -- kernel wrappers --------------------------------------------------------

def _i32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.int32 else t.to(torch.int32)


def _check_dev(*ts: torch.Tensor) -> None:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"join kernel tensors must share one device: {devs}")
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"join kernels take int32 tensors, got {t.dtype}")


def _seq_arg(seq, shape, device):
    """The kernels' sequence argument: (tensor to keep alive over the
    launch, (pointer, row stride, shard stride)). A vector of the batch's
    shape ([n], or [S, n] on the sharded path) keeps its strides; None or
    a scalar becomes one element every row reads (both strides 0)."""
    if isinstance(seq, torch.Tensor) and seq.dim() >= 1:
        if tuple(seq.shape) != tuple(shape):
            raise ValueError(f"seq shape {tuple(seq.shape)} differs from "
                             f"the batch's {tuple(shape)}")
        return seq, _rows(seq)
    # a fill launch, not a copy from pageable host memory (which would
    # wait for the stream to drain)
    t = torch.full((1,), 0 if seq is None else int(seq), dtype=torch.int32,
                   device=device)
    return t, (t.data_ptr(), 0, 0)


class LinkScratch:
    """K5's per-slot bucket words for chain arrays with one ``head`` shape
    ([cap] or [S, cap]): one 64-bit word a slot holding (generation << 32
    | row), and the grid barrier's word. Each launch takes the next
    generation, so a word an earlier launch wrote reads as empty and
    nothing restores the words between launches; they are zeroed again
    only when the 32-bit generation wraps."""

    GEN_LIMIT = 1 << 32

    def __init__(self, head: torch.Tensor):
        self.shape = tuple(head.shape)
        self.words = torch.zeros(head.numel() + 1, dtype=torch.int64,
                                 device=head.device)
        self.gen = 0

    def next_gen(self) -> int:
        self.gen += 1
        if self.gen >= self.GEN_LIMIT:
            self.words.zero_()
            self.gen = 1
        return self.gen


def _k5_seq(seq, shape) -> Tuple[int, int, int, int]:
    """K5's sequence argument: (pointer, row stride, shard stride,
    value). A vector of the batch's shape keeps its strides; None or a
    scalar goes by value, with no device copy ahead of the launch."""
    if isinstance(seq, torch.Tensor) and seq.dim() >= 1:
        if tuple(seq.shape) != tuple(shape):
            raise ValueError(f"seq shape {tuple(seq.shape)} differs from "
                             f"the batch's {tuple(shape)}")
        if seq.dtype != torch.int32:
            raise TypeError(f"join kernels take int32 seq, got {seq.dtype}")
        return (*_rows(seq), 0)
    return 0, 0, 0, 0 if seq is None else int(seq)


def link_scratch(head: torch.Tensor) -> Optional[LinkScratch]:
    """A side's K5 scratch for chain arrays with this ``head`` (None on
    the CPU, where the plain versions need none)."""
    return LinkScratch(head) if head.device.type == "cuda" else None


def _slot_scratch(scratch: Optional[LinkScratch], head: torch.Tensor
                  ) -> LinkScratch:
    if scratch is None:
        return LinkScratch(head)
    if scratch.shape != tuple(head.shape) or \
            scratch.words.device != head.device:
        raise ValueError("link scratch must be made for this head")
    return scratch


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _rows(t: Optional[torch.Tensor], lanes: bool = False
          ) -> Tuple[int, int, int]:
    """(pointer, row stride, shard stride) of a row input: [n] (or [n, L]
    with ``lanes``) for one shard, [S, n] (or [S, n, L]) for S shards,
    any strides; None gives zeros (the part is off)."""
    if t is None:
        return 0, 0, 0
    if t.dim() == 1 + lanes:
        return t.data_ptr(), t.stride(0), 0
    return t.data_ptr(), t.stride(1), t.stride(0)


def _join_apply_launch(chains: ChainState, pay: Optional[torch.Tensor],
                       n: int, shards: int = 1, *, slots=None, ins_ok=None,
                       ins_bits=-1, ins_ref=None, seq=None, del_ok=None,
                       del_bits=-1, del_ref=None, pay_src=None,
                       scratch=None) -> None:
    """One K5 launch over ``shards`` shards; every part optional (None →
    skipped). Row inputs are int32 [n] (one shard) or [S, n] views with
    any strides (aux or receive-block columns, plain vectors); ``seq`` is
    a vector of their shape, a scalar or None (0); the chain arrays are
    [cap]/[row_cap], or [S, cap]/[S, row_cap]."""
    head, nxt, ins_seq, del_seq = chains
    if n == 0:
        return
    for t in (head, nxt, ins_seq, del_seq):
        if not t.is_contiguous():
            raise ValueError("chain arrays must be contiguous")
    if shards > 1 and head.dim() != 2:
        raise ValueError("sharded chain arrays are [S, ...]")
    cap = int(head.shape[-1])
    row_cap = int(nxt.shape[-1])
    P = 0 if pay_src is None else int(pay_src.shape[-1])
    if P:
        if pay is None or tuple(pay.shape[-2:]) != (row_cap, P) or \
                not pay.is_contiguous() or pay_src.stride(-1) != 1:
            raise ValueError("payload store must be int32[row_cap, P] "
                             "with contiguous source lanes")
    if slots is not None and slots.stride(-1) != 1:
        raise ValueError("slots must be contiguous along the rows")
    words = gen = rows = None
    if slots is not None:
        sl = _slot_scratch(scratch, head)
        words, gen = sl.words, sl.next_gen()
        rows = torch.empty(2 * shards * n, dtype=torch.int32,
                           device=head.device)
    ref = ins_ref if ins_ref is not None else del_ref
    cuda.call("join_apply", "rw_join_apply",
              _ptr(slots), _rows(slots)[2], *_rows(ins_ok), ins_bits,
              *_rows(ins_ref), *_k5_seq(seq, ref.shape), *_rows(del_ok),
              del_bits, *_rows(del_ref), *_rows(pay_src, lanes=True), P, n,
              shards,
              head.data_ptr(), cap, nxt.data_ptr(), ins_seq.data_ptr(),
              del_seq.data_ptr(), row_cap, _ptr(pay if P else None),
              _ptr(words), gen or 0, _ptr(rows))
    LAUNCHES.add("join_apply")


def link_rows(chains: ChainState, slots: torch.Tensor,
              row_refs: torch.Tensor, vis: torch.Tensor, cap: int,
              seq=None, scratch: Optional[LinkScratch] = None
              ) -> ChainState:
    """Link a batch of rows into their key chains (K5, link only).
    ``scratch``: the side's ``LinkScratch``, or None to make one."""
    if slots.device.type != "cuda":
        return link_rows_plain(chains, slots, row_refs, vis, cap, seq)
    n = int(slots.shape[0])
    vis = _i32(vis)
    row_refs = _i32(row_refs)
    _check_dev(slots, row_refs, vis, *chains)
    if cap != chains.head.shape[0]:
        raise ValueError("cap differs from the head array")
    _join_apply_launch(chains, None, n, slots=slots, ins_ok=vis,
                       ins_ref=row_refs, seq=seq, scratch=scratch)
    return chains


def tombstone_rows(chains: ChainState, row_refs: torch.Tensor,
                   vis: torch.Tensor, seq=None) -> ChainState:
    """Tombstone deletes (K5, tombstone only)."""
    if row_refs.device.type != "cuda":
        return tombstone_rows_plain(chains, row_refs, vis, seq)
    n = int(row_refs.shape[0])
    vis = _i32(vis)
    row_refs = _i32(row_refs)
    _check_dev(row_refs, vis, *chains)
    _join_apply_launch(chains, None, n, del_ok=vis, del_ref=row_refs,
                       seq=seq)
    return chains


def join_apply(chains: ChainState, pay: torch.Tensor, slots: torch.Tensor,
               up: torch.Tensor, aux: torch.Tensor, key_width: int,
               scratch: Optional[LinkScratch] = None,
               pay_src: Optional[torch.Tensor] = None) -> None:
    """K5 over one epoch, after K1 gave the insert rows' ``slots``: link,
    tombstone and payload scatter, in place. ``up`` is [key lanes |
    payload lanes] int32[n, key_width + P], or the key lanes alone with
    the payload lanes in ``pay_src`` int32[n, P]; ``aux`` int32[n, 4]
    (AUX_*), its columns any stride (K5 reads each as a row input)."""
    if up.device.type != "cuda":
        return join_apply_plain(chains, pay, slots, up, aux, key_width,
                                pay_src)
    n = int(up.shape[0])
    src = up[:, key_width:] if pay_src is None else pay_src
    _check_dev(up, aux, pay, slots, src, *chains)
    if aux.shape != (n, 4) or up.stride(1) != 1 or slots.shape != (n,) \
            or tuple(src.shape) != (n, pay.shape[1]):
        raise ValueError("join_apply takes aux int32[n, 4], slots "
                         "int32[n], contiguous lanes in each row and "
                         "the payload store's width")
    _join_apply_launch(
        chains, pay, n, slots=slots, ins_ok=aux[:, AUX_FLAGS],
        ins_bits=FLAG_INS, ins_ref=aux[:, AUX_INS_REF],
        seq=aux[:, AUX_SEQ], del_ok=aux[:, AUX_FLAGS],
        del_bits=FLAG_DEL, del_ref=aux[:, AUX_DEL_REF],
        pay_src=src if pay.shape[1] else None, scratch=scratch)


def join_apply_sharded(chains: ChainState, slots: Optional[torch.Tensor],
                       *, ins_ok=None, ins_bits: int = -1, ins_ref=None,
                       del_ok=None, del_bits: int = -1, del_ref=None,
                       seq=None, scratch: Optional[LinkScratch] = None
                       ) -> ChainState:
    """K5 over S shards in one launch sequence, in place (the per-shard
    link_rows + tombstone_rows of ``risingwave_tpu/parallel/join.py``).
    ``chains`` holds head [S, cap] and next/ins_seq/del_seq [S, row_cap]
    (indexed by GLOBAL row ref); ``slots`` is K1's int32[S, n] (None: no
    link); ``ins_ok``/``ins_ref``/``del_ok``/``del_ref`` are int32 [S, n]
    views with any strides (receive-block columns), a row inserting when
    ``ins_ok & ins_bits`` and tombstoning when ``del_ok & del_bits``;
    ``seq`` is a scalar or int32[S, n]. ``scratch``: the shards' ``LinkScratch``
    (made for head [S, cap]), or None."""
    if chains.head.device.type != "cuda":
        return join_apply_sharded_plain(
            chains, slots, ins_ok=ins_ok, ins_bits=ins_bits,
            ins_ref=ins_ref, del_ok=del_ok, del_bits=del_bits,
            del_ref=del_ref, seq=seq)
    s = int(chains.head.shape[0])
    ref = ins_ref if ins_ref is not None else del_ref
    if ref is None or ref.dim() != 2 or ref.shape[0] != s:
        raise ValueError("sharded join_apply takes [S, n] row inputs")
    n = int(ref.shape[1])
    parts = [t for t in (slots, ins_ok, ins_ref, del_ok, del_ref)
             if t is not None]
    _check_dev(*parts, *chains)
    if any(tuple(t.shape) != (s, n) for t in parts):
        raise ValueError("sharded join_apply row inputs must be [S, n]")
    if slots is not None and (ins_ok is None or ins_ref is None):
        raise ValueError("a link needs ins_ok and ins_ref")
    _join_apply_launch(chains, None, n, s, slots=slots, ins_ok=ins_ok,
                       ins_bits=ins_bits, ins_ref=ins_ref, seq=seq,
                       del_ok=del_ok, del_bits=del_bits, del_ref=del_ref,
                       scratch=scratch)
    return chains


def epoch_apply(table: ht.TableState, chains: ChainState,
                pay: torch.Tensor, up: torch.Tensor, aux: torch.Tensor,
                key_width: int, scratch: Optional[LinkScratch] = None,
                pay_src: Optional[torch.Tensor] = None):
    """Apply a whole epoch's inserts and tombstones (K1 + K5). Returns
    (table, chains, pay, K1 stats). ``pay_src``: see join_apply."""
    if up.device.type != "cuda":
        return epoch_apply_plain(table, chains, pay, up, aux, key_width,
                                 pay_src)
    table, slots, stats = ht.probe_insert(table, up[:, :key_width],
                                          aux[:, AUX_FLAGS] & FLAG_INS)
    join_apply(chains, pay, slots, up, aux, key_width, scratch, pay_src)
    return table, chains, pay, stats


def _join_probe_launch(table: ht.TableState, chains: ChainState, *,
                       keys, vis, vis_bits, seq, aux, n, pay, deg_self,
                       deg_self_out, deg_sink_out, out_cap: int,
                       deg_rows: bool, old_col: bool, scatter: bool,
                       name: str, shards: int = 1, rid=None, rvalid=None):
    """One K6 call (two launches) over ``shards`` shards. One shard: keys
    [n, K], vis [n], the table [cap, K] and chains [cap]/[row_cap];
    S shards: [S, n, K], [S, n], [S, cap, K], [S, cap]/[S, row_cap].
    ``seq`` is _seq_arg's triple. Returns (out [(S,) rows, W], stats
    [(S,) 2])."""
    tkeys, occ = table
    head, nxt, ins_seq, del_seq = chains
    dev = head.device
    k = int(keys.shape[-1])
    if k != tkeys.shape[-1] or (n and keys.stride(-1) != 1):
        raise ValueError("probe key lanes must match the table's width "
                         "and be contiguous")
    if not all(t.is_contiguous() for t in (tkeys, occ, *chains)):
        raise ValueError("table and chain arrays must be contiguous")
    if (rid is None) != (rvalid is None):
        raise ValueError("a row-id lane comes with the route's valid flags")
    P = 0 if pay is None else int(pay.shape[-1])
    if P and not pay.is_contiguous():
        raise ValueError("payload store must be contiguous")
    W = 2 + P + int(old_col)
    rows = 1 + (n if deg_rows else 0) + out_cap
    lead = (shards,) if head.dim() == 2 else ()
    out = torch.empty(lead + (rows, W), dtype=torch.int32, device=dev)
    tiles = -(-n // 256)
    scratch = torch.empty(shards * (4 * n + 2 * tiles + 1),
                          dtype=torch.int32, device=dev)
    stats = torch.empty(lead + (2,), dtype=torch.int32, device=dev)
    cuda.call("join_probe", "rw_join_probe",
              *_rows(keys, lanes=True), k, *_rows(vis), vis_bits, *seq,
              _ptr(aux), n, shards, *_rows(rid), *_rows(rvalid),
              tkeys.data_ptr(), occ.data_ptr(), int(tkeys.shape[-2]),
              head.data_ptr(), nxt.data_ptr(), ins_seq.data_ptr(),
              del_seq.data_ptr(), int(nxt.shape[-1]),
              _ptr(pay if P else None), P, _ptr(deg_self),
              _ptr(deg_self_out), _ptr(deg_sink_out),
              0 if deg_sink_out is None else int(deg_sink_out.shape[-1]),
              int(deg_rows), int(old_col), int(scatter),
              out.data_ptr(), out_cap, W, scratch.data_ptr(),
              stats.data_ptr())
    LAUNCHES.add(name)
    return out, stats


def probe_pairs(table: ht.TableState, chains: ChainState,
                key_lanes: torch.Tensor, vis: torch.Tensor, seq,
                out_cap: int, with_degrees: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Degrees + cumsum + emit in one launch sequence (K6 with no
    payload). Returns (matrix, lookup stats); see probe_pairs_plain."""
    if key_lanes.device.type != "cuda":
        return probe_pairs_plain(table, chains, key_lanes, vis, seq,
                                 out_cap, with_degrees)
    n = int(key_lanes.shape[0])
    vis = _i32(vis)
    _check_dev(key_lanes, vis, *table, *chains)
    _keep, sq = _seq_arg(seq, (n,), key_lanes.device)
    return _join_probe_launch(
        table, chains, keys=key_lanes, vis=vis, vis_bits=-1, seq=sq,
        aux=None, n=n, pay=None, deg_self=None, deg_self_out=None,
        deg_sink_out=None, out_cap=out_cap, deg_rows=with_degrees,
        old_col=False, scatter=False,
        name="join_probe_deg" if with_degrees else "join_probe")


def join_probe_sharded(table: ht.TableState, chains: ChainState,
                       key_lanes: torch.Tensor, vis: torch.Tensor,
                       vis_bits: int, seq, out_cap: int,
                       with_degrees: bool,
                       rid: Optional[torch.Tensor] = None,
                       rvalid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 over S shards in one launch sequence (the per-shard
    probe_pairs of ``risingwave_tpu/parallel/join.py``): shard s probes
    its table keys [S, cap, K] + occ [S, cap] and chains ([S, cap] head,
    [S, row_cap] rows) with its rows ``key_lanes`` [S, n, K], visible
    where ``vis & vis_bits`` ([S, n], any strides), at ``seq`` (a scalar
    or [S, n]). Returns (out int32[S, 1 + (n) + out_cap, 2], stats
    int32[S, 2]); each shard's header holds its TRUE total. With ``rid``
    (the routed global row ids, [S, n]) and ``rvalid`` (the route's
    valid flags), pair rows carry rid[row] and degree rows (deg, rvalid ?
    rid : -1)."""
    if key_lanes.device.type != "cuda":
        return join_probe_sharded_plain(table, chains, key_lanes, vis,
                                        vis_bits, seq, out_cap,
                                        with_degrees, rid, rvalid)
    s, n = int(key_lanes.shape[0]), int(key_lanes.shape[1])
    parts = [t for t in (vis, rid, rvalid) if t is not None]
    _check_dev(key_lanes, *parts, *table, *chains)
    if any(tuple(t.shape) != (s, n) for t in parts) or \
            table.keys.shape[0] != s or chains.head.shape[0] != s:
        raise ValueError("sharded join_probe takes [S, n] rows and [S, ...]"
                         " state")
    _keep, sq = _seq_arg(seq, (s, n), key_lanes.device)
    return _join_probe_launch(
        table, chains, keys=key_lanes, vis=vis, vis_bits=vis_bits, seq=sq,
        aux=None, n=n, pay=None, deg_self=None, deg_self_out=None,
        deg_sink_out=None, out_cap=out_cap, deg_rows=with_degrees,
        old_col=False, scatter=False, name="join_probe", shards=s, rid=rid,
        rvalid=rvalid)


def epoch_probe(table: ht.TableState, chains: ChainState,
                pay: torch.Tensor, deg_self: torch.Tensor,
                deg_sink: torch.Tensor, up: torch.Tensor, aux: torch.Tensor,
                key_width: int, out_cap: int, with_degrees: bool):
    """Probe a whole epoch's rows, each at its own sequence (K6).
    Returns (matrix, deg_self', deg_sink', lookup stats); see
    epoch_probe_plain for the layout."""
    if up.device.type != "cuda":
        return epoch_probe_plain(table, chains, pay, deg_self, deg_sink,
                                 up, aux, key_width, out_cap, with_degrees)
    n = int(up.shape[0])
    _check_dev(up, aux, pay, deg_self, deg_sink, *table, *chains)
    if aux.shape != (n, 4) or not aux.is_contiguous():
        raise ValueError("epoch_probe takes aux int32[n, 4]")
    ds = dk = None
    if with_degrees:
        if not (deg_self.is_contiguous() and deg_sink.is_contiguous()):
            raise ValueError("degree arrays must be contiguous")
        ds, dk = deg_self.clone(), deg_sink.clone()
    mat, stats = _join_probe_launch(
        table, chains, keys=up[:, :key_width], vis=aux[:, AUX_FLAGS],
        vis_bits=FLAG_PROBE, seq=_rows(aux[:, AUX_SEQ]), aux=aux, n=n,
        pay=pay if pay.shape[1] else None,
        deg_self=deg_self if with_degrees else None, deg_self_out=ds,
        deg_sink_out=dk, out_cap=out_cap, deg_rows=with_degrees,
        old_col=with_degrees, scatter=with_degrees,
        name="join_probe_deg" if with_degrees else "join_probe")
    return mat, ds, dk, stats


def apply_and_probe(my_table: ht.TableState, my_chains: ChainState,
                    other_table: ht.TableState, other_chains: ChainState,
                    key_lanes: torch.Tensor, probe_vis: torch.Tensor,
                    ins_refs: torch.Tensor, ins_mask: torch.Tensor,
                    del_refs: torch.Tensor, del_mask: torch.Tensor, seq,
                    out_cap: int, scratch: Optional[LinkScratch] = None):
    """The whole per-chunk step (B16, ``hash_join.py:415``): probe the
    OTHER side at ``seq`` (K6 with degrees, no payload), then insert this
    side's rows' keys (K1) and link and tombstone them at ``seq`` (one K5
    launch), in place. Returns (my_table, my_chains, K1 stats, probe
    matrix)."""
    if key_lanes.device.type != "cuda":
        return apply_and_probe_plain(
            my_table, my_chains, other_table, other_chains, key_lanes,
            probe_vis, ins_refs, ins_mask, del_refs, del_mask, seq, out_cap)
    mat, _st = probe_pairs(other_table, other_chains, key_lanes, probe_vis,
                           seq, out_cap, True)
    n = int(key_lanes.shape[0])
    ins_mask, del_mask = _i32(ins_mask), _i32(del_mask)
    ins_refs, del_refs = _i32(ins_refs), _i32(del_refs)
    my_table, slots, stats = ht.probe_insert(my_table, key_lanes, ins_mask)
    _check_dev(slots, ins_mask, ins_refs, del_mask, del_refs, *my_chains)
    _join_apply_launch(my_chains, None, n, slots=slots, ins_ok=ins_mask,
                       ins_ref=ins_refs, seq=seq, del_ok=del_mask,
                       del_ref=del_refs, scratch=scratch)
    return my_table, my_chains, stats, mat


def _k7_launch(gather: bool, dst: torch.Tensor, idx: torch.Tensor,
               vis: Optional[torch.Tensor], src: torch.Tensor
               ) -> torch.Tensor:
    """One K7 masked_scatter launch: dst[idx[i]] := src[i] (scatter) or
    dst[i] := src[idx[i]] (gather) over the visible rows i < len(idx)."""
    n = int(idx.shape[0])
    _check_dev(dst, idx, src, *(() if vis is None else (vis,)))
    width = 1 if dst.dim() == 1 else int(dst.shape[1])
    if not dst.is_contiguous() or src.dim() != dst.dim() or \
            (dst.dim() == 2 and (src.shape[1] != width or
                                 src.stride(1) != 1)):
        raise ValueError("masked_scatter takes a contiguous int32 [rows] "
                         "or [rows, P] array and a source of its lanes "
                         "with a unit lane stride")
    if idx.dim() != 1 or (vis is not None and tuple(vis.shape) != (n,)):
        raise ValueError("masked_scatter takes int32 [n] refs and vis")
    if (n > dst.shape[0]) if gather else (src.shape[0] != n):
        raise ValueError("masked_scatter shape mismatch")
    if n and width:
        cuda.call("join_maint", "rw_masked_scatter", int(gather),
                  dst.data_ptr(), int(dst.shape[0]), width, idx.data_ptr(),
                  idx.stride(0), _ptr(vis),
                  0 if vis is None else vis.stride(0), src.data_ptr(),
                  src.stride(0), int(src.shape[0]), n)
        LAUNCHES.add("masked_scatter")
    return dst


def _masked_scatter(arr: torch.Tensor, refs: torch.Tensor,
                    vis: Optional[torch.Tensor], vals: torch.Tensor
                    ) -> torch.Tensor:
    """arr[ref] := val for the visible rows, in place (K7 masked_scatter):
    ``arr`` int32 [rows] (degrees) or [rows, P] (payload lanes),
    contiguous; ``refs`` and ``vis`` int32 [n], ``vis`` None when every
    row is visible (no all-ones array); ``vals`` [n] or [n, P]. Refs, vis
    and vals may be strided views (a column of a matrix already on the
    card); vals' lanes are contiguous."""
    if arr.device.type != "cuda":
        return _masked_scatter_plain(arr, refs, vis, vals)
    return _k7_launch(False, arr, refs, vis, vals)


def _gather_carry(dst: torch.Tensor, src: torch.Tensor, idx: torch.Tensor,
                  vis: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dst[i] := src[idx[i]] for the visible rows i < len(idx), in place
    (K7 masked_scatter's gather mode): a compaction carries the live
    rows' degrees from the old array into the fresh one on the card.
    ``dst`` and ``src`` are int32 [rows] (or [rows, P]) arrays, ``idx``
    and ``vis`` int32 [n] with any stride, ``vis`` None: every row."""
    if dst.device.type != "cuda":
        return _gather_carry_plain(dst, src, idx, vis)
    return _k7_launch(True, dst, idx, vis, src)


def _remap_head(head: torch.Tensor, old_to_new: torch.Tensor,
                new_cap: int, occ_new: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Re-scatter ``head`` through a table growth's old→new slots.

    On the card this is K4 ``remap`` (``csrc/rebuild.cu``) over the one
    row ``head`` with fill -1: it writes each old slot's head to its new
    slot and -1 into every slot ``occ_new`` left empty. That equals the
    reference's fresh -1 array exactly when every occupied slot of the
    new table came from an old slot, which holds on growth (the new
    table holds only the re-inserted old keys), so ``occ_new`` is
    required there. The plain version does not read it."""
    if head.device.type != "cuda":
        return _remap_head_plain(head, old_to_new, new_cap)
    if occ_new is None:
        raise ValueError("_remap_head on the card takes the new table's "
                         "occupancy (K4 remap writes the fill there)")
    fill = torch.full((1,), -1, dtype=torch.int32, device=head.device)
    return remap(head.view(1, -1), _i32(old_to_new), _i32(occ_new), fill,
                 new_cap)[0]


def _rebase(chains: ChainState) -> ChainState:
    """Every finite ins/del sequence becomes 0, in place (K7 rebase)."""
    if chains.ins_seq.device.type != "cuda":
        return _rebase_plain(chains)
    _check_dev(*chains)
    n = int(chains.ins_seq.shape[0])
    cuda.call("join_maint", "rw_rebase", chains.ins_seq.data_ptr(),
              chains.del_seq.data_ptr(), n)
    LAUNCHES.add("rebase")
    return chains


# -- host side ----------------------------------------------------------------

class PendingProbe:
    """An in-flight per-chunk probe (``hash_join.py:467``): dispatched,
    its device→host copy started, not yet read.

    Sequence versioning makes ``collect`` exact at any later point: the
    kernel may have applied more messages since, and a re-dispatch after
    a pair-buffer overflow (``redispatch(cap)`` probes the kernel's
    CURRENT state at a larger buffer) still returns the probe-time
    result. ``bump(cap)`` records the grown buffer on the owning
    kernel."""

    def __init__(self, mat: torch.Tensor, n: int, cap: int,
                 redispatch: Callable[[int], torch.Tensor],
                 with_degrees: bool = True, bump=None):
        self.mat = mat
        self._fetch = start_fetch(mat)
        self.n = n
        self.cap = cap
        self.redispatch = redispatch
        self.with_degrees = with_degrees
        self.bump = bump

    def collect(self) -> Tuple[Optional[np.ndarray], np.ndarray,
                               np.ndarray]:
        """(degrees | None, probe_idx[pairs], refs[pairs]); pairs sorted
        by probe row."""
        n = self.n
        while True:
            mat = self._fetch.result()
            total = int(mat[0, 0])
            if total <= self.cap:
                break
            self.cap = max(self.cap * 2, next_pow2(total))
            if self.bump is not None:
                self.bump(self.cap)
            self.mat = self.redispatch(self.cap)
            self._fetch = start_fetch(self.mat)
        if self.with_degrees:
            deg = np.ascontiguousarray(mat[1:1 + n, 0])
            pairs = mat[1 + n:1 + n + total]
        else:
            deg = None
            pairs = mat[1:1 + total]
        return (deg, np.ascontiguousarray(pairs[:, 0]),
                np.ascontiguousarray(pairs[:, 1]))


class PendingEpochProbe:
    """An in-flight epoch probe: dispatched, its device→host copy
    started, not yet read.

    ``collect`` re-dispatches with a doubled pair buffer while the
    header's true total exceeds it (sequence versioning makes the retry
    exact) and installs the updated degree arrays into their owners only
    once the collect succeeds, so a retry never double-counts."""

    def __init__(self, mat: torch.Tensor, n: int, cap: int,
                 redispatch: Callable[[int], torch.Tensor],
                 pay_width: int, with_degrees: bool, install, bump):
        self.mat = mat
        self._fetch = start_fetch(mat)
        self.n = n
        self.cap = cap
        self.redispatch = redispatch
        self.pay_width = pay_width
        self.with_degrees = with_degrees
        self.install = install        # (deg_self, deg_sink) -> None
        self.bump = bump
        self._degs = None             # latest (deg_self, deg_sink)

    def set_degs(self, deg_self, deg_sink) -> None:
        self._degs = (deg_self, deg_sink)

    def collect(self):
        """(degrees | None, probe_idx, refs, pay_rows | None,
        old_deg | None); pairs sorted by probe row index."""
        n = self.n
        while True:
            mat = self._fetch.result()
            total = int(mat[0, 0])
            if total <= self.cap:
                break
            self.cap = max(self.cap * 2, next_pow2(total))
            if self.bump is not None:
                self.bump(self.cap)
            self.mat = self.redispatch(self.cap)
            self._fetch = start_fetch(self.mat)
        if self.with_degrees and self._degs is not None:
            self.install(*self._degs)
        if self.with_degrees:
            deg = np.ascontiguousarray(mat[1:1 + n, 0])
            pairs = mat[1 + n:1 + n + total]
        else:
            deg = None
            pairs = mat[1:1 + total]
        P = self.pay_width
        pay = np.ascontiguousarray(pairs[:, 2:2 + P]) if P else None
        old = np.ascontiguousarray(pairs[:, 2 + P]) \
            if self.with_degrees else None
        return (deg, np.ascontiguousarray(pairs[:, 0]),
                np.ascontiguousarray(pairs[:, 1]), pay, old)


class JoinSideKernel:
    """Host wrapper: key table + chain arrays + payload/degree stores.

    The key table is a DeviceHashTable (growth, load factor and the
    sync-free occupancy bound live there); on rehash its on_grow hook
    remaps ``head``. The executor assigns row refs; tombstoned refs are
    NOT recycled (a dead ref stays linked in its chain) and are
    reclaimed wholesale by ``rebuild``. On the card every call runs on
    K1, K4, K5, K6 and K7."""

    DEFAULT_CAPACITY = 1 << 16

    def __init__(self, key_width: int,
                 key_capacity: int = DEFAULT_CAPACITY,
                 row_capacity: int = DEFAULT_CAPACITY,
                 probe_capacity: int = 1 << 14,
                 payload_width: int = 0, device=None):
        self.device = resolve_device(device)
        self.key_width = key_width
        # payload lanes per stored row (3 int32 lanes per device-typed
        # column, ops/lanes.py payload_lanes)
        self.payload_width = payload_width
        self._probe_cap = probe_capacity
        self._init_state(key_capacity, row_capacity)

    def _init_state(self, key_capacity: int, row_capacity: int) -> None:
        self.table = ht.DeviceHashTable(self.key_width, key_capacity,
                                        device=self.device)
        self.table.on_grow(self._on_table_grow)
        self.chains = make_chains(self.table.capacity, row_capacity,
                                  self.device)
        self.pay = torch.zeros((row_capacity, self.payload_width),
                               dtype=torch.int32, device=self.device)
        # device-resident per-ref match degrees (outer/semi/anti
        # bookkeeping); unallocated refs are 0 by bump allocation
        self.deg = torch.zeros(row_capacity, dtype=torch.int32,
                               device=self.device)
        self._link_scratch = self._new_scratch()

    def _new_scratch(self) -> Optional[LinkScratch]:
        """K5's per-slot bucket words (no launch restores them)."""
        return link_scratch(self.chains.head)

    @property
    def row_capacity(self) -> int:
        return int(self.chains.next.shape[0])

    # -- growth ----------------------------------------------------------
    def _on_table_grow(self, old_to_new: torch.Tensor,
                       old_capacity: int) -> None:
        cap = self.table.capacity
        self.chains = self.chains._replace(
            head=_remap_head(self.chains.head, old_to_new, cap,
                             self.table.state.occ))
        self._link_scratch = self._new_scratch()

    def reserve_rows(self, max_ref: int) -> None:
        row_cap = self.row_capacity
        if max_ref < row_cap:
            return
        new_cap = row_cap
        while new_cap <= max_ref:
            new_cap *= 4
        pad = new_cap - row_cap

        def grown(a, v):
            return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), v,
                                            dtype=torch.int32,
                                            device=self.device)])
        c = self.chains
        self.chains = c._replace(next=grown(c.next, -1),
                                 ins_seq=grown(c.ins_seq, I32_MAX),
                                 del_seq=grown(c.del_seq, I32_MAX))
        self.pay = grown(self.pay, 0)
        self.deg = grown(self.deg, 0)

    # -- ops --------------------------------------------------------------
    def insert(self, key_lanes: torch.Tensor, row_refs: np.ndarray,
               vis: torch.Tensor, seq: int = 0) -> None:
        if len(row_refs):
            self.reserve_rows(int(np.max(row_refs)))
        slots = self.table.probe_insert(key_lanes, vis)
        self.chains = link_rows(self.chains, slots,
                                upload(np.asarray(row_refs, np.int32),
                                       self.device),
                                vis, self.table.capacity, seq,
                                scratch=self._link_scratch)

    def delete(self, row_refs: np.ndarray, vis, seq: int = 0,
               key_lanes=None) -> None:
        """Tombstone by ref (``key_lanes``: the sharded kernel's routing
        argument, unused on one device)."""
        del key_lanes
        self.chains = tombstone_rows(
            self.chains, upload(np.asarray(row_refs, np.int32), self.device),
            upload(np.asarray(vis, np.int32), self.device), seq)

    # -- per chunk (B16) ----------------------------------------------------
    def _dev(self, a, dtype=np.int32) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return upload(np.asarray(a, dtype), self.device)

    def apply_and_probe(self, other: "JoinSideKernel", key_lanes,
                        probe_vis, ins_refs, ins_mask, del_refs, del_mask,
                        seq: int) -> PendingProbe:
        """One per-chunk step (``hash_join.py:690``): probe ``other`` at
        ``seq`` and apply this side's inserts and deletes at ``seq`` (K6,
        then K1 + K5). Arguments are host arrays or device tensors of the
        chunk's rows; returns the pending probe (copy started)."""
        lanes = self._dev(key_lanes)
        n = int(lanes.shape[0])
        ins_refs = np.asarray(ins_refs)
        if np.asarray(ins_mask).any():
            self.reserve_rows(int(ins_refs.max()))
        self.table.reserve(n)
        vis = self._dev(probe_vis)
        out_cap = other._probe_cap
        self.table.state, self.chains, stats, mat = apply_and_probe(
            self.table.state, self.chains, other.table.state, other.chains,
            lanes, vis, self._dev(ins_refs), self._dev(ins_mask),
            self._dev(del_refs), self._dev(del_mask), seq, out_cap,
            scratch=self._link_scratch)
        self.table._counters.push(stats, n)

        def redispatch(cap):
            return probe_pairs(other.table.state, other.chains, lanes, vis,
                               seq, cap, True)[0]

        def bump(cap):
            other._probe_cap = max(other._probe_cap, cap)

        return PendingProbe(mat, n, out_cap, redispatch, bump=bump)

    def probe_submit(self, key_lanes, vis, seq: Optional[int] = None
                     ) -> PendingProbe:
        """Dispatch a probe of this side (K6) and start its copy; never
        waits (``hash_join.py:725``). The result is a function of (state,
        seq) alone: ``collect`` may run after later applies."""
        s = I32_MAX if seq is None else seq
        lanes, vis_d = self._dev(key_lanes), self._dev(vis)

        def dispatch(cap):
            return probe_pairs(self.table.state, self.chains, lanes, vis_d,
                               s, cap, True)[0]

        def bump(cap):
            self._probe_cap = max(self._probe_cap, cap)

        return PendingProbe(dispatch(self._probe_cap), int(lanes.shape[0]),
                            self._probe_cap, dispatch, bump=bump)

    def probe(self, key_lanes, vis, seq: Optional[int] = None):
        return self.probe_submit(key_lanes, vis, seq).collect()

    # -- epoch batching ---------------------------------------------------
    def stage_epoch(self, up: np.ndarray, aux: np.ndarray, total: int,
                    max_ins_ref: int) -> tuple:
        """Host→device staging of one side's epoch matrices."""
        del total, max_ins_ref
        return upload(up, self.device), upload(aux, self.device)

    def apply_epoch(self, up_dev: torch.Tensor, aux_dev: torch.Tensor,
                    n_rows: int, max_ins_ref: int,
                    pay_src: Optional[torch.Tensor] = None) -> None:
        """Apply a whole epoch's concatenated inserts/tombstones (and
        their payload lanes, in ``up_dev`` or in ``pay_src``) in one
        dispatch (K1 + K5)."""
        if max_ins_ref >= 0:
            self.reserve_rows(max_ins_ref)
        self.table.reserve(n_rows)
        self.table.state, self.chains, self.pay, stats = epoch_apply(
            self.table.state, self.chains, self.pay, up_dev, aux_dev,
            self.key_width, scratch=self._link_scratch, pay_src=pay_src)
        self.table._counters.push(stats, n_rows)

    def probe_epoch(self, up_dev: torch.Tensor, aux_dev: torch.Tensor,
                    with_degrees: bool,
                    sink: Optional["JoinSideKernel"] = None
                    ) -> PendingEpochProbe:
        """Probe a whole epoch's rows against THIS side, each at its aux
        sequence; call after both sides' apply_epoch. With degrees,
        ``sink`` is the PROBING side's kernel (see epoch_probe)."""
        sink = sink if sink is not None else self
        # the degree arrays at ENTRY: a redispatch recomputes from them
        deg0_self, deg0_sink = self.deg, sink.deg

        def dispatch(cap):
            mat, ds, dk, stats = epoch_probe(
                self.table.state, self.chains, self.pay, deg0_self,
                deg0_sink, up_dev, aux_dev, self.key_width, cap,
                with_degrees)
            self.table._counters.watch(stats)
            return mat, ds, dk

        def install(d_self, d_sink):
            self.deg = d_self
            sink.deg = d_sink

        def bump(cap):
            self._probe_cap = max(self._probe_cap, cap)

        def redispatch(cap):
            m, ds, dk = dispatch(cap)
            pending.set_degs(ds, dk)
            return m

        mat, d_self, d_sink = dispatch(self._probe_cap)
        pending = PendingEpochProbe(
            mat, int(up_dev.shape[0]), self._probe_cap, redispatch,
            pay_width=self.payload_width, with_degrees=with_degrees,
            install=install, bump=bump)
        if with_degrees:
            pending.set_degs(d_self, d_sink)
        return pending

    # -- degrees (device-resident; recovery/reload writes) ---------------
    def write_degrees(self, refs: torch.Tensor, vals: torch.Tensor) -> None:
        """Scatter exact degree values by ref on the device (K7, every row
        visible): ``refs`` and ``vals`` are int32 [n] tensors on this
        side's device with any stride (the refs column of a staged aux
        matrix, K6's degree column)."""
        if int(refs.shape[0]):
            self.deg = _masked_scatter(self.deg, refs, None, vals)

    def read_degrees(self, refs: np.ndarray) -> np.ndarray:
        """Degree values by ref, fetched to the host (a whole-array read
        and a sync: for checks; the executor's paths keep degrees on the
        device)."""
        return fetch(self.deg)[refs].astype(np.int64)

    def probe_degrees(self, key_lanes, vis) -> torch.Tensor:
        """Each row's match degree against THIS side at the latest
        sequence, left on the device: K6's degree branch with no pair
        buffer, and its degree column ``mat[1:1+n, 0]`` returned as a
        strided view (0 where a row is not visible). Arguments are host
        arrays or device tensors (views of a staged matrix); nothing is
        fetched."""
        lanes, vis_d = self._dev(key_lanes), self._dev(vis)
        mat, _stats = probe_pairs(self.table.state, self.chains, lanes,
                                  vis_d, I32_MAX, 0, True)
        return mat[1:1 + int(lanes.shape[0]), 0]

    def rebase_seq(self) -> None:
        """Reset every finite ins/del sequence to 0 (a safe point with
        no probes in flight) so the int32 message counter can restart
        instead of wrapping."""
        self.chains = _rebase(self.chains)

    # -- recovery / compaction ---------------------------------------------
    def rebuild(self, key_lanes: np.ndarray, row_refs: np.ndarray,
                payload: Optional[np.ndarray] = None,
                carry: Optional[np.ndarray] = None) -> None:
        """Reload all live rows (recovery, compaction): a fresh state, then
        one upload applied as an epoch at seq 0 (K1 + K5, the payload
        lanes written in K5's launch). The upload is one buffer of
        contiguous blocks, [key lanes | payload lanes | aux columns (|
        carry)], written in place on the host (interleaving lanes into
        rows costs more host time than it saves). Degrees reset to zero;
        with ``carry`` (compaction: ``row_refs`` dense 0..n-1,
        ``carry[i]`` the old ref of new ref i) each row's degree moves
        from the old array into the fresh one on the card (K7's
        gather)."""
        n = len(row_refs)
        key_cap = max(self.table.capacity,
                      ht.MIN_CAPACITY if n == 0 else
                      1 << int(np.ceil(np.log2(max(n / ht.MAX_LOAD, 1)))))
        row_cap = max(self.row_capacity,
                      1 << int(np.ceil(np.log2(max(n + 1, 2)))))
        if carry is not None and (len(carry) != n or not np.array_equal(
                row_refs, np.arange(n))):
            raise ValueError("a carry rebuilds dense refs 0..n-1, one old "
                             "ref each")
        old_deg = self.deg
        self._init_state(key_cap, row_cap)
        if n == 0:
            return
        kw, P = self.key_width, self.payload_width
        at = np.cumsum([0, n * kw, n * P, 4 * n,
                        0 if carry is None else n])
        host = staging(int(at[-1]), self.device)
        h = host.numpy()
        h[:at[1]] = np.asarray(key_lanes, np.int32).reshape(-1)
        h[at[1]:at[2]] = 0 if payload is None else \
            np.asarray(payload, np.int32).reshape(-1)
        aux = h[at[2]:at[3]].reshape(4, n)
        aux[AUX_INS_REF] = row_refs
        aux[AUX_DEL_REF] = -1
        aux[AUX_FLAGS] = FLAG_INS
        aux[AUX_SEQ] = 0        # rebuilt rows predate every live sequence
        if carry is not None:
            h[at[3]:] = carry
        dev = send(host, self.device)
        self.apply_epoch(dev[:at[1]].view(n, kw),
                         dev[at[2]:at[3]].view(4, n).t(), n,
                         int(np.max(row_refs)),
                         pay_src=dev[at[1]:at[2]].view(n, P))
        if carry is not None:
            self.deg = _gather_carry(self.deg, old_deg, dev[at[3]:])
