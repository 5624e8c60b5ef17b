"""Nexmark in-process event generator, fully vectorized.

Port of the bid half of ``risingwave_tpu/connectors/nexmark.py``:
``NexmarkConfig`` (:86), ``gen_bids`` (:216) and ``NexmarkSplitReader``
(:370), with the same counter-based RNG, so both packages generate the
same stream bit for bit. The person and auction generators are not
ported yet (q7 reads bids only).

Reference parity: src/connector/src/source/nexmark/mod.rs:31 (properties:
event.num, table.type, max.chunk.size, min.event.gap.in.ns, hot ratios,
active people / in-flight auctions) and the upstream `nexmark` crate's
generator semantics: a single global event sequence interleaving
1 person : 3 auctions : 46 bids per 50 events, with hot-key skew on
sellers/auctions/bidders and event-time pacing.

Re-design (NOT a port of the per-event generator loop): events are a
*pure function of the event index*. A counter-based RNG (splitmix64 over the
index) lets us materialize any range of events as whole numpy columns in one
vectorized pass — no generator state, no per-row Python, trivially split by
striding the index space. It makes every split reader deterministic and seekable by construction
(offset = event index, recovery is `seek(offset)`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from risingwave_tpu_torch.common.chunk import StreamChunk, next_pow2
from risingwave_tpu_torch.common.types import DataType, Field, Schema

# Standard Nexmark interleave: out of every 50 events, 1 person then
# 3 auctions then 46 bids (nexmark crate config.rs PROPORTION constants).
PERSON_PROPORTION = 1
AUCTION_PROPORTION = 3
BID_PROPORTION = 46
PROPORTION_DENOMINATOR = 50

FIRST_PERSON_ID = 1000
FIRST_AUCTION_ID = 1000

# Event-time origin: 2015-07-15 00:00:00 UTC in ms, like the nexmark crate.
BASE_TIME_MS = 1_436_918_400_000


BID_SCHEMA = Schema([
    Field("auction", DataType.INT64),
    Field("bidder", DataType.INT64),
    Field("price", DataType.INT64),          # cents
    Field("channel", DataType.VARCHAR),
    Field("url", DataType.VARCHAR),
    Field("date_time", DataType.TIMESTAMP),  # µs
    Field("extra", DataType.VARCHAR),
])

@dataclass
class NexmarkConfig:
    """Knobs mirroring nexmark.* source properties (mod.rs:31)."""

    event_num: int = 1 << 62           # effectively unbounded
    max_chunk_size: int = 1024
    table_type: str = "bid"            # bid | auction | person
    min_event_gap_in_ns: int = 100_000  # event-time pacing: 10K ev/s default
    active_people: int = 1000
    in_flight_auctions: int = 100
    hot_seller_ratio: int = 4
    hot_auction_ratio: int = 2
    hot_bidder_ratio: int = 4
    num_categories: int = 5
    seed: int = 0x5EED0                # deterministic stream identity
    generate_strings: bool = True       # False: constant-pool-only varchar


# -- counter-based RNG ------------------------------------------------------

_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: uint64 counter → uint64 random bits."""
    with np.errstate(over="ignore"):
        z = (x + _SM_GAMMA) * np.uint64(1)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _rng_u64(idx: np.ndarray, stream: int, seed: int) -> np.ndarray:
    """Independent random stream per (event index, stream id)."""
    with np.errstate(over="ignore"):
        x = idx.astype(np.uint64) * np.uint64(PROPORTION_DENOMINATOR + 7) \
            + np.uint64(stream) + (np.uint64(seed) << np.uint64(20))
    return _splitmix64(x)


def _uniform(idx: np.ndarray, stream: int, seed: int) -> np.ndarray:
    """float64 uniform [0, 1) per event."""
    return (_rng_u64(idx, stream, seed) >> np.uint64(11)).astype(
        np.float64) / float(1 << 53)


# -- id bookkeeping (pure functions of the global event index) --------------


def _epoch_offset(event_idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return (event_idx // PROPORTION_DENOMINATOR,
            event_idx % PROPORTION_DENOMINATOR)


def _max_person_base0(event_idx: np.ndarray) -> np.ndarray:
    """Highest base-0 person id that exists as of this event (inclusive)."""
    ep, off = _epoch_offset(event_idx)
    return ep * PERSON_PROPORTION + np.minimum(off, PERSON_PROPORTION - 1)


def _max_auction_base0(event_idx: np.ndarray) -> np.ndarray:
    """Highest base-0 auction id that exists as of this event (inclusive)."""
    ep, off = _epoch_offset(event_idx)
    return (ep * AUCTION_PROPORTION
            + np.clip(off - PERSON_PROPORTION, 0, AUCTION_PROPORTION - 1))


def _event_timestamp_us(event_idx: np.ndarray,
                        cfg: NexmarkConfig) -> np.ndarray:
    ns = event_idx.astype(np.int64) * np.int64(cfg.min_event_gap_in_ns)
    return np.int64(BASE_TIME_MS) * 1000 + ns // 1000


# nth event of a type → global event index (closed forms, no filtering)


def bid_event_index(k: np.ndarray) -> np.ndarray:
    return (k // BID_PROPORTION) * PROPORTION_DENOMINATOR \
        + PERSON_PROPORTION + AUCTION_PROPORTION + k % BID_PROPORTION


# -- string pools (fancy-indexed: vectorized varchar generation) ------------

_CHANNELS = np.asarray(["Google", "Facebook", "Baidu", "Apple"], dtype=object)
_CITIES = np.asarray(
    ["Phoenix", "Los Angeles", "San Francisco", "Boise", "Portland",
     "Bend", "Redmond", "Seattle", "Kent", "Cheyenne"], dtype=object)


def _pool_pick(pool: np.ndarray, u: np.ndarray) -> np.ndarray:
    # uint64 fancy indexing is legal: skip the int64 astype temporary
    return pool[u % np.uint64(len(pool))]


def _prefixed_int_str(prefix: str, vals: np.ndarray) -> np.ndarray:
    """``prefix + str(v)`` per row, built once per DISTINCT value
    through the unique pool (the bid-url shape: a constant prefix
    over a bounded id window). Nexmark numeric string columns draw
    from bounded windows (in-flight auctions, active people), so a 4K
    chunk holds a few hundred uniques at most — the per-row
    str()/np.char fixed-width materializations this replaces were the
    dominant generator cost (the r11 q1 host_ingest residual)."""
    uniq, inv = np.unique(vals, return_inverse=True)
    pool = np.array([prefix + str(v) for v in uniq.tolist()],
                    dtype=object)
    return pool[inv]


# -- column generators ------------------------------------------------------


def gen_bids(k: np.ndarray, cfg: NexmarkConfig) -> Dict[str, np.ndarray]:
    """k: bid ordinals (int64). Returns named columns, all vectorized."""
    idx = bid_event_index(k)
    s = cfg.seed
    max_auction = _max_auction_base0(idx)
    max_person = _max_person_base0(idx)

    # auction choice: hot auction with prob 1-1/ratio, else uniform over the
    # last `in_flight_auctions` (nexmark NUM_IN_FLIGHT_AUCTIONS analog)
    hot_a = _uniform(idx, 1, s) < 1.0 - 1.0 / max(cfg.hot_auction_ratio, 1)
    hot_auction = (max_auction // cfg.in_flight_auctions) \
        * cfg.in_flight_auctions
    window_a = np.minimum(max_auction + 1, cfg.in_flight_auctions)
    cold_auction = max_auction - (
        _rng_u64(idx, 2, s) % window_a.astype(np.uint64)).astype(np.int64)
    auction = np.where(hot_a, hot_auction, cold_auction) + FIRST_AUCTION_ID

    # bidder choice: hot bidder, else uniform over last `active_people`
    hot_b = _uniform(idx, 3, s) < 1.0 - 1.0 / max(cfg.hot_bidder_ratio, 1)
    hot_bidder = (max_person // cfg.active_people) * cfg.active_people + 1
    window_p = np.minimum(max_person + 1, cfg.active_people)
    cold_bidder = max_person - (
        _rng_u64(idx, 4, s) % window_p.astype(np.uint64)).astype(np.int64)
    bidder = np.where(hot_b, np.minimum(hot_bidder, max_person),
                      cold_bidder) + FIRST_PERSON_ID

    # price: lognormal-ish cents in [1, 10^8) — 10^(u*6)*100
    price = np.maximum(
        1, (np.power(10.0, _uniform(idx, 5, s) * 6.0) * 100.0)).astype(
        np.int64)

    out: Dict[str, np.ndarray] = {
        "auction": auction,
        "bidder": bidder,
        "price": price,
        "date_time": _event_timestamp_us(idx, cfg),
    }
    if cfg.generate_strings:
        out["channel"] = _pool_pick(_CHANNELS, _rng_u64(idx, 6, s))
        out["url"] = _prefixed_int_str(
            "https://www.nexmark.com/item.htm?query=1&id=", auction)
        out["extra"] = _pool_pick(_CITIES, _rng_u64(idx, 7, s))
    else:
        const = np.full(len(k), "", dtype=object)
        out["channel"] = _pool_pick(_CHANNELS, _rng_u64(idx, 6, s))
        out["url"] = const
        out["extra"] = const
    return out


class NexmarkSplitReader:
    """One split of the nexmark event stream (SplitReader analog,
    src/connector/src/source/base.rs:282; nexmark reader
    src/connector/src/source/nexmark/source/reader.rs).

    Split `i` of `m` reads type-ordinals {i, i+m, i+2m, …} — striding the
    ordinal space gives disjoint, load-balanced, seekable splits. `offset`
    (the recovery cursor persisted in split state) counts chunks of this
    split's own ordinal subsequence.
    """

    def __init__(self, cfg: NexmarkConfig, split_index: int = 0,
                 split_num: int = 1, offset: int = 0):
        if cfg.table_type != "bid":
            raise NotImplementedError(
                f"nexmark {cfg.table_type} generator is not ported")
        assert 0 <= split_index < split_num
        self.cfg = cfg
        self.split_index = split_index
        self.split_num = split_num
        self.offset = int(offset)   # ordinals consumed within this split
        self.schema = BID_SCHEMA
        self._gen = gen_bids
        # total ordinals of this type available to this split
        share = cfg.event_num * BID_PROPORTION \
            // PROPORTION_DENOMINATOR
        self._split_total = share // split_num \
            + (1 if split_index < share % split_num else 0)
        self._capacity = next_pow2(cfg.max_chunk_size)

    @property
    def split_id(self) -> str:
        return f"nexmark-{self.split_index}"

    def seek(self, offset: int) -> None:
        self.offset = int(offset)

    def next_chunk(self) -> Optional[StreamChunk]:
        """Generate up to max_chunk_size events as one StreamChunk.

        Returns None when the split is exhausted (event_num reached).
        """
        remaining = self._split_total - self.offset
        if remaining <= 0:
            return None
        n = int(min(self.cfg.max_chunk_size, remaining))
        local = np.arange(self.offset, self.offset + n, dtype=np.int64)
        k = local * self.split_num + self.split_index  # global type ordinal
        cols = self._gen(k, self.cfg)
        self.offset += n
        data = {f.name: cols[f.name] for f in self.schema}
        return StreamChunk.from_pydict(self.schema, data,
                                       capacity=self._capacity)
