"""Epochs: the global logical clock driven by barriers.

Port of ``risingwave_tpu/common/epoch.py`` (unchanged semantics).

Reference parity: src/common/src/util/epoch.rs — a 64-bit epoch is
``physical_time_ms << 16``; the low 16 bits are a sequence number so multiple
barriers within one millisecond stay ordered. ``EpochPair`` carries
{curr, prev} across a barrier.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import ClassVar

EPOCH_PHYSICAL_SHIFT = 16

# Keep our own epoch-zero so numbers stay small and readable in tests.
UNIX_RISINGWAVE_DATE_EPOCH_MS = 1_617_235_200_000  # 2021-04-01, like reference


def physical_now_ms() -> int:
    return int(time.time() * 1000) - UNIX_RISINGWAVE_DATE_EPOCH_MS


@dataclass(frozen=True, order=True)
class Epoch:
    value: int

    INVALID: ClassVar["Epoch"]  # patched below

    @staticmethod
    def from_physical(ms: int, seq: int = 0) -> "Epoch":
        return Epoch((ms << EPOCH_PHYSICAL_SHIFT) | seq)

    @staticmethod
    def now() -> "Epoch":
        return Epoch.from_physical(physical_now_ms())

    @property
    def physical_ms(self) -> int:
        return self.value >> EPOCH_PHYSICAL_SHIFT

    def next(self) -> "Epoch":
        """Next epoch: physical now if clock advanced, else +1 sequence."""
        ms = physical_now_ms()
        if ms > self.physical_ms:
            return Epoch.from_physical(ms)
        return Epoch(self.value + 1)

    def __repr__(self) -> str:
        return f"Epoch({self.value})"


Epoch.INVALID = Epoch(0)


@dataclass(frozen=True)
class EpochPair:
    """{curr, prev} as carried by every barrier (epoch.rs EpochPair)."""

    curr: Epoch
    prev: Epoch

    def advance(self, new_curr: Epoch) -> "EpochPair":
        assert new_curr.value > self.curr.value
        return EpochPair(curr=new_curr, prev=self.curr)

    def __repr__(self) -> str:
        return f"EpochPair(curr={self.curr.value}, prev={self.prev.value})"
