"""Per-frame statistics: named timers + counters.

Reference parity: ``StatisticsTracker`` + RAII ``Timer``
(src/PaperRenderer/Statistics.h:44-102). Timers read the host clock, so on a
GPU they measure enqueue time unless the caller synchronizes; device time
comes from CUDA events or ``torch.profiler``. The tracker is cleared each
``begin_frame`` (PaperRenderer.cpp:368).
"""

from __future__ import annotations

import enum
import threading
import time
from collections import deque
from typing import Deque, Dict, Tuple


class TimeStatisticInterval(enum.IntEnum):
    REGULAR = 0    # every-frame statistic
    IRREGULAR = 1  # rare events (buffer rebuilds, compaction)


class StatisticsTracker:
    def __init__(self):
        self._lock = threading.Lock()
        self.time_statistics: Deque[Tuple[str, TimeStatisticInterval, float]] = deque()
        self.object_counters: Dict[str, int] = {}

    def clear(self) -> None:
        with self._lock:
            self.time_statistics.clear()

    def insert_time_statistic(
        self, name: str, interval: TimeStatisticInterval, seconds: float
    ) -> None:
        with self._lock:
            self.time_statistics.append((name, interval, seconds))

    def modify_object_counter(self, name: str, delta: int) -> None:
        with self._lock:
            self.object_counters[name] = self.object_counters.get(name, 0) + delta

    def snapshot(self):
        with self._lock:
            return list(self.time_statistics), dict(self.object_counters)


class Timer:
    """Context-manager timer (the RAII Timer, Statistics.h:83-102)."""

    def __init__(
        self,
        tracker: StatisticsTracker,
        name: str,
        interval: TimeStatisticInterval = TimeStatisticInterval.REGULAR,
    ):
        self._tracker = tracker
        self._name = name
        self._interval = interval
        self._start = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracker.insert_time_statistic(
            self._name, self._interval, time.perf_counter() - self._start)
        return False
