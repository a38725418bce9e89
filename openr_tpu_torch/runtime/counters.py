"""Process-wide counters/stats fabric.

Role of fb303 (`fb303::fbData->addStatValue/setCounter`) which the
reference uses everywhere (e.g. decision.spf_ms LinkState.cpp:909,
kvstore thrift counters KvStore.cpp:3263). Flat singleton registry with
counters (set/increment) and stats (windowed sum/count/avg), exported via
the ctrl API and the monitor module.
"""

from __future__ import annotations

import bisect
import collections
import math
import threading
import time
from typing import Optional


class _Stat:
    __slots__ = ("samples",)

    def __init__(self):
        # (ts, value) ring: 4096 most-recent samples; windowed() filters by age
        self.samples: collections.deque = collections.deque(maxlen=4096)

    def add(self, value: float) -> None:
        self.samples.append((time.monotonic(), value))

    def windowed(self, window_s: float = 60.0) -> dict:
        cutoff = time.monotonic() - window_s
        vals = [v for ts, v in self.samples if ts >= cutoff]
        n = len(vals)
        return {
            "count": n,
            "sum": sum(vals),
            "avg": (sum(vals) / n) if n else 0.0,
            "max": max(vals) if vals else 0.0,
        }

    def multi_windowed(self, windows: tuple) -> dict:
        """One pass over the ring bucketing every sample into each
        window it falls in (60s samples are a subset of 600s etc.).
        A window is marked truncated when the ring's eviction horizon
        is newer than its cutoff — the ring holds the 4096 most-recent
        samples, so a high-rate stat cannot honor long windows and must
        SAY so rather than silently undercount."""
        return _aggregate_windows(
            list(self.samples), self.samples.maxlen, windows
        )


def _percentile(sorted_vals: list, q: float) -> float:
    """numpy-style linear interpolation (method="linear") so tests can
    compare against np.percentile bit-for-bit on the same samples."""
    n = len(sorted_vals)
    if not n:
        return 0.0
    idx = (q / 100.0) * (n - 1)
    lo, hi = math.floor(idx), math.ceil(idx)
    if lo == hi:
        return float(sorted_vals[lo])
    frac = idx - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def _aggregate_windows(samples: list, maxlen: int, windows: tuple) -> dict:
    now = time.monotonic()
    # samples arrive via time.monotonic() so the ring is time-ordered:
    # each window's members are a suffix, found by bisect on the ts
    # column; quantiles then sort just that suffix once per window
    ts_col = [ts for ts, _ in samples]
    vals = [v for _, v in samples]
    full = len(samples) == maxlen
    oldest = ts_col[0] if ts_col else now
    out = {}
    for w in sorted(windows):
        cutoff = now - w
        sub = vals[bisect.bisect_left(ts_col, cutoff):]
        n = len(sub)
        total = sum(sub)
        ordered = sorted(sub)
        out[str(int(w))] = {
            "count": n,
            "sum": total,
            # empty window reports 0.0 (matches windowed()); a window
            # of negative samples reports its true maximum
            "max": ordered[-1] if n else 0.0,
            "avg": (total / n) if n else 0.0,
            "p50": _percentile(ordered, 50.0),
            "p95": _percentile(ordered, 95.0),
            "p99": _percentile(ordered, 99.0),
            "truncated": full and oldest > cutoff,
        }
    return out


class CounterRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._stats: dict[str, _Stat] = {}

    def set_counter(self, key: str, value: float) -> None:
        with self._lock:
            self._counters[key] = value

    def increment(self, key: str, delta: float = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + delta

    def add_stat_value(self, key: str, value: float) -> None:
        with self._lock:
            st = self._stats.get(key)
            if st is None:
                st = self._stats[key] = _Stat()
            st.add(value)

    def get_counter(self, key: str) -> Optional[float]:
        # lock held: solver worker threads increment concurrently and a
        # dict resize mid-read is a torn view on some interpreters
        with self._lock:
            return self._counters.get(key)

    def get_statistics(
        self, prefix: str = "", windows: tuple = (60.0, 600.0, 3600.0)
    ) -> dict[str, dict]:
        """fb303-style multi-window stat view (ref breeze monitor
        statistics): per stat key, count/sum/avg/max over each window.
        Only the sample-ring snapshot happens under the registry lock —
        the aggregation runs outside it, so a statistics poll can't
        stall hot-path add_stat_value/increment calls mid-SPF."""
        with self._lock:
            snap = {
                k: (list(st.samples), st.samples.maxlen)
                for k, st in self._stats.items()
                if k.startswith(prefix)
            }
        return {
            k: _aggregate_windows(samples, maxlen, windows)
            for k, (samples, maxlen) in snap.items()
        }

    def export_snapshot(
        self, windows: tuple = (60.0, 600.0, 3600.0)
    ) -> tuple[dict[str, float], dict[str, dict]]:
        """One consistent (counters, stat-windows) view for exposition
        (runtime/metrics_export.py). Same locking discipline as
        get_statistics: only the ring copy happens under the lock."""
        with self._lock:
            counters_snap = dict(self._counters)
            stat_snap = {
                k: (list(st.samples), st.samples.maxlen)
                for k, st in self._stats.items()
            }
        stats = {
            k: _aggregate_windows(samples, maxlen, windows)
            for k, (samples, maxlen) in stat_snap.items()
        }
        return counters_snap, stats

    def raw_counters(self) -> dict[str, float]:
        """Plain-counter snapshot WITHOUT the windowed stat aggregation
        get_counters folds in — one dict copy under the lock. The cheap
        path for high-frequency samplers (flight-recorder ticks)."""
        with self._lock:
            return dict(self._counters)

    def get_counters(self, prefix: str = "") -> dict[str, float]:
        with self._lock:
            out = {k: v for k, v in self._counters.items() if k.startswith(prefix)}
            for k, st in self._stats.items():
                if k.startswith(prefix):
                    w = st.windowed()
                    out[f"{k}.avg.60"] = w["avg"]
                    out[f"{k}.count.60"] = w["count"]
                    out[f"{k}.sum.60"] = w["sum"]
            return out

    def erase(self, key: str) -> bool:
        """Drop one counter/stat. Returns whether anything existed —
        idempotent, so sweepers can erase speculatively."""
        with self._lock:
            had = self._counters.pop(key, None) is not None
            had = (self._stats.pop(key, None) is not None) or had
            return had

    def erase_prefix(self, prefix: str) -> int:
        """Drop every counter/stat under a prefix; returns the number
        erased. Callers own the trailing-dot discipline: pass
        "q.reader.r." (not "q.reader.r") so reader "r" never swallows
        reader "r2"'s gauges."""
        n = 0
        with self._lock:
            for table in (self._counters, self._stats):
                stale = [k for k in table if k.startswith(prefix)]
                for k in stale:
                    del table[k]
                n += len(stale)
        return n

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._stats.clear()


# the process-wide instance (role of fb303::fbData)
counters = CounterRegistry()
