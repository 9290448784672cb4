"""First-class serving telemetry (the port's own copy of
``repro/gateway/telemetry.py``: host-only, stdlib; DESIGN.md §10).

One ``Telemetry`` object per gateway: thread-safe counters, gauges, and
log-spaced latency histograms, snapshotted on demand (``Gateway.stats``)
and periodically emitted as one structured JSON line through pluggable
sinks.  Everything is host-side and O(1) per event — recording a
latency is an index into a fixed bin array, never an allocation — so
telemetry cost stays invisible next to a dispatch.

Counters are monotone by construction (asserted by the tests):
only ``inc`` exists, gauges are the separate escape hatch for values
that legitimately move both ways (queue depth).

The recall *proxy* is deliberately not recall: online traffic has no
ground truth.  We track the result fill rate (fraction of the k result
slots holding a live id — a search that comes back short is the first
observable symptom of a mis-sized nprobe/max_scan or a churn-starved
list) plus the mean exact top-1 distance, whose drift under a stable
query mix indicates index quality movement.
"""
from __future__ import annotations

import json
import math
import sys
import threading
import time
from typing import Dict, Optional

# histogram range: 10us .. 100s, log-spaced.  ~7.4% bin width — tighter
# than any latency SLO anyone will write against this gateway.
_H_LO = 1e-5
_H_HI = 100.0
_H_BINS = 192


class LatencyHistogram:
    """Fixed log-spaced latency histogram with percentile estimates.

    ``record`` is O(1); ``percentile`` interpolates within the covering
    bin (upper-edge biased, so reported percentiles never understate).
    Not thread-safe by itself — ``Telemetry`` holds the lock.
    """

    __slots__ = ("counts", "total", "sum_s", "max_s")

    def __init__(self):
        self.counts = [0] * _H_BINS
        self.total = 0
        self.sum_s = 0.0
        self.max_s = 0.0

    def record(self, seconds: float) -> None:
        x = max(float(seconds), _H_LO)
        b = int(math.log(x / _H_LO) / math.log(_H_HI / _H_LO) * _H_BINS)
        self.counts[min(max(b, 0), _H_BINS - 1)] += 1
        self.total += 1
        self.sum_s += seconds
        if seconds > self.max_s:
            self.max_s = seconds

    def percentile(self, q: float) -> float:
        """q in [0, 100] -> estimated latency in seconds (0 if empty)."""
        if self.total == 0:
            return 0.0
        target = q / 100.0 * self.total
        seen = 0
        for b, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                # upper edge of bin b
                return _H_LO * (_H_HI / _H_LO) ** ((b + 1) / _H_BINS)
        return self.max_s

    def snapshot(self) -> Dict[str, float]:
        """Schema (locked by the tests, as the reference's): count, sum_ms,
        mean_ms, p50/p95/p99_ms, max_ms — count + sum let sinks derive
        rates and cross-interval means without re-binning."""
        ms = 1e3
        return {
            "count": self.total,
            "sum_ms": self.sum_s * ms,
            "mean_ms": (self.sum_s / self.total * ms) if self.total else 0.0,
            "p50_ms": self.percentile(50) * ms,
            "p95_ms": self.percentile(95) * ms,
            "p99_ms": self.percentile(99) * ms,
            "max_ms": self.max_s * ms,
        }


class TelemetrySink:
    """Pluggable destination for periodic structured telemetry records.
    Subclass and override ``emit`` (a dict, JSON-serializable)."""

    def emit(self, record: dict) -> None:
        raise NotImplementedError


class LogSink(TelemetrySink):
    """Default sink: one structured JSON line per record to a stream."""

    def __init__(self, stream=None):
        self.stream = stream if stream is not None else sys.stderr

    def emit(self, record: dict) -> None:
        self.stream.write(json.dumps(record, default=float) + "\n")
        self.stream.flush()


class MemorySink(TelemetrySink):
    """Test/inspection sink: keeps every record in a list."""

    def __init__(self):
        self.records = []

    def emit(self, record: dict) -> None:
        self.records.append(record)


class Telemetry:
    """Thread-safe serving metrics for one gateway.

    Counters (monotone): requests, responses, errors, batches,
    bucket_rows (padded dispatch rows), stale_retries, handovers,
    warmup_compiles observed at session swaps.  Gauges: queue_depth.
    Histograms: end-to-end latency, queue wait, dispatch time.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._sums: Dict[str, float] = {}
        self.latency = LatencyHistogram()
        self.queue_wait = LatencyHistogram()
        self.dispatch = LatencyHistogram()

    def inc(self, name: str, v: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + v

    def add(self, name: str, v: float) -> None:
        """Accumulate a monotone float counter.  Negative deltas violate
        the counters-are-monotone contract (module docstring) and raise;
        values that legitimately move both ways go through ``gauge`` or
        ``add_signed``."""
        if v < 0:
            raise ValueError(
                f"accumulator {name!r}: negative delta {v!r} breaks the "
                f"monotone-counters contract; use add_signed() for sums "
                f"that are legitimately signed")
        with self._lock:
            self._sums[name] = self._sums.get(name, 0.0) + v

    def add_signed(self, name: str, v: float) -> None:
        """Accumulate a *signed* sum (e.g. top-1 inner-product scores,
        which are negated distances).  The escape hatch from ``add``'s
        monotonicity check — use sparingly and document the call site."""
        with self._lock:
            self._sums[name] = self._sums.get(name, 0.0) + v

    def gauge(self, name: str, v: float) -> None:
        with self._lock:
            self._gauges[name] = v

    def record_latency(self, hist: LatencyHistogram, seconds: float) -> None:
        with self._lock:
            hist.record(seconds)

    def observe(self, counters: Optional[dict] = None,
                sums: Optional[dict] = None,
                signed: Optional[dict] = None,
                gauges: Optional[dict] = None,
                latencies=()) -> None:
        """Apply one multi-metric update *atomically* — a single lock
        acquisition covers every counter, sum, gauge, and histogram
        record, so a concurrent ``snapshot()`` sees either none or all
        of it.  This is what keeps cross-metric invariants exact under
        load (e.g. ``latency.count == counters["responses"]`` after
        every dispatch, asserted by the threaded consistency test).

        ``latencies`` is an iterable of ``(histogram, seconds)`` pairs.
        Monotonicity is validated up front so a bad delta rejects the
        whole update instead of applying half of it.
        """
        for name, v in (sums or {}).items():
            if v < 0:
                raise ValueError(
                    f"accumulator {name!r}: negative delta {v!r} breaks "
                    f"the monotone-counters contract; use the signed= "
                    f"mapping for sums that are legitimately signed")
        with self._lock:
            for name, v in (counters or {}).items():
                self._counters[name] = self._counters.get(name, 0) + v
            for name, v in (sums or {}).items():
                self._sums[name] = self._sums.get(name, 0.0) + v
            for name, v in (signed or {}).items():
                self._sums[name] = self._sums.get(name, 0.0) + v
            for name, v in (gauges or {}).items():
                self._gauges[name] = v
            for hist, seconds in latencies:
                hist.record(seconds)

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> dict:
        """One coherent metrics dict: counters, gauges, derived rates
        (qps, batch-fill, recall proxies), and latency percentiles."""
        with self._lock:
            c = dict(self._counters)
            g = dict(self._gauges)
            s = dict(self._sums)
            lat = self.latency.snapshot()
            qw = self.queue_wait.snapshot()
            disp = self.dispatch.snapshot()
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        responses = c.get("responses", 0)
        batches = c.get("batches", 0)
        slots = s.get("result_slots", 0.0)
        out = {
            "uptime_s": elapsed,
            "counters": c,
            "gauges": g,
            "qps": responses / elapsed,
            # requests coalesced per compiled dispatch: > 1 means the
            # micro-batcher is actually amortizing dispatch overhead
            "batch_fill": responses / batches if batches else 0.0,
            # fraction of each dispatched bucket holding real queries
            # (the rest is pad-row waste)
            "bucket_fill": (responses / c["bucket_rows"]
                            if c.get("bucket_rows") else 0.0),
            "approx_dco_per_query": (s.get("approx_dco", 0.0) / responses
                                     if responses else 0.0),
            "refine_dco_per_query": (s.get("refine_dco", 0.0) / responses
                                     if responses else 0.0),
            # recall proxies (see module docstring)
            "result_fill_rate": (s.get("result_filled", 0.0) / slots
                                 if slots else 0.0),
            "mean_top1_dist": (s.get("top1_dist", 0.0) / responses
                               if responses else 0.0),
            "latency": lat,
            "queue_wait": qw,
            "dispatch": disp,
        }
        return out

    def emit(self, sinks, kind: str = "gateway_stats",
             extra: Optional[dict] = None) -> dict:
        """Snapshot once and push the record through every sink."""
        record = {"t": time.time(), "kind": kind, **self.snapshot()}
        if extra:
            record.update(extra)
        for sink in sinks:
            sink.emit(record)
        return record
