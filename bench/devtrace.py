"""Readings from ``torch.profiler`` traces of the card.

A profiled stretch is opened and closed by ``Stretch``; its events are read
once into plain lists (device operations, host events, anchors), from which
the busy time, the longest device operations, the idle gaps by what the
host was doing, and the kernels that ran inside a tracer span are
worked out.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

ANCHOR = "bench.anchor"
BATCH = "bench.batch"         # the harness's annotation of one batch
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def _all_threads():
    """Profile every thread the program runs work on, and record
    the interpreter's garbage collections, where this PyTorch can."""
    from torch._C._profiler import _ExperimentalConfig
    for kw in ({"profile_all_threads": True, "record_python_gc_info": True},
               {"profile_all_threads": True}, {}):
        try:
            return _ExperimentalConfig(**kw)
        except TypeError:
            continue


class Stretch:
    """``with Stretch() as st: ...`` profiles the card and the host over
    the block.  ``st.read()`` (deferred, so that the work of reading the
    trace falls outside the stretch) fills ``st.device`` with (name,
    start_ns, end_ns) of every operation that ran on the card (kernels,
    copies, memsets), ``st.host`` with the host's torch ops, annotations
    and runtime calls, ``st.window_ns`` with the stretch's (start, end),
    ``st.cats`` with the count of events by category, and
    ``st.offset_ns`` with what turns a ``perf_counter`` reading into the
    trace's clock.  The trace is read from the profiler's Chrome export,
    written to a temporary file (``TMPDIR``) and removed."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             experimental_config=_all_threads())
        self._prof.__enter__()
        self._pc0 = self._anchor()
        self.device = None
        return self

    @staticmethod
    def _anchor() -> float:
        a = time.perf_counter()
        with torch.profiler.record_function(ANCHOR):
            pass
        return (a + time.perf_counter()) / 2

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._anchor()
        self._prof.__exit__(*exc)
        return False

    def read(self) -> "Stretch":
        if self.device is not None:
            return self
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        self.device, self.host, anchors = [], [], []
        self.cats: Dict[str, int] = defaultdict(int)
        span: Dict[str, list] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            self.cats[cat] += 1
            s = float(e["ts"]) * 1e3
            t = s + float(e.get("dur", 0.0)) * 1e3
            lim = span.setdefault(cat, [s, t])
            lim[0], lim[1] = min(lim[0], s), max(lim[1], t)
            if cat in DEVICE_CATS:
                self.device.append((e["name"], s, t))
            elif cat == "user_annotation" and e["name"] == ANCHOR:
                anchors.append((s + t) / 2)
            elif cat in HOST_CATS:
                self.host.append((e["name"], s, t))
        anchors.sort()
        self.offset_ns = anchors[0] - self._pc0 * 1e9
        self.window_ns = (anchors[0], anchors[-1])
        # where each category's events lie against the stretch, in ms
        self.extent_ms = {c: [round((a - anchors[0]) / 1e6, 3),
                              round((b - anchors[0]) / 1e6, 3)]
                          for c, (a, b) in span.items()}
        return self

    def to_ns(self, pc: float) -> float:
        return pc * 1e9 + self.read().offset_ns


def busy_ns(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals inside [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] in which no device operation ran."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def _host_at(host, starts, t: float, look: int = 4096) -> str:
    """The innermost host event around ``t``: of those that started
    before it and still run, the one that started last."""
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(host[max(0, i - look):i]):
        if e >= t:
            return name
    return "python (no torch op)"


def readings(st: Stretch) -> Optional[Dict[str, object]]:
    """busy and window seconds, and the breakdown: the ten device
    operations with most time, and the ten host activities under which the
    card sat idle longest (a gap is named by the innermost host event
    around its midpoint).  None where the trace holds no device operation
    inside the stretch, or placed most of them outside it (seen on the
    card for stretches of CUDA graph replays alone: every device event at
    one instant, of no length)."""
    lo, hi = st.read().window_ns
    dev = [(s, e) for _, s, e in st.device]
    inside = sum(1 for s, e in dev if lo <= (s + e) / 2 <= hi)
    if not dev or inside < len(dev) / 2:
        return None
    by_op: Dict[str, float] = defaultdict(float)
    for name, s, e in st.device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_op[_short(name)] += (e - s) / 1e9
    host = sorted(st.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    by_host: Dict[str, float] = defaultdict(float)
    for g0, g1 in idle_gaps(dev, lo, hi):
        by_host[_short(_host_at(host, starts, (g0 + g1) / 2))] += (
            (g1 - g0) / 1e9)
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                                key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_ns(dev, lo, hi) / 1e9,
            "window_s": (hi - lo) / 1e9,
            "device_ops": top(by_op), "idle_gaps": top(by_host)}


def kernels_in(st: Stretch, spans) -> List[float]:
    """Device seconds of the operations whose midpoint falls inside each
    span, given as ``(start, end)`` on ``perf_counter``."""
    mids = sorted(((s + e) / 2, e - s) for _, s, e in st.read().device)
    keys = [m for m, _ in mids]
    out = []
    for s, e in spans:
        i = bisect.bisect_left(keys, st.to_ns(s))
        j = bisect.bisect_right(keys, st.to_ns(e))
        out.append(sum(d for _, d in mids[i:j]) / 1e9)
    return out


def span_intervals(tracer, names) -> List[Tuple[float, float]]:
    """(start, end) on ``perf_counter`` of the tracer's spans named in
    ``names``, in the order they were recorded."""
    return [(tracer.t0 + r["ts"], tracer.t0 + r["ts"] + r["dur"])
            for r in tracer.records
            if r["kind"] == "span" and r["name"] in names]
