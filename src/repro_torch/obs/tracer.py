"""Span-based tracer for the search sessions (counterpart of
``repro/obs/tracer.py``).

One ``Tracer`` records complete spans: name, category, thread, start
time, duration, nesting depth, and a free-form counter dict.  Spans are
opened with the module-level ``span(...)`` context manager, which keeps
spans well nested per thread.

Zero overhead when disabled is a hard contract: ``span()`` returns a
shared no-op singleton and ``fence()`` returns its argument untouched —
no lock, no allocation that grows, no device synchronize.  The module
keeps a global work counter (``work_count()``) bumped on every recorded
span, raw event, and fence; the tests check that it does not move while
tracing is off.

``fence(x)`` is how device work becomes attributable: with a tracer
active it runs ``torch.cuda.synchronize`` on the device of ``x``'s
tensors (a nested tuple of tensors), so the enclosing span covers the
device time of its stage instead of the cost of queueing it.  Fencing
changes when the host observes values, never the values.

``Tracer.event`` records cross-thread exemplar events on virtual request
tracks; these carry no nesting contract.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch

# virtual-track tids for cross-thread exemplar events (Tracer.event):
# requests overlap in time, so they rotate over a small pool of tracks
# instead of stacking on the recording thread's (well-nested) track.
_REQ_TID_BASE = 1_000_000
_REQ_TRACKS = 8

# module-global tracer work counter: spans + events + fences ever
# recorded.  The zero-overhead-when-disabled test pins this.
_WORK = 0
_ACTIVE: Optional["Tracer"] = None
_ACTIVE_LOCK = threading.Lock()


class _NoopSpan:
    """Shared do-nothing span returned by ``span()`` while disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counters):
        return self


_NOOP = _NoopSpan()


class _Span:
    """A live span; created by ``Tracer.span`` and recorded on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "t0", "depth")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0
        self.depth = 0

    def add(self, **counters) -> "_Span":
        """Attach counters to the span (merged into its args)."""
        self.args.update(counters)
        return self

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self.depth = len(stack)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self._tracer._stack().pop()
        self._tracer._record(self.name, self.cat, threading.get_ident(),
                             self.t0, t1 - self.t0, self.depth, self.args,
                             kind="span")
        return False


class Tracer:
    """Thread-safe span/event recorder.

    ``sample`` thins exemplar events (``sampled()`` is true once every
    ``sample`` calls); ``max_events`` bounds memory — past it, records
    are counted in ``dropped`` instead of stored.
    """

    def __init__(self, sample: int = 1, max_events: int = 200_000):
        if sample < 1:
            raise ValueError(f"sample must be >= 1, got {sample}")
        self.t0 = time.perf_counter()
        self.sample = sample
        self.max_events = max_events
        self.records: List[Dict[str, Any]] = []
        self.fences = 0
        self.dropped = 0
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._sample_ctr = 0
        self._req_slot = 0

    # -- recording ------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _record(self, name, cat, tid, t0, dur, depth, args, kind) -> None:
        global _WORK
        rec = {"name": name, "cat": cat, "tid": tid,
               "ts": t0 - self.t0, "dur": dur, "depth": depth,
               "kind": kind, "args": args}
        with self._lock:
            _WORK += 1
            if len(self.records) >= self.max_events:
                self.dropped += 1
            else:
                self.records.append(rec)

    def span(self, name: str, cat: str = "host", **args) -> _Span:
        return _Span(self, name, cat, args)

    def event(self, name: str, t0: float, dur: float, cat: str = "request",
              tid: Optional[int] = None, **args) -> None:
        """Record a cross-thread complete event (no nesting contract).
        ``t0`` is an absolute ``time.perf_counter()`` timestamp.  Without
        an explicit ``tid`` the event lands on a rotating virtual
        request track so overlapping requests render side by side."""
        if tid is None:
            with self._lock:
                slot = self._req_slot
                self._req_slot = (slot + 1) % _REQ_TRACKS
            tid = _REQ_TID_BASE + slot
        self._record(name, cat, tid, t0, dur, 0, args, kind="event")

    def sampled(self) -> bool:
        """True once every ``sample`` calls (always true at sample=1)."""
        with self._lock:
            n = self._sample_ctr
            self._sample_ctr += 1
        return n % self.sample == 0

    # -- aggregation ----------------------------------------------------
    def stage_summary(self) -> Dict[str, Dict[str, Any]]:
        """Per-span-name aggregate: count, total/mean seconds, and the
        sum of every numeric counter the spans carried."""
        with self._lock:
            recs = list(self.records)
        out: Dict[str, Dict[str, Any]] = {}
        for r in recs:
            if r["kind"] != "span":
                continue
            agg = out.setdefault(r["name"], {"count": 0, "total_s": 0.0,
                                             "counters": {}})
            agg["count"] += 1
            agg["total_s"] += r["dur"]
            for k, v in r["args"].items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                agg["counters"][k] = agg["counters"].get(k, 0) + v
        for agg in out.values():
            agg["mean_ms"] = agg["total_s"] / agg["count"] * 1e3
        return out


# ---------------------------------------------------------------------------
# module-level API — the only names instrumentation sites use
# ---------------------------------------------------------------------------

def enabled() -> bool:
    """True while a tracer is active (``start()`` .. ``stop()``)."""
    return _ACTIVE is not None


def tracer() -> Optional[Tracer]:
    """The active tracer, or None."""
    return _ACTIVE


def work_count() -> int:
    """Total tracer work ever done in this process (spans + events +
    fences recorded).  Pinned by the zero-overhead-when-disabled test."""
    return _WORK


def span(name: str, cat: str = "host", **args):
    """Open a span on the active tracer, or a shared no-op when none."""
    t = _ACTIVE
    if t is None:
        return _NOOP
    return t.span(name, cat, **args)


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of the tensors in ``x`` (nested tuples, lists and
    dicts of tensors)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _cuda_devices(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _cuda_devices(y, out)
    return out


def fence(x):
    """Wait until the device work that produces ``x`` is done — only
    while tracing (the production path never synchronizes).  Returns
    ``x``."""
    t = _ACTIVE
    if t is not None:
        global _WORK
        for dev in _cuda_devices(x, set()):
            torch.cuda.synchronize(dev)
        with t._lock:
            t.fences += 1
            _WORK += 1
    return x


def start(sample: int = 1, max_events: int = 200_000) -> Tracer:
    """Install a fresh active tracer (errors if one is already active)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a tracer is already active; stop() it first")
        _ACTIVE = Tracer(sample=sample, max_events=max_events)
        return _ACTIVE


def stop() -> Tracer:
    """Deactivate and return the active tracer (errors if none)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is None:
            raise RuntimeError("no active tracer")
        t = _ACTIVE
        _ACTIVE = None
        return t


class trace:
    """``with obs.trace() as tr: ...`` — start/stop scoped to a block."""

    def __init__(self, sample: int = 1, max_events: int = 200_000):
        self._kw = {"sample": sample, "max_events": max_events}

    def __enter__(self) -> Tracer:
        self._t = start(**self._kw)
        return self._t

    def __exit__(self, *exc) -> bool:
        stop()
        return False
