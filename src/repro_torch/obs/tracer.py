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
changes when the host observes values, never the values.  Inside a CUDA
graph's capture, where a synchronize would break the capture, it does
nothing, and ``recording()`` (which guards the span counters that read
device values) is false.

``Tracer.event`` records cross-thread exemplar events on virtual request
tracks; these carry no nesting contract.

One clock with the device trace: while ``torch.profiler`` collects,
every ``span()`` also opens the profiler's annotation of its name
(whether a tracer is active or not), so the spans sit in the profiler's
Chrome trace beside the device operations.  With neither a tracer nor
the profiler on, ``span()`` costs one flag check more than before.

Device time of CUDA graph replays: while timing is on (``timing()``: a
tracer active or the profiler collecting), ``replay_span()`` brackets a
replay with a pair of CUDA timing events from a small pool.  Pairs
resolve without a synchronize: completed ones by ``query()`` at later
replays, the rest in one wait by ``settle()``.  With no tracer active a
pair adds its milliseconds to the replaying session's ``DeviceTime``
(the untraced dispatch's replays only); with one, to its span as
``device_ms``.

``to_host(t)`` is ``t.cpu()``; while tracing it counts the copy
(``d2h``, ``d2h_bytes``) on the innermost open span.  ``clocked()`` is a
span that keeps its ``seconds`` whether or not a tracer records it.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

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

# the profiler's annotation pair (what ``record_function`` calls, without
# its context-manager object)
_rf_enter = torch.ops.profiler._record_function_enter_new
_rf_exit = torch.ops.profiler._record_function_exit._RecordFunction

# replay timing: free CUDA timing events, the pairs still on the device
# as (start, end, DeviceTime or None, span args or None), and the events
# ever taken from the pool
_FREE: List[Any] = []
_PENDING: "collections.deque" = collections.deque()
_TAKEN = 0
_TIMING_LOCK = threading.Lock()


def _profiling() -> bool:
    """True while ``torch.profiler`` collects, on any thread: the flag its
    start sets for the whole process (``_profiler_enabled()`` reads this
    thread's state, which a profiler of all threads leaves unset)."""
    return _autograd_profiler._is_profiler_enabled


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
    """A live span; created by ``Tracer.span`` and recorded on exit.
    Without a tracer (``clocked``, or only the profiler collecting) it
    records nothing: the profiler's annotation and the clock alone."""

    __slots__ = ("_tracer", "name", "cat", "args", "t0", "depth", "seconds",
                 "_rf")

    def __init__(self, tracer: Optional["Tracer"], name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0
        self.depth = 0
        self.seconds = 0.0

    def add(self, **counters) -> "_Span":
        """Attach counters to the span (merged into its args)."""
        self.args.update(counters)
        return self

    def __enter__(self) -> "_Span":
        self._rf = _rf_enter(self.name, None) if _profiling() else None
        if self._tracer is not None:
            stack = self._tracer._stack()
            self.depth = len(stack)
            stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self.seconds = t1 - self.t0
        if self._tracer is not None:
            self._tracer._stack().pop()
            self._tracer._record(self.name, self.cat, threading.get_ident(),
                                 self.t0, self.seconds, self.depth,
                                 self.args, kind="span")
        if self._rf is not None:
            _rf_exit(self._rf)
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


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def recording() -> bool:
    """True while a tracer is active and this thread captures no CUDA
    graph: where instrumentation may read device values (``int()`` of a
    tensor for a span counter) and ``fence`` synchronizes."""
    return _ACTIVE is not None and not _capturing()


def tracer() -> Optional[Tracer]:
    """The active tracer, or None."""
    return _ACTIVE


def work_count() -> int:
    """Total tracer work ever done in this process (spans + events +
    fences recorded).  Pinned by the zero-overhead-when-disabled test."""
    return _WORK


def span(name: str, cat: str = "host", **args):
    """Open a span on the active tracer (and the profiler's annotation
    while it collects), the annotation alone while only the profiler
    collects, or a shared no-op when neither."""
    t = _ACTIVE
    if t is None:
        return _Span(None, name, cat, args) if _profiling() else _NOOP
    return t.span(name, cat, **args)


def clocked(name: str, cat: str = "host", **args) -> _Span:
    """A span that reads the clock with or without a tracer: after the
    block its ``seconds`` hold the time the tracer (if any) recorded."""
    return _Span(_ACTIVE, name, cat, args)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, a copy the host waits for.  While tracing, the
    innermost open span counts it: ``d2h`` (copies) and ``d2h_bytes``
    (on the CPU the tensor is already on the host, and the counters
    count the reads the path makes)."""
    tr = _ACTIVE
    if tr is not None:
        stack = tr._stack()
        if stack:
            a = stack[-1].args
            a["d2h"] = a.get("d2h", 0) + 1
            a["d2h_bytes"] = (a.get("d2h_bytes", 0)
                              + t.numel() * t.element_size())
    return t.cpu()


# ---------------------------------------------------------------------------
# device time of CUDA graph replays
# ---------------------------------------------------------------------------

def timing() -> bool:
    """True while graph replays are timed: a tracer is active or
    ``torch.profiler`` collects."""
    return _ACTIVE is not None or _profiling()


class DeviceTime:
    """Device time of one session's graph replays timed with no tracer
    active (the untraced dispatch): ``replays``, ``calls`` (the session
    calls that made at least one, counted by the session), and
    ``seconds``, added as the event pairs resolve (``settle()`` resolves
    the rest).  A replay outside a session call (``warmup_widths``'
    throwaway probe) adds its seconds and no call."""

    __slots__ = ("calls", "replays", "seconds")

    def __init__(self):
        self.calls = 0
        self.replays = 0
        self.seconds = 0.0


def _new_event():
    return torch.cuda.Event(enable_timing=True)


def _take():
    global _TAKEN
    with _TIMING_LOCK:
        _TAKEN += 1
        if _FREE:
            return _FREE.pop()
    return _new_event()


def events_taken() -> int:
    """CUDA timing events ever taken from the pool in this process."""
    return _TAKEN


def _resolve(wait: bool) -> None:
    """Resolve the pending pairs that completed, or with ``wait`` all of
    them (one wait on the newest; a pair of another stream that is still
    running is waited for alone)."""
    with _TIMING_LOCK:
        if wait and _PENDING:
            _PENDING[-1][1].synchronize()
        while _PENDING:
            start, end, sink, args = _PENDING[0]
            if not end.query():
                if not wait:
                    break
                end.synchronize()
            _PENDING.popleft()
            ms = start.elapsed_time(end)
            if sink is not None:
                sink.seconds += ms / 1e3
            if args is not None:
                args["device_ms"] = ms
            _FREE.extend((start, end))


def settle() -> None:
    """Resolve every timed replay still pending (waits for the device
    only where one is)."""
    if _PENDING:
        _resolve(wait=True)


class _TimedReplay:
    """A span around a graph replay, bracketed by two timing events."""

    __slots__ = ("_span", "_sink", "_start", "_end")

    def __init__(self, sp, sink: Optional[DeviceTime]):
        self._span = sp
        self._sink = sink

    def __enter__(self):
        self._span.__enter__()
        if _PENDING:
            _resolve(wait=False)
        self._start, self._end = _take(), _take()
        self._start.record()
        return self._span

    def __exit__(self, *exc):
        self._end.record()
        sink = self._sink
        if sink is not None:
            sink.replays += 1
        args = getattr(self._span, "args", None)
        with _TIMING_LOCK:
            _PENDING.append((self._start, self._end, sink, args))
        return self._span.__exit__(*exc)


def replay_span(name: str, sink: Optional[DeviceTime] = None,
                cat: str = "device", **args):
    """``span(name)`` around a CUDA graph replay; while timing is on, its
    device time is taken by a pair of timing events: into ``sink`` with
    no tracer active, else onto the tracer's span as ``device_ms`` when
    the pair resolves."""
    if not timing():
        return _NOOP
    return _TimedReplay(span(name, cat, **args),
                        sink if _ACTIVE is None else None)


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
    while tracing, and not inside a CUDA graph's capture (the production
    path never synchronizes).  Returns ``x``."""
    t = _ACTIVE
    if t is not None and not _capturing():
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
    """Deactivate and return the active tracer (errors if none), its
    timed replays resolved."""
    global _ACTIVE
    settle()
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
