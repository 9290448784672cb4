"""Deadline-batched request queue with probe-signature admission (the
port's own copy of ``repro/gateway/queue.py``: host-only, stdlib).

The queue is the gateway's coalescing buffer: single-query arrivals
wait here until either the oldest request's flush deadline expires or a
full dispatch bucket has accumulated — whichever comes first — and are
then taken as one batch (``Gateway`` dispatches it through a compiled
``Searcher`` bucket).

Admission is *probe-signature-aware*: each request carries the id of
its nearest centroid (its rank-0 probed list, computed host-side at
submit time), and the queue keeps one FIFO lane per signature.
``take_batch`` drains whole lanes oldest-first, so requests probing the
same lists land in the same dispatch — exactly the traffic shape the
clustered exec mode and the session ``plan_reuse`` cache are built for
(queries sharing probed lists co-tile, and adjacent batches re-probe
the same hot lists).  FIFO order is preserved *within* a lane, and
lanes are served by the age of their oldest request, so signature
grouping can reorder requests only within one flush window — bounded
by the deadline, never starvation.

Admission is *bounded* (DESIGN.md §13): with ``max_queue`` set, a full
queue either sheds the arrival (``policy="reject"`` raises
``Overloaded`` — the producer was never enqueued, retry after backoff
is safe) or applies backpressure (``policy="block"`` parks the
producer thread until the dispatcher frees a slot).  Unbounded is the
default only because the gateway owns choosing a bound.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import List, NamedTuple, Optional

from ..errors import GatewayClosed, Overloaded

_OVERLOAD_POLICIES = ("reject", "block")


class RequestResult(NamedTuple):
    """What a completed request resolves to."""
    ids: "object"          # (k,) int64 result ids (external ids under churn)
    dists: "object"        # (k,) float32 exact distances
    latency_s: float       # enqueue -> fulfilled
    queued_s: float        # enqueue -> taken into a batch
    batch: int             # coalesced batch size this request rode in
    epoch: int             # index epoch that served it
    level: int = 0         # degradation-ladder quality level (0 = full)


class PendingRequest:
    """A submitted query: future-like handle the client blocks on."""

    __slots__ = ("query", "t_enqueue", "deadline", "signature",
                 "_event", "_result", "_error")

    def __init__(self, query, signature: int,
                 deadline: Optional[float] = None):
        self.query = query
        self.t_enqueue = time.perf_counter()
        self.deadline = deadline      # absolute perf_counter time or None
        self.signature = signature
        self._event = threading.Event()
        self._result: Optional[RequestResult] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> RequestResult:
        """Block until fulfilled; raises the dispatch error if it failed."""
        if not self._event.wait(timeout):
            raise TimeoutError("gateway request not fulfilled in time")
        if self._error is not None:
            raise self._error
        return self._result

    # -- fulfilled by the dispatcher ------------------------------------
    def _fulfill(self, result: RequestResult) -> None:
        self._result = result
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()


class RequestQueue:
    """Signature-laned FIFO with a condition variable the dispatcher
    sleeps on.  All methods are thread-safe."""

    def __init__(self, grouped: bool = True,
                 max_queue: Optional[int] = None, policy: str = "reject"):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 or None, "
                             f"got {max_queue}")
        if policy not in _OVERLOAD_POLICIES:
            raise ValueError(f"policy must be one of {_OVERLOAD_POLICIES}, "
                             f"got {policy!r}")
        self.grouped = grouped
        self.max_queue = max_queue
        self.policy = policy
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # one FIFO lane per probe signature (signature 0 lane only when
        # grouping is off); OrderedDict keeps lane creation order cheap
        self._lanes: "collections.OrderedDict[int, collections.deque]" = \
            collections.OrderedDict()
        self._depth = 0
        self._peak = 0
        self._closed = False

    @property
    def depth(self) -> int:
        return self._depth

    def take_peak(self) -> int:
        """High-watermark depth since the last call (and reset to the
        current depth).  The degradation ladder keys on this, not on an
        instantaneous sample: the dispatcher wakes the moment a full
        batch accumulates, so sampling depth right after the flush wait
        systematically reads ~max_batch even while the queue saturates
        and sheds *between* wakeups."""
        with self._lock:
            peak = self._peak
            self._peak = self._depth
            return peak

    def put(self, req: PendingRequest) -> None:
        """Enqueue one request, applying the overload policy when the
        queue is bounded and full: "reject" raises ``Overloaded``
        without enqueuing; "block" parks this producer until the
        dispatcher frees a slot (raising ``GatewayClosed`` if the
        gateway shuts down while it waits)."""
        key = req.signature if self.grouped else 0
        with self._cond:
            if self.max_queue is not None and self._depth >= self.max_queue:
                if self.policy == "reject":
                    raise Overloaded(
                        f"queue at max_queue={self.max_queue}; shed")
                while self._depth >= self.max_queue and not self._closed:
                    self._cond.wait()
            if self._closed:
                raise GatewayClosed("gateway is closed")
            lane = self._lanes.get(key)
            if lane is None:
                lane = self._lanes[key] = collections.deque()
            lane.append(req)
            self._depth += 1
            if self._depth > self._peak:
                self._peak = self._depth
            self._cond.notify()

    def kick(self) -> None:
        """Wake the dispatcher without enqueuing (close, handover-ready)."""
        with self._cond:
            self._cond.notify_all()

    def close(self) -> None:
        """Mark closed and wake everyone: blocked producers raise
        ``GatewayClosed``, the dispatcher sees the flag and drains."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def oldest_flush_at(self, max_delay: float) -> Optional[float]:
        """Earliest moment any queued request must flush (perf_counter
        time), honoring per-request deadlines; None when empty."""
        with self._lock:
            t = None
            for lane in self._lanes.values():
                if not lane:
                    continue
                r = lane[0]
                due = r.t_enqueue + max_delay
                if r.deadline is not None:
                    due = min(due, r.deadline)
                t = due if t is None else min(t, due)
            return t

    def wait_for_work(self, timeout: Optional[float]) -> None:
        """Sleep until a request arrives, a kick, or the timeout."""
        with self._cond:
            if self._depth == 0:
                self._cond.wait(timeout)

    def wait_for_flush(self, max_batch: int, due: float) -> None:
        """Sleep out the coalescing window: returns once ``max_batch``
        requests have accumulated or the flush deadline ``due``
        (perf_counter time) passes."""
        with self._cond:
            while self._depth < max_batch:
                remaining = due - time.perf_counter()
                if remaining <= 0:
                    return
                self._cond.wait(remaining)

    def take_expired(self, now: float) -> List[PendingRequest]:
        """Remove (and return) every queued request whose deadline is
        already past at ``now`` — the dispatcher fails these with
        ``DeadlineExceeded`` instead of dispatching them (a scan whose
        client has given up is pure wasted capacity)."""
        with self._cond:
            if self._depth == 0:
                return []
            out: List[PendingRequest] = []
            for key in list(self._lanes):
                lane = self._lanes[key]
                kept = collections.deque(
                    r for r in lane
                    if r.deadline is None or r.deadline >= now)
                if len(kept) != len(lane):
                    out.extend(r for r in lane
                               if r.deadline is not None and r.deadline < now)
                    if kept:
                        self._lanes[key] = kept
                    else:
                        del self._lanes[key]
            self._depth -= len(out)
            if out:
                self._cond.notify_all()   # free slots for blocked producers
            return out

    def take_batch(self, max_batch: int) -> List[PendingRequest]:
        """Drain up to ``max_batch`` requests, whole signature lanes at a
        time, lanes ordered by their oldest member (never starves)."""
        with self._cond:
            if self._depth == 0:
                return []
            order = sorted(
                (k for k, lane in self._lanes.items() if lane),
                key=lambda k: self._lanes[k][0].t_enqueue)
            out: List[PendingRequest] = []
            for key in order:
                lane = self._lanes[key]
                while lane and len(out) < max_batch:
                    out.append(lane.popleft())
                if not lane:
                    del self._lanes[key]
                if len(out) >= max_batch:
                    break
            self._depth -= len(out)
            if out:
                self._cond.notify_all()   # free slots for blocked producers
            return out
