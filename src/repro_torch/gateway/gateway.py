"""The async serving gateway of the port (counterpart of
``repro/gateway/gateway.py``; DESIGN.md §10).

``Gateway`` turns the session layer into a service: single-query
requests arrive continuously (``submit`` / ``search`` from any thread),
wait in a deadline-batched queue (queue.py), and a dispatcher thread
coalesces them into the pad-and-dispatch batch buckets the ``Searcher``
sessions already AOT-compile — flushing on the oldest request's
deadline or on a full bucket, whichever comes first.  Admission groups
requests by probe signature so clustered tiles and the ``plan_reuse``
cache stay hot across consecutive dispatches.

Zero-downtime epoch handover (streaming indexes): ``compact_async``
snapshots the epoch (``StreamingIndex.begin_compact``), folds it on a
worker thread while the dispatcher keeps serving the pinned old-epoch
session, and the dispatcher installs the new epoch atomically *between*
batches — no in-flight request is dropped or stale-errored, and
because responses carry stable external ids, results clients are
holding remain valid across the swap (``resolve_ids``).

Handover state machine::

    IDLE --compact_async--> FOLDING --fold done--> READY
    READY --dispatcher, between batches--> INSTALLING --> IDLE
                (install + session refresh + width-ladder warmup)

Telemetry is first-class and pluggable (telemetry.py): QPS, DCO,
queue depth, batch-fill ratio, recall proxies, and p50/p95/p99 latency
histograms via ``stats()`` plus a periodic structured JSON log.

On the card (what the reference's functional arrays do not need):

  * a session's executables are CUDA graphs over static buffers in one
    memory pool, captured with PyTorch's default (global) capture mode,
    during which a CUDA call from any other thread may break the
    capture.  So every use of the card goes through ``self._lock``:
    dispatch, the ladder's warmup (which captures), install, and the
    mutations.  The client side (``submit``: the admission signature,
    the queue) and the fold worker (``PendingCompaction.fold`` is numpy
    only) never touch the card, and ``submit`` refuses a query that
    lives on it.  A caller must not run CUDA work of its own on another
    thread while a gateway on the card is live;
  * the admission signature is scored on a host copy of the centroids,
    taken once, in numpy exactly as the reference scores it, so one
    query gets the same signature (and lane) in both packages;
  * a dispatched batch's results are copied to the host once, under the
    lock (a probe graph's outputs are its static buffers, valid only
    until its next replay), and the requests are answered from that
    copy.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import faults, obs
from ..core.params import SearchParams
from ..core.stream.streaming import StreamingIndex
from ..errors import (DeadlineExceeded, GatewayClosed, HandoverFailed,
                      Overloaded, StaleSessionError)
from .queue import PendingRequest, RequestQueue, RequestResult
from .telemetry import Telemetry, TelemetrySink

_ADMISSION_MODES = ("signature", "fifo")
_OVERLOAD_POLICIES = ("reject", "block")


def degrade_ladder(params: SearchParams, levels: int = 2,
                   factor: float = 0.5) -> Tuple[SearchParams, ...]:
    """Derive a quality/cost ladder below ``params``: each level scales
    ``nprobe`` (and any explicit ``max_scan``) by ``factor`` over the
    previous one, floored at 1 probe.  Level 0 is ``params`` itself —
    full quality; RAIRS's redundant assignment means the early probes
    carry most of the recall, so halving nprobe sheds scan cost much
    faster than it sheds recall (the knob the ladder exists to turn)."""
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    out = [params]
    for _ in range(levels):
        p = out[-1]
        nprobe = max(1, int(p.nprobe * factor))
        if nprobe == p.nprobe and p.nprobe > 1:
            nprobe = p.nprobe - 1
        kw = {"nprobe": nprobe}
        if p.max_scan is not None:
            kw["max_scan"] = max(p.k, int(p.max_scan * factor))
        out.append(dataclasses.replace(p, **kw))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    """Gateway-side knobs (query knobs stay in ``SearchParams``).

    max_delay_ms        micro-batch deadline: the longest a request may
                        wait for co-batching before it flushes anyway
    max_batch           coalescing target (clamped to the session's
                        ``max_chunk``); a full bucket flushes early
    admission           "signature" groups requests by their rank-0
                        probed list (plan/tile locality), "fifo" is
                        arrival order only
    warmup              pre-compile the dispatch bucket (and, with
                        plan_reuse, the whole union-width ladder) at
                        startup and after each epoch swap
    telemetry_interval_s  period of the structured telemetry log through
                        the configured sinks (0 = no periodic log)
    compact_delta_frac  background-handover trigger: delta slots exceed
                        this fraction of the base (None = explicit only)
    compact_dead_frac   background-handover trigger: tombstones exceed
                        this fraction of the id space (None = explicit)
    max_queue           bounded admission (DESIGN.md §13): queue depth
                        cap; None = unbounded (no shedding, no degrade)
    overload            policy when the bounded queue is full:
                        "reject" sheds the arrival with ``Overloaded``,
                        "block" applies producer backpressure
    drain_s             close() grace window: how long the dispatcher
                        keeps flushing queued work before failing
                        leftovers with ``GatewayClosed``; None drains
                        until empty, 0 fails queued work immediately
    degrade             quality/cost ladder: SearchParams tuple *below*
                        level 0 (= the gateway params), stepped down
                        under sustained queue pressure and back up when
                        load recedes; see ``degrade_ladder``.  Requires
                        max_queue (watermarks are depth fractions)
    degrade_high        step-down watermark, fraction of max_queue
    degrade_low         step-up watermark, fraction of max_queue
    degrade_hold        hysteresis: consecutive dispatch cycles the
                        depth must sit past a watermark before stepping
    handover_retries    extra fold attempts before a failed async
                        compaction rolls back and surfaces
                        ``HandoverFailed``
    handover_backoff_s  sleep before fold retry i, scaled by 2**i
    """
    max_delay_ms: float = 2.0
    max_batch: int = 256
    admission: str = "signature"
    warmup: bool = True
    telemetry_interval_s: float = 0.0
    compact_delta_frac: Optional[float] = None
    compact_dead_frac: Optional[float] = None
    max_queue: Optional[int] = None
    overload: str = "reject"
    drain_s: Optional[float] = None
    degrade: Optional[Tuple[SearchParams, ...]] = None
    degrade_high: float = 0.75
    degrade_low: float = 0.25
    degrade_hold: int = 3
    handover_retries: int = 2
    handover_backoff_s: float = 0.05

    def __post_init__(self):
        if self.max_delay_ms < 0:
            raise ValueError(
                f"max_delay_ms must be >= 0, got {self.max_delay_ms}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.admission not in _ADMISSION_MODES:
            raise ValueError(f"admission must be one of {_ADMISSION_MODES}, "
                             f"got {self.admission!r}")
        for name in ("compact_delta_frac", "compact_dead_frac"):
            v = getattr(self, name)
            if v is not None and not v > 0:
                raise ValueError(f"{name} must be > 0 or None, got {v!r}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1 or None, got {self.max_queue}")
        if self.overload not in _OVERLOAD_POLICIES:
            raise ValueError(f"overload must be one of {_OVERLOAD_POLICIES}, "
                             f"got {self.overload!r}")
        if self.drain_s is not None and self.drain_s < 0:
            raise ValueError(
                f"drain_s must be >= 0 or None, got {self.drain_s}")
        if self.degrade is not None:
            if self.max_queue is None:
                raise ValueError("degrade ladder needs max_queue: the "
                                 "watermarks are fractions of the bound")
            if not self.degrade:
                raise ValueError("degrade must be a non-empty tuple of "
                                 "SearchParams (or None)")
            if not 0.0 < self.degrade_low < self.degrade_high <= 1.0:
                raise ValueError(
                    f"need 0 < degrade_low < degrade_high <= 1, got "
                    f"low={self.degrade_low} high={self.degrade_high}")
            if self.degrade_hold < 1:
                raise ValueError(
                    f"degrade_hold must be >= 1, got {self.degrade_hold}")
        if self.handover_retries < 0:
            raise ValueError(f"handover_retries must be >= 0, "
                             f"got {self.handover_retries}")
        if self.handover_backoff_s < 0:
            raise ValueError(f"handover_backoff_s must be >= 0, "
                             f"got {self.handover_backoff_s}")


class Handover:
    """Handle for one zero-downtime epoch swap (``compact_async``)."""

    def __init__(self, pending):
        self.pending = pending
        self.state = "folding"     # folding -> ready -> installed | failed
        self.info: Optional[dict] = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    def wait(self, timeout: Optional[float] = None) -> dict:
        """Block until installed; returns the install info dict."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"handover still {self.state}")
        if self.error is not None:
            raise self.error
        return self.info


class Gateway:
    """Deadline-batched serving front-end over any index exposing the
    session protocol (``RairsIndex`` / ``StreamingIndex``).  Create,
    submit from any thread, ``close()`` (or use as a context manager) to
    drain and stop.  It serves on the index's device: the card, unless
    the index was built or loaded with ``device="cpu"``."""

    def __init__(self, index, params: Optional[SearchParams] = None,
                 config: Optional[GatewayConfig] = None,
                 sinks: Tuple[TelemetrySink, ...] = (), **param_kwargs):
        if params is None:
            params = SearchParams(**param_kwargs)
        elif param_kwargs:
            params = dataclasses.replace(params, **param_kwargs)
        self.index = index
        self.params = params.resolve(index)
        cfg = config or GatewayConfig()
        if cfg.max_batch > self.params.max_chunk:
            cfg = dataclasses.replace(cfg, max_batch=self.params.max_chunk)
        self.config = cfg
        self.telemetry = Telemetry()
        self._sinks = tuple(sinks)
        self._is_stream = isinstance(index, StreamingIndex)
        if not self._is_stream and (cfg.compact_delta_frac is not None
                                    or cfg.compact_dead_frac is not None):
            raise ValueError("compact_*_frac thresholds need a "
                             "StreamingIndex (nothing to compact otherwise)")
        # quality/cost ladder: level 0 is the configured params, lower
        # levels are cheaper SearchParams served under queue pressure
        ladder = [self.params]
        for p in (cfg.degrade or ()):
            p = p.resolve(index)
            if p.k != self.params.k:
                raise ValueError(
                    f"every degrade level must keep k={self.params.k} "
                    f"(result shape is part of the response contract), "
                    f"got k={p.k}")
            ladder.append(p)
        self._ladder: Tuple[SearchParams, ...] = tuple(ladder)
        self._level = 0
        self._hold_down = 0          # cycles spent above the high mark
        self._hold_up = 0            # cycles spent below the low mark
        self.queue = RequestQueue(grouped=cfg.admission == "signature",
                                  max_queue=cfg.max_queue,
                                  policy=cfg.overload)
        # host-side probe-signature scorer: centroids are frozen across
        # compaction, so one host copy serves every epoch
        self._centroids = np.asarray(index.centroids.detach().cpu(),
                                     np.float32)
        self._c2 = (self._centroids ** 2).sum(axis=1)
        self._metric = index.config.metric
        self._dim = int(self._centroids.shape[1])
        self._lock = threading.RLock()   # session use + mutations + install
        self._last_session = None
        self._warm_epoch: object = None  # last epoch the ladder was warmed on
        self._handover: Optional[Handover] = None
        self._last_handover: Optional[dict] = None
        self._last_emit = time.perf_counter()
        self._closed = threading.Event()
        self._drain_deadline: Optional[float] = None
        with self._lock:
            self._session_locked()       # build + warm the serving session
        self._thread = threading.Thread(
            target=self._serve_loop, name="gateway-dispatch", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # client API (any thread)
    # ------------------------------------------------------------------
    def submit(self, query, deadline_s: Optional[float] = None
               ) -> PendingRequest:
        """Enqueue one query vector (host memory: numpy, or a CPU
        tensor); returns a future-like handle.
        ``deadline_s`` tightens this request's flush deadline below the
        gateway-wide ``max_delay_ms`` (it never loosens it) — and a
        request still queued past its deadline is failed with
        ``DeadlineExceeded`` at dequeue, never dispatched.

        Bounded admission (``max_queue``) never raises from here: a
        shed arrival comes back as an already-failed handle whose
        ``result()`` raises ``Overloaded``, so open-loop producers keep
        a uniform submit -> result error path under overload."""
        if self._closed.is_set():
            raise GatewayClosed("gateway is closed")
        with obs.span("gateway.submit", cat="gateway"):
            if torch.is_tensor(query):
                if query.device.type != "cpu":
                    # a client thread must not touch the card (module
                    # docstring): the dispatcher may be capturing
                    raise TypeError(
                        f"submit takes a host query (numpy or a CPU "
                        f"tensor), got a tensor on {query.device}")
                query = query.numpy()
            q = np.asarray(query, np.float32)
            if q.ndim == 2 and q.shape[0] == 1:
                q = q[0]
            if q.ndim != 1 or q.shape[0] != self._dim:
                raise ValueError(
                    f"query must be ({self._dim},), got shape {q.shape}")
            sig = self._signature(q) if self.queue.grouped else 0
            deadline = (time.perf_counter() + deadline_s
                        if deadline_s is not None else None)
            req = PendingRequest(q, sig, deadline=deadline)
            self.telemetry.inc("requests")
            try:
                self.queue.put(req)
            except Overloaded as e:
                self.telemetry.inc("shed")
                req._fail(e)
        return req

    def search(self, query, timeout: Optional[float] = None) -> RequestResult:
        """Blocking single-query convenience over ``submit``."""
        return self.submit(query).result(timeout)

    # -- mutations (streaming indexes; serialized with dispatch) --------
    def insert(self, x) -> np.ndarray:
        """Insert vectors; returns their *stable external* ids (valid
        across any number of epoch handovers)."""
        self._require_stream("insert")
        with self._lock:
            ids = self.index.insert(x)
            ext = self.index.external_ids(ids)
        self.telemetry.inc("inserts", int(ext.size))
        self._maybe_auto_handover()
        return ext

    def delete(self, external_ids) -> int:
        """Tombstone items by their external ids; returns how many were
        live.  Unknown / already-dead handles are a no-op."""
        self._require_stream("delete")
        with self._lock:
            internal = self.index.resolve_ids(external_ids)
            n = self.index.delete(internal[internal >= 0])
        self.telemetry.inc("deletes", n)
        self._maybe_auto_handover()
        return n

    def resolve_ids(self, external_ids) -> np.ndarray:
        """Current internal ids for previously returned external ids."""
        self._require_stream("resolve_ids")
        with self._lock:
            return self.index.resolve_ids(external_ids)

    # -- zero-downtime handover -----------------------------------------
    def compact_async(self, reason: str = "gateway") -> Handover:
        """Start a background epoch handover; serving continues on the
        old epoch until the dispatcher installs the folded one between
        batches.  Returns a ``Handover`` to ``wait()`` on; idempotent
        while one is in flight."""
        self._require_stream("compact_async")
        with self._lock:
            if self._handover is not None:
                return self._handover
            pending = self.index.begin_compact(reason)
            h = Handover(pending)
            self._handover = h
        threading.Thread(target=self._fold_worker, args=(h,),
                         name="gateway-fold", daemon=True).start()
        return h

    def _fold_worker(self, h: Handover) -> None:
        cfg = self.config
        last = None
        for attempt in range(cfg.handover_retries + 1):
            if attempt:
                self.telemetry.inc("handover_retries")
                time.sleep(cfg.handover_backoff_s * 2 ** (attempt - 1))
            try:
                faults.injected("gateway.fold")
                h.pending.fold()
                h.state = "ready"
                break
            except BaseException as e:
                # a failed fold leaves the snapshot intact (state stays
                # "folding"), so retrying is safe; serving meanwhile
                # continues on the pinned old epoch
                last = e
        else:
            self._handover_failed(h, last, "fold")
        self.queue.kick()            # wake the dispatcher to install

    def _handover_failed(self, h: Handover, cause: BaseException,
                         stage: str) -> None:
        """Roll back: abort the pending compaction (the old epoch stays
        installed and keeps serving; the id-remap chain is untouched)
        and surface ``HandoverFailed`` through the handle."""
        err = HandoverFailed(
            f"epoch handover failed at {stage} after "
            f"{self.config.handover_retries + 1} attempt(s): {cause!r}")
        err.__cause__ = cause
        h.error = err
        h.state = "failed"
        h.pending.abort()
        with self._lock:
            self._handover = None
        self.telemetry.inc("handover_failures")
        tr = obs.tracer()
        if tr is not None:
            tr.event("gateway.handover_failed", time.perf_counter(), 0.0,
                     cat="gateway", stage=stage, error=repr(cause))
        h._done.set()

    def _maybe_auto_handover(self) -> None:
        c = self.config
        st = self.index
        if self._handover is not None:
            return
        n_delta_slots = st.n_total - st.n_base
        if (c.compact_delta_frac is not None
                and n_delta_slots > c.compact_delta_frac
                * max(1, st.n_base)):
            self.compact_async("delta_threshold")
        elif (c.compact_dead_frac is not None
                and st.n_dead > c.compact_dead_frac * max(1, st.n_total)):
            self.compact_async("dead_threshold")

    # ------------------------------------------------------------------
    # observability / lifecycle
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """One coherent dict: telemetry snapshot, queue depth, handover
        state, session compile stats, and (streaming) epoch state."""
        h = self._handover
        out = {
            "telemetry": self.telemetry.snapshot(),
            "queue_depth": self.queue.depth,
            "closed": self._closed.is_set(),
            "handover": {"state": h.state if h is not None else "idle",
                         "last": self._last_handover},
            "quality": {"level": self._level,
                        "ladder_levels": len(self._ladder)},
        }
        sess = self._last_session
        if sess is not None:
            out["session"] = sess.compile_stats()
        if self._is_stream:
            st = self.index
            out["stream"] = {"epoch": st.epoch, "version": st.version,
                             "n_live": st.n_live, "n_delta": st.n_delta,
                             "n_dead": st.n_dead}
        return out

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work, drain queued requests for up to
        ``config.drain_s``, stop the dispatcher, emit a final record.
        Requests still queued when the drain window closes fail with
        ``GatewayClosed`` — typed, never a bare RuntimeError."""
        if self._closed.is_set():
            return
        if self.config.drain_s is not None:
            self._drain_deadline = time.perf_counter() + self.config.drain_s
        self._closed.set()
        self.queue.close()           # wake dispatcher + blocked producers
        self._thread.join(timeout)
        if self._sinks:
            self.telemetry.emit(self._sinks, kind="gateway_final",
                                extra={"queue_depth": self.queue.depth})

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # dispatcher internals
    # ------------------------------------------------------------------
    def _require_stream(self, what: str) -> None:
        if not self._is_stream:
            raise TypeError(f"{what} needs a StreamingIndex-backed gateway "
                            f"(got {type(self.index).__name__})")

    def _bucket_ladder(self, p: Optional[SearchParams] = None) -> list:
        """Every dispatch bucket a flush can land in: deadline flushes
        carry anywhere from 1 to ``max_batch`` requests."""
        p = p or self.params
        top = p.bucket_for(min(self.config.max_batch, p.max_chunk))
        if p.batch_buckets is not None:
            return [b for b in p.batch_buckets if b <= top]
        sizes, b = [], 1
        while b <= top:
            sizes.append(b)
            b *= 2
        return sizes

    def _signature(self, q: np.ndarray) -> int:
        """Rank-0 probed list, host-side (admission locality hint)."""
        if self._metric == "ip":
            return int(np.argmax(self._centroids @ q))
        return int(np.argmin(self._c2 - 2.0 * (self._centroids @ q)))

    def _session_locked(self):
        """The serving session for the *current quality level*;
        refreshed (and, on an epoch change, width-warmed across every
        ladder level) when the index has moved past it."""
        params = self._ladder[self._level]
        dev = self.index.device
        sess = self.index.searcher(params, device=dev)
        epoch = getattr(sess, "epoch", 0)
        if self.config.warmup and epoch != self._warm_epoch:
            # a new epoch starts with cold executable caches: pre-pay
            # the compiles now, not on the first request — every batch
            # bucket a partial flush can dispatch at (and with
            # plan_reuse, each bucket's union-width ladder), for every
            # degradation level a pressure step can switch to (a step-
            # down must never stall on a compile).  A pristine streaming
            # session delegates to its base session — warm the delegate.
            self._warm_epoch = epoch
            for p in self._ladder:
                s = self.index.searcher(p, device=dev)
                target = getattr(s, "_delegate", None) or s
                before = target.stats.warmup_compiles
                target.warmup_widths(*self._bucket_ladder(p))
                self.telemetry.inc(
                    "warmup_compiles",
                    target.stats.warmup_compiles - before)
        self._last_session = sess
        return sess

    def _serve_loop(self) -> None:
        try:
            while True:
                self._install_if_ready()
                self._maybe_emit()
                # true deadline enforcement: a request the dispatcher
                # could not reach by its deadline is failed here, at
                # dequeue, never dispatched — the check runs *before*
                # this cycle's flush wait, so a healthy request taken
                # exactly at its deadline still rides its flush
                self._fail_expired(time.perf_counter())
                if self._closed.is_set():
                    dd = self._drain_deadline
                    if self.queue.depth == 0 or (
                            dd is not None
                            and time.perf_counter() >= dd):
                        break
                due = self.queue.oldest_flush_at(
                    self.config.max_delay_ms / 1e3)
                if due is None:
                    self.queue.wait_for_work(0.05)   # idle tick
                    continue
                if not self._closed.is_set():        # draining flushes now
                    self.queue.wait_for_flush(self.config.max_batch, due)
                self._adjust_level()
                batch = self.queue.take_batch(self.config.max_batch)
                if batch:
                    self._dispatch(batch)
        finally:
            for req in self.queue.take_batch(1 << 30):   # never strand
                req._fail(GatewayClosed("gateway closed before this "
                                        "request could be dispatched"))

    def _fail_expired(self, now: float) -> None:
        expired = self.queue.take_expired(now)
        if not expired:
            return
        self.telemetry.inc("deadline_failures", len(expired))
        for r in expired:
            late_ms = (now - r.deadline) * 1e3
            r._fail(DeadlineExceeded(
                f"request deadline passed {late_ms:.1f}ms before dispatch"))

    def _adjust_level(self) -> None:
        """Degradation-ladder hysteresis, one decision per dispatch
        cycle: sustained depth above the high watermark steps quality
        down a level; sustained depth below the low watermark steps
        back up.  Transitions are telemetry counters + trace events."""
        cfg = self.config
        if len(self._ladder) == 1 or cfg.max_queue is None:
            return
        depth = self.queue.take_peak()   # high-watermark since last cycle
        if depth >= cfg.degrade_high * cfg.max_queue:
            self._hold_up = 0
            if self._level < len(self._ladder) - 1:
                self._hold_down += 1
                if self._hold_down >= cfg.degrade_hold:
                    self._step_to(self._level + 1, depth)
        elif depth <= cfg.degrade_low * cfg.max_queue:
            self._hold_down = 0
            if self._level > 0:
                self._hold_up += 1
                if self._hold_up >= cfg.degrade_hold:
                    self._step_to(self._level - 1, depth)
        else:
            self._hold_down = self._hold_up = 0

    def _step_to(self, level: int, depth: int) -> None:
        down = level > self._level
        self._level = level
        self._hold_down = self._hold_up = 0
        tm = self.telemetry
        tm.inc("degrade_steps_down" if down else "degrade_steps_up")
        tm.gauge("quality_level", level)
        tr = obs.tracer()
        if tr is not None:
            tr.event("gateway.degrade", time.perf_counter(), 0.0,
                     cat="gateway", level=level, queue_depth=depth,
                     direction="down" if down else "up")

    def _install_if_ready(self) -> None:
        h = self._handover
        if h is None or h.state != "ready":
            return
        try:
            with self._lock:
                info = h.pending.install()
                self._session_locked()   # refresh + warm the new epoch
        except BaseException as e:
            # a failed install rolls back like a failed fold: abort the
            # pending compaction so the old epoch (still installed)
            # resumes auto-compaction eligibility, and surface typed
            self._handover_failed(h, e, "install")
            return
        h.info = info
        h.state = "installed"
        self._last_handover = {k: v for k, v in info.items()
                               if k != "id_remap"}
        self.telemetry.inc("handovers")
        with self._lock:
            self._handover = None
        h._done.set()

    def _dispatch(self, batch) -> None:
        tm = self.telemetry
        t_take = time.perf_counter()
        tm.observe(
            gauges={"queue_depth": self.queue.depth},
            latencies=[(tm.queue_wait, t_take - r.t_enqueue)
                       for r in batch])
        level = self._level
        with obs.span("gateway.flush", cat="gateway",
                      batch=len(batch)) as fsp:
            q = np.stack([r.query for r in batch])
            try:
                faults.injected("gateway.dispatch")
                with self._lock:
                    res, epoch = self._search_locked(q)
                    # one host copy of the batch, before the lock is
                    # released (module docstring)
                    ids, dists, approx, refine = (
                        a.cpu().numpy() for a in (res.ids, res.dists,
                                                  res.approx_dco,
                                                  res.refine_dco))
                    if self._is_stream:
                        # responses carry stable external ids so clients
                        # survive epoch handovers (resolve_ids maps back)
                        ids = self.index.external_ids(ids)
                    else:
                        ids = ids.astype(np.int64)
                    approx = float(np.sum(approx))
                    refine = float(np.sum(refine))
            except BaseException as e:
                tm.inc("errors", len(batch))
                for r in batch:
                    r._fail(e)
                return
            fsp.add(approx_dco=approx, refine_dco=refine)
        t_done = time.perf_counter()
        counters = {
            "batches": 1,
            "responses": len(batch),
            "bucket_rows": self.params.bucket_for(
                min(len(batch), self.params.max_chunk)),
        }
        if len(self._ladder) > 1:
            counters[f"responses_level_{level}"] = len(batch)
        # one atomic multi-metric update per dispatch: a snapshot racing
        # this sees the batch fully counted or not at all, so derived
        # cross-metric invariants (latency.count == responses) are exact
        tm.observe(
            counters=counters,
            sums={"approx_dco": approx, "refine_dco": refine,
                  "result_slots": float(ids.size),
                  "result_filled": float((ids >= 0).sum())},
            # exact top-1 distances are signed under the ip metric
            # (finalize scores are negated inner products) — not monotone
            signed={"top1_dist": float(dists[:, 0].sum())},
            latencies=[(tm.dispatch, t_done - t_take)]
                      + [(tm.latency, t_done - r.t_enqueue)
                         for r in batch])
        tr = obs.tracer()
        for i, r in enumerate(batch):
            if tr is not None and tr.sampled():
                # one exemplar complete-event per sampled request,
                # spanning enqueue -> fulfill on a virtual request track
                tr.event("gateway.request", r.t_enqueue,
                         t_done - r.t_enqueue,
                         queued_ms=(t_take - r.t_enqueue) * 1e3,
                         batch=len(batch), epoch=epoch)
            r._fulfill(RequestResult(
                ids=ids[i], dists=dists[i], latency_s=t_done - r.t_enqueue,
                queued_s=t_take - r.t_enqueue, batch=len(batch),
                epoch=epoch, level=level))

    def _search_locked(self, q: np.ndarray):
        """Dispatch through the current session; a session staled by an
        out-of-band mutation (the caller bypassing the gateway) is
        refreshed and retried rather than surfacing to clients."""
        last_err = None
        for _ in range(3):
            sess = self._session_locked()
            try:
                return sess(q), getattr(sess, "epoch", 0)
            except StaleSessionError as e:
                self.telemetry.inc("stale_retries")
                last_err = e
        raise last_err

    def _maybe_emit(self) -> None:
        iv = self.config.telemetry_interval_s
        if not self._sinks or iv <= 0:
            return
        now = time.perf_counter()
        if now - self._last_emit >= iv:
            self._last_emit = now
            self.telemetry.emit(self._sinks,
                                extra={"queue_depth": self.queue.depth})
