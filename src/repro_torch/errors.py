"""Typed error taxonomy (the port's own copy of ``repro/errors.py``).

Every failure a caller can observe from persistence, streaming and the
gateway is a subclass of ``RairsError``, so ``except RairsError``
catches "the system told me no" while genuine bugs (TypeError,
KeyError, ...) propagate.  Several
leaves also subclass the stdlib exception callers saw at that site
(``CorruptBundleError`` is a ValueError, ``DeadlineExceeded`` a
TimeoutError, ``GatewayClosed`` a RuntimeError).  Same names and bases
as the reference, so code written against either package catches the
same errors.  Dependency-free.
"""
from __future__ import annotations

__all__ = [
    "RairsError",
    "Overloaded",
    "DeadlineExceeded",
    "GatewayClosed",
    "HandoverFailed",
    "CorruptBundleError",
    "FaultInjected",
    "StaleSessionError",
]


class RairsError(Exception):
    """Root of every deliberate, typed failure this system raises."""


class Overloaded(RairsError):
    """Admission control shed the request: the gateway queue was at
    ``max_queue`` under the ``reject`` overload policy.  The request
    was never enqueued; retrying after backoff is safe."""


class DeadlineExceeded(RairsError, TimeoutError):
    """The request's deadline passed before dispatch.  Raised at
    dequeue time — a request that has already blown its budget is
    failed, never scanned.  Subclasses TimeoutError so generic
    timeout handling still applies."""


class GatewayClosed(RairsError, RuntimeError):
    """The gateway is shut down (or closed while this request was
    queued past the drain window).  Subclasses RuntimeError: callers
    that caught the old ``RuntimeError("gateway is closed")`` still
    do."""


class HandoverFailed(RairsError, RuntimeError):
    """Async compaction failed after exhausting its retry budget; the
    gateway rolled back to the pinned old epoch and keeps serving.
    ``__cause__`` carries the final underlying exception."""


class CorruptBundleError(RairsError, ValueError):
    """A persisted index bundle failed integrity verification
    (truncated file, bad magic, or a per-array crc32 mismatch).  The
    message names the offending member, e.g.
    ``shard_0003-1a2b3c4d.npz:block_codes``."""


class FaultInjected(RairsError):
    """Raised by an installed ``FaultPlan`` at a ``raise``-kind fault
    site.  Only ever seen in chaos tests — production code paths treat
    it like any other dispatch/worker failure."""


class StaleSessionError(RairsError, RuntimeError):
    """A searcher session outlived the index state it compiled against:
    a ``StreamingIndex`` mutated (or compacted) past the (epoch, version)
    the session pinned.  Re-fetch the session with
    ``stream.searcher(params)``.  (The reference defines it in
    ``repro/core/stream/streaming.py``, with the same bases.)"""
