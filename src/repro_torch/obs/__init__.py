"""Observability of the port: the span tracer, trace export and the
unified stats snapshot (counterpart of ``repro/obs``).

The tracer (``tracer.py``) records spans threaded through the serving
stack (``Gateway`` flush, then ``Searcher`` dispatch, then the engine
stages).  It is off by default: every instrumentation point goes
through ``span()`` / ``fence()``, which are no-ops (a shared singleton
span, no device synchronize, no recorded work) until ``start()``
installs an active tracer.  With one active, sessions run the same
composition their CUDA graphs hold (``core/search.py::seil_search``, a
mesh's serve step) eagerly, and each fence after a stage is a
``torch.cuda.synchronize``, so a stage's span covers its device time;
results stay bitwise equal.  While ``torch.profiler`` collects, spans
are also the profiler's annotations, tracer or not; and while either is
on, CUDA graph replays are timed by CUDA events without changing the
dispatch: with the tracer off into the sessions' ``DeviceTime``
(``timed_calls`` / ``timed_device_s`` of an index's ``searcher_stats``),
with it on onto the replay's span.

Export paths:
  * ``write_trace`` — Chrome/Perfetto trace-event JSON;
    ``validate_trace`` is its schema gate (``python -m
    repro_torch.obs.export FILE``).
  * ``to_prometheus`` — text exposition of any nested stats dict.
  * ``snapshot_all`` — the one documented stats schema unifying session
    compile stats, plan-cache stats, per-stage DCO from span counters,
    gateway telemetry, and the modeled memory traffic of the scan stage.
"""
from .export import (to_prometheus, to_trace_events,  # noqa: F401
                     validate_trace, write_trace)
from .stats import (scan_traffic_model, session_traffic_model,  # noqa: F401
                    snapshot_all)
from .tracer import (DeviceTime, Tracer, clocked, enabled,  # noqa: F401
                     events_taken, fence, recording, replay_span, settle,
                     span, start, stop, timing, to_host, trace, tracer,
                     work_count)

__all__ = [
    "Tracer", "enabled", "recording", "fence", "span", "start", "stop",
    "trace", "tracer", "work_count", "clocked", "to_host", "timing",
    "DeviceTime", "replay_span", "settle", "events_taken",
    "to_trace_events", "write_trace", "validate_trace", "to_prometheus",
    "snapshot_all", "scan_traffic_model", "session_traffic_model",
]
