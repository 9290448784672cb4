"""Observability of the port: the span tracer (counterpart of ``repro/obs``).

The tracer (``tracer.py``) records spans threaded through the search
sessions (``Searcher`` dispatch, then the engine stages).  It is off by
default: every instrumentation point goes through ``span()`` /
``fence()``, which are no-ops (a shared singleton span, no device
synchronize, no recorded work) until ``start()`` installs an active
tracer.  With one active, sessions dispatch through the stage-fenced
``seil_search_traced`` and each fence is a ``torch.cuda.synchronize``,
so a stage's span covers its device time; results stay bitwise equal.

Trace export and the unified stats schema (the reference's ``export.py``
and ``stats.py``) are not ported yet: ROADMAP.md Queue 1, item 2.
"""
from .tracer import (Tracer, enabled, fence, span, start, stop,  # noqa: F401
                     trace, tracer, work_count)

__all__ = ["Tracer", "enabled", "fence", "span", "start", "stop", "trace",
           "tracer", "work_count"]
