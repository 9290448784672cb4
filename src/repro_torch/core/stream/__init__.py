"""Streaming mutable index of the port (counterpart of
``repro/core/stream/``).

``streaming.py``'s ``StreamingIndex`` wraps an immutable ``RairsIndex``
base epoch with an append-only delta segment (``delta.py``), a tombstone
bitmap, threshold/explicit compaction, and (epoch, version)-pinned
searcher sessions; ``search.py`` is the delta scan the engine's
pipeline (``core/search.py``) runs beside the base.  The package
imports only the latter two: ``core/search.py`` imports ``search.py``,
and ``streaming.py`` imports the sessions built on ``core/search.py``.
"""
from .delta import DeltaSegment  # noqa: F401
from .search import DeltaInputs, delta_adc  # noqa: F401
