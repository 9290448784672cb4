"""Streaming mutable index of the port (counterpart of
``repro/core/stream/``).

``StreamingIndex`` wraps an immutable ``RairsIndex`` base epoch with an
append-only delta segment, a tombstone bitmap, threshold/explicit
compaction, and (epoch, version)-pinned searcher sessions.
"""
from .delta import DeltaSegment  # noqa: F401
from .search import delta_adc, streaming_search  # noqa: F401
from .streaming import (PendingCompaction, StaleSessionError,  # noqa: F401
                        StreamConfig, StreamingIndex, StreamingSearcher,
                        StreamStats)
