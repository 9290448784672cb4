"""Delta segment — the append-only mutable tail of a ``StreamingIndex``
(the port's own copy of ``repro/core/stream/delta.py``, numpy on the
host as there).

Holds everything a post-epoch insert needs to be searchable and later
foldable into a fresh SEIL base: raw vectors (exact refinement), PQ
codes (ADC scan), and strategy-registry assignments (compaction input).
The buffers are host-side numpy; ``StreamingIndex`` owns the device
mirrors and patches them in place.

Capacity grows in fixed geometric buckets (``pad * 2**j``), so the
padded device views keep a small bounded set of shapes and the compiled
streaming executables never retrace on steady-state appends.  Slots are
never reused: a deleted delta item keeps its slot with ``live=False``
until the next compaction discards the whole segment — ids therefore
stay append-ordered and dense in ``[0, count)``.

The segment also maintains a **per-list posting map** (``post``,
``post_n``): for each IVF list, the delta slots assigned to it — the
routing directory that lets the query path scan only the delta items
reachable through the probed lists once the segment outgrows the
exhaustive-scan fast path (``IndexConfig.delta_route_min``).  Postings
are maintained incrementally on append (each slot posted once per
*distinct* assigned list), padded to a power-of-two per-list
width so the device mirror keeps a bounded set of shapes, and never
pruned on delete — liveness is checked through ``delta_ids`` at query
time, exactly like the exhaustive path.
"""
from __future__ import annotations

import numpy as np

_POST_MIN_WIDTH = 16


class DeltaSegment:
    """Padded append-only buffers for one epoch's inserts."""

    def __init__(self, dim: int, m_pq: int, m_assign: int, pad: int = 256,
                 nlist: int = 0):
        if pad < 1:
            raise ValueError(f"pad must be >= 1, got {pad}")
        self.dim = int(dim)
        self.m_pq = int(m_pq)
        self.m_assign = int(m_assign)
        self.pad = int(pad)
        self.nlist = int(nlist)
        self.count = 0         # slots ever used (monotonic)
        self.capacity = 0      # allocated slots (bucketed)
        self.vectors = np.zeros((0, self.dim), np.float32)
        self.codes = np.zeros((0, self.m_pq), np.uint8)
        self.assigns = np.zeros((0, self.m_assign), np.int32)
        self.live = np.zeros((0,), bool)
        # per-list routing directory: slot ids per assigned list, -1 pad
        self.post_width = 0
        self.post = np.full((self.nlist, 0), -1, np.int32)
        self.post_n = np.zeros(self.nlist, np.int32)
        # (lists, cols, slots) written by the latest append — the device
        # mirror patches exactly these coordinates instead of rebuilding
        self.last_post_update = (np.zeros(0, np.int64),) * 3

    def _cap_for(self, n: int) -> int:
        if n <= 0:
            return 0
        cap = self.pad
        while cap < n:
            cap *= 2
        return cap

    @property
    def n_live(self) -> int:
        return int(self.live[:self.count].sum())

    @property
    def n_dead(self) -> int:
        return self.count - self.n_live

    def append(self, vectors: np.ndarray, codes: np.ndarray,
               assigns: np.ndarray):
        """Append a batch; returns ``(slots, grew)`` where `slots` are the
        newly used slot indices and `grew` flags a capacity-bucket or
        posting-width jump (device mirrors must be rebuilt rather than
        patched)."""
        b = vectors.shape[0]
        s0 = self.count
        need = s0 + b
        grew = need > self.capacity
        if grew:
            cap = self._cap_for(need)

            def regrow(old, shape, dtype):
                out = np.zeros(shape, dtype)
                out[:s0] = old[:s0]
                return out

            self.vectors = regrow(self.vectors, (cap, self.dim), np.float32)
            self.codes = regrow(self.codes, (cap, self.m_pq), np.uint8)
            self.assigns = regrow(self.assigns, (cap, self.m_assign), np.int32)
            self.live = regrow(self.live, (cap,), bool)
            self.capacity = cap
        self.vectors[s0:need] = vectors
        self.codes[s0:need] = codes
        self.assigns[s0:need] = assigns
        self.live[s0:need] = True
        self.count = need
        slots = np.arange(s0, need, dtype=np.int64)
        grew |= self._append_postings(slots, np.asarray(assigns, np.int64))
        return slots, grew

    def _append_postings(self, slots: np.ndarray, assigns: np.ndarray
                         ) -> bool:
        """Post each new slot under its distinct assigned lists; returns
        whether the per-list width grew (device mirror rebuild)."""
        if self.nlist == 0 or slots.size == 0:
            return False
        m = assigns.shape[1]
        dup = np.zeros(assigns.shape, bool)
        for j in range(1, m):    # drop repeated lists within one row
            dup[:, j] = (assigns[:, :j] == assigns[:, j:j + 1]).any(axis=1)
        keep = ~dup
        lists = assigns[keep]
        srep = np.broadcast_to(slots[:, None], assigns.shape)[keep]
        order = np.argsort(lists, kind="stable")
        lists, srep = lists[order], srep[order]
        within = np.arange(len(lists)) - np.searchsorted(lists, lists)
        cols = self.post_n[lists].astype(np.int64) + within
        need = int(cols.max()) + 1 if len(cols) else 0
        grew = need > self.post_width
        if grew:
            w = max(_POST_MIN_WIDTH, self.post_width or _POST_MIN_WIDTH)
            while w < need:
                w *= 2
            post = np.full((self.nlist, w), -1, np.int32)
            post[:, :self.post_width] = self.post
            self.post, self.post_width = post, w
        self.post[lists, cols] = srep
        self.post_n += np.bincount(lists, minlength=self.nlist
                                   ).astype(np.int32)
        self.last_post_update = (lists, cols, srep)
        return grew

    def mark_dead(self, slots: np.ndarray) -> int:
        """Tombstone `slots`; returns how many were live until now."""
        slots = np.asarray(slots, np.int64).ravel()
        if slots.size == 0:
            return 0
        if (slots < 0).any() or (slots >= self.count).any():
            raise ValueError(
                f"delta slots out of range [0, {self.count}): {slots}")
        newly = int(self.live[slots].sum())
        self.live[slots] = False
        return newly
