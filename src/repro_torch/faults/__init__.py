"""Deterministic fault injection (the port's own copy of
``repro/faults/``, stdlib and numpy only).

A ``FaultPlan`` is a seeded schedule of failures that code paths ask
about at named sites::

    plan = FaultPlan(seed=7, specs=(
        FaultSpec("gateway.dispatch", kind="raise", prob=0.2),
        FaultSpec("gateway.fold", kind="raise", at=(0, 1)),
        FaultSpec("io.read_array", kind="bitflip", at=(3,)),
    ))
    with plan.installed():
        ...  # every fire("gateway.dispatch") now fails ~20% of visits

A site's Nth visit under seed S always makes the same fire/skip
decision: each (site, spec) pair has its own ``random.Random`` stream
derived from the plan seed, consumed once per visit, seeded exactly as
the reference seeds it, so one ``(seed, specs)`` gives the same
decisions in both packages.

Sites the port asks about:

====================  =====================================================
``gateway.dispatch``  per-batch, before the search runs (kinds: raise,
                      delay)
``gateway.fold``      per compaction-fold attempt on the worker thread
                      (kind: raise — simulates a compaction worker crash)
``io.read_array``     per array loaded from a bundle; ``corrupt_array``
                      applies truncate/bitflip to the raw bytes *before*
                      checksum verification
====================  =====================================================

The uninstalled fast path is one module-global ``is None`` check.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from ..errors import FaultInjected

__all__ = ["FaultSpec", "FaultPlan", "fire", "corrupt_array",
           "install", "clear", "active"]

_KINDS = ("raise", "delay", "truncate", "bitflip")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One failure rule bound to a named site.

    site      the site string production code passes to ``fire``
    kind      "raise" | "delay" | "truncate" | "bitflip"
    at        explicit 0-based visit indices that fire (deterministic
              schedule); () means "use prob instead"
    prob      per-visit fire probability, drawn from this spec's seeded
              stream (ignored when ``at`` is non-empty)
    delay_s   sleep injected by kind="delay"
    max_hits  stop firing after this many hits (0 = unlimited)
    """
    site: str
    kind: str = "raise"
    at: Tuple[int, ...] = ()
    prob: float = 0.0
    delay_s: float = 0.0
    max_hits: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {_KINDS}")


class FaultPlan:
    """A seeded schedule of FaultSpecs with per-site visit counters."""

    def __init__(self, seed: int, specs: Tuple[FaultSpec, ...] = ()):
        self.seed = int(seed)
        self.specs = tuple(specs)
        self._lock = threading.Lock()
        self._visits: Dict[str, int] = {}
        self._hits: Dict[int, int] = {}   # spec index -> times fired
        # one independent deterministic stream per spec: the stream
        # seed folds in the spec's position and site so reordering
        # unrelated specs never perturbs another site's schedule
        self._rngs = [
            random.Random(f"{self.seed}:{i}:{s.site}:{s.kind}")
            for i, s in enumerate(self.specs)
        ]

    def visit(self, site: str) -> Optional[FaultSpec]:
        """Record one visit to ``site``; return the first spec for that
        site that fires on this visit (None otherwise)."""
        with self._lock:
            visit = self._visits.get(site, 0)
            fired = None
            for i, s in enumerate(self.specs):
                if s.site != site:
                    continue
                # every matching spec consumes its stream every visit,
                # so one spec firing never shifts a sibling's schedule
                draw = self._rngs[i].random()
                if fired is not None:
                    continue
                if s.max_hits and self._hits.get(i, 0) >= s.max_hits:
                    continue
                due = visit in s.at if s.at else draw < s.prob
                if due:
                    self._hits[i] = self._hits.get(i, 0) + 1
                    fired = s
            self._visits[site] = visit + 1
            return fired

    def visits(self, site: str) -> int:
        with self._lock:
            return self._visits.get(site, 0)

    def fired(self) -> int:
        """Total faults fired so far, across all specs."""
        with self._lock:
            return sum(self._hits.values())

    @contextlib.contextmanager
    def installed(self):
        """Install this plan globally for the duration of the block."""
        install(self)
        try:
            yield self
        finally:
            clear()


_ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> None:
    global _ACTIVE
    _ACTIVE = plan


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def fire(site: str) -> Optional[FaultSpec]:
    """Production-side hook: count a visit to ``site`` on the active
    plan (if any) and return the FaultSpec that fires, or None.

    The caller interprets the spec: for kind="raise" it raises
    ``FaultInjected``, for "delay" it sleeps ``delay_s``, etc.  The
    ``injected(site)`` helper does the common raise/delay handling.
    """
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.visit(site)


def injected(site: str) -> None:
    """Fire ``site`` and apply raise/delay semantics in place."""
    spec = fire(site)
    if spec is None:
        return
    if spec.kind == "delay":
        time.sleep(spec.delay_s)
    elif spec.kind == "raise":
        raise FaultInjected(f"injected fault at {site}")


def corrupt_array(site: str, name: str, arr: "np.ndarray") -> "np.ndarray":
    """Bundle-read hook: maybe corrupt ``arr``'s bytes per the active
    plan.  truncate drops the final byte (emulating a torn write);
    bitflip flips one deterministic bit.  Returns the (possibly new)
    array reinterpreted with the original dtype — shape is flattened
    for truncation, which any length/shape validation must catch."""
    spec = fire(site)
    if spec is None or spec.kind not in ("truncate", "bitflip"):
        return arr
    raw = bytearray(arr.tobytes())
    if not raw:
        return arr
    if spec.kind == "truncate":
        raw = raw[:-1]
        return np.frombuffer(bytes(raw), dtype=np.uint8)
    pos = zlib.crc32(name.encode()) % len(raw)
    raw[pos] ^= 1 << (pos % 8)
    return np.frombuffer(bytes(raw), dtype=arr.dtype).reshape(arr.shape)
