"""Open-loop synthetic load generation for the gateway (the port's own
copy of ``repro/gateway/loadgen.py``: host-only, numpy).

Open-loop means arrivals follow their own clock (a Poisson process at
``offered_qps``), not the server's: a slow server does not slow the
generator down, so queueing delay shows up in the measured latency
instead of being hidden by closed-loop back-pressure.  This is the
load model the serve sweep of ``chip_smoke.py`` (phase ``gateway``)
drives.

The per-request baseline a sweep compares against is the same
generator pointed at a gateway configured with ``max_batch=1`` /
``max_delay_ms=0`` — identical queue, identical sessions, but every
dispatch carries exactly one query — so the measured gap is purely the
value of deadline coalescing.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np

from ..errors import DeadlineExceeded, GatewayClosed, Overloaded


def _pct(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = int(math.ceil(q / 100.0 * len(sorted_vals))) - 1
    return sorted_vals[min(max(i, 0), len(sorted_vals) - 1)]


def run_open_loop(gateway, queries: np.ndarray, offered_qps: float,
                  n_requests: int, seed: int = 0,
                  timeout_s: float = 60.0,
                  exponential: bool = True,
                  tick_ms: float = 2.0,
                  on_request: Optional[Callable[[int], None]] = None,
                  collect: bool = False) -> dict:
    """Drive ``n_requests`` single-query submissions at ``offered_qps``
    and block for every response.

    queries       (N, D) pool cycled through round-robin
    exponential   Poisson arrivals (True) or a fixed inter-arrival gap
    tick_ms       generator clock quantum: the generator wakes once per
                  tick and submits every arrival whose scheduled time
                  has passed, instead of one sleep per request — at high
                  offered rates per-request sleeps turn the generator
                  into a scheduler-churn benchmark (thousands of wakeups
                  a second competing with the dispatch compute),
                  drowning the system under test.  0 restores
                  per-request pacing.
    on_request    optional hook called after every submit with the
                  request index — the churn/handover tests use it to
                  interleave mutations with live traffic
    collect       also return the raw per-answer arrays (query index,
                  result ids) so a caller can score recall offline —
                  an overload sweep needs this to price degradation

    Returns one load-point summary: achieved qps, latency percentiles
    (ms), the mean coalesced batch size, and a full typed accounting of
    every submission — ``n_ok + shed + deadline_failed + closed +
    errors == n_requests`` is the no-silent-drops invariant.  ``shed``/``deadline_failed``/``closed``
    count requests the gateway failed *typed* (``Overloaded`` /
    ``DeadlineExceeded`` / ``GatewayClosed``); ``errors`` is anything
    untyped — a healthy run, overloaded or not, keeps it at zero.
    """
    if offered_qps <= 0:
        raise ValueError(f"offered_qps must be > 0, got {offered_qps}")
    rng = np.random.default_rng(seed)
    if exponential:
        gaps = rng.exponential(1.0 / offered_qps, size=n_requests)
    else:
        gaps = np.full(n_requests, 1.0 / offered_qps)
    arrivals = np.cumsum(gaps)

    pending = []
    t0 = time.perf_counter()
    i = 0
    while i < n_requests:
        now = time.perf_counter() - t0
        while i < n_requests and arrivals[i] <= now:
            pending.append(gateway.submit(queries[i % len(queries)]))
            if on_request is not None:
                on_request(i)
            i += 1
        if i < n_requests:
            wait = arrivals[i] - (time.perf_counter() - t0)
            time.sleep(max(wait, tick_ms / 1e3) if tick_ms > 0
                       else max(wait, 0.0))

    results = []
    shed = deadline_failed = closed = errors = 0
    ok_idx, ok_ids = [], []
    levels: dict = {}
    for i, req in enumerate(pending):
        try:
            r = req.result(timeout_s)
        except Overloaded:
            shed += 1
            continue
        except DeadlineExceeded:
            deadline_failed += 1
            continue
        except GatewayClosed:
            closed += 1
            continue
        except Exception:
            errors += 1
            continue
        results.append(r)
        levels[r.level] = levels.get(r.level, 0) + 1
        if collect:
            ok_idx.append(i % len(queries))
            ok_ids.append(np.asarray(r.ids))
    t1 = time.perf_counter()

    lat = sorted(r.latency_s for r in results)
    wall = max(t1 - t0, 1e-9)
    return {
        "offered_qps": float(offered_qps),
        "achieved_qps": len(results) / wall,
        "n_requests": n_requests,
        "n_ok": len(results),
        "shed": shed,
        "deadline_failed": deadline_failed,
        "closed": closed,
        "errors": errors,
        "levels": {str(k): v for k, v in sorted(levels.items())},
        "wall_s": wall,
        **({"ok_query_idx": np.asarray(ok_idx, np.int64),
            "ok_ids": (np.stack(ok_ids) if ok_ids
                       else np.zeros((0, 0), np.int64))} if collect else {}),
        "p50_ms": _pct(lat, 50) * 1e3,
        "p95_ms": _pct(lat, 95) * 1e3,
        "p99_ms": _pct(lat, 99) * 1e3,
        "mean_latency_ms": (sum(lat) / len(lat) * 1e3) if lat else 0.0,
        "mean_batch": (float(np.mean([r.batch for r in results]))
                       if results else 0.0),
    }
