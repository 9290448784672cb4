"""Trace/stats exporters of the port (counterpart of
``repro/obs/export.py``): Chrome/Perfetto trace-event JSON + Prometheus
text exposition.

The trace format is the Chrome trace-event *JSON object format*: a top
level ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` where every
event is a complete ("ph": "X") event with microsecond ``ts``/``dur``
plus thread-name metadata ("ph": "M") rows — loadable unmodified in
``chrome://tracing`` and https://ui.perfetto.dev.  ``validate_trace``
is the schema contract a captured trace must meet
(``python -m repro_torch.obs.export FILE``).

``to_prometheus`` flattens any nested numeric stats dict (e.g.
``snapshot_all()`` or ``Gateway.stats()``) into ``rairs_*`` text
exposition lines for scrape-style consumption from the gateway sink.
"""
from __future__ import annotations

import json
import numbers
import re
from typing import Any, Dict

from .tracer import _REQ_TID_BASE, _REQ_TRACKS, Tracer

_PID = 1
_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def to_trace_events(tracer: Tracer) -> Dict[str, Any]:
    """Render a tracer's records as a Chrome trace-event JSON document.

    Real thread ids are remapped to small ints in first-seen order;
    virtual request tracks (``Tracer.event`` exemplars) keep their own
    named tracks after the real threads.
    """
    with tracer._lock:
        recs = list(tracer.records)
    tid_map: Dict[int, int] = {}
    events = [{"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
               "args": {"name": "rairs-serve"}}]
    body = []
    for r in recs:
        raw = r["tid"]
        if raw not in tid_map:
            tid_map[raw] = len(tid_map)
            # virtual request tracks occupy exactly the small reserved
            # band; real OS thread idents are arbitrary large ints
            virt = _REQ_TID_BASE <= raw < _REQ_TID_BASE + _REQ_TRACKS
            label = (f"requests-{raw - _REQ_TID_BASE}" if virt
                     else f"thread-{tid_map[raw]}")
            events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                           "tid": tid_map[raw], "args": {"name": label}})
        body.append({
            "name": r["name"], "cat": r["cat"], "ph": "X",
            "ts": r["ts"] * 1e6, "dur": r["dur"] * 1e6,
            "pid": _PID, "tid": tid_map[raw],
            "args": {k: v for k, v in r["args"].items()},
        })
    body.sort(key=lambda e: e["ts"])
    return {"traceEvents": events + body, "displayTimeUnit": "ms",
            "otherData": {"fences": tracer.fences,
                          "dropped": tracer.dropped}}


def write_trace(tracer_or_doc, path: str) -> Dict[str, Any]:
    """Serialize a tracer (or a pre-rendered document) to ``path``;
    returns the document written."""
    doc = (tracer_or_doc if isinstance(tracer_or_doc, dict)
           else to_trace_events(tracer_or_doc))
    validate_trace(doc)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return doc


def validate_trace(doc: Any) -> Dict[str, Any]:
    """Raise ``ValueError`` unless ``doc`` is a well-formed trace-event
    JSON object; returns the doc.  This is the schema gate."""
    if not isinstance(doc, dict):
        raise ValueError(f"trace root must be an object, got {type(doc)}")
    ev = doc.get("traceEvents")
    if not isinstance(ev, list) or not ev:
        raise ValueError("traceEvents must be a non-empty list")
    for i, e in enumerate(ev):
        if not isinstance(e, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = e.get("ph")
        if ph not in ("X", "M"):
            raise ValueError(f"traceEvents[{i}]: unsupported ph {ph!r}")
        if not isinstance(e.get("name"), str):
            raise ValueError(f"traceEvents[{i}]: missing string name")
        for key in ("pid", "tid"):
            if not isinstance(e.get(key), int):
                raise ValueError(f"traceEvents[{i}]: {key} must be an int")
        if ph == "X":
            for key in ("ts", "dur"):
                v = e.get(key)
                if not isinstance(v, numbers.Real) or v < 0:
                    raise ValueError(
                        f"traceEvents[{i}]: {key} must be a number >= 0, "
                        f"got {v!r}")
        if "args" in e and not isinstance(e["args"], dict):
            raise ValueError(f"traceEvents[{i}]: args must be an object")
    return doc


def to_prometheus(stats: Dict[str, Any], prefix: str = "rairs") -> str:
    """Flatten the numeric leaves of a nested stats dict into Prometheus
    text exposition lines (``<prefix>_<dotted_path_with_underscores>
    <value>``).  Non-numeric leaves and list entries are skipped —
    counters, gauges, rates, and histogram summaries all survive."""
    lines = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, bool):
            lines.append((path, int(node)))
        elif isinstance(node, numbers.Real):
            lines.append((path, node))

    walk(stats, ())
    out = []
    for path, v in sorted(lines):
        name = _NAME_RE.sub("_", "_".join((prefix,) + path))
        out.append(f"{name} {float(v):g}")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    """CLI schema gate: validate a captured trace file and print a
    one-line summary per span category."""
    import argparse
    ap = argparse.ArgumentParser(
        description="validate a Chrome/Perfetto trace-event JSON file")
    ap.add_argument("trace", help="path to a captured trace file")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)
    validate_trace(doc)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    cats: Dict[str, int] = {}
    for e in spans:
        cats[e.get("cat", "?")] = cats.get(e.get("cat", "?"), 0) + 1
    by_cat = ", ".join(f"{k}={v}" for k, v in sorted(cats.items()))
    print(f"ok: {args.trace} — {len(spans)} spans ({by_cat})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
