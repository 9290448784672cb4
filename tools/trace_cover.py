#!/usr/bin/env python3
"""Where a traced benchmark run's time sits in the program's spans.

    python3 tools/trace_cover.py --workload <cell> --seed <n> --seconds <s>

on the card, from the root of a checkout.  Runs the cell once with
``--trace 1`` in this process, as ``bench/run.py`` does, prints that
result line, then one JSON line of readings the benchmark does not
report:

* ``cover``: for each span with children (``stage.merge_unions_host``,
  ``stream.insert``, ``stream.delete``), the share of its time its
  children take, in the stretch with the tracer on;
* ``idle``: in the profiled stretch (tracer off), the card's idle
  seconds inside the harness's batches and the part of them under a
  program span at any depth; and the idle seconds outside batches with
  no torch op running, split into those under a program span and those
  under none (what the breakdown named ``python (no torch op)`` before
  the spans reached the profiler's trace);
* ``qps_tracer_on``: queries/s over the stretch with the tracer alone;
* ``spans``: the tracer's summary (count, mean ms, counters) of each
  span.

A program span is a profiler annotation whose name starts with one of
``PROGRAM``; the harness's own start with ``bench.``.
"""
import argparse
import bisect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = ("searcher.", "graph.", "stage.", "merge.", "stream.", "build.")
CHILDREN = {"stage.merge_unions_host": "merge.",
            "stream.insert": "stream.insert.",
            "stream.delete": "stream.delete."}


def merged(intervals):
    """Sorted disjoint (start, end) covering the same points."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covers(union, starts, t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and union[i][1] >= t


def idle_split(st) -> dict:
    """The profiled stretch's idle gaps, by what the host was inside."""
    import devtrace
    lo, hi = st.read().window_ns
    classes = {"batch": [], "program": [], "torch": []}
    for name, s, e in st.host:
        if name == devtrace.BATCH:
            classes["batch"].append((s, e))
        elif name.startswith(PROGRAM):
            classes["program"].append((s, e))
        elif not name.startswith("bench."):
            classes["torch"].append((s, e))
    unions = {k: merged(v) for k, v in classes.items()}
    starts = {k: [u[0] for u in v] for k, v in unions.items()}
    out = dict.fromkeys(("in_batch_s", "in_batch_under_span_s",
                         "no_op_outside_batch_under_span_s",
                         "no_op_outside_batch_under_none_s"), 0.0)
    for g0, g1 in devtrace.idle_gaps([(s, e) for _, s, e in st.device],
                                     lo, hi):
        m, d = (g0 + g1) / 2, (g1 - g0) / 1e9
        span = covers(unions["program"], starts["program"], m)
        if covers(unions["batch"], starts["batch"], m):
            out["in_batch_s"] += d
            out["in_batch_under_span_s"] += d * span
        elif not covers(unions["torch"], starts["torch"], m):
            key = "under_span" if span else "under_none"
            out[f"no_op_outside_batch_{key}_s"] += d
    out["window_s"] = (hi - lo) / 1e9
    return out


def cover(tracer) -> dict:
    total = {}
    for r in tracer.records:
        if r["kind"] == "span":
            total[r["name"]] = total.get(r["name"], 0.0) + r["dur"]
    return {p: sum(v for k, v in total.items() if k.startswith(c)) / total[p]
            for p, c in CHILDREN.items() if total.get(p)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    import harness
    import judge
    import run as bench_run
    spec = harness.load_cell(ROOT, args.workload)
    run = harness.run_cell(spec, args.seed, args.seconds, True, "cuda",
                           t_start)
    verdict = judge.judge(run)
    run.power_limit = bench_run.power_limit()
    print(json.dumps(bench_run.result(run, verdict)))
    extra = {"cell": args.workload, "seed": args.seed}
    if run.tracer is not None:
        extra["cover"] = cover(run.tracer)
        summ = run.tracer.stage_summary()
        extra["spans"] = {k: {"count": v["count"],
                              "mean_ms": v["mean_ms"],
                              "counters": v["counters"]}
                          for k, v in summ.items()}
        n = summ.get("searcher.dispatch", {}).get("count", 0)
        t1 = run.rec.t1
        if 2 <= n <= len(t1):
            extra["qps_tracer_on"] = ((n - 1) * int(spec.traffic["batch"])
                                      / (t1[-1] - t1[-n]))
    if run.prof is not None:
        extra["idle"] = idle_split(run.prof)
    print(json.dumps(extra))
    return 0


if __name__ == "__main__":
    sys.exit(main())
