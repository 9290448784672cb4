"""Run one cell of the benchmark once and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic and
its metrics are found by name from ``BENCHMARK.json``.  The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; then
``checks``, every number compared beside its limit, which also end
standard error.  Without a card, or with fewer cards than the cell asks
for, it exits 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must not
    run (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def metrics_of(run, specs) -> dict:
    import harness
    out = {}
    for m in specs:
        v = harness.reader(m["name"]).read(run)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result(run, verdict) -> dict:
    """The result line's object (``checks`` last)."""
    spec = run.spec
    run.verdict = verdict
    metrics = metrics_of(run, spec.per_layer if run.trace
                         else spec.end_to_end)
    import torch
    dev = {"platform": "gpu" if run.dev.type == "cuda" else run.dev.type,
           "kind": (torch.cuda.get_device_name(run.dev)
                    if run.dev.type == "cuda" else "cpu"),
           "count": int(spec.cell["chips"]),
           "memory_peak_bytes": int(run.memory_peak),
           "power_limit": getattr(run, "power_limit", "")}
    out = {"correct": bool(verdict.correct),
           "attempted": int(sum(len(k) for k in run.rec.keys)),
           "failed": 0, "metrics": metrics, "device": dev}
    if run.trace and run.prof_readings is not None and run.dev.type == "cuda":
        r = run.prof_readings
        dev["busy_s"], dev["window_s"] = r["busy_s"], r["window_s"]
        dev["busy_stretch"] = r["stretch"]
        out["breakdown"] = {"device_ops": r["device_ops"],
                            "idle_gaps": r["idle_gaps"]}
        out["trace_events"] = r["cats"]
    out["setup_parts"] = run.parts
    out["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"],
                         "pass": c["pass"]}
                     for k, c in verdict.checks.items()}
    return out


def _num(v):
    """A number JSON can carry: +-inf as +-1e300, NaN as null."""
    if isinstance(v, float) and not math.isfinite(v):
        return None if math.isnan(v) else math.copysign(1e300, v)
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    import torch
    import harness
    import judge
    spec = harness.load_cell(ROOT, args.workload)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: cell {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    verdict = judge.judge(run)
    run.power_limit = power_limit()
    out = result(run, verdict)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {', '.join(bad)}; the port must not",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['pass']} "
              f"{c['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
