"""The readings a cell's limits are set from, in one process.

    python3 bench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --fault-nprobe 16,24 --seconds <s>

For each seed of ``--seeds`` the program runs the cell (a window of
``--seconds``) and is judged as in a benchmark run.  For each seed of
``--control-seeds`` the same traffic is also judged with the control in
the program's place: the plain reference computed one precision lower
(TF32 matmuls for the configuration's float32).  And the program runs
that traffic again at each ``--fault-nprobe``, fewer lists probed than
the configuration states: a scan that drops candidates, which the recall
limit has to catch.  The index is built once and kept across seeds.  One
JSON line per judgement.
"""
import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def with_nprobe(spec, nprobe: int):
    """``spec`` with the configuration's nprobe replaced."""
    out = copy.copy(spec)
    out.config = copy.deepcopy(spec.config)
    out.config["search"]["nprobe"] = int(nprobe)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-nprobe", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose BENCHMARK.json names the cell")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    import harness
    import judge
    spec = harness.load_cell(Path(args.root), args.workload)
    cache = {}
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    faults = [int(s) for s in args.fault_nprobe.split(",") if s]

    def show(run, seed, side, v):
        print(json.dumps({
            "cell": args.workload, "seed": seed, "side": side,
            "correct": v.correct,
            "answers": int(sum(len(k) for k in run.rec.keys)),
            "checks": {k: c["value"] for k, c in v.checks.items()},
            "parts": run.parts}), flush=True)

    for seed in [int(s) for s in args.seeds.split(",")]:
        run = harness.run_cell(spec, seed, args.seconds, False, args.device,
                               time.perf_counter(), cache=cache)
        show(run, seed, "program", judge.judge(run))
        if seed not in ctrl:
            continue
        show(run, seed, "control", judge.judge(run, control=True))
        for nprobe in faults:
            run = harness.run_cell(with_nprobe(spec, nprobe), seed,
                                   args.seconds, False, args.device,
                                   time.perf_counter(), cache=cache)
            show(run, seed, f"nprobe={nprobe}", judge.judge(run))
    return 0


if __name__ == "__main__":
    sys.exit(main())
