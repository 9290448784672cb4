#!/usr/bin/env python3
"""The streaming delta scan's time against its query-chunk budget, and
the routed scan's kernel beside it, on one NVIDIA H100.

    python3 tools/delta_scan_chunks.py [--seed 0] [--budgets 28,27,26]
                                       [--fetch 200] [--loop]

Times the stream's delta scans (ADC over ascending m, then each query's
stable top-fetch) at the churn cell's shapes, with
``chip_smoke.py::delta_inputs`` (uniform codes, uniform assignments
over 4096 lists, 5% dead slots): the exhaustive scan
(``exhaustive_delta_candidates``) at capacity 131,072, first holding its
ADC sums (``delta_adc``: ``F.embedding_bag``) bitwise against a loop of
one gather and one add per m (``--loop`` times the scan with that loop
in their place), and the routed scan at capacity 262,144 (nprobe 32,
posting width 256): its kernel (``ops.delta_scan_topk``) beside the
chunked plain version (``kernels/ref.py::routed_delta_topk``, the
CPU's path).  At B = 1024 and 64, M 64, K 16, ``--fetch`` (the cell's
finalize fetch, 200), with ``kernels/ref.py::DELTA_CHUNK_BYTES`` (the
budget of both plain scans) set to each
``2**budget`` in turn.  Each time is the card's work alone (calls
captured in one CUDA graph and replayed, as a session replays them);
every budget's output, and the kernel's, must be bitwise the first
budget's.  The card's name and power limit head the output.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def adc_loop(torch, lut, codes):
    """sum over ascending m of lut[b, m, codes[c, m]], one pass per m:
    (B, M, K) x (C, M) codes shared by every query -> (B, C)."""
    out = None
    for j in range(lut.shape[1]):
        col = torch.index_select(lut[:, j, :], 1, codes[:, j].long())
        out = col if out is None else out + col
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budgets", default="28,27,26")
    ap.add_argument("--fetch", type=int, default=200)
    ap.add_argument("--loop", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("delta_scan_chunks: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import delta_inputs, graph_ms
    from repro_torch.core.stream import search
    from repro_torch.kernels import ops, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    budgets = [int(x) for x in args.budgets.split(",")]
    lut, codes, *_ = delta_inputs(torch, dev, args.seed, 256, cap=131072)
    if not torch.equal(search.delta_adc(lut, codes),
                       adc_loop(torch, lut, codes)):
        print("delta_scan_chunks: FAILED: delta_adc differs from the per-m "
              "loop", file=sys.stderr)
        return 1
    print("delta_adc (256 x 131072) bitwise equal to the per-m loop")
    if args.loop:
        search._adc_columns = lambda lut_, index: adc_loop(
            torch, lut_, index - torch.arange(index.shape[1],
                                              device=dev) * lut_.shape[2])
        print("(the exhaustive ADC sums replaced by the per-m loop)")
    for routed, cap in ((False, 131072), (True, 262144)):
        for b in (1024, 64):
            args_ = delta_inputs(torch, dev, args.seed, b, cap=cap)
            if routed:
                def plain():
                    return ref.routed_delta_topk(*args_, args.fetch)
            else:
                def plain():
                    return search.exhaustive_delta_candidates(
                        *args_[:3], args.fetch)
            first = None
            line = []
            for bud in budgets:
                ref.DELTA_CHUNK_BYTES = 2 ** bud
                step = (ref._rows_per_chunk(
                    b, ref._routed_bytes(args_[3], args_[1], args_[4],
                                         32)) if routed
                    else ref._rows_per_chunk(b, 40 * cap))
                out = plain()
                torch.cuda.synchronize()
                if first is None:
                    first = out
                elif not all(torch.equal(x, y) for x, y in zip(out, first)):
                    print(f"delta_scan_chunks: FAILED: budget 2**{bud} "
                          "differs", file=sys.stderr)
                    return 1
                torch.cuda.reset_peak_memory_stats()
                ms = graph_ms(torch, plain, calls=5, reps=3)
                peak = torch.cuda.max_memory_allocated() / 2 ** 20
                line.append(f"2**{bud} ({step} rows a chunk) {ms:.4f} ms, "
                            f"peak {peak:.0f} MiB")
            if routed:
                def kernel():
                    return ops.delta_scan_topk(*args_, fetch=args.fetch)
                if not all(torch.equal(x, y)
                           for x, y in zip(kernel(), first)):
                    print("delta_scan_chunks: FAILED: the kernel differs "
                          "from the plain version", file=sys.stderr)
                    return 1
                torch.cuda.reset_peak_memory_stats()
                ms = graph_ms(torch, kernel, calls=5, reps=3)
                peak = torch.cuda.max_memory_allocated() / 2 ** 20
                line.insert(0, f"kernel {ms:.4f} ms, peak {peak:.0f} MiB")
            print(f"{'routed' if routed else 'exhaustive'} capacity {cap} "
                  f"B={b} fetch {args.fetch}: " + "; ".join(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
