#!/usr/bin/env python3
"""The streaming delta scan's time against its query-chunk budget, on one
NVIDIA H100.

    python3 tools/delta_scan_chunks.py [--seed 0] [--budgets 28,27,26]
                                       [--loop]

Times ``core/stream/search.py::_delta_candidates`` (the delta scan of a
streaming batch: ADC over ascending m, then each query's stable
top-fetch) at the stream phase's shapes of ``chip_smoke.py``, and
first the exhaustive scan's ADC sums (``delta_adc``:
``F.embedding_bag``) bitwise against a loop of one gather and one add
per m (``--loop`` times the scan with that loop in their place, as the
routed scan's ``_adc_rows`` runs it): the
exhaustive scan at capacity 131,072 and the routed scan at capacity
262,144 (nprobe 32, posting width 256), at B = 1024 and 64, M 64, K 16,
fetch 100, with ``DELTA_CHUNK_BYTES`` set to each ``2**budget`` in
turn.  Inputs are made on the card from ``--seed`` (uniform codes,
uniform assignments over 4096 lists, 5% dead slots).  Each time is the
card's work alone (calls captured in one CUDA graph and replayed, as a
session replays them); every budget's output must be bitwise the
first's.  The card's name and power limit head the output.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def graph_ms(torch, fn, calls: int = 5, reps: int = 3) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        g.replay()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / (reps * calls)


def inputs(torch, dev, seed, b, cap, nlist=4096, p=32, m=64, k=16,
           width=256):
    g = torch.Generator(device=dev).manual_seed(seed)
    lut = torch.rand((b, m, k), generator=g, device=dev) * 4
    codes = torch.randint(0, k, (cap, m), generator=g, device=dev,
                          dtype=torch.uint8)
    ids = torch.arange(cap, dtype=torch.int32, device=dev) + 1_000_000
    ids[torch.rand(cap, generator=g, device=dev) < 0.05] = -1
    assigns = torch.randint(0, nlist, (cap, 2), generator=g, device=dev,
                            dtype=torch.int32)
    # postings: each slot under its distinct lists, in slot order
    lists = torch.cat([assigns[:, 0], assigns[:, 1]])
    slots = torch.arange(cap, device=dev).repeat(2)
    keep = torch.cat([torch.ones(cap, dtype=torch.bool, device=dev),
                      assigns[:, 1] != assigns[:, 0]])
    lists, slots = lists[keep].long(), slots[keep]
    order = torch.sort(lists * cap + slots).indices
    lists, slots = lists[order], slots[order]
    start = torch.searchsorted(lists, torch.arange(nlist, device=dev))
    col = torch.arange(lists.numel(), device=dev) - start[lists]
    post = torch.full((nlist, width), -1, dtype=torch.int32, device=dev)
    fit = col < width
    post[lists[fit], col[fit]] = slots[fit].to(torch.int32)
    sel = torch.stack([torch.randperm(nlist, generator=g, device=dev)[:p]
                       for _ in range(b)]).to(torch.int32)
    rank_of = torch.full((b, nlist), 2 ** 30, dtype=torch.int32, device=dev)
    rank_of.scatter_(1, sel.long(), torch.arange(
        p, dtype=torch.int32, device=dev).expand(b, p).contiguous())
    return lut, codes, ids, post, assigns, sel, rank_of


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
    ap.add_argument("--loop", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("delta_scan_chunks: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.stream import search
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    budgets = [int(x) for x in args.budgets.split(",")]
    lut, codes, *_ = inputs(torch, dev, args.seed, 256, 131072)
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
            args_ = inputs(torch, dev, args.seed, b, cap)
            first = None
            line = []
            for bud in budgets:
                search.DELTA_CHUNK_BYTES = 2 ** bud
                step = (search._rows_per_chunk(
                    b, search._routed_bytes(args_[3], args_[1], args_[4],
                                            32)) if routed
                    else search._rows_per_chunk(b, 40 * cap))

                def fn():
                    return search._delta_candidates(*args_, routed, 100)
                out = fn()
                torch.cuda.synchronize()
                if first is None:
                    first = out
                elif not all(torch.equal(x, y) for x, y in zip(out, first)):
                    print(f"delta_scan_chunks: FAILED: budget 2**{bud} "
                          "differs", file=sys.stderr)
                    return 1
                torch.cuda.reset_peak_memory_stats()
                ms = graph_ms(torch, fn)
                peak = torch.cuda.max_memory_allocated() / 2 ** 20
                line.append(f"2**{bud} ({step} rows a chunk) {ms:.4f} ms, "
                            f"peak {peak:.0f} MiB")
            print(f"{'routed' if routed else 'exhaustive'} capacity {cap} "
                  f"B={b}: " + "; ".join(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
