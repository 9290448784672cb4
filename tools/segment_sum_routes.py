#!/usr/bin/env python3
"""K-means's per-list sums on one NVIDIA H100: the shipped
``core/kmeans.py::segment_sum`` beside the other reductions in a fixed
order, and ``index_add_`` (f32 atomics) for scale.

    python3 tools/segment_sum_routes.py [--seed 0] [--reps 20]

Routes, each at the build's k-means shapes of ``chip_smoke.py``'s main
index (131,072 training rows: PQ64x4 sub-codebooks, D 2 and k 16; the
nbits=8 index's, D 2 and k 256; IVF4096, D 128 and k 4096):

* ``shipped``: ``kmeans.segment_sum`` as it stands;
* ``sort``: a stable sort by list and ``torch.segment_reduce`` (each
  list's rows summed one after another: the CPU's order);
* ``onehot``: a one-hot (rows, k) block times the rows, a GEMM a chunk
  of 16,384 rows with TF32 off, the chunks added in order;
* ``mask``: the one-hot block broadcast against the rows and summed over
  rows (``torch.sum``'s fixed tree), a chunk of at most 64 MiB at a time,
  the chunks added in order (small k * D only);
* ``index_add``: ``index_add_``, not reproducible on the card.

Each route runs ``--reps`` times on the same input; a route is
``reproducible`` when every run is bitwise the first.  Times are CUDA
events around each call (median, ms).  Then a whole ``pq_train`` and a
whole IVF ``kmeans_fit`` at the main index's shapes, in seconds, with
each route in turn in ``segment_sum``'s place (``shipped`` and
``index_add`` first and last, to show the spread).  The card's
name and power limit head the output; one JSON line ends it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SHAPES = (("pq4", 2, 16), ("pq8", 2, 256), ("ivf", 128, 4096))


def route_sort(torch, x, seg, k):
    s = seg.long()
    srt, order = torch.sort(s, stable=True)
    bounds = torch.searchsorted(
        srt, torch.arange(k + 1, dtype=torch.long, device=x.device))
    lengths = bounds[1:] - bounds[:-1]
    sums = torch.segment_reduce(x[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)
    return sums, lengths.to(x.dtype)


def route_onehot(torch, x, seg, k, chunk=16384):
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        s = seg.long()
        sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
        cols = torch.arange(k, device=x.device)
        for lo in range(0, x.shape[0], chunk):
            hot = (s[lo:lo + chunk, None] == cols).to(x.dtype)
            sums += hot.t() @ x[lo:lo + chunk]
        counts = torch.bincount(s, minlength=k).to(x.dtype)
        return sums, counts
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep


def route_mask(torch, x, seg, k):
    s = seg.long()
    step = max(1, 2 ** 26 // (4 * k * x.shape[1]))
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    cols = torch.arange(k, device=x.device)
    for lo in range(0, x.shape[0], step):
        hot = (s[lo:lo + step, None] == cols).to(x.dtype)
        sums += (hot[:, :, None] * x[lo:lo + step, None, :]).sum(0)
    counts = torch.bincount(s, minlength=k).to(x.dtype)
    return sums, counts


def route_index_add(torch, x, seg, k):
    s = seg.long()
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    sums.index_add_(0, s, x)
    counts = torch.zeros(k, dtype=x.dtype, device=x.device)
    counts.index_add_(0, s, torch.ones_like(s, dtype=x.dtype))
    return sums, counts


def timed(torch, fn, reps):
    outs, ms = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        outs.append(out)
    same = all(torch.equal(o[0], outs[0][0]) and torch.equal(o[1], outs[0][1])
               for o in outs)
    return statistics.median(ms), same, outs[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("segment_sum_routes: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import kmeans
    from repro_torch.core.pq import pq_train
    from repro_torch.data import make_dataset

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    x, _, _ = make_dataset("sift1m", args.seed, n=131072, n_queries=1,
                           device=dev)
    routes = {"shipped": lambda t, a, s, k: kmeans.segment_sum(a, s, k),
              "sort": route_sort, "onehot": route_onehot, "mask": route_mask,
              "index_add": route_index_add}
    rows = []
    for name, d, k in SHAPES:
        if d == 2:
            g = torch.Generator().manual_seed(args.seed)
            pick = torch.randint(0, 64, (1,), generator=g).item()
            xs = x[:, 2 * pick:2 * pick + 2].contiguous()
        else:
            xs = x
        cents = xs[torch.randperm(xs.shape[0], generator=torch.Generator()
                                  .manual_seed(args.seed))[:k].to(dev)]
        seg = kmeans.assign_nearest(xs, cents)
        ref = route_sort(torch, xs, seg, k)
        for route, fn in routes.items():
            if route == "mask" and k * d > 4096:
                continue
            ms, same, out = timed(torch, lambda: fn(torch, xs, seg, k),
                                  args.reps)
            err = (out[0] - ref[0]).abs().max().item()
            row = dict(shape=name, rows=xs.shape[0], d=d, k=k, route=route,
                       ms=ms, reproducible=same,
                       equals_sort=bool(torch.equal(out[0], ref[0])),
                       max_abs_diff_vs_sort=err)
            rows.append(row)
            print(f"{name:4s} d={d:3d} k={k:4d} {route:9s} {ms:9.4f} ms "
                  f"reproducible={same} equals_sort={row['equals_sort']} "
                  f"max|diff| vs sort {err:.3e}", flush=True)

    trains = []
    original = kmeans.segment_sum
    for route in ("shipped", "index_add", "sort", "onehot", "mask",
                  "index_add", "shipped"):
        fn = routes[route]
        if route != "shipped":
            kmeans.segment_sum = (lambda f: lambda a, s, k: f(torch, a, s, k)
                                  )(fn)
        try:
            for what in ("pq_train", "ivf"):
                if route == "mask" and what == "ivf":
                    continue
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                g = torch.Generator().manual_seed(args.seed)
                if what == "pq_train":
                    out = pq_train(x, 64, nbits=4, iters=12, sample=131072,
                                   generator=g).codebooks
                else:
                    out = kmeans.kmeans_fit(x, 4096, iters=15, sample=131072,
                                            generator=g)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                trains.append(dict(route=route, what=what, seconds=sec,
                                   checksum=float(out.double().sum())))
                print(f"{what:8s} with {route:7s} {sec:.4f} s", flush=True)
        finally:
            kmeans.segment_sum = original
    print(json.dumps({"segment_sum": rows, "train": trains}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
