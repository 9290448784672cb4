"""Peaks of the card and the least time of a scan, from counted work.

The arithmetic is a frozen copy of ``chip_smoke.py``'s ``k3_bound``: the
least time is the larger of bytes over the card's memory bandwidth and f32
adds over its f32 rate.  What changed is where the counts come from: the
bytes are counted from the index's lists and the lists a batch probes, not
from one kernel's arguments, so a redesigned scan is held to the same work:

* every code and id byte of each block that some probed list of the batch
  holds (owned, referenced or miscellaneous), read once;
* the batch's ADC tables, (B, M, K) f32, read once;
* the (B, fetch) candidate output, f32 distances and int32 ids, written
  once;
* adds: one per sub-quantizer for each distance computed (DCO x M), the
  DCO being the count the answers carry.
"""
from __future__ import annotations

import torch

# one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit)
PEAK = {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12,
        "tf32_flops": 495e12, "bf16_flops": 989e12}


def probed_lists(centroids: torch.Tensor, q: torch.Tensor,
                 nprobe: int) -> torch.Tensor:
    """(B, nprobe) nearest lists of each query (squared L2, f32)."""
    d = ((q * q).sum(1, keepdim=True) - 2.0 * q @ centroids.T
         + (centroids * centroids).sum(1)[None, :])
    return torch.topk(d, nprobe, dim=1, largest=False).indices


def scan_bytes(tables, probed: torch.Tensor, *, block: int, m: int,
               nbits: int, ksub: int, fetch: int) -> int:
    """Least bytes the scan of one batch moves.  ``tables`` are the
    index's per-list block tables (each (nlist, W) int32, -1 pad);
    ``probed`` the batch's (B, nprobe) lists."""
    lists = torch.unique(probed.reshape(-1))
    blocks = torch.cat([t[lists].reshape(-1) for t in tables])
    n_blocks = int(torch.unique(blocks[blocks >= 0]).numel())
    per_block = block * m * nbits // 8 + block * 4
    b = probed.shape[0]
    return n_blocks * per_block + b * m * ksub * 4 + b * fetch * 8


def least_seconds(n_bytes: float, n_adds: float) -> float:
    return max(n_bytes / PEAK["hbm_bytes_per_s"], n_adds / PEAK["f32_flops"])


def spread(values) -> float:
    """Interquartile distance over the median (``statistics.quantiles``,
    n=4), the run-to-run spread a bound is set from."""
    import statistics
    v = [float(x) for x in values]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    return (q3 - q1) / abs(q2) if q2 else float("inf")


def bound_from(spreads) -> float:
    """Five times the widest spread, never under 1%."""
    return max(0.01, 5.0 * max(spreads))

