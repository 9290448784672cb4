"""The plain reference: exact k-nearest-neighbour search, the live set of a
stream replayed from the benchmark's own write log, and the checks that
decide ``correct``.

Plain PyTorch and NumPy.  It imports nothing of the program, takes none of
its tables, and reads the program's answers only to judge them.  The
distances are squared L2 in float32 with TF32 off (the configuration's
precision); ``tf32=True`` computes them one step lower, which is the
control (``bench/control.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

CHUNK = 1 << 18           # corpus rows scored at once


class Precision:
    """Sets TF32 for float32 matmuls inside the block, restores on exit."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 explicit mantissa bits, to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def exact_topk(base: torch.Tensor, q: torch.Tensor, k: int, *,
               live: Optional[torch.Tensor] = None, tf32: bool = False,
               chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest live rows of ``base`` (n, d) to each query (b, d):
    ``(ids int64 (b, k), squared distances f32 (b, k))``, ascending.

    Distances are ``|q|^2 - 2 q.x + |x|^2`` from one matmul per block of
    ``chunk`` rows (TF32 as asked; where the device has no TF32, the
    CPU, its rounding of the operands to 10 mantissa bits is applied
    before the float32 matmul), dead rows (``live`` False) at +inf.
    """
    emulate = tf32 and q.device.type != "cuda"
    with Precision(tf32):
        qn = (q * q).sum(1, keepdim=True)
        qm = to_tf32(q) if emulate else q
        best_d = best_i = None
        for s in range(0, base.shape[0], chunk):
            xb = base[s:s + chunk]
            xm = to_tf32(xb) if emulate else xb
            d = qn - 2.0 * (qm @ xm.T) + (xb * xb).sum(1)[None, :]
            if live is not None:
                d = torch.where(live[s:s + chunk][None, :], d, torch.inf)
            kk = min(k, d.shape[1])
            v, i = torch.topk(d, kk, dim=1, largest=False)
            i = i + s
            if best_d is None:
                best_d, best_i = v, i
            else:
                cd = torch.cat([best_d, v], 1)
                ci = torch.cat([best_i, i], 1)
                v, j = torch.topk(cd, min(k, cd.shape[1]), dim=1,
                                  largest=False)
                best_d, best_i = v, torch.gather(ci, 1, j)
    order = torch.sort(best_d, dim=1, stable=True).indices
    return torch.gather(best_i, 1, order), torch.gather(best_d, 1, order)


def distances64(base: torch.Tensor, q: torch.Tensor,
                ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared L2 of each query row to each id of ``ids`` (b, k), as
    differences in float64, and the scale ``|q|^2 + |x|^2`` (float64).
    Invalid ids (< 0 or >= n) give NaN."""
    n = base.shape[0]
    ok = (ids >= 0) & (ids < n)
    xv = base[ids.clamp(0, n - 1).long()].double()            # (b, k, d)
    qd = q.double()[:, None, :]
    d = ((xv - qd) ** 2).sum(-1)
    scale = (xv * xv).sum(-1) + (qd * qd).sum(-1)
    nan = torch.full_like(d, float("nan"))
    return torch.where(ok, d, nan), torch.where(ok, scale, nan)


def dist_gap(base, q, ids, dists) -> Tuple[float, int]:
    """(largest |returned - exact| / (|q|^2 + |x|^2) over the answers'
    valid ids, number of answers with fewer than k valid ids).  A returned
    id outside the corpus reads as a gap of +inf."""
    ids = ids.to(base.device)
    dists = dists.to(base.device)
    exact, scale = distances64(base, q, ids)
    valid = ids >= 0
    short = int((~valid).any(1).sum())
    bad = valid & torch.isnan(exact)
    if bool(bad.any()):
        return float("inf"), short
    gap = (dists.double() - exact).abs() / scale
    gap = torch.where(valid, gap, torch.zeros_like(gap))
    gap = torch.nan_to_num(gap, nan=float("inf"))
    return float(gap.max()) if gap.numel() else 0.0, short


def recall_hits(found: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Per query |found ∩ truth| over k (truth (n, k); -1 in found never
    matches)."""
    hits = np.zeros(found.shape[0], np.float64)
    for s in range(0, found.shape[0], 1 << 16):
        f, t = found[s:s + (1 << 16)], truth[s:s + (1 << 16)]
        eq = (f[:, :, None] == t[:, None, :]) & (f[:, :, None] >= 0)
        hits[s:s + (1 << 16)] = eq.any(2).sum(1) / t.shape[1]
    return hits


class WriteLog:
    """A stream's writes as the benchmark drew them, replayed as live
    masks.  Ids: the corpus is ``0 .. n_base-1``, the i-th insert is
    ``n_base + i``.  ``deletes`` is the delete sequence in order."""

    def __init__(self, n_base: int, n_inserts: int, deletes: np.ndarray):
        self.n_base = n_base
        self.n_inserts = n_inserts
        self.deletes = np.asarray(deletes, np.int64)

    def live(self, n_ins: int, n_del: int) -> np.ndarray:
        """Live mask over all ``n_base + n_inserts`` ids once the first
        ``n_ins`` inserts and ``n_del`` deletes are applied."""
        m = np.zeros(self.n_base + self.n_inserts, bool)
        m[:self.n_base + n_ins] = True
        m[self.deletes[:n_del]] = False
        return m


def draw_deletes(rng: np.random.Generator, n_base: int, setup_ins: int,
                 setup_del: int, ins_due: np.ndarray,
                 del_due: np.ndarray) -> np.ndarray:
    """The delete sequence: ``setup_del`` ids drawn uniformly from the
    live ids after the set-up inserts, then one id per window delete,
    drawn uniformly from the ids live at its due time (inserts due at the
    same time come first).  ``ins_due`` / ``del_due``: ascending due
    times of the window's inserts and deletes."""
    cap = n_base + setup_ins + len(ins_due)
    pool = np.empty(cap, np.int64)
    n = n_base + setup_ins
    pool[:n] = np.arange(n)
    out = np.empty(setup_del + len(del_due), np.int64)

    def take(j):
        nonlocal n
        r = int(rng.integers(n))
        out[j] = pool[r]
        pool[r] = pool[n - 1]
        n -= 1

    for j in range(setup_del):
        take(j)
    next_ins = 0
    for j, t in enumerate(del_due):
        while next_ins < len(ins_due) and ins_due[next_ins] <= t:
            pool[n] = n_base + setup_ins + next_ins
            n += 1
            next_ins += 1
        take(setup_del + j)
    return out
