"""Recall / DCO metrics and exact ground truth (paper §6.1)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .kmeans import pairwise_sq_l2


def ground_truth(x, q, k: int, metric: str = "l2", chunk: int = 256,
                 device: DeviceLike = None) -> np.ndarray:
    """Exact top-k ids by brute force on ``device``, chunked over
    queries.  -> (nq, k) int32 on the host."""
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
    q = torch.as_tensor(q).to(device=dev, dtype=torch.float32)
    outs = []
    for s in range(0, q.shape[0], chunk):
        qc = q[s:s + chunk]
        d = pairwise_sq_l2(qc, x) if metric == "l2" else -(qc @ x.T)
        outs.append(torch.topk(d, k, dim=1, largest=False).indices
                    .to(torch.int32).cpu().numpy())
    return np.concatenate(outs, axis=0)


def recall_at_k(result_ids, gt_ids) -> float:
    """Average |result ∩ gt| / K (paper's recall k@K)."""
    r = np.asarray(torch.as_tensor(result_ids).cpu())
    g = np.asarray(gt_ids)
    k = g.shape[1]
    hits = (r[:, :, None] == g[:, None, :]).any(axis=1).sum(axis=1)
    return float(hits.mean() / k)


def _host(a) -> np.ndarray:
    """A host numpy copy of a tensor (or array-like)."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def per_query_recall(result_ids, gt_ids) -> np.ndarray:
    """|result ∩ gt| / K per query, (nq,) float64."""
    r, g = _host(result_ids), _host(gt_ids)
    return (r[:, :, None] == g[:, None, :]).any(axis=1).sum(axis=1) / g.shape[1]


def dco_summary(res) -> Dict[str, float]:
    """Mean approx / refine / total DCO a query, the p99 total, and the
    mean of the dropped blocks, over a ``SearchResult``."""
    a = _host(res.approx_dco).astype(np.float64)
    r = _host(res.refine_dco).astype(np.float64)
    return {
        "approx_dco": float(a.mean()),
        "refine_dco": float(r.mean()),
        "total_dco": float((a + r).mean()),
        "p99_dco": float(np.percentile(a + r, 99)),
        "dropped_blocks": float(_host(res.dropped_blocks).mean()),
    }
