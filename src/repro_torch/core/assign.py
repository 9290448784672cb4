"""Redundant-assignment strategies: NaiveRA, SOAR(L2), AIR / RAIR / SRAIR.

The AIR metric (paper Theorem 4.1):   loss(c') = ||r'||^2 + lambda * r^T r'
with r = c1 - x (primary residual), r' = c' - x.  lambda=0 degenerates to
NaiveRA; SOAR uses ||r'||^2 + lambda*(r^T r' / ||r||)^2.

Selections are stable (``torch.sort(stable=True)``, ``torch.argmin``'s
first minimum), so ties resolve as in the reference.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .. import obs
from .kmeans import pairwise_sq_l2

METRICS = ("naive", "soar", "air")
AGGRS = ("max", "min", "avg")


def candidate_lists(x: torch.Tensor, centroids: torch.Tensor, n_cands: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-n_cands nearest lists per vector (ascending distance).
    Returns (cand_ids (n, C) int32, cand_d2 (n, C) f32)."""
    srt = torch.sort(pairwise_sq_l2(x, centroids), dim=1, stable=True)
    return srt.indices[:, :n_cands].to(torch.int32), srt.values[:, :n_cands]


def _second_loss(x, centroids, cand_ids, cand_d2, metric: str, lam: float):
    """AIR/SOAR/naive loss of every candidate as the 2nd list. (n, C)."""
    if metric == "naive":
        return cand_d2
    r = centroids[cand_ids.long()] - x[:, None, :]   # residuals (n, C, D)
    r0 = r[:, 0, :]                                  # primary residual (n, D)
    dot = torch.einsum("nd,ncd->nc", r0, r)          # r^T r'
    if metric == "air":
        return cand_d2 + lam * dot
    if metric == "soar":
        nrm2 = torch.clamp_min(torch.sum(r0 * r0, dim=-1, keepdim=True), 1e-12)
        return cand_d2 + lam * (dot * dot) / nrm2
    raise ValueError(f"unknown metric {metric!r}")


def _assign2_chunk(x, centroids, n_cands, metric, lam, strict):
    cand_ids, cand_d2 = candidate_lists(x, centroids, n_cands)
    loss = _second_loss(x, centroids, cand_ids, cand_d2, metric, lam)
    if strict:
        # SRAIR: exclude the primary list from the 2nd-choice argmin
        loss = loss.clone()
        loss[:, 0] = torch.inf
    sec = torch.gather(cand_ids, 1, torch.argmin(loss, dim=-1)[:, None])[:, 0]
    first = cand_ids[:, 0]
    return torch.stack([torch.minimum(first, sec), torch.maximum(first, sec)],
                       dim=-1)                       # (n, 2), lo==hi => single


def rair_assign(x: torch.Tensor, centroids: torch.Tensor, *,
                metric: str = "air", lam: float = 0.5, n_cands: int = 10,
                strict: bool = False, chunk: int = 8192) -> torch.Tensor:
    """Assign each vector to (list1, list2), list1<=list2 (Alg. 3).

    metric='air' strict=False  -> RAIR (paper default)
    metric='air' strict=True   -> SRAIR
    metric='naive' strict=True -> NaiveRA   (2nd-nearest list)
    metric='soar'  strict=True -> SOARL2
    """
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.cat([_assign2_chunk(x[s:s + chunk], centroids, n_cands,
                                     metric, lam, strict)
                      for s in range(0, x.shape[0], chunk)])


def single_assign(x: torch.Tensor, centroids: torch.Tensor,
                  chunk: int = 8192) -> torch.Tensor:
    """Baseline: (n, 2) with both entries = nearest list (cell_{i,i})."""
    outs = []
    for s in range(0, x.shape[0], chunk):
        c = candidate_lists(x[s:s + chunk], centroids, 1)[0]
        outs.append(torch.cat([c, c], dim=-1))
    return torch.cat(outs)


def _assign_m_chunk(x, centroids, n_cands, m, aggr, lam):
    """Greedy strict m-assignment of one chunk (paper §4.3): the nearest
    list first, then each next list minimising ||r'||^2 + lam * aggr_i
    r_i^T r' over the residuals r_i chosen so far, never a list twice.
    -> (n, m) int32 list ids, sorted."""
    cand_ids, cand_d2 = candidate_lists(x, centroids, n_cands)
    n, c = cand_ids.shape
    r = centroids[cand_ids.long()] - x[:, None, :]   # (n, C, D)
    dots = torch.einsum("ncd,nkd->nck", r, r)        # r_i^T r_j (n, C, C)
    rows = torch.arange(n, device=x.device)
    chosen = torch.zeros((n, m), dtype=torch.long, device=x.device)
    taken = torch.zeros((n, c), dtype=torch.bool, device=x.device)
    taken[:, 0] = True                               # primary = nearest
    for j in range(1, m):
        sel = torch.gather(dots, 1, chosen[:, :j, None].expand(n, j, c))
        if aggr == "max":
            agg = sel.amax(dim=1)
        elif aggr == "min":
            agg = sel.amin(dim=1)
        else:
            agg = sel.sum(dim=1) / j
        loss = torch.where(taken, torch.inf, cand_d2 + lam * agg)
        nxt = torch.argmin(loss, dim=-1)             # first minimum
        chosen[:, j] = nxt
        taken[rows, nxt] = True
    return torch.sort(torch.gather(cand_ids, 1, chosen), dim=-1).values


def rair_assign_multi(x, centroids, *, m: int = 3, aggr: str = "max",
                      lam: float = 0.5, n_cands: int = 10, chunk: int = 8192):
    """Strict m-assignment (paper Fig. 14).  Returns (n, m) sorted int32
    list ids, chunked over n like ``rair_assign``."""
    if aggr not in AGGRS:
        raise ValueError(f"aggr must be one of {AGGRS}, got {aggr!r}")
    return torch.cat([_assign_m_chunk(x[s:s + chunk], centroids, n_cands, m,
                                      aggr, lam)
                      for s in range(0, x.shape[0], chunk)])


# ----------------------------------------------------------------------------
# Strategy registry: name -> fn(x (n, D), centroids (nlist, D), cfg) ->
# np.ndarray (n, m) of sorted per-vector list ids
# ----------------------------------------------------------------------------
StrategyFn = Callable[[torch.Tensor, torch.Tensor, object], np.ndarray]
STRATEGY_REGISTRY: Dict[str, StrategyFn] = {}


def register_strategy(name: str, overwrite: bool = False):
    """Decorator: register an assignment strategy under `name`."""
    def deco(fn: StrategyFn) -> StrategyFn:
        if not overwrite and name in STRATEGY_REGISTRY:
            raise ValueError(f"strategy {name!r} already registered")
        STRATEGY_REGISTRY[name] = fn
        return fn
    return deco


def get_strategy(name: str) -> StrategyFn:
    try:
        return STRATEGY_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; registered: "
            f"{available_strategies()}") from None


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(STRATEGY_REGISTRY))


def _host(a: torch.Tensor) -> np.ndarray:
    return obs.to_host(a).numpy()


@register_strategy("single")
def _strategy_single(x, centroids, cfg):
    """IVFPQfs baseline: one (duplicated) nearest-list assignment."""
    return _host(single_assign(x, centroids))


def _rair_family(x, centroids, cfg, metric: str, strict: bool):
    return _host(rair_assign(x, centroids, metric=metric, lam=cfg.lam,
                             n_cands=cfg.n_cands, strict=strict))


@register_strategy("naive")
def _strategy_naive(x, centroids, cfg):
    """NaiveRA: strict 2nd-nearest list."""
    return _rair_family(x, centroids, cfg, metric="naive", strict=True)


@register_strategy("soar")
def _strategy_soar(x, centroids, cfg):
    """SOARL2: strict orthogonality-weighted residual."""
    return _rair_family(x, centroids, cfg, metric="soar", strict=True)


@register_strategy("rair")
def _strategy_rair(x, centroids, cfg):
    """RAIR: AIR metric, primary may win (single assignment kept)."""
    return _rair_family(x, centroids, cfg, metric="air", strict=False)


@register_strategy("srair")
def _strategy_srair(x, centroids, cfg):
    """SRAIR: AIR metric, strictly two distinct lists."""
    return _rair_family(x, centroids, cfg, metric="air", strict=True)


def air_skip_fraction(x: torch.Tensor, centroids: torch.Tensor, lam=0.5,
                      n_cands=10, chunk=8192) -> float:
    """Fraction of vectors for which RAIR keeps single assignment
    (loss_min attained by the primary list: ||r'||^2+lam r^T r' >=
    (1+lam)||r||^2)."""
    a = rair_assign(x, centroids, metric="air", lam=lam, n_cands=n_cands,
                    strict=False, chunk=chunk)
    single = (a[:, 0] == a[:, 1]).to(torch.float32).sum()
    # the reference's f32 mean: the count times the f32 reciprocal of n
    inv = torch.reciprocal(torch.tensor(float(a.shape[0]),
                                        dtype=torch.float32))
    return float(single.cpu() * inv)
