"""Search sessions — the query-side public API.

A ``Searcher`` binds one ``RairsIndex`` to one ``SearchParams``.  A
batch is padded with zero rows up to its dispatch bucket (powers of two,
or ``batch_buckets``); batches larger than the biggest bucket are cut
into chunks and the results concatenated.  Every stage is per query, so
the first B rows of a padded batch are the rows of the padded run.

PyTorch runs eagerly, so a session compiles nothing; it fixes the
resolved params and counts calls, dispatches and padded rows.  Plan
reuse and the two-tier refine are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .params import SearchParams
from .search import SearchResult, seil_search


@dataclasses.dataclass
class SearcherStats:
    """Dispatch accounting for one session."""
    calls: int = 0           # searcher invocations
    dispatches: int = 0      # chunk dispatches (>= calls)
    padded_rows: int = 0     # total pad rows added across dispatches

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class Searcher:
    """A search session over one index (create via
    ``RairsIndex.searcher(params)``).  Calling it with a (B, D) query
    batch returns a ``SearchResult`` of tensors on the index's device."""

    def __init__(self, index, params: SearchParams):
        if not isinstance(params, SearchParams):
            raise TypeError(f"params must be SearchParams, got {type(params)}")
        if params.plan_reuse:
            raise NotImplementedError(
                "plan_reuse is not ported yet: ROADMAP.md Queue 1, 'plan "
                "reuse, warmup, traced stages and CUDA graphs in sessions'")
        if params.refine is not None:
            raise NotImplementedError(
                "refine is not ported yet: ROADMAP.md Queue 1, "
                "'quantization ladder'")
        self.index = index
        self.params = params.resolve(index)
        self.stats = SearcherStats()

    def _dispatch(self, qc: torch.Tensor) -> SearchResult:
        p = self.params
        idx = self.index
        self.stats.dispatches += 1
        return seil_search(
            idx.arrays, idx.centroids, idx.codebook, idx.vectors, qc,
            nprobe=p.nprobe, bigk=p.bigk, k=p.k, max_scan=p.max_scan,
            metric=idx.config.metric, dedup_results=idx.needs_result_dedup,
            oversample=idx.result_oversample, exec_mode=p.exec_mode,
            query_tile=p.query_tile, fused_topk=p.fused_topk)

    def __call__(self, queries) -> SearchResult:
        dev = self.index.device
        if isinstance(queries, np.ndarray):
            queries = torch.from_numpy(queries)
        q = queries.to(device=dev, dtype=torch.float32)
        if q.dim() != 2:
            raise ValueError(f"queries must be (B, D), got shape "
                             f"{tuple(q.shape)}")
        if q.shape[0] == 0:
            raise ValueError("empty query batch (B=0)")
        n = q.shape[0]
        outs = []
        s = 0
        while s < n:
            b = min(n - s, self.params.max_chunk)
            bucket = self.params.bucket_for(b)
            qc = q[s:s + b]
            if b < bucket:
                qc = torch.cat([qc, qc.new_zeros((bucket - b, q.shape[1]))])
                self.stats.padded_rows += bucket - b
            r = self._dispatch(qc)
            if b < bucket:
                r = SearchResult(*(a[:b] for a in r))
            outs.append(r)
            s += b
        self.stats.calls += 1
        if len(outs) == 1:
            return outs[0]
        return SearchResult(*(torch.cat(a) for a in zip(*outs)))

    # explicit alias for callers that prefer a method name
    search = __call__
