"""RairsIndex — the public index object tying RAIR + PQ + SEIL together.

``build_index`` is paper Alg. 1 (AddVectors) for a bulk batch:
train (k-means + PQ) -> RairAssign -> PQEncoding -> SeilInsert.
Querying is Alg. 2 through a session: ``index.searcher(SearchParams(...))``.

Strategy presets (extensible via ``assign.register_strategy``):
  single  -> IVFPQfs   (baseline single assignment)
  naive   -> NaiveRA   (2nd-nearest list, strict)
  soar    -> SOARL2    (orthogonal residual, strict)
  rair    -> RAIR      (AIR, primary may win -> single)
  srair   -> SRAIR     (AIR, strictly two lists)
``seil=True`` adds the shared-cell layout (RAIRS = rair+seil, etc.).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..device import DeviceLike, resolve_device
from .assign import (AGGRS, STRATEGY_REGISTRY, available_strategies,
                     get_strategy, rair_assign_multi)
from .kmeans import kmeans_fit
from .params import SearchParams
from .pq import PQCodebook, pq_encode, pq_train
from .search import SearchResult
from .searcher import Searcher
from .seil import SeilArrays, SeilStats, build_seil


@dataclasses.dataclass
class IndexConfig:
    """The reference's build configuration, field for field."""
    nlist: int = 256
    m_pq: Optional[int] = None        # default D // 2 (paper: dsub = 2)
    nbits: int = 4
    block: int = 32
    strategy: str = "rair"
    seil: bool = True
    lam: float = 0.5
    n_cands: int = 10
    metric: str = "l2"
    multi_m: int = 2                  # >2 enables m-assignment
    aggr: str = "max"
    kmeans_iters: int = 15
    pq_iters: int = 12
    train_sample: int = 131072
    delta_route_min: Optional[int] = None   # streaming: delta routing

    def __post_init__(self):
        if self.strategy not in STRATEGY_REGISTRY:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; registered: "
                f"{available_strategies()}")
        if self.metric not in ("l2", "ip"):
            raise ValueError(f"metric must be 'l2' or 'ip', got {self.metric!r}")
        if not 1 <= self.nbits <= 8:
            raise ValueError(
                f"nbits must be in [1, 8] (codes are uint8), got {self.nbits}")
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {self.block}")
        if self.nlist < 1:
            raise ValueError(f"nlist must be >= 1, got {self.nlist}")
        if self.multi_m < 2:
            raise ValueError(f"multi_m must be >= 2, got {self.multi_m}")
        if self.aggr not in AGGRS:
            raise ValueError(f"aggr must be one of {AGGRS}, got {self.aggr!r}")
        if self.n_cands < 2:
            raise ValueError(
                f"n_cands must be >= 2 (primary + alternates), got {self.n_cands}")
        if self.m_pq is not None and self.m_pq < 1:
            raise ValueError(f"m_pq must be >= 1 or None, got {self.m_pq}")
        if self.lam < 0:
            raise ValueError(f"lam must be >= 0, got {self.lam}")
        if self.delta_route_min is not None and self.delta_route_min < 0:
            raise ValueError(
                f"delta_route_min must be >= 0 or None (auto), got "
                f"{self.delta_route_min}")


@dataclasses.dataclass
class RairsIndex:
    config: IndexConfig
    centroids: torch.Tensor           # (nlist, D)
    codebook: PQCodebook
    arrays: SeilArrays
    vectors: torch.Tensor             # (n, D) refine store
    stats: SeilStats
    assigns: np.ndarray               # (n, m) host copy, for analysis
    codes: Optional[np.ndarray] = None  # (n, M) host copy of the PQ codes
    build_seconds: dict = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def needs_result_dedup(self) -> bool:
        # duplicated layouts (no SEIL) can surface the same id twice
        return (not self.config.seil) and self.config.strategy != "single"

    @property
    def result_oversample(self) -> int:
        # max copies of one id = assignment multiplicity
        return max(int(self.assigns.shape[1]), 2)

    def default_max_scan(self, nprobe: int, slack: float = 1.3) -> int:
        avg_blocks = self.stats.n_blocks / self.config.nlist
        mo, mr, mm = (self.arrays.owned.shape[1], self.arrays.refs.shape[1],
                      self.arrays.misc.shape[1])
        cap = nprobe * (mo + mr + mm)
        want = int(nprobe * max(avg_blocks * slack, 4.0)) + 8
        return min(cap, max(want, 16))

    def searcher(self, params: Optional[SearchParams] = None, *,
                 device: DeviceLike = None, **kwargs) -> Searcher:
        """A search session for `params` (cached per params object).

        ``device`` (None -> CUDA) names where the session runs; it must
        be the device the index lives on — a session never copies the
        index.  Keyword arguments build (or override fields of) the
        params: ``index.searcher(k=10, nprobe=16, device="cpu")``.
        """
        dev = resolve_device(device)
        if dev.type != self.device.type or (
                dev.index is not None and dev != self.device):
            raise ValueError(f"index lives on {self.device}, session asked "
                             f"for {dev}")
        if params is None:
            params = SearchParams(**kwargs)
        elif kwargs:
            params = dataclasses.replace(params, **kwargs)
        cache = self.__dict__.setdefault("_searcher_cache", {})
        if params not in cache:
            cache[params] = Searcher(self, params)
        return cache[params]

    def plane(self, backend: str, codec=None):
        """Attach (or fetch) a compact code plane (``quant/plane.py``),
        cached per backend: the codec is trained (pq4, from a generator
        seeded with 17 plus the backend's position in
        ``PLANE_BACKENDS``) or closed-form (binary) from the refine
        store, every id is encoded, and the codes are gathered into this
        index's SEIL block layout, nibble-packed, on its device.  Pass
        ``codec=`` (a ``PQCodebook``) to carry a trained codec across,
        e.g. one the reference trained: encoding is deterministic."""
        from ..quant import PLANE_BACKENDS, build_plane
        if backend not in PLANE_BACKENDS:
            raise ValueError(f"unknown plane backend {backend!r}; "
                             f"choose from {PLANE_BACKENDS}")
        cache = self.__dict__.setdefault("_planes", {})
        hit = cache.get(backend)
        if hit is not None and (codec is None or codec is hit.codec):
            return hit
        gen = torch.Generator().manual_seed(
            17 + PLANE_BACKENDS.index(backend))
        cache[backend] = build_plane(
            backend, self.vectors, self.arrays.block_ids, codec=codec,
            iters=self.config.pq_iters, generator=gen, device=self.device)
        return cache[backend]

    def streaming(self, config=None):
        """Wrap this (immutable) index as the base epoch of a mutable
        ``StreamingIndex`` (core/stream/): inserts go to a delta segment,
        deletes to a tombstone mask, ``compact()`` folds both into a
        fresh base.  ``config`` is an optional ``StreamConfig``."""
        from .stream.streaming import StreamingIndex
        return StreamingIndex(self, config)

    def shard(self, mesh, axes=("data",), max_scan_local=None):
        """Deploy this index over ``mesh`` (``core/sharded.py::make_mesh``)
        as a ``ShardedIndex``: block rows and refine vectors shard by id
        range, centroids, tables and codebooks replicate, and
        ``.searcher(params)`` sessions run the mesh's serve step with the
        single-host bucket and cache machinery.  Cached per (mesh, axes,
        max_scan_local), so repeated shards of one index share placed
        tensors and executables."""
        from .sharded import shard_index
        return shard_index(self, mesh, axes=axes,
                           max_scan_local=max_scan_local)

    def searcher_stats(self) -> dict:
        """Aggregate compile-cache stats over every cached session, and
        the device time of their graph replays while timing was on
        (``timed_calls``, ``timed_device_s``; ``obs.timing``)."""
        sessions = list(self.__dict__.get("_searcher_cache", {}).values())
        obs.settle()
        return {
            "sessions": len(sessions),
            "compiles": sum(s.stats.compiles for s in sessions),
            "cache_hits": sum(s.stats.cache_hits for s in sessions),
            "timed_calls": sum(s.timing.calls for s in sessions),
            "timed_device_s": sum(s.timing.seconds for s in sessions),
        }

    def search(self, queries, k: int, nprobe: int, k_factor: int = 10,
               max_scan: Optional[int] = None, use_kernel: bool = False,
               exec_mode: str = "paged", query_tile: int = 8, *,
               device: DeviceLike = None) -> SearchResult:
        """Keyword path over the cached sessions, with the reference's
        arguments in the reference's order.  ``use_kernel`` is carried in
        the params and picks nothing: the index's device does
        (``SearchParams``)."""
        return self.searcher(SearchParams(
            k=k, nprobe=nprobe, k_factor=k_factor, max_scan=max_scan,
            use_kernel=use_kernel, exec_mode=exec_mode,
            query_tile=query_tile), device=device)(queries)


def compute_assignments(x: torch.Tensor, centroids: torch.Tensor,
                        cfg: IndexConfig) -> np.ndarray:
    """Dispatch to the registered assignment strategy (m-assignment,
    paper §4.3, overrides the pairwise strategies when multi_m > 2)."""
    if cfg.multi_m > 2:
        return obs.to_host(rair_assign_multi(
            x, centroids, m=cfg.multi_m, aggr=cfg.aggr, lam=cfg.lam,
            n_cands=cfg.n_cands)).numpy()
    return np.asarray(get_strategy(cfg.strategy)(x, centroids, cfg))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_index(x, cfg: IndexConfig, *,
                centroids: Optional[torch.Tensor] = None,
                codebook: Optional[PQCodebook] = None,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> RairsIndex:
    """Train (k-means + PQ) and add all vectors (Alg. 1) on ``device``.

    ``generator`` is a CPU ``torch.Generator`` for the training samples
    and initial centroids (seed 0 when None); given ``centroids`` /
    ``codebook`` skip their training.  ``build_seconds`` records the
    phases train / assign / encode / layout, each the ``seconds`` of its
    span (``build.train`` ... ``build.layout``, ``obs.clocked``).
    """
    dev = resolve_device(device)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    x = x.to(device=dev, dtype=torch.float32).contiguous()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    n, d = x.shape
    m_pq = cfg.m_pq or d // 2
    times = {}
    with obs.clocked("build.train", cat="build") as sp:
        if centroids is None:
            centroids = kmeans_fit(x, cfg.nlist, iters=cfg.kmeans_iters,
                                   sample=cfg.train_sample,
                                   generator=generator)
        centroids = centroids.to(device=dev, dtype=torch.float32)
        if codebook is None:
            codebook = pq_train(x, m_pq, nbits=cfg.nbits, iters=cfg.pq_iters,
                                sample=cfg.train_sample, generator=generator)
        codebook = PQCodebook(codebook.codebooks.to(device=dev,
                                                    dtype=torch.float32))
        _sync(dev)
    times["train"] = sp.seconds

    with obs.clocked("build.assign", cat="build", rows=n) as sp:
        assigns = compute_assignments(x, centroids, cfg)
    times["assign"] = sp.seconds

    with obs.clocked("build.encode", cat="build", rows=n) as sp:
        codes = obs.to_host(pq_encode(codebook, x)).numpy()
    times["encode"] = sp.seconds

    with obs.clocked("build.layout", cat="build", rows=n) as sp:
        # SEIL shares cells of two lists; m-assignment stores every copy
        arrays, stats = build_seil(
            assigns, codes, np.arange(n, dtype=np.int32), cfg.nlist,
            block=cfg.block, shared=cfg.seil and cfg.multi_m == 2,
            code_bits=cfg.nbits, device=dev)
        _sync(dev)
    times["layout"] = sp.seconds

    return RairsIndex(config=cfg, centroids=centroids, codebook=codebook,
                      arrays=arrays, vectors=x, stats=stats,
                      assigns=assigns, codes=codes, build_seconds=times)


def insert_batch(index, x_new):
    """Append a batch through the streaming delta path (paper Fig. 12):
    wraps ``index`` in a ``StreamingIndex`` (or reuses the one given) and
    appends to its delta segment in O(batch).  The result reads like a
    ``RairsIndex`` (vectors / search / searcher), new ids continue the
    old numbering, and ``.compact()`` folds the delta into a fresh base."""
    from .stream.streaming import StreamingIndex  # local: it imports this
    stream = (index if isinstance(index, StreamingIndex)
              else index.streaming())
    stream.insert(x_new)
    return stream
