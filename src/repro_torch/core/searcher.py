"""Search sessions — the query-side public API (counterpart of
``repro/core/searcher.py``).

A ``Searcher`` binds one ``RairsIndex`` to one ``SearchParams``.  A
batch is padded with zero rows up to its dispatch bucket (powers of two,
or ``batch_buckets``); batches larger than the biggest bucket are cut
into chunks and the results concatenated.  Every stage is per query, so
the first B rows of a padded batch are the rows of the padded run.

Each bucket dispatches to a cached executable (``core/graphs.py``): on
the card a CUDA graph, captured at first use or in ``warmup`` /
``warmup_widths``; on the CPU the eager function.  The keys are the
reference's: ``bucket`` for the whole pipeline (``seil_search``), and
with ``plan_reuse`` ``("probe", bucket)`` for stages 1-2 plus the
batch's own unions (``probe_plan``) and ``("scan", bucket, width)`` for
stages 3-4 at one union-width bucket (``scan_finalize``).  So the same
traffic gives the same ``compiles``, ``cache_hits`` and ``buckets`` as
the reference.

With ``plan_reuse`` a batch runs probe -> host plan-cache merge -> scan:
each tile's union is merged with the one cached under the tile's
signature (``engine/cluster.py``), and the scan runs at the smallest
width bucket covering the live entries.  While a tracer is active
(``obs/``) the whole-pipeline dispatch runs the session's own function
(``_search_fn``, the composition its graphs hold) eagerly, each stage
in its span and fenced, and the plan-reuse dispatch fences its probe /
merge / scan boundaries; results stay bitwise equal.  The host merge
runs in four spans (``merge.d2h``, ``merge.signatures``,
``merge.union``, ``merge.h2d``), and while timing is on (``obs.timing``)
with no tracer active each call's graph replays are timed into
``timing``, a ``DeviceTime``.

With ``refine`` (the two-tier search) the session resolves the compact
plane once (``index.plane``) and its executables scan the plane's packed
block codes with the plane's codec and keep ``bigk_eff`` survivors for
the exact re-rank; the plane's tensors are static inputs of the CUDA
graphs like the index's own.  ``refine_factor=1`` and the "full" plane
keep the plain program.

The hooks ``_check_current``, ``_call_inputs`` (the tensors every
executable takes after its own inputs), ``_route_delta``,
``_probe_exe_store``, ``_graph_pool`` and ``device`` let ``core/stream/``'s
``StreamingSearcher`` run the same pipeline over its state: it supplies
``(vectors, DeltaInputs, live)`` as ``_call_inputs`` and its route
choice as ``_route_delta``, which ``_search_fn`` / ``_scan_fn`` hand to
``seil_search`` / ``scan_finalize``.  ``core/sharded.py``'s
``ShardedSearcher`` swaps ``_search_fn`` for the mesh's serve step, as
the reference's hooks do.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .. import obs
from .engine import (BIG, merge_unions_host, plan_width, tile_signatures,
                     union_live, width_buckets)
from .graphs import GraphExe
from .params import SearchParams
from .search import SearchResult, probe_plan, scan_finalize, seil_search


@dataclasses.dataclass
class SearcherStats:
    """Compile/dispatch accounting for one session."""
    compiles: int = 0        # executables built (CUDA graphs captured)
    warmup_compiles: int = 0  # of which paid up-front by warmup /
                              # warmup_widths, not by live traffic
    calls: int = 0           # searcher invocations
    dispatches: int = 0      # chunk dispatches (>= calls)
    cache_hits: int = 0      # executable fetches served from the cache
                             # (plan_reuse chunks fetch two: probe + scan)
    padded_rows: int = 0     # total pad rows added across dispatches

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PlanStats:
    """Incremental-plan accounting (``SearchParams.plan_reuse``).

    A tile is one block union (the whole batch for ``grouped``, one
    query tile for ``clustered``); every dispatched batch classifies each
    of its tiles as hit (own union covered by the cache), extend (cache
    grew, still fits the width) or miss (first sight / overflow, cache
    replaced)."""
    batches: int = 0          # probe->scan dispatches
    tiles: int = 0            # unions processed (batches x tiles/batch)
    hits: int = 0             # reused unchanged
    extends: int = 0          # merged into the cache
    misses: int = 0           # replaced (cold cache or width overflow)
    union_live_sum: int = 0   # live entries actually scanned (per tile)
    own_live_sum: int = 0     # live entries this batch needed (per tile)
    width_sum: int = 0        # dispatched union-width buckets (per tile)
    sig_deep_split: int = 0   # tiles the deep signature separated from a
                              # neighbour sharing its lead list

    def summary(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        t = max(self.tiles, 1)
        d["hit_rate"] = self.hits / t
        d["mean_union_live"] = self.union_live_sum / t
        d["mean_own_live"] = self.own_live_sum / t
        d["mean_width"] = self.width_sum / t
        return d


class Searcher:
    """A search session over one index (create via
    ``RairsIndex.searcher(params)``).  Calling it with a (B, D) query
    batch returns a ``SearchResult`` of tensors on the index's device;
    ``stats`` counts executables and dispatches, ``buckets`` lists the
    batch sizes with an executable."""

    _route_delta = False    # a stream's session: route its delta scan

    def __init__(self, index, params: SearchParams):
        if not isinstance(params, SearchParams):
            raise TypeError(f"params must be SearchParams, got {type(params)}")
        self.index = index
        self.params = params.resolve(index)
        # the two-tier scan: the compact plane, resolved once
        ap = self.params.active_plane
        self._plane = index.plane(ap) if ap is not None else None
        self._arrays, self._codebook, self._packed = self._scan_state()
        self.stats = SearcherStats()
        self.plan_stats = PlanStats()
        # device time of this session's graph replays while timing is on
        self.timing = obs.DeviceTime()
        self._compiled: Dict[Any, Any] = {}
        # per dispatch bucket, a signature-keyed map of cached tile unions
        # ((list, run) -> (W,) row), LRU-bounded
        self._plan_cache: Dict[int, "collections.OrderedDict"] = {}
        self._pool = self._graph_pool()

    @property
    def device(self) -> torch.device:
        """Where the session takes its queries and returns its results:
        the index's device (a mesh session's result device,
        ``core/sharded.py``)."""
        return self.index.device

    def _graph_pool(self):
        """The memory pool of this session's CUDA graphs (None on the
        CPU)."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.graph_pool_handle()

    @property
    def buckets(self):
        """Batch-size buckets with an executable, ascending (with
        plan_reuse the probe store may live outside ``_compiled``)."""
        keys = set(self._compiled) | set(self._probe_exe_store())
        return tuple(sorted({k if isinstance(k, int) else k[1]
                             for k in keys}))

    def compile_stats(self) -> Dict[str, Any]:
        d = self.stats.as_dict()
        d["buckets"] = list(self.buckets)
        if self.params.plan_reuse:
            d["plan"] = self.plan_stats.summary()
        return d

    def _check_current(self) -> None:
        """Raise if the index has mutated past this session: a no-op for
        an immutable ``RairsIndex`` (``StreamingSearcher`` raises
        ``StaleSessionError``)."""

    def _scan_state(self) -> tuple:
        """(arrays, codebook, packed) the scan stages run over: with a
        compact plane its packed block codes and its codec, else the
        index's own.  The refine store and finalize are untouched."""
        idx = self.index
        if self._plane is None:
            return idx.arrays, idx.codebook, False
        return (dataclasses.replace(idx.arrays,
                                    block_codes=self._plane.block_codes),
                self._plane.codec, True)

    # -- the three executables --------------------------------------------
    def _search_kw(self) -> dict:
        p, idx = self.params, self.index
        return dict(bigk=p.bigk_eff, k=p.k, metric=idx.config.metric,
                    dedup_results=idx.needs_result_dedup,
                    oversample=idx.result_oversample, exec_mode=p.exec_mode,
                    query_tile=p.query_tile, fused_topk=p.fused_topk,
                    packed_codes=self._packed,
                    route_delta=self._route_delta)

    def _zeros(self, bucket: int) -> torch.Tensor:
        return torch.zeros((bucket, self.index.vectors.shape[1]),
                           dtype=torch.float32, device=self.device)

    def _make(self, fn, inputs, clone: bool = True):
        """``fn`` as an executable: a CUDA graph over the static
        ``inputs`` on the card, the eager function on the CPU."""
        if self._pool is None:
            return fn
        return GraphExe(fn, inputs, pool=self._pool, clone=clone,
                        timing=self.timing)

    def _get_exe(self, key, make, cache=None):
        cache = self._compiled if cache is None else cache
        hit = key in cache
        if not hit:
            with obs.span("searcher.compile", cat="compile", key=str(key)):
                cache[key] = make()
            self.stats.compiles += 1
        else:
            self.stats.cache_hits += 1
        exe = cache[key]
        if isinstance(exe, GraphExe):  # a stream's probe graphs outlive
            exe.timing = self.timing   # the session that captured them
        return exe

    def _probe_exe_store(self) -> dict:
        """Where plan_reuse probe executables live.  The probe half reads
        only the base index, so a subclass whose ``_compiled`` is keyed by
        delta shapes (core/stream/) keeps them in a longer-lived store."""
        return self._compiled

    def _call_inputs(self) -> tuple:
        """Tensors the whole-pipeline and scan executables take after
        their own inputs (static inputs of their CUDA graphs): none for
        an immutable index; a stream's ``(vectors, DeltaInputs, live)``."""
        return ()

    def _search_fn(self):
        """``fn(q, *self._call_inputs())`` -> SearchResult."""
        idx = self.index
        kw = dict(self._search_kw(), nprobe=self.params.nprobe,
                  max_scan=self.params.max_scan)
        arrays, codebook = self._arrays, self._codebook

        def fn(q, vectors=idx.vectors, delta=None, live=None):
            return seil_search(arrays, idx.centroids, codebook, vectors, q,
                               delta=delta, live=live, **kw)
        return fn

    def _scan_fn(self):
        """``fn(q, probe, unions, *self._call_inputs())`` -> SearchResult."""
        idx = self.index
        kw = self._search_kw()
        arrays = self._arrays

        def fn(q, probe, unions, vectors=idx.vectors, delta=None, live=None):
            return scan_finalize(arrays, vectors, q, probe, unions,
                                 delta=delta, live=live, **kw)
        return fn

    def _executable(self, bucket: int):
        """The whole pipeline for one bucket."""
        return self._get_exe(bucket, lambda: self._make(
            self._search_fn(), (self._zeros(bucket),) + self._call_inputs()))

    def _probe_exe(self, bucket: int):
        """Stages 1-2 and the batch's own unions for one bucket; returns
        ``(queries, PlanProbe)``, the scan executable's first inputs."""
        p, idx = self.params, self.index
        kw = dict(nprobe=p.nprobe, max_scan=p.max_scan,
                  metric=idx.config.metric, exec_mode=p.exec_mode,
                  query_tile=p.query_tile)

        arrays, codebook = self._arrays, self._codebook

        def fn(q):
            return q, probe_plan(arrays, idx.centroids, codebook, q, **kw)
        return self._get_exe(
            ("probe", bucket),
            lambda: self._make(fn, (self._zeros(bucket),), clone=False),
            cache=self._probe_exe_store())

    def _scan_exe(self, bucket: int, qp, pr, width: int):
        """Stages 3-4 for one bucket at one union width, reading the
        probe executable's outputs ``(qp, pr)``."""
        def make():
            unions = torch.full((pr.unions.shape[0], width), BIG,
                                dtype=pr.unions.dtype,
                                device=self.device)
            return self._make(self._scan_fn(),
                              (qp, pr, unions) + self._call_inputs())
        return self._get_exe(("scan", bucket, width), make)

    # -- dispatch ---------------------------------------------------------
    def _dispatch(self, bucket: int, qc: torch.Tensor) -> SearchResult:
        """One padded chunk through the whole-pipeline executable (while
        a tracer is active, its function run eagerly, stage-fenced), or
        through probe -> plan-cache merge -> scan."""
        self.stats.dispatches += 1
        if not self.params.plan_reuse:
            exe = (self._search_fn() if obs.enabled()
                   else self._executable(bucket))
            return exe(qc, *self._call_inputs())
        qp, pr, unions_w = self._probe_merge(bucket, qc)
        wp = unions_w.shape[1]
        scan = self._scan_exe(bucket, qp, pr, wp)
        with obs.span("stage.scan_finalize", cat="device", bucket=bucket,
                      width=wp):
            return obs.fence(scan(qp, pr, unions_w, *self._call_inputs()))

    def _probe_merge(self, bucket: int, qc: torch.Tensor):
        """Probe a padded chunk and merge its tile unions with the plan
        cache: ``(qp, pr, unions)``, the scan's inputs (on the card
        ``qp`` and ``pr`` are the probe graph's outputs, valid until its
        next replay)."""
        probe = self._probe_exe(bucket)
        with obs.span("stage.probe_plan", cat="device", bucket=bucket):
            qp, pr = obs.fence(probe(qc))
        with obs.span("stage.merge_unions_host", cat="host") as msp:
            with obs.span("merge.d2h", cat="host"):
                own = obs.to_host(pr.unions).numpy()
                t, w = own.shape
                if t > 1:
                    sel = obs.to_host(pr.sel).numpy()
                    perm = obs.to_host(pr.perm).numpy()
            deep_split = 0
            with obs.span("merge.signatures", cat="host"):
                if t == 1:             # grouped: one batch-wide union
                    sigs = [(0, 0)]
                else:                  # clustered: name tiles by working set
                    rows = sel[perm][::bucket // t]
                    sigs = tile_signatures(rows[:, 0], deep=rows)
                    deep_split = (len({(s[0], s[1]) for s in sigs})
                                  - len({s[0] for s in sigs}))
            with obs.span("merge.union", cat="host"):
                cache = self._plan_cache.setdefault(
                    bucket, collections.OrderedDict())
                cached = [cache.get(s) for s in sigs]
                present = np.array([r is not None for r in cached])
                if present.any():
                    pad = np.full(w, int(BIG), own.dtype)
                    used, hit, ext = merge_unions_host(
                        np.stack([pad if r is None else r for r in cached]),
                        own, present)
                else:
                    used, hit, ext = merge_unions_host(None, own)
                for s, row in zip(sigs, used):
                    cache[s] = row
                    cache.move_to_end(s)
                while len(cache) > max(64, 4 * t):  # bound drifting sigs
                    cache.popitem(last=False)
                live = union_live(used)
                wp = plan_width(int(live.max(initial=1)), w)
                n_hit, n_ext = int(hit.sum()), int(ext.sum())
                ps = self.plan_stats
                ps.batches += 1
                ps.tiles += t
                ps.hits += n_hit
                ps.extends += n_ext
                ps.misses += t - n_hit - n_ext
                ps.union_live_sum += int(live.sum())
                ps.own_live_sum += int(union_live(own).sum())
                ps.width_sum += wp * t
                ps.sig_deep_split += deep_split
            msp.add(tiles=t, hits=n_hit, extends=n_ext,
                    misses=t - n_hit - n_ext, union_live=int(live.sum()),
                    width=wp, sig_deep_split=deep_split)
            with obs.span("merge.h2d", cat="host"):
                unions_w = torch.from_numpy(
                    np.ascontiguousarray(used[:, :wp])).to(self.device)
        return qp, pr, unions_w

    # -- warmup -----------------------------------------------------------
    def _bucket(self, b: int) -> int:
        return self.params.bucket_for(min(b, self.params.max_chunk))

    def warmup(self, *batch_sizes: int) -> "Searcher":
        """Build the executables of the buckets covering ``batch_sizes``
        (chainable).  With plan_reuse only the probe half: the scan
        half's union width is a property of the traffic
        (``warmup_widths`` builds the whole width ladder).  Builds here
        count as ``warmup_compiles``."""
        before = self.stats.compiles
        for b in batch_sizes:
            bucket = self._bucket(b)
            if self.params.plan_reuse:
                self._probe_exe(bucket)
            else:
                self._executable(bucket)
        self.stats.warmup_compiles += self.stats.compiles - before
        return self

    def warmup_widths(self, *batch_sizes: int) -> "Searcher":
        """Build the plan_reuse scan executables at every union-width
        bucket (``width_buckets``) for ``batch_sizes`` (chainable), so
        that no batch of live traffic pays a capture.  Without plan_reuse
        this is ``warmup``.  Builds here count as ``warmup_compiles``."""
        if not self.params.plan_reuse:
            return self.warmup(*batch_sizes)
        before = self.stats.compiles
        for b in batch_sizes:
            bucket = self._bucket(b)
            # one throwaway probe dispatch gives the scan inputs (tile
            # count and full union width) of this bucket
            qp, pr = self._probe_exe(bucket)(self._zeros(bucket))
            for wp in width_buckets(pr.unions.shape[1]):
                self._scan_exe(bucket, qp, pr, wp)
        self.stats.warmup_compiles += self.stats.compiles - before
        return self

    def __call__(self, queries) -> SearchResult:
        self._check_current()
        dev = self.device
        with obs.span("searcher.h2d", cat="host"):
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
        replays = self.timing.replays
        while s < n:
            b = min(n - s, self.params.max_chunk)
            bucket = self.params.bucket_for(b)
            with obs.span("searcher.dispatch", cat="searcher",
                          bucket=bucket, rows=b, pad=bucket - b):
                qc = q[s:s + b]
                if b < bucket:
                    qc = torch.cat([qc, qc.new_zeros((bucket - b,
                                                      q.shape[1]))])
                    self.stats.padded_rows += bucket - b
                r = self._dispatch(bucket, qc)
                if b < bucket:
                    r = SearchResult(*(a[:b] for a in r))
            outs.append(r)
            s += b
        if self.timing.replays != replays:  # a call whose replays were timed
            self.timing.calls += 1
        self.stats.calls += 1
        if len(outs) == 1:
            return outs[0]
        return SearchResult(*(torch.cat(a) for a in zip(*outs)))

    # explicit alias for callers that prefer a method name
    search = __call__
