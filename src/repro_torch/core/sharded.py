"""ShardedIndex — one index over a mesh of shards (counterpart of
``repro/core/sharded.py``).

``index.shard(mesh, axes=...)`` wraps a ``RairsIndex`` *or* a
``StreamingIndex`` as a mesh deployment that serves through the same
session protocol as the single-host path::

    mesh     = make_mesh(4)                       # 4 shards, round-robin
    sharded  = index.shard(mesh)                  # over the visible cards
    searcher = sharded.searcher(SearchParams(k=10, nprobe=16))
    result   = searcher(queries)                  # pad-and-dispatch buckets
    searcher.compile_stats()                      # same counters

The mesh is single-controller, as the reference's is: one process holds
every shard (``Mesh``, a list of torch devices with axis names; several
shards may share a device, so four shards run on one card or on the
CPU), and ``ShardedSearcher`` runs ``core/distributed.py``'s serve step
over them.  ``ShardedSearcher`` keeps all of ``Searcher``'s machinery
(buckets, chunking, compile and cache stats, the (epoch, version) pin)
and swaps the hooks ``_search_fn`` / ``_call_inputs`` /
``_check_current`` / ``_graph_pool`` / ``device``; while a tracer is
active the serve step runs eagerly, its two halves fenced in their spans
(``core/distributed.py``).  When every shard is on one card the whole step is one CUDA
graph per bucket, captured into a pool the placement owns (kept alive
by a one-op anchor graph, ``core/stream/streaming.py::_pool_anchor``);
across cards the step runs eagerly, because a CUDA graph cannot span
cards.

Placement happens once per index state, not per call, in two tiers as
in the reference: the base layout (block rows by block-id range, padded
to a multiple of the shard count; the list tables, centroids and
codebooks replicated) once per *epoch*, the mutable pieces (the refine
vectors by vector-id range, incl. delta rows; the delta buffers and the
tombstone mask replicated) once per *version*.  On the device the index
lives on, a shard's rows are views of the index's own tensors (only a
padded last block shard is a copy), so a one-card mesh costs almost no
memory beyond the index; a shard on another device gets copies.  A
stream's device mirrors are patched in place between capacity jumps
(``core/stream/streaming.py``), and the views see each version's data;
a capacity jump or a compaction replaces the mirrors, and the state is
placed anew.  A session pinned to an older version raises
``StaleSessionError``; executables are shared through a shape-keyed
cache, so steady churn inside one capacity bucket builds nothing new.

On a one-shard mesh the whole pipeline (plan window, local scan, stable
top-fetch preselect, the gather, owner refinement) is bitwise the plain
``Searcher``, frozen and streaming (``tests/test_torch_sharded.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..errors import StaleSessionError
from .distributed import ShardArgs, build_serve_step
from .engine import tables_from_arrays
from .params import SearchParams
from .search import SearchResult
from .searcher import Searcher
from .stream.streaming import StreamingIndex, _pool_anchor


class Mesh:
    """Devices arranged over named axes (row-major), the port's
    counterpart of ``jax.sharding.Mesh``.  A device may appear more than
    once: each entry is one shard."""

    def __init__(self, devices: Sequence, axis_names=("data",),
                 shape: Optional[Sequence[int]] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        dims = (len(self.devices),) if shape is None else tuple(shape)
        if len(dims) != len(self.axis_names) or (
                int(np.prod(dims)) != len(self.devices)):
            raise ValueError(
                f"a mesh of {len(self.devices)} devices cannot have shape "
                f"{dims} over axes {self.axis_names}")
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self._dims = dims

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, in axis order (as ``jax``'s ``mesh.shape``)."""
        return dict(zip(self.axis_names, self._dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def shard_devices(self, axes: Tuple[str, ...]) -> Tuple[torch.device, ...]:
        """The devices of the shards over ``axes``, in mesh order (the
        first named axis major); an axis not named is a replica axis, of
        which the first entry serves."""
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(
                    f"mesh has no axis {a!r} (axes: {self.axis_names})")
        grid = np.empty(len(self.devices), object)
        grid[:] = list(self.devices)
        grid = grid.reshape(self._dims)
        kept = [a for a in self.axis_names if a in axes]
        grid = grid[tuple(slice(None) if a in axes else 0
                          for a in self.axis_names)]
        grid = np.transpose(grid, [kept.index(a) for a in axes])
        return tuple(grid.ravel())

    def _key(self):
        return (tuple(str(d) for d in self.devices), self.axis_names,
                self._dims)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names}, shape={self._dims})")


def make_mesh(n: Optional[int] = None, device: DeviceLike = None,
              axis_names=("data",)) -> Mesh:
    """A 1-D mesh of ``n`` shards.  ``device`` None is CUDA (raising when
    there is no card, as ``resolve_device`` does): the shards go
    round-robin over the visible cards (``n`` None: one a card), so
    ``make_mesh(4)`` on one card puts four shards on ``cuda:0``.  A
    device with an index (``"cuda:1"``) or ``"cpu"`` holds every shard
    (``n`` None: one)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        pool = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        pool = [dev]
    n = len(pool) if n is None else int(n)
    if n < 1:
        raise ValueError(f"a mesh needs n >= 1 shards, got {n}")
    return Mesh([pool[i % len(pool)] for i in range(n)], axis_names)


def _rows(x: torch.Tensor, lo: int, hi: int, dev: torch.device,
          fill) -> torch.Tensor:
    """Rows [lo, hi) of ``x`` on ``dev``, ``fill`` past the end of ``x``
    (the reference's ``_pad_rows``): a view where nothing is padded and
    ``x`` already lives on ``dev``."""
    n = x.shape[0]
    part = x[min(lo, n):min(hi, n)]
    if part.shape[0] < hi - lo:
        pad = torch.full((hi - lo - part.shape[0],) + tuple(x.shape[1:]),
                         fill, dtype=x.dtype, device=x.device)
        part = torch.cat([part, pad])
    return part.to(dev)


def _vector_rows(x: torch.Tensor, lo: int, hi: int,
                 dev: torch.device) -> torch.Tensor:
    """Rows [lo, hi) of the refine store, cut at its end rather than
    padded (an id past the store is owned by no shard; a shard past it
    holds one zero row that no candidate owns)."""
    part = x[min(lo, x.shape[0]):min(hi, x.shape[0])]
    if part.shape[0] == 0:
        part = x.new_zeros((1,) + tuple(x.shape[1:]))
    return part.to(dev)


def _replicas(tensors: dict, devices) -> list:
    """``tensors`` on each of ``devices``: one copy per distinct device
    (the tensors themselves on their own device)."""
    per_dev = {}
    out = []
    for dev in devices:
        if dev not in per_dev:
            per_dev[dev] = {k: t.to(dev) for k, t in tensors.items()}
        out.append(per_dev[dev])
    return out


@dataclasses.dataclass
class _BasePlacement:
    """One *epoch* of the base layout on the shards: per shard its block
    rows and the replicated tables, centroids and codebooks.  Nothing
    here changes on insert or delete; a compaction (a new epoch) places
    it anew."""
    shards: tuple                 # per shard: {ShardArgs field: tensor}
    tbp: int                      # padded block count (multiple of ndev)


@dataclasses.dataclass
class _PlacedState:
    """Full per-*version* state: the epoch's base plus the mutable
    pieces, per shard.  ``source`` is what the mutable pieces were read
    from (a stream's device mirrors, or the frozen index): while it is
    the same object and every shard is on its device, the views stay
    current and the state is reused.  ``signature`` keys the executable
    cache; on the card it ends with the placement's ``generation``,
    bumped whenever the placed tensors change, because a CUDA graph reads
    its inputs by address."""
    base: _BasePlacement
    mutable: tuple                # per shard: vectors, delta_codes, ids, live
    source: object
    signature: Tuple

    def serve_args(self, plane_shards=None) -> Tuple[ShardArgs, ...]:
        """The serve step's ``shards``: with ``plane_shards`` (per shard
        the plane's block codes, codec books and delta codes) the compact
        plane substituted into the block store, the LUT source and the
        delta scan."""
        out = []
        for r, (b, m) in enumerate(zip(self.base.shards, self.mutable)):
            kw = dict(b, **m)
            if plane_shards is not None:
                p = plane_shards[r]
                kw.update(block_codes=p[0], codebooks=p[1],
                          delta_codes=p[2])
            out.append(ShardArgs(**kw))
        return tuple(out)


class _Placement:
    """Placed tensors, the executable cache and the graph pool shared by
    every ``ShardedIndex`` of one (index, mesh, axes): views differing
    only in ``max_scan_local`` must not place the index twice."""

    def __init__(self):
        self.state: Optional[_PlacedState] = None
        self.version = None
        self.base: Optional[_BasePlacement] = None
        self.base_epoch = None
        self.generation = 0
        self.exec_cache: Dict[tuple, dict] = {}
        self.budget_cache: Dict[tuple, int] = {}   # derived max_scan_local
        # compact planes: per epoch the block codes and codec books per
        # shard, per version the delta's plane codes per shard
        self.plane_base: Dict[str, tuple] = {}
        self.plane_delta: Dict[str, tuple] = {}
        self.pool = None
        self.pool_anchor = None


def shard_index(index, mesh, axes=("data",),
                max_scan_local: Optional[int] = None) -> "ShardedIndex":
    """Cached ``ShardedIndex`` factory behind ``RairsIndex.shard`` /
    ``StreamingIndex.shard``: one per (mesh, axes, max_scan_local) on the
    index (equal meshes hit the same entry), and views differing only in
    ``max_scan_local`` share one placement and executable cache."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch Mesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    cache = index.__dict__.setdefault("_shard_cache", {})
    key = (mesh, axes, max_scan_local)
    if key not in cache:
        cache[key] = ShardedIndex(index, mesh, axes=axes,
                                  max_scan_local=max_scan_local)
    return cache[key]


class ShardedIndex:
    """A mesh deployment of an index, serving through ``Searcher``
    sessions.

    Reads like ``RairsIndex`` / ``StreamingIndex`` (config / centroids /
    codebook / vectors / device / searcher / search / searcher_stats)
    and, over a streaming base, mutates like it (insert / delete /
    compact), so code written against the single-host API runs unchanged
    on a mesh.  ``device`` is the result device, the mesh's first shard's.
    """

    def __init__(self, index, mesh: Mesh, axes=("data",),
                 max_scan_local: Optional[int] = None):
        if isinstance(index, ShardedIndex):
            raise TypeError("index is already a ShardedIndex")
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a repro_torch Mesh (make_mesh), "
                            f"got {type(mesh).__name__}")
        self.index = index
        self.mesh = mesh
        self.axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self.devices = mesh.shard_devices(self.axes)
        self.ndev = len(self.devices)
        self.max_scan_local = max_scan_local
        self.streaming = isinstance(index, StreamingIndex)
        # one CUDA graph per bucket when every shard is on one card
        self.graphs = (self.devices[0].type == "cuda"
                       and len(set(self.devices)) == 1)
        pcache = index.__dict__.setdefault("_placement_cache", {})
        self._placement: _Placement = pcache.setdefault(
            (mesh, self.axes), _Placement())
        self._sessions: Dict[SearchParams, "ShardedSearcher"] = {}
        self._retired: Dict[str, int] = {}
        self._n_invalidations = 0

    # ------------------------------------------------------------------
    # read side
    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def config(self):
        return self.index.config

    @property
    def centroids(self):
        return self.index.centroids

    @property
    def codebook(self):
        return self.index.codebook

    @property
    def vectors(self):
        return self.index.vectors

    @property
    def needs_result_dedup(self) -> bool:
        return self.index.needs_result_dedup

    @property
    def result_oversample(self) -> int:
        return self.index.result_oversample

    def default_max_scan(self, nprobe: int, slack: float = 1.3) -> int:
        return self.index.default_max_scan(nprobe, slack)

    @property
    def epoch(self) -> int:
        return getattr(self.index, "epoch", 0)

    @property
    def version(self) -> int:
        return getattr(self.index, "version", 0)

    def plane(self, backend: str, codec=None):
        """The wrapped index's compact plane (``Searcher.__init__``
        resolves a session's plane through it); its placement on the
        shards is ``_plane_shards``."""
        return self.index.plane(backend, codec=codec)

    # mutations (a streaming base only) ---------------------------------
    def _stream(self) -> StreamingIndex:
        if not self.streaming:
            raise TypeError(
                "mutations need a streaming base: shard a StreamingIndex "
                "(index.streaming().shard(mesh)) instead of a frozen "
                "RairsIndex")
        return self.index

    def insert(self, x) -> np.ndarray:
        """Append through the base's delta path; the placed state and
        open sessions refresh on the next ``searcher()`` fetch."""
        return self._stream().insert(x)

    def delete(self, ids) -> int:
        return self._stream().delete(ids)

    def compact(self, reason: str = "manual") -> dict:
        """Fold delta and tombstones on the base; the new epoch's block
        rows are placed on the shards at the next session fetch."""
        return self._stream().compact(reason=reason)

    def live_ids(self) -> np.ndarray:
        return self._stream().live_ids()

    def live_vectors(self):
        return self._stream().live_vectors()

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def _place_base(self, base) -> _BasePlacement:
        """One epoch's base layout on the shards."""
        nd = self.ndev
        arrays = base.arrays
        tb = arrays.block_ids.shape[0]
        tb_l = -(-tb // nd)
        tables = tables_from_arrays(arrays)
        reps = _replicas(dict(tables._asdict(), centroids=base.centroids,
                              codebooks=base.codebook.codebooks),
                         self.devices)
        shards = []
        for r, dev in enumerate(self.devices):
            lo, hi = r * tb_l, (r + 1) * tb_l
            shards.append(dict(
                reps[r],
                block_codes=_rows(arrays.block_codes, lo, hi, dev, 0),
                block_ids=_rows(arrays.block_ids, lo, hi, dev, -1),
                block_other=_rows(arrays.block_other, lo, hi, dev, -1)))
        return _BasePlacement(shards=tuple(shards), tbp=tb_l * nd)

    def _mutable_source(self):
        """(vectors, delta_codes, delta_ids, live, capacity, source): a
        stream's device mirrors, or the frozen index with zero-width
        streaming tensors."""
        idx = self.index
        if self.streaming:
            dev = idx._device_state()       # id-aligned base + delta
            return (dev.vectors_full, dev.delta_codes, dev.delta_ids,
                    dev.live_full, dev.capacity, dev)
        d = idx.device
        return (idx.vectors,
                torch.zeros((0, idx.codebook.m), dtype=torch.uint8,
                            device=d),
                torch.zeros((0,), dtype=torch.int32, device=d),
                torch.zeros((0,), dtype=torch.bool, device=d), 0, idx)

    def _ensure_state(self) -> _PlacedState:
        pl = self._placement
        v = self.version
        if pl.state is not None and pl.version == v:
            return pl.state
        if pl.base is None or pl.base_epoch != self.epoch:
            base = self.index.base if self.streaming else self.index
            pl.base = self._place_base(base)
            pl.base_epoch = self.epoch
            pl.plane_base.clear()
            pl.plane_delta.clear()
        vectors, dcodes, dids, live, cap, source = self._mutable_source()
        prev = pl.state
        local = all(d == vectors.device for d in self.devices)
        if not (prev is not None and prev.base is pl.base
                and prev.source is source and local):
            nd = self.ndev
            n_l = -(-vectors.shape[0] // nd)
            reps = _replicas(dict(delta_codes=dcodes, delta_ids=dids,
                                  live=live), self.devices)
            mutable = tuple(
                dict(reps[r], vectors=_vector_rows(
                    vectors, r * n_l, (r + 1) * n_l, dev))
                for r, dev in enumerate(self.devices))
            pl.generation += 1
            signature = (pl.base.tbp, n_l * nd, cap, nd)
            if self.graphs:
                signature += (pl.generation,)
                # graphs of older placements read tensors that are gone
                for key in [k for k in pl.exec_cache
                            if k[2][-1] != pl.generation]:
                    del pl.exec_cache[key]
            prev = _PlacedState(base=pl.base, mutable=mutable, source=source,
                                signature=signature)
        pl.state = prev
        pl.version = v
        return prev

    def _plane_shards(self, plane) -> tuple:
        """The compact plane on the shards: its packed block codes in the
        base's block rows (the same padded TB, so the block windows line
        up), the codec books and the delta's plane codes replicated.
        Cached per epoch and version like their full-width twins."""
        pl = self._placement
        nd = self.ndev
        hit = pl.plane_base.get(plane.backend)
        if hit is None:
            tb_l = pl.base.tbp // nd
            books = _replicas({"b": plane.codec.codebooks}, self.devices)
            hit = tuple((_rows(plane.block_codes, r * tb_l, (r + 1) * tb_l,
                               dev, 0), books[r]["b"])
                        for r, dev in enumerate(self.devices))
            pl.plane_base[plane.backend] = hit
        if self.streaming:
            dcodes = self.index._plane_delta_codes(plane.backend)
        else:
            dcodes = torch.zeros((0, plane.codec.codebooks.shape[0]),
                                 dtype=torch.uint8,
                                 device=self.index.device)
        dhit = pl.plane_delta.get(plane.backend)
        if dhit is None or dhit[0] != self.version or dhit[1] is not dcodes:
            reps = _replicas({"d": dcodes}, self.devices)
            dhit = (self.version, dcodes, tuple(r["d"] for r in reps))
            pl.plane_delta[plane.backend] = dhit
        return tuple((c, b, d) for (c, b), d in zip(hit, dhit[2]))

    def _graph_pool(self):
        """The pool every session's graphs on this placement capture
        into (executables outlive sessions), with its anchor graph."""
        pl = self._placement
        if pl.pool is None:
            pl.pool = torch.cuda.graph_pool_handle()
            pl.pool_anchor = _pool_anchor(pl.pool, self.device)
        return pl.pool

    def derived_max_scan_local(self, nprobe: int) -> int:
        """Per-shard plan budget from per-shard list occupancy.

        For each shard, every list contributes only the table entries
        (owned / refs / misc) whose block falls in that shard's block
        range; the worst query selects at most the ``nprobe`` fullest
        such lists, so the sum of their local counts bounds any local
        plan: the derived budget never truncates a plan, hence is
        recall-neutral.  Sessions use ``min(params.max_scan, derived)``
        when ``max_scan_local`` is unset; on one shard that is bitwise
        the plain ``Searcher`` either way (the old budget applies, or
        nothing truncates anywhere).  Cached per (epoch, nprobe, ndev)
        on the shared placement."""
        pl = self._placement
        key = (self.epoch, nprobe, self.ndev)
        if key not in pl.budget_cache:
            base = self.index.base if self.streaming else self.index
            arrays = base.arrays
            nd = self.ndev
            tb = arrays.block_codes.shape[0]
            tb_l = (tb + (-tb) % nd) // nd        # padded rows per shard
            counts = np.zeros((base.config.nlist, nd), np.int64)
            for tbl in (arrays.owned, arrays.refs, arrays.misc):
                t = tbl.cpu().numpy()
                rows = np.repeat(np.arange(t.shape[0]), t.shape[1])
                blocks = t.ravel()
                ok = blocks >= 0
                np.add.at(counts, (rows[ok], blocks[ok] // tb_l), 1)
            top = np.sort(counts, axis=0)[::-1][:nprobe]
            pl.budget_cache[key] = max(int(top.sum(axis=0).max()), 1)
        return pl.budget_cache[key]

    # ------------------------------------------------------------------
    # sessions
    # ------------------------------------------------------------------
    def searcher(self, params: Optional[SearchParams] = None, *,
                 device: DeviceLike = None,
                 **kwargs) -> "ShardedSearcher":
        """Create (or fetch) a mesh session for ``params``.

        The contract of the single-host ``searcher()``: sessions are
        cached per params; over a streaming base a cached session is
        returned only while the index has not mutated past it (a stale
        one is dropped, its stats folded, and replaced; executables are
        shared through a shape-keyed cache).  ``device`` (None: the
        mesh's) must be the result device, ``self.device``.
        """
        if device is not None:
            dev = resolve_device(device)
            if dev.type != self.device.type or (
                    dev.index is not None and dev != self.device):
                raise ValueError(f"the mesh answers on {self.device}, "
                                 f"session asked for {dev}")
        if params is None:
            params = SearchParams(**kwargs)
        elif kwargs:
            params = dataclasses.replace(params, **kwargs)
        if params.plan_reuse:
            raise ValueError(
                "plan_reuse is a single-host session feature (the plan "
                "cache merges host-side between dispatches); mesh "
                "sessions support exec_mode='clustered' for per-device "
                "tile unions instead")
        sess = self._sessions.get(params)
        if sess is not None and sess.version == self.version:
            return sess
        if sess is not None:
            self._fold_session(sess)
            self._n_invalidations += 1
        sess = ShardedSearcher(self, params)
        self._sessions[params] = sess
        return sess

    def search(self, queries, k: int, nprobe: int, k_factor: int = 10,
               max_scan: Optional[int] = None, exec_mode: str = "paged",
               query_tile: int = 8) -> SearchResult:
        """Keyword path mirroring ``RairsIndex.search``."""
        return self.searcher(SearchParams(
            k=k, nprobe=nprobe, k_factor=k_factor, max_scan=max_scan,
            exec_mode=exec_mode, query_tile=query_tile))(queries)

    def _fold_session(self, sess: Searcher):
        for key, v in sess.stats.as_dict().items():
            self._retired[key] = self._retired.get(key, 0) + v

    def searcher_stats(self) -> dict:
        live = list(self._sessions.values())
        out = {
            "sessions": len(live) + self._n_invalidations,
            "invalidations": self._n_invalidations,
            "ndev": self.ndev,
            "epoch": self.epoch,
            "version": self.version,
        }
        for key in ("compiles", "cache_hits"):
            out[key] = (self._retired.get(key, 0)
                        + sum(getattr(s.stats, key) for s in live))
        return out


class ShardedSearcher(Searcher):
    """A session over one ``ShardedIndex`` (create via
    ``sharded.searcher(params)``).

    ``Searcher``'s machinery (buckets, chunking, compile and cache stats)
    and, over a streaming base, the (epoch, version) pin with
    ``StaleSessionError``.  Its executable per bucket is the
    ``build_serve_step`` program over the placed shards: one CUDA graph
    when every shard is on one card (captured into the placement's pool),
    the eager step across cards (a graph cannot span cards) and on the
    CPU.  While a tracer is active a batch runs the step eagerly, its two
    halves fenced (``stage.shard_scan``, ``stage.gather_finalize``).
    """

    def __init__(self, sharded: ShardedIndex, params: SearchParams):
        self.sharded = sharded
        self.version = sharded.version
        state = sharded._ensure_state()
        super().__init__(sharded.index, params)
        self.epoch = sharded.epoch
        self._state = state
        # per-shard plan budget: explicit max_scan_local, or derived from
        # per-shard list occupancy (never truncates) capped by the
        # per-query one
        self.max_scan_local = (
            sharded.max_scan_local if sharded.max_scan_local is not None
            else min(self.params.max_scan,
                     sharded.derived_max_scan_local(self.params.nprobe)))
        # executables depend on (params, per-shard budget, shapes) only,
        # the placed tensors being inputs: sibling views and later
        # versions with equal shapes share them
        self._compiled = sharded._placement.exec_cache.setdefault(
            (self.params, self.max_scan_local, state.signature), {})

    @property
    def device(self) -> torch.device:
        return self.sharded.device

    def _graph_pool(self):
        return self.sharded._graph_pool() if self.sharded.graphs else None

    def _check_current(self) -> None:
        sh = self.sharded
        if self.version != sh.version:
            raise StaleSessionError(
                f"sharded session pinned (epoch {self.epoch}, version "
                f"{self.version}) but the index is at (epoch {sh.epoch}, "
                f"version {sh.version}); mutations invalidate sessions — "
                f"re-fetch via sharded.searcher(params)")

    def _call_inputs(self) -> tuple:
        """The placed shards (``ShardArgs`` in mesh order), with the
        compact plane substituted when a refine tier is active."""
        planes = (None if self._plane is None
                  else self.sharded._plane_shards(self._plane))
        return self._state.serve_args(planes)

    def _search_fn(self):
        sh, p, idx = self.sharded, self.params, self.index
        serve = build_serve_step(
            nprobe=p.nprobe, bigk=p.bigk_eff, k=p.k,
            max_scan_local=self.max_scan_local, metric=idx.config.metric,
            dedup_results=idx.needs_result_dedup,
            oversample=idx.result_oversample, exec_mode=p.exec_mode,
            query_tile=p.query_tile, streaming=sh.streaming,
            fused_topk=p.fused_topk, packed_codes=self._plane is not None)

        def fn(q, *shards):
            return serve(shards, q)
        return fn
