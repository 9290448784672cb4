"""StreamingIndex — a mutable, epoch-versioned view over a frozen base
(counterpart of ``repro/core/stream/streaming.py``).

  * the **base** is an ordinary immutable ``RairsIndex`` (one *epoch*);
  * inserts go to an append-only **delta segment** (stream/delta.py),
    assigned through the strategy registry and PQ-encoded exactly like the
    base, and scanned beside it (stream/search.py): exhaustively while the
    delta is small, routed through the probed lists once its capacity
    passes ``IndexConfig.delta_route_min`` (default ``nlist * block``);
    no layout is rebuilt;
  * deletes flip bits in a **tombstone mask** over the whole id space;
    dead items are masked at query time, never rewritten out;
  * **compaction** folds the survivors (base minus tombstones, then the
    live delta) into a fresh SEIL base, renumbers ids densely
    (``last_remap``: old -> new, -1 deleted) and bumps ``epoch``.
    ``begin_compact`` is the zero-downtime variant: ``fold()`` builds the
    next layout from a snapshot (on any thread) while the stream keeps
    serving and mutating, ``install()`` swaps it in and replays the
    mutations that arrived meanwhile;
  * **external ids** are stable handles: ``resolve_ids`` /
    ``external_ids`` translate through a map that chains every remap;
  * **sessions** (``StreamingSearcher``) pin the (epoch, version) they
    were made at: a mutation bumps ``version``, and a stale session raises
    ``StaleSessionError``.  Sessions share executables through a
    stream-level cache keyed by (params, delta capacity, posting width),
    so steady churn inside one capacity bucket captures nothing new.

On the card (what the reference's functional arrays do not need):

  * the device mirrors of the mutable state (``_DeviceState``: the
    id-aligned refine store, delta codes / ids / postings / assignments,
    the tombstone mask) are patched **in place** (slice ``copy_``,
    ``index_put_``), because a captured CUDA graph reads them by address.
    Executables take them as explicit inputs (``_call_inputs``), and a
    graph handed the very tensor it captured copies nothing.  The
    mirrors are rebuilt only on a capacity jump, and
    the postings alone on a posting-width jump: both change the
    executable key, and the executables of older keys are dropped;
  * a compact plane's delta codes live in one buffer per (backend,
    capacity), encoded whole when first asked for; each insert then
    encodes its batch into it in place (``_plane_delta_codes``);
  * the graphs of every session of an epoch allocate from one memory pool
    owned by the stream's epoch (``_pool``), because an executable
    outlives the session that captured it.  One session at a time
    (``core/graphs.py``).  The epoch also keeps a one-op graph captured
    into that pool (``_pool_anchor``): PyTorch releases a pool once its
    last graph dies and refuses a later capture into it, and a capacity
    jump drops every graph of the old capacity (``_prune_executables``)
    while the epoch goes on capturing into its pool;
  * ``PendingCompaction.fold()`` touches no device (numpy and
    ``seil.build_seil_host`` on the snapshot), so it cannot break a
    capture on the serving thread; ``install()``, on the serving thread,
    moves the layout to the card and gathers the surviving vectors there.

Mutation costs: insert is O(batch) (assign + encode, a plane's encode
too, + buffer patches),
delete O(batch) (a scatter into the mask), compaction the one O(n)
operation, by thresholds (``StreamConfig``) or on request.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ... import obs
# module (not symbol) imports: the insert path sees a patched
# index_mod.pq_encode / compute_assignments exactly as build_index does
from .. import index as index_mod
from ...device import DeviceLike, resolve_device
from ...errors import StaleSessionError
from ...kernels.pq_scan import pq_encode_kernel
from ..params import SearchParams
from ..search import SearchResult
from ..searcher import Searcher
from ..seil import SeilStats, arrays_to_device, build_seil_host
from .delta import DeltaSegment
from .search import DeltaInputs

__all__ = ["PendingCompaction", "StaleSessionError", "StreamConfig",
           "StreamStats", "StreamingIndex", "StreamingSearcher"]


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Streaming-side knobs (query knobs stay in ``SearchParams``).

    delta_pad           delta capacity bucket quantum: buffers are padded
                        to ``delta_pad * 2**j`` slots so compiled shapes
                        stay bounded under churn
    compact_delta_frac  auto-compact when the delta segment exceeds this
                        fraction of the base size (None = manual only)
    compact_dead_frac   auto-compact when tombstoned items exceed this
                        fraction of the id space (None = manual only)
    """
    delta_pad: int = 256
    compact_delta_frac: Optional[float] = None
    compact_dead_frac: Optional[float] = None

    def __post_init__(self):
        if self.delta_pad < 1:
            raise ValueError(f"delta_pad must be >= 1, got {self.delta_pad}")
        for name in ("compact_delta_frac", "compact_dead_frac"):
            v = getattr(self, name)
            if v is not None and not v > 0:
                raise ValueError(f"{name} must be > 0 or None, got {v!r}")


@dataclasses.dataclass
class StreamStats:
    """Mutation / session accounting for one StreamingIndex."""
    inserts: int = 0           # vectors appended
    deletes: int = 0           # items newly tombstoned
    compactions: int = 0
    auto_compactions: int = 0  # subset of compactions (threshold-triggered)
    sessions: int = 0          # StreamingSearcher objects created
    invalidations: int = 0     # cached sessions dropped as stale

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _DeviceState:
    """Device mirrors of the mutable state, patched in place between
    capacity-bucket jumps (which rebuild them)."""
    vectors_full: torch.Tensor   # (n_base + cap, D) id-aligned refine store
    delta_codes: torch.Tensor    # (cap, M) uint8
    delta_ids: torch.Tensor      # (cap,) int32 global ids, -1 dead/unused
    delta_post: torch.Tensor     # (nlist, L) int32 per-list slot postings
    delta_assigns: torch.Tensor  # (cap, m) int32 assigned lists per slot
    live_full: torch.Tensor      # (n_base + cap,) bool
    no_post: torch.Tensor        # (nlist, 0) the exhaustive path's postings
    capacity: int


class _Folded(NamedTuple):
    """What ``_fold_host`` computes: the next epoch's layout on the host
    and the old -> new id remap over the snapshot's id space."""
    host: dict                 # SEIL_FIELDS as numpy
    stats: SeilStats
    codes: np.ndarray          # (n, M) uint8 survivors' PQ codes
    assigns: np.ndarray        # (n, m) int32 survivors' assignments
    remap: np.ndarray          # (n_snapshot,) int64, -1 = deleted
    layout_seconds: float


def _host_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (never a view of the host buffer)."""
    return torch.from_numpy(np.array(a)).to(device)


def _pool_anchor(pool, device: torch.device):
    """A one-op CUDA graph captured into ``pool``, kept for as long as the
    pool is captured into (module docstring): PyTorch counts the graphs of
    a pool and asserts at a capture into a pool whose count fell to 0."""
    buf = torch.zeros(1, device=device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        buf.add_(1.0)
    return graph, buf


def _fold_host(cfg, base_codes: np.ndarray, base_assigns: np.ndarray,
               base_live: np.ndarray, d_codes: np.ndarray,
               d_assigns: np.ndarray, d_live: np.ndarray) -> _Folded:
    """The epoch fold on the host: the survivors' stored codes and
    assignments (base first, then delta, in id order) through
    ``build_seil_host``.  Reads only its arguments and touches no device,
    so it may run on any thread (``PendingCompaction.fold``)."""
    codes = np.concatenate([np.asarray(base_codes)[base_live],
                            d_codes[d_live]], axis=0)
    assigns = np.concatenate([np.asarray(base_assigns)[base_live],
                              d_assigns[d_live]], axis=0)
    n = codes.shape[0]
    t1 = time.perf_counter()
    host, stats = build_seil_host(
        assigns, codes, np.arange(n, dtype=np.int32), cfg.nlist,
        block=cfg.block, shared=cfg.seil and cfg.multi_m == 2,
        code_bits=cfg.nbits)
    t_layout = time.perf_counter() - t1
    alive_full = np.concatenate([base_live, d_live])
    remap = np.full(alive_full.shape[0], -1, np.int64)
    remap[np.nonzero(alive_full)[0]] = np.arange(n)
    return _Folded(host, stats, codes, assigns, remap, t_layout)


def _install_base(base, folded: _Folded, base_live: np.ndarray,
                  d_vectors: np.ndarray, d_live: np.ndarray):
    """The folded epoch as a ``RairsIndex`` on the base's device: the
    layout moved there, the surviving vectors gathered there (the
    caller's thread must own the device)."""
    dev = base.device
    keep = torch.from_numpy(np.nonzero(base_live)[0]).to(dev)
    vec = torch.cat([base.vectors[keep],
                     _host_tensor(d_vectors[d_live], dev)], dim=0)
    return index_mod.RairsIndex(
        config=base.config, centroids=base.centroids,
        codebook=base.codebook,
        arrays=arrays_to_device(folded.host, dev), vectors=vec,
        stats=folded.stats, assigns=folded.assigns, codes=folded.codes,
        build_seconds={"layout": folded.layout_seconds})


def _base_codes(base) -> np.ndarray:
    """The base's PQ codes on the host (a bundle without the code cache
    encodes them once)."""
    if base.codes is not None:
        return base.codes
    return index_mod.pq_encode(base.codebook, base.vectors).cpu().numpy()


class PendingCompaction:
    """A two-phase zero-downtime compaction (``begin_compact``).

    ``fold()`` builds the next epoch's layout from the snapshot taken at
    ``begin_compact`` time; it reads only the snapshot copies and touches
    no device, so a worker thread can run it while the stream keeps
    answering queries (CUDA graphs included) and absorbing mutations.
    ``install()`` then moves the layout to the device, swaps the epoch in
    and *replays* everything that arrived after the snapshot: tail inserts
    re-append with their computed codes and assignments, post-snapshot
    deletes re-tombstone through the remap.  The combined remap over the
    whole pre-install id space lands in ``stream.last_remap`` and chains
    into the external-id map exactly like a synchronous ``compact()``.

    Thread contract: ``fold()`` may run on any thread; ``install()``
    mutates the stream and uses the device, and must be serialized
    against every other use of the index.
    """

    def __init__(self, stream: "StreamingIndex", reason: str):
        self.stream = stream
        self.reason = reason
        self.state = "folding"
        d = stream._delta
        self._base0 = stream.base
        self._base_codes0 = _base_codes(stream.base)
        self._epoch0 = stream.epoch
        self._n_base0 = stream.n_base
        self._count0 = d.count
        self._base_live0 = stream._base_live.copy()
        self._d_vectors0 = d.vectors[:d.count].copy()
        self._d_codes0 = d.codes[:d.count].copy()
        self._d_assigns0 = d.assigns[:d.count].copy()
        self._d_live0 = d.live[:d.count].copy()
        self._folded: Optional[_Folded] = None
        self._fold_seconds = 0.0

    def fold(self) -> "PendingCompaction":
        """The O(n) layout build on the host: run it off-thread;
        chainable."""
        if self.state != "folding":
            raise RuntimeError(f"fold() on a {self.state} compaction")
        t0 = time.perf_counter()
        self._folded = _fold_host(
            self._base0.config, self._base_codes0,
            np.asarray(self._base0.assigns), self._base_live0,
            self._d_codes0, self._d_assigns0, self._d_live0)
        self._fold_seconds = time.perf_counter() - t0
        self.state = "ready"
        return self

    def abort(self) -> None:
        """Drop the pending fold; the stream stays on its current epoch."""
        self.state = "aborted"
        if self.stream._pending_compact is self:
            self.stream._pending_compact = None

    def install(self) -> dict:
        """Swap the folded epoch in and replay the mutation tail.  Must
        not race any other use of the stream (class docstring); sessions
        become stale exactly as under ``compact``."""
        st = self.stream
        if self.state != "ready":
            raise RuntimeError(
                f"install() on a {self.state} compaction (fold() first)")
        if st.epoch != self._epoch0:
            self.abort()
            raise RuntimeError(
                "a competing compaction landed while this one folded; "
                "the snapshot is stale")
        t0 = time.perf_counter()
        folded = self._folded
        new_base = _install_base(self._base0, folded, self._base_live0,
                                 self._d_vectors0, self._d_live0)
        remap0 = folded.remap
        d = st._delta
        # mutations that arrived after the snapshot
        tail_vec = d.vectors[self._count0:d.count].copy()
        tail_codes = d.codes[self._count0:d.count].copy()
        tail_assigns = d.assigns[self._count0:d.count].copy()
        tail_live = d.live[self._count0:d.count].copy()
        dead_base = self._base_live0 & ~st._base_live
        dead_delta = self._d_live0 & ~d.live[:self._count0]
        n_total_old = self._n_base0 + d.count
        # swap epochs (sessions stale from here on)
        st.base = new_base
        st.epoch += 1
        st.version += 1
        st.stats.compactions += 1
        st._retire_sessions()
        st._reset_epoch_state()
        # remap over the whole pre-install id space: snapshot ids fold
        # through remap0, live tail inserts re-append under fresh ids
        remap = np.full(n_total_old, -1, np.int64)
        remap[:remap0.size] = remap0
        if tail_live.any():
            lv = np.nonzero(tail_live)[0]
            slots, _ = st._delta.append(
                tail_vec[lv], tail_codes[lv], tail_assigns[lv])
            remap[self._n_base0 + self._count0 + lv] = st.n_base + slots
        # post-snapshot deletes: their victims folded in as live (the
        # snapshot predates them), so re-tombstone through the remap.
        # Stats and version stay put: they were counted when issued.
        dead_old = np.concatenate(
            [np.nonzero(dead_base)[0],
             self._n_base0 + np.nonzero(dead_delta)[0]])
        if dead_old.size:
            st._apply_tombstones(remap[dead_old])
        st._apply_remap(remap)
        st._pending_compact = None
        self.state = "installed"
        return {"epoch": st.epoch, "reason": self.reason,
                "n_live": st.n_live,
                "dropped": int((remap < 0).sum()),
                "seconds": self._fold_seconds + time.perf_counter() - t0,
                "layout_seconds": folded.layout_seconds,
                "replayed_inserts": int(tail_live.sum()),
                "replayed_deletes": int(dead_old.size),
                "id_remap": remap}


class StreamingIndex:
    """Mutable index: an immutable ``RairsIndex`` base epoch plus delta
    segment, tombstone mask, and versioned searcher sessions.

    Duck-type compatible with the read side of ``RairsIndex`` (config /
    centroids / codebook / vectors / device / searcher / search).  Its
    tensors live on the base index's device.
    """

    def __init__(self, base, config: Optional[StreamConfig] = None):
        if isinstance(base, StreamingIndex):
            raise TypeError("base must be an immutable RairsIndex, not a "
                            "StreamingIndex (nest epochs via compact())")
        self.base = base
        self.stream_config = config or StreamConfig()
        self.epoch = 0
        self.version = 0            # bumps on every insert/delete/compact
        self.stats = StreamStats()
        self.last_remap = None      # old id -> new id after last compact
        self._retired: Dict[str, int] = {}   # folded stats of dead sessions
        self._pending_compact: Optional[PendingCompaction] = None
        # stable external ids: the handle first issued for an item never
        # changes; _ext_to_int chains every compaction remap (-1 = dead)
        # and _int_to_ext is its inverse over the current id space
        self._ext_to_int = np.arange(self.n_base, dtype=np.int64)
        self._int_to_ext = np.arange(self.n_base, dtype=np.int64)
        # compact-plane codecs outlive epochs: train once, re-encode
        # every rebuilt base with the carried codec (quant/plane.py)
        self._plane_codecs: Dict[str, object] = {}
        self._reset_epoch_state()

    def _reset_epoch_state(self):
        base = self.base
        self._delta = DeltaSegment(
            dim=int(base.vectors.shape[1]), m_pq=int(base.codebook.m),
            m_assign=int(base.assigns.shape[1]),
            pad=self.stream_config.delta_pad,
            nlist=int(base.config.nlist))
        self._base_live = np.ones(self.n_base, bool)
        self._dead_base = 0
        self._dev: Optional[_DeviceState] = None
        self._sessions: Dict[SearchParams, "StreamingSearcher"] = {}
        self._exec_cache: Dict[tuple, dict] = {}
        # plan_reuse probe-half executables read only the base arrays, so
        # they survive delta capacity / posting jumps (per params; dropped
        # with the epoch like everything here)
        self._probe_cache: Dict[SearchParams, dict] = {}
        # per backend: (capacity, codec, the delta's plane codes)
        self._plane_delta: Dict[str, tuple] = {}
        # the memory pool of this epoch's CUDA graphs, shared by its
        # sessions because the executables are
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self._pool_anchor = (_pool_anchor(self._pool, self.device)
                             if self._pool is not None else None)

    # ------------------------------------------------------------------
    # sizes / views
    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def n_base(self) -> int:
        return int(self.base.vectors.shape[0])

    @property
    def n_total(self) -> int:
        """Size of the id space (base + every delta slot ever used)."""
        return self.n_base + self._delta.count

    @property
    def n_delta(self) -> int:
        """Live items in the delta segment."""
        return self._delta.n_live

    @property
    def n_dead(self) -> int:
        return self._dead_base + self._delta.n_dead

    @property
    def n_live(self) -> int:
        return self.n_total - self.n_dead

    @property
    def has_mutations(self) -> bool:
        """Any insert/delete since the current epoch's base was built."""
        return self._delta.count > 0 or self._dead_base > 0

    @property
    def delta_route_threshold(self) -> int:
        """Delta capacity above which the scan routes through the probed
        lists (``IndexConfig.delta_route_min``; default ``nlist *
        block``)."""
        cfg = self.base.config
        if cfg.delta_route_min is not None:
            return cfg.delta_route_min
        return cfg.nlist * cfg.block

    @property
    def delta_routed(self) -> bool:
        """Whether the current delta capacity bucket scans routed (keyed
        on capacity, a static property of the executables' shapes)."""
        return self._delta.capacity > self.delta_route_threshold

    def routes_at(self, nprobe: int) -> bool:
        """Session-level routing decision, made on the host.  An explicit
        ``delta_route_min`` is final; under the auto threshold the routed
        gather (~``nprobe x post_width`` rows a query) must also be
        cheaper than the exhaustive ``capacity`` rows."""
        if not self.delta_routed:
            return False
        if self.base.config.delta_route_min is not None:
            return True
        return nprobe * self._delta.post_width < self._delta.capacity

    # read-side duck typing with RairsIndex --------------------------------
    @property
    def config(self):
        return self.base.config

    @property
    def centroids(self):
        return self.base.centroids

    @property
    def codebook(self):
        return self.base.codebook

    @property
    def arrays(self):
        return self.base.arrays

    @property
    def seil_stats(self):
        return self.base.stats

    # RairsIndex exposes `.stats` as SeilStats; StreamingIndex.stats is the
    # mutation counter, so the layout stats keep their own accessor above.

    @property
    def needs_result_dedup(self) -> bool:
        return self.base.needs_result_dedup

    @property
    def result_oversample(self) -> int:
        return self.base.result_oversample

    def default_max_scan(self, nprobe: int, slack: float = 1.3) -> int:
        return self.base.default_max_scan(nprobe, slack)

    def plane(self, backend: str, codec=None):
        """The stream-level compact plane: the current base epoch's, with
        the codec pinned across compactions (the first epoch trains it,
        every rebuilt base re-encodes with it).  An explicit ``codec=``
        (bundle restore) takes precedence."""
        if codec is None:
            codec = self._plane_codecs.get(backend)
        pp = self.base.plane(backend, codec=codec)
        self._plane_codecs[backend] = pp.codec
        return pp

    def _plane_delta_codes(self, backend: str) -> torch.Tensor:
        """(capacity, Mc) uint8 plane codes of the delta buffer, unpacked
        (the delta scan is a per-slot gather).  One buffer per capacity
        and codec, encoded whole when first asked for; after that
        ``insert`` encodes only its batch into it, in place, so a
        mutation costs O(batch) and the executables that read the buffer
        by address see the current codes.  Deletes leave it as it is (the
        scan masks dead slots by id).  A slot's code is thus its insert
        batch's encode or the buffer's, as the main PQ codes are encoded
        a batch at a time."""
        from ...quant import encode_plane
        d = self._delta
        codec = self.plane(backend).codec
        hit = self._plane_delta.get(backend)
        if hit is not None and hit[0] == d.capacity and hit[1] is codec:
            return hit[2]
        codes = torch.from_numpy(encode_plane(codec, d.vectors)).to(
            self.device)
        if hit is not None and hit[2].shape == codes.shape:
            hit[2].copy_(codes)
            codes = hit[2]
        self._plane_delta[backend] = (d.capacity, codec, codes)
        return codes

    @property
    def vectors(self) -> torch.Tensor:
        """(n_total, D) id-aligned vector view (tombstoned rows included)."""
        d = self._delta
        if d.count == 0:
            return self.base.vectors
        if self._dev is not None:
            return self._dev.vectors_full[:self.n_total]
        return torch.cat([self.base.vectors,
                          _host_tensor(d.vectors[:d.count], self.device)])

    @property
    def assigns(self) -> np.ndarray:
        """(n_total, m) id-aligned assignment view (host)."""
        d = self._delta
        if d.count == 0:
            return self.base.assigns
        return np.concatenate(
            [np.asarray(self.base.assigns), d.assigns[:d.count]], axis=0)

    @property
    def codes(self) -> Optional[np.ndarray]:
        """(n_total, M) id-aligned PQ-code view (None only for a base
        without the code cache that was never mutated)."""
        d = self._delta
        if d.count == 0:
            return self.base.codes
        return np.concatenate([_base_codes(self.base), d.codes[:d.count]],
                              axis=0)

    def live_mask(self) -> np.ndarray:
        """(n_total,) host bool: True where the id is still live."""
        return np.concatenate(
            [self._base_live, self._delta.live[:self._delta.count]])

    def live_ids(self) -> np.ndarray:
        return np.nonzero(self.live_mask())[0].astype(np.int64)

    def live_vectors(self) -> torch.Tensor:
        """(n_live, D) surviving vectors in id order (oracle / recall)."""
        d = self._delta
        keep = torch.from_numpy(np.nonzero(self._base_live)[0]).to(
            self.device)
        return torch.cat([self.base.vectors[keep],
                          _host_tensor(d.vectors[:d.count][
                              d.live[:d.count]], self.device)])

    # ------------------------------------------------------------------
    # device mirrors
    # ------------------------------------------------------------------
    def _device_state(self) -> _DeviceState:
        if self._dev is None:
            d = self._delta
            nb, dev = self.n_base, self.device
            vec = torch.empty((nb + d.capacity, d.dim), dtype=torch.float32,
                              device=dev)
            vec[:nb].copy_(self.base.vectors)
            vec[nb:].copy_(torch.from_numpy(d.vectors))
            ids = np.full(d.capacity, -1, np.int32)
            used = np.arange(d.count)
            live_used = used[d.live[:d.count]]
            ids[live_used] = nb + live_used
            self._dev = _DeviceState(
                vectors_full=vec,
                delta_codes=_host_tensor(d.codes, dev),
                delta_ids=_host_tensor(ids, dev),
                delta_post=_host_tensor(d.post, dev),
                delta_assigns=_host_tensor(d.assigns, dev),
                live_full=_host_tensor(
                    np.concatenate([self._base_live, d.live]), dev),
                no_post=torch.zeros((self.base.config.nlist, 0),
                                    dtype=torch.int32, device=dev),
                capacity=d.capacity)
            self._prune_executables()
        return self._dev

    def _prune_executables(self) -> None:
        """Drop the executables of other capacities and posting widths:
        they read mirrors that were replaced (and capacity and width only
        grow within an epoch, so no session asks for them again)."""
        cap, pw = self._delta.capacity, self._delta.post_width
        for key in list(self._exec_cache):
            if key[1] != cap or key[2] not in (0, pw):
                del self._exec_cache[key]

    # ------------------------------------------------------------------
    # mutations
    # ------------------------------------------------------------------
    def insert(self, x) -> np.ndarray:
        """Append vectors through the delta path; returns their ids.

        O(batch): strategy-registry assignment and PQ encoding of the new
        rows, then patches of the host buffers and the device mirrors,
        never a layout build (``seil.build_seil_call_count``).  The span
        ``stream.insert.encode`` counts ``kernel``: 1 where the encode
        kernel ran (a CUDA stream), 0 on the CPU.
        """
        if torch.is_tensor(x):
            x = x.detach().cpu().numpy()
        x = np.array(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.base.vectors.shape[1]:
            raise ValueError(
                f"insert batch must be (B, {self.base.vectors.shape[1]}), "
                f"got {x.shape}")
        if x.shape[0] == 0:
            return np.zeros(0, np.int64)
        with obs.span("stream.insert", cat="stream", rows=x.shape[0]):
            base, dev = self.base, self.device
            with obs.span("stream.insert.assign", cat="device"):
                xt = torch.from_numpy(x).to(dev)
                assigns = np.asarray(index_mod.compute_assignments(
                    xt, base.centroids, base.config), np.int32)
            with obs.span("stream.insert.encode", cat="device") as sp:
                launches = pq_encode_kernel.launches
                codes = obs.to_host(index_mod.pq_encode(base.codebook,
                                                        xt)).numpy()
                sp.add(kernel=int(pq_encode_kernel.launches > launches))
            nb = self.n_base
            d = self._delta
            cap0, width0 = d.capacity, d.post_width
            with obs.span("stream.insert.host", cat="host"):
                slots, _ = d.append(x, codes, assigns)
                ids = nb + slots
                # hand out permanent external handles (identical to the
                # internal id at insert time; compaction remaps chain
                # through _apply_remap)
                n_ext = self._ext_to_int.size
                ext = np.arange(n_ext, n_ext + ids.size, dtype=np.int64)
                self._ext_to_int = np.concatenate([self._ext_to_int, ids])
                self._int_to_ext = np.concatenate([self._int_to_ext, ext])
            with obs.span("stream.insert.mirror", cat="device"):
                if self._dev is not None and d.capacity == cap0:
                    dv = self._dev
                    s0, s1 = int(slots[0]), int(slots[-1]) + 1
                    dv.vectors_full[nb + s0:nb + s1].copy_(xt)
                    dv.delta_codes[s0:s1].copy_(torch.from_numpy(codes))
                    dv.delta_ids[s0:s1].copy_(
                        torch.from_numpy(ids.astype(np.int32)))
                    dv.delta_assigns[s0:s1].copy_(torch.from_numpy(assigns))
                    if d.post_width != width0:
                        # a posting-width jump: a wider mirror, and a new
                        # key for the routed sessions
                        dv.delta_post = _host_tensor(d.post, dev)
                        self._prune_executables()
                    else:
                        pl, pc, ps = d.last_post_update
                        if len(pl):
                            dv.delta_post[torch.from_numpy(pl).to(dev),
                                          torch.from_numpy(pc).to(dev)] = (
                                torch.from_numpy(ps.astype(np.int32)).to(dev))
                    dv.live_full[nb + s0:nb + s1] = True
                else:
                    self._dev = None   # capacity bucket jump: rebuild lazily
                if d.capacity != cap0:
                    self._plane_delta.clear()
                elif self._plane_delta:
                    from ...quant import encode_plane
                    s0, s1 = int(slots[0]), int(slots[-1]) + 1
                    for _, codec, buf in self._plane_delta.values():
                        buf[s0:s1].copy_(
                            torch.from_numpy(encode_plane(codec, xt)))
                obs.fence(xt)
        self.version += 1
        self.stats.inserts += x.shape[0]
        epoch_before = self.epoch
        self._maybe_auto_compact()
        if self.epoch != epoch_before:
            # compaction renumbered the id space; the fresh inserts are
            # alive by construction, so the remap covers all of them
            ids = self.last_remap[ids]
        return ids

    def _mask_device(self, ids: np.ndarray, dslots: np.ndarray) -> None:
        """Tombstone ``ids`` (and delta slots ``dslots``) in the device
        mirrors, in place."""
        if self._dev is None:
            return
        dv, dev = self._dev, self.device
        dv.live_full[torch.from_numpy(ids).to(dev)] = False
        if dslots.size:
            dv.delta_ids[torch.from_numpy(dslots).to(dev)] = -1
        obs.fence(dv.live_full)

    def delete(self, ids) -> int:
        """Tombstone `ids` (base and/or delta); returns how many were
        live until now.  Dead/duplicate ids are a no-op; out-of-range
        ids raise.  O(batch): bitmap scatter, no layout rewrite."""
        if torch.is_tensor(ids):
            ids = ids.detach().cpu().numpy()
        ids = np.asarray(ids, np.int64).ravel()
        if ids.size == 0:
            return 0
        with obs.span("stream.delete", cat="stream", rows=ids.size):
            with obs.span("stream.delete.host", cat="host"):
                ids = np.unique(ids)
                if ids[0] < 0 or ids[-1] >= self.n_total:
                    raise ValueError(
                        f"delete ids out of range [0, {self.n_total})")
                nb = self.n_base
                bids = ids[ids < nb]
                dslots = ids[ids >= nb] - nb
                newly_base = int(self._base_live[bids].sum())
                newly = newly_base + int(self._delta.live[dslots].sum())
                if newly == 0:
                    return 0    # idempotent retry: nothing changed
                self._base_live[bids] = False
                self._dead_base += newly_base
                self._delta.mark_dead(dslots)
            with obs.span("stream.delete.mirror", cat="device"):
                self._mask_device(ids, dslots)
        self.version += 1
        self.stats.deletes += newly
        self._maybe_auto_compact()
        return newly

    def compact(self, reason: str = "manual") -> dict:
        """Fold delta + tombstones into a fresh base epoch.

        Survivors keep their relative (id) order, base first, then delta,
        and are renumbered densely: the new base is ``build_seil`` over
        the survivors' stored assignments and codes with the frozen
        centroids / codebook.  ``last_remap[old_id] -> new_id`` (-1 =
        deleted) records the renumbering; every open session goes stale.
        """
        if self._pending_compact is not None:
            raise RuntimeError(
                "a background compaction is pending (begin_compact); "
                "install() or abort() it before compacting synchronously")
        t0 = time.perf_counter()
        d = self._delta
        folded = _fold_host(
            self.base.config, _base_codes(self.base),
            np.asarray(self.base.assigns), self._base_live,
            d.codes[:d.count], d.assigns[:d.count], d.live[:d.count])
        new_base = _install_base(self.base, folded, self._base_live,
                                 d.vectors[:d.count], d.live[:d.count])
        remap = folded.remap
        n = int((remap >= 0).sum())
        self.base = new_base
        self.epoch += 1
        self.version += 1
        self.stats.compactions += 1
        self._retire_sessions()
        self._reset_epoch_state()
        self._apply_remap(remap)
        return {"epoch": self.epoch, "reason": reason, "n_live": n,
                "dropped": int(remap.size - n),
                "seconds": time.perf_counter() - t0,
                "layout_seconds": folded.layout_seconds, "id_remap": remap}

    def begin_compact(self, reason: str = "background") -> PendingCompaction:
        """Start a zero-downtime compaction: snapshot this epoch and
        return a ``PendingCompaction`` whose ``fold()`` can run on a
        worker thread while searches and mutations keep flowing, and
        whose ``install()`` swaps the new epoch in (replaying the
        post-snapshot mutation tail).  Only one may be pending;
        threshold auto-compaction stands down while it is."""
        if self._pending_compact is not None:
            raise RuntimeError("a background compaction is already pending")
        p = PendingCompaction(self, reason)
        self._pending_compact = p
        return p

    # ------------------------------------------------------------------
    # stable external ids (survive compaction renumbering)
    # ------------------------------------------------------------------
    def _apply_remap(self, remap: np.ndarray) -> None:
        """Record a compaction renumbering and chain it into the
        composed external-id map (external handles never change)."""
        self.last_remap = remap
        e2i = self._ext_to_int
        valid = e2i >= 0
        nxt = np.full(e2i.shape, -1, np.int64)
        nxt[valid] = remap[e2i[valid]]
        self._ext_to_int = nxt
        i2e = np.full(self.n_total, -1, np.int64)
        ext = np.nonzero(nxt >= 0)[0]
        i2e[nxt[ext]] = ext
        self._int_to_ext = i2e

    def resolve_ids(self, external_ids) -> np.ndarray:
        """Map stable external handles to current internal ids; -1 for
        handles that were deleted or never issued.  Handles survive any
        number of compactions (the map chains every ``last_remap``)."""
        e = np.asarray(external_ids, np.int64)
        flat = e.ravel()
        out = np.full(flat.shape, -1, np.int64)
        ok = (flat >= 0) & (flat < self._ext_to_int.size)
        ints = self._ext_to_int[flat[ok]]
        live = self.live_mask()
        out[ok] = np.where(
            (ints >= 0) & live[np.clip(ints, 0, live.size - 1)], ints, -1)
        return out.reshape(e.shape)

    def external_ids(self, internal_ids) -> np.ndarray:
        """Map current internal ids (e.g. ``SearchResult.ids``) to their
        stable external handles; -1 pads pass through."""
        if torch.is_tensor(internal_ids):
            internal_ids = internal_ids.cpu().numpy()
        i = np.asarray(internal_ids, np.int64)
        flat = i.ravel()
        out = np.full(flat.shape, -1, np.int64)
        ok = (flat >= 0) & (flat < self._int_to_ext.size)
        out[ok] = self._int_to_ext[flat[ok]]
        return out.reshape(i.shape)

    def _apply_tombstones(self, ids: np.ndarray) -> None:
        """Install-time tombstone scatter: no version bump, stats, or
        auto-compaction (the replayed deletes were counted when the
        caller issued them, ``PendingCompaction.install``)."""
        ids = np.asarray(ids, np.int64).ravel()
        ids = np.unique(ids[ids >= 0])
        if ids.size == 0:
            return
        nb = self.n_base
        bids = ids[ids < nb]
        dslots = ids[ids >= nb] - nb
        self._dead_base += int(self._base_live[bids].sum())
        self._base_live[bids] = False
        self._delta.mark_dead(dslots)
        self._mask_device(ids, dslots)

    def restore_state(self, *, epoch: int, version: int,
                      base_live: np.ndarray, delta_vectors: np.ndarray,
                      delta_codes: np.ndarray, delta_assigns: np.ndarray,
                      delta_live: np.ndarray) -> None:
        """Rehydrate persisted epoch state (a bundle's streaming section,
        core/io.py) into a freshly wrapped base: codes, assignments and
        liveness are restored, nothing is recomputed.  Only valid before
        any mutation."""
        if self.version != 0 or self._delta.count != 0:
            raise RuntimeError("restore_state requires a pristine "
                               "StreamingIndex")
        if delta_vectors.shape[0]:
            self._delta.append(delta_vectors, delta_codes, delta_assigns)
            self._delta.mark_dead(np.nonzero(~delta_live)[0])
        if base_live.shape[0] != self.n_base:
            raise ValueError(
                f"base_live has {base_live.shape[0]} bits for a base of "
                f"{self.n_base} vectors")
        self._base_live[:] = base_live
        self._dead_base = int((~base_live).sum())
        self._dev = None
        self._plane_delta.clear()
        self.epoch = int(epoch)
        self.version = int(version)
        # external-id state is not persisted (the bundle format predates
        # it): a restored stream issues identity handles over its id space
        self._ext_to_int = np.arange(self.n_total, dtype=np.int64)
        self._int_to_ext = np.arange(self.n_total, dtype=np.int64)

    def _maybe_auto_compact(self):
        if self._pending_compact is not None:
            return      # the background fold owns this epoch's compaction
        sc = self.stream_config
        if (sc.compact_delta_frac is not None
                and self._delta.count > sc.compact_delta_frac
                * max(1, self.n_base)):
            self.stats.auto_compactions += 1
            self.compact(reason="delta_threshold")
        elif (sc.compact_dead_frac is not None
                and self.n_dead > sc.compact_dead_frac
                * max(1, self.n_total)):
            self.stats.auto_compactions += 1
            self.compact(reason="dead_threshold")

    def shard(self, mesh, axes=("data",), max_scan_local=None):
        """Deploy this mutable index over ``mesh`` as a ``ShardedIndex``
        (``core/sharded.py``): the base epoch shards by block and vector
        range, the delta segment and tombstone mask replicate, and a
        compaction places the new base at the next session fetch.
        Mutations keep flowing through this index (the sharded view
        forwards insert / delete / compact); mesh sessions pin (epoch,
        version) as single-host ones do.  Cached per (mesh, axes,
        max_scan_local)."""
        from ..sharded import shard_index
        return shard_index(self, mesh, axes=axes,
                           max_scan_local=max_scan_local)

    # ------------------------------------------------------------------
    # sessions
    # ------------------------------------------------------------------
    def searcher(self, params: Optional[SearchParams] = None, *,
                 device: DeviceLike = None,
                 **kwargs) -> "StreamingSearcher":
        """Create (or fetch) a session pinned to the current version.

        A cached session is returned only while the index has not
        mutated past it; otherwise its stats are folded into the
        aggregate, it is dropped as stale, and a fresh session, sharing
        this stream's executables, replaces it.  ``device`` (None ->
        CUDA) must be the device the index lives on, as for
        ``RairsIndex.searcher``.
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
        sess = self._sessions.get(params)
        if sess is not None and sess.version == self.version:
            return sess
        if sess is not None:
            self._fold_session(sess)
            self.stats.invalidations += 1
        sess = StreamingSearcher(self, params)
        self._sessions[params] = sess
        self.stats.sessions += 1
        return sess

    def search(self, queries, k: int, nprobe: int, k_factor: int = 10,
               max_scan: Optional[int] = None, use_kernel: bool = False,
               exec_mode: str = "paged", query_tile: int = 8, *,
               device: DeviceLike = None) -> SearchResult:
        """Keyword path mirroring ``RairsIndex.search``: always through
        a current (never stale) session."""
        return self.searcher(SearchParams(
            k=k, nprobe=nprobe, k_factor=k_factor, max_scan=max_scan,
            use_kernel=use_kernel, exec_mode=exec_mode,
            query_tile=query_tile), device=device)(queries)

    def _fold_session(self, sess: "Searcher"):
        obs.settle()
        folded = dict(sess.stats.as_dict(), timed_calls=sess.timing.calls,
                      timed_device_s=sess.timing.seconds)
        for key, v in folded.items():
            self._retired[key] = self._retired.get(key, 0) + v

    def _retire_sessions(self):
        for sess in self._sessions.values():
            self._fold_session(sess)
        self._sessions.clear()

    def searcher_stats(self) -> dict:
        """Aggregate compile-cache stats and replay device time over
        live + retired sessions, extending ``RairsIndex.searcher_stats``
        with epoch fields."""
        live = list(self._sessions.values())
        out = {
            "sessions": self.stats.sessions,
            "invalidations": self.stats.invalidations,
            "epoch": self.epoch,
            "version": self.version,
        }
        for key in ("compiles", "cache_hits"):
            out[key] = (self._retired.get(key, 0)
                        + sum(getattr(s.stats, key) for s in live))
        obs.settle()
        out["timed_calls"] = (self._retired.get("timed_calls", 0)
                              + sum(s.timing.calls for s in live))
        out["timed_device_s"] = (self._retired.get("timed_device_s", 0.0)
                                 + sum(s.timing.seconds for s in live))
        out["base"] = self.base.searcher_stats()
        return out


class StreamingSearcher(Searcher):
    """An (epoch, version)-pinned session over a ``StreamingIndex``.

    A pristine epoch (no mutations yet) delegates to the base index's
    own session, so an unmutated stream searches bitwise like its
    ``RairsIndex``.  Once mutated, the session dispatches
    ``seil_search`` with the stream's state (delta scan + tombstone mask)
    per batch bucket; its executables live in the stream-level cache keyed
    by (params, delta capacity, posting width) and take the device
    mirrors as inputs, and their CUDA graphs allocate from the epoch's
    pool (module docstring).
    """

    def __init__(self, stream: StreamingIndex, params: SearchParams):
        self.stream = stream
        self.version = stream.version
        ap = params.active_plane
        if ap is not None:
            # pin the carried codec on the base's plane cache *before*
            # Searcher.__init__ resolves it, so a post-compaction epoch
            # re-encodes with the stream's codec instead of retraining
            stream.plane(ap)
        super().__init__(stream.base, params)
        self.epoch = stream.epoch
        # pinned at session creation: a mutation that changes the answer
        # also bumps the version, which stales the session anyway
        self._route_delta = stream.routes_at(self.params.nprobe)
        if stream.has_mutations:
            self._delegate = None
            # the posting width joins the key only where this session
            # routes (the routed gather's width is a captured shape); the
            # exhaustive path takes a zero-width placeholder, so appends
            # that widen the postings capture nothing new for it
            post_w = stream._delta.post_width if self._route_delta else 0
            self._compiled = stream._exec_cache.setdefault(
                (self.params, stream._delta.capacity, post_w), {})
        else:
            self._delegate = stream.base.searcher(params,
                                                  device=stream.device)

    def _graph_pool(self):
        return self.stream._pool

    def _probe_exe_store(self) -> dict:
        """Probe-half executables read only base arrays: shared across
        delta capacity / posting jumps (same epoch)."""
        return self.stream._probe_cache.setdefault(self.params, {})

    def _check_current(self):
        st = self.stream
        if self.version != st.version:
            raise StaleSessionError(
                f"searcher session pinned (epoch {self.epoch}, version "
                f"{self.version}) but the StreamingIndex is at (epoch "
                f"{st.epoch}, version {st.version}); mutations invalidate "
                f"sessions — re-fetch via stream.searcher(params)")

    def _delta_codes(self, dev: _DeviceState) -> torch.Tensor:
        """The delta codes the scan scores: the index's own, or with a
        refine tier the plane's (unpacked) codes of the delta buffer, so
        that the delta gather and the blocked base scan score tier-1
        distances against the same codec."""
        if self._plane is None:
            return dev.delta_codes
        return self.stream._plane_delta_codes(self._plane.backend)

    def _call_inputs(self) -> tuple:
        dev = self.stream._device_state()
        post = dev.delta_post if self._route_delta else dev.no_post
        return (dev.vectors_full, DeltaInputs(
            self._delta_codes(dev), dev.delta_ids, post, dev.delta_assigns),
            dev.live_full)

    def __call__(self, queries) -> SearchResult:
        if self._delegate is not None:
            self._check_current()
            return self._delegate(queries)
        return super().__call__(queries)

    search = __call__
