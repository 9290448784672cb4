"""Streaming in the port against the reference, on the CPU (1 of 3).

The mutations of ``tests/test_stream.py`` run on a reference index and
on the same index carried into the port: slots, capacities, postings,
ids, DCO counters, remaps, external ids and compacted layouts bitwise,
distances at rtol=atol=1e-5; each reference assertion holds for the
port too.  Also here: ``DeltaSegment`` on random batches, a
``PendingCompaction`` with a mutation tail, the deprecated layout-only
``delete_ids``, and k-means's fixed-order segment sum against
``jax.ops.segment_sum``.  (Search paths in
``tests/test_torch_stream_search.py``, bundles in
``tests/test_torch_stream_io.py``.)
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexConfig as JConfig
from repro.core import SearchParams as JParams
from repro.core import StreamConfig as JStreamConfig
from repro.core import StreamingIndex as JStream
from repro.core import build_index as j_build
from repro.core import ground_truth as j_gt
from repro.core import insert_batch as j_insert_batch
from repro.core import recall_at_k
from repro.core.stream.delta import DeltaSegment as JDelta
from repro_torch.convert import index_from_numpy
from repro_torch.core import (SearchParams, StaleSessionError, StreamConfig,
                              StreamingIndex, build_index,
                              build_seil_call_count, insert_batch)
from repro_torch.core.kmeans import segment_sum
from repro_torch.core.seil import build_id_map, build_seil, delete_ids
from repro_torch.core.stream.delta import DeltaSegment

SEIL = ("block_codes", "block_ids", "block_other", "owned", "refs",
        "refs_other", "misc")
INTS = ("ids", "approx_dco", "refine_dco", "scanned_blocks",
        "dropped_blocks")
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = dict(device="cpu")


def carry(j):
    """A reference ``RairsIndex`` as the port's, on the CPU."""
    arrays = {f: np.asarray(getattr(j.arrays, f)) for f in SEIL}
    arrays.update(centroids=np.asarray(j.centroids),
                  codebooks=np.asarray(j.codebook.codebooks),
                  vectors=np.asarray(j.vectors), assigns=j.assigns,
                  codes=j.codes)
    return index_from_numpy(dataclasses.asdict(j.config), arrays, **CPU)


def assert_same(got, want, msg=""):
    """A port result against a reference one."""
    for f in INTS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=msg + f)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               err_msg=msg + "dists", **TOL)


def assert_identical(a, b):
    """Two port results bitwise."""
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def assert_same_delta(t, j):
    for name in ("count", "capacity", "post_width"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("vectors", "codes", "assigns", "live", "post", "post_n"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)


def search_both(ts, js, q, **kw):
    return (ts.search(np.asarray(q), **kw, **CPU), js.search(q, **kw))


@pytest.fixture()
def pair(unit_data, shared_trained):
    """The reference's ``small_index`` (the first 5000 unit vectors) and
    the same index in the port."""
    x, _, _ = unit_data
    cents, cb = shared_trained
    cfg = JConfig(nlist=64, strategy="rair", seil=True)
    j = j_build(jax.random.PRNGKey(0), x[:5000], cfg, centroids=cents,
                codebook=cb)
    return carry(j), j


# ---------------------------------------------------------------------------
# the delta segment and the build's segment sum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_delta_segment_matches_reference(seed):
    """Slots, grew flags, capacities, postings (per-list width, the
    latest update) and tombstones, batch after batch."""
    rng = np.random.default_rng(seed)
    nlist, m = 12, int(rng.integers(2, 4))
    t, j = (cls(dim=6, m_pq=4, m_assign=m, pad=8, nlist=nlist)
            for cls in (DeltaSegment, JDelta))
    for _ in range(12):
        b = int(rng.integers(1, 40))
        vec = rng.standard_normal((b, 6)).astype(np.float32)
        codes = rng.integers(0, 16, (b, 4)).astype(np.uint8)
        # hot lists and repeated lists within a row
        assigns = rng.integers(0, 3 if seed == 1 else nlist,
                               (b, m)).astype(np.int32)
        ts, tg = t.append(vec, codes, assigns)
        js, jg = j.append(vec, codes, assigns)
        np.testing.assert_array_equal(ts, js)
        assert tg == jg
        assert_same_delta(t, j)
        for x, y in zip(t.last_post_update, j.last_post_update):
            np.testing.assert_array_equal(x, y)
        dead = rng.choice(t.count, size=min(3, t.count), replace=False)
        assert t.mark_dead(dead) == j.mark_dead(dead)
        assert (t.n_live, t.n_dead) == (j.n_live, j.n_dead)
    with pytest.raises(ValueError, match="out of range"):
        t.mark_dead([t.count])
    with pytest.raises(ValueError, match="pad"):
        DeltaSegment(dim=6, m_pq=4, m_assign=2, pad=0)


@pytest.mark.parametrize("n,d,k", [(5000, 32, 64), (20000, 2, 16),
                                   (3000, 128, 300)])
def test_segment_sum_is_the_reference_segment_sum(n, d, k):
    """k-means's update sums each list's rows in a fixed order: on the
    CPU bitwise ``jax.ops.segment_sum`` (empty lists too)."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, d)) * 10).astype(np.float32)
    seg = rng.integers(0, k, n).astype(np.int32)
    seg[seg == 3] = 4                        # an empty segment
    sums, counts = segment_sum(torch.from_numpy(x), torch.from_numpy(seg), k)
    want = jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(seg),
                               num_segments=k)
    np.testing.assert_array_equal(sums.numpy(), np.asarray(want))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(seg, minlength=k))
    assert counts.dtype == torch.float32 and float(sums[3].abs().max()) == 0


def test_delete_ids_is_deprecated_layout_only(rairs_index):
    """The layout-only helper (``test_seil.py::test_delete_ids``): warns
    with the reference's text and clears exactly the victims' entries."""
    from repro.core.seil import build_id_map as j_map
    tidx = carry(rairs_index)
    id_map = build_id_map(tidx.arrays)
    assert id_map == j_map(rairs_index.arrays)
    victims = [0, 1, 2, 3, 4]
    with pytest.warns(DeprecationWarning, match="StreamingIndex.delete"):
        arrays2 = delete_ids(tidx.arrays, id_map, victims)
    ids2 = arrays2.block_ids.numpy()
    for v in victims:
        assert not (ids2 == v).any()
    ids1 = tidx.arrays.block_ids.numpy()
    np.testing.assert_array_equal(np.bincount(ids1[ids1 >= 5]),
                                  np.bincount(ids2[ids2 >= 5]))


# ---------------------------------------------------------------------------
# unmutated identity + insert path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("exec_mode", ["paged", "grouped"])
def test_unmutated_stream_is_bitwise_identical(pair, unit_data, exec_mode):
    _, q, _ = unit_data
    tb, jb = pair
    stream = StreamingIndex(tb)
    ra = tb.search(np.asarray(q[:40]), k=10, nprobe=8, exec_mode=exec_mode,
                   **CPU)
    rb = stream.search(np.asarray(q[:40]), k=10, nprobe=8,
                       exec_mode=exec_mode, **CPU)
    assert_identical(ra, rb)
    assert_same(rb, JStream(jb).search(q[:40], k=10, nprobe=8,
                                       exec_mode=exec_mode))


def test_insert_goes_through_delta_not_layout_rebuild(pair, unit_data):
    x, _, _ = unit_data
    tb, jb = pair
    stream, js = StreamingIndex(tb), JStream(jb)
    before = build_seil_call_count()
    ids = stream.insert(np.asarray(x[5000:5400]))
    assert build_seil_call_count() == before
    assert stream.base is tb
    np.testing.assert_array_equal(ids, js.insert(x[5000:5400]))
    np.testing.assert_array_equal(ids, np.arange(5000, 5400))
    assert stream.n_delta == 400 and stream.n_live == 5400
    assert_same_delta(stream._delta, js._delta)
    r, rj = search_both(stream, js, x[5007][None, :], k=1, nprobe=16)
    assert int(r.ids[0, 0]) == 5007
    assert_same(r, rj)


def test_steady_state_churn_does_not_recompile(pair, unit_data):
    x, q, _ = unit_data
    tb, jb = pair
    stream = StreamingIndex(tb, StreamConfig(delta_pad=512))
    js = JStream(jb, JStreamConfig(delta_pad=512))
    for step in range(4):
        for st in (stream, js):
            st.insert(np.asarray(x[5000 + step * 64:5000 + (step + 1) * 64]))
            st.delete([int(st.live_ids()[step])])
        assert_same(stream.searcher(SearchParams(k=10, nprobe=8),
                                    **CPU)(np.asarray(q[:16])),
                    js.searcher(JParams(k=10, nprobe=8))(q[:16]))
    stats = stream.searcher_stats()
    assert stats["compiles"] == 1 and stats["invalidations"] == 3, stats
    want = js.searcher_stats()
    # the port's stats add the replay device time (no graph on the CPU)
    assert {k: v for k, v in stats.items() if k in want and k != "base"} == {
        k: v for k, v in want.items() if k != "base"}
    assert set(stats) - set(want) == {"timed_calls", "timed_device_s"}
    assert stats["timed_calls"] == 0 and stats["timed_device_s"] == 0.0


def test_delta_capacity_buckets_are_geometric(pair, unit_data):
    x, _, _ = unit_data
    stream = StreamingIndex(pair[0], StreamConfig(delta_pad=64))
    xs = np.asarray(x)
    for hi, cap in ((5010, 64), (5100, 128), (5400, 512)):
        stream.insert(xs[stream.n_total:hi])
        assert stream._delta.capacity == cap


def test_plane_delta_codes_patched_by_batch(pair, unit_data, monkeypatch):
    """A two-tier stream's delta plane codes: one buffer per capacity,
    each insert encoding only its batch into it in place, a delete
    encoding nothing; results still the reference's."""
    import repro_torch.quant as quant
    from repro.core import RefineParams as JRefine
    from repro_torch.core import RefineParams
    from repro_torch.core.pq import PQCodebook
    x, q, _ = unit_data
    tb, jb = pair
    stream = StreamingIndex(tb, StreamConfig(delta_pad=512))
    js = JStream(jb, JStreamConfig(delta_pad=512))
    codec = js.plane("pq4").codec
    stream.plane("pq4", codec=PQCodebook(torch.from_numpy(
        np.array(codec.codebooks))))
    p = SearchParams(k=10, nprobe=8, refine=RefineParams("pq4", 4))
    jp = JParams(k=10, nprobe=8, refine=JRefine("pq4", 4))
    rows = []
    encode = quant.encode_plane
    monkeypatch.setattr(quant, "encode_plane", lambda c, v: (
        rows.append(v.shape[0]), encode(c, v))[1])
    for st in (stream, js):
        st.insert(np.asarray(x[5000:5100]))
    assert_same(stream.searcher(p, **CPU)(np.asarray(q[:16])),
                js.searcher(jp)(q[:16]))
    buf = stream._plane_delta_codes("pq4")
    assert rows == [512]                  # the buffer, encoded whole once
    for lo, hi in ((5100, 5164), (5164, 5300)):
        for st in (stream, js):
            st.insert(np.asarray(x[lo:hi]))
            st.delete([lo - 3, 17])
        assert_same(stream.searcher(p, **CPU)(np.asarray(q[:16])),
                    js.searcher(jp)(q[:16]))
        assert stream._plane_delta_codes("pq4") is buf
    assert rows == [512, 64, 136]          # then only each insert's batch
    np.testing.assert_array_equal(
        buf.numpy(), encode(stream.plane("pq4").codec,
                            stream._delta.vectors))
    for st in (stream, js):                # a capacity jump: a new buffer
        st.insert(np.asarray(x[5300:5600]))
    assert_same(stream.searcher(p, **CPU)(np.asarray(q[:16])),
                js.searcher(jp)(q[:16]))
    assert stream._delta.capacity == 1024 and rows[-1] == 1024


# ---------------------------------------------------------------------------
# delete consistency
# ---------------------------------------------------------------------------
def test_delete_keeps_all_views_coherent(pair, unit_data):
    x, _, _ = unit_data
    tb, jb = pair
    stream, js = StreamingIndex(tb), JStream(jb)
    probe = np.asarray(x[42][None, :])
    assert int(stream.search(probe, k=1, nprobe=16, **CPU).ids[0, 0]) == 42
    stale = stream.searcher(SearchParams(k=1, nprobe=16), **CPU)
    assert stream.delete([42, 42, 43]) == 2 == js.delete([42, 42, 43])
    with pytest.raises(StaleSessionError, match="version"):
        stale(probe)
    r, rj = search_both(stream, js, probe, k=10, nprobe=16)
    assert 42 not in r.ids and 43 not in r.ids
    assert_same(r, rj)
    assert stream.n_live == 4998
    assert stream.vectors.shape[0] == 5000
    assert stream.assigns.shape[0] == 5000
    assert not stream.live_mask()[42]
    assert stream.delete([42]) == 0
    with pytest.raises(ValueError, match="out of range"):
        stream.delete([stream.n_total])


def test_delete_of_delta_items(pair, unit_data):
    x, _, _ = unit_data
    tb, jb = pair
    stream, js = StreamingIndex(tb), JStream(jb)
    ids = stream.insert(np.asarray(x[5000:5100]))
    js.insert(x[5000:5100])
    victim = int(ids[7])
    assert stream.delete([victim]) == 1 == js.delete([victim])
    r, rj = search_both(stream, js, x[5007][None, :], k=5, nprobe=16)
    assert victim not in r.ids
    assert_same(r, rj)
    assert stream.n_delta == 99


# ---------------------------------------------------------------------------
# session versioning / epochs
# ---------------------------------------------------------------------------
def test_mutations_invalidate_sessions_and_epochs_bump(pair, unit_data):
    x, q, _ = unit_data
    qs = np.asarray(q[:8])
    stream = StreamingIndex(pair[0])
    params = SearchParams(k=10, nprobe=8)
    s0 = stream.searcher(params, **CPU)
    assert s0.epoch == 0 and stream.version == 0
    s0(qs)
    stream.insert(np.asarray(x[5000:5064]))
    with pytest.raises(StaleSessionError):
        s0(qs)
    s1 = stream.searcher(params, **CPU)
    assert s1 is not s0 and s1.version == stream.version
    s1(qs)
    info = stream.compact()
    assert info["epoch"] == stream.epoch == 1
    with pytest.raises(StaleSessionError):
        s1(qs)
    s2 = stream.searcher(params, **CPU)
    assert s2.epoch == 1
    assert tuple(s2(qs).ids.shape) == (8, 10)
    assert stream.stats.invalidations >= 1
    assert stream.searcher_stats()["epoch"] == 1


def test_searcher_cache_returns_same_session_while_current(pair):
    stream = StreamingIndex(pair[0])
    a = stream.searcher(k=10, nprobe=8, **CPU)
    b = stream.searcher(SearchParams(k=10, nprobe=8), **CPU)
    assert a is b


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------
def test_compact_matches_from_scratch_rebuild(pair, unit_data,
                                              shared_trained):
    """compact() equals the reference's compaction and a from-scratch
    build over the survivors (layout, stats, searches), bitwise."""
    x, q, _ = unit_data
    cents, cb = shared_trained
    tb, jb = pair
    stream, js = StreamingIndex(tb), JStream(jb)
    victims = np.array([1, 42, 4999, 5003, 5499])
    for st in (stream, js):
        st.insert(np.asarray(x[5000:5500]))
        st.delete(victims)
    before = build_seil_call_count()
    info, jinfo = stream.compact(), js.compact()
    assert build_seil_call_count() == before + 1
    assert info["n_live"] == 5495 and info["dropped"] == 5
    np.testing.assert_array_equal(info["id_remap"], jinfo["id_remap"])
    keep = np.ones(5500, bool)
    keep[victims] = False
    surv = np.asarray(x[:5500])[keep]
    ref = j_build(jax.random.PRNGKey(0), jnp.asarray(surv), jb.config,
                  centroids=cents, codebook=cb)
    for f in SEIL:
        np.testing.assert_array_equal(getattr(stream.base.arrays, f).numpy(),
                                      np.asarray(getattr(ref.arrays, f)),
                                      err_msg=f)
    assert dataclasses.asdict(stream.base.stats) == dataclasses.asdict(
        ref.stats)
    np.testing.assert_array_equal(stream.base.vectors.numpy(), surv)
    np.testing.assert_array_equal(stream.base.codes, ref.codes)
    np.testing.assert_array_equal(stream.base.assigns, ref.assigns)
    # the port's own scratch build over the survivors, frozen training
    scratch = build_index(surv, tb.config, centroids=tb.centroids,
                          codebook=tb.codebook, **CPU)
    for mode in ("paged", "grouped"):
        r = stream.search(np.asarray(q[:48]), k=10, nprobe=8,
                          exec_mode=mode, **CPU)
        assert_identical(r, scratch.search(np.asarray(q[:48]), k=10,
                                           nprobe=8, exec_mode=mode, **CPU))
        assert_same(r, ref.search(q[:48], k=10, nprobe=8, exec_mode=mode))
    remap = info["id_remap"]
    assert remap.shape == (5500,)
    assert (remap[victims] == -1).all()
    np.testing.assert_array_equal(remap[keep], np.arange(5495))


def test_auto_compaction_thresholds(pair, unit_data):
    x, _, _ = unit_data
    stream = StreamingIndex(pair[0], StreamConfig(delta_pad=64,
                                                  compact_delta_frac=0.05))
    stream.insert(np.asarray(x[5000:5200]))
    assert stream.epoch == 0
    stream.insert(np.asarray(x[5200:5300]))
    assert stream.epoch == 1 and stream.stats.auto_compactions == 1
    assert stream.n_delta == 0 and stream.n_live == 5300


def test_auto_compaction_returns_renumbered_ids(pair, unit_data):
    x, _, _ = unit_data
    tb, jb = pair
    cfg = dict(delta_pad=64, compact_delta_frac=0.05)
    stream = StreamingIndex(tb, StreamConfig(**cfg))
    js = JStream(jb, JStreamConfig(**cfg))
    for st in (stream, js):
        st.delete(np.arange(10))
    ids = stream.insert(np.asarray(x[5000:5300]))
    np.testing.assert_array_equal(ids, js.insert(x[5000:5300]))
    assert stream.epoch == 1
    np.testing.assert_array_equal(ids, np.arange(4990, 5290))
    r, rj = search_both(stream, js, x[5007][None, :], k=1, nprobe=16)
    assert int(r.ids[0, 0]) == int(ids[7])
    assert_same(r, rj)


def test_noop_delete_does_not_invalidate_sessions(pair, unit_data):
    _, q, _ = unit_data
    qs = np.asarray(q[:8])
    stream = StreamingIndex(pair[0])
    stream.delete([42])
    sess = stream.searcher(SearchParams(k=10, nprobe=8), **CPU)
    sess(qs)
    v = stream.version
    assert stream.delete([42]) == 0
    assert stream.version == v
    sess(qs)
    assert stream.searcher(SearchParams(k=10, nprobe=8), **CPU) is sess


def test_pending_compaction_replays_its_mutation_tail(pair, unit_data):
    """begin_compact -> mutations while fold() runs on a thread ->
    install(): the same remap, replay counts, layout and answers as the
    reference's, and external ids resolve across the two epochs."""
    x, q, _ = unit_data
    xs = np.asarray(x)
    tb, jb = pair
    stream, js = StreamingIndex(tb), JStream(jb)
    for st in (stream, js):
        st.insert(xs[5000:5300])
        st.delete([3, 5010, 5020])
    handles = stream.external_ids(np.array([7, 5100, 5299, 3]))
    np.testing.assert_array_equal(handles, [7, 5100, 5299, 3])
    pend, jpend = stream.begin_compact(), js.begin_compact()
    with pytest.raises(RuntimeError, match="already pending"):
        stream.begin_compact()
    worker = threading.Thread(target=pend.fold)
    worker.start()
    tail = {}
    for st in (stream, js):            # the mutation tail, while folding
        tail[id(st)] = st.insert(xs[5300:5350])
        st.delete([7, 5005, 5301])
    worker.join()
    jpend.fold()
    info, jinfo = pend.install(), jpend.install()
    for key in ("epoch", "n_live", "dropped", "replayed_inserts",
                "replayed_deletes"):
        assert info[key] == jinfo[key], key
    assert info["replayed_inserts"] == 49 and info["replayed_deletes"] == 2
    np.testing.assert_array_equal(info["id_remap"], jinfo["id_remap"])
    np.testing.assert_array_equal(stream.last_remap, js.last_remap)
    for f in SEIL:
        np.testing.assert_array_equal(getattr(stream.base.arrays, f).numpy(),
                                      np.asarray(getattr(js.base.arrays, f)),
                                      err_msg=f)
    assert_same_delta(stream._delta, js._delta)
    np.testing.assert_array_equal(stream.live_mask(), js.live_mask())
    # handles issued before the fold and during it resolve in the new epoch
    ext = np.concatenate([handles, stream.external_ids(tail[id(stream)])])
    got = stream.resolve_ids(ext)
    np.testing.assert_array_equal(got, js.resolve_ids(ext))
    assert got[0] == -1 and got[3] == -1          # 7 and 3 were deleted
    assert (got[1:3] >= 0).all()
    np.testing.assert_array_equal(stream.external_ids(got[got >= 0]),
                                  ext[got >= 0])
    r, rj = search_both(stream, js, q[:32], k=10, nprobe=8)
    assert_same(r, rj)
    assert stream._pending_compact is None and stream.epoch == 1


# ---------------------------------------------------------------------------
# insert_batch, validation
# ---------------------------------------------------------------------------
def test_insert_batch_is_a_streaming_wrapper(pair, unit_data):
    x, q, _ = unit_data
    tb, jb = pair
    before = build_seil_call_count()
    grown = insert_batch(tb, np.asarray(x[5000:5300]))
    assert isinstance(grown, StreamingIndex)
    assert build_seil_call_count() == before
    assert grown.vectors.shape[0] == 5300
    grown2 = insert_batch(grown, np.asarray(x[5300:5400]))
    assert grown2 is grown and grown.vectors.shape[0] == 5400
    jgrown = j_insert_batch(j_insert_batch(jb, x[5000:5300]), x[5300:5400])
    np.testing.assert_array_equal(grown.assigns, jgrown.assigns)
    # the legacy behaviour: a pooled re-add rebuilding the whole layout
    cfg = tb.config
    arrays, stats = build_seil(
        grown.assigns, np.concatenate([tb.codes, grown._delta.codes[:400]]),
        np.arange(5400, dtype=np.int32), cfg.nlist, block=cfg.block,
        shared=cfg.seil and cfg.multi_m == 2, code_bits=cfg.nbits, **CPU)
    legacy = dataclasses.replace(tb, arrays=arrays, stats=stats,
                                 assigns=grown.assigns, codes=None,
                                 vectors=grown.vectors.clone())
    grown.compact()
    jgrown.compact()
    r = grown.search(np.asarray(q[:32]), k=10, nprobe=8, **CPU)
    assert_identical(r, legacy.search(np.asarray(q[:32]), k=10, nprobe=8,
                                      **CPU))
    assert_same(r, jgrown.search(q[:32], k=10, nprobe=8))


def test_stream_config_and_inputs_validate(pair):
    with pytest.raises(ValueError, match="delta_pad"):
        StreamConfig(delta_pad=0)
    with pytest.raises(ValueError, match="compact_delta_frac"):
        StreamConfig(compact_delta_frac=0.0)
    stream = StreamingIndex(pair[0])
    with pytest.raises(TypeError, match="StreamingIndex"):
        StreamingIndex(stream)
    with pytest.raises(ValueError, match="insert batch"):
        stream.insert(np.zeros((4, 3), np.float32))
    assert stream.insert(np.zeros((0, 32), np.float32)).size == 0
    assert stream.delete([]) == 0
    assert stream.version == 0
    with pytest.raises(TypeError, match="mesh must be a repro_torch Mesh"):
        stream.shard(None)


# ---------------------------------------------------------------------------
# churn (the reference's property test, on fixed seeds)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,n_ops,mid_compact",
                         [(0, 4, True), (1, 6, False), (7, 5, True)])
def test_churn_recall_matches_scratch_rebuild(seed, n_ops, mid_compact):
    """Interleaved insert / delete (/ compact) on both packages: the same
    ids at every step, streaming recall against a brute-force oracle
    within 0.05 of a from-scratch rebuild's, and after a final compact
    exactly the rebuild's answers."""
    from repro.data import make_dataset
    x, q, _ = make_dataset("unit")
    x = np.asarray(x)
    q = np.asarray(q[:64])
    rng = np.random.default_rng(seed)
    cfg = JConfig(nlist=32, strategy="rair", seil=True, kmeans_iters=4,
                  pq_iters=4)
    n0 = 2000
    jbase = j_build(jax.random.PRNGKey(0), jnp.asarray(x[:n0]), cfg)
    stream = StreamingIndex(carry(jbase), StreamConfig(delta_pad=64))
    js = JStream(jbase, JStreamConfig(delta_pad=64))
    pool = n0
    rows = {i: i for i in range(n0)}
    for _ in range(n_ops):
        op = rng.integers(0, 3 if mid_compact else 2)
        if op == 0 and pool + 200 <= x.shape[0]:
            ids = stream.insert(x[pool:pool + 200])
            np.testing.assert_array_equal(ids, js.insert(x[pool:pool + 200]))
            for j, i in enumerate(ids):
                rows[int(i)] = pool + j
            pool += 200
        elif op == 1 and len(rows) > 300:
            victims = rng.choice(stream.live_ids(), size=100, replace=False)
            assert stream.delete(victims) == js.delete(victims)
            for v in victims:
                rows.pop(int(v), None)
        elif op == 2:
            remap = stream.compact()["id_remap"]
            np.testing.assert_array_equal(remap, js.compact()["id_remap"])
            rows = {int(remap[i]): r for i, r in rows.items()}
        r, rj = search_both(stream, js, q, k=10, nprobe=8)
        assert_same(r, rj)
    surv_rows = np.array([rows[i] for i in sorted(rows)])
    corpus = x[surv_rows]
    gt = np.asarray(j_gt(jnp.asarray(corpus), jnp.asarray(q), 10))
    rebuilt = build_index(corpus, stream.config,
                          centroids=stream.centroids,
                          codebook=stream.codebook, **CPU)
    rec_rebuild = recall_at_k(
        rebuilt.search(q, k=10, nprobe=8, **CPU).ids.numpy(), gt)
    pos_of = {int(i): p for p, i in enumerate(stream.live_ids())}
    ids = stream.search(q, k=10, nprobe=8, **CPU).ids.numpy()
    as_pos = np.array([[pos_of.get(int(i), -1) for i in row]
                       for row in ids])
    assert recall_at_k(as_pos, gt) >= rec_rebuild - 0.05
    stream.compact()
    assert_identical(stream.search(q, k=10, nprobe=8, **CPU),
                     rebuilt.search(q, k=10, nprobe=8, **CPU))
