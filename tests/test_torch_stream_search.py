"""Streaming search paths in the port against the reference, on the CPU
(2 of 3).

The delta scan (``delta_adc``, ``routed_delta_candidates``) on seeded
inputs, ``seil_search`` with a stream's delta and tombstones (the
reference's ``streaming_search``) in the three exec modes fused off and
on, exhaustive and routed; then the
streaming tests of ``test_plan.py`` (clustered on a mutated stream, plan
reuse across mutations and a capacity jump, the routed delta, the
routing threshold and the cost guard), ``test_fused.py`` (fused against
unfused on a mutated stream), ``test_obs.py`` (the ``stage.delta_scan``
span) and ``test_refine.py`` (two-tier sessions on a stream).  Ids and
DCO counters bitwise, distances at rtol=atol=1e-5 (``jnp.sum`` does not
promise the port's ascending m).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexConfig as JConfig
from repro.core import RefineParams as JRefine
from repro.core import SearchParams as JParams
from repro.core import StreamingIndex as JStream
from repro.core import build_index as j_build
from repro.core.stream import search as jsearch
from repro_torch import obs
from repro_torch.convert import index_from_numpy
from repro_torch.core import (DeltaInputs, RefineParams, SearchParams,
                              StaleSessionError, StreamingIndex, seil_search)
from repro_torch.core.engine import select_lists
from repro_torch.core.pq import PQCodebook
from repro_torch.core.stream import search as tsearch
from repro_torch.kernels import ref

SEIL = ("block_codes", "block_ids", "block_other", "owned", "refs",
        "refs_other", "misc")
INTS = ("ids", "approx_dco", "refine_dco", "scanned_blocks",
        "dropped_blocks")
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = dict(device="cpu")
MODES = ("paged", "grouped", "clustered")


def t(a):
    return torch.from_numpy(np.array(a))


def carry(j):
    arrays = {f: np.asarray(getattr(j.arrays, f)) for f in SEIL}
    arrays.update(centroids=np.asarray(j.centroids),
                  codebooks=np.asarray(j.codebook.codebooks),
                  vectors=np.asarray(j.vectors), assigns=j.assigns,
                  codes=j.codes)
    return index_from_numpy(dataclasses.asdict(j.config), arrays, **CPU)


def assert_same(got, want, msg=""):
    for f in INTS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=msg + f)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               err_msg=msg + "dists", **TOL)


def assert_identical(a, b, msg=""):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), msg + f


def both(cfg, x, cents, cb, n=5000):
    j = j_build(jax.random.PRNGKey(0), x[:n], cfg, centroids=cents,
                codebook=cb)
    return StreamingIndex(carry(j)), JStream(j)


def churn(streams, x, lo=5000, hi=5500, n_del=40, n_base_del=20):
    for st in streams:
        ids = st.insert(np.asarray(x[lo:hi]))
        st.delete(ids[:n_del])
        st.delete(np.arange(n_base_del))


@pytest.fixture()
def small_streams(unit_data, shared_trained):
    """The reference's ``small_stream`` in both packages."""
    x, _, _ = unit_data
    cfg = JConfig(nlist=64, strategy="rair", seil=True, kmeans_iters=8,
                  pq_iters=6)
    ts, js = both(cfg, x, *shared_trained)
    churn((ts, js), x)
    return ts, js, x


# ---------------------------------------------------------------------------
# the delta scan on seeded inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [16, 256])
def test_delta_adc_matches_reference(k):
    rng = np.random.default_rng(k)
    lut = rng.random((5, 8, k), np.float32) * 4
    codes = rng.integers(0, k, (37, 8)).astype(np.uint8)
    got = tsearch.delta_adc(t(lut), t(codes)).numpy()
    want = np.asarray(jsearch.delta_adc(jnp.asarray(lut), jnp.asarray(codes)))
    np.testing.assert_allclose(got, want, **TOL)
    # the port sums over ascending m, shared codes and each query's own
    acc = np.zeros((5, 37), np.float32)
    for m in range(8):
        acc += lut[:, m, :][:, codes[:, m]]
    np.testing.assert_array_equal(got, acc)
    rows = rng.integers(0, k, (5, 11, 8)).astype(np.uint8)
    acc = np.zeros((5, 11), np.float32)
    for m in range(8):
        acc += np.take_along_axis(lut[:, m, :], rows[:, :, m].astype(int), 1)
    np.testing.assert_array_equal(ref._adc_rows(t(lut), t(rows)).numpy(),
                                  acc)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_routed_delta_candidates_match_reference(seed, signed):
    """Signed tables are the inner-product case (``pq_lut_ip`` gives
    -<q, c>): the closest slots have negative distances and must survive
    the top-``fetch`` cut ahead of dead slots (+inf)."""
    rng = np.random.default_rng(seed)
    nlist, p, width, cap, b = 10, 4, 8, 40, 6
    lut = rng.random((b, 8, 16), np.float32)
    if signed:
        lut = lut - np.float32(0.75)
    codes = rng.integers(0, 16, (cap, 8)).astype(np.uint8)
    ids = np.where(rng.random(cap) < 0.8, 1000 + np.arange(cap), -1
                   ).astype(np.int32)
    assigns = rng.integers(0, nlist, (cap, 2)).astype(np.int32)
    post = np.full((nlist, width), -1, np.int32)
    for s in range(cap):
        for lst in set(assigns[s].tolist()):
            col = int((post[lst] >= 0).sum())
            if col < width:
                post[lst, col] = s
    sel = np.stack([rng.permutation(nlist)[:p] for _ in range(b)]
                   ).astype(np.int32)
    rank_of = np.full((b, nlist), 2 ** 30, np.int32)
    for r in range(b):
        rank_of[r, sel[r]] = np.arange(p)
    args = (lut, codes, ids, post, assigns, sel, rank_of)
    got = ref.routed_delta_candidates(*(t(a) for a in args))
    want = jsearch.routed_delta_candidates(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the streaming path keeps the stable top-fetch of the same stream
    for fetch in (3, 20, 64):
        dd, di, dco, _ = tsearch._delta_candidates(
            *(t(a) for a in args[:5]), t(sel), t(rank_of), True, fetch)
        order = np.argsort(got[0].numpy(), axis=1, kind="stable")[:, :fetch]
        np.testing.assert_array_equal(
            di.numpy(), np.take_along_axis(got[1].numpy(), order, 1))
        np.testing.assert_array_equal(dco.numpy(), got[2].numpy())
        # and the exhaustive path cuts the reference's delta_adc stream
        dd, di, dco, _ = tsearch._delta_candidates(
            *(t(a) for a in args[:5]), t(sel), t(rank_of), False, fetch)
        full = np.asarray(jsearch.delta_adc(jnp.asarray(lut),
                                            jnp.asarray(codes)))
        full = np.where(ids[None, :] >= 0, full, np.inf)
        order = np.argsort(full, axis=1, kind="stable")[:, :fetch]
        np.testing.assert_array_equal(
            di.numpy(), np.broadcast_to(ids, full.shape)[
                np.arange(b)[:, None], order])
        np.testing.assert_allclose(
            dd.numpy(), np.take_along_axis(full, order, 1), **TOL)
        assert (dco.numpy() == (ids >= 0).sum()).all()


def _routed_inputs(case, seed=0):
    """Seeded routed-delta inputs (numpy) for one case of
    ``test_delta_scan_topk_plain``: (lut, codes, ids, post, assigns, sel,
    rank_of), every posting row a prefix of slots, and the fetch."""
    rng = np.random.default_rng(seed)
    nlist, p, width, cap, b = 10, 4, 8, 40, 6
    fetch, dead, lists = 20, 0.2, nlist
    if case == "fetch_above_kept":
        width, fetch = 16, 200              # n = P * L = 64 > kept
    if case == "dead":
        dead = 0.6
    if case == "two_lists":
        lists = p + 1                       # most slots under two probed lists
    if case == "ties":
        lut = rng.integers(0, 3, (b, 8, 16)).astype(np.float32)
    else:
        lut = rng.random((b, 8, 16), np.float32)
    if case == "signed":
        lut = lut - np.float32(0.75)
    codes = rng.integers(0, 16, (cap, 8)).astype(np.uint8)
    ids = np.where(rng.random(cap) < 1 - dead, 1000 + np.arange(cap), -1
                   ).astype(np.int32)
    assigns = rng.integers(0, lists, (cap, 2)).astype(np.int32)
    if case == "pad_row":
        assigns[assigns == 0] = 1           # list 0 has no postings
    post = np.full((nlist, width), -1, np.int32)
    for s in range(cap):
        for lst in dict.fromkeys(assigns[s].tolist()):
            col = int((post[lst] >= 0).sum())
            if col < width:
                post[lst, col] = s
    if case == "two_lists":
        sel = np.stack([rng.permutation(p) for _ in range(b)])
    elif case == "pad_row":                 # list 0 probed second by all
        sel = np.stack([np.insert(rng.permutation(np.arange(1, nlist))[
            :p - 1], 1, 0) for _ in range(b)])
    else:
        sel = np.stack([rng.permutation(nlist)[:p] for _ in range(b)])
    sel = sel.astype(np.int32)
    rank_of = np.full((b, nlist), 2 ** 30, np.int32)
    for r in range(b):
        rank_of[r, sel[r]] = np.arange(p)
    return (lut, codes, ids, post, assigns, sel, rank_of), fetch


@pytest.mark.parametrize("case", ["ties", "signed", "pad_row", "two_lists",
                                  "dead", "fetch_above_kept"])
def test_delta_scan_topk_plain(case):
    """On the CPU the routed delta scan's wrapper (``ops.delta_scan_topk``,
    the kernel's entry on the card) is its plain version: bitwise
    ``_routed_chunks(..., fetch)``, the walk each probed row's prefix of
    slots, and the reference's ``routed_delta_candidates`` stream cut
    stably (ids and DCO exact, distances at TOL).  Integer tables make
    ties common, so the (distance, position) order is held."""
    from repro_torch.kernels import ops
    args, fetch = _routed_inputs(case)
    post, sel = args[3], args[5]
    targs = [t(a) for a in args]
    dd, di, dco, walked = ops.delta_scan_topk(*targs, fetch=fetch)
    plain = ref._routed_chunks(*targs, fetch)
    for got, want in zip((dd, di, dco), plain):
        assert torch.equal(got, want)
    rows = post[sel]                                     # (B, P, L)
    np.testing.assert_array_equal(walked.numpy(), (rows >= 0).sum((1, 2)))
    if case == "pad_row":
        assert (rows[:, 1] < 0).all() and (walked.numpy() > 0).all()
    if case == "two_lists":
        probed = np.isin(args[4], sel[0]).all(1) & (args[4][:, 0]
                                                    != args[4][:, 1])
        assert probed.sum() > 10            # scored once each, not twice
    n = min(fetch, rows.shape[1] * rows.shape[2])
    assert dd.shape == (sel.shape[0], n)
    if case == "fetch_above_kept":
        assert (dco.numpy() < n).all()
        assert bool((di[:, -1] == -1).all()) and bool(torch.isinf(
            dd[:, -1]).all())
    jd, ji, jdco = jsearch.routed_delta_candidates(
        *(jnp.asarray(a) for a in args))
    jd, ji = np.asarray(jd), np.asarray(ji)
    order = np.argsort(jd, axis=1, kind="stable")[:, :n]
    np.testing.assert_array_equal(di.numpy(), np.take_along_axis(ji, order, 1))
    np.testing.assert_array_equal(dco.numpy(), np.asarray(jdco))
    np.testing.assert_allclose(dd.numpy(), np.take_along_axis(jd, order, 1),
                               **TOL)


def test_stable_top_orders_either_sign():
    """The int64 selection key is monotone over the whole f32 range:
    negatives ahead of zeros ahead of positives ahead of +inf, ties (and
    -0.0 against +0.0) in position order."""
    d = torch.tensor([[1.0, -1.0, np.inf, -2.0, 0.0, -0.0, -np.inf, 1e-45,
                       -1e-45, 3.4e38, -3.4e38, -1.0]])
    ids = torch.arange(d.shape[1])[None]
    order = np.argsort((d + 0.0).numpy(), axis=1, kind="stable")
    for n in (1, 5, d.shape[1]):
        dd, di = ref._stable_top(d, ids, n)
        np.testing.assert_array_equal(di.numpy(), order[:, :n])
        assert torch.equal(dd, torch.gather(d, 1, di))


def _direct(idx, st, q, mode, fused, route, bigk=100):
    """One call of either package's streaming pipeline on the mirrors of
    stream ``st``, under the index's metric: the port's ``seil_search``
    with the delta and tombstones, the reference's ``streaming_search``."""
    metric = idx.config.metric
    if isinstance(st, StreamingIndex):
        dv = st._device_state()
        return seil_search(
            idx.arrays, idx.centroids, idx.codebook, dv.vectors_full, t(q),
            nprobe=8, bigk=bigk, k=10, max_scan=idx.default_max_scan(8),
            metric=metric, exec_mode=mode, query_tile=4, route_delta=route,
            fused_topk=fused, live=dv.live_full, delta=DeltaInputs(
                dv.delta_codes, dv.delta_ids, dv.delta_post,
                dv.delta_assigns))
    dv = st._device_state()
    return jsearch.streaming_search(
        idx.arrays, idx.centroids, idx.codebook, dv.vectors_full,
        dv.delta_codes, dv.delta_ids, dv.delta_post, dv.delta_assigns,
        dv.live_full, jnp.asarray(q), nprobe=8, bigk=bigk, k=10,
        max_scan=idx.default_max_scan(8), metric=metric, exec_mode=mode,
        query_tile=4, route_delta=route, fused_topk=fused)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("route", [False, True])
def test_streaming_search_matches_reference(small_streams, unit_data, mode,
                                            route):
    ts, js, _ = small_streams
    _, q, _ = unit_data
    q = np.asarray(q[:24])
    for fused in (False, True):
        got = _direct(ts.base, ts, q, mode, fused, route)
        assert_same(got, _direct(js.base, js, q, mode, fused, route),
                    f"{mode} fused={fused} routed={route} ")


@pytest.mark.parametrize("route", [False, True])
def test_streaming_search_ip_matches_reference(unit_data, route):
    """An inner-product stream: its closest delta items score below zero,
    and with bigk 20 (fetch 40) the delta stream is cut."""
    x, q, _ = unit_data
    cfg = JConfig(nlist=64, strategy="rair", seil=True, metric="ip",
                  kmeans_iters=8, pq_iters=6)
    ts, js = both(cfg, x, None, None, n=4000)
    churn((ts, js), x, lo=4000, hi=4500)
    q = np.asarray(q[:24])
    for mode in MODES:
        for fused in (False, True):
            got = _direct(ts.base, ts, q, mode, fused, route, bigk=20)
            assert_same(got, _direct(js.base, js, q, mode, fused, route,
                                     bigk=20),
                        f"{mode} fused={fused} routed={route} ")
    inserted = set(range(4000, 4500)) - set(range(4000, 4040))
    # the session path too: inserted items reach the results
    got = ts.search(np.asarray(x[4100:4124]), k=10, nprobe=8, **CPU)
    assert set(got.ids.numpy().ravel().tolist()) & inserted
    assert_same(got, js.search(x[4100:4124], k=10, nprobe=8))


# ---------------------------------------------------------------------------
# test_plan.py's streaming tests
# ---------------------------------------------------------------------------
def test_clustered_streaming_mutated(small_streams, unit_data):
    ts, js, _ = small_streams
    _, q, _ = unit_data
    qs = np.asarray(q[:32])
    rp = ts.search(qs, k=10, nprobe=8, exec_mode="paged", **CPU)
    rc = ts.search(qs, k=10, nprobe=8, exec_mode="clustered", **CPU)
    assert_identical(rp, rc)
    assert_same(rc, js.search(q[:32], k=10, nprobe=8, exec_mode="clustered"))


def test_plan_reuse_streaming_and_epoch_bump(small_streams, unit_data):
    ts, js, x = small_streams
    _, q, _ = unit_data
    qs = np.asarray(q[:32])
    kw = dict(k=10, nprobe=8, exec_mode="clustered", plan_reuse=True)
    params = SearchParams(**kw)

    def paged():
        return ts.search(qs, k=10, nprobe=8, exec_mode="paged", **CPU)
    s0 = ts.searcher(params, **CPU)
    r0 = s0(qs)
    assert_identical(paged(), r0)
    assert_same(r0, js.searcher(JParams(**kw))(q[:32]))
    assert s0.plan_stats.batches == 1
    for st in (ts, js):
        st.insert(np.asarray(x[5600:5650]))
    with pytest.raises(StaleSessionError):
        s0(qs)
    s1 = ts.searcher(params, **CPU)
    assert s1 is not s0 and s1.plan_stats.batches == 0
    r1 = s1(qs)
    assert_identical(paged(), r1, "post-insert ")
    assert_same(r1, js.searcher(JParams(**kw))(q[:32]))
    for st in (ts, js):
        st.compact()
    with pytest.raises(StaleSessionError):
        s1(qs)
    s2 = ts.searcher(params, **CPU)
    assert s2.epoch == ts.epoch and s2.plan_stats.batches == 0
    r2 = s2(qs)
    assert_identical(paged(), r2, "post-epoch ")
    assert_same(r2, js.searcher(JParams(**kw))(q[:32]))


def test_plan_reuse_probe_survives_capacity_jump(small_streams, unit_data):
    ts, js, x = small_streams
    _, q, _ = unit_data
    qs = np.asarray(q[:32])
    kw = dict(k=10, nprobe=8, exec_mode="clustered", plan_reuse=True)
    params = SearchParams(**kw)
    s0 = ts.searcher(params, **CPU)
    s0(qs)
    js.searcher(JParams(**kw))(q[:32])
    before = dict(ts._probe_cache[s0.params])
    assert before
    cap0 = ts._delta.capacity
    for st in (ts, js):
        st.insert(np.asarray(x[5500:6000]))
    assert ts._delta.capacity > cap0 == 512
    s1 = ts.searcher(params, **CPU)
    r1 = s1(qs)
    assert_identical(ts.search(qs, k=10, nprobe=8, exec_mode="paged", **CPU),
                     r1, "post-jump ")
    j1 = js.searcher(JParams(**kw))
    assert_same(r1, j1(q[:32]))
    after = ts._probe_cache[s1.params]
    for key, exe in before.items():
        assert after[key] is exe
    assert 32 in s1.buckets
    assert s1.compile_stats() == j1.compile_stats()


@pytest.fixture()
def routed_pairs(unit_data, shared_trained):
    """Two streams in each package over the same base and churn: one
    exhaustive (huge threshold), one routed from the first insert."""
    x, _, _ = unit_data
    out = []
    for route_min in (10 ** 9, 0):
        cfg = JConfig(nlist=64, strategy="rair", seil=True, kmeans_iters=8,
                      pq_iters=6, delta_route_min=route_min)
        ts, js = both(cfg, x, *shared_trained)
        churn((ts, js), x, hi=5600, n_del=64, n_base_del=32)
        out.append((ts, js))
    (te, je), (tr, jr) = out
    assert not te.delta_routed and tr.delta_routed and jr.delta_routed
    np.testing.assert_array_equal(tr._delta.post, jr._delta.post)
    return out


def test_routed_delta_bitwise_at_full_probe(routed_pairs, unit_data):
    _, q, _ = unit_data
    (te, je), (tr, jr) = routed_pairs
    qs = np.asarray(q[:48])
    re_ = te.search(qs, k=10, nprobe=64, **CPU)
    rr = tr.search(qs, k=10, nprobe=64, **CPU)
    assert torch.equal(re_.ids, rr.ids)
    assert torch.equal(re_.dists, rr.dists)
    assert torch.equal(re_.approx_dco, rr.approx_dco)
    assert_same(rr, jr.search(q[:48], k=10, nprobe=64))


def test_routed_delta_reduces_dco(routed_pairs, unit_data):
    _, q, _ = unit_data
    (te, je), (tr, jr) = routed_pairs
    qs = np.asarray(q[:48])
    de = te.search(qs, k=10, nprobe=8, **CPU)
    dr = tr.search(qs, k=10, nprobe=8, **CPU)
    assert dr.approx_dco.float().mean() < de.approx_dco.float().mean()
    assert_same(de, je.search(q[:48], k=10, nprobe=8))
    assert_same(dr, jr.search(q[:48], k=10, nprobe=8))


def test_routed_delta_items_retrievable(routed_pairs, unit_data):
    x, _, _ = unit_data
    _, (tr, jr) = routed_pairs
    r = tr.search(np.asarray(x[5100][None, :]), k=1, nprobe=16, **CPU)
    assert int(r.ids[0, 0]) == 5100
    assert_same(r, jr.search(x[5100][None, :], k=1, nprobe=16))


def test_traced_routed_delta_counters(routed_pairs, unit_data):
    """A traced routed batch's ``stage.delta_scan`` span counts the walk
    (``delta_walked``: the posted slots of each probed row) beside the
    kept slots (``delta_dco``), and ``kernel`` 0 for the plain version."""
    _, q, _ = unit_data
    _, (tr, jr) = routed_pairs
    qs = np.asarray(q[:16])
    searcher = tr.searcher(SearchParams(k=10, nprobe=8), **CPU)
    ref = searcher(qs)
    with obs.trace() as trace:
        res = searcher(qs)
    assert_identical(ref, res)
    counters = trace.stage_summary()["stage.delta_scan"]["counters"]
    dv = tr._device_state()
    sel = select_lists(t(qs), tr.centroids, nprobe=8).sel
    rows = dv.delta_post[sel.long()]
    assert counters["kernel"] == 0
    assert counters["delta_walked"] == int((rows >= 0).sum())
    assert 0 < counters["delta_dco"] < counters["delta_walked"]
    assert_same(res, jr.searcher(JParams(k=10, nprobe=8))(q[:16]))


def test_routing_threshold_activates_on_capacity(unit_data, shared_trained):
    x, _, _ = unit_data
    cfg = JConfig(nlist=64, strategy="rair", seil=True, kmeans_iters=8,
                  pq_iters=6, delta_route_min=256)
    st, _ = both(cfg, x, *shared_trained)
    assert st.delta_route_threshold == 256
    st.insert(np.asarray(x[5000:5100]))
    assert not st.delta_routed
    st.insert(np.asarray(x[5100:5400]))
    assert st.delta_routed
    st2, _ = both(dataclasses.replace(cfg, delta_route_min=None), x,
                  *shared_trained)
    assert st2.delta_route_threshold == 64 * 32
    assert st.routes_at(64)


def test_auto_routing_cost_guard(unit_data, shared_trained):
    x, _, _ = unit_data
    cfg = JConfig(nlist=64, strategy="rair", seil=True, kmeans_iters=8,
                  pq_iters=6)
    ts, js = both(cfg, x, *shared_trained)
    rng = np.random.default_rng(7)
    hot = np.asarray(x[5000])[None, :] + rng.normal(
        0, 1e-3, (2200, x.shape[1])).astype(np.float32)
    for st in (ts, js):
        st.insert(hot)
    assert ts.delta_routed
    assert ts._delta.post_width * 8 > ts._delta.capacity
    assert not ts.routes_at(8) and not js.routes_at(8)
    r = ts.search(np.asarray(x[5000])[None, :], k=1, nprobe=8, **CPU)
    assert int(r.ids[0, 0]) >= 5000
    assert_same(r, js.search(x[5000][None, :], k=1, nprobe=8))


# ---------------------------------------------------------------------------
# test_fused.py, test_obs.py and test_refine.py on streams
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("exec_mode", MODES)
def test_streaming_fused_parity(rairs_index, unit_data, exec_mode):
    x, q, _ = unit_data
    rng = np.random.default_rng(11)
    ts, js = StreamingIndex(carry(rairs_index)), JStream(rairs_index)
    new = rng.standard_normal((37, x.shape[1])).astype(np.float32)
    for st in (ts, js):
        st.insert(new)
        st.delete(np.arange(0, 60, 5))
    kw = dict(k=10, nprobe=8, exec_mode=exec_mode, query_tile=4)
    base = ts.searcher(SearchParams(**kw), **CPU)(np.asarray(q[:16]))
    fused = ts.searcher(SearchParams(**kw, fused_topk=True),
                        **CPU)(np.asarray(q[:16]))
    for f in INTS:
        assert torch.equal(getattr(fused, f), getattr(base, f)), f
    np.testing.assert_allclose(fused.dists.numpy(), base.dists.numpy(), **TOL)
    assert_same(fused, js.searcher(JParams(**kw, fused_topk=True))(q[:16]))


def test_streaming_fused_parity_plan_reuse(rairs_index, unit_data):
    x, q, _ = unit_data
    rng = np.random.default_rng(13)
    ts, js = StreamingIndex(carry(rairs_index)), JStream(rairs_index)
    new = rng.standard_normal((21, x.shape[1])).astype(np.float32)
    for st in (ts, js):
        st.insert(new)
        st.delete(np.arange(0, 40, 7))
    kw = dict(k=10, nprobe=8, exec_mode="clustered", query_tile=4,
              plan_reuse=True)
    base = ts.searcher(SearchParams(**kw), **CPU)
    fused = ts.searcher(SearchParams(**kw, fused_topk=True), **CPU)
    jfused = js.searcher(JParams(**kw, fused_topk=True))
    for lo in (0, 8):                     # the second batch hits the cache
        qs = np.asarray(q[lo:lo + 8])
        a, b = fused(qs), base(qs)
        for f in INTS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert_same(a, jfused(q[lo:lo + 8]))
    assert fused.compile_stats() == jfused.compile_stats()


def test_traced_streaming_delta_scan(unit_data, shared_trained):
    x, q, _ = unit_data
    cfg = JConfig(nlist=64, strategy="rair", seil=True)
    cents, cb = shared_trained
    j = j_build(jax.random.PRNGKey(0), x[:4000], cfg, centroids=cents,
                codebook=cb)
    from repro.core import StreamConfig as JStreamConfig
    from repro_torch.core import StreamConfig
    ts = StreamingIndex(carry(j), StreamConfig(delta_pad=512))
    js = JStream(j, JStreamConfig(delta_pad=512))
    for st in (ts, js):
        st.insert(np.asarray(x[4000:4256]))
    searcher = ts.searcher(SearchParams(k=10, nprobe=8), **CPU)
    qs = np.asarray(q)
    ref = searcher(qs)
    with obs.trace():
        searcher(qs)
    with obs.trace() as tr:
        res = searcher(qs)
    assert_identical(ref, res)
    summary = tr.stage_summary()
    assert "stage.delta_scan" in summary
    counters = summary["stage.delta_scan"]["counters"]
    assert counters["delta_dco"] > 0
    assert counters["kernel"] == 0 and "delta_walked" not in counters
    want = js.searcher(JParams(k=10, nprobe=8))(q)
    assert_same(res, want)


@pytest.fixture()
def fresh_streams(unit_data):
    """test_refine.py's ``fresh_stream`` in both packages."""
    x, q, _ = unit_data
    cfg = JConfig(nlist=64, strategy="rair", seil=True, kmeans_iters=8,
                  pq_iters=6)
    j = j_build(jax.random.PRNGKey(0), x[:5600], cfg)
    return StreamingIndex(carry(j)), j.streaming(), x, q


def test_streaming_two_tier(fresh_streams):
    ts, js, x, q = fresh_streams
    qs = np.asarray(q)
    p_two = SearchParams(k=10, nprobe=16, refine=RefineParams("binary", 4))
    jp_two = JParams(k=10, nprobe=16, refine=JRefine("binary", 4))
    p_one = SearchParams(k=10, nprobe=16)
    p_rf1 = SearchParams(k=10, nprobe=16, refine=RefineParams("binary", 1))
    r0 = ts.searcher(p_one, **CPU)(qs)
    assert torch.equal(r0.ids, ts.searcher(p_rf1, **CPU)(qs).ids)
    assert_same(ts.searcher(p_two, **CPU)(qs), js.searcher(jp_two)(q))
    codec0 = ts._plane_codecs["binary"]
    # the pq4 plane with the reference's codec (each package trains its own)
    jcodec = js.plane("pq4").codec
    ts.plane("pq4", codec=PQCodebook(t(jcodec.codebooks)))
    ids = None
    for st in (ts, js):
        ids = st.insert(np.asarray(x[5600:5800]))
        st.delete(np.arange(60))
    got = ts.searcher(p_two, **CPU)(qs)
    live = got.ids.numpy()
    assert not (set(live[live >= 0].tolist()) & set(range(60)))
    assert set(live[live >= 0].tolist()) & set(ids.tolist())
    assert_same(got, js.searcher(jp_two)(q))
    for plane in ("pq4", "binary"):
        for mode in MODES:
            for fused in (False, True):
                kw = dict(k=10, nprobe=16, exec_mode=mode, fused_topk=fused)
                assert_same(
                    ts.searcher(SearchParams(
                        **kw, refine=RefineParams(plane, 4)), **CPU)(qs[:24]),
                    js.searcher(JParams(**kw, refine=JRefine(plane, 4)))(
                        q[:24]), f"{plane} {mode} fused={fused} ")
    r0 = ts.searcher(p_one, **CPU)(qs)
    r1 = ts.searcher(p_rf1, **CPU)(qs)
    assert_identical(r0, r1)
    # compaction carries the codec: the new epoch re-encodes with it
    ts.compact()
    js.compact()
    assert_same(ts.searcher(p_two, **CPU)(qs), js.searcher(jp_two)(q))
    assert ts._plane_codecs["binary"] is codec0
    assert ts.base.plane("binary").codec is codec0
    sess = ts.searcher(p_two, **CPU)
    ts.insert(np.asarray(x[:4]))
    with pytest.raises(StaleSessionError):
        sess(qs[:8])
    ts.searcher(p_two, **CPU)(qs[:8])
