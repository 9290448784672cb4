"""Plan reuse in the port against the reference, on the CPU.

The host half of the planner (``engine/cluster.py``: ``plan_width``,
``width_buckets``, ``tile_signatures``, ``merge_unions_host``) is numpy
in both packages and must give the reference's keys and unions
bitwise.  The split pipeline (``probe_plan`` / ``scan_finalize``) and
the plan-reuse session are held to the reference on the unit index:
plans, permutations, unions, ids and DCO counters bitwise, LUTs and
distances at rtol=atol=1e-5, and the session's ``compile_stats()``
(plan stats included) exactly.  Inputs are made by numpy from a seed.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SearchParams as JParams
from repro.core import engine as jeng
from repro.core import search as jsearch
from repro.core.searcher import Searcher as JSearcher
from repro_torch.convert import index_from_numpy
from repro_torch.core import SearchParams
from repro_torch.core import engine as teng
from repro_torch.core import search as tsearch
from repro_torch.core.searcher import Searcher

BIG = 2 ** 30
TOL = dict(rtol=1e-5, atol=1e-5)
BUNDLE_FIELDS = ("block_codes", "block_ids", "block_other", "owned", "refs",
                 "refs_other", "misc")


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def tindex(rairs_index):
    """The reference's unit index carried across to the port."""
    j = rairs_index
    arrays = {f: np.asarray(getattr(j.arrays, f)) for f in BUNDLE_FIELDS}
    arrays.update(centroids=np.asarray(j.centroids),
                  codebooks=np.asarray(j.codebook.codebooks),
                  vectors=np.asarray(j.vectors), assigns=j.assigns,
                  codes=j.codes)
    return index_from_numpy(dataclasses.asdict(j.config), arrays,
                            device="cpu")


def random_unions(rng, t_, w, hi, fill):
    """(T, W) int32 ascending unique block ids in [0, hi), ``fill`` of
    each row live at most, BIG-padded."""
    out = np.full((t_, w), BIG, np.int32)
    for r in range(t_):
        n = int(rng.integers(0, max(1, int(fill * w)) + 1))
        out[r, :n] = np.sort(rng.choice(hi, size=n, replace=False))
    return out


# ---------------------------------------------------------------------------
# host half of the planner
# ---------------------------------------------------------------------------
def test_plan_width_and_width_buckets_match_reference():
    for cap in (1, 31, 32, 33, 48, 100, 4448, 35584, 100000):
        assert teng.width_buckets(cap) == jeng.width_buckets(cap)
        for live in (0, 1, 31, 32, 33, 47, 48, 49, 1000, cap):
            assert teng.plan_width(live, cap) == jeng.plan_width(live, cap)
    assert teng.EXTEND_SLACK == jeng.cluster.EXTEND_SLACK
    assert teng.CLUSTER_DEPTH == jeng.cluster.CLUSTER_DEPTH


@pytest.mark.parametrize("seed", range(4))
def test_tile_signatures_match_reference(seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 5, (24, 6))
    rows[:, 0] = np.sort(rng.integers(0, 4, 24))     # runs of shared leads
    rows[5:9, 1:] = rows[4, 1:]                      # repeated prefixes
    assert (teng.tile_signatures(rows[:, 0])
            == jeng.tile_signatures(rows[:, 0]))
    assert (teng.tile_signatures(rows[:, 0], deep=rows)
            == jeng.tile_signatures(rows[:, 0], deep=rows))
    assert (teng.tile_signatures(rows[:, 0], deep=rows[:, :2])
            == jeng.tile_signatures(rows[:, 0], deep=rows[:, :2]))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("with_present", [False, True])
def test_merge_unions_host_matches_reference(seed, with_present):
    rng = np.random.default_rng(seed)
    t_, w = 9, int(rng.integers(8, 80))
    hi = int(rng.integers(w + 1, 4 * w))
    cached = random_unions(rng, t_, w, hi, float(rng.uniform(0.1, 1.0)))
    own = random_unions(rng, t_, w, hi, float(rng.uniform(0.1, 1.0)))
    own[0] = cached[0]                               # a hit
    own[1] = np.where(cached[1] < BIG, cached[1], BIG)
    own[1, 1:] = BIG if own[1, 0] < BIG else own[1, 1:]   # a subset
    present = rng.random(t_) < 0.7 if with_present else None
    got = teng.merge_unions_host(cached, own, present)
    want = jeng.merge_unions_host(cached, own, present)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(teng.merge_unions_host(None, own),
                    jeng.merge_unions_host(None, own)):
        np.testing.assert_array_equal(a, b)


def test_union_live_takes_arrays_and_tensors():
    u = random_unions(np.random.default_rng(0), 5, 20, 60, 0.8)
    want = np.asarray(jeng.union_live(u))
    np.testing.assert_array_equal(teng.union_live(u), want)
    np.testing.assert_array_equal(teng.union_live(t(u)).numpy(), want)


# ---------------------------------------------------------------------------
# the split pipeline
# ---------------------------------------------------------------------------
def _probe_kw(jidx, mode, query_tile=8, nprobe=8):
    return dict(nprobe=nprobe, max_scan=jidx.default_max_scan(nprobe),
                metric=jidx.config.metric, exec_mode=mode,
                query_tile=query_tile)


def _scan_kw(jidx, mode, fused, query_tile=8):
    return dict(bigk=100, k=10, metric=jidx.config.metric,
                dedup_results=jidx.needs_result_dedup,
                oversample=jidx.result_oversample, exec_mode=mode,
                query_tile=query_tile, fused_topk=fused)


def _probes(jidx, tidx, q, mode, query_tile=8):
    kw = _probe_kw(jidx, mode, query_tile)
    want = jsearch.probe_plan(jidx.arrays, jidx.centroids, jidx.codebook,
                              jnp.asarray(q), **kw)
    got = tsearch.probe_plan(tidx.arrays, tidx.centroids, tidx.codebook,
                             t(q), **kw)
    return got, want


@pytest.mark.parametrize("mode,query_tile", [("grouped", 8),
                                             ("clustered", 8),
                                             ("clustered", 5)])
def test_probe_plan_matches_reference(rairs_index, tindex, unit_data, mode,
                                      query_tile):
    _, q, _ = unit_data
    got, want = _probes(rairs_index, tindex, np.asarray(q[:40]), mode,
                        query_tile)
    for f in ("sel", "rank_of", "perm", "unions"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    for f in got.plan._fields:
        np.testing.assert_array_equal(getattr(got.plan, f).numpy(),
                                      np.asarray(getattr(want.plan, f)), f)
    np.testing.assert_allclose(got.lut.numpy(), np.asarray(want.lut), **TOL)


@pytest.mark.parametrize("mode", ["grouped", "clustered"])
@pytest.mark.parametrize("fused", [False, True])
def test_scan_finalize_on_widened_unions_matches_reference(
        rairs_index, tindex, unit_data, mode, fused):
    """Both halves scan the same unions, widened with another batch's
    (merge_unions_host) and cut to a width bucket, as a session does."""
    _, q, _ = unit_data
    qa = np.asarray(q[:32])
    got, want = _probes(rairs_index, tindex, qa, mode)
    other, _ = _probes(rairs_index, tindex, np.asarray(q[32:64]), mode)
    own = np.asarray(want.unions)
    used, _, ext = jeng.merge_unions_host(other.unions.numpy(), own)
    assert ext.any(), "no tile was widened"
    wp = jeng.plan_width(int(jeng.union_live(used).max()), own.shape[1])
    unions = np.ascontiguousarray(used[:, :wp])
    skw = _scan_kw(rairs_index, mode, fused)
    r_want = jsearch.scan_finalize(rairs_index.arrays, rairs_index.vectors,
                                   jnp.asarray(qa), want, jnp.asarray(unions),
                                   **skw)
    r_got = tsearch.scan_finalize(tindex.arrays, tindex.vectors, t(qa), got,
                                  t(unions), **skw)
    for f in ("ids", "approx_dco", "refine_dco", "scanned_blocks",
              "dropped_blocks"):
        np.testing.assert_array_equal(getattr(r_got, f).numpy(),
                                      np.asarray(getattr(r_want, f)), f)
    np.testing.assert_allclose(r_got.dists.numpy(), np.asarray(r_want.dists),
                               **TOL)
    # and the widened scan equals the port's own plain search
    plain = tsearch.seil_search(
        tindex.arrays, tindex.centroids, tindex.codebook, tindex.vectors,
        t(qa), **dict(skw, nprobe=8,
                      max_scan=rairs_index.default_max_scan(8)))
    for f in r_got._fields:
        assert torch.equal(getattr(r_got, f), getattr(plain, f)), f


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------
def _sessions(jidx, tidx, **kw):
    """A fresh reference session and a fresh port session (not the
    indexes' cached ones, so no other test's traffic is in the stats)."""
    kw = dict(dict(k=10, nprobe=8, max_scan=jidx.default_max_scan(8)), **kw)
    return JSearcher(jidx, JParams(**kw)), Searcher(tidx, SearchParams(**kw))


def _same_results(got, want):
    for f in ("ids", "approx_dco", "refine_dco", "scanned_blocks",
              "dropped_blocks"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               **TOL)


@pytest.mark.parametrize("mode", ["grouped", "clustered"])
@pytest.mark.parametrize("fused", [False, True])
def test_plan_reuse_session_matches_reference(rairs_index, tindex, unit_data,
                                              mode, fused):
    """Drifting batches through a plan_reuse session of each package:
    the same results, and the same compile and plan stats (hits,
    extends, misses, live and width sums, deep splits) after each."""
    _, q, _ = unit_data
    q = np.asarray(q)
    js, ts = _sessions(rairs_index, tindex, exec_mode=mode, fused_topk=fused,
                       plan_reuse=True)
    for lo, hi in ((0, 48), (16, 64), (0, 48), (8, 40)):
        _same_results(ts(t(q[lo:hi])), js(jnp.asarray(q[lo:hi])))
        assert ts.compile_stats() == js.compile_stats()
    plan = ts.compile_stats()["plan"]
    assert plan["batches"] == 4 and plan["misses"] >= 1
    assert plan["hits"] + plan["extends"] > 0


@pytest.mark.parametrize("mode,plan_reuse", [("paged", False),
                                             ("grouped", True),
                                             ("clustered", True)])
def test_warmup_and_warmup_widths_match_reference(rairs_index, tindex,
                                                  unit_data, mode,
                                                  plan_reuse):
    _, q, _ = unit_data
    q = np.asarray(q)
    js, ts = _sessions(rairs_index, tindex, exec_mode=mode,
                       plan_reuse=plan_reuse, batch_buckets=(16, 32))
    js.warmup(10, 32)
    ts.warmup(10, 32)
    assert ts.compile_stats() == js.compile_stats()
    js.warmup_widths(32)
    ts.warmup_widths(32)
    assert ts.compile_stats() == js.compile_stats()
    assert ts.stats.warmup_compiles == ts.stats.compiles
    _same_results(ts(t(q[:40])), js(jnp.asarray(q[:40])))
    assert ts.compile_stats() == js.compile_stats()
    assert ts.buckets == js.buckets == (16, 32)
