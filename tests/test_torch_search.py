"""End to end: the port's seil_search and sessions against the reference.

JAX-built indexes are carried across with ``convert.index_from_numpy``
(numpy arrays under the bundle's member names) and searched by both
packages on the same queries, in all three exec modes with the fused
scan off and on.  ids and DCO counters compare bitwise, distances at
rtol=atol=1e-5.  A query whose stage-1 selection differs is excluded
only if the test shows the cause: two centroid distances within 1e-5
relative of each other at the nprobe boundary.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexConfig as JConfig
from repro.core import build_index as j_build
from repro.core import seil_search as j_search
from repro.core.kmeans import pairwise_sq_l2 as j_l2
from repro.data import make_dataset as j_dataset
from repro_torch.convert import index_from_numpy
from repro_torch.core import SearchParams, seil_search
from repro_torch.core.engine import select_lists

BUNDLE_FIELDS = ("block_codes", "block_ids", "block_other", "owned", "refs",
                 "refs_other", "misc")
MODES = ("paged", "grouped", "clustered")


def convert(jidx):
    arrays = {f: np.asarray(getattr(jidx.arrays, f)) for f in BUNDLE_FIELDS}
    arrays.update(centroids=np.asarray(jidx.centroids),
                  codebooks=np.asarray(jidx.codebook.codebooks),
                  vectors=np.asarray(jidx.vectors), assigns=jidx.assigns,
                  codes=jidx.codes)
    return index_from_numpy(dataclasses.asdict(jidx.config), arrays,
                            device="cpu")


@pytest.fixture(scope="module")
def dup_index(unit_data):
    """RAIR without SEIL: duplicated storage, so results need id-dedup."""
    x, _, _ = unit_data
    return j_build(jax.random.PRNGKey(1), x,
                   JConfig(nlist=64, strategy="rair", seil=False,
                           kmeans_iters=8, pq_iters=6))


@pytest.fixture(scope="module")
def ip_data():
    x, q, _ = j_dataset("unit_ip")
    idx = j_build(jax.random.PRNGKey(2), x,
                  JConfig(nlist=64, metric="ip", kmeans_iters=8, pq_iters=6))
    return idx, q


def _kw(jidx, mode, fused, nprobe=8):
    return dict(nprobe=nprobe, bigk=100, k=10,
                max_scan=jidx.default_max_scan(nprobe),
                metric=jidx.config.metric,
                dedup_results=jidx.needs_result_dedup,
                oversample=jidx.result_oversample, exec_mode=mode,
                query_tile=8, fused_topk=fused)


def _near_tie_rows(jidx, q, nprobe):
    """Rows whose stage-1 selections differ, each shown to be a centroid
    distance gap below 1e-5 relative at the nprobe boundary."""
    metric = jidx.config.metric
    js = jax.numpy.asarray(
        jax.jit(lambda a, c: j_l2(a, c) if metric == "l2" else -(a @ c.T))(
            jnp.asarray(q), jidx.centroids))
    from repro.core.engine import select_lists as j_select
    jsel = np.asarray(j_select(jnp.asarray(q), jidx.centroids, nprobe=nprobe,
                               metric=metric).sel)
    tsel = select_lists(torch.from_numpy(np.array(q)),
                        torch.from_numpy(np.array(jidx.centroids)),
                        nprobe=nprobe, metric=metric).sel.numpy()
    rows = np.nonzero((jsel != tsel).any(axis=1))[0]
    cd = np.asarray(js)
    for r in rows:
        srt = np.sort(cd[r])
        gap = abs(srt[nprobe] - srt[nprobe - 1])
        assert gap <= 1e-5 * max(abs(srt[nprobe]), 1e-30), (r, gap)
    return rows


def _compare(jidx, tidx, q, mode, fused):
    kw = _kw(jidx, mode, fused)
    want = j_search(jidx.arrays, jidx.centroids, jidx.codebook, jidx.vectors,
                    jnp.asarray(q), **kw)
    got = seil_search(tidx.arrays, tidx.centroids, tidx.codebook,
                      tidx.vectors, torch.from_numpy(np.array(q)), **kw)
    skip = _near_tie_rows(jidx, q, kw["nprobe"])
    keep = np.setdiff1d(np.arange(q.shape[0]), skip)
    assert len(keep) >= q.shape[0] - 2
    for f in ("ids", "approx_dco", "refine_dco", "scanned_blocks",
              "dropped_blocks"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[keep],
                                      np.asarray(getattr(want, f))[keep],
                                      err_msg=f)
    np.testing.assert_allclose(got.dists.numpy()[keep],
                               np.asarray(want.dists)[keep],
                               rtol=1e-5, atol=1e-5)
    return got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fused", [False, True])
def test_seil_search_matches_reference(rairs_index, unit_data, mode, fused):
    _, q, _ = unit_data
    _compare(rairs_index, convert(rairs_index), np.asarray(q[:64]), mode,
             fused)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fused", [False, True])
def test_dedup_layout_matches_reference(dup_index, unit_data, mode, fused):
    assert dup_index.needs_result_dedup
    _, q, _ = unit_data
    _compare(dup_index, convert(dup_index), np.asarray(q[64:128]), mode,
             fused)


@pytest.mark.parametrize("mode,fused", [("paged", False), ("paged", True),
                                        ("clustered", True)])
def test_ip_index_matches_reference(ip_data, mode, fused):
    jidx, q = ip_data
    _compare(jidx, convert(jidx), np.asarray(q[:64]), mode, fused)


def test_convert_carries_stats_and_config(rairs_index, dup_index):
    for jidx in (rairs_index, dup_index):
        tidx = convert(jidx)
        assert dataclasses.asdict(tidx.stats) == dataclasses.asdict(jidx.stats)
        assert dataclasses.asdict(tidx.config) == dataclasses.asdict(jidx.config)
        assert tidx.default_max_scan(8) == jidx.default_max_scan(8)
        assert tidx.arrays.block_ids.dtype == torch.int32
        assert tidx.arrays.block_codes.dtype == torch.uint8


def test_searcher_pads_to_bucket(rairs_index, unit_data):
    """B=48 pads to the 64 bucket.  Row-safety of padding is held at the
    padded shape: a torch matmul whose batch changes may round
    differently, so the session is compared with seil_search run on the
    same zero-padded batch."""
    _, q, _ = unit_data
    tidx = convert(rairs_index)
    qs = torch.from_numpy(np.array(q[:48]))
    s = tidx.searcher(SearchParams(k=10, nprobe=8), device="cpu")
    res = s(qs)
    padded = torch.cat([qs, qs.new_zeros((16, qs.shape[1]))])
    p = s.params
    ref = seil_search(tidx.arrays, tidx.centroids, tidx.codebook,
                      tidx.vectors, padded, nprobe=p.nprobe, bigk=p.bigk,
                      k=p.k, max_scan=p.max_scan, dedup_results=False)
    for f in res._fields:
        assert torch.equal(getattr(res, f), getattr(ref, f)[:48]), f
    assert s.stats.padded_rows == 16
    assert s.stats.calls == 1 and s.stats.dispatches == 1
    assert tidx.searcher(SearchParams(k=10, nprobe=8), device="cpu") is s


def test_searcher_chunks_and_merges(rairs_index, unit_data):
    _, q, _ = unit_data
    tidx = convert(rairs_index)
    qs = torch.from_numpy(np.array(q[:36]))
    s = tidx.searcher(SearchParams(k=10, nprobe=8, batch_buckets=(8, 16)),
                      device="cpu")
    res = s(qs)            # chunks of 16, 16 and 4 (padded to 8)
    assert s.stats.dispatches == 3 and s.stats.padded_rows == 4
    assert res.ids.shape == (36, 10)
    for lo, hi in ((0, 16), (16, 32), (32, 36)):
        part = s(qs[lo:hi])
        assert torch.equal(part.ids, res.ids[lo:hi])
    assert SearchParams(batch_buckets=(8, 16)).bucket_for(5) == 8
    assert SearchParams().bucket_for(3000) == 1024
    assert SearchParams().max_chunk == 1024


def test_searcher_rejects_unported_features(rairs_index, unit_data):
    """plan_reuse and refine, each refused here until it was ported, run:
    plan_reuse equals the plain session bitwise (tests/test_torch_plan.py
    holds it against the reference), and refine at refine_factor 1 is the
    plain session bitwise (tests/test_torch_refine.py holds the two-tier
    search against the reference)."""
    from repro_torch.core import RefineParams
    _, q, _ = unit_data
    tidx = convert(rairs_index)
    qs = torch.from_numpy(np.array(q[:16]))
    for mode in ("grouped", "clustered"):
        reuse = tidx.searcher(SearchParams(exec_mode=mode, plan_reuse=True),
                              device="cpu")(qs)
        plain = tidx.searcher(SearchParams(exec_mode=mode), device="cpu")(qs)
        for f in plain._fields:
            assert torch.equal(getattr(reuse, f), getattr(plain, f)), f
    plain = tidx.searcher(SearchParams(), device="cpu")(qs)
    rf1 = tidx.searcher(SearchParams(refine=RefineParams(refine_factor=1)),
                        device="cpu")(qs)
    for f in plain._fields:
        assert torch.equal(getattr(rf1, f), getattr(plain, f)), f
    two = tidx.searcher(SearchParams(refine=RefineParams()), device="cpu")(qs)
    assert two.ids.shape == plain.ids.shape
    assert torch.equal(two.approx_dco, plain.approx_dco)
    with pytest.raises(ValueError):
        SearchParams(exec_mode="nope")
    with pytest.raises(ValueError, match="nprobe"):
        tidx.searcher(SearchParams(nprobe=999), device="cpu")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("call", ["positional", "keyword"])
def test_index_search_takes_use_kernel(rairs_index, unit_data, mode, call):
    """``RairsIndex.search`` takes the reference's arguments in the
    reference's order, ``use_kernel`` included: by position and by
    keyword it answers as the session with the same params and as the
    reference's ``RairsIndex.search``."""
    from repro_torch.core import Searcher
    _, q, _ = unit_data
    q = np.asarray(q[:32])
    tidx = convert(rairs_index)
    tq = torch.from_numpy(np.array(q))
    if call == "positional":
        got = tidx.search(tq, 10, 8, 10, None, True, mode, 8, device="cpu")
    else:
        got = tidx.search(tq, k=10, nprobe=8, k_factor=10, max_scan=None,
                          use_kernel=True, exec_mode=mode, query_tile=8,
                          device="cpu")
    sess = Searcher(tidx, SearchParams(k=10, nprobe=8, k_factor=10,
                                       use_kernel=True, exec_mode=mode,
                                       query_tile=8))(tq)
    want = rairs_index.search(jnp.asarray(q), 10, 8, 10, None, True, mode, 8)
    keep = np.setdiff1d(np.arange(q.shape[0]),
                        _near_tie_rows(rairs_index, q, 8))
    assert len(keep) >= q.shape[0] - 2
    for f in ("ids", "approx_dco", "refine_dco", "scanned_blocks",
              "dropped_blocks"):
        assert torch.equal(getattr(got, f), getattr(sess, f)), f
        np.testing.assert_array_equal(getattr(got, f).numpy()[keep],
                                      np.asarray(getattr(want, f))[keep],
                                      err_msg=f)
    assert torch.equal(got.dists, sess.dists)
    np.testing.assert_allclose(got.dists.numpy()[keep],
                               np.asarray(want.dists)[keep],
                               rtol=1e-5, atol=1e-5)
