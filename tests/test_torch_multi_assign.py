"""m-assignment (``multi_m > 2``, paper Fig. 14) against the reference.

``rair_assign_multi`` picks lists greedily: the nearest first, then each
next the untaken candidate of least ``||r'||^2 + lam * aggr_i r_i^T r'``.
The residual dot products are a batched f32 matmul in both packages,
which may round differently, so a row may pick the other of two
candidates whose losses lie within f32 rounding of each other.  The
test allows such rows only where it shows the tie: at some step of the
greedy, recomputed in float64, the best and second-best untaken losses
differ by no more than 1e-5 of the largest loss term (f32 keeps about
6e-8 of a value per rounding, and each dot product rounds D = 32 times).
Given the reference's assignments, the layout and ``seil_search`` are
bitwise (ids, DCO counters) and distances agree at rtol=atol=1e-5.
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
from repro.core import assign as jassign
from repro.core.seil import build_seil as j_build_seil
from repro_torch.convert import index_from_numpy
from repro_torch.core import (IndexConfig, PQCodebook, build_index,
                              build_seil, rair_assign_multi, seil_search)

BUNDLE_FIELDS = ("block_codes", "block_ids", "block_other", "owned", "refs",
                 "refs_other", "misc")
MODES = ("paged", "grouped", "clustered")


def t(a):
    return torch.from_numpy(np.array(a))


def _tie_rows(x, c, lam, aggr, m, n_cands, rows):
    """The rows among ``rows`` whose float64 greedy meets a near-tie
    (best and second-best untaken loss within 1e-5 of the largest loss
    term) at some step."""
    x = np.asarray(x, np.float64)
    c = np.asarray(c, np.float64)
    tied = []
    for r in rows:
        d2 = ((x[r][None] - c) ** 2).sum(-1)
        cand = np.argsort(d2, kind="stable")[:n_cands]
        res = c[cand] - x[r][None]
        dots = res @ res.T
        chosen, taken = [0], np.zeros(len(cand), bool)
        taken[0] = True
        near = False
        for j in range(1, m):
            sel = dots[chosen]
            agg = {"max": sel.max(0), "min": sel.min(0),
                   "avg": sel.sum(0) / j}[aggr]
            loss = np.where(taken, np.inf, d2[cand] + lam * agg)
            srt = np.sort(loss)
            scale = max(np.abs(d2[cand]).max(), lam * np.abs(agg).max())
            near |= bool(srt[1] - srt[0] <= 1e-5 * scale)
            nxt = int(np.argmin(loss))
            chosen.append(nxt)
            taken[nxt] = True
        if near:
            tied.append(r)
    return np.asarray(tied, np.int64)


@pytest.mark.parametrize("aggr", ["max", "min", "avg"])
@pytest.mark.parametrize("m", [3, 4])
def test_rair_assign_multi_matches_reference(rairs_index, unit_data, m,
                                             aggr):
    x, _, _ = unit_data
    c = np.asarray(rairs_index.centroids)
    want = np.asarray(jassign.rair_assign_multi(x, jnp.asarray(c), m=m,
                                                aggr=aggr, n_cands=10))
    got = rair_assign_multi(t(x), t(c), m=m, aggr=aggr, n_cands=10,
                            chunk=2048).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (len(x), m)
    assert (np.diff(got, axis=1) > 0).all()         # strict, sorted
    differ = np.nonzero((got != want).any(axis=1))[0]
    assert len(differ) <= len(x) // 1000
    tied = _tie_rows(x, c, 0.5, aggr, m, 10, differ)
    np.testing.assert_array_equal(differ, tied)


def test_rair_assign_multi_rejects_unknown_aggr(unit_data):
    x, _, _ = unit_data
    with pytest.raises(ValueError, match="aggr"):
        rair_assign_multi(t(x[:8]), t(x[:4]), aggr="median")


@pytest.fixture(scope="module")
def multi_index(unit_data):
    x, _, _ = unit_data
    return j_build(jax.random.PRNGKey(5), x,
                   JConfig(nlist=64, multi_m=3, aggr="max", kmeans_iters=8,
                           pq_iters=6))


def _convert(jidx):
    arrays = {f: np.asarray(getattr(jidx.arrays, f)) for f in BUNDLE_FIELDS}
    arrays.update(centroids=np.asarray(jidx.centroids),
                  codebooks=np.asarray(jidx.codebook.codebooks),
                  vectors=np.asarray(jidx.vectors), assigns=jidx.assigns,
                  codes=jidx.codes)
    return index_from_numpy(dataclasses.asdict(jidx.config), arrays,
                            device="cpu")


def test_layout_from_reference_assignments_is_bitwise(multi_index):
    """m = 3 stores every copy (no shared cells): build_seil of the
    reference's (n, 3) assignments is the reference's layout."""
    assigns, codes = multi_index.assigns, multi_index.codes
    assert assigns.shape[1] == 3
    ids = np.arange(len(codes), dtype=np.int32)
    tarr, tstats = build_seil(assigns, codes, ids, 64, block=32,
                              shared=False, device="cpu")
    for f in BUNDLE_FIELDS:
        np.testing.assert_array_equal(getattr(tarr, f).numpy(),
                                      np.asarray(getattr(multi_index.arrays,
                                                         f)), err_msg=f)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(multi_index.stats)
    again, _ = j_build_seil(assigns, codes, ids, 64, block=32, shared=False)
    np.testing.assert_array_equal(np.asarray(again.block_ids),
                                  tarr.block_ids.numpy())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fused", [False, True])
def test_multi_index_search_matches_reference(multi_index, unit_data, mode,
                                              fused):
    _, q, _ = unit_data
    tidx = _convert(multi_index)
    assert tidx.result_oversample == multi_index.result_oversample == 3
    assert tidx.needs_result_dedup == multi_index.needs_result_dedup
    kw = dict(nprobe=8, bigk=100, k=10,
              max_scan=multi_index.default_max_scan(8), metric="l2",
              dedup_results=multi_index.needs_result_dedup,
              oversample=multi_index.result_oversample, exec_mode=mode,
              query_tile=8, fused_topk=fused)
    qs = np.asarray(q[:64])
    want = j_search(multi_index.arrays, multi_index.centroids,
                    multi_index.codebook, multi_index.vectors,
                    jnp.asarray(qs), **kw)
    got = seil_search(tidx.arrays, tidx.centroids, tidx.codebook,
                      tidx.vectors, t(qs), **kw)
    for f in ("ids", "approx_dco", "refine_dco", "scanned_blocks",
              "dropped_blocks"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-5, atol=1e-5)


def test_build_index_multi_m_uses_m_assignment(multi_index, unit_data):
    """The port's build with the reference's centroids and codebook
    takes the m-assignment over the strategy, and lays every copy out
    unshared, as the reference's build does."""
    x, _, _ = unit_data
    cfg = IndexConfig(nlist=64, multi_m=3, aggr="max", kmeans_iters=8,
                      pq_iters=6)
    idx = build_index(t(x), cfg, centroids=t(multi_index.centroids),
                      codebook=PQCodebook(t(multi_index.codebook.codebooks)),
                      device="cpu")
    assert idx.assigns.shape == multi_index.assigns.shape
    assert (idx.assigns == multi_index.assigns).all(axis=1).mean() >= 0.999
    assert idx.stats.n_ref_entries == 0 and idx.arrays.refs.shape[1] == 1
    want, _ = build_seil(idx.assigns, idx.codes,
                         np.arange(len(x), dtype=np.int32), 64, shared=False,
                         device="cpu")
    assert torch.equal(idx.arrays.block_ids, want.block_ids)
