"""The port's small extras against the reference, on the CPU.

``pq_adc`` / ``pq_decode`` (core/pq.py) within 1e-5; ``per_query_recall``
/ ``dco_summary`` (core/metrics.py), ``air_skip_fraction``
(core/assign.py), ``cell_stats`` / ``vectors_in_large_cells``
(core/seil.py) exactly, on the same inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assign as jassign
from repro.core import metrics as jmetrics
from repro.core import pq as jpq
from repro.core import seil as jseil
from repro.core.search import SearchResult as JResult
from repro_torch.core import (PQCodebook, SearchResult, air_skip_fraction,
                              cell_stats, dco_summary, per_query_recall,
                              pq_adc, pq_decode, vectors_in_large_cells)

TOL = dict(rtol=1e-5, atol=1e-5)


def _codebook(jidx):
    return PQCodebook(torch.from_numpy(np.array(jidx.codebook.codebooks)))


@pytest.mark.parametrize("rows", [1, 7, 256])
def test_pq_decode_matches_reference(rairs_index, rows):
    codes = np.array(rairs_index.codes[:rows])
    want = np.asarray(jpq.pq_decode(rairs_index.codebook, jnp.asarray(codes)))
    got = pq_decode(_codebook(rairs_index), torch.from_numpy(codes))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("query", [0, 5, 17])
def test_pq_adc_matches_reference(rairs_index, unit_data, query):
    _, q, _ = unit_data
    lut = jpq.pq_lut(rairs_index.codebook, jnp.asarray(q[query:query + 1]))[0]
    codes = np.array(rairs_index.codes[:300])
    want = np.asarray(jpq.pq_adc(lut, jnp.asarray(codes)))
    tlut = torch.from_numpy(np.array(lut))
    got = pq_adc(tlut, torch.from_numpy(codes))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # one item (codes (M,)) gives a scalar
    one = pq_adc(tlut, torch.from_numpy(codes[3]))
    assert one.shape == ()
    np.testing.assert_allclose(
        one.item(), float(np.asarray(jpq.pq_adc(lut, jnp.asarray(codes[3])))),
        **TOL)


def test_pq_adc_sums_ascending_m(rairs_index, unit_data):
    _, q, _ = unit_data
    lut = torch.from_numpy(np.array(
        jpq.pq_lut(rairs_index.codebook, jnp.asarray(q[:1]))[0]))
    codes = torch.from_numpy(np.array(rairs_index.codes[:64]))
    want = torch.zeros(codes.shape[0])
    for m in range(lut.shape[0]):
        want = want + lut[m, codes[:, m].long()]
    assert torch.equal(pq_adc(lut, codes), want)


def _result(rng, nq=40, k=10):
    ids = rng.integers(0, 500, size=(nq, k)).astype(np.int32)
    return dict(ids=ids, dists=rng.random((nq, k)).astype(np.float32),
                approx_dco=rng.integers(0, 9000, nq).astype(np.int32),
                refine_dco=rng.integers(0, 100, nq).astype(np.int32),
                scanned_blocks=rng.integers(0, 90, nq).astype(np.int32),
                dropped_blocks=rng.integers(0, 3, nq).astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_per_query_recall_and_dco_summary_exact(seed):
    rng = np.random.default_rng(seed)
    r = _result(rng)
    gt = rng.integers(0, 500, size=(40, 10)).astype(np.int32)
    gt[:, :5] = r["ids"][:, :5]
    want = jmetrics.per_query_recall(r["ids"], gt)
    got = per_query_recall(torch.from_numpy(r["ids"]), gt)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    want = jmetrics.dco_summary(JResult(**{f: jnp.asarray(v)
                                           for f, v in r.items()}))
    got = dco_summary(SearchResult(**{f: torch.from_numpy(v)
                                      for f, v in r.items()}))
    assert got == want


@pytest.mark.parametrize("lam,n_cands", [(0.5, 10), (0.0, 4), (2.0, 6)])
def test_air_skip_fraction_exact(unit_data, shared_trained, lam, n_cands):
    x, _, _ = unit_data
    cents, _ = shared_trained
    xs = np.array(x[:2000])
    want = jassign.air_skip_fraction(jnp.asarray(xs), cents, lam=lam,
                                     n_cands=n_cands, chunk=512)
    got = air_skip_fraction(torch.from_numpy(xs),
                            torch.from_numpy(np.array(cents)), lam=lam,
                            n_cands=n_cands, chunk=512)
    assert got == want


@pytest.mark.parametrize("block", [1, 8, 32])
def test_cell_stats_and_large_cells_exact(rairs_index, block):
    a = rairs_index.assigns
    want = jseil.cell_stats(a)["cell_sizes"]
    got = cell_stats(a)["cell_sizes"]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (vectors_in_large_cells(a, block)
            == jseil.vectors_in_large_cells(a, block))
