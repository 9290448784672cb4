"""The port's dense (product) scoring path against the reference's, on
the CPU.

For the five layouts of ``tests/test_dense.py`` at nprobe 3 and 9: DCO
and ``scanned_blocks`` bitwise; ids equal, or at most 2 apart on rows
where the reference's own exact distances put the 10th and 11th within
an f32 tie (1e-5 relative); distances within rtol=atol=1e-5;
``make_dense_aux``'s arrays bitwise.  Within the port, as in
``test_dense.py``: dense against the blocked search with a budget that
drops no block, and the nprobe sweep against single runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexConfig as JConfig
from repro.core import build_index as j_build
from repro.core.dense import dense_search as j_dense
from repro.core.dense import make_dense_aux as j_make_aux
from repro_torch.convert import index_from_numpy
from repro_torch.core import (SearchParams, dense_search, dense_search_multi,
                              make_dense_aux)

SEIL = ("block_codes", "block_ids", "block_other", "owned", "refs",
        "refs_other", "misc")
LAYOUTS = [("single", False), ("naive", False), ("rair", False),
           ("rair", True), ("srair", True)]
AUX = ("dec", "dec_norm2", "ids", "other", "block_l1", "block_l2")
TOL = dict(rtol=1e-5, atol=1e-5)
TIE_REL = 1e-5
_BUILT = {}


def carry(j):
    arrays = {f: np.asarray(getattr(j.arrays, f)) for f in SEIL}
    arrays.update(centroids=np.asarray(j.centroids),
                  codebooks=np.asarray(j.codebook.codebooks),
                  vectors=np.asarray(j.vectors), assigns=j.assigns,
                  codes=j.codes)
    return index_from_numpy(dataclasses.asdict(j.config), arrays,
                            device="cpu")


def layout(unit_data, shared_trained, strategy, seil):
    """(reference index, port index) of one layout, built once."""
    key = (strategy, seil)
    if key not in _BUILT:
        x, _, _ = unit_data
        cents, cb = shared_trained
        j = j_build(jax.random.PRNGKey(0), x,
                    JConfig(nlist=64, strategy=strategy, seil=seil),
                    centroids=cents, codebook=cb)
        _BUILT[key] = (j, carry(j))
    return _BUILT[key]


def tie_rows(jidx, q, nprobe):
    """Rows whose reference top-11 exact distances put the 10th and 11th
    within an f32 tie."""
    d = np.asarray(j_dense(jidx, q, nprobe=nprobe, k=11).dists)
    gap = np.abs(d[:, 10] - d[:, 9])
    return np.nonzero(gap <= TIE_REL * np.maximum(np.abs(d[:, 10]), 1e-30))[0]


@pytest.mark.parametrize("nprobe", [3, 9])
@pytest.mark.parametrize("strategy,seil", LAYOUTS)
def test_dense_matches_reference(unit_data, shared_trained, strategy, seil,
                                 nprobe):
    _, q, _ = unit_data
    jidx, tidx = layout(unit_data, shared_trained, strategy, seil)
    qs = np.array(q[:24])
    want = j_dense(jidx, jnp.asarray(qs), nprobe=nprobe, k=10)
    got = dense_search(tidx, torch.from_numpy(qs), nprobe=nprobe, k=10)
    for f in ("approx_dco", "refine_dco", "scanned_blocks", "dropped_blocks"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    gi, wi = got.ids.numpy(), np.asarray(want.ids)
    differ = np.nonzero((gi != wi).any(axis=1))[0]
    ties = tie_rows(jidx, jnp.asarray(qs), nprobe)
    assert set(differ) <= set(ties), (differ, ties)
    for r in differ:
        a, b = set(gi[r][gi[r] >= 0].tolist()), set(wi[r][wi[r] >= 0].tolist())
        assert len(a ^ b) <= 2, (r, a ^ b)
    same = np.setdiff1d(np.arange(len(qs)), differ)
    np.testing.assert_allclose(got.dists.numpy()[same],
                               np.asarray(want.dists)[same], **TOL)


@pytest.mark.parametrize("strategy,seil", LAYOUTS)
def test_make_dense_aux_bitwise(unit_data, shared_trained, strategy, seil):
    jidx, tidx = layout(unit_data, shared_trained, strategy, seil)
    want = j_make_aux(jidx.arrays, jidx.codebook)
    got = make_dense_aux(tidx.arrays, tidx.codebook)
    for f in AUX:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("strategy,seil", LAYOUTS)
def test_dense_equals_blocked(unit_data, shared_trained, strategy, seil):
    """The port's dense path against the port's blocked search (a budget
    that drops no block): DCO equal, ids within the tie-boundary
    tolerance of ``tests/test_dense.py``."""
    _, q, _ = unit_data
    _, tidx = layout(unit_data, shared_trained, strategy, seil)
    qs = torch.from_numpy(np.array(q[:24]))
    for nprobe in (3, 9):
        rb = tidx.searcher(SearchParams(k=10, nprobe=nprobe,
                                        max_scan=100000), device="cpu")(qs)
        rd = dense_search(tidx, qs, nprobe=nprobe, k=10)
        assert int(rb.dropped_blocks.max()) == 0
        for f in ("approx_dco", "refine_dco", "scanned_blocks"):
            assert torch.equal(getattr(rb, f), getattr(rd, f)), f
        gb, gd = rb.ids.numpy(), rd.ids.numpy()
        for i in range(len(qs)):
            a = set(gb[i][gb[i] >= 0].tolist())
            b = set(gd[i][gd[i] >= 0].tolist())
            assert len(a ^ b) <= 2, (i, a ^ b)


def test_dense_multi_matches_single(rairs_index, unit_data):
    _, q, _ = unit_data
    tidx = carry(rairs_index)
    qs = torch.from_numpy(np.array(q[:16]))
    multi = dense_search_multi(tidx, qs, nprobes=(2, 8), k=10)
    assert tidx._dense_aux is not None           # kept on the index
    for p, r in zip((2, 8), multi):
        single = dense_search(tidx, qs, nprobe=p, k=10)
        for f in r._fields:
            assert torch.equal(getattr(r, f), getattr(single, f)), f


def test_dense_chunking_is_invisible(rairs_index, unit_data):
    """Chunks of 5 queries answer like one chunk of 24: every stage is
    per query."""
    _, q, _ = unit_data
    tidx = carry(rairs_index)
    qs = np.array(q[:24])
    a = dense_search(tidx, qs, nprobe=6, k=10, chunk=5)
    b = dense_search(tidx, torch.from_numpy(qs), nprobe=6, k=10)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
