"""The two-tier search (quantization ladder) against the reference.

Planes: the binary codec is closed form in numpy on the host in both
packages, so codec, codes and packed block codes are bitwise; the pq4
codec is trained with each package's own random stream, so the port
is given the reference's codec (``index.plane("pq4", codec=...)``) and
its codes and block codes are then bitwise.  ``plane_block_codes`` is
bitwise for any code width, odd Mc included.

Sessions: a port ``Searcher`` with ``refine=RefineParams(plane, rf)``
against a JAX ``Searcher`` on the same index, planes and queries, in
the three exec modes, fused off and on, rf 1 / 2 / 4: ids, DCO counters
and ``compile_stats()`` exact, distances at rtol=atol=1e-5 (the exact
re-rank reduces over D in another order).  Plan reuse with a plane is
held the same way, over two batches.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RefineParams as JRefine
from repro.core import SearchParams as JParams
from repro.core.searcher import Searcher as JSearcher
from repro.quant import plane as jplane
from repro_torch.convert import index_from_numpy
from repro_torch.core import RefineParams, SearchParams, Searcher
from repro_torch.core.pq import PQCodebook
from repro_torch.quant import (PLANE_BACKENDS, build_plane, compact_subdim,
                               encode_plane, plane_block_codes, train_plane)

TOL = dict(rtol=1e-5, atol=1e-5)
BUNDLE_FIELDS = ("block_codes", "block_ids", "block_other", "owned", "refs",
                 "refs_other", "misc")
MODES = ("paged", "grouped", "clustered")
RESULT_INTS = ("ids", "approx_dco", "refine_dco", "scanned_blocks",
               "dropped_blocks")


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jidx(rairs_index):
    """The shared unit index, copied so that its planes and sessions
    stay in this module."""
    return dataclasses.replace(rairs_index)


@pytest.fixture(scope="module")
def tidx(jidx):
    """The reference's index carried across, the pq4 plane with the
    reference's codec."""
    arrays = {f: np.asarray(getattr(jidx.arrays, f)) for f in BUNDLE_FIELDS}
    arrays.update(centroids=np.asarray(jidx.centroids),
                  codebooks=np.asarray(jidx.codebook.codebooks),
                  vectors=np.asarray(jidx.vectors), assigns=jidx.assigns,
                  codes=jidx.codes)
    idx = index_from_numpy(dataclasses.asdict(jidx.config), arrays,
                           device="cpu")
    idx.plane("pq4", codec=PQCodebook(t(jidx.plane("pq4").codec.codebooks)))
    idx.plane("binary")
    return idx


def _assert_planes_equal(tp, jp):
    np.testing.assert_array_equal(tp.codec.codebooks.numpy(),
                                  np.asarray(jp.codec.codebooks))
    np.testing.assert_array_equal(tp.codes, np.asarray(jp.codes))
    np.testing.assert_array_equal(tp.block_codes.numpy(),
                                  np.asarray(jp.block_codes))
    assert (tp.m, tp.ksub, tp.bytes_per_item) == (jp.m, jp.ksub,
                                                  jp.bytes_per_item)


@pytest.mark.parametrize("backend", PLANE_BACKENDS)
def test_planes_bitwise(tidx, jidx, backend):
    """binary: codec, codes and block codes bitwise from the same
    vectors; pq4: codes and block codes bitwise given the codec."""
    tp, jp = tidx.plane(backend), jidx.plane(backend)
    _assert_planes_equal(tp, jp)
    assert tp.block_codes.dtype == torch.uint8 and tp.codes.dtype == np.uint8
    assert tidx.plane(backend) is tp                 # cached per backend


def test_pq4_plane_trains_its_own_codec(jidx, unit_data):
    x, _, _ = unit_data
    ids = t(jidx.arrays.block_ids)
    a = build_plane("pq4", t(x), ids, iters=3,
                    generator=torch.Generator().manual_seed(3))
    b = build_plane("pq4", t(x), ids, iters=3,
                    generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.codec.codebooks, b.codec.codebooks)
    assert a.m == x.shape[1] // compact_subdim(x.shape[1]) == 4
    assert a.ksub == 16 and int(a.codes.max()) < 16
    np.testing.assert_array_equal(a.block_codes.numpy(), np.asarray(
        jplane.plane_block_codes(a.codes, np.asarray(ids))))


@pytest.mark.parametrize("d", [12, 20, 32])
def test_odd_mc_planes_bitwise(d):
    """d 12 and 20 give odd Mc (3 and 5) in both backends: the packed
    width rounds up and the phantom hi nibble is zero."""
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((300, d)) * 2 + 1).astype(np.float32)
    codec = train_plane("binary", t(x))
    want = jplane.train_plane("binary", None, x)
    np.testing.assert_array_equal(codec.codebooks.numpy(),
                                  np.asarray(want.codebooks))
    codes = encode_plane(codec, t(x))
    np.testing.assert_array_equal(codes, jplane.encode_plane(want, x))
    ids = np.where(rng.random((12, 8)) < 0.8,
                   rng.integers(0, 300, (12, 8)), -1).astype(np.int32)
    got = plane_block_codes(codes, t(ids))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jplane.plane_block_codes(codes, ids)))
    assert got.shape == (12, 8, (codes.shape[1] + 1) // 2)
    assert compact_subdim(d) == jplane.compact_subdim(d)
    pq = rng.integers(0, 16, (300, d // compact_subdim(d))).astype(np.uint8)
    np.testing.assert_array_equal(
        plane_block_codes(pq, t(ids)).numpy(),
        np.asarray(jplane.plane_block_codes(pq, ids)))


def test_plane_rejects_unknown_backend(tidx):
    with pytest.raises(ValueError, match="plane backend"):
        tidx.plane("opq")
    with pytest.raises(ValueError, match="plane backend"):
        train_plane("opq", torch.zeros((4, 8)))


def _compare_sessions(tidx, jidx, params_kw, batches):
    """A fresh port session and a fresh JAX session over ``batches``:
    ids and counters exact, distances at TOL, compile_stats exact."""
    refine = params_kw.pop("refine", None)
    tp = SearchParams(**params_kw, refine=None if refine is None
                      else RefineParams(*refine))
    jp = JParams(**params_kw, refine=None if refine is None
                 else JRefine(*refine))
    ts, js = Searcher(tidx, tp), JSearcher(jidx, jp)
    for q in batches:
        got, want = ts(t(q)), js(jnp.asarray(q))
        for f in RESULT_INTS:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                                   **TOL)
    assert ts.compile_stats() == js.compile_stats()
    assert ts.params.bigk_eff == js.params.bigk_eff
    assert ts.params.active_plane == js.params.active_plane
    return got


@pytest.mark.parametrize("rf", [1, 2, 4])
@pytest.mark.parametrize("plane", PLANE_BACKENDS)
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_two_tier_sessions_match_reference(tidx, jidx, unit_data, mode,
                                           fused, plane, rf):
    _, q, _ = unit_data
    q = np.asarray(q)
    _compare_sessions(tidx, jidx, dict(k=10, nprobe=8, k_factor=4,
                                       exec_mode=mode, fused_topk=fused,
                                       refine=(plane, rf)),
                      [q[:40]])


@pytest.mark.parametrize("plane", PLANE_BACKENDS)
def test_refine_factor_one_is_the_plain_session(tidx, unit_data, plane):
    _, q, _ = unit_data
    qs = t(q[:32])
    for fused in (False, True):
        plain = Searcher(tidx, SearchParams(k=10, nprobe=8,
                                            fused_topk=fused))(qs)
        rf1 = Searcher(tidx, SearchParams(
            k=10, nprobe=8, fused_topk=fused,
            refine=RefineParams(plane, 1)))(qs)
        full = Searcher(tidx, SearchParams(
            k=10, nprobe=8, k_factor=40, fused_topk=fused))(qs)
        wide = Searcher(tidx, SearchParams(
            k=10, nprobe=8, fused_topk=fused,
            refine=RefineParams("full", 4)))(qs)
        for f in plain._fields:
            assert torch.equal(getattr(rf1, f), getattr(plain, f)), f
            assert torch.equal(getattr(wide, f), getattr(full, f)), f


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", ["grouped", "clustered"])
def test_two_tier_plan_reuse_matches_reference(tidx, jidx, unit_data, mode,
                                               fused):
    _, q, _ = unit_data
    q = np.asarray(q)
    _compare_sessions(tidx, jidx, dict(k=10, nprobe=8, k_factor=4,
                                       exec_mode=mode, fused_topk=fused,
                                       plan_reuse=True,
                                       refine=("pq4", 4)),
                      [q[:32], q[8:40], q[:32]])


def test_two_tier_scans_the_plane(tidx, unit_data):
    """A two-tier session scans the packed plane (fewer code bytes per
    item) and re-ranks bigk_eff survivors; its tier-1 DCO equals the
    single-tier one's (same plan), its refine DCO is wider."""
    _, q, _ = unit_data
    qs = t(q[:32])
    plain = Searcher(tidx, SearchParams(k=10, nprobe=8, k_factor=4))(qs)
    s = Searcher(tidx, SearchParams(k=10, nprobe=8, k_factor=4,
                                    refine=RefineParams("binary", 4)))
    two = s(qs)
    assert s._packed and s._arrays.block_codes is tidx.plane(
        "binary").block_codes
    assert s._codebook is tidx.plane("binary").codec
    assert torch.equal(two.approx_dco, plain.approx_dco)
    assert bool((two.refine_dco >= plain.refine_dco).all())
    assert int(two.refine_dco.sum()) > int(plain.refine_dco.sum())
