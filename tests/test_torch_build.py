"""The port's build path against the reference, fed the same numpy inputs.

JAX random streams cannot be matched in torch, so k-means starts from a
given initialisation and the assignment / encoding stages take the
reference's trained centroids and codebook.  Argmin stages may break a
float near-tie the other way, so they must agree on >= 99.9% of rows;
``build_seil`` is bitwise given the same assignments and codes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assign as jassign
from repro.core import ground_truth as j_gt
from repro.core.kmeans import _kmeans_loop as j_kmeans_loop
from repro.core.pq import pq_encode as j_encode
from repro.core.seil import build_seil as j_build_seil
from repro.data import make_dataset as j_dataset
from repro_torch.core import (IndexConfig, PQCodebook, build_index,
                              build_seil, ground_truth, recall_at_k)
from repro_torch.core import assign as tassign
from repro_torch.core.kmeans import assign_nearest, kmeans_loop
from repro_torch.core.pq import pq_encode
from repro_torch.data import DATASETS, make_dataset
from repro_torch.quant import pack_nibbles, packed_width, unpack_nibbles


def t(a):
    return torch.from_numpy(np.array(a))


def test_kmeans_loop_from_given_init(unit_data):
    x, _, _ = unit_data
    xn = np.asarray(x[:3000])
    init = xn[np.random.default_rng(0).choice(3000, 32, replace=False)]
    want = np.asarray(j_kmeans_loop(jnp.asarray(xn), jnp.asarray(init), 32,
                                    3, 16384))
    got = kmeans_loop(t(xn), t(init), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    a = assign_nearest(t(xn), t(want)).numpy()
    b = np.asarray(jax.numpy.argmin(
        ((xn[:, None, :] - want[None]) ** 2).sum(-1), axis=1))
    assert (a == b).mean() >= 0.999


def test_pq_encode_agrees(rairs_index, unit_data):
    x, _, _ = unit_data
    cb = np.asarray(rairs_index.codebook.codebooks)
    want = np.asarray(j_encode(rairs_index.codebook, x))
    got = pq_encode(PQCodebook(t(cb)), t(x)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (got == want).all(axis=1).mean() >= 0.999


@pytest.mark.parametrize("strategy", ["single", "naive", "soar", "rair",
                                      "srair"])
def test_assignment_strategies_agree(rairs_index, unit_data, strategy):
    x, _, _ = unit_data
    c = np.asarray(rairs_index.centroids)
    cfg = IndexConfig(nlist=64, strategy=strategy)
    want = jassign.get_strategy(strategy)(x, jnp.asarray(c), cfg)
    got = tassign.get_strategy(strategy)(t(x), t(c), cfg)
    assert got.shape == want.shape
    assert (got == want).all(axis=1).mean() >= 0.999
    assert set(tassign.available_strategies()) >= {
        "single", "naive", "soar", "rair", "srair"}


@pytest.mark.parametrize("shared", [True, False])
def test_build_seil_bitwise(rairs_index, shared):
    assigns = rairs_index.assigns
    codes = rairs_index.codes
    ids = np.arange(len(codes), dtype=np.int32)
    jarr, jstats = j_build_seil(assigns, codes, ids, 64, block=32,
                                shared=shared)
    tarr, tstats = build_seil(assigns, codes, ids, 64, block=32,
                              shared=shared, device="cpu")
    for f in dataclasses.fields(tarr):
        np.testing.assert_array_equal(getattr(tarr, f.name).numpy(),
                                      np.asarray(getattr(jarr, f.name)),
                                      err_msg=f.name)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)


def test_build_seil_with_full_shared_blocks():
    """Cells of >= one block exercise owned/refs (the unit index has few)."""
    rng = np.random.default_rng(4)
    n, nlist = 900, 6
    assigns = np.sort(rng.integers(0, nlist, (n, 2)), axis=1).astype(np.int32)
    codes = rng.integers(0, 16, (n, 8)).astype(np.uint8)
    ids = rng.permutation(n).astype(np.int32)
    jarr, jstats = j_build_seil(assigns, codes, ids, nlist, block=16)
    tarr, tstats = build_seil(assigns, codes, ids, nlist, block=16,
                              device="cpu")
    assert jstats.n_ref_entries > 0
    for f in dataclasses.fields(tarr):
        np.testing.assert_array_equal(getattr(tarr, f.name).numpy(),
                                      np.asarray(getattr(jarr, f.name)),
                                      err_msg=f.name)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)


def test_build_index_with_reference_training(rairs_index, unit_data):
    """The port's build given the reference's centroids and codebook
    lands within a hair of the reference's layout, and serves."""
    x, q, gt = unit_data
    cfg = IndexConfig(nlist=64, strategy="rair", seil=True)
    idx = build_index(t(x), cfg, centroids=t(rairs_index.centroids),
                      codebook=PQCodebook(t(rairs_index.codebook.codebooks)),
                      device="cpu")
    assert (idx.assigns == rairs_index.assigns).all(axis=1).mean() >= 0.999
    assert (idx.codes == rairs_index.codes).all(axis=1).mean() >= 0.999
    assert set(idx.build_seconds) == {"train", "assign", "encode", "layout"}
    res = idx.search(t(q[:100]), k=10, nprobe=8, device="cpu")
    assert recall_at_k(res.ids, gt[:100]) >= 0.8


def test_build_index_trains_itself(unit_data):
    x, q, gt = unit_data
    cfg = IndexConfig(nlist=32, kmeans_iters=4, pq_iters=3)
    idx = build_index(t(x), cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    again = build_index(t(x), cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert torch.equal(idx.centroids, again.centroids)
    res = idx.searcher(nprobe=8, device="cpu")(t(q[:100]))
    assert recall_at_k(res.ids, gt[:100]) >= 0.8
    # multi_m=3 (m-assignment, once refused) builds: three distinct lists
    # per vector, each copy stored, as the reference lays them out
    multi = build_index(t(x[:500]), IndexConfig(nlist=16, multi_m=3),
                        device="cpu")
    assert multi.assigns.shape == (500, 3)
    assert (np.diff(multi.assigns, axis=1) > 0).all()
    want = jassign.rair_assign_multi(x[:500], jnp.asarray(
        multi.centroids.numpy()), m=3, aggr="max", n_cands=10)
    assert (multi.assigns == np.asarray(want)).all(axis=1).mean() >= 0.99
    jarr, _ = j_build_seil(multi.assigns, multi.codes,
                           np.arange(500, dtype=np.int32), 16, shared=False)
    np.testing.assert_array_equal(multi.arrays.block_ids.numpy(),
                                  np.asarray(jarr.block_ids))


def test_index_config_validation():
    for bad in (dict(strategy="nope"), dict(metric="cos"), dict(nbits=9),
                dict(block=0), dict(n_cands=1), dict(lam=-1.0)):
        with pytest.raises(ValueError):
            IndexConfig(**bad)


def test_make_dataset_matches_reference_distribution():
    x, q, spec = make_dataset("unit", 0, device="cpu")
    jx, jq, jspec = j_dataset("unit")
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert spec == DATASETS["unit"]
    assert x.shape == tuple(jx.shape) and q.shape == tuple(jq.shape)
    assert x.dtype == torch.float32
    x2, _, _ = make_dataset("unit", 0, device="cpu")
    assert torch.equal(x, x2)
    for a, b in ((x.numpy(), np.asarray(jx)), (q.numpy(), np.asarray(jq))):
        assert abs(a.std() - b.std()) < 0.15 * b.std()
        assert np.abs(a.mean(0)).mean() < 3 * np.abs(b.mean(0)).mean() + 0.1
    xi, qi, _ = make_dataset("unit_ip", 0, device="cpu", n=1000,
                             n_queries=50)
    assert xi.shape == (1000, 32) and qi.shape == (50, 32)
    assert torch.isfinite(xi).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ground_truth_matches_reference(unit_data, metric):
    x, q, _ = unit_data
    want = j_gt(x, q[:64], 10, metric=metric)
    got = ground_truth(t(x), t(q[:64]), 10, metric=metric, device="cpu")
    assert got.dtype == np.int32 and got.shape == want.shape
    assert recall_at_k(got, want) >= 0.999


def test_nibbles_roundtrip_and_reference_layout():
    from repro.quant.nibbles import pack_nibbles as j_pack
    rng = np.random.default_rng(0)
    for m in (1, 7, 16):
        codes = rng.integers(0, 16, (5, m)).astype(np.uint8)
        packed = pack_nibbles(codes)
        np.testing.assert_array_equal(packed, j_pack(codes))
        assert packed.shape[-1] == packed_width(m)
        np.testing.assert_array_equal(
            unpack_nibbles(t(packed), m).numpy(), codes.astype(np.int32))
    with pytest.raises(ValueError):
        pack_nibbles(np.array([[16]], np.uint8))
