"""Streaming bundles across both packages, on the CPU (3 of 3).

A ``StreamingIndex`` saved by either package (one file or shards, with
and without compact planes) loads in the other as a ``StreamingIndex``
whose base arrays, epoch / version, tombstones, delta segment and
carried plane codecs equal the saved one's, and whose searches equal
the saved stream's (ids and DCO exact, distances at rtol=atol=1e-5
across packages, bitwise within the port).  Also the streaming bundle
tests of ``test_stream.py`` and ``test_plan.py`` (a restored routed
stream).  The golden v2 / v4 bundles are held in
``tests/test_torch_io.py``.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import IndexConfig as JConfig
from repro.core import RefineParams as JRefine
from repro.core import SearchParams as JParams
from repro.core import StreamConfig as JStreamConfig
from repro.core import StreamingIndex as JStream
from repro.core import build_index as j_build
from repro.core import load_index as j_load
from repro.core import save_index as j_save
from repro_torch.convert import index_from_numpy
from repro_torch.core import (RairsIndex, RefineParams, SearchParams,
                              StreamConfig, StreamingIndex, load_index,
                              save_index)
from repro_torch.core.pq import PQCodebook

SEIL = ("block_codes", "block_ids", "block_other", "owned", "refs",
        "refs_other", "misc")
INTS = ("ids", "approx_dco", "refine_dco", "scanned_blocks",
        "dropped_blocks")
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = dict(device="cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def _host(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def carry(j):
    arrays = {f: np.asarray(getattr(j.arrays, f)) for f in SEIL}
    arrays.update(centroids=np.asarray(j.centroids),
                  codebooks=np.asarray(j.codebook.codebooks),
                  vectors=np.asarray(j.vectors), assigns=j.assigns,
                  codes=j.codes)
    return index_from_numpy(dataclasses.asdict(j.config), arrays, **CPU)


def assert_same(got, want, msg=""):
    for f in INTS:
        np.testing.assert_array_equal(_host(getattr(got, f)),
                                      _host(getattr(want, f)),
                                      err_msg=msg + f)
    np.testing.assert_allclose(_host(got.dists), _host(want.dists),
                               err_msg=msg + "dists", **TOL)


def assert_identical(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def assert_same_stream(a, b):
    """Two streams of either package: base arrays, epoch state, delta
    segment and carried plane codecs equal, dtypes included."""
    assert type(a).__name__ == type(b).__name__ == "StreamingIndex"
    assert (a.epoch, a.version, a.n_live, a.n_delta, a.n_dead) == (
        b.epoch, b.version, b.n_live, b.n_delta, b.n_dead)
    assert dataclasses.asdict(a.stream_config) == dataclasses.asdict(
        b.stream_config)
    pairs = [(getattr(a.base.arrays, f), getattr(b.base.arrays, f), f)
             for f in SEIL]
    pairs += [(a.base.vectors, b.base.vectors, "vectors"),
              (a.base.assigns, b.base.assigns, "assigns"),
              (a.base.codes, b.base.codes, "codes"),
              (a.live_mask(), b.live_mask(), "live"),
              (a.assigns, b.assigns, "all assigns")]
    for name in ("vectors", "codes", "assigns", "live", "post", "post_n"):
        pairs.append((getattr(a._delta, name), getattr(b._delta, name),
                      f"delta {name}"))
    assert sorted(a._plane_codecs) == sorted(b._plane_codecs)
    for name in a._plane_codecs:
        pairs.append((a._plane_codecs[name].codebooks,
                      b._plane_codecs[name].codebooks, f"codec {name}"))
    for x, y, name in pairs:
        x, y = _host(x), _host(y)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _search(st, q, **kw):
    """One fresh session of either package's stream on ``q`` (numpy)."""
    ref = kw.pop("refine", None)
    if isinstance(st, StreamingIndex):
        p = SearchParams(**kw, refine=ref and RefineParams(*ref))
        return st.searcher(p, **CPU)(q)
    p = JParams(**kw, refine=ref and JRefine(*ref))
    return st.searcher(p)(q)


@pytest.fixture()
def streams(unit_data, shared_trained):
    """A mutated stream in both packages (routed from the first insert,
    both planes attached, the port's pq4 with the reference's codec)."""
    x, _, _ = unit_data
    cents, cb = shared_trained
    cfg = JConfig(nlist=64, strategy="rair", seil=True, delta_route_min=0)
    j = j_build(jax.random.PRNGKey(0), x[:5000], cfg, centroids=cents,
                codebook=cb)
    js = JStream(j, JStreamConfig(delta_pad=128))
    ts = StreamingIndex(carry(j), StreamConfig(delta_pad=128))
    ts.plane("pq4", codec=PQCodebook(t(js.plane("pq4").codec.codebooks)))
    for st in (ts, js):
        st.plane("binary")
        st.insert(np.asarray(x[5000:5300]))
        st.delete([7, 17, 5003, 5005])
    assert_same_stream(ts, js)
    return ts, js


@pytest.mark.parametrize("shards", [None, 3])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stream_bundles_cross_both_ways(streams, unit_data, tmp_path,
                                        shards, writer):
    _, q, _ = unit_data
    ts, js = streams
    path = tmp_path / "stream"
    if writer == "port":
        save_index(ts, path, shards=shards)
    else:
        j_save(js, path, shards=shards)
    tl, jl = load_index(path, **CPU), j_load(path)
    assert isinstance(tl, StreamingIndex) and isinstance(jl, JStream)
    assert_same_stream(tl, ts)
    assert_same_stream(jl, js)
    qs = np.asarray(q[:24])
    for ref in (None, ("binary", 4), ("pq4", 2)):
        for mode in ("paged", "clustered"):
            kw = dict(k=10, nprobe=8, exec_mode=mode, fused_topk=True,
                      refine=ref)
            got = _search(tl, qs, **dict(kw))
            assert_identical(got, _search(ts, qs, **dict(kw)))
            assert_same(got, _search(jl, q[:24], **dict(kw)))
    # the restored streams keep mutating alike
    x = np.asarray(unit_data[0])
    for st in (tl, jl):
        st.insert(x[5300:5400])
        st.delete([8, 5301])
    assert_same_stream(tl, jl)
    assert_same(_search(tl, qs, k=10, nprobe=8),
                _search(jl, q[:24], k=10, nprobe=8))


def test_streaming_bundle_roundtrip(unit_data, shared_trained, tmp_path):
    """``test_stream.py::test_streaming_bundle_roundtrip`` in the port."""
    x, q, _ = unit_data
    cents, cb = shared_trained
    j = j_build(jax.random.PRNGKey(0), x[:5000],
                JConfig(nlist=64, strategy="rair", seil=True),
                centroids=cents, codebook=cb)
    stream = StreamingIndex(carry(j), StreamConfig(delta_pad=128))
    stream.insert(np.asarray(x[5000:5200]))
    stream.delete([7, 5003])
    path = os.path.join(tmp_path, "stream.npz")
    save_index(stream, path, extra={"dataset": "unit"})
    restored = load_index(path, **CPU)
    assert isinstance(restored, StreamingIndex)
    assert restored.epoch == stream.epoch
    assert restored.version == stream.version
    assert restored.n_live == stream.n_live
    assert restored.n_delta == stream.n_delta
    assert restored.stream_config == stream.stream_config
    qs = np.asarray(q[:32])
    assert_identical(stream.search(qs, k=10, nprobe=8, **CPU),
                     restored.search(qs, k=10, nprobe=8, **CPU))
    restored.insert(np.asarray(x[5200:5250]))
    assert restored.n_live == stream.n_live + 50


def test_v1_bundle_still_loads(unit_data, shared_trained, tmp_path):
    """A v1 bundle is v2 without the streaming section: a RairsIndex."""
    x, q, _ = unit_data
    cents, cb = shared_trained
    j = j_build(jax.random.PRNGKey(0), x[:5000],
                JConfig(nlist=64, strategy="rair", seil=True),
                centroids=cents, codebook=cb)
    idx = carry(j)
    path = os.path.join(tmp_path, "v2.npz")
    save_index(idx, path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["meta_json"].tobytes()).decode())
    assert meta["format_version"] == 5 and "streaming" not in meta
    meta["format_version"] = 1
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    v1 = os.path.join(tmp_path, "v1.npz")
    with open(v1, "wb") as f:
        np.savez(f, **arrays)
    restored = load_index(v1, **CPU)
    assert isinstance(restored, RairsIndex)
    qs = np.asarray(q[:16])
    assert_identical(idx.search(qs, k=10, nprobe=8, **CPU),
                     restored.search(qs, k=10, nprobe=8, **CPU))


def test_routed_postings_follow_restore(unit_data, shared_trained,
                                        tmp_path):
    """``test_plan.py``'s restored routed stream: the postings are
    rebuilt on load and it searches like the stream in memory."""
    x, q, _ = unit_data
    cents, cb = shared_trained
    cfg = JConfig(nlist=64, strategy="rair", seil=True, kmeans_iters=8,
                  pq_iters=6, delta_route_min=0)
    j = j_build(jax.random.PRNGKey(0), x[:5000], cfg, centroids=cents,
                codebook=cb)
    st, js = StreamingIndex(carry(j)), JStream(j)
    for s in (st, js):
        s.insert(np.asarray(x[5000:5300]))
        s.delete([5005, 17])
    path = os.path.join(tmp_path, "routed.npz")
    save_index(st, path)
    restored = load_index(path, **CPU)
    assert restored.delta_routed
    np.testing.assert_array_equal(restored._delta.post, js._delta.post)
    qs = np.asarray(q[:24])
    r = restored.search(qs, k=10, nprobe=8, **CPU)
    assert_identical(st.search(qs, k=10, nprobe=8, **CPU), r)
    assert_same(r, js.search(q[:24], k=10, nprobe=8))
