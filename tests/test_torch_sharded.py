"""Sharding in the port against the reference, on the CPU.

A ``ShardedIndex`` over a one-shard mesh is bitwise the port's plain
``Searcher`` and agrees with the reference's ``index.shard`` on a
one-device mesh (ids and DCO counters exact, distances at
rtol=atol=1e-5), in the three exec modes, fused off and on, the dedup
(``srair``, no SEIL) layout and the pq4 plane.

Four shards are held against the reference at four devices: a module
fixture runs the reference in a subprocess on a 4-virtual-device CPU mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, ~15-30 s),
which builds the ``unit`` index and a stream, serves them sharded four
ways and writes the index arrays and the answers to an npz; the port
carries the same arrays across and must give the same ids and counters,
frozen and streaming (below the routing threshold), the same
``derived_max_scan_local`` at 1, 2 and 4 shards and ``kmeans_step_sharded``
within rtol 1e-5.  Also here: the session protocol (caches, the shared
placement, ``StaleSessionError``, the refusals), the traced split, a
gateway over a ``ShardedIndex``, v3 bundles across both packages with
``mesh=`` and ``distributed_search``.  (The serve CLI is in
``tests/test_torch_serve_cli.py``.)
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import IndexConfig as JConfig
from repro.core import RefineParams as JRefine
from repro.core import SearchParams as JParams
from repro.core import build_index as j_build
from repro.core import load_index as j_load
from repro.core import save_index as j_save
from repro_torch import obs
from repro_torch.convert import index_from_numpy
from repro_torch.core import (Mesh, RefineParams, SearchParams, Searcher,
                              ShardedIndex, ShardedSearcher,
                              StaleSessionError, distributed_search,
                              kmeans_step_sharded, load_index, make_mesh,
                              save_index)
from repro_torch.core.pq import PQCodebook
from repro_torch.gateway import Gateway, GatewayConfig

ROOT = Path(__file__).resolve().parents[1]
SEIL = ("block_codes", "block_ids", "block_other", "owned", "refs",
        "refs_other", "misc")
NAMES = SEIL + ("centroids", "codebooks", "vectors", "assigns", "codes")
INTS = ("ids", "approx_dco", "refine_dco", "scanned_blocks",
        "dropped_blocks")
MODES = ("paged", "grouped", "clustered")
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = dict(device="cpu")


def carry(j, **cfg):
    """A reference ``RairsIndex`` (or its dumped arrays, with the config
    fields that differ from ``cfg``) as the port's, on the CPU."""
    if isinstance(j, dict):
        config = dict(nlist=64, kmeans_iters=8, pq_iters=6, **cfg)
        return index_from_numpy(config, j, **CPU)
    arrays = {f: np.asarray(getattr(j.arrays, f)) for f in SEIL}
    arrays.update(centroids=np.asarray(j.centroids),
                  codebooks=np.asarray(j.codebook.codebooks),
                  vectors=np.asarray(j.vectors), assigns=j.assigns,
                  codes=j.codes)
    return index_from_numpy(dataclasses.asdict(j.config), arrays, **CPU)


def assert_same(got, want, msg=""):
    """A port result against a reference one (or its dumped arrays)."""
    def get(f):
        return (want[f] if isinstance(want, dict)
                else np.asarray(getattr(want, f)))
    for f in INTS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), get(f),
                                      err_msg=msg + f)
    np.testing.assert_allclose(got.dists.numpy(), get("dists"),
                               err_msg=msg + "dists", **TOL)


def assert_identical(a, b):
    """Two port results bitwise."""
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def assert_mesh_contract(got, want):
    """The reference's multi-device contract: every counter exact,
    sorted distances exact, the same id set per query."""
    for f in INTS[1:]:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.dists.sort(dim=1).values,
                       want.dists.sort(dim=1).values)
    for a, b in zip(got.ids.numpy(), want.ids.numpy()):
        assert set(a[a >= 0]) == set(b[b >= 0])


@pytest.fixture(scope="module")
def jidx(rairs_index):
    """The shared unit index, copied so its planes and sessions stay in
    this module."""
    return dataclasses.replace(rairs_index)


@pytest.fixture(scope="module")
def tidx(jidx):
    idx = carry(jidx)
    idx.plane("pq4", codec=PQCodebook(torch.from_numpy(
        np.array(jidx.plane("pq4").codec.codebooks))))
    return idx


@pytest.fixture(scope="module")
def qs(unit_data):
    return np.asarray(unit_data[1][:32])


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1,), ("data",))


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(1, **CPU)


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh(4, **CPU)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
def test_make_mesh_and_axes():
    m = make_mesh(4, **CPU)
    assert m.devices == (torch.device("cpu"),) * 4
    assert m.shape == {"data": 4} and m.size == 4
    assert m == make_mesh(4, **CPU) and hash(m) == hash(make_mesh(4, **CPU))
    assert m != make_mesh(2, **CPU)
    assert make_mesh(device="cpu").size == 1
    grid = Mesh(["cpu"] * 6, ("x", "y"), shape=(2, 3))
    assert grid.shape == {"x": 2, "y": 3}
    assert len(grid.shard_devices(("x", "y"))) == 6
    assert len(grid.shard_devices(("y",))) == 3
    assert len(grid.shard_devices(("y", "x"))) == 6
    with pytest.raises(ValueError, match="no axis"):
        grid.shard_devices(("model",))
    with pytest.raises(ValueError, match="cannot have shape"):
        Mesh(["cpu"] * 4, ("x", "y"), shape=(3, 2))
    with pytest.raises(ValueError, match="n >= 1"):
        make_mesh(0, **CPU)


def test_make_mesh_round_robin_over_cards(monkeypatch):
    """n shards go round-robin over the visible cards (four on one card
    share it); nothing touches a card here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = make_mesh(5)
    assert [d.index for d in m.devices] == [0, 1, 0, 1, 0]
    assert make_mesh().size == 2
    assert set(make_mesh(3, device="cuda:1").devices) == {
        torch.device("cuda", 1)}


def test_mesh_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tidx):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tidx.shard(make_mesh(4))
    assert tidx.shard(make_mesh(4, **CPU)).ndev == 4


def test_shard_refusals(tidx, mesh4):
    with pytest.raises(TypeError, match="Mesh"):
        tidx.shard(None)
    with pytest.raises(ValueError, match="no axis 'model'"):
        tidx.shard(mesh4, axes=("model",))
    with pytest.raises(TypeError, match="already a ShardedIndex"):
        ShardedIndex(tidx.shard(mesh4), mesh4)
    with pytest.raises(TypeError, match="streaming base"):
        tidx.shard(mesh4).insert(np.zeros((1, 32), np.float32))
    with pytest.raises(TypeError, match="streaming base"):
        tidx.shard(mesh4).delete([0])
    with pytest.raises(ValueError, match="plan_reuse"):
        tidx.shard(mesh4).searcher(SearchParams(
            k=10, nprobe=8, exec_mode="grouped", plan_reuse=True))
    with pytest.raises(ValueError, match="answers on cpu"):
        tidx.shard(mesh4).searcher(SearchParams(k=10), device="meta")


# ---------------------------------------------------------------------------
# one shard: bitwise the plain session, and the reference's 1-device mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_one_shard_is_the_plain_session(tidx, jidx, jmesh, mesh1, qs, mode,
                                        fused):
    p = dict(k=10, nprobe=8, exec_mode=mode, fused_topk=fused)
    got = tidx.shard(mesh1).searcher(SearchParams(**p))(qs)
    assert_identical(got, Searcher(tidx, SearchParams(**p))(qs))
    assert_same(got, jidx.shard(jmesh).searcher(JParams(**p))(qs))


def test_one_shard_dedup_layout(jidx, unit_data, shared_trained, jmesh,
                                mesh1, mesh4, qs):
    """A duplicated (no-SEIL) layout dedups across the gathered stream."""
    x = unit_data[0]
    cents, cb = shared_trained
    jdup = j_build(jax.random.PRNGKey(0), x,
                   JConfig(nlist=64, strategy="srair", seil=False,
                           kmeans_iters=8, pq_iters=6),
                   centroids=cents, codebook=cb)
    tdup = carry(jdup)
    p = dict(k=10, nprobe=8, max_scan=4096)
    got = tdup.shard(mesh1).searcher(SearchParams(**p))(qs)
    assert_identical(got, Searcher(tdup, SearchParams(**p))(qs))
    assert_same(got, jdup.shard(jmesh).searcher(JParams(**p))(qs))
    got4 = tdup.shard(mesh4).searcher(SearchParams(**p))(qs)
    for row in got4.ids.numpy():
        row = row[row >= 0]
        assert len(row) == len(set(row)), "duplicate id in sharded top-k"


@pytest.mark.parametrize("fused", [False, True])
def test_one_shard_pq4_plane(tidx, jidx, jmesh, mesh1, qs, fused):
    """The two-tier search on the mesh scans the plane's packed block
    rows with its codec; one shard is the plain two-tier session."""
    p = dict(k=10, nprobe=8, fused_topk=fused)
    got = tidx.shard(mesh1).searcher(SearchParams(
        **p, refine=RefineParams("pq4", 4)))(qs)
    assert_identical(got, Searcher(tidx, SearchParams(
        **p, refine=RefineParams("pq4", 4)))(qs))
    assert_same(got, jidx.shard(jmesh).searcher(JParams(
        **p, refine=JRefine("pq4", 4)))(qs))
    assert_mesh_contract(tidx.shard(make_mesh(4, **CPU)).searcher(
        SearchParams(**p, refine=RefineParams("pq4", 4)))(qs), got)


# ---------------------------------------------------------------------------
# four shards against the reference at four devices (subprocess)
# ---------------------------------------------------------------------------
_REF4 = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import IndexConfig, SearchParams, build_index
from repro.core.kmeans import kmeans_step_sharded
from repro.data import make_dataset
from repro.dist import shard_map
assert len(jax.devices()) == 4, jax.devices()
SEIL = ("block_codes", "block_ids", "block_other", "owned", "refs",
        "refs_other", "misc")


def mesh(n):
    return jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])


def dump(tag, idx):
    for f in SEIL:
        out[f"{tag}/{f}"] = np.asarray(getattr(idx.arrays, f))
    out[f"{tag}/centroids"] = np.asarray(idx.centroids)
    out[f"{tag}/codebooks"] = np.asarray(idx.codebook.codebooks)
    out[f"{tag}/vectors"] = np.asarray(idx.vectors)
    out[f"{tag}/assigns"] = np.asarray(idx.assigns)
    out[f"{tag}/codes"] = np.asarray(idx.codes)


def answer(tag, r):
    for f in r._fields:
        out[f"{tag}/{f}"] = np.asarray(getattr(r, f))


x, q, _ = make_dataset("unit")
q = np.asarray(q[:32])
out = {"q": q, "x": np.asarray(x)}
cfg = IndexConfig(nlist=64, strategy="rair", seil=True, kmeans_iters=8,
                  pq_iters=6)
idx = build_index(jax.random.PRNGKey(0), x, cfg)
dump("frozen", idx)
m4 = mesh(4)
for mode in ("paged", "grouped", "clustered"):
    for fused in (0, 1):
        p = SearchParams(k=10, nprobe=8, exec_mode=mode, fused_topk=bool(fused))
        answer(f"frozen/{mode}/{fused}", idx.shard(m4).searcher(p)(q))
for n in (1, 2, 4):
    for nprobe in (4, 8, 16):
        out[f"budget/{n}/{nprobe}"] = np.int64(
            idx.shard(mesh(n)).derived_max_scan_local(nprobe))
dup = build_index(jax.random.PRNGKey(0), x,
                  IndexConfig(nlist=64, strategy="srair", seil=False,
                              kmeans_iters=8, pq_iters=6),
                  centroids=idx.centroids, codebook=idx.codebook)
dump("dup", dup)
answer("dup/paged", dup.shard(m4).searcher(
    SearchParams(k=10, nprobe=8, max_scan=4096))(q))
base = build_index(jax.random.PRNGKey(0), x[:5600], cfg)
dump("base", base)
st = base.streaming()
ids = st.insert(x[5600:5900])
st.delete(ids[:80])
st.delete(np.arange(40))
for mode in ("paged", "grouped", "clustered"):
    for fused in (0, 1):
        p = SearchParams(k=10, nprobe=8, exec_mode=mode, fused_topk=bool(fused))
        answer(f"stream/{mode}/{fused}", st.shard(m4).searcher(p)(q))
step = jax.jit(shard_map(
    lambda xl, c: kmeans_step_sharded(xl, c, axis_names=("data",)),
    mesh=m4, in_specs=(P("data"), P()), out_specs=P()))
out["kmeans"] = np.asarray(step(jnp.asarray(x), idx.centroids))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref4(tmp_path_factory):
    """The reference at four virtual CPU devices, run in a subprocess
    (a process sees its device count from XLA_FLAGS at start-up): the
    dumped arrays and answers."""
    path = tmp_path_factory.mktemp("ref4") / "ref4.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", _REF4, str(path)], env=env,
                   check=True, timeout=600)
    z = np.load(path)
    return {name: z[name] for name in z.files}


def _arrays(ref, tag):
    return {n: ref[f"{tag}/{n}"] for n in NAMES}


def _answer(ref, tag):
    return {f: ref[f"{tag}/{f}"] for f in INTS + ("dists",)}


@pytest.fixture(scope="module")
def port4(ref4):
    """The port's index and stream from the subprocess's arrays, the
    stream mutated as the subprocess mutated its own."""
    idx = carry(_arrays(ref4, "frozen"))
    stream = carry(_arrays(ref4, "base")).streaming()
    x = ref4["x"]
    ids = stream.insert(x[5600:5900])
    stream.delete(ids[:80])
    stream.delete(np.arange(40))
    return idx, stream


@pytest.mark.parametrize("fused", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_four_shards_match_the_reference_at_four_devices(ref4, port4, mode,
                                                         fused):
    idx, _ = port4
    p = SearchParams(k=10, nprobe=8, exec_mode=mode, fused_topk=bool(fused))
    got = idx.shard(make_mesh(4, **CPU)).searcher(p)(ref4["q"])
    assert_same(got, _answer(ref4, f"frozen/{mode}/{fused}"))


@pytest.mark.parametrize("fused", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_four_shard_stream_matches_the_reference(ref4, port4, mode, fused):
    """Inserts below the routing threshold (the exhaustive delta scan),
    deletes in base and delta: each delta slot owned by one shard."""
    _, stream = port4
    assert not stream.delta_routed
    p = SearchParams(k=10, nprobe=8, exec_mode=mode, fused_topk=bool(fused))
    got = stream.shard(make_mesh(4, **CPU)).searcher(p)(ref4["q"])
    assert_same(got, _answer(ref4, f"stream/{mode}/{fused}"))


def test_four_shard_dedup_layout_matches_the_reference(ref4):
    dup = carry(_arrays(ref4, "dup"), strategy="srair", seil=False)
    got = dup.shard(make_mesh(4, **CPU)).searcher(
        SearchParams(k=10, nprobe=8, max_scan=4096))(ref4["q"])
    assert_same(got, _answer(ref4, "dup/paged"))


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_derived_max_scan_local_matches_the_reference(ref4, port4, ndev):
    idx, _ = port4
    sh = idx.shard(make_mesh(ndev, **CPU))
    for nprobe in (4, 8, 16):
        assert sh.derived_max_scan_local(nprobe) == int(
            ref4[f"budget/{ndev}/{nprobe}"]), nprobe


def test_kmeans_step_sharded_matches_the_reference(ref4):
    x = torch.from_numpy(ref4["x"])
    c = torch.from_numpy(ref4["frozen/centroids"])
    got = kmeans_step_sharded(list(x.chunk(4)), c)
    np.testing.assert_allclose(got.numpy(), ref4["kmeans"], rtol=1e-5,
                               atol=0)
    # one shard is the plain Lloyd step; an empty cluster keeps its place
    far = torch.cat([c, torch.full((1, c.shape[1]), 1e6)])
    one = kmeans_step_sharded([x], far)
    assert torch.equal(one[-1], far[-1])
    np.testing.assert_allclose(one[:-1].numpy(), ref4["kmeans"], rtol=1e-5,
                               atol=0)


# ---------------------------------------------------------------------------
# the session protocol
# ---------------------------------------------------------------------------
def test_sharded_session_protocol(tidx, mesh4, qs):
    sharded = tidx.shard(mesh4)
    assert isinstance(sharded, ShardedIndex)
    assert tidx.shard(mesh4) is sharded                  # cached per mesh
    assert tidx.shard(make_mesh(4, **CPU)) is sharded    # equal meshes
    view = tidx.shard(mesh4, max_scan_local=64)
    assert view is not sharded
    assert view._placement is sharded._placement         # placed once
    params = SearchParams(k=5, nprobe=4, batch_buckets=(16, 64))
    s1 = sharded.searcher(params)
    assert isinstance(s1, ShardedSearcher)
    assert sharded.searcher(params) is s1                # cached per params
    r = s1(qs[:23])
    assert r.ids.shape == (23, 5) and s1.stats.padded_rows > 0
    s1(qs[:23])
    assert s1.stats.cache_hits > 0
    st = sharded.searcher_stats()
    assert st["ndev"] == 4 and st["compiles"] >= 1
    assert sharded.device == torch.device("cpu")
    assert sharded.searcher(params, device="cpu") is s1
    r2 = sharded.search(qs[:8], k=5, nprobe=4)
    assert r2.ids.shape == (8, 5)
    assert view.searcher(params).max_scan_local == 64


def _stream(unit_data):
    x = np.asarray(unit_data[0])
    base = carry(j_build(jax.random.PRNGKey(0), x[:5600],
                         JConfig(nlist=64, strategy="rair", seil=True,
                                 kmeans_iters=8, pq_iters=6)))
    return base.streaming(), x


@pytest.mark.parametrize("ndev", [1, 4])
def test_streaming_on_a_mesh_matches_the_stream(unit_data, qs, ndev):
    """insert -> delete -> compact through the sharded view: the same
    answers as the stream's own session (bitwise on one shard; with four,
    ids and counters, the derived budget never truncating here), the base
    placed once per epoch, no deleted id served."""
    stream, x = _stream(unit_data)
    sharded = stream.shard(make_mesh(ndev, **CPU))
    params = SearchParams(k=10, nprobe=8)

    def check():
        want = stream.searcher(params, **CPU)(qs)
        got = sharded.searcher(params)(qs)
        if ndev == 1:
            assert_identical(got, want)
        else:
            assert_mesh_contract(got, want)
    check()
    base_placed = sharded._placement.base
    ids = sharded.insert(x[-400:-100])
    assert np.array_equal(ids, np.arange(stream.n_base, stream.n_base + 300))
    sharded.delete(ids[:80])
    sharded.delete(np.arange(40))
    assert stream.n_dead == 120
    check()
    assert sharded._placement.base is base_placed   # per epoch, not version
    got = sharded.searcher(params)(qs).ids.numpy()
    dead = set(ids[:80].tolist()) | set(range(40))
    assert not set(got[got >= 0].tolist()) & dead
    info = sharded.compact()
    assert info["epoch"] == 1
    sharded.searcher(params)
    assert sharded._placement.base is not base_placed
    check()
    assert sharded.version == stream.version


def test_streaming_mesh_sessions_pin_the_version(unit_data, qs, mesh4):
    stream, x = _stream(unit_data)
    sharded = stream.shard(mesh4)
    params = SearchParams(k=5, nprobe=4)
    sess = sharded.searcher(params)
    sess(qs[:8])
    sharded.insert(x[-50:])
    with pytest.raises(StaleSessionError, match="re-fetch"):
        sess(qs[:8])
    fresh = sharded.searcher(params)
    assert fresh is not sess
    fresh(qs[:8])
    assert sharded.searcher_stats()["invalidations"] == 1
    # steady churn inside one capacity bucket shares the executables, and
    # the placed state reads the mirrors patched in place
    before = sharded.searcher_stats()["compiles"]
    state = sharded._placement.state
    for _ in range(3):
        sharded.insert(x[-8:])
        assert_mesh_contract(sharded.searcher(params)(qs[:8]),
                             stream.searcher(params, **CPU)(qs[:8]))
    assert sharded.searcher_stats()["compiles"] == before
    assert sharded._placement.state is state


def test_traced_split_is_the_untraced_step(tidx, mesh4, qs):
    """While a tracer is active a batch runs the scan half and the tail
    apart, each in a span with its counters: bitwise the whole step."""
    for fused in (False, True):
        sess = tidx.shard(mesh4).searcher(SearchParams(
            k=10, nprobe=8, exec_mode="clustered", fused_topk=fused))
        plain = sess(qs)
        with obs.trace() as tr:
            traced = sess(qs)
        assert_identical(traced, plain)
        spans = {r["name"]: r["args"] for r in tr.records
                 if r["kind"] == "span"}
        assert spans["stage.shard_scan"]["ndev"] == 4
        assert spans["stage.shard_scan"]["approx_dco"] == int(
            plain.approx_dco.sum())
        assert spans["stage.shard_scan"]["scanned_blocks"] == int(
            plain.scanned_blocks.sum())
        assert spans["stage.gather_finalize"]["refine_dco"] == int(
            plain.refine_dco.sum())


def test_gateway_over_a_sharded_index(tidx, mesh4, qs):
    """The gateway serves a ShardedIndex through its sessions: the same
    answers as the direct session (one flush of the whole burst)."""
    sharded = tidx.shard(mesh4)
    params = SearchParams(k=10, nprobe=8, fused_topk=True)
    want = sharded.searcher(params)(qs)
    cfg = GatewayConfig(max_batch=32, max_delay_ms=2000.0)
    with Gateway(sharded, params, config=cfg) as gw:
        reqs = [gw.submit(q) for q in qs]
        got = [r.result(60) for r in reqs]
    np.testing.assert_array_equal(np.stack([g.ids for g in got]),
                                  want.ids.numpy())
    assert gw.stats()["telemetry"]["counters"]["responses"] == len(qs)


def test_distributed_search_compat(tidx, mesh4, qs):
    res_c = distributed_search(tidx, mesh4, qs, nprobe=8, k=10,
                               max_scan_local=4096)
    res_s = tidx.shard(mesh4, max_scan_local=4096).searcher(
        SearchParams(k=10, nprobe=8))(qs)
    assert_identical(res_c, res_s)
    res_p = distributed_search(tidx, mesh4, qs,
                               params=SearchParams(k=10, nprobe=4),
                               nprobe=8, max_scan_local=4096)
    assert torch.equal(res_p.ids, res_c.ids)
    with pytest.raises(ValueError, match="max_scan"):
        distributed_search(tidx, mesh4, qs, params=SearchParams(
            k=10, nprobe=8, max_scan=4096))
    with pytest.raises(TypeError, match="nprobe= and k="):
        distributed_search(tidx, mesh4, qs, nprobe=8)


# ---------------------------------------------------------------------------
# bundles with mesh=
# ---------------------------------------------------------------------------
def test_v3_bundles_across_packages_and_mesh_sizes(tidx, jidx, jmesh, qs,
                                                   tmp_path):
    """A 4-shard port ShardedIndex saves v3 with four bundle shards; it
    loads onto a 2-shard mesh and in the reference; a reference 4-shard
    bundle loads onto the port's 4-shard mesh: the same answers."""
    p = SearchParams(k=10, nprobe=8, exec_mode="grouped", fused_topk=True)
    want = tidx.shard(make_mesh(4, **CPU)).searcher(p)(qs)
    save_index(tidx.shard(make_mesh(4, **CPU)), tmp_path / "t4")
    assert len(list((tmp_path / "t4").glob("shard_*.npz"))) == 4
    two = load_index(tmp_path / "t4", mesh=make_mesh(2, **CPU))
    assert isinstance(two, ShardedIndex) and two.ndev == 2
    assert_identical(two.searcher(p)(qs), want)
    jp = JParams(k=10, nprobe=8, exec_mode="grouped", fused_topk=True)
    jgot = j_load(tmp_path / "t4", mesh=jmesh).searcher(jp)(qs)
    assert_same(want, jgot)
    j_save(jidx, tmp_path / "j4", shards=4)
    four = load_index(tmp_path / "j4", mesh=make_mesh(4, **CPU),
                      max_scan_local=4096)
    assert four.max_scan_local == 4096
    assert_identical(four.searcher(p)(qs), tidx.shard(
        make_mesh(4, **CPU), max_scan_local=4096).searcher(p)(qs))


def test_streaming_bundle_onto_a_mesh(unit_data, qs, tmp_path):
    stream, x = _stream(unit_data)
    ids = stream.insert(x[-300:])
    stream.delete(ids[:50])
    sharded = stream.shard(make_mesh(4, **CPU))
    p = SearchParams(k=10, nprobe=8, fused_topk=True)
    want = sharded.searcher(p)(qs)
    save_index(sharded, tmp_path / "s")
    back = load_index(tmp_path / "s", mesh=make_mesh(2, **CPU))
    assert back.streaming and back.version == stream.version
    assert_identical(back.searcher(p)(qs), want)
