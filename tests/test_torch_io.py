"""Persistence across both packages, on the CPU.

Bundles are the port's weight carrier: the machine with the card has no
JAX, so an index the reference wrote reaches the port only as a bundle.
Here a bundle written by either package (one file, or 2 / 3 shards,
with both compact planes) loads in the other: every array bitwise, the
same config, stats and planes, and searches bitwise equal to the
in-memory index of the same package (ids and DCO counters exact across
packages, distances at rtol=atol=1e-5, as in tests/test_torch_search.py).
Corruption (a flipped bit, a truncated or missing member, a checksum
mismatch) raises ``CorruptBundleError`` naming the member, with the
reference's message; ``FaultPlan`` decisions equal the reference's for
the same seed and specs.  The golden streaming bundles (v2, v4) load as
a ``StreamingIndex`` equal to the reference's load, one file or sharded,
and answer alike.
"""
import dataclasses
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro.core import SearchParams as JParams
from repro.core import load_index as j_load
from repro.core import read_index_meta as j_meta
from repro.core import save_index as j_save
from repro.core.searcher import Searcher as JSearcher
from repro.errors import CorruptBundleError as JCorrupt
from repro_torch import faults
from repro_torch.convert import index_from_numpy
from repro_torch.core import (CHECKSUM_FORMAT_VERSION, INDEX_FORMAT,
                              RairsIndex, SearchParams, Searcher, load_index,
                              read_index_meta, save_index)
from repro_torch.core.pq import PQCodebook
from repro_torch.errors import CorruptBundleError, RairsError

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = {v: os.path.join(DATA, f"golden_v{v}.npz") for v in (1, 2, 4)}
SEIL = ("block_codes", "block_ids", "block_other", "owned", "refs",
        "refs_other", "misc")
INTS = ("ids", "approx_dco", "refine_dco", "scanned_blocks",
        "dropped_blocks")
TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jidx(rairs_index):
    """The shared unit index, copied, with both planes attached."""
    idx = dataclasses.replace(rairs_index)
    idx.plane("pq4")
    idx.plane("binary")
    return idx


@pytest.fixture(scope="module")
def tidx(jidx):
    """The same index in the port, its pq4 plane with the reference's
    codec."""
    arrays = {f: np.asarray(getattr(jidx.arrays, f)) for f in SEIL}
    arrays.update(centroids=np.asarray(jidx.centroids),
                  codebooks=np.asarray(jidx.codebook.codebooks),
                  vectors=np.asarray(jidx.vectors), assigns=jidx.assigns,
                  codes=jidx.codes)
    idx = index_from_numpy(dataclasses.asdict(jidx.config), arrays,
                           device="cpu")
    idx.plane("pq4", codec=PQCodebook(t(jidx.plane("pq4").codec.codebooks)))
    idx.plane("binary")
    return idx


def _host(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def assert_same_index(a, b):
    """Every persisted array bitwise (dtype included), config, stats and
    planes equal; either package's index on either side."""
    assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
    pairs = [(a.centroids, b.centroids, "centroids"),
             (a.vectors, b.vectors, "vectors"),
             (a.assigns, b.assigns, "assigns"), (a.codes, b.codes, "codes"),
             (a.codebook.codebooks, b.codebook.codebooks, "codebooks")]
    pairs += [(getattr(a.arrays, f), getattr(b.arrays, f), f) for f in SEIL]
    pa = a.__dict__.get("_planes") or {}
    pb = b.__dict__.get("_planes") or {}
    assert sorted(pa) == sorted(pb)
    for name in pa:
        pairs += [(pa[name].codes, pb[name].codes, f"plane_{name}_codes"),
                  (pa[name].block_codes, pb[name].block_codes,
                   f"plane_{name}_block_codes"),
                  (pa[name].codec.codebooks, pb[name].codec.codebooks,
                   f"plane_{name}_codebooks")]
    for x, y, name in pairs:
        x, y = _host(x), _host(y)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _search(index, q, mode, fused, plane):
    """One fresh session of either package on ``q`` (numpy)."""
    from repro.core import RefineParams as JRefine
    from repro_torch.core import RefineParams
    kw = dict(k=10, nprobe=8, k_factor=4, exec_mode=mode, fused_topk=fused)
    if isinstance(index, RairsIndex):
        p = SearchParams(**kw, refine=plane and RefineParams(plane, 4))
        r = Searcher(index, p)(t(q))
        return {f: getattr(r, f).numpy() for f in r._fields}
    p = JParams(**kw, refine=plane and JRefine(plane, 4))
    r = JSearcher(index, p)(jnp.asarray(q))
    return {f: np.asarray(getattr(r, f)) for f in r._fields}


def _assert_results(got, want, exact):
    for f in INTS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    if exact:
        np.testing.assert_array_equal(got["dists"], want["dists"])
    else:
        np.testing.assert_allclose(got["dists"], want["dists"], **TOL)


def _save(which, index, path, shards):
    kw = {} if shards is None else dict(shards=shards)
    (save_index if which == "port" else j_save)(index, path,
                                                 extra={"by": which}, **kw)


SHARDS = [None, 2, 3]


@pytest.mark.parametrize("shards", SHARDS, ids=["file", "shards2",
                                                "shards3"])
def test_reference_bundle_loads_in_the_port(jidx, tidx, unit_data, tmp_path,
                                            shards):
    path = tmp_path / ("idx.npz" if shards is None else "idx")
    _save("jax", jidx, path, shards)
    got = load_index(path, device="cpu")
    assert isinstance(got, RairsIndex)
    assert_same_index(got, jidx)
    assert_same_index(got, tidx)
    assert read_index_meta(path) == j_meta(path)
    _, q, _ = unit_data
    q = np.asarray(q[:24])
    for mode, fused, plane in (("paged", False, None),
                               ("clustered", True, "pq4"),
                               ("grouped", True, "binary")):
        mine = _search(got, q, mode, fused, plane)
        _assert_results(mine, _search(tidx, q, mode, fused, plane), True)
        _assert_results(mine, _search(jidx, q, mode, fused, plane), False)


@pytest.mark.parametrize("shards", SHARDS, ids=["file", "shards2",
                                                "shards3"])
def test_port_bundle_loads_in_the_reference(jidx, tidx, unit_data, tmp_path,
                                            shards):
    path = tmp_path / ("idx.npz" if shards is None else "idx")
    _save("port", tidx, path, shards)
    got = j_load(path)
    assert_same_index(tidx, got)
    assert_same_index(jidx, got)
    meta = j_meta(path)
    assert meta == read_index_meta(path)
    assert meta["format"] == INDEX_FORMAT
    assert meta["format_version"] == CHECKSUM_FORMAT_VERSION
    assert meta["planes"] == ["binary", "pq4"] and meta["extra"] == {
        "by": "port"}
    _, q, _ = unit_data
    q = np.asarray(q[24:48])
    for mode, fused, plane in (("paged", True, "binary"),
                               ("grouped", False, None),
                               ("clustered", False, "pq4")):
        _assert_results(_search(got, q, mode, fused, plane),
                        _search(jidx, q, mode, fused, plane), True)


def test_both_writers_write_the_same_meta_and_members(jidx, tidx, tmp_path):
    """Same member names, dtypes, shapes and crc32 table; the same meta
    but for the build timings."""
    _save("jax", jidx, tmp_path / "j.npz", None)
    _save("port", tidx, tmp_path / "t.npz", None)
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert zj.files == zt.files
        for name in zj.files:
            if name != "meta_json":
                assert zj[name].dtype == zt[name].dtype, name
                assert zj[name].shape == zt[name].shape, name
        mj = json.loads(bytes(zj["meta_json"]).decode())
        mt = json.loads(bytes(zt["meta_json"]).decode())
    assert list(mj) == list(mt)
    for m in (mj, mt):
        m.pop("build_seconds")
        m["extra"].pop("by")
    assert mj == mt


def test_sharded_save_commits_manifest_last_and_sweeps(tidx, tmp_path):
    path = tmp_path / "idx"
    save_index(tidx, path, shards=3)
    first = sorted(os.listdir(path))
    assert "MANIFEST.json" in first and len(first) == 5
    save_index(tidx, path, shards=2)            # a later, different save
    second = sorted(os.listdir(path))
    assert len(second) == 4                     # stale members swept
    manifest = json.loads((path / "MANIFEST.json").read_text())
    assert manifest["shards"] == 2
    assert set(manifest["shard_files"]) | {manifest["common"],
                                           "MANIFEST.json"} == set(second)
    assert not [f for f in second if ".tmp." in f]
    assert_same_index(load_index(path, device="cpu"), tidx)


def test_failed_write_leaves_no_temporary_file(tidx, tmp_path, monkeypatch):
    def boom(fh, **arrays):
        fh.write(b"partial")
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez_compressed", boom)
    with pytest.raises(OSError, match="disk full"):
        save_index(tidx, tmp_path / "idx.npz")
    assert os.listdir(tmp_path) == []
    monkeypatch.undo()
    save_index(tidx, tmp_path / "idx.npz")
    assert os.listdir(tmp_path) == ["idx.npz"]


def _both_raise(path, plan=None):
    """The port's and the reference's load of ``path`` under ``plan`` (a
    (seed, specs) pair): both CorruptBundleError, the same message."""
    msgs = []
    for load, mod, exc in ((lambda: load_index(path, device="cpu"), faults,
                            CorruptBundleError),
                           (lambda: j_load(path), jfaults, JCorrupt)):
        if plan is not None:
            seed, specs = plan
            mod.install(mod.FaultPlan(seed, tuple(
                mod.FaultSpec(*s) for s in specs)))
        try:
            with pytest.raises(exc) as info:
                load()
        finally:
            mod.clear()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    return msgs[0]


@pytest.mark.parametrize("kind", ["bitflip", "truncate"])
@pytest.mark.parametrize("at", [0, 3, 9])
def test_fault_site_corruption_names_the_member(tidx, tmp_path, kind, at):
    path = tmp_path / "idx.npz"
    save_index(tidx, path)
    msg = _both_raise(path, (7, [("io.read_array", kind, (at,))]))
    with np.load(path) as z:
        member = [f for f in z.files if f != "meta_json"][at]
    assert msg.startswith(f"idx.npz:{member}: crc32 mismatch")


def test_sharded_corruption_and_missing_member(tidx, tmp_path):
    path = tmp_path / "idx"
    save_index(tidx, path, shards=2)
    manifest = json.loads((path / "MANIFEST.json").read_text())
    shard = manifest["shard_files"][1]
    # the fifth array read is the first shard's assigns
    msg = _both_raise(path, (3, [("io.read_array", "bitflip", (4,))]))
    assert msg.startswith(f"{manifest['shard_files'][0]}:assigns: crc32 "
                          "mismatch")
    os.remove(path / shard)
    msg = _both_raise(path)
    assert msg == f"{shard}: bundle member missing"


def test_truncated_and_bit_flipped_files(tidx, tmp_path):
    path = tmp_path / "idx.npz"
    save_index(tidx, path)
    raw = path.read_bytes()
    cut = tmp_path / "cut.npz"
    cut.write_bytes(raw[:len(raw) // 2])
    assert _both_raise(cut).startswith("cut.npz: unreadable")
    # a flipped bit inside the largest member's compressed stream
    with np.load(path) as z:
        names = z.files
    flipped = tmp_path / "flip.npz"
    data = bytearray(raw)
    off = raw.index(b"vectors.npy") + 200
    data[off] ^= 0x10
    flipped.write_bytes(bytes(data))
    msg = _both_raise(flipped)
    assert msg.split(":")[0] == "flip.npz"
    assert any(f"flip.npz:{n}:" in msg for n in names)
    assert issubclass(CorruptBundleError, (RairsError, ValueError))


def test_golden_v1_answers_as_the_reference_load(tmp_path):
    got = load_index(GOLDEN[1], device="cpu")
    want = j_load(GOLDEN[1])
    assert_same_index(got, want)
    meta = read_index_meta(GOLDEN[1])
    assert meta == j_meta(GOLDEN[1]) and meta["format_version"] == 1
    q = np.asarray(want.vectors)[:8] + 0.01
    for mode in ("paged", "grouped", "clustered"):
        for fused in (False, True):
            kw = dict(k=5, nprobe=2, exec_mode=mode, fused_topk=fused)
            a = Searcher(got, SearchParams(**kw))(t(q))
            b = JSearcher(want, JParams(**kw))(jnp.asarray(q))
            _assert_results({f: getattr(a, f).numpy() for f in a._fields},
                            {f: np.asarray(getattr(b, f))
                             for f in b._fields}, False)
    # a resave by the port reloads to the same index in both packages
    save_index(got, tmp_path / "v5.npz")
    assert_same_index(load_index(tmp_path / "v5.npz", device="cpu"), got)
    assert_same_index(j_load(tmp_path / "v5.npz"), want)


@pytest.mark.parametrize("version", [2, 4])
def test_streaming_bundles_load_as_the_reference_load(version, tmp_path):
    """golden_v2 / golden_v4 (a StreamingIndex with a delta segment and
    tombstones; v4 with both planes), one file and resaved as 2 shards:
    the same base, epoch state, delta and carried codecs as the
    reference's load, and the same answers in the six modes (and on
    each plane)."""
    from repro.core import RefineParams as JRefine
    from repro_torch.core import RefineParams, StreamingIndex
    path = GOLDEN[version]
    meta = read_index_meta(path)
    assert meta == j_meta(path) and meta["streaming"]["delta_count"] == 12
    out = tmp_path / "sharded"
    j_save(j_load(path), out, shards=2)
    for src in (path, out):
        got, want = load_index(src, device="cpu"), j_load(src)
        assert isinstance(got, StreamingIndex)
        assert_same_index(got.base, want.base)
        assert (got.epoch, got.version, got.n_live, got.n_delta) == (
            want.epoch, want.version, want.n_live, want.n_delta)
        assert dataclasses.asdict(got.stream_config) == dataclasses.asdict(
            want.stream_config)
        np.testing.assert_array_equal(got.live_mask(), want.live_mask())
        for name in ("vectors", "codes", "assigns", "post", "post_n"):
            np.testing.assert_array_equal(getattr(got._delta, name),
                                          getattr(want._delta, name))
        assert sorted(got._plane_codecs) == sorted(want._plane_codecs)
        q = np.asarray(want.vectors)[-8:] + 0.01
        for mode in ("paged", "grouped", "clustered"):
            for fused in (False, True):
                for plane in [None] + sorted(got._plane_codecs):
                    kw = dict(k=5, nprobe=2, exec_mode=mode,
                              fused_topk=fused)
                    a = got.searcher(SearchParams(
                        **kw, refine=plane and RefineParams(plane, 2)),
                        device="cpu")(t(q))
                    b = want.searcher(JParams(
                        **kw, refine=plane and JRefine(plane, 2)))(
                        jnp.asarray(q))
                    _assert_results(
                        {f: getattr(a, f).numpy() for f in a._fields},
                        {f: np.asarray(getattr(b, f)) for f in b._fields},
                        False)
        # a resave by the port reloads alike in both packages
        save_index(got, tmp_path / "resaved.npz")
        again = j_load(tmp_path / "resaved.npz")
        assert_same_index(again.base, want.base)
        np.testing.assert_array_equal(again.live_mask(), want.live_mask())


def test_unknown_versions_and_foreign_files_raise(tidx, tmp_path):
    out = tmp_path / "sharded"
    save_index(tidx, out, shards=2)
    mpath = out / "MANIFEST.json"
    manifest = json.loads(mpath.read_text())
    manifest["format_version"] = 99
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="format_version"):
        load_index(out, device="cpu")
    np.savez(tmp_path / "other.npz", a=np.zeros(3))
    with pytest.raises(ValueError, match="not a rairs-index bundle"):
        load_index(tmp_path / "other.npz", device="cpu")
    shutil.rmtree(out)
    with pytest.raises(TypeError):
        save_index({"not": "an index"}, tmp_path / "x.npz")


def test_load_index_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_index(GOLDEN[1])


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_fault_plan_decisions_match_the_reference(seed):
    specs = (("gateway.dispatch", "raise", (), 0.3),
             ("gateway.dispatch", "delay", (1, 4), 0.0, 0.0, 2),
             ("io.read_array", "bitflip", (), 0.5),
             ("io.read_array", "truncate", (2,)))
    mine = faults.FaultPlan(seed, tuple(faults.FaultSpec(*s)
                                        for s in specs))
    ref = jfaults.FaultPlan(seed, tuple(jfaults.FaultSpec(*s)
                                        for s in specs))
    sites = ["gateway.dispatch", "io.read_array", "gateway.fold"] * 20
    for site in sites:
        a, b = mine.visit(site), ref.visit(site)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.site, a.kind, a.at) == (b.site, b.kind, b.at)
    assert mine.fired() == ref.fired()
    for site in set(sites):
        assert mine.visits(site) == ref.visits(site)
    arr = np.arange(40, dtype=np.int32).reshape(8, 5)
    for mod in (faults, jfaults):
        mod.install(mod.FaultPlan(seed, (mod.FaultSpec(
            "io.read_array", "bitflip", prob=0.5),)))
    try:
        outs = []
        for mod in (faults, jfaults):
            outs.append([mod.corrupt_array("io.read_array", f"m{i}", arr)
                         for i in range(10)])
    finally:
        faults.clear()
        jfaults.clear()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="fault kind"):
        faults.FaultSpec("io.read_array", kind="melt")
