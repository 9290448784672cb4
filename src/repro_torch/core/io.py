"""Index persistence (counterpart of ``repro/core/io.py``): the
reference's bundle formats, so that a bundle written by either package
loads in the other to an index whose searches are bitwise equal.

A bundle holds every array the query path needs (centroids, PQ
codebooks, the SEIL block store and per-list tables, the refine
vectors) and the build state (assignments, PQ codes), with config,
stats and provenance as a JSON document embedded in the npz as a uint8
array (``meta_json``), headed by a format name and version.  Arrays keep
the reference's names and dtypes: f32 floats, int32 ids and lists, uint8
codes.

* v1 / v2: one compressed npz.  v2 may carry a *streaming* section: a
  ``StreamingIndex`` saved without compacting, its base epoch's arrays as
  before plus the delta segment (``delta_vectors`` / ``_codes`` /
  ``_assigns`` / ``_live``), the base tombstones bit-packed
  (``base_live``, ``np.packbits``) and ``epoch`` / ``version`` /
  ``stream_config`` in the meta.  ``save_index`` takes either index
  type and ``load_index`` returns the type the bundle holds (every later
  version carries the section alike; v1 is v2 without it).
* v3: ``save_index(index, path, shards=N)`` writes a directory, a
  ``MANIFEST.json`` plus ``common-<crc>.npz`` (centroids, codebooks,
  per-list tables, planes) and ``shard_NNNN-<crc>.npz`` (block arrays by
  block-id range, vectors / assigns / codes by vector-id range).
* v4: attached compact planes travel as their codec books and per-id
  codes (``plane_<backend>_codebooks`` / ``_codes``); the packed block
  layout is re-derived on load (``quant.plane_block_codes``).
* v5 (what every save writes): each file is written to a temporary name,
  fsynced and renamed into place; sharded members are content-addressed
  and the manifest is committed last, then stale members are swept; the
  meta carries a crc32 of every array, verified on load (after the
  ``io.read_array`` fault site), and a mismatch, a truncated or
  unreadable member, or a missing one raises ``CorruptBundleError``
  naming it.

``load_index(path, device=None)`` rebuilds a ``RairsIndex`` (or a
``StreamingIndex``) on ``device`` (None: CUDA), with ``SeilStats`` from
the meta; a stream's planes come back as its carried codecs.  With
``mesh=`` it returns the loaded index deployed over that mesh
(``loaded.shard(mesh, ...)``, ``core/sharded.py``), loaded on the mesh's
first device unless ``device`` says otherwise; a bundle of any shard
count loads onto a mesh of any size.  ``save_index`` of a
``ShardedIndex`` writes v3 with one bundle shard per mesh shard.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Callable, Optional, Union

import numpy as np
import torch

from .. import faults
from ..device import DeviceLike, resolve_device
from ..errors import CorruptBundleError
from .index import IndexConfig, RairsIndex
from .pq import PQCodebook
from .seil import SEIL_FIELDS, SeilStats, arrays_to_device
from .sharded import ShardedIndex
from .stream.streaming import StreamConfig, StreamingIndex

INDEX_FORMAT = "rairs-index"
INDEX_FORMAT_VERSION = 2          # single-file bundles without planes
SHARDED_FORMAT_VERSION = 3        # manifest + per-shard bundles
PLANE_FORMAT_VERSION = 4          # either layout + attached compact planes
CHECKSUM_FORMAT_VERSION = 5       # atomic writes + per-array crc32 table
READ_FORMAT_VERSIONS = (1, 2, 3, 4, 5)  # v1 = v2 minus the streaming section
MANIFEST_NAME = "MANIFEST.json"

# v3 split of the SEIL arrays: block store shards by block-id range,
# the per-list directory replicates in common.npz
_BLOCK_FIELDS = ("block_codes", "block_ids", "block_other")
_TABLE_FIELDS = ("owned", "refs", "refs_other", "misc")
_VECTOR_FIELDS = ("vectors", "assigns", "codes")   # shard by vector-id range
# a StreamingIndex's epoch state; replicated in common.npz when sharded
_STREAM_FIELDS = ("delta_vectors", "delta_codes", "delta_assigns",
                  "delta_live", "base_live")
# the reference's dtype of every array a frozen bundle holds
_DTYPES = dict(centroids=np.float32, codebooks=np.float32,
               vectors=np.float32, assigns=np.int32, codes=np.uint8,
               block_codes=np.uint8, block_ids=np.int32,
               block_other=np.int32, owned=np.int32, refs=np.int32,
               refs_other=np.int32, misc=np.int32,
               delta_vectors=np.float32, delta_codes=np.uint8,
               delta_assigns=np.int32, delta_live=np.bool_,
               base_live=np.uint8)


def _fsync_dir(dirname: str) -> None:
    """Best-effort directory fsync so the rename itself is durable
    (no-op on platforms/filesystems that refuse O_RDONLY dir opens)."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(path: Union[str, os.PathLike],
                  write: Callable) -> None:
    """Crash-safe file write: temp name in the same directory, fsync,
    then ``os.replace`` into place — readers only ever see the old
    complete file or the new complete file, never a torn one."""
    path = os.fspath(path)
    d = os.path.dirname(path) or "."
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as fh:
            write(fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(d)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _checksums(arrays: dict) -> dict:
    return {name: _crc(a) for name, a in arrays.items()}


def _host(a, dtype) -> np.ndarray:
    """A tensor or array as a contiguous host array of ``dtype``."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype=dtype)


def _gather_arrays(index: Union[RairsIndex, StreamingIndex],
                   extra: Optional[dict]) -> tuple:
    """(meta, arrays) shared by the single-file and sharded writers, in
    the reference's order."""
    stream = index if isinstance(index, StreamingIndex) else None
    index = stream.base if stream is not None else index
    meta = {
        "format": INDEX_FORMAT,
        "format_version": CHECKSUM_FORMAT_VERSION,
        "config": dataclasses.asdict(index.config),
        "stats": dataclasses.asdict(index.stats),
        "build_seconds": dict(index.build_seconds),
        "has_codes": index.codes is not None,
        "extra": dict(extra or {}),
    }
    arrays = {
        "centroids": index.centroids,
        "codebooks": index.codebook.codebooks,
        "vectors": index.vectors,
        "assigns": index.assigns,
    }
    for f in SEIL_FIELDS:
        arrays[f] = getattr(index.arrays, f)
    if index.codes is not None:
        arrays["codes"] = index.codes
    if stream is not None:
        d = stream._delta
        meta["streaming"] = {
            "epoch": stream.epoch,
            "version": stream.version,
            "delta_count": int(d.count),
            "stream_config": dataclasses.asdict(stream.stream_config),
        }
        arrays["delta_vectors"] = d.vectors[:d.count]
        arrays["delta_codes"] = d.codes[:d.count]
        arrays["delta_assigns"] = d.assigns[:d.count]
        arrays["delta_live"] = d.live[:d.count]
        arrays["base_live"] = np.packbits(stream._base_live)
    arrays = {k: _host(a, _DTYPES[k]) for k, a in arrays.items()}
    # quantization-ladder planes (v4+): codec books + per-id codes only;
    # the packed block layout is re-derived on load
    planes = index.__dict__.get("_planes") or {}
    if planes:
        meta["planes"] = sorted(planes)
        for b in sorted(planes):
            pp = planes[b]
            arrays[f"plane_{b}_codebooks"] = _host(pp.codec.codebooks,
                                                   np.float32)
            arrays[f"plane_{b}_codes"] = _host(pp.codes, np.uint8)
    return meta, arrays


def save_index(index, path: Union[str, os.PathLike], extra: dict = None,
               *, shards: Optional[int] = None) -> None:
    """Write ``index`` to ``path`` in format v5.

    Default: one compressed npz bundle at exactly ``path`` (no implicit
    .npz suffix).  With ``shards=N``, or when ``index`` is a
    ``ShardedIndex`` (N defaulting to its shard count), ``path`` becomes
    a directory holding a manifest and per-shard bundles (module
    docstring).  ``extra`` is a JSON-able dict of caller provenance
    readable via ``read_index_meta``.  A ``StreamingIndex`` is saved
    without compacting: its delta segment and tombstones travel as they
    are."""
    if isinstance(index, ShardedIndex):
        shards = shards or index.ndev
        index = index.index
    if not isinstance(index, (RairsIndex, StreamingIndex)):
        raise TypeError(f"save_index takes a RairsIndex, a StreamingIndex "
                        f"or a ShardedIndex, got {type(index)}")
    meta, arrays = _gather_arrays(index, extra)
    if shards is None:
        meta["checksums"] = _checksums(arrays)
        arrays["meta_json"] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), np.uint8)
        _atomic_write(path,
                      lambda fh: np.savez_compressed(fh, **arrays))
        return
    _save_sharded(meta, arrays, path, int(shards))


def _splits(n: int, shards: int):
    """Even [lo, hi) row ranges (np.array_split semantics)."""
    bounds = np.linspace(0, n, shards + 1).astype(np.int64)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(shards)]


def _member_token(checksums: dict) -> str:
    """Short content token for a member file, derived from its arrays'
    crc32 table — two saves of different content never collide on a
    member name, so a crashed save cannot tear a file the committed
    manifest still points at."""
    blob = json.dumps(checksums, sort_keys=True).encode()
    return f"{zlib.crc32(blob):08x}"


def _save_sharded(meta: dict, arrays: dict, path, shards: int) -> None:
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    os.makedirs(path, exist_ok=True)
    tb = arrays["block_ids"].shape[0]
    n = arrays["vectors"].shape[0]
    block_rows = _splits(tb, shards)
    vector_rows = _splits(n, shards)
    shard_files, checksums = [], {}
    for s in range(shards):
        blo, bhi = block_rows[s]
        vlo, vhi = vector_rows[s]
        payload = {f: arrays[f][blo:bhi] for f in _BLOCK_FIELDS}
        for f in _VECTOR_FIELDS:
            if f in arrays:
                payload[f] = arrays[f][vlo:vhi]
        crcs = _checksums(payload)
        fname = f"shard_{s:04d}-{_member_token(crcs)}.npz"
        _atomic_write(os.path.join(path, fname),
                      lambda fh, p=payload: np.savez_compressed(fh, **p))
        shard_files.append(fname)
        checksums[fname] = crcs
    common = {f: arrays[f] for f in ("centroids", "codebooks")}
    for f in _TABLE_FIELDS + _STREAM_FIELDS:
        if f in arrays:
            common[f] = arrays[f]
    # plane payloads are tiny (Mc << M) — they replicate with the tables
    for f in arrays:
        if f.startswith("plane_"):
            common[f] = arrays[f]
    common_crcs = _checksums(common)
    common_name = f"common-{_member_token(common_crcs)}.npz"
    _atomic_write(os.path.join(path, common_name),
                  lambda fh: np.savez_compressed(fh, **common))
    checksums[common_name] = common_crcs
    manifest = {
        "format": INDEX_FORMAT,
        "format_version": CHECKSUM_FORMAT_VERSION,
        "shards": shards,
        "common": common_name,
        "shard_files": shard_files,
        "block_rows": block_rows,
        "vector_rows": vector_rows,
        "checksums": checksums,
        "meta": dict(meta, format_version=CHECKSUM_FORMAT_VERSION),
    }
    # the manifest is the commit point: every member is already durable
    # under a content-addressed name, so atomically replacing the
    # manifest flips the whole bundle old -> new; a crash anywhere
    # before this line leaves the previous bundle fully loadable
    _atomic_write(os.path.join(path, MANIFEST_NAME),
                  lambda fh: fh.write(
                      (json.dumps(manifest, indent=1) + "\n").encode()))
    _sweep_orphans(path, {common_name, *shard_files})


def _sweep_orphans(path, live: set) -> None:
    """Post-commit cleanup: drop member files no manifest references
    any more (left by superseded saves or crashed attempts).  Strictly
    best-effort — the bundle is already committed."""
    try:
        entries = os.listdir(path)
    except OSError:
        return
    for fname in entries:
        if fname in live or not fname.endswith(".npz"):
            continue
        if fname.startswith(("shard_", "common")):
            try:
                os.remove(os.path.join(path, fname))
            except OSError:
                pass


def _manifest_path(path) -> Optional[str]:
    """Resolve `path` to a v3 manifest file, or None for single-file."""
    p = os.fspath(path)
    if os.path.isdir(p):
        return os.path.join(p, MANIFEST_NAME)
    if os.path.basename(p) == MANIFEST_NAME:
        return p
    return None


def _check_meta(path, meta: dict) -> dict:
    if meta.get("format") != INDEX_FORMAT:
        raise ValueError(
            f"{path}: format {meta.get('format')!r} != {INDEX_FORMAT!r}")
    version = meta.get("format_version")
    if version not in READ_FORMAT_VERSIONS:
        raise ValueError(
            f"{path}: unsupported format_version {version} "
            f"(this build reads versions {READ_FORMAT_VERSIONS})")
    return meta


def _load_npz_meta(path, z) -> dict:
    if "meta_json" not in z:
        raise ValueError(f"{path}: not a {INDEX_FORMAT} bundle")
    fname = os.path.basename(os.fspath(path))
    raw = _read_members(fname, z, skip=[k for k in z.files
                                        if k != "meta_json"])
    meta = json.loads(bytes(raw["meta_json"].tobytes()).decode("utf-8"))
    _check_meta(path, meta)
    if meta["format_version"] not in (1, INDEX_FORMAT_VERSION,
                                      PLANE_FORMAT_VERSION,
                                      CHECKSUM_FORMAT_VERSION):
        raise ValueError(
            f"{path}: single-file bundles carry format_version 1, "
            f"{INDEX_FORMAT_VERSION}, {PLANE_FORMAT_VERSION} or "
            f"{CHECKSUM_FORMAT_VERSION}, got "
            f"{meta['format_version']} (v{SHARDED_FORMAT_VERSION} bundles "
            f"are directories with a {MANIFEST_NAME})")
    return meta


def _read_manifest(mpath: str) -> dict:
    if not os.path.exists(mpath):
        raise ValueError(f"{mpath}: sharded bundle has no {MANIFEST_NAME}")
    with open(mpath) as fh:
        manifest = json.load(fh)
    _check_meta(mpath, manifest)
    if manifest.get("format_version") not in (SHARDED_FORMAT_VERSION,
                                              PLANE_FORMAT_VERSION,
                                              CHECKSUM_FORMAT_VERSION):
        raise ValueError(
            f"{mpath}: manifest version "
            f"{manifest.get('format_version')} not in "
            f"({SHARDED_FORMAT_VERSION}, {PLANE_FORMAT_VERSION}, "
            f"{CHECKSUM_FORMAT_VERSION})")
    return manifest


def _open_member(path: str):
    """np.load a bundle member, turning truncation / not-a-zip / torn
    header failures into ``CorruptBundleError`` naming the file."""
    import zipfile
    try:
        return np.load(path, allow_pickle=False)
    except (zipfile.BadZipFile, EOFError, OSError, ValueError) as e:
        if not os.path.exists(path):
            raise CorruptBundleError(
                f"{os.path.basename(path)}: bundle member missing") from e
        raise CorruptBundleError(
            f"{os.path.basename(path)}: unreadable "
            f"({type(e).__name__}: {e})") from e


def _read_members(fname: str, z, skip=()) -> dict:
    """Extract every array from an open npz, turning zip-stream decode
    failures (numpy reads members lazily, so a mid-file bitflip only
    surfaces here, not at ``_open_member``) into ``CorruptBundleError``
    naming the offending ``file:member``."""
    import zipfile
    import zlib
    out = {}
    for name in z.files:
        if name in skip:
            continue
        try:
            out[name] = z[name]
        except (zipfile.BadZipFile, zlib.error, EOFError, OSError,
                ValueError) as e:
            raise CorruptBundleError(
                f"{fname}:{name}: unreadable "
                f"({type(e).__name__}: {e})") from e
    return out


def _verify_members(fname: str, members: dict,
                    checksums: Optional[dict]) -> dict:
    """Apply the fault-injection read hook, then verify each array
    against the bundle's crc32 table (v5; earlier formats have no
    table and skip verification).  Raises ``CorruptBundleError``
    naming the offending ``file:member``."""
    out = {}
    for name, arr in members.items():
        arr = faults.corrupt_array("io.read_array", f"{fname}:{name}", arr)
        if checksums is not None:
            want = checksums.get(name)
            if want is None:
                raise CorruptBundleError(
                    f"{fname}:{name}: member absent from the bundle's "
                    f"checksum table")
            got = _crc(arr)
            if got != want:
                raise CorruptBundleError(
                    f"{fname}:{name}: crc32 mismatch "
                    f"(stored {want:#010x}, computed {got:#010x}) — "
                    f"bundle is truncated or bit-flipped")
        out[name] = arr
    return out


def read_index_meta(path: Union[str, os.PathLike]) -> dict:
    """Read only the JSON metadata of a bundle (config / stats / extra
    provenance) without materializing the arrays.  Works on single-file
    bundles and v3 sharded directories alike."""
    mpath = _manifest_path(path)
    if mpath is not None:
        manifest = _read_manifest(mpath)
        return dict(manifest["meta"], shards=manifest["shards"])
    with _open_member(os.fspath(path)) as z:
        return _load_npz_meta(path, z)


def _index_from(meta: dict, get, device: torch.device
                ) -> Union[RairsIndex, StreamingIndex]:
    """Rebuild the index on ``device`` from meta + an array accessor
    (shared by the single-file and sharded loaders)."""
    from ..quant import PlanePack, plane_block_codes

    def tensor(name, dtype):
        return torch.from_numpy(_host(get(name), dtype)).to(device)
    cfg = IndexConfig(**meta["config"])
    host = {f: _host(get(f), _DTYPES[f]) for f in SEIL_FIELDS}
    index = RairsIndex(
        config=cfg,
        centroids=tensor("centroids", np.float32),
        codebook=PQCodebook(tensor("codebooks", np.float32)),
        arrays=arrays_to_device(host, device),
        vectors=tensor("vectors", np.float32),
        stats=SeilStats(**meta["stats"]),
        assigns=_host(get("assigns"), np.int32),
        codes=_host(get("codes"), np.uint8) if meta["has_codes"] else None,
        build_seconds=dict(meta.get("build_seconds", {})),
    )
    if meta.get("planes"):
        planes = index.__dict__.setdefault("_planes", {})
        for b in meta["planes"]:
            codes = _host(get(f"plane_{b}_codes"), np.uint8)
            planes[b] = PlanePack(
                backend=b,
                codec=PQCodebook(tensor(f"plane_{b}_codebooks", np.float32)),
                codes=codes,
                block_codes=plane_block_codes(codes, host["block_ids"],
                                              device))
    sm = meta.get("streaming")
    if sm is None:
        return index
    stream = StreamingIndex(index, StreamConfig(**sm["stream_config"]))
    if meta.get("planes"):
        # restored codecs are the stream's carried ones: a later
        # compaction re-encodes with them instead of retraining
        stream._plane_codecs.update(
            {b: index._planes[b].codec for b in meta["planes"]})
    stream.restore_state(
        epoch=sm["epoch"], version=sm["version"],
        base_live=np.unpackbits(
            _host(get("base_live"), np.uint8),
            count=index.vectors.shape[0]).astype(bool),
        delta_vectors=_host(get("delta_vectors"), np.float32),
        delta_codes=_host(get("delta_codes"), np.uint8),
        delta_assigns=_host(get("delta_assigns"), np.int32),
        delta_live=_host(get("delta_live"), np.bool_))
    return stream


def _load_sharded(mpath: str, device: torch.device
                  ) -> Union[RairsIndex, StreamingIndex]:
    manifest = _read_manifest(mpath)
    root = os.path.dirname(mpath)
    table = manifest.get("checksums")
    parts = []
    for fname in manifest["shard_files"] + [manifest["common"]]:
        with _open_member(os.path.join(root, fname)) as z:
            members = _verify_members(
                fname, _read_members(fname, z),
                table.get(fname) if table is not None else None)
        parts.append(members)
    common = parts.pop()

    def get(name):
        if name in common:
            return common[name]
        return np.concatenate([p[name] for p in parts], axis=0)

    return _index_from(dict(manifest["meta"]), get, device)


def load_index(path: Union[str, os.PathLike], device: DeviceLike = None,
               *, mesh=None, axes=("data",),
               max_scan_local: Optional[int] = None):
    """Load a bundle written by either package's ``save_index`` (any
    readable version, single file or sharded directory) on ``device``
    (None: CUDA, or with ``mesh`` the mesh's first device): a
    ``RairsIndex``, or a ``StreamingIndex`` (delta segment, tombstones,
    epoch / version restored) when the bundle carries streaming state.
    With ``mesh=`` the loaded index is deployed at once: returns
    ``loaded.shard(mesh, axes=axes, max_scan_local=max_scan_local)``.  A
    corrupt bundle raises ``CorruptBundleError`` naming the member."""
    if device is None and mesh is not None:
        device = mesh.devices[0]
    dev = resolve_device(device)
    mpath = _manifest_path(path)
    if mpath is not None:
        index = _load_sharded(mpath, dev)
    else:
        fname = os.path.basename(os.fspath(path))
        with _open_member(os.fspath(path)) as z:
            meta = _load_npz_meta(path, z)
            members = _verify_members(
                fname, _read_members(fname, z, skip=("meta_json",)),
                meta.get("checksums"))
        index = _index_from(meta, members.__getitem__, dev)
    if mesh is not None:
        return index.shard(mesh, axes=axes, max_scan_local=max_scan_local)
    return index
