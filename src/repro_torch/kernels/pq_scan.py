"""Wrappers of the CUDA scan kernels (K1, K3 and its merge, the row
select, the stream's routed delta scan), the paged entry (K2) and the PQ
encode.

Each wrapper takes its plain version (``ref.py``) only for tensors on
the CPU.  For CUDA tensors it checks dtype, shape and contiguity,
launches its kernel on PyTorch's current stream, raises on any launch
error, and adds one to its ``launches`` counter.  There is no fallback
from kernel to plain version on the card.
"""
from __future__ import annotations

import functools

import torch

from . import build
from .ref import (merge_topk_ref, pq_encode_plain, pq_scan_tiled_ref,
                  pq_scan_topk_ref, routed_delta_topk, scan_rows_ref,
                  select_topk_ref)
from .topk import pow2_ceil

SMEM_LIMIT = 232448        # bytes of shared memory a Hopper block may use
_MAX_GRID_Y = 65535
TOPK_THREADS = 256         # threads of a K3 scan CTA (NT in pq_scan_topk.cu)
_MIN_ROUNDS = 4            # rounds of TOPK_THREADS items a K3 split scans
_FINE_SPLITS = 8           # splits a tile from which K3 takes two waves
MAX_QUERY_TILE = 64        # K3 keeps a group's queries in 64-bit masks
K1_THREADS = 256           # threads of a K1 CTA (NT in pq_scan.cu)
_K1_TARGET_CTAS = 8 * 132  # two waves and more of K1 CTAs on the H100
_K1_MIN_ITEMS = 4 * K1_THREADS   # items a K1 CTA scores at least
K1_MAX_POSITIONS = 1024    # tile_idx entries a K1 CTA stages (pq_scan.cu)
# K1's forms, numbered as pq_scan.cu's enum Form
K1_FORMS = ("generic", "fast", "packed", "staged", "k256")
# K3's forms: tables in shared memory, a CTA a query at K 256 with its
# table staged through shared memory by range (GT), candidate rows (GS), a
# CTA a query at K 256 with its table in shared memory (k256), and tables
# read from global memory through __ldg (GT-ldg: the shapes GT does not take)
K3_FORMS = ("shared", "GT", "GS", "k256", "GT-ldg")
# K1's staged form (pq_scan.cu's SQ and IPT): at most 8 queries a launch,
# their sums carried in registers; 8 items a thread, so a CTA scores a pass
# of 8 x K1_THREADS items against each range of the tables it stages
K1_STAGED_QUERIES = 8
K1_STAGED_PASS = 8 * K1_THREADS
_K1_STAGED_TARGET = 2 * 132  # staged CTAs: about two an SM on the H100
# The delta scan's form bits (csrc/delta_scan_topk.cu's F_*): the table read
# from global memory, the rank_of row staged in shared memory, kept triples
# appended to candidate rows (no selection state in shared memory); tried
# in this order, the table kept in shared memory before the rank row
DELTA_GT, DELTA_RANK, DELTA_GS = 1, 2, 4
_DELTA_ORDER = tuple(gs | gt | rank for gs in (0, DELTA_GS)
                     for gt in (0, DELTA_GT) for rank in (DELTA_RANK, 0))
# its forms by name, indexed by the GT and GS bits
DELTA_FORMS = ("shared", "GT", "GS", "GT-GS")
ENCODE_TILE = 32           # rows a PQ-encode CTA takes at a time (pq_encode.cu)
# shared memory of a PQ-encode CTA where its books allow: four CTAs an SM,
# 32 warps, to hide the latency of each centroid's dependent steps
ENCODE_SMEM = SMEM_LIMIT // 4


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
             device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device:
        raise ValueError(f"{name}: want {dtype} with {ndim} dims on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class QueryGroups(list):
    """The query groups of a tile, ``[(q0, q1), ...]``, one launch each,
    and the kernel form they run: ``global_tables`` is True when the
    launches read the tables from global memory (one query's tables alone
    do not fit in a CTA's shared memory), ``global_state`` when K3 takes
    its candidate-row form (one query's selection arrays do not fit beside
    the rest of its state), ``k256`` when the tile runs in the K = 256
    form (one launch; K3: a CTA a query).  K3 with both ``k256`` and
    ``global_tables`` is its GT form: a CTA a query, the table staged by
    range."""

    def __init__(self, groups, global_tables: bool = False,
                 global_state: bool = False, k256: bool = False):
        super().__init__(groups)
        self.global_tables = global_tables
        self.global_state = global_state
        self.k256 = k256

    @property
    def largest(self) -> int:
        """Queries in the largest group."""
        return max(q1 - q0 for q0, q1 in self)

    @property
    def tables(self) -> int:
        """Where the launches' tables are, as the libraries' shared-memory
        queries and launches take it: 0 shared memory, 1 global memory
        (K1 staged, K3 GT-ldg), 2 the k256 form, 3 K3's GT form."""
        if self.k256:
            return 3 if self.global_tables else 2
        return int(self.global_tables)

    @property
    def form(self) -> str:
        """K3's form of these launches (``K3_FORMS``)."""
        if self.global_state:
            return "GS"
        if self.k256:
            return "GT" if self.global_tables else "k256"
        return "GT-ldg" if self.global_tables else "shared"


def query_groups(qt: int, bytes_per_query: int, fixed_bytes: int = 0, *,
                 table_bytes=None, state_bytes: int = 0,
                 limit: int = SMEM_LIMIT, max_group: int = 0) -> QueryGroups:
    """Cut a query tile of ``qt`` queries into groups whose shared memory,
    ``fixed_bytes + n * bytes_per_query`` for a group of n, fits
    ``limit`` (and n <= ``max_group`` when that is given): ``[(q0, q1),
    ...]``, as few and as even as can be, covering ``[0, qt)`` in order,
    none empty.  ``table_bytes`` of ``bytes_per_query`` are the query's
    tables (all of it when None), ``state_bytes`` its selection arrays
    (K3; 0 when they cannot move).  When one query alone does not fit,
    its tables stay in global memory.  When it still does not fit, its
    selection arrays go to global memory too, and the tables come back
    to shared memory if they then fit.  The groups are sized by what
    stays; ``global_tables`` / ``global_state`` say what moved.  Raises
    ``ValueError`` only when one query's rest does not fit either."""
    tables = bytes_per_query if table_bytes is None else table_bytes
    global_tables = fixed_bytes + bytes_per_query > limit
    if global_tables:
        bytes_per_query -= tables
    global_state = bool(state_bytes) and fixed_bytes + bytes_per_query > limit
    if global_state:
        bytes_per_query -= state_bytes
        if global_tables and fixed_bytes + bytes_per_query + tables <= limit:
            global_tables = False
            bytes_per_query += tables
    fit = (limit - fixed_bytes) // bytes_per_query if bytes_per_query else qt
    if max_group:
        fit = min(fit, max_group)
    if fit < 1:
        raise ValueError(
            f"one query needs {fixed_bytes + bytes_per_query} B of shared "
            f"memory besides its tables, above the {limit} B a Hopper "
            "block may use")
    n = -(-qt // fit)
    return QueryGroups([(g * qt // n, (g + 1) * qt // n) for g in range(n)],
                       global_tables, global_state)


def scan_splits(t: int, s: int, blk: int) -> tuple:
    """How K1 splits a tile's S scan positions over the grid's second
    dimension, from the shape alone: ``(splits, s_per)``.  About
    ``_K1_TARGET_CTAS`` CTAs, each scoring at least ``_K1_MIN_ITEMS``
    items and staging at most ``K1_MAX_POSITIONS`` positions.  Split
    ``y`` scans ``[y * s_per, min(s, (y + 1) * s_per))``; the ranges
    cover ``[0, s)`` exactly and none is empty (one empty range when s
    is 0)."""
    splits = max(1, min(-(-_K1_TARGET_CTAS // max(t, 1)),
                        s * blk // _K1_MIN_ITEMS),
                 -(-s // K1_MAX_POSITIONS))
    s_per = max(1, -(-s // splits))
    splits = max(1, -(-s // s_per))
    if splits > _MAX_GRID_Y:
        raise ValueError(f"{s} scan positions need {splits} CTAs per tile, "
                         f"above the grid's {_MAX_GRID_Y}")
    return splits, s_per


def staged_splits(t: int, s: int, blk: int) -> tuple:
    """How K1's staged form splits a tile's S scan positions, from the
    shape alone: ``(splits, s_per)``.  A CTA restages every range of its
    tables for each pass of ``K1_STAGED_PASS`` items, so a split holds at
    most one pass (and at most ``K1_MAX_POSITIONS`` positions); where the
    ``t`` tiles' CTAs would not fill the card (``_K1_STAGED_TARGET``),
    more splits, down to half a pass each.  Split ``y`` scans ``[y *
    s_per, min(s, (y + 1) * s_per))``; the ranges cover ``[0, s)``
    exactly and none is empty (one empty range when s is 0)."""
    items = s * blk
    splits = max(1, -(-items // K1_STAGED_PASS), -(-s // K1_MAX_POSITIONS))
    if t * splits < _K1_STAGED_TARGET:
        splits = max(splits, min(-(-_K1_STAGED_TARGET // max(t, 1)),
                                 items // (K1_STAGED_PASS // 2)))
    s_per = max(1, -(-s // splits))
    return max(1, -(-s // s_per)), s_per


def _library_groups(qt: int, smem_of, max_group: int = 0,
                    movable_state: bool = False) -> QueryGroups:
    """``query_groups`` for a launch whose shared memory the kernel's
    library reports: ``smem_of(n, global_tables)`` bytes for a group of
    n queries, linear in n, with the tables in shared memory (0) or in
    global memory (1); with ``movable_state`` also
    ``smem_of(n, global_tables, global_state)``, the selection arrays in
    shared (0) or global (1) memory."""
    fixed = smem_of(0, 0)
    per = smem_of(1, 0) - fixed
    rest = smem_of(1, 1) - smem_of(0, 1)
    arrays = (per - (smem_of(1, 0, 1) - smem_of(0, 0, 1)) if movable_state
              else 0)
    return query_groups(qt, per, fixed, table_bytes=per - rest,
                        state_bytes=arrays, max_group=max_group)


def k1_groups(qt: int, smem_of, k256: bool = False) -> QueryGroups:
    """K1's query groups for a tile of ``qt`` queries whose launch takes
    ``smem_of(n, 0)`` bytes of shared memory for n queries with their
    tables in shared memory (linear in n): ``query_groups``, or, with
    ``k256`` (the shape takes the k256 form), the whole tile in one
    launch; where one query's tables alone do not fit, the staged form's
    groups (``global_tables``), at most ``K1_STAGED_QUERIES`` queries
    each, as few and as even as can be (its range buffers fit at any
    size)."""
    fixed = smem_of(0, 0)
    per = smem_of(1, 0) - fixed
    if fixed + per <= SMEM_LIMIT:
        if k256:
            return QueryGroups([(0, qt)], k256=True)
        return query_groups(qt, per, fixed)
    n = -(-qt // K1_STAGED_QUERIES)
    return QueryGroups([(g * qt // n, (g + 1) * qt // n) for g in range(n)],
                       global_tables=True)


def k1_query_groups(m: int, k: int, qt: int, s_per: int,
                    k256: bool = False) -> QueryGroups:
    """The query groups K1 launches for a tile of ``qt`` queries, and
    their form, by its library's ``pq_scan_tiled_smem_bytes`` (on the
    card only)."""
    lib = build.load("pq_scan")
    return k1_groups(
        qt, lambda n, g: lib.pq_scan_tiled_smem_bytes(m, k, n, s_per, g),
        k256)


def k1_plan(t: int, s: int, blk: int, m: int, k: int, qt: int, *,
            packed: bool = False, codes_align: int = 16) -> tuple:
    """K1's launches for ``t`` tiles of ``qt`` queries over ``s`` scan
    positions: ``(groups, s_per)``, the grid split by ``scan_splits``, or
    by ``staged_splits`` where the tables stay in global memory (the
    staged groups do not depend on s_per) and for the k256 form's tiles
    (one group: a launch scores the whole tile, ``k1_k256_groups``), on
    the card only."""
    _, s_per = scan_splits(t, s, blk)
    groups = k1_query_groups(
        m, k, qt, s_per, k1_form(m, k, blk, m // 2 if packed else m, qt,
                                 packed, False, codes_align) == "k256")
    if groups.k256 and qt > 1:
        _, s_per = staged_splits(t * k1_k256_groups(qt), s, blk)
    elif groups.global_tables:
        _, s_per = staged_splits(t, s, blk)
    return groups, s_per


def k1_k256_groups(qt: int) -> int:
    """Groups of ``K1_STAGED_QUERIES`` queries a k256 launch of ``qt > 1``
    queries runs over its grid (pq_scan.cu's KQ)."""
    return -(-qt // K1_STAGED_QUERIES)


def k1_form(m: int, k: int, blk: int, mb: int, qt: int, packed: bool,
            global_tables: bool, codes_align: int) -> str:
    """The form K1 takes for one launch of ``qt`` queries, from the shape
    alone (``codes_align``: the largest power of two, up to 16, dividing
    the code array's address): ``"staged"`` where the tables stay in
    global memory; where BLK is a power of two, ``"k256"`` at unpacked K
    256 (one query's tables in shared memory) where ``qt`` is above 1, or
    is 1 and the rows are 8-byte aligned (M a multiple of 8), ``"fast"``
    (unpacked K 16, M 64) or ``"packed"`` (nibble-packed K 16, MB 8 or
    16) where ``qt`` is 1 or a multiple of 8 and the rows are aligned;
    else ``"generic"``."""
    if global_tables:
        return "staged"
    if blk & (blk - 1) == 0 and k == 256 and not packed and mb == m and (
            qt > 1 or (m % 8 == 0 and codes_align % 8 == 0)):
        return "k256"
    if blk & (blk - 1) == 0 and (qt == 1 or qt % 8 == 0) and k == 16:
        if not packed and mb == m == 64 and codes_align % 16 == 0:
            return "fast"
        if packed and mb in (8, 16) and m == 2 * mb and codes_align % mb == 0:
            return "packed"
    return "generic"


def k3_query_groups(m: int, k: int, qt: int, fw: int, blk: int, *,
                    packed: bool = False,
                    codes_align: int = 16) -> QueryGroups:
    """The query groups K3 launches for a tile of ``qt`` queries, and
    their form, by its library's ``pq_scan_topk_smem_bytes`` and at most
    ``MAX_QUERY_TILE`` each (on the card only).  At unpacked K 256 with
    8-byte aligned rows (M a multiple of 8), where one query's table and
    selection state fit in a CTA's shared memory, the whole tile is one
    launch of the k256 form (``k256_fits``); where only the table does
    not fit, one launch of the GT form (``gt_fits``)."""
    lib = build.load("pq_scan_topk")
    smem_of = lib.pq_scan_topk_smem_bytes
    if k256_fits(m, k, fw, blk, packed, codes_align, smem_of):
        return QueryGroups([(0, qt)], k256=True)
    if gt_fits(m, k, fw, blk, packed, codes_align, smem_of):
        return QueryGroups([(0, qt)], global_tables=True, k256=True)
    return _library_groups(
        qt, lambda n, g, gs=0: lib.pq_scan_topk_smem_bytes(m, k, n, fw, blk,
                                                           g, gs),
        max_group=MAX_QUERY_TILE, movable_state=True)


def _k256_shaped(m: int, k: int, packed: bool, codes_align: int) -> bool:
    """Unpacked K 256, M a multiple of 8 and 8-byte aligned rows: the
    shapes K3's CTA-a-query forms (k256, GT) read in 8- or 16-byte
    pieces."""
    return k == 256 and not packed and m % 8 == 0 and codes_align % 8 == 0


def k256_fits(m: int, k: int, fw: int, blk: int, packed: bool,
              codes_align: int, smem_of) -> bool:
    """Whether K3 takes its k256 form, from the shape alone: k256-shaped
    (``_k256_shaped``) and one query's CTA (``smem_of(m, k, 1, fw, blk, 2,
    0)`` bytes) within a block's shared memory."""
    return (_k256_shaped(m, k, packed, codes_align)
            and smem_of(m, k, 1, fw, blk, 2, 0) <= SMEM_LIMIT)


def gt_fits(m: int, k: int, fw: int, blk: int, packed: bool,
            codes_align: int, smem_of) -> bool:
    """Whether K3 takes its GT form, from the shape alone: k256-shaped,
    one query's table too large for the k256 form (``k256_fits``), and
    the GT CTA (two range buffers, the selection state and the kept list:
    ``smem_of(m, k, 1, fw, blk, 3, 0)`` bytes) within a block's shared
    memory (fetch up to 4096)."""
    return (_k256_shaped(m, k, packed, codes_align)
            and not k256_fits(m, k, fw, blk, packed, codes_align, smem_of)
            and smem_of(m, k, 1, fw, blk, 3, 0) <= SMEM_LIMIT)


def merge_by_select(splits: int, fetch: int) -> bool:
    """Whether K3's merge of ``splits`` lists of ``fetch`` runs the row
    select: one query's list keys do not fit in a CTA's shared memory
    (on the card only)."""
    lib = build.load("pq_scan_topk")
    return lib.topk_merge_smem_bytes(splits, fetch) > SMEM_LIMIT


def select_in_global(fetch: int) -> bool:
    """Whether the row select keeps its survivors in its scratch tensor:
    they do not fit in a CTA's shared memory (on the card only)."""
    lib = build.load("topk_select")
    return lib.topk_select_smem_bytes(fetch, 0) > SMEM_LIMIT


def row_width(s: int, blk: int, plan_width=None) -> int:
    """Entries of a candidate row (K3's candidate-row form): BLK times the
    plan width, at most the S scan positions of the launch.  A query keeps
    at most one item per (plan slot, lane)."""
    return blk * (s if plan_width is None else min(s, plan_width))


def pq_scan_tiled_kernel(lut: torch.Tensor, block_codes: torch.Tensor,
                         tile_idx: torch.Tensor, *, query_tile: int = 8,
                         packed: bool = False) -> torch.Tensor:
    """K1.  lut (B, M, K) f32, block_codes (TB, BLK, MB) uint8, tile_idx
    (B // query_tile, S) int32 with entries in [0, TB) -> (B, S, BLK)
    f32.  With ``packed`` each code byte holds two 4-bit codes and
    M == 2 * MB.  Every query tile pages its own scan list.  On the card
    a tile whose tables do not fit in shared memory is scanned in
    ``k1_query_groups``, one launch each; every output row depends only
    on its own query's table and the tile's list, so the split is
    exact.  Where one query's tables alone do not fit, the kernel reads
    them from global memory, the whole tile in one launch."""
    if lut.device.type == "cpu":
        return pq_scan_tiled_ref(lut, block_codes, tile_idx,
                                 query_tile=query_tile, packed=packed)
    b, m, k = lut.shape
    tb, blk, mb = block_codes.shape
    t, s = tile_idx.shape
    dev = lut.device
    _require(lut, "lut", torch.float32, 3, dev)
    _require(block_codes, "block_codes", torch.uint8, 3, dev)
    _require(tile_idx, "tile_idx", torch.int32, 2, dev)
    if (2 * mb if packed else mb) != m:
        raise ValueError(f"code width {mb} (packed={packed}) != lut M {m}")
    if b != t * query_tile:
        raise ValueError(f"batch {b} != {t} tiles x query_tile {query_tile}")
    out = torch.empty((b, s, blk), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    ptr = block_codes.data_ptr()
    align = min(16, ptr & -ptr)
    groups, s_per = k1_plan(t, s, blk, m, k, query_tile, packed=packed,
                            codes_align=align)
    lib = build.load("pq_scan")
    if groups.k256 and lut.data_ptr() % 16:
        lut = lut.clone()           # cp.async copies the tables in 16 B
    for q0, q1 in groups:
        form = k1_form(m, k, blk, mb, q1 - q0, packed, groups.global_tables,
                       align)
        fid = K1_FORMS.index(form)
        nbytes = lib.pq_scan_tiled_scratch_bytes(b, m, q1 - q0, query_tile,
                                                 fid)
        scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
                   if nbytes else None)
        err = lib.pq_scan_tiled_launch(
            lut.data_ptr() + 4 * q0 * m * k, ptr,
            tile_idx.data_ptr(), out.data_ptr() + 4 * q0 * s * blk, b, m, k,
            blk, mb, s, q1 - q0, query_tile, int(packed), s_per, fid,
            None if scratch is None else scratch.data_ptr(), _stream(dev))
        build.check(lib, err, f"pq_scan_tiled_kernel ({form} form)")
        pq_scan_tiled_kernel.launches += 1
        pq_scan_tiled_kernel.forms[form] += 1
    return out


pq_scan_tiled_kernel.launches = 0
pq_scan_tiled_kernel.forms = dict.fromkeys(K1_FORMS, 0)


def pq_scan_paged_kernel(lut: torch.Tensor, block_codes: torch.Tensor,
                         block_idx: torch.Tensor, *, query_tile: int = 8,
                         packed: bool = False) -> torch.Tensor:
    """K2.  block_idx (B, S) -> (B, S, BLK) through K1.  With
    query_tile > 1 every row of a tile must carry the same scan list
    (only row 0 drives the paging); a mismatch raises ``ValueError``."""
    b, s = block_idx.shape
    if b % query_tile:
        raise ValueError(f"batch {b} is not a multiple of query_tile "
                         f"{query_tile}")
    rows = block_idx.reshape(b // query_tile, query_tile, s)
    if query_tile > 1 and not bool((rows == rows[:, :1, :]).all()):
        raise ValueError(
            f"pq_scan_paged_kernel: query_tile={query_tile} but the tile "
            "rows of block_idx disagree — per-tile paging scores row 0's "
            "list for the whole tile.  Use query_tile=1 (per-query paging) "
            "or a tile-shared scan list (ops.pq_scan_grouped / "
            "ops.pq_scan_tiled).")
    return pq_scan_tiled_kernel(lut, block_codes,
                                rows[:, 0, :].contiguous(),
                                query_tile=query_tile, packed=packed)


def topk_width(fetch: int) -> int:
    """K3's per-query accumulator and queue width FW: a power of two
    >= fetch, and at least a warp."""
    return max(pow2_ceil(max(fetch, 1)), 32)


def topk_splits(t: int, s: int, blk: int, target: int) -> tuple:
    """How K3 splits a tile's S scan positions over the grid's second
    dimension, from the shape alone: ``(splits, s_per)``.  As many splits
    as keep the ``t`` tiles' CTAs within ``target`` (whole waves of the
    CTAs the card holds at once, ``k3_wave_splits``: a partial wave costs
    a whole CTA's time), but at least ``_MIN_ROUNDS`` rounds of ``TOPK_THREADS``
    items each.  Split ``y`` scans positions ``[y * s_per, min(s, (y +
    1) * s_per))``; the ranges cover ``[0, s)`` exactly and none is
    empty (one empty range when s is 0)."""
    per_round = max(1, TOPK_THREADS // blk)       # positions in a round
    splits = max(1, min(target // max(t, 1),
                        s // (_MIN_ROUNDS * per_round), _MAX_GRID_Y))
    s_per = max(1, -(-s // splits))
    return max(1, -(-s // s_per)), s_per


@functools.lru_cache(maxsize=None)
def _k3_ctas(packed: bool, tables: int, global_state: bool, smem: int,
             device_index: int) -> int:
    """K3 CTAs of this form (``tables`` as ``QueryGroups.tables``) and
    shared memory that the card holds at once
    (``pq_scan_topk_ctas_per_sm`` times the SMs)."""
    lib = build.load("pq_scan_topk")
    with torch.cuda.device(device_index):
        per_sm = lib.pq_scan_topk_ctas_per_sm(
            int(packed), int(tables), int(global_state), smem)
    if per_sm < 1:
        raise RuntimeError(f"K3: occupancy query failed ({per_sm}) for "
                           f"{smem} B of shared memory")
    props = torch.cuda.get_device_properties(device_index)
    return per_sm * props.multi_processor_count


def k3_wave(groups: QueryGroups, m: int, k: int, fw: int, blk: int,
            packed: bool, device) -> int:
    """K3 CTAs of the launches in ``groups`` (``k3_query_groups`` or
    ``k3_row_groups``; ``fw`` 0 for the candidate-row form) that the card
    holds at once, by the shared memory of the largest group (on the card
    only)."""
    lib = build.load("pq_scan_topk")
    smem = lib.pq_scan_topk_smem_bytes(m, k, groups.largest, fw, blk,
                                       groups.tables,
                                       int(groups.global_state))
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _k3_ctas(packed, groups.tables, groups.global_state, smem, index)


def k3_wave_splits(groups: QueryGroups, t: int, s: int, m: int, k: int,
                   fw: int, blk: int, packed: bool, device) -> tuple:
    """``topk_splits`` of K3's launches in ``groups`` for one full wave of
    ``k3_wave`` CTAs.  Where one wave cuts a tile into ``_FINE_SPLITS``
    splits or more (few tiles: grouped batches), two waves: the splits of
    such a tile differ in how much of it is planned (the densest CTA of a
    grouped pq4 batch at fetch 400 takes twice the mean), and a second
    wave lets the card even them out; with many tiles (clustered) one
    wave is faster (``tools/k3_phases.py --waves``).  The k256 form's
    CTAs of a split are a tile's queries, not the tile.  Returns ``(splits,
    s_per)``."""
    wave = k3_wave(groups, m, k, fw, blk, packed, device)
    if groups.k256:        # a CTA a query of a tile (k256 and GT)
        t *= groups.largest
    waves = 2 if wave // max(t, 1) >= _FINE_SPLITS else 1
    return topk_splits(t, s, blk, waves * wave)


def select_topk_kernel(row_d: torch.Tensor, row_pos: torch.Tensor,
                       row_id: torch.Tensor, row_n=None, *, fetch: int):
    """The row select (``csrc/topk_select.cu``).  (B, W) rows of (d, pos,
    id) triples, of which the first ``row_n[b]`` count (all W when
    ``row_n`` is None) -> their stable top-``fetch`` under (d, pos),
    ``(acc_d, acc_pos, acc_id)`` (B, fetch), padded with ``(+inf,
    PAD_POS, -1)`` (see ``ref.select_topk_ref``).  One CTA per row;
    survivors beyond a CTA's shared memory go to a scratch tensor
    (``select_in_global``)."""
    if row_d.device.type == "cpu":
        return select_topk_ref(row_d, row_pos, row_id, row_n, fetch=fetch)
    b, w = row_d.shape
    dev = row_d.device
    _require(row_d, "row_d", torch.float32, 2, dev)
    for name, x in (("row_pos", row_pos), ("row_id", row_id)):
        _require(x, name, torch.int32, 2, dev)
        if x.shape != row_d.shape:
            raise ValueError(f"{name} {tuple(x.shape)} != row_d "
                             f"{tuple(row_d.shape)}")
    if row_n is not None:
        _require(row_n, "row_n", torch.int32, 1, dev)
        if row_n.shape != (b,):
            raise ValueError(f"row_n must be ({b},), got {tuple(row_n.shape)}")
    if fetch < 1:
        raise ValueError(f"fetch must be >= 1, got {fetch}")
    out = (torch.empty((b, fetch), dtype=torch.float32, device=dev),
           torch.empty((b, fetch), dtype=torch.int32, device=dev),
           torch.empty((b, fetch), dtype=torch.int32, device=dev))
    lib = build.load("topk_select")
    glob = select_in_global(fetch)
    scratch = torch.empty(b * lib.topk_select_scratch_words(fetch, int(glob)),
                          dtype=torch.int32, device=dev)
    err = lib.topk_select_launch(
        row_d.data_ptr(), row_pos.data_ptr(), row_id.data_ptr(),
        None if row_n is None else row_n.data_ptr(),
        *(x.data_ptr() for x in out), scratch.data_ptr(), b, w, fetch,
        int(glob), _stream(dev))
    build.check(lib, err, "select_topk_kernel")
    select_topk_kernel.launches += 1
    return out


select_topk_kernel.launches = 0


def merge_topk_kernel(part_d: torch.Tensor, part_pos: torch.Tensor,
                      part_id: torch.Tensor):
    """K3's merge.  (B, splits, F) lists, each ascending by (d, pos)
    with pads ``(+inf, PAD_POS, -1)`` last and pos unique among a query's
    other entries -> their top-F ``(acc_d, acc_pos, acc_id)``, (B, F)
    ascending by (d, pos).  One CTA per query finds the F-th key by
    counting and places each entry up to it by counting
    (``csrc/pq_scan_topk.cu``).  Where a query's keys pass a CTA's shared
    memory (``merge_by_select``: splits * F above about 28,000) the row
    select merges the (B, splits * F) rows instead, and the launch counts
    as ``select_topk_kernel``'s."""
    if part_d.device.type == "cpu":
        return merge_topk_ref(part_d, part_pos, part_id)
    b, splits, fetch = part_d.shape
    dev = part_d.device
    _require(part_d, "part_d", torch.float32, 3, dev)
    for name, x in (("part_pos", part_pos), ("part_id", part_id)):
        _require(x, name, torch.int32, 3, dev)
        if x.shape != part_d.shape:
            raise ValueError(f"{name} {tuple(x.shape)} != part_d "
                             f"{tuple(part_d.shape)}")
    if splits < 1 or fetch < 1:
        raise ValueError(f"merge_topk_kernel needs splits, fetch >= 1, got "
                         f"{tuple(part_d.shape)}")
    if merge_by_select(splits, fetch):
        return select_topk_kernel(*(x.reshape(b, splits * fetch)
                                    for x in (part_d, part_pos, part_id)),
                                  fetch=fetch)
    out = (torch.empty((b, fetch), dtype=torch.float32, device=dev),
           torch.empty((b, fetch), dtype=torch.int32, device=dev),
           torch.empty((b, fetch), dtype=torch.int32, device=dev))
    lib = build.load("pq_scan_topk")
    err = lib.topk_merge_launch(
        part_d.data_ptr(), part_pos.data_ptr(), part_id.data_ptr(),
        *(x.data_ptr() for x in out), b, splits, fetch, _stream(dev))
    build.check(lib, err, "merge_topk_kernel")
    merge_topk_kernel.launches += 1
    return out


merge_topk_kernel.launches = 0


def _k3_shape(lut, block_codes, block_ids, block_other, tile_idx, rank_of,
              slot_of, rank_u, dead, query_tile, packed):
    """Check K3's inputs on the card; returns (b, m, k, blk, mb, s, nlist)."""
    b, m, k = lut.shape
    tb, blk, mb = block_codes.shape
    t, s = tile_idx.shape
    dev = lut.device
    _require(lut, "lut", torch.float32, 3, dev)
    _require(block_codes, "block_codes", torch.uint8, 3, dev)
    for name, x in (("block_ids", block_ids), ("block_other", block_other),
                    ("tile_idx", tile_idx), ("rank_of", rank_of),
                    ("slot_of", slot_of), ("rank_u", rank_u)):
        _require(x, name, torch.int32, 2, dev)
    if dead is not None:
        _require(dead, "dead", torch.uint8, 2, dev)
        if dead.shape != block_ids.shape:
            raise ValueError(f"dead {tuple(dead.shape)} != block_ids "
                             f"{tuple(block_ids.shape)}")
    if (2 * mb if packed else mb) != m:
        raise ValueError(f"code width {mb} (packed={packed}) != lut M {m}")
    if b != t * query_tile:
        raise ValueError(f"batch {b} != {t} tiles x query_tile {query_tile}")
    if blk != pow2_ceil(blk):
        raise ValueError(f"block size must be a power of 2: {blk}")
    if block_ids.shape != (tb, blk) or block_other.shape != (tb, blk):
        raise ValueError("block_ids / block_other must be (TB, BLK)")
    if slot_of.shape != (b, s) or rank_u.shape != (b, s):
        raise ValueError(f"slot_of / rank_u must be {(b, s)}")
    if rank_of.shape[0] != b:
        raise ValueError(f"rank_of must have {b} rows")
    return b, m, k, blk, mb, s, rank_of.shape[1]


def k3_row_groups(m: int, k: int, qt: int, blk: int) -> QueryGroups:
    """The query groups of K3's candidate-row form for a tile of ``qt``
    queries (``global_state`` set), by its library's
    ``pq_scan_topk_smem_bytes`` (on the card only)."""
    lib = build.load("pq_scan_topk")
    groups = _library_groups(
        qt, lambda n, g: lib.pq_scan_topk_smem_bytes(m, k, n, 0, blk, g, 1),
        max_group=MAX_QUERY_TILE)
    groups.global_state = True
    return groups


def _scan_rows(args, dims, query_tile, packed, plan_width, groups):
    """Launch K3's candidate-row form on checked inputs (``dims`` from
    ``_k3_shape``), one launch per query group, over
    ``k3_wave_splits`` ranges: ``(row_d, row_pos, row_id, row_n, dco)``."""
    lut, block_codes, block_ids, block_other, tile_idx, rank_of, slot_of, \
        rank_u, dead = args
    b, m, k, blk, mb, s, nlist = dims
    dev = lut.device
    cap = row_width(s, blk, plan_width)
    rows = tuple(torch.empty((b, cap), dtype=dt, device=dev)
                 for dt in (torch.float32, torch.int32, torch.int32))
    row_n = torch.zeros((b,), dtype=torch.int32, device=dev)
    dco = torch.zeros((b,), dtype=torch.int32, device=dev)
    splits, s_per = k3_wave_splits(groups, tile_idx.shape[0], s, m, k, 0,
                                   blk, packed, dev)
    lib = build.load("pq_scan_topk")
    for q0, q1 in groups:
        err = lib.pq_scan_rows_launch(
            lut.data_ptr() + 4 * q0 * m * k, block_codes.data_ptr(),
            block_ids.data_ptr(), block_other.data_ptr(), tile_idx.data_ptr(),
            rank_of.data_ptr() + 4 * q0 * nlist,
            slot_of.data_ptr() + 4 * q0 * s, rank_u.data_ptr() + 4 * q0 * s,
            None if dead is None else dead.data_ptr(),
            *(x.data_ptr() + 4 * q0 * cap for x in rows),
            row_n.data_ptr() + 4 * q0, dco.data_ptr() + 4 * q0, b, m, k, blk,
            mb, s, q1 - q0, query_tile, nlist, cap, int(packed), splits,
            s_per, int(groups.global_tables), _stream(dev))
        build.check(lib, err, "pq_scan_topk_kernel (GS form)")
        pq_scan_topk_kernel.launches += 1
        pq_scan_topk_kernel.forms["GS"] += 1
    return rows[0], rows[1], rows[2], row_n, dco


def pq_scan_rows_kernel(lut, block_codes, block_ids, block_other, tile_idx,
                        rank_of, slot_of, rank_u, dead=None, *,
                        query_tile: int = 8, packed: bool = False,
                        plan_width=None):
    """K3's candidate-row form alone: the scan and keep mask of
    ``pq_scan_topk_kernel``, with every kept triple of query b appended to
    row b (see ``ref.scan_rows_ref``).  Returns ``(row_d, row_pos, row_id,
    row_n, dco)``: (B, W) f32 / int32 / int32 rows with
    ``W = row_width(S, BLK, plan_width)`` (``plan_width``: the plan's
    slots, every ``slot_of`` below it; S when None), the (B,) int32 count
    of kept triples, and the DCO.  On the card the first ``row_n[b]``
    entries of a row come in no particular order (the plain version's in
    ascending pos) and the rest are not written.  Its launches count as
    ``pq_scan_topk_kernel``'s: the same CUDA kernel."""
    if lut.device.type == "cpu":
        return scan_rows_ref(lut, block_codes, block_ids, block_other,
                             tile_idx, rank_of, slot_of, rank_u, dead,
                             query_tile=query_tile, packed=packed,
                             plan_width=plan_width)
    args = (lut, block_codes, block_ids, block_other, tile_idx, rank_of,
            slot_of, rank_u, dead)
    dims = _k3_shape(*args, query_tile, packed)
    _, m, k, blk, _, _, _ = dims
    return _scan_rows(args, dims, query_tile, packed, plan_width,
                      k3_row_groups(m, k, query_tile, blk))


def pq_scan_topk_kernel(lut, block_codes, block_ids, block_other, tile_idx,
                        rank_of, slot_of, rank_u, dead=None, *,
                        query_tile: int = 8, fetch: int = 64,
                        packed: bool = False, plan_width=None):
    """K3.  Fused scan -> keep mask -> top-``fetch`` per query (see
    ``ref.pq_scan_topk_ref`` for the contract).  Returns
    ``(acc_d, acc_pos, acc_id, dco)``: (B, fetch) f32 / int32 / int32
    ascending by (d, pos), and the (B,) int32 logical DCO.  The scan
    runs over ``k3_wave_splits`` ranges of positions; with more than one,
    ``merge_topk_kernel`` merges their lists.  On the card a tile whose
    state does not fit in shared memory, or that has more than
    ``MAX_QUERY_TILE`` queries, is scanned in ``k3_query_groups``, one
    launch each; every output row depends only on its own query's rows
    and the tile's list, so the split is exact.  Where one query's
    tables alone do not fit, the kernel reads them from global memory:
    at k256's shapes in its GT form (``gt_fits``: a CTA a query, the
    table staged through shared memory by range), else through __ldg
    (GT-ldg).  Where its selection arrays do not fit (fetch above 8192),
    K3 takes its candidate-row form: the scan appends every kept triple
    to its query's row (``pq_scan_rows_kernel``, rows ``plan_width`` slots
    wide) and ``select_topk_kernel`` selects from each row; no merge
    runs.  At unpacked K 256 (``k256_fits``) the whole tile is one launch
    of the k256 form, a CTA a query."""
    if lut.device.type == "cpu":
        return pq_scan_topk_ref(lut, block_codes, block_ids, block_other,
                                tile_idx, rank_of, slot_of, rank_u, dead,
                                query_tile=query_tile, fetch=fetch,
                                packed=packed)
    args = (lut, block_codes, block_ids, block_other, tile_idx, rank_of,
            slot_of, rank_u, dead)
    dims = _k3_shape(*args, query_tile, packed)
    b, m, k, blk, mb, s, nlist = dims
    if fetch < 1:
        raise ValueError(f"fetch must be >= 1, got {fetch}")
    dev = lut.device
    fw = topk_width(fetch)
    ptr = block_codes.data_ptr()
    groups = k3_query_groups(m, k, query_tile, fw, blk, packed=packed,
                             codes_align=min(16, ptr & -ptr))
    if groups.global_state:
        row_d, row_pos, row_id, row_n, dco = _scan_rows(
            args, dims, query_tile, packed, plan_width, groups)
        acc = select_topk_kernel(row_d, row_pos, row_id, row_n, fetch=fetch)
        return acc[0], acc[1], acc[2], dco
    lib = build.load("pq_scan_topk")
    splits, s_per = k3_wave_splits(groups, tile_idx.shape[0], s, m, k, fw,
                                   blk, packed, dev)
    acc = tuple(torch.empty((b, fetch), dtype=dt, device=dev)
                for dt in (torch.float32, torch.int32, torch.int32))
    part = acc if splits == 1 else tuple(
        torch.empty((b, splits, fetch), dtype=x.dtype, device=dev)
        for x in acc)
    dco = torch.zeros((b,), dtype=torch.int32, device=dev)
    if groups.k256 and lut.data_ptr() % 16:
        lut = lut.clone()           # cp.async copies the tables in 16 B
    for q0, q1 in groups:
        err = lib.pq_scan_topk_launch(
            lut.data_ptr() + 4 * q0 * m * k, block_codes.data_ptr(),
            block_ids.data_ptr(), block_other.data_ptr(), tile_idx.data_ptr(),
            rank_of.data_ptr() + 4 * q0 * nlist,
            slot_of.data_ptr() + 4 * q0 * s, rank_u.data_ptr() + 4 * q0 * s,
            None if dead is None else dead.data_ptr(),
            *(x.data_ptr() + 4 * q0 * splits * fetch for x in part),
            dco.data_ptr() + 4 * q0, b, m, k, blk, mb, s, q1 - q0,
            query_tile, nlist, fw, fetch, int(packed), splits, s_per,
            groups.tables, _stream(dev))
        build.check(lib, err, f"pq_scan_topk_kernel ({groups.form} form)")
        pq_scan_topk_kernel.launches += 1
        pq_scan_topk_kernel.forms[groups.form] += 1
    if splits > 1:
        acc = merge_topk_kernel(*part)
    return acc[0], acc[1], acc[2], dco


pq_scan_topk_kernel.launches = 0
pq_scan_topk_kernel.forms = dict.fromkeys(K3_FORMS, 0)

def delta_form(m: int, k: int, nlist: int, p: int, fw: int, smem_of) -> int:
    """The delta scan's form from the shape alone: the first of
    ``_DELTA_ORDER`` whose CTA, ``smem_of(m, k, nlist, p, fw, form)``
    bytes, fits a block's shared memory.  The query's table leaves shared
    memory only where the rank_of row has left it first and the CTA still
    does not fit; the selection state (six FW-wide arrays) only where
    neither move makes it fit.  Raises ``ValueError`` where even the
    probed lists and their offsets pass a block's shared memory."""
    for form in _DELTA_ORDER:
        if smem_of(m, k, nlist, p, fw, form) <= SMEM_LIMIT:
            return form
    raise ValueError(f"delta scan: {p} probed lists need more than the "
                     f"{SMEM_LIMIT} B of shared memory a Hopper block may use")


def delta_form_name(form: int) -> str:
    """The name in ``DELTA_FORMS`` of a form's GT and GS bits."""
    return DELTA_FORMS[(form & DELTA_GT) | (form & DELTA_GS) >> 1]


def delta_splits(b: int, p: int, wave: int) -> int:
    """CTAs the delta scan splits a query's walk over, from the batch
    alone: as many as keep the ``b`` queries' CTAs within one wave of
    ``wave`` (those the card holds at once), at most one a probed list of
    the ``p``; 1 where the batch alone fills a wave."""
    return max(1, min(wave // max(b, 1), p))


@functools.lru_cache(maxsize=None)
def _delta_ctas(form: int, smem: int, device_index: int) -> int:
    """Delta-scan CTAs of this form and shared memory that the card holds
    at once (``delta_scan_topk_ctas_per_sm`` times the SMs)."""
    lib = build.load("delta_scan_topk")
    with torch.cuda.device(device_index):
        per_sm = lib.delta_scan_topk_ctas_per_sm(form, smem)
    if per_sm < 1:
        raise RuntimeError(f"delta scan: occupancy query failed ({per_sm}) "
                           f"for {smem} B of shared memory")
    props = torch.cuda.get_device_properties(device_index)
    return per_sm * props.multi_processor_count


def delta_scan_topk_kernel(lut, delta_codes, delta_ids, delta_post,
                           delta_assigns, sel, rank_of, *, fetch: int):
    """The stream's routed delta scan with each query's stable
    top-``fetch`` (``csrc/delta_scan_topk.cu``).  lut (B, M, K) f32,
    delta_codes (cap, M) uint8, delta_ids (cap,) (-1: dead or unused),
    delta_post (nlist, L) slot postings, each row a prefix of slots then
    -1 pads, delta_assigns (cap, m), sel (B, P) the ranked probed lists,
    rank_of (B, nlist); int32 but lut and codes.  Position p * L + l
    holds the slot posted at column l of list sel[b, p]; a live slot is
    kept at its lowest-ranked probed assigned list and scored over
    ascending m.  Returns ``(dd, di, dco, walked)``: (B, n) f32 / int32,
    n = min(fetch, P * L), the kept (distance, id) pairs ascending by
    (distance, position), unfilled places (+inf, -1); the (B,) int32
    kept count (the routed DCO) and posted slots read (each probed row's
    prefix).  On the card: one CTA a query, or ``delta_splits`` CTAs a
    query at small batches, merged by ``merge_topk_kernel``; where the
    selection state does not fit in shared memory (``delta_form``: fetch
    above 8192) the kept triples go to (B, P * L) rows and
    ``select_topk_kernel`` selects.  On the CPU, the plain version:
    ``ref.py::routed_delta_topk``."""
    if lut.device.type == "cpu":
        return routed_delta_topk(lut, delta_codes, delta_ids, delta_post,
                                 delta_assigns, sel, rank_of, fetch)
    b, m, k = lut.shape
    cap = delta_ids.shape[0]
    nlist, width = delta_post.shape
    p = sel.shape[1]
    dev = lut.device
    _require(lut, "lut", torch.float32, 3, dev)
    _require(delta_codes, "delta_codes", torch.uint8, 2, dev)
    for name, x, nd in (("delta_ids", delta_ids, 1),
                        ("delta_post", delta_post, 2),
                        ("delta_assigns", delta_assigns, 2), ("sel", sel, 2),
                        ("rank_of", rank_of, 2)):
        _require(x, name, torch.int32, nd, dev)
    if delta_codes.shape != (cap, m):
        raise ValueError(f"delta_codes {tuple(delta_codes.shape)} != "
                         f"{(cap, m)}")
    if delta_assigns.shape[0] != cap or delta_assigns.shape[1] < 1:
        raise ValueError(f"delta_assigns {tuple(delta_assigns.shape)} must "
                         f"be ({cap}, m >= 1)")
    if sel.shape[0] != b or rank_of.shape != (b, nlist):
        raise ValueError(f"sel {tuple(sel.shape)} / rank_of "
                         f"{tuple(rank_of.shape)} must have {b} rows, "
                         f"rank_of {nlist} columns")
    if fetch < 1:
        raise ValueError(f"fetch must be >= 1, got {fetch}")
    n = min(fetch, p * width)
    dco = torch.zeros((b,), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return (torch.empty((b, 0), dtype=torch.float32, device=dev),
                torch.empty((b, 0), dtype=torch.int32, device=dev), dco,
                torch.zeros((b,), dtype=torch.int32, device=dev))
    walked = torch.empty((b,), dtype=torch.int32, device=dev)  # all written
    fw = topk_width(n)
    lib = build.load("delta_scan_topk")
    form = delta_form(m, k, nlist, p, fw, lib.delta_scan_topk_smem_bytes)
    smem = lib.delta_scan_topk_smem_bytes(m, k, nlist, p, fw, form)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    splits = delta_splits(b, p, _delta_ctas(form, smem, index))
    gs = bool(form & DELTA_GS)
    shape = (b, p * width) if gs else (b, splits, n)
    part = tuple(torch.empty(shape, dtype=dt, device=dev)
                 for dt in (torch.float32, torch.int32, torch.int32))
    row_n = torch.zeros((b,), dtype=torch.int32, device=dev) if gs else None
    ptr = delta_codes.data_ptr()
    name = delta_form_name(form)
    err = lib.delta_scan_topk_launch(
        lut.data_ptr(), ptr, delta_ids.data_ptr(), delta_post.data_ptr(),
        delta_assigns.data_ptr(), sel.data_ptr(), rank_of.data_ptr(),
        part[0].data_ptr(),
        part[1].data_ptr() if gs or splits > 1 else None, part[2].data_ptr(),
        None if row_n is None else row_n.data_ptr(), dco.data_ptr(),
        walked.data_ptr(), b, m, k, width, p, nlist, delta_assigns.shape[1],
        fw, n, p * width, splits, form, int(m % 16 == 0 and ptr % 16 == 0),
        _stream(dev))
    build.check(lib, err, f"delta_scan_topk_kernel ({name} form)")
    delta_scan_topk_kernel.launches += 1
    delta_scan_topk_kernel.forms[name] += 1
    if gs:
        dd, _, di = select_topk_kernel(*part, row_n, fetch=n)
    elif splits > 1:
        dd, _, di = merge_topk_kernel(*part)
    else:
        dd, di = part[0].view(b, n), part[2].view(b, n)
    return dd, di, dco, walked


delta_scan_topk_kernel.launches = 0
delta_scan_topk_kernel.forms = dict.fromkeys(DELTA_FORMS, 0)


def encode_split(m: int, k: int, dsub: int, smem_of) -> int:
    """Subquantizers MS one encode CTA stages: all ``m`` where their books,
    norms and a tile of rows (``smem_of(ms, k, dsub)`` bytes) fit
    ``ENCODE_SMEM``, so that an SM holds four CTAs, else the size of the
    fewest equal chunks that fit it (PQ64x8: 4, PQ256x8 at dsub 1: 10),
    else of those that fit a block's shared memory.  Raises ``ValueError``
    where one subquantizer does not fit."""
    for limit in (ENCODE_SMEM, SMEM_LIMIT):
        for chunks in range(1, m + 1):
            ms = -(-m // chunks)
            if smem_of(ms, k, dsub) <= limit:
                return ms
    raise ValueError(f"pq encode: one subquantizer of {k} x {dsub} floats "
                     f"needs more than the {SMEM_LIMIT} B of shared memory "
                     "a Hopper block may use")


@functools.lru_cache(maxsize=None)
def encode_plan(m: int, k: int, dsub: int, device_index: int) -> tuple:
    """``(ms, ctas)``: the encode's subquantizers a CTA (``encode_split``)
    and its row CTAs for one wave on this card, the CTAs an SM holds
    times the SMs, over the ceil(m / ms) chunks (at least 1)."""
    lib = build.load("pq_encode")
    ms = encode_split(m, k, dsub, lib.pq_encode_smem_bytes)
    with torch.cuda.device(device_index):
        per_sm = lib.pq_encode_ctas_per_sm(
            dsub, lib.pq_encode_smem_bytes(ms, k, dsub))
    if per_sm < 1:
        raise RuntimeError(f"pq encode: occupancy query failed ({per_sm})")
    props = torch.cuda.get_device_properties(device_index)
    return ms, max(1, per_sm * props.multi_processor_count // -(-m // ms))


def pq_encode_kernel(codebooks: torch.Tensor, x: torch.Tensor,
                     chunk: int = 65536) -> torch.Tensor:
    """PQ codes of ``x`` (``csrc/pq_encode.cu``): codebooks (M, K, dsub)
    f32, x (n, M * dsub) f32 -> (n, M) uint8, each the first nearest
    centroid of its subquantizer by ``max((x2 - 2 xc) + c2, 0)``, summed
    in one fixed order whatever n.  One launch a call for any n >= 1
    (none for n = 0).  On the CPU, the plain version
    ``ref.py::pq_encode_plain``, ``chunk`` rows a step (the kernel
    ignores ``chunk``)."""
    if x.device.type == "cpu":
        return pq_encode_plain(codebooks, x, chunk)
    dev = x.device
    _require(codebooks, "codebooks", torch.float32, 3, dev)
    _require(x, "x", torch.float32, 2, dev)
    m, k, dsub = codebooks.shape
    n = x.shape[0]
    if x.shape[1] != m * dsub:
        raise ValueError(f"x {tuple(x.shape)} must be (n, {m * dsub})")
    if not 1 <= k <= 256:
        raise ValueError(f"pq encode: K={k} does not fit a uint8 code")
    out = torch.empty((n, m), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    ms, ctas = encode_plan(m, k, dsub, index)
    lib = build.load("pq_encode")
    err = lib.pq_encode_launch(x.data_ptr(), codebooks.data_ptr(),
                               out.data_ptr(), n, m, k, dsub, ms,
                               min(-(-n // ENCODE_TILE), ctas), _stream(dev))
    build.check(lib, err, "pq_encode_kernel")
    pq_encode_kernel.launches += 1
    return out


pq_encode_kernel.launches = 0

KERNELS = (pq_scan_tiled_kernel, pq_scan_topk_kernel, merge_topk_kernel,
           select_topk_kernel, delta_scan_topk_kernel, pq_encode_kernel)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    pq_scan_tiled_kernel.forms = dict.fromkeys(K1_FORMS, 0)
    pq_scan_topk_kernel.forms = dict.fromkeys(K3_FORMS, 0)
    delta_scan_topk_kernel.forms = dict.fromkeys(DELTA_FORMS, 0)


_BY_FORM = (pq_scan_tiled_kernel, pq_scan_topk_kernel, delta_scan_topk_kernel)


def launch_counts(forms: bool = False) -> dict:
    """Launches by kernel name; with ``forms`` also K1's, K3's and the
    delta scan's by form, as ``pq_scan_tiled_kernel[form]`` and so on."""
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    if forms:
        for fn in _BY_FORM:
            counts.update({f"{fn.__name__}[{f}]": n
                           for f, n in fn.forms.items()})
    return counts


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (by kernel name, and by form) to the
    counters: what a CUDA graph replay launches (``core/graphs.py``)."""
    for fn in KERNELS:
        fn.launches += counts.get(fn.__name__, 0)
    for fn in _BY_FORM:
        for f in fn.forms:
            fn.forms[f] += counts.get(f"{fn.__name__}[{f}]", 0)
