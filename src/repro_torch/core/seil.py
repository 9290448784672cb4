"""SEIL — Shared-cell Enhanced IVF Lists (paper §5).

``cell_{i,j}`` (i<=j) holds all vectors assigned to both list_i and
list_j (i==j: single assignment).  SEIL stores the *full* blocks of a
cell once (physically in list_i); list_j keeps a reference entry.  The
``nitems % block`` leftovers are stored in BOTH lists' miscellaneous
areas, with the other list id recorded per item in ``block_other``.

The layout is built on the host in numpy (the reference's algorithm,
``repro/core/seil.py``, copied so the port stands alone) and moved to
the device at the end:
  * flat block storage: ``block_codes (TB, BLK, M)``, ``block_ids (TB, BLK)``,
    ``block_other (TB, BLK)`` (-1 = no co-assigned list);
  * per-list padded tables of block indices: ``owned`` (full shared-cell
    blocks stored here), ``refs``/``refs_other`` (referenced blocks and
    their physical home list), ``misc`` (miscellaneous blocks).

``shared=False`` builds the baseline duplicated layout: every item is
stored once per assigned list, all blocks owned, no dedup metadata.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

SEIL_FIELDS = ("block_codes", "block_ids", "block_other", "owned", "refs",
               "refs_other", "misc")


@dataclasses.dataclass
class SeilArrays:
    """Finalized static-layout lists (tensors on one device)."""
    block_codes: torch.Tensor   # (TB, BLK, M) uint8
    block_ids: torch.Tensor     # (TB, BLK) int32, -1 invalid
    block_other: torch.Tensor   # (TB, BLK) int32, -1 none (misc-item dedup tag)
    owned: torch.Tensor         # (nlist, MO) int32 block ids, -1 pad
    refs: torch.Tensor          # (nlist, MR) int32 block ids, -1 pad
    refs_other: torch.Tensor    # (nlist, MR) int32 physical-home list, -1 pad
    misc: torch.Tensor          # (nlist, MM) int32 block ids, -1 pad

    @property
    def nlist(self) -> int:
        return self.owned.shape[0]

    @property
    def block_size(self) -> int:
        return self.block_ids.shape[1]


@dataclasses.dataclass
class SeilStats:
    """Logical storage accounting (paper Table 4 / Fig 13b)."""
    n_vectors: int
    n_items_stored: int        # vector items physically stored (code+id)
    n_ref_entries: int         # (other, nblocks, ptr) entries
    n_blocks: int
    n_misc_items: int          # items living in misc areas (incl. duplicates)
    code_bytes_per_item: float
    id_bytes_per_item: int = 4
    ref_entry_bytes: int = 8

    @property
    def logical_bytes(self) -> int:
        per_item = self.code_bytes_per_item + self.id_bytes_per_item
        return int(self.n_items_stored * per_item
                   + self.n_ref_entries * self.ref_entry_bytes)


def cell_stats(assigns: np.ndarray) -> Dict[str, np.ndarray]:
    """Cell-size distribution (paper Fig 5). assigns: (n, 2) with l1<=l2."""
    a = np.asarray(assigns)
    keys = a[:, 0].astype(np.int64) * (a.max() + 1) + a[:, 1]
    _, counts = np.unique(keys, return_counts=True)
    return {"cell_sizes": counts}


def vectors_in_large_cells(assigns: np.ndarray, block: int = 32) -> float:
    """Fraction of vectors residing in cells >= one block (paper: ~50%)."""
    sizes = cell_stats(assigns)["cell_sizes"]
    return float(sizes[sizes >= block].sum() / sizes.sum())


def _pad_table(groups: np.ndarray, values: np.ndarray, nlist: int,
               pad_to: Optional[int] = None) -> np.ndarray:
    """Scatter `values` grouped by `groups` into (nlist, MAX) with -1 pad."""
    order = np.argsort(groups, kind="stable")
    groups, values = groups[order], values[order]
    counts = np.bincount(groups, minlength=nlist)
    width = int(counts.max()) if counts.size and counts.max() > 0 else 1
    if pad_to is not None:
        width = max(width, pad_to)
    table = np.full((nlist, width), -1, np.int32)
    starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(groups)) - starts[groups]
    table[groups, pos] = values
    return table


def _build_host(assigns, codes, ids, nlist, block, shared, code_bits):
    """Paper Alg. 4 on the host: numpy arrays of SEIL_FIELDS + SeilStats."""
    n, m_assign = assigns.shape
    m_pq = codes.shape[1]

    blk_codes, blk_ids, blk_other = [], [], []     # streams of full blocks
    owned_l, owned_b = [], []                      # (list, block) pairs
    ref_l, ref_b, ref_o = [], [], []
    misc_list, misc_item, misc_other = [], [], []  # item-level misc pools
    n_ref_entries = 0

    if shared:
        if m_assign != 2:
            raise ValueError("SEIL sharing is designed for 2-assignment")
        l1, l2 = assigns[:, 0], assigns[:, 1]
        order = np.lexsort((ids, l2, l1))
        sl1, sl2 = l1[order], l2[order]
        change = np.empty(n, bool)
        change[0] = True
        change[1:] = (sl1[1:] != sl1[:-1]) | (sl2[1:] != sl2[:-1])
        starts = np.nonzero(change)[0]
        counts = np.diff(np.append(starts, n))
        cell_of_item = np.cumsum(change) - 1
        pos_in_cell = np.arange(n) - starts[cell_of_item]
        nfull_of_cell = (counts // block) * block
        full_mask = pos_in_cell < nfull_of_cell[cell_of_item]

        # ---- full shared blocks (stored once, in cell's first list) ----
        fidx = order[full_mask]                         # item rows, cell-contig
        nb_total = len(fidx) // block
        if nb_total:
            fb = fidx.reshape(nb_total, block)
            blk_codes.append(codes[fb])
            blk_ids.append(ids[fb])
            cell_l1 = l1[fb[:, 0]]
            cell_l2 = l2[fb[:, 0]]
            other = np.where(cell_l2 != cell_l1, cell_l2, -1)
            blk_other.append(np.broadcast_to(other[:, None],
                                             (nb_total, block)).copy())
            bid = np.arange(nb_total, dtype=np.int64)
            owned_l.append(cell_l1)
            owned_b.append(bid)
            sh = cell_l2 != cell_l1
            ref_l.append(cell_l2[sh])
            ref_b.append(bid[sh])
            ref_o.append(cell_l1[sh])
            # one (other, nblocks, ptr) entry per contiguous shared-cell run
            n_ref_entries = len(np.unique(
                cell_l1[sh].astype(np.int64) * nlist + cell_l2[sh]))

        # ---- miscellaneous leftovers: stored in BOTH lists ----
        midx = order[~full_mask]
        if len(midx):
            ml1, ml2 = l1[midx], l2[midx]
            dup = ml2 != ml1
            misc_list = np.concatenate([ml1, ml2[dup]])
            misc_item = np.concatenate([midx, midx[dup]])
            misc_other = np.concatenate([np.where(dup, ml2, -1), ml1[dup]])
        n_misc_items = len(misc_item)
    else:
        # baseline duplicated layout: one copy per assigned list; dedup off
        pairs_l, pairs_i = [], []
        for j in range(m_assign):
            lj = assigns[:, j]
            if j == 0:
                keep = np.ones(n, bool)
            else:
                keep = (assigns[:, j:j + 1] != assigns[:, :j]).all(axis=1)
            pairs_l.append(lj[keep])
            pairs_i.append(np.nonzero(keep)[0])
        misc_list = np.concatenate(pairs_l)
        misc_item = np.concatenate(pairs_i)
        misc_other = np.full(len(misc_list), -1, np.int32)
        n_misc_items = 0  # not a SEIL misc area; counted as plain items

    # ---- pack per-list misc/item pools into blocks ----
    misc_l_tab = np.zeros(0, np.int64)
    misc_b_tab = np.zeros(0, np.int64)
    if len(misc_list):
        misc_list = np.asarray(misc_list)
        misc_item = np.asarray(misc_item)
        misc_other = np.asarray(misc_other, np.int32)
        o2 = np.lexsort((ids[misc_item], misc_item, misc_list))
        gl, gi, go = misc_list[o2], misc_item[o2], misc_other[o2]
        lcounts = np.bincount(gl, minlength=nlist)
        lstarts = np.zeros(nlist + 1, np.int64)
        np.cumsum(lcounts, out=lstarts[1:])
        pos = np.arange(len(gl)) - lstarts[gl]
        nmb = (lcounts + block - 1) // block          # misc blocks per list
        mb_off = np.zeros(nlist + 1, np.int64)
        np.cumsum(nmb, out=mb_off[1:])
        nb_full = sum(b.shape[0] for b in blk_ids)
        rel = mb_off[gl] + pos // block
        item_slot = pos % block
        n_misc_blocks = int(mb_off[-1])
        mcodes = np.zeros((n_misc_blocks, block, m_pq), np.uint8)
        mids = np.full((n_misc_blocks, block), -1, np.int32)
        mother = np.full((n_misc_blocks, block), -1, np.int32)
        mcodes[rel, item_slot] = codes[gi]
        mids[rel, item_slot] = ids[gi]
        mother[rel, item_slot] = go
        blk_codes.append(mcodes)
        blk_ids.append(mids)
        blk_other.append(mother)
        mb_list = np.repeat(np.arange(nlist), nmb)
        mb_bid = nb_full + np.arange(n_misc_blocks)
        if shared:
            misc_l_tab, misc_b_tab = mb_list, mb_bid
        else:
            owned_l.append(mb_list)
            owned_b.append(mb_bid)

    if sum(b.shape[0] for b in blk_ids) == 0:  # degenerate empty index
        blk_codes = [np.zeros((1, block, m_pq), np.uint8)]
        blk_ids = [np.full((1, block), -1, np.int32)]
        blk_other = [np.full((1, block), -1, np.int32)]

    def cat(xs):
        return (np.concatenate(xs).astype(np.int64)
                if xs else np.zeros(0, np.int64))

    refs_groups = cat(ref_l)
    host = {
        "block_codes": np.concatenate(blk_codes, axis=0),
        "block_ids": np.concatenate(blk_ids, axis=0).astype(np.int32),
        "block_other": np.concatenate(blk_other, axis=0).astype(np.int32),
        "owned": _pad_table(cat(owned_l), cat(owned_b).astype(np.int32),
                            nlist),
        "refs": _pad_table(refs_groups, cat(ref_b).astype(np.int32), nlist),
        "refs_other": _pad_table(refs_groups, cat(ref_o).astype(np.int32),
                                 nlist),
        "misc": _pad_table(misc_l_tab, misc_b_tab.astype(np.int32), nlist),
    }
    stats = SeilStats(
        n_vectors=n,
        n_items_stored=int((host["block_ids"] >= 0).sum()),
        n_ref_entries=int(n_ref_entries),
        n_blocks=int(host["block_ids"].shape[0]),
        n_misc_items=int(n_misc_items),
        code_bytes_per_item=m_pq * code_bits / 8.0,
    )
    return host, stats


def arrays_to_device(host: dict, device: torch.device) -> SeilArrays:
    """numpy SEIL_FIELDS -> SeilArrays on ``device``."""
    return SeilArrays(**{f: torch.from_numpy(np.array(host[f])).to(device)
                         for f in SEIL_FIELDS})


# Count of full layout builds in this process.  Streaming (core/stream/)
# shows with it that an append builds no layout: a rebuild is the O(n)
# cost the delta segment exists to avoid.
_BUILD_SEIL_CALLS = 0


def build_seil_call_count() -> int:
    """Number of full layout builds since process start."""
    return _BUILD_SEIL_CALLS


def build_seil_host(assigns, codes, ids, nlist: int, block: int = 32,
                    shared: bool = True, code_bits: int = 4):
    """``build_seil`` up to the host arrays: ``(SEIL_FIELDS as numpy,
    SeilStats)``.  Touches no device, so a compaction can fold on a
    worker thread (``core/stream/``) and move the layout to the card
    later (``arrays_to_device``).  Counts as a layout build."""
    global _BUILD_SEIL_CALLS
    _BUILD_SEIL_CALLS += 1
    return _build_host(np.asarray(assigns, np.int32),
                       np.asarray(codes, np.uint8),
                       np.asarray(ids, np.int32), nlist, block, shared,
                       code_bits)


def build_seil(
    assigns: np.ndarray,        # (n, m) sorted list ids per vector
    codes: np.ndarray,          # (n, M) uint8
    ids: np.ndarray,            # (n,) int32 vector ids
    nlist: int,
    block: int = 32,
    shared: bool = True,
    code_bits: int = 4,
    device: DeviceLike = None,
) -> Tuple[SeilArrays, SeilStats]:
    """Build the SEIL (or baseline duplicated) list layout (paper Alg. 4)
    on the host, then move it to ``device``."""
    dev = resolve_device(device)
    host, stats = build_seil_host(assigns, codes, ids, nlist, block, shared,
                                  code_bits)
    return arrays_to_device(host, dev), stats


def build_id_map(arrays: SeilArrays) -> Dict[int, list]:
    """id -> [(block, slot), ...] (at most 2 per id, plus misc copies)."""
    ids = arrays.block_ids.cpu().numpy()
    out: Dict[int, list] = {}
    bs, ss = np.nonzero(ids >= 0)
    for b, s in zip(bs.tolist(), ss.tolist()):
        out.setdefault(int(ids[b, s]), []).append((b, s))
    return out


def delete_ids(arrays: SeilArrays, id_map: Dict[int, list],
               del_ids) -> SeilArrays:
    """Deprecated: invalidate the layout entries of ``del_ids`` (paper
    §6.1).

    Layout only: it rewrites ``SeilArrays`` alone and leaves an index's
    ``assigns`` / ``codes`` / ``vectors`` / ``SeilStats`` and its cached
    sessions stale.  Delete through ``StreamingIndex.delete``
    (core/stream/), which masks tombstones at query time and keeps every
    view and session version coherent.  Warns with ``DeprecationWarning``
    (the reference's text)."""
    import warnings
    warnings.warn(
        "seil.delete_ids is layout-only and leaves assigns/codes/vectors/"
        "stats and cached sessions stale; use StreamingIndex.delete "
        "(index.streaming().delete(ids)) for index-level deletion",
        DeprecationWarning, stacklevel=2)
    ids = arrays.block_ids.cpu().numpy().copy()
    for i in del_ids:
        for (b, s) in id_map.get(int(i), ()):
            ids[b, s] = -1
    return dataclasses.replace(
        arrays, block_ids=torch.from_numpy(ids).to(arrays.block_ids.device))
