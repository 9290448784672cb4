"""Plain PyTorch versions of the CUDA kernels, with their signatures.

They serve the CPU (a wrapper in ``pq_scan.py`` takes them only for a
tensor on the CPU) and hold the kernels on the card in
``chip_smoke.py``.  The ADC sum runs over **ascending m** in f32, one
add at a time, exactly as each kernel thread does, so kernel and plain
version agree bitwise on the same device.
"""
from __future__ import annotations

import torch

from .topk import PAD_POS


def _tile_codes(block_codes: torch.Tensor, tile_idx: torch.Tensor,
                packed: bool) -> torch.Tensor:
    """Gathered code tiles (T, S, BLK, M) uint8, nibbles unpacked."""
    raw = block_codes[tile_idx.long()]                   # (T, S, BLK, MB)
    if not packed:
        return raw
    t, s, blk, mb = raw.shape
    return torch.stack([raw & 15, raw >> 4], dim=-1).reshape(t, s, blk, 2 * mb)


def pq_scan_tiled_ref(lut: torch.Tensor, block_codes: torch.Tensor,
                      tile_idx: torch.Tensor, *, query_tile: int = 8,
                      packed: bool = False) -> torch.Tensor:
    """Plain K1: lut (B, M, K) f32, block_codes (TB, BLK, MB) uint8,
    tile_idx (B // QT, S) -> (B, S, BLK) f32 with
    ``out[b, s, i] = sum_m lut[b, m, codes[tile_idx[b // QT, s], i, m]]``
    summed over ascending m.  ``packed``: MB = M / 2 and each byte holds
    the codes of subquantizers 2j (lo nibble) and 2j+1 (hi nibble)."""
    b, m, k = lut.shape
    t, s = tile_idx.shape
    if b != t * query_tile:
        raise ValueError(f"batch {b} != {t} tiles x query_tile {query_tile}")
    codes = _tile_codes(block_codes, tile_idx, packed)   # (T, S, BLK, M)
    if codes.shape[-1] != m:
        raise ValueError(f"code width {codes.shape[-1]} != lut M {m}")
    blk = codes.shape[2]
    lut_t = lut.reshape(t, query_tile, m, k)
    acc = torch.zeros((t, query_tile, s * blk), dtype=torch.float32,
                      device=lut.device)
    for j in range(m):
        idx = codes[..., j].long().reshape(t, 1, s * blk).expand(
            t, query_tile, s * blk)
        acc = acc + torch.gather(lut_t[:, :, j, :], 2, idx)
    return acc.reshape(b, s, blk)


def pq_scan_paged_ref(lut: torch.Tensor, block_codes: torch.Tensor,
                      block_idx: torch.Tensor, *,
                      packed: bool = False) -> torch.Tensor:
    """Per-query paging: plain K1 at query_tile = 1."""
    return pq_scan_tiled_ref(lut, block_codes, block_idx, query_tile=1,
                             packed=packed)


def _kept(lut, block_codes, block_ids, block_other, tile_idx, rank_of,
          slot_of, rank_u, dead, query_tile, packed):
    """K3's scan and keep mask: (B, S * BLK) candidates ``(cd, cp, ci)``,
    pads ``(+inf, PAD_POS, -1)`` where an item is not kept, and the (B,)
    int32 DCO (see ``pq_scan_topk_ref``)."""
    b = lut.shape[0]
    blk = block_codes.shape[1]
    d = pq_scan_tiled_ref(lut, block_codes, tile_idx, query_tile=query_tile,
                          packed=packed)                     # (B, S, BLK)
    tiles = tile_idx.long().repeat_interleave(query_tile, dim=0)  # (B, S)
    ids = block_ids[tiles]                                   # (B, S, BLK)
    other = block_other[tiles]
    orank = torch.gather(rank_of, 1, other.clamp_min(0).reshape(b, -1).long()
                         ).reshape(other.shape)
    dup = (other >= 0) & (orank < rank_u[:, :, None])
    item_ok = (ids >= 0) & (slot_of >= 0)[:, :, None]
    keep = item_ok & ~dup
    if dead is not None:
        keep &= dead[tiles] == 0
    dco = item_ok.sum(dim=(1, 2)).to(torch.int32)
    lane = torch.arange(blk, dtype=torch.int32, device=lut.device)
    pos = slot_of[:, :, None] * blk + lane
    cd = torch.where(keep, d, torch.inf).reshape(b, -1)
    cp = torch.where(keep, pos, PAD_POS).reshape(b, -1)
    ci = torch.where(keep, ids, -1).reshape(b, -1)
    return cd, cp, ci, dco


def pq_scan_topk_ref(lut, block_codes, block_ids, block_other, tile_idx,
                     rank_of, slot_of, rank_u, dead=None, *,
                     query_tile: int = 8, fetch: int = 64,
                     packed: bool = False):
    """Plain K3: plain K1, then the keep mask, then a stable top-``fetch``.

    Keep mask per (query b, scan position s, lane i) of block
    ``blk = tile_idx[b // QT, s]``: ``block_ids[blk, i] >= 0`` and
    ``slot_of[b, s] >= 0`` (``item_ok``, counted into the DCO), not a
    misc duplicate (``rank_of[b, other] < rank_u[b, s]`` with
    ``other = block_other[blk, i] >= 0``), and not dead when the
    ``(TB, BLK)`` tombstone tile is given.  Kept candidates are ranked
    by ``(d, pos = slot * BLK + lane)``; the result is padded with
    ``(+inf, PAD_POS, -1)``.  Returns ``(acc_d, acc_pos, acc_id, dco)``:
    (B, fetch) f32 / int32 / int32 and (B,) int32.
    """
    cd, cp, ci, dco = _kept(lut, block_codes, block_ids, block_other,
                            tile_idx, rank_of, slot_of, rank_u, dead,
                            query_tile, packed)
    acc_d, acc_pos, acc_id = _lex_topk(cd, cp, ci, fetch)
    return acc_d, acc_pos, acc_id, dco


def scan_rows_ref(lut, block_codes, block_ids, block_other, tile_idx,
                  rank_of, slot_of, rank_u, dead=None, *,
                  query_tile: int = 8, packed: bool = False,
                  plan_width=None):
    """Plain scan to candidate rows (K3's candidate-row form): the scan
    and keep mask of ``pq_scan_topk_ref``, every kept triple of query b
    in row b, in ascending pos, then pads ``(+inf, PAD_POS, -1)``.  Rows
    are ``BLK * min(S, plan_width)`` wide (S when ``plan_width`` is None;
    every ``slot_of`` lies below ``plan_width``).  Returns ``(row_d,
    row_pos, row_id, row_n, dco)``: (B, W) f32 / int32 / int32, the (B,)
    int32 count of kept triples, and the DCO.
    ``select_topk_ref(*rows, fetch=f)`` is ``pq_scan_topk_ref`` at
    fetch f."""
    cd, cp, ci, dco = _kept(lut, block_codes, block_ids, block_other,
                            tile_idx, rank_of, slot_of, rank_u, dead,
                            query_tile, packed)
    s, blk = tile_idx.shape[1], block_codes.shape[1]
    w = blk * (s if plan_width is None else min(s, plan_width))
    order = torch.sort(cp, dim=1, stable=True).indices[:, :w]
    row_n = (cp < PAD_POS).sum(dim=1).to(torch.int32)
    return (torch.gather(cd, 1, order), torch.gather(cp, 1, order),
            torch.gather(ci, 1, order), row_n, dco)


def select_topk_ref(row_d, row_pos, row_id, row_n=None, *, fetch: int):
    """Plain row select: of the first ``row_n[b]`` entries of each (B, W)
    row of (d, pos, id) triples (all W when ``row_n`` is None), the
    ``fetch`` first in the stable order by (d, pos) (d as f32: -0.0
    equals +0.0, a NaN is last), padded with ``(+inf, PAD_POS, -1)``:
    (B, fetch) each.  Entries past ``row_n[b]`` count as pads whatever
    they hold."""
    order = _lex_order(row_d, row_pos)
    gone = None
    if row_n is not None:
        past = (row_n.long()[:, None]
                <= torch.arange(row_d.shape[1], device=row_d.device))
        # entries past the fill after every other, in any order
        order = torch.gather(order, 1, torch.sort(
            past.gather(1, order).to(torch.uint8), dim=1,
            stable=True).indices)
        gone = past.gather(1, order[:, :fetch])
    return _take(row_d, row_pos, row_id, order[:, :fetch], fetch, gone)


def _lex_order(cd, cp):
    """(B, N) indices of each row in the stable order by (d, pos)."""
    # lexicographic (d, pos): stable sort by pos, then stable by d
    o1 = torch.sort(cp, dim=1, stable=True).indices
    o2 = torch.sort(torch.gather(cd, 1, o1), dim=1, stable=True).indices
    return torch.gather(o1, 1, o2)


def _take(cd, cp, ci, order, fetch: int, gone=None):
    """The triples at ``order`` (B, <= fetch), pads where ``gone``, padded
    to ``fetch`` with ``(+inf, PAD_POS, -1)``."""
    b = cd.shape[0]
    pads = (torch.inf, PAD_POS, -1)
    out = [torch.gather(x, 1, order) for x in (cd, cp, ci)]
    if gone is not None:
        out = [torch.where(gone, p, x) for x, p in zip(out, pads)]
    short = fetch - order.shape[1]
    if short > 0:
        out = [torch.cat([x, torch.full((b, short), p, dtype=x.dtype,
                                        device=x.device)], dim=1)
               for x, p in zip(out, pads)]
    return out[0], out[1], out[2]


def _lex_topk(cd, cp, ci, fetch: int):
    """The first ``fetch`` of (B, N) triples under the lexicographic
    (d, pos) key, stable, padded with ``(+inf, PAD_POS, -1)``."""
    return _take(cd, cp, ci, _lex_order(cd, cp)[:, :fetch], fetch)


def merge_topk_ref(part_d, part_pos, part_id):
    """Plain K3 merge: (B, splits, F) lists of (d, pos, id) triples ->
    the top-F of their union under (d, pos), stable, (B, F) each.  When
    every list is the top-F of one range of scan positions, this is the
    top-F of the whole range."""
    b, _, fetch = part_d.shape
    return _lex_topk(part_d.reshape(b, -1), part_pos.reshape(b, -1),
                     part_id.reshape(b, -1), fetch)
