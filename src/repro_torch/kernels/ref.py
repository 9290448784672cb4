"""Plain PyTorch versions of the CUDA kernels, with their signatures:
K1, K3 and its merge, the row select, the stream's routed delta scan and
the PQ encode.

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


# ---------------------------------------------------------------------------
# the stream's routed delta scan (delta_scan_topk_kernel)
# ---------------------------------------------------------------------------
# The reference materialises (B, C, M) lookups; the plain delta scans cut
# the batch into query chunks of at most DELTA_CHUNK_BYTES (256 MiB) of
# working set, counted from the temporaries each chunk holds at once
# (routed: ``P * L * (2 M + 16 m + 48)`` bytes a query, the gathered code
# rows, the assigned lists' ranks, the sums and the keys), so their peak
# stays near 256 MiB at any batch and capacity; the kernel holds no such
# temporaries.
DELTA_CHUNK_BYTES = 2 ** 28


def _rows_per_chunk(b: int, bytes_per_query: int) -> int:
    return max(1, min(b, DELTA_CHUNK_BYTES // max(1, bytes_per_query)))


def _adc_rows(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """sum_m lut[b, m, codes[b, n, m]] over ascending m: (B, M, K) x
    (B, N, M) uint8 rows of each query's own -> (B, N) f32, one gather
    and one add per m."""
    b, n, m = codes.shape
    codes_t = codes.permute(2, 0, 1).contiguous()           # (M, B, N)
    out = torch.zeros((b, n), dtype=torch.float32, device=lut.device)
    for j in range(m):
        out.add_(torch.gather(lut[:, j, :], 1, codes_t[j].long()))
    return out


def _stable_top(d: torch.Tensor, i: torch.Tensor, n: int):
    """The stable top-``n`` of each row of ``d`` (ascending, ties by
    position) and its ``i``: a unique int64 key (the f32 bits made
    signed-monotone in [-2**31, 2**31), -0.0 taken as +0.0, above the
    column) makes ``torch.topk`` exact for either sign of distance."""
    n = min(n, d.shape[1])
    bits = (d + 0.0).view(torch.int32).long()
    mono = torch.where(bits >= 0, bits, -2 ** 31 - bits)
    col = torch.arange(d.shape[1], dtype=torch.long, device=d.device)
    key = torch.topk((mono << 32) | col, n, dim=1, largest=False,
                     sorted=True).values
    pos = key & 0xFFFFFFFF
    return torch.gather(d, 1, pos), torch.gather(i, 1, pos)


def _routed_rows(lut, delta_codes, delta_ids, delta_post, delta_assigns,
                 sel, rank_of):
    """``routed_delta_candidates`` for one chunk of queries."""
    b, p = sel.shape
    slots = delta_post[sel.long()]                          # (B, P, L)
    s0 = slots.clamp_min(0).long()
    sids = torch.where(slots >= 0, delta_ids[s0], torch.full_like(slots, -1))
    al = delta_assigns[s0]                                  # (B, P, L, m)
    r = torch.gather(rank_of, 1, al.reshape(b, -1).long()).reshape(al.shape)
    min_rank = r.min(dim=-1).values                         # (B, P, L)
    keep = (sids >= 0) & (min_rank == torch.arange(
        p, dtype=torch.int32, device=sel.device)[None, :, None])
    d = _adc_rows(lut, delta_codes[s0.reshape(b, -1)])      # (B, P*L)
    keep = keep.reshape(b, -1)
    sids = sids.reshape(b, -1)
    dd = torch.where(keep, d, torch.inf)
    di = torch.where(keep, sids, torch.full_like(sids, -1))
    return dd, di, keep.sum(dim=1).to(torch.int32)


def _routed_bytes(delta_post, delta_codes, delta_assigns, p) -> int:
    return p * delta_post.shape[1] * (2 * delta_codes.shape[1]
                                      + 16 * delta_assigns.shape[1] + 48)


def _routed_chunks(lut, delta_codes, delta_ids, delta_post, delta_assigns,
                   sel, rank_of, fetch=None):
    """``_routed_rows`` over query chunks (``DELTA_CHUNK_BYTES``), each
    chunk's stream cut to its stable top-``fetch`` when one is given."""
    b, p = sel.shape
    step = _rows_per_chunk(b, _routed_bytes(delta_post, delta_codes,
                                            delta_assigns, p))
    dds, dis, dcos = [], [], []
    for s in range(0, b, step):
        dd, di, dco = _routed_rows(
            lut[s:s + step], delta_codes, delta_ids, delta_post,
            delta_assigns, sel[s:s + step], rank_of[s:s + step])
        if fetch is not None:
            dd, di = _stable_top(dd, di, fetch)
        dds.append(dd)
        dis.append(di)
        dcos.append(dco)
    return torch.cat(dds), torch.cat(dis), torch.cat(dcos)


def routed_delta_candidates(lut, delta_codes, delta_ids, delta_post,
                            delta_assigns, sel, rank_of):
    """Delta candidates reached through the probed lists only.

    lut (B, M, K); delta_post (nlist, L) slot ids (-1 pad);
    delta_assigns (cap, m); sel (B, P) ranked probed lists; rank_of
    (B, nlist).  Returns ``(dd, di, dco)``: (B, P*L) distances / ids and
    the per-query routed DCO.  A slot assigned to several probed lists is
    scored once, at its lowest-ranked probed assigned list, so the
    candidate stream stays duplicate-free.  Computed in query chunks
    (``DELTA_CHUNK_BYTES``)."""
    return _routed_chunks(lut, delta_codes, delta_ids, delta_post,
                          delta_assigns, sel, rank_of)


def routed_delta_topk(lut, delta_codes, delta_ids, delta_post,
                      delta_assigns, sel, rank_of, fetch: int):
    """Plain ``delta_scan_topk_kernel`` (the CPU's routed delta scan):
    ``routed_delta_candidates`` with each query's stream cut to its
    stable top-``fetch`` in query chunks, and the posted slots each query
    reads.  Returns ``(dd, di, dco, walked)``."""
    dd, di, dco = _routed_chunks(lut, delta_codes, delta_ids, delta_post,
                                 delta_assigns, sel, rank_of, fetch)
    walked = (delta_post[sel.long()] >= 0).sum(dim=(1, 2), dtype=torch.int32)
    return dd, di, dco, walked


# ---------------------------------------------------------------------------
# the PQ encode (pq_encode_kernel)
# ---------------------------------------------------------------------------
def pairwise_sq_l2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances ||x - c||^2, shapes (n, D) x (k, D) -> (n, k)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)        # (n, 1)
    c2 = torch.sum(c * c, dim=-1)                       # (k,)
    xc = x @ c.T                                        # (n, k)
    return torch.clamp_min(x2 - 2.0 * xc + c2[None, :], 0.0)


def pq_encode_plain(codebooks: torch.Tensor, x: torch.Tensor,
                    chunk: int = 65536) -> torch.Tensor:
    """Plain ``pq_encode_kernel``: codebooks (M, K, dsub), x (n, M * dsub)
    -> (n, M) uint8, per subquantizer a distance matmul and argmin (first
    minimum), ``chunk`` rows at a time."""
    n, d = x.shape
    m, ksub, dsub = codebooks.shape
    out = torch.empty((n, m), dtype=torch.uint8, device=x.device)
    for s in range(0, n, chunk):
        xs = x[s:s + chunk].reshape(-1, m, dsub)
        for j in range(m):
            out[s:s + chunk, j] = torch.argmin(
                pairwise_sq_l2(xs[:, j, :], codebooks[j]), dim=-1
            ).to(torch.uint8)
    return out
