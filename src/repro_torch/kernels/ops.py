"""Dispatch layer over the scan kernels (counterpart of ``repro/kernels/ops.py``).

CUDA tensors go to the kernels, CPU tensors to their plain versions;
the choice is made by the wrappers in ``pq_scan.py`` from the tensors'
device.  The reference's 128-lane padding of M is a TPU tiling rule and
is not carried over.  The zero-pad of the LUT to ``2 * MB`` rows for a
nibble-packed plane holds on every backend: it also absorbs an odd
Mc's phantom hi nibble (a padded code selects a zero row).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .pq_scan import (delta_scan_topk_kernel, pq_encode_kernel,
                      pq_scan_paged_kernel, pq_scan_tiled_kernel,
                      pq_scan_topk_kernel)


def align(lut: torch.Tensor, block_codes: torch.Tensor, packed: bool):
    """LUT as the kernels want it: contiguous f32, and for a packed
    plane zero-padded to 2 * (code bytes) rows."""
    lut = lut.to(torch.float32).contiguous()
    if packed:
        pad = 2 * block_codes.shape[-1] - lut.shape[1]
        if pad:
            lut = F.pad(lut, (0, 0, 0, pad))
    return lut, block_codes.contiguous()


def pq_scan_paged(lut: torch.Tensor, block_codes: torch.Tensor,
                  block_idx: torch.Tensor, *,
                  packed: bool = False) -> torch.Tensor:
    """Per-query paged ADC scan.  lut (B, M, K) f32, block_codes
    (TB, BLK, MB) uint8, block_idx (B, S) (>= 0) -> (B, S, BLK) f32."""
    lut, block_codes = align(lut, block_codes, packed)
    return pq_scan_paged_kernel(lut, block_codes,
                                block_idx.to(torch.int32).contiguous(),
                                query_tile=1, packed=packed)


def pq_scan_grouped(lut: torch.Tensor, block_codes: torch.Tensor,
                    shared_idx: torch.Tensor, query_tile: int = 8,
                    *, packed: bool = False) -> torch.Tensor:
    """List-major batch mode: all B queries score the SAME scan list.
    lut (B, M, K), shared_idx (S,) -> (B, S, BLK)."""
    b = lut.shape[0]
    lut, block_codes = align(lut, block_codes, packed)
    idx = shared_idx.to(torch.int32)[None, :].expand(
        b // query_tile, shared_idx.shape[0]).contiguous()
    return pq_scan_tiled_kernel(lut, block_codes, idx,
                                query_tile=query_tile, packed=packed)


def pq_scan_tiled(lut: torch.Tensor, block_codes: torch.Tensor,
                  tile_idx: torch.Tensor, query_tile: int = 8,
                  *, packed: bool = False) -> torch.Tensor:
    """Clustered mode: each query tile scores its own scan list.
    lut (B, M, K) in cluster order, tile_idx (B // query_tile, W)
    -> (B, W, BLK)."""
    lut, block_codes = align(lut, block_codes, packed)
    return pq_scan_tiled_kernel(lut, block_codes,
                                tile_idx.to(torch.int32).contiguous(),
                                query_tile=query_tile, packed=packed)


def pq_scan_topk(lut, block_codes, block_ids, block_other, tile_idx,
                 rank_of, slot_of, rank_u, dead=None, *, fetch: int,
                 query_tile: int = 8, packed: bool = False,
                 plan_width=None):
    """Fused scan -> top-``fetch``.  tile_idx (B // query_tile, S) pages
    per-tile scan lists exactly like ``pq_scan_tiled``; ``slot_of`` /
    ``rank_u`` (B, S) map each scan position back to the query's plan
    slot (see ``core/engine/fused.py``), every slot below ``plan_width``
    (the plan's width; it sizes K3's candidate rows).  Returns
    (acc_d, acc_pos, acc_id, dco)."""
    lut, block_codes = align(lut, block_codes, packed)

    def i32(x):
        return x.to(torch.int32).contiguous()
    return pq_scan_topk_kernel(
        lut, block_codes, i32(block_ids), i32(block_other), i32(tile_idx),
        i32(rank_of), i32(slot_of), i32(rank_u),
        None if dead is None else dead.to(torch.uint8).contiguous(),
        query_tile=query_tile, fetch=fetch, packed=packed,
        plan_width=plan_width)


def delta_scan_topk(lut, delta_codes, delta_ids, delta_post, delta_assigns,
                    sel, rank_of, *, fetch: int):
    """The stream's routed delta scan, each query's stream cut to its
    stable top-``fetch``: ``(dd, di, dco, walked)`` (see
    ``pq_scan.delta_scan_topk_kernel``)."""
    def i32(x):
        return x.to(torch.int32).contiguous()
    return delta_scan_topk_kernel(
        lut.to(torch.float32).contiguous(), delta_codes.contiguous(),
        i32(delta_ids), i32(delta_post), i32(delta_assigns), i32(sel),
        i32(rank_of), fetch=fetch)


def pq_encode(codebooks: torch.Tensor, x: torch.Tensor,
              chunk: int = 65536) -> torch.Tensor:
    """PQ codes (n, M) uint8 of rows x (n, M * dsub) against codebooks
    (M, K, dsub), both taken as contiguous f32 (see
    ``pq_scan.pq_encode_kernel``; ``chunk`` is the plain version's)."""
    return pq_encode_kernel(codebooks.to(torch.float32).contiguous(),
                            x.to(torch.float32).contiguous(), chunk)
