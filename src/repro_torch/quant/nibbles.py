"""Packed 4-bit code layout: two codes per byte, lo nibble = even
subquantizer, hi nibble = odd.  The port's own copy of the layout the
reference defines in ``repro/quant/nibbles.py``; the scan kernels take
``packed=True`` planes in exactly this layout."""
from __future__ import annotations

import numpy as np
import torch


def packed_width(m: int) -> int:
    """Code bytes per item for an m-subquantizer 4-bit plane."""
    return (m + 1) // 2


def pack_nibbles(codes: np.ndarray) -> np.ndarray:
    """(..., M) uint8 codes < 16 -> (..., ceil(M/2)) packed bytes.

    Odd M pads a zero code into the final hi nibble; the scan's LUT is
    zero-padded to 2*ceil(M/2) rows so that phantom code contributes 0.
    """
    codes = np.asarray(codes)
    if codes.size and int(codes.max()) >= 16:
        raise ValueError("pack_nibbles needs 4-bit codes (< 16)")
    m = codes.shape[-1]
    if m % 2:
        pad = np.zeros(codes.shape[:-1] + (1,), codes.dtype)
        codes = np.concatenate([codes, pad], axis=-1)
    lo = codes[..., 0::2].astype(np.uint8)
    hi = codes[..., 1::2].astype(np.uint8)
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_nibbles(packed: torch.Tensor, m: int) -> torch.Tensor:
    """(..., ceil(M/2)) packed uint8 -> (..., m) int32 codes, in
    subquantizer order with the odd-M phantom column sliced off."""
    p = packed.to(torch.int32)
    out = torch.stack([p & 15, p >> 4], dim=-1)
    out = out.reshape(packed.shape[:-1] + (2 * packed.shape[-1],))
    return out[..., :m]
