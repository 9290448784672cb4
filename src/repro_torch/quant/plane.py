"""Compact code planes: the tier-1 side of the quantization ladder
(counterpart of ``repro/quant/plane.py``).

A two-tier search runs the unchanged engine over a compact plane: a
second, coarser set of per-item codes laid out in the index's own SEIL
block geometry and nibble-packed.  The session substitutes three
things (``core/searcher.py``): the plane's packed block codes for
``arrays.block_codes``, the plane's codec for the ADC tables, and a
survivor budget widened to ``bigk * refine_factor``.  Tier 2 is the
engine's exact re-rank in ``finalize_candidates``.

Every backend is a ``PQCodebook`` with 16 centroids per subspace, so
tables, encoding and scanning reuse ``core/pq.py`` and the kernels'
``packed=True`` form:

``pq4``     a coarser product quantizer (``pq_train`` at dsub 8, or 4 / 2
            for small or odd dims): Mc = D / 8 against the full plane's
            M = D / 2, 8 code bytes per item at D = 128 once packed.
``binary``  a sign code with a closed-form codebook over groups of 4
            dims: corner c of group g is ``mean + scale * (2 bit_j(c) -
            1)``, with the corpus mean and standard deviation (ddof 0)
            computed in numpy on the host as the reference does, so the
            codec is bitwise the reference's.  Nearest-corner encoding is
            the sign bit of ``x - mean`` per dimension.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.pq import PQCodebook, pq_encode, pq_train
from ..device import DeviceLike, resolve_device
from .nibbles import pack_nibbles

PLANE_BACKENDS: Tuple[str, ...] = ("pq4", "binary")


def compact_subdim(d: int) -> int:
    """Subspace width of the pq4 plane: as coarse as the dim allows."""
    if d % 8 == 0 and d >= 16:
        return 8
    if d % 4 == 0:
        return 4
    if d % 2 == 0:
        return 2
    raise ValueError(f"pq4 plane needs an even dimension, got d={d}")


@dataclasses.dataclass(frozen=True)
class PlanePack:
    """One attached compact plane: codec, per-id codes, block layout.

    ``codes`` (n, Mc) uint8 on the host are the persistent form;
    ``block_codes`` (TB, BLK, ceil(Mc/2)) uint8 on the index's device is
    the scan form, the SEIL block gather of ``codes``, nibble-packed."""
    backend: str
    codec: PQCodebook           # (Mc, 16, dsub) f32 on the device
    codes: np.ndarray           # (n, Mc) uint8
    block_codes: torch.Tensor   # (TB, BLK, ceil(Mc/2)) uint8

    @property
    def m(self) -> int:
        return int(self.codec.codebooks.shape[0])

    @property
    def ksub(self) -> int:
        return int(self.codec.codebooks.shape[1])

    @property
    def bytes_per_item(self) -> int:
        return int(self.block_codes.shape[-1])


def _device(x, device: DeviceLike) -> torch.device:
    """``device``, or when None the device of ``x`` if it is a tensor,
    else CUDA."""
    if device is None and torch.is_tensor(x):
        return x.device
    return resolve_device(device)


def _as_tensor(vectors, device: torch.device) -> torch.Tensor:
    if isinstance(vectors, np.ndarray):
        vectors = torch.from_numpy(vectors)
    return vectors.to(device=device, dtype=torch.float32)


def train_plane(backend: str, vectors, *, iters: int = 10,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> PQCodebook:
    """Train (pq4, with ``generator``, a CPU ``torch.Generator``) or
    derive (binary) a compact-plane codec on ``device`` (None: the
    vectors' device if they are a tensor, else CUDA)."""
    dev = _device(vectors, device)
    if backend == "pq4":
        x = _as_tensor(vectors, dev)
        return pq_train(x, x.shape[1] // compact_subdim(x.shape[1]),
                        nbits=4, iters=iters, generator=generator)
    if backend == "binary":
        x = (vectors.detach().cpu().numpy() if torch.is_tensor(vectors)
             else np.asarray(vectors, np.float32))
        d = x.shape[1]
        group = 4 if d % 4 == 0 else (2 if d % 2 == 0 else 1)
        mc = d // group
        mean = x.mean(axis=0)
        scale = x.std(axis=0) + 1e-6
        bits = (np.arange(2 ** group)[:, None]
                >> np.arange(group)[None, :]) & 1          # (ksub, group)
        signs = 2.0 * bits.astype(np.float32) - 1.0
        books = (mean.reshape(mc, 1, group)
                 + scale.reshape(mc, 1, group) * signs[None, :, :])
        return PQCodebook(torch.from_numpy(
            np.ascontiguousarray(books, np.float32)).to(dev))
    raise ValueError(f"unknown plane backend {backend!r}; "
                     f"choose from {PLANE_BACKENDS}")


def encode_plane(codec: PQCodebook, vectors) -> np.ndarray:
    """Encode vectors against a plane codec on the codec's device ->
    (n, Mc) uint8 on the host."""
    dev = codec.codebooks.device
    x = _as_tensor(vectors, dev)
    if x.shape[0] == 0:
        return np.zeros((0, codec.m), np.uint8)
    return pq_encode(codec, x).cpu().numpy()


def plane_block_codes(codes: np.ndarray, block_ids,
                      device: DeviceLike = None) -> torch.Tensor:
    """Gather per-id plane codes into the SEIL block layout and pack:
    codes (n, Mc) uint8, block_ids (TB, BLK) int32 with -1 invalid ->
    (TB, BLK, ceil(Mc/2)) uint8 on ``device`` (None: block_ids' device
    if it is a tensor, else CUDA).  A host gather: invalid slots carry
    zero codes, which the scan masks by id."""
    dev = _device(block_ids, device)
    ids = (block_ids.cpu().numpy() if torch.is_tensor(block_ids)
           else np.asarray(block_ids))
    per_block = (np.asarray(codes)[np.maximum(ids, 0)]
                 * (ids >= 0)[..., None].astype(np.uint8))
    return torch.from_numpy(pack_nibbles(per_block)).to(dev)


def build_plane(backend: str, vectors, block_ids, *,
                codec: Optional[PQCodebook] = None, iters: int = 10,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> PlanePack:
    """Train (unless a codec is carried over), encode and lay out a plane
    on ``device`` (None: the vectors' device if a tensor, else CUDA)."""
    dev = _device(vectors, device)
    if codec is None:
        codec = train_plane(backend, vectors, iters=iters,
                            generator=generator, device=dev)
    if (codec.codebooks.device != dev
            or codec.codebooks.dtype != torch.float32):
        codec = PQCodebook(codec.codebooks.to(device=dev,
                                              dtype=torch.float32))
    codes = encode_plane(codec, vectors)
    return PlanePack(backend=backend, codec=codec, codes=codes,
                     block_codes=plane_block_codes(codes, block_ids, dev))
