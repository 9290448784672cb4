"""Product quantization: training, encoding and ADC lookup tables.

4-bit codes (ksub = 16); LUTs are built per query (no residual), so the
estimated distance of item i is ``sum_m LUT[m, code[i, m]]``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels import ops
from .kmeans import kmeans_fit


@dataclasses.dataclass
class PQCodebook:
    """codebooks: (M, ksub, dsub) float32."""
    codebooks: torch.Tensor

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def ksub(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]


def pq_train(x: torch.Tensor, m: int, nbits: int = 4, iters: int = 15,
             sample: int = 65536,
             generator: Optional[torch.Generator] = None) -> PQCodebook:
    """Per-subspace k-means codebooks.  x: (n, D), D % m == 0."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"D={d} not divisible by M={m}")
    dsub, ksub = d // m, 2 ** nbits
    xs = x.reshape(n, m, dsub)
    books = [kmeans_fit(xs[:, j, :].contiguous(), ksub, iters=iters,
                        sample=sample, generator=generator)
             for j in range(m)]
    return PQCodebook(torch.stack(books))


def pq_encode(cb: PQCodebook, x: torch.Tensor,
              chunk: int = 65536) -> torch.Tensor:
    """Encode (n, D) -> (n, M) uint8 codes (values < ksub), through
    ``kernels/ops.py::pq_encode``: the encode kernel for a CUDA tensor
    (one launch for any n, each code in one fixed order whatever n),
    its plain version (``kernels/ref.py::pq_encode_plain``) for a CPU
    tensor.  ``chunk`` bounds the plain version's distance buffer; the
    kernel needs none and ignores it."""
    return ops.pq_encode(cb.codebooks, x, chunk)


def pq_lut(cb: PQCodebook, q: torch.Tensor) -> torch.Tensor:
    """Per-query ADC tables.  q: (B, D) -> (B, M, ksub) squared-L2 partials."""
    b, d = q.shape
    m, ksub, dsub = cb.codebooks.shape
    diff = q.reshape(b, m, 1, dsub) - cb.codebooks[None]
    return torch.sum(diff * diff, dim=-1)


def pq_lut_ip(cb: PQCodebook, q: torch.Tensor) -> torch.Tensor:
    """Inner-product ADC tables: -<q_sub, c>."""
    b, d = q.shape
    m, ksub, dsub = cb.codebooks.shape
    return -torch.einsum("bmd,mkd->bmk", q.reshape(b, m, dsub), cb.codebooks)


def pq_adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Estimated distances of one query: ``sum_m lut[m, codes[..., m]]``,
    summed over ascending m.  lut: (M, ksub); codes: (M,) or (n, M)."""
    m = lut.shape[0]
    g = lut[torch.arange(m, device=lut.device), codes.long()]   # (..., M)
    out = g[..., 0]
    for j in range(1, m):
        out = out + g[..., j]
    return out


def pq_decode(cb: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct vectors from codes: (n, M) -> (n, D)."""
    m, ksub, dsub = cb.codebooks.shape
    rec = cb.codebooks[torch.arange(m, device=codes.device)[None, :],
                       codes.long()]                            # (n, M, dsub)
    return rec.reshape(codes.shape[0], m * dsub)
