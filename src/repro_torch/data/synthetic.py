"""Synthetic datasets statistically shaped like the paper's corpora.

The same latent-manifold Gaussian mixtures as the reference
(``repro/data/synthetic.py``): cluster structure in a low-dim latent
space (power-law mixture mass, anisotropic covariance) projected to the
ambient dimension plus small ambient noise; queries are perturbed data
points, or for the T2I stand-in (``modality_gap``) a shifted mixture
with Zipf-ish data norms.  The distribution is the reference's; the
numbers are not (torch draws from its own generator), and they are
drawn on ``device`` so a million-vector corpus is made on the card.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n: int
    d: int
    n_queries: int
    n_components: int = 64
    latent: int = 24            # intrinsic dimension of the manifold
    zipf: float = 1.2           # power-law exponent of mixture weights
    spread: float = 0.35        # within-cluster sigma (latent space)
    query_noise: float = 1.0    # query perturbation scale
    metric: str = "l2"
    modality_gap: bool = False  # T2I-like: query distribution shifted


DATASETS = {
    # the reference's table (sizes scaled for a 1-core CPU; pass n= and
    # n_queries= to make_dataset for the paper's scale)
    "sift1m": DatasetSpec("sift1m", 100_000, 128, 2_000),
    "msong": DatasetSpec("msong", 60_000, 128, 1_000, n_components=48),
    "gist": DatasetSpec("gist", 50_000, 256, 1_000, n_components=48,
                        latent=32),
    "openai": DatasetSpec("openai", 60_000, 256, 1_000, n_components=96,
                          latent=40, zipf=1.0),
    "t2i": DatasetSpec("t2i", 80_000, 128, 2_000, metric="ip",
                       modality_gap=True),
    "unit": DatasetSpec("unit", 6_000, 32, 200, n_components=16, latent=12),
    "unit_ip": DatasetSpec("unit_ip", 6_000, 32, 200, n_components=16,
                           latent=12, metric="ip", modality_gap=True),
}


def _choice(g, p: torch.Tensor, n: int) -> torch.Tensor:
    """n draws from the categorical p (inverse CDF on uniforms)."""
    cdf = torch.cumsum(p, 0)
    u = torch.rand(n, generator=g, device=p.device) * cdf[-1]
    return torch.searchsorted(cdf, u).clamp_max(p.shape[0] - 1)


def _latent_mixture(g, n, k, latent, zipf, spread, dev):
    centers = torch.randn(k, latent, generator=g, device=dev)
    w = 1.0 / torch.arange(1, k + 1, device=dev, dtype=torch.float32) ** zipf
    comp = _choice(g, w / w.sum(), n)
    scales = (0.4 + 1.2 * torch.rand(k, latent, generator=g, device=dev)
              ) * spread
    return centers[comp] + torch.randn(n, latent, generator=g,
                                       device=dev) * scales[comp]


def make_dataset(name: str, seed: int = 0, *, n: Optional[int] = None,
                 n_queries: Optional[int] = None,
                 device: DeviceLike = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, DatasetSpec]:
    """Returns (data (n, D), queries (nq, D), spec), both f32 on
    ``device``.  ``n`` / ``n_queries`` override the spec's sizes."""
    dev = resolve_device(device)
    spec = DATASETS[name]
    spec = dataclasses.replace(spec, n=n or spec.n,
                               n_queries=n_queries or spec.n_queries)
    g = torch.Generator(device=dev)
    g.manual_seed(zlib.crc32(name.encode()) % (2 ** 31) + seed)
    z = _latent_mixture(g, spec.n, spec.n_components, spec.latent,
                        spec.zipf, spec.spread, dev)
    proj = torch.randn(spec.latent, spec.d, generator=g,
                       device=dev) / spec.latent ** 0.5
    x = z @ proj + torch.randn(spec.n, spec.d, generator=g, device=dev) * 0.02
    if spec.modality_gap:
        zq = _latent_mixture(g, spec.n_queries, spec.n_components,
                             spec.latent, spec.zipf, spec.spread * 1.3, dev)
        shift = torch.randn(spec.latent, generator=g, device=dev) * 0.3
        q = (zq + shift) @ proj
        if spec.metric == "ip":
            # Zipf-ish norms on the data side: Gamma(2, 1) as the sum of
            # two unit exponentials
            u = torch.rand(spec.n, 2, generator=g, device=dev)
            gamma = -torch.log1p(-u).sum(dim=1, keepdim=True)
            x = x * (1.0 + gamma * 0.3)
    else:
        base = torch.randint(spec.n, (spec.n_queries,), generator=g,
                             device=dev)
        scale = spec.spread * spec.query_noise / (spec.d / spec.latent) ** 0.5
        q = x[base] + torch.randn(spec.n_queries, spec.d, generator=g,
                                  device=dev) * scale
    return x.float().contiguous(), q.float().contiguous(), spec
