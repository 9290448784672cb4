"""The benchmark's data: a frozen copy of the SIFT1M-shaped generator.

Copied from ``src/repro_torch/data/synthetic.py`` (``make_dataset`` and its
helpers, spec ``sift1m``): the same latent-manifold Gaussian mixture
(power-law mixture mass, anisotropic covariance, a random projection to the
ambient dimension plus small ambient noise; queries are perturbed data
points).  What changed, so that a seed varies the traffic and not the corpus:

* the mixture (centres, weights, scales, projection), the corpus and the
  query pool are drawn from ``data_seed``, which the configuration fixes, as
  SIFT1M fixes its corpus and its 10,000 queries; queries perturb corpus
  points as before, from a generator of their own;
* inserted vectors, fresh samples of the same mixture, are drawn from the
  run's ``seed`` (the traffic's order is the harness's, also from it);
* the sizes come from the configuration file, not from a table.

It imports torch only: nothing of the program, so later changes to the
program cannot move the yardstick.
"""
from __future__ import annotations

import zlib
from typing import NamedTuple

import torch


class Mixture(NamedTuple):
    centers: torch.Tensor   # (k, latent)
    weights: torch.Tensor   # (k,) sums to 1
    scales: torch.Tensor    # (k, latent)
    proj: torch.Tensor      # (latent, d)


def _generator(device, seed: int, salt: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((zlib.crc32(salt.encode()) + int(seed)) % (2 ** 63))
    return g


def _choice(g, p: torch.Tensor, n: int) -> torch.Tensor:
    """n draws from the categorical p (inverse CDF on uniforms)."""
    cdf = torch.cumsum(p, 0)
    u = torch.rand(n, generator=g, device=p.device) * cdf[-1]
    return torch.searchsorted(cdf, u).clamp_max(p.shape[0] - 1)


def _sample(g, mix: Mixture, n: int) -> torch.Tensor:
    """n points of the mixture: latent draw, projection, ambient noise."""
    dev = mix.centers.device
    comp = _choice(g, mix.weights, n)
    z = mix.centers[comp] + torch.randn(
        n, mix.centers.shape[1], generator=g, device=dev) * mix.scales[comp]
    x = z @ mix.proj + torch.randn(n, mix.proj.shape[1], generator=g,
                                   device=dev) * 0.02
    return x.float().contiguous()


def corpus(data: dict, device) -> tuple:
    """(mixture, corpus (n, d) f32) from the configuration's ``data``."""
    g = _generator(device, data["data_seed"], data["spec"])
    k, latent = data["n_components"], data["latent"]
    centers = torch.randn(k, latent, generator=g, device=device)
    w = 1.0 / torch.arange(1, k + 1, device=device,
                           dtype=torch.float32) ** data["zipf"]
    scales = (0.4 + 1.2 * torch.rand(k, latent, generator=g, device=device)
              ) * data["spread"]
    proj = torch.randn(latent, data["d"], generator=g,
                       device=device) / latent ** 0.5
    mix = Mixture(centers, w / w.sum(), scales, proj)
    return mix, _sample(g, mix, data["n"])


def queries(data: dict, x: torch.Tensor) -> torch.Tensor:
    """The deployment's query pool: ``n_queries`` corpus points,
    perturbed."""
    g = _generator(x.device, data["data_seed"], data["spec"] + ".queries")
    base = torch.randint(x.shape[0], (data["n_queries"],), generator=g,
                         device=x.device)
    scale = (data["spread"] * data["query_noise"]
             / (data["d"] / data["latent"]) ** 0.5)
    noise = torch.randn(data["n_queries"], data["d"], generator=g,
                        device=x.device) * scale
    return (x[base] + noise).float().contiguous()


def inserts(data: dict, mix: Mixture, seed: int, n: int) -> torch.Tensor:
    """``n`` fresh vectors of the corpus's mixture, for a stream's writes."""
    if n == 0:
        return torch.zeros((0, data["d"]), device=mix.centers.device)
    g = _generator(mix.centers.device, seed, data["spec"] + ".inserts")
    return _sample(g, mix, n)


def checksum(x: torch.Tensor) -> int:
    """An order-sensitive checksum of a float tensor's bits."""
    bits = x.contiguous().view(torch.int32).reshape(-1).long()
    pos = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return int(((bits & 0xFFFF) * pos).sum() + ((bits >> 16) * (pos ^ 7)).sum())
