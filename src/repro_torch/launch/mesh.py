"""Production mesh construction (single-pod 16x16, multi-pod 2x16x16).

The production meshes are made of ``meta`` devices: the port plans the
reference's meshes (shapes, axis names, shardings) without any card or
allocation, as the reference plans on abstract devices.  The host mesh
is over the cards that are visible.
"""
from __future__ import annotations

import torch

from ..core.sharded import Mesh
from ..device import DeviceLike, resolve_device


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for d in shape:
        n *= d
    return Mesh([torch.device("meta")] * n, axes, shape)


def make_host_mesh(*, model: int = 1, device: DeviceLike = None) -> Mesh:
    """A (data, model) mesh over the visible cards (``device`` None:
    CUDA, raising when there is none, as ``resolve_device`` does); a
    named device (``"cpu"``, ``"meta"``, ``"cuda:1"``) gives a mesh of
    that one device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [dev]
    n = len(devs)
    return Mesh(devs, ("data", "model"), (n // model, model))
