"""Gradient compression for cross-replica reduction.

Two codecs, as the reference's:
  * bf16 — 2x traffic cut, loses 16 mantissa bits (safe for grads);
  * int8 — 4x cut, per-tensor absmax scaling (absmax/127, round half to
    even, clipped to ±127).

``train/step.py`` compresses the accumulated gradients and decompresses
them before the optimizer.  `compressed_psum` is the reduction across
replicas on the port's mesh, one process holding a list of shards
(``core/sharded.py``): it takes one tree a shard and sums the compressed
values (int8 in int32, the others in f32) with the scales' max.  As in
the reference, int8 multiplies the summed codes by the largest shard's
scale, so it is exact only where the shards' scales agree.
"""
from __future__ import annotations

from functools import reduce
from typing import Sequence

import torch

from ..tree import leaves, tree_map


def compress_tree(tree, mode: str):
    """-> (compressed tree, per-leaf scales or None)."""
    if mode == "none":
        return tree, None
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), tree), None
    if mode == "int8":
        scales = tree_map(
            lambda g: torch.clamp_min(g.abs().max(), 1e-12) / 127.0, tree)
        q = tree_map(lambda g, s: torch.clamp(torch.round(g / s), -127, 127)
                     .to(torch.int8), tree, scales)
        return q, scales
    raise ValueError(mode)


def decompress_tree(tree, scales, mode: str):
    if mode == "none":
        return tree
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.float32), tree)
    if mode == "int8":
        return tree_map(lambda q, s: q.to(torch.float32) * s, tree, scales)
    raise ValueError(mode)


def compressed_psum(trees: Sequence, mode: str = "bf16"):
    """The sum over shards of ``trees`` (one per shard) with on-the-wire
    compression, on the first shard's device: what every replica of the
    reference's ``psum`` receives."""
    dev = leaves(trees[0])[0].device
    packed = [compress_tree(t, mode) for t in trees]
    comp = [c for c, _ in packed]
    if mode == "int8":
        total = tree_map(lambda *qs: reduce(torch.add, [
            q.to(dev, torch.int32) for q in qs]), *comp)
        scale = tree_map(lambda *ss: torch.stack([s.to(dev) for s in ss])
                         .amax(), *[s for _, s in packed])
        return tree_map(lambda q, s: q.to(torch.float32) * s, total, scale)
    return tree_map(lambda *cs: reduce(torch.add, [
        c.to(dev, torch.float32) for c in cs]), *comp)
