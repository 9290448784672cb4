"""RAIRS in PyTorch with hand-written Hopper kernels.

A port of the JAX package ``repro`` (the reference, which this package
never imports): build a RAIRS index (k-means IVF, 4-bit PQ, AIR
redundant assignment, the SEIL shared-cell block layout) and serve it
through the four-stage query engine.  The PQ fast-scan and the fused
scan->top-k run as CUDA C++ kernels for ``sm_90a``
(``kernels/csrc/``); every other stage is plain PyTorch.

Every entry point takes ``device=None``, which means CUDA and raises
``RuntimeError`` when no card is present; pass ``device="cpu"`` to run
the plain versions of the kernels on the CPU.
"""
from __future__ import annotations

import torch

# TF32 would change which lists pairwise_sq_l2 selects and which
# candidates survive the top-k, so every fp32 product runs in full fp32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
# The LM path's bf16 products (models/layers.py) keep an f32 accumulator
# throughout, as the reference's do.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

from .device import resolve_device  # noqa: E402,F401
