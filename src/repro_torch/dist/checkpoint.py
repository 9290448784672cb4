"""Host checkpointing: one ``step_XXXXXXXX`` directory per step holding
the flattened tree's leaves (npz), with atomic publish (write to a tmp
dir, rename) and optional retention.  Restore rebuilds the caller's
template structure, so any tree of tensors (params dict, ``OptState``,
nested caches) round-trips.

The files are the reference's: leaf ``i`` is ``leaf_%06d`` in
``jax.tree.leaves`` order (``repro_torch.tree``), so a checkpoint
written by either package restores in the other.  Leaves are written in
their own dtype; numpy has no bfloat16, so a bf16 leaf is refused (the
trainer's params and moments are f32).
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

from ..tree import leaves, unflatten

_STEP_RE = re.compile(r"^step_(\d{8})$")
_LEAVES = "leaves.npz"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.isfile(os.path.join(ckpt_dir, name, _LEAVES)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _host(leaf, i: int) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"leaf {i} is bfloat16, which numpy cannot "
                            "hold; checkpoint f32 masters")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree, keep: Optional[int] = None
                    ) -> str:
    """Write `tree` as checkpoint `step`; prune to the newest `keep`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _LEAVES),
             **{f"leaf_{i:06d}": _host(leaf, i)
                for i, leaf in enumerate(leaves(tree))})
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if keep is not None:
        for s in _steps(ckpt_dir)[:-keep]:
            shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
    return final


def restore_checkpoint(ckpt_dir: str, template, step: Optional[int] = None):
    """Load checkpoint `step` (default: latest) into `template`'s tree
    structure, each leaf on its template leaf's device.  Leaf count must
    match; dtypes/shapes come from disk."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
    with np.load(os.path.join(_step_dir(ckpt_dir, step), _LEAVES),
                 allow_pickle=False) as z:
        loaded = [z[k] for k in sorted(z.files)]
    slots = leaves(template)
    if len(loaded) != len(slots):
        raise ValueError(f"checkpoint has {len(loaded)} leaves, "
                         f"template expects {len(slots)}")
    return unflatten(template, [torch.from_numpy(v).to(t.device)
                                for v, t in zip(loaded, slots)])
