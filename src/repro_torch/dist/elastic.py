"""Elastic training: replan the mesh after node failures and rescale the
batch schedule so the optimizer sees the same global batch.

The policy is the standard one for synchronous data parallelism: keep
the per-device microbatch fixed (it was tuned for memory), shrink the
data axis to the surviving devices, and raise gradient accumulation so
``global_batch = data_size * microbatch * accum`` is preserved (rounded
up — a slightly larger global batch is preferred over a smaller one).
Devices are any hashable handles (``torch.device`` objects here).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    data_size: int
    model_size: int
    devices: tuple

    @property
    def n_devices(self) -> int:
        return self.data_size * self.model_size


def replan_mesh(devices: Sequence, model: int = 1, failed: Sequence = ()
                ) -> MeshPlan:
    """Largest (data, model) mesh over the surviving devices.  The model
    axis is fixed (tensor-parallel groups cannot shrink without a
    different parameter layout); data_size absorbs the loss."""
    failed = set(failed)
    alive = tuple(d for d in devices if d not in failed)
    if len(alive) < model:
        raise ValueError(f"only {len(alive)} devices left; "
                         f"model axis needs {model}")
    data = len(alive) // model
    return MeshPlan(data_size=data, model_size=model,
                    devices=alive[:data * model])


def rescale_batch(global_batch: int, accum: int, plan: MeshPlan,
                  orig_data_size: Optional[int] = None) -> Tuple[int, int]:
    """(new_global_batch, new_accum) preserving the per-device
    microbatch implied by the original schedule.  ``orig_data_size`` is
    the data-axis size the schedule was tuned on; it defaults to the
    new plan's (exact only when no data devices were lost — pass the
    old size after a failure so the microbatch stays fixed)."""
    orig = orig_data_size if orig_data_size is not None else plan.data_size
    micro = max(1, global_batch // max(orig * accum, 1))
    new_accum = max(accum, -(-global_batch // (plan.data_size * micro)))
    return plan.data_size * micro * new_accum, new_accum
