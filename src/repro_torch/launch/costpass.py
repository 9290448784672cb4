"""Cost pass: FLOPs, bytes and the peak of live memory per cell, traced
on meta tensors.

The reference lowers each cell with every scan unrolled and reads
XLA's ``cost_analysis``.  The port runs each cell's step on the meta
arguments that ``launch/shapes.py`` plans (shapes and dtypes, no
storage, nothing allocated) inside ``unrolled()`` and three counters:

* ``flops``: GEMM FLOPs, from ``torch.utils.flop_counter.FlopCounterMode``
  (2·M·K·N a product).  Its built-in formula for ``aten.bmm`` does not
  take the ``out_dtype`` overload that the port's batched products use
  (``models/layers.py::_bmm_f32``), so the pass maps ``aten.bmm`` to
  `_bmm_flop`; ``aten.mm`` keeps the built-in formula, which counts the
  ``out_dtype`` overload.  XLA's count also includes elementwise work:
  this one does not.
* ``bytes_accessed``: every dispatched op's input and output bytes.
  Eager ops are unfused, so this is the counterpart of the unfused HLO
  bytes (the upper bracket of a memory roofline).
* ``peak_bytes``: the high-water mark of live storage, arguments
  included (`PeakMeter`).  Meta storages are freed when Python drops
  them, as the card's are, so this estimates the caching allocator's
  ``max_memory_allocated`` of the same call, less the allocator's
  rounding and workspaces.

``transcendentals`` has no counterpart (null).  The counts are global:
the whole step on one device, unsharded.

Run: ``PYTHONPATH=src python -m repro_torch.launch.costpass --all``
(no card needed; records in ``launch_results/torch/cost/``).
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS
from ..configs.base import SHAPES
from ..models.runtime_flags import unrolled
from ..tree import leaves

RESULTS_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "launch_results", "torch")
RESULTS_DIR = os.path.join(RESULTS_ROOT, "cost")

FLOPS_NOTE = ("flops: GEMM FLOPs only (FlopCounterMode; XLA's count also "
              "has elementwise work); bytes_accessed: every dispatched op's "
              "inputs and outputs, unfused; global, one device")


def _bmm_flop(a_shape, b_shape, out_dtype=None, *, out_shape=None, **_):
    """FLOPs of ``aten.bmm``, its ``out_dtype`` overload included (the
    dtype arrives third): 2·L·M·K·N."""
    l, m, k = a_shape
    _, k2, n = b_shape
    assert k == k2, (a_shape, b_shape)
    return 2 * l * m * k * n


def flop_counter() -> FlopCounterMode:
    return FlopCounterMode(display=False,
                           custom_mapping={torch.ops.aten.bmm: _bmm_flop})


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class PeakMeter(TorchDispatchMode):
    """Counts dispatched ops and their input + output bytes, and tracks
    live storage: each storage an op returns is added once, when first
    seen, and subtracted when it is freed (a ``weakref.finalize`` on the
    storage); ``peak`` is the high-water mark.  ``hold(tree)`` counts
    storages that already exist (the arguments)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._sizes = {}
        self._lock = threading.Lock()

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._sizes:
                return
            n = st.nbytes()
            self._sizes[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        with self._lock:
            self.live -= self._sizes.pop(key, 0)

    def hold(self, tree) -> int:
        """Counts the storages of ``tree``'s tensors as live; returns
        their bytes (each storage once)."""
        before = self.live
        for t in leaves(tree):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return self.live - before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor):
                self.bytes += nbytes(t)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.bytes += nbytes(t)
                self._track(t)
        return out


def trace(step_fn, args):
    """Runs ``step_fn(*args)`` on meta args under the counters.  ->
    (record fields, the outputs)."""
    t0 = time.perf_counter()
    meter = PeakMeter()
    arg_bytes = meter.hold(args)
    with unrolled(), flop_counter() as fc, meter:
        out = step_fn(*args)
    return {"flops": float(fc.get_total_flops()),
            "bytes_accessed": float(meter.bytes),
            "transcendentals": None,
            "ops": meter.ops,
            "arg_bytes": arg_bytes,
            "peak_bytes": meter.peak,
            "trace_s": round(time.perf_counter() - t0, 1)}, out


def read_record(path, force):
    """The record at ``path`` (None when there is none or ``force``);
    makes its directory."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    return None


def write_record(path, rec):
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def run_cost(arch: str, shape: str, force: bool = False):
    from .mesh import make_host_mesh
    from .shapes import plan_cell, skip_reason
    cell_id = f"{arch}__{shape}"
    out_path = os.path.join(RESULTS_DIR, cell_id + ".json")
    rec = read_record(out_path, force)
    if rec is not None:
        return rec
    rec = {"cell": cell_id, "arch": arch, "shape": shape}
    reason = skip_reason(arch, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
    else:
        t0 = time.perf_counter()
        try:
            # a one-device mesh only to build the plan; the trace is
            # unsharded (global shapes, meta)
            plan = plan_cell(arch, shape, make_host_mesh(device="meta"))
            cost, out = trace(plan.step_fn, plan.args)
            del out
            rec.update(status="ok", mode=plan.mode, note=FLOPS_NOTE, **cost)
        except Exception:
            rec.update(status="failed",
                       error=traceback.format_exc()[-3000:],
                       seconds=round(time.perf_counter() - t0, 1))
    return write_record(out_path, rec)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    nf = 0
    for a in archs:
        for s in shapes:
            rec = run_cost(a, s, force=args.force)
            nf += rec.get("status") == "failed"
            flops = rec.get("flops")
            print(f"[{rec['cell']}] {rec.get('status')} "
                  f"flops={'-' if flops is None else f'{flops:.4e}'} "
                  f"bytes={rec.get('bytes_accessed', '-')} "
                  f"peak={rec.get('peak_bytes', '-')} "
                  f"ops={rec.get('ops', '-')} t={rec.get('trace_s', '-')}s",
                  flush=True)
            if rec.get("status") == "failed":
                print(rec["error"][-800:])
    if nf:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
