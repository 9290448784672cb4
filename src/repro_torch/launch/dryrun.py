"""Dry-run: plan every (arch x shape) cell on the production meshes and
record what the plan and a trace on meta tensors give.

The reference lowers and compiles each cell for 512 placeholder devices
and records XLA's memory, cost and collective analyses.  The port has
no SPMD compiler and no HLO, so each field becomes (``PERF.md`` §6):

* ``argument_size_in_bytes``: each argument's bytes divided by the
  product of the mesh axis sizes its spec uses, summed: one device's
  share, exact from shapes and specs;
* ``output_size_in_bytes``: the outputs' bytes under the plan's
  ``out_shardings`` where it gives them (None where it gives none:
  XLA chose those layouts); a prefill's is None;
* ``temp_size_in_bytes``: one card, unsharded: the peak of live memory
  while the step runs on meta tensors (``costpass.PeakMeter``) less the
  arguments' global bytes; there is no per-device figure;
* ``flops``, ``bytes_accessed``: as in ``costpass``, global and
  unsharded (the reference's compiled counts are per device after SPMD);
* ``generated_code_size_in_bytes``, ``transcendentals``, ``hlo_bytes``,
  ``collective_bytes``: no counterpart, None;
* ``lower_s`` / ``compile_s`` become ``plan_s`` / ``trace_s``.

The reference's ``parse_collective_bytes`` (collective operand bytes
read from the compiled HLO) is not ported: there is no HLO.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --multi-pod
Results cache to launch_results/torch/dryrun/<cell>.json; --force
re-runs.  No card is needed.
"""
from __future__ import annotations

import argparse
import os
import time
import traceback
from typing import Optional

import torch

from ..configs import ARCHS
from ..configs.base import SHAPES
from ..dist.sharding import NamedSharding
from ..tree import leaves
from . import costpass
from .mesh import make_production_mesh

RESULTS_DIR = os.path.join(costpass.RESULTS_ROOT, "dryrun")

NO_COUNTERPART = ("generated_code_size_in_bytes", "transcendentals",
                  "hlo_bytes", "collective_bytes")
NOTE = ("argument/output bytes: per device, from shapes and specs; "
        "temp: one card unsharded (meta peak less the global arguments); "
        "flops (GEMM only) and bytes_accessed (unfused): global; "
        "generated code, transcendentals, HLO and collective bytes: no "
        "counterpart (no SPMD compiler, no HLO)")

def sharded_bytes(tree, shardings) -> int:
    """Per-device bytes of ``tree``'s tensors, each divided by the
    number of shards its `NamedSharding` (the matching leaf of
    ``shardings``) splits it into."""
    ts, shs = leaves(tree), leaves(shardings)
    if len(ts) != len(shs):
        raise ValueError(f"{len(ts)} tensors against {len(shs)} shardings")
    total = 0
    for t, sh in zip(ts, shs):
        assert isinstance(sh, NamedSharding), sh
        total += costpass.nbytes(t) // sh.shards()
    return total


def output_bytes(out, out_shardings):
    """Per-device bytes of the outputs that the plan places: None where
    the plan gives no sharding (a subtree of None counts nothing), and
    None overall when it places nothing."""
    if out_shardings is None:
        return None
    if isinstance(out_shardings, NamedSharding):
        return sharded_bytes(out, out_shardings)
    if isinstance(out_shardings, dict):
        parts = [output_bytes(out[k], out_shardings[k])
                 for k in out_shardings]
    else:
        parts = [output_bytes(o, s) for o, s in zip(out, out_shardings)]
    parts = [p for p in parts if p is not None]
    return sum(parts) if parts else None


def run_cell(arch: str, shape: str, multi_pod: bool, force: bool = False,
             traces: Optional[dict] = None):
    """One (cell, mesh) record.  ``traces``, a dict the caller keeps,
    holds each cell's trace (fields and outputs) for the next mesh: the
    trace is the same on every mesh."""
    from .shapes import plan_cell, skip_reason
    cell_id = f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"
    out_path = os.path.join(RESULTS_DIR, cell_id + ".json")
    rec = costpass.read_record(out_path, force)
    if rec is not None:
        return rec
    reason = skip_reason(arch, shape)
    if reason:
        return costpass.write_record(out_path, {
            "cell": cell_id, "status": "skipped", "reason": reason})
    t0 = time.perf_counter()
    rec = {"cell": cell_id, "arch": arch, "shape": shape,
           "multi_pod": multi_pod}
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        plan = plan_cell(arch, shape, mesh)
        plan_s = time.perf_counter() - t0
        traces = {} if traces is None else traces
        if (arch, shape) not in traces:
            traces[arch, shape] = costpass.trace(plan.step_fn, plan.args)
        cost, out = traces[arch, shape]
        rec.update(
            status="ok", mode=plan.mode, note=plan.note,
            plan_s=round(plan_s, 2), trace_s=cost["trace_s"],
            argument_size_in_bytes=sharded_bytes(plan.args,
                                                 plan.in_shardings),
            output_size_in_bytes=output_bytes(out, plan.out_shardings),
            temp_size_in_bytes=cost["peak_bytes"] - cost["arg_bytes"],
            peak_bytes=cost["peak_bytes"], flops=cost["flops"],
            bytes_accessed=cost["bytes_accessed"], ops=cost["ops"],
            fields_note=NOTE, **{k: None for k in NO_COUNTERPART})
    except Exception:
        rec.update(status="failed", error=traceback.format_exc()[-4000:],
                   seconds=round(time.perf_counter() - t0, 1))
    return costpass.write_record(out_path, rec)


def rairs_args(multi_pod: bool):
    """The 18 arguments of the distributed RAIRS serve step at SIFT1B
    scale (``configs/rairs.py``), as meta tensors, and which of them
    shard over every mesh axis (the index's flat block-range split)."""
    from ..configs.rairs import CONFIG as R
    nd = 512 if multi_pod else 256
    blk, m = R.block, R.m_pq
    tb = ((int(R.n_vectors * 1.15) // blk) // nd + 1) * nd
    maxo, maxr, maxm = 560, 560, 64
    bq = 256   # serving batch sized to device memory

    def S(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    i32, f32 = torch.int32, torch.float32
    args = (S((tb, blk, m), torch.uint8), S((tb, blk), i32),
            S((tb, blk), i32), S((R.nlist, maxo), i32),
            S((R.nlist, maxo), i32), S((R.nlist, maxr), i32),
            S((R.nlist, maxr), i32), S((R.nlist, maxm), i32),
            S((R.nlist, R.d), f32), S((m, 16, R.d // m), f32),
            S((R.n_vectors, R.d), torch.bfloat16), S((nd,), i32),
            S((nd,), i32), S((nd,), i32), S((0, m), torch.uint8),
            S((0,), i32), S((0,), torch.bool), S((bq, R.d), f32))
    sharded = (True, True, True, False, False, False, False, False, False,
               False, True, True, True, True, False, False, False, False)
    return args, sharded, nd


def rairs_arg_bytes(multi_pod: bool) -> int:
    """One device's bytes of the rairs serve step's arguments."""
    args, sharded, nd = rairs_args(multi_pod)
    return sum(costpass.nbytes(a) // (nd if s else 1)
               for a, s in zip(args, sharded))


def run_rairs_cell(multi_pod: bool, force: bool = False):
    """The paper's own workload at SIFT1B scale: the distributed RAIRS
    serve step's arguments on the production mesh, the index split over
    every mesh axis.  Per-device argument bytes only: the port's serve
    step launches its CUDA kernels through ``ctypes``
    (``kernels/build.py``), which meta tensors cannot enter, so flops
    and temp are None."""
    cell_id = f"rairs-sift1b__serve__{'pod2' if multi_pod else 'pod1'}"
    out_path = os.path.join(RESULTS_DIR, cell_id + ".json")
    rec = costpass.read_record(out_path, force)
    if rec is not None:
        return rec
    rec = {"cell": cell_id, "arch": "rairs-sift1b", "shape": "serve",
           "multi_pod": multi_pod}
    t0 = time.perf_counter()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh.size == (512 if multi_pod else 256)
        arg_bytes = rairs_arg_bytes(multi_pod)
        rec.update(status="ok", mode="rairs_serve",
                   plan_s=round(time.perf_counter() - t0, 2), trace_s=None,
                   argument_size_in_bytes=arg_bytes,
                   output_size_in_bytes=None, temp_size_in_bytes=None,
                   flops=None, bytes_accessed=None,
                   note="arguments only: the serve step's kernels run "
                        "through ctypes, which meta tensors cannot enter",
                   **{k: None for k in NO_COUNTERPART})
    except Exception:
        rec.update(status="failed", error=traceback.format_exc()[-4000:],
                   seconds=round(time.perf_counter() - t0, 1))
    return costpass.write_record(out_path, rec)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    n_ok = n_fail = n_skip = 0
    if args.all or args.arch == "rairs-sift1b":
        for mp in meshes:
            rec = run_rairs_cell(mp, force=args.force)
            st = rec.get("status")
            n_ok += st == "ok"
            n_fail += st == "failed"
            print(f"[{rec['cell']}] {st} "
                  f"args={rec.get('argument_size_in_bytes', '-')}",
                  flush=True)
            if st == "failed":
                print(rec.get("error", "")[-800:])
        if args.arch == "rairs-sift1b":
            archs = []
    for arch in archs:
        for shape in shapes:
            traces = {}
            for mp in meshes:
                rec = run_cell(arch, shape, mp, force=args.force,
                               traces=traces)
                st = rec.get("status")
                n_ok += st == "ok"
                n_fail += st == "failed"
                n_skip += st == "skipped"
                msg = (f"[{rec['cell']}] {st} mode={rec.get('mode', '-')} "
                       f"args={rec.get('argument_size_in_bytes', '-')} "
                       f"temp={rec.get('temp_size_in_bytes', '-')} "
                       f"flops={rec.get('flops', '-')} "
                       f"trace={rec.get('trace_s', '-')}s")
                if st == "failed":
                    msg += "\n" + rec.get("error", "")[-800:]
                print(msg, flush=True)
    print(f"done: ok={n_ok} failed={n_fail} skipped={n_skip}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
