"""The launch tooling's peak-live estimate against one call on the card.

For Qwen3-8B prefill_32k (batch 1) and Qwen3-1.7B train_4k (batch 8,
accum 8), the cells ``chip_smoke.py`` runs at full width: the step is
traced on meta tensors (``launch/costpass.py``: the estimate), then run
twice on the card from a fresh allocator state with only its inputs
resident, once under ``costpass.PeakMeter`` (which then tracks the
card's storages: what the ops return) and once plain.  Prints
``max_memory_allocated`` of each call, the meter's peak, and their
ratios to the estimate.  The prefill here has no ``cache_slack``, as
the plan's step.

Run on the card: ``python3 tools/launch_peaks.py`` (~3 min).
"""
from __future__ import annotations

import gc
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CELLS = (("qwen3-8b", "prefill_32k", 1), ("qwen3-1.7b", "train_4k", 8))


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def estimate(arch, shape, batch):
    from repro_torch.launch import costpass, shapes
    from repro_torch.launch.mesh import make_host_mesh
    saved = shapes.SHAPES
    shapes.SHAPES = dict(saved, **{shape: dict(saved[shape],
                                               global_batch=batch)})
    try:
        plan = shapes.plan_cell(arch, shape, make_host_mesh(device="meta"))
        cost, _ = costpass.trace(plan.step_fn, plan.args)
        return plan, cost, shapes.SHAPES[shape]
    finally:
        shapes.SHAPES = saved


def inputs(plan, info, dev):
    """The step and its inputs on the card, made from seed 0."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.step import make_prefill_step
    from repro_torch.train import TrainConfig, init_all, make_train_step
    cfg = ARCHS[plan.arch]
    g = torch.Generator(device=dev).manual_seed(0)
    b, s = info["global_batch"], info["seq_len"]
    if plan.mode == "train":
        params, opt = init_all(cfg, g, dev)
        data = synthetic_lm_batch(g, cfg, b, s)
        return make_train_step(cfg, TrainConfig()), (params, opt, data)
    params = init_params(cfg, g, dev, serve_dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=g, device=dev,
                           dtype=torch.int32)
    return make_prefill_step(cfg), (params, {"tokens": tokens})


def one_call(step, args, meter):
    from repro_torch.launch import costpass
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    m = costpass.PeakMeter()
    held = m.hold(args)
    t0 = time.perf_counter()
    if meter:
        with m:
            out = step(*args)
    else:
        out = step(*args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del out
    return before, held, peak, (m.peak if meter else None), dt


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_peaks: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi()
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda} [{card}]", flush=True)
    for arch, shape, batch in CELLS:
        plan, cost, info = estimate(arch, shape, batch)
        est = cost["peak_bytes"]
        print(f"{arch} {shape} batch {batch}: meta estimate {est} B "
              f"({est / 2**30:.3f} GiB, arguments {cost['arg_bytes']} B), "
              f"traced in {cost['trace_s']} s", flush=True)
        step, args = inputs(plan, info, dev)
        if plan.mode == "train":        # the step's outputs feed the next
            args = step(*args)[:2] + (args[2],)
        else:
            step(*args)                 # the first call's one-time set-up
        for meter in (True, False):
            before, held, peak, mpeak, dt = one_call(step, args, meter)
            line = (f"  {'under PeakMeter' if meter else 'plain'}: "
                    f"resident before {before} B (inputs {held}), "
                    f"max_memory_allocated {peak} B ({peak / est:.4f} of "
                    f"the estimate)")
            if meter:
                line += (f", the meter's peak over the card's storages "
                         f"{mpeak} B ({mpeak / est:.6f} of the estimate)")
            print(line + f", {dt:.1f} s [{card}]", flush=True)
        del step, args
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
