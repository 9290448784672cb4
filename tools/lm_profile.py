#!/usr/bin/env python3
"""Where a Qwen3-8B serving step's time goes on one card.

    python3 tools/lm_profile.py [--seed 0] [--kv 32768] [--prefill 8192]

Builds Qwen3-8B at full width and depth (bf16 serving weights from a
seeded CUDA generator), a zero f32 K/V cache at ``--kv`` tokens, and
profiles decode steps (B 1) and one prefill at ``--prefill`` tokens with
``torch.profiler``: the card's kernel time a step against the host
clock, kernel launches a step, and the ops and kernels that take the
most card time.  Every line carries the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def table(prof, n, what):
    rows = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    print(f"{what}: top {n} by card time (ms total, calls)")
    for e in rows[:n]:
        print(f"  {e.device_time_total / 1e3:10.3f} ms {e.count:6d}  "
              f"{e.key[:90]}")


def kernel_stats(prof):
    """(card ms, kernel launches) from the profile's device events."""
    evs = [e for e in prof.events()
           if getattr(e, "device_type", None) is not None
           and str(e.device_type).endswith("CUDA")]
    return sum(e.device_time for e in evs) / 1e3, len(evs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv", type=int, default=32_768)
    ap.add_argument("--prefill", type=int, default=8_192)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lm_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ARCHS
    from repro_torch.models.transformer import (decode_step, init_params,
                                                prefill)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = ARCHS["qwen3-8b"]
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, g, dev, serve_dtype=torch.bfloat16)
    shape = (cfg.n_periods, 1, args.kv + 64, cfg.n_kv_heads, cfg.hd)
    cache = {"blocks": {"s0": (torch.zeros(shape, device=dev),
                               torch.zeros(shape, device=dev))},
             "len": torch.full((1,), args.kv, dtype=torch.int32, device=dev)}
    tok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    for _ in range(3):
        _, cache = decode_step(params, cfg, cache, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            _, cache = decode_step(params, cfg, cache, tok)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / args.steps
    card, launches = kernel_stats(prof)
    print(f"decode at kv {args.kv}: host {1e3 * host:.3f} ms/step, card "
          f"kernels {card / args.steps:.3f} ms/step, "
          f"{launches / args.steps:.0f} kernel launches/step [{smi}]")
    table(prof, 15, f"decode [{smi}]")
    del cache
    torch.cuda.empty_cache()
    tokens = torch.randint(0, cfg.vocab, (1, args.prefill), generator=g,
                           device=dev, dtype=torch.int32)
    prefill(params, cfg, {"tokens": tokens[:, :1024]})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    card, launches = kernel_stats(prof)
    print(f"prefill at S {args.prefill}: host {1e3 * host:.1f} ms, card "
          f"kernels {card:.1f} ms, {launches} kernel launches [{smi}]")
    table(prof, 15, f"prefill [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
