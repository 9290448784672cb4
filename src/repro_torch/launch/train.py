"""Training entry point of the port (counterpart of
``repro/launch/train.py``): ``PYTHONPATH=src python -m
repro_torch.launch.train --arch qwen3-8b --steps 100 [--reduced]``.

The loop is the reference's production skeleton on one device:
synthetic data -> train step -> periodic checkpoint -> restore of the
latest checkpoint on restart.  ``--reduced`` is the reference's flag as
it stands (``store_true`` with a default of True, so the reduced config
is always used).  The device is explicit: ``--device`` (default CUDA,
raising when there is no card; ``cpu`` runs on the CPU).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from ..configs import ARCHS
from ..device import resolve_device
from ..dist.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..train.step import TrainConfig, init_all, make_train_step


def synthetic_lm_batch(generator: torch.Generator, cfg, batch: int,
                       seq: int, device=None):
    """Random tokens (labels: the tokens shifted left by one) and the
    frontend's stub inputs, drawn from ``generator`` on its device."""
    dev = generator.device if device is None else torch.device(device)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=generator,
                           device=dev, dtype=torch.int32)
    b = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.frontend == "frame":
        b["frames"] = torch.randn((batch, seq, cfg.d_model),
                                  generator=generator, device=dev)
    if cfg.frontend == "patch":
        b["patch_embeds"] = torch.randn((batch, seq // 4, cfg.patch_dim),
                                        generator=generator, device=dev)
    if cfg.m_rope:
        b["positions3"] = torch.arange(seq, dtype=torch.int32, device=dev
                                       )[None, None].expand(3, batch, seq
                                                            ).contiguous()
    return b


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: CUDA, an error "
                         "without a card; 'cpu' trains on the CPU)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    step_fn = make_train_step(cfg, TrainConfig(accum=args.accum))

    params, opt = init_all(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    start = 0
    if latest_step(args.ckpt_dir) is not None:
        restored = restore_checkpoint(args.ckpt_dir,
                                      {"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        start = int(opt.step)
        print(f"resumed from step {start}")

    for i in range(start, args.steps):
        batch = synthetic_lm_batch(torch.Generator(device=dev).manual_seed(i),
                                   cfg, args.batch, args.seq)
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        loss = float(m["loss"])
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {loss:7.4f} "
                  f"gnorm {float(m['grad_norm']):7.3f} "
                  f"{time.perf_counter() - t0:5.2f}s", flush=True)
        if (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1,
                            {"params": params, "opt": opt})
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
