#!/usr/bin/env python3
"""What sets K1's pace on one NVIDIA H100: code traffic or table lookups.

    python3 tools/k1_limits.py [--seed 0] [--n 1000000]

Compiles copies of ``src/repro_torch/kernels/csrc/pq_scan.cu`` (with its
header ``adc.cuh``) changed at anchors in the source; the script fails
if an anchor no longer matches once.  The variants:

  * "as built"      the kernel the package builds, unchanged;
  * "memory only"   reads the tile lists and the code rows and writes the
                    output as built, but replaces each table lookup with
                    a register add of the code byte;
  * "lookups only"  derives each code row from its item index (no tile
                    list and no code row is read from device memory) and
                    does every table lookup and add as built; this holds
                    for the main path's instantiations, the ones timed.

It builds chip_smoke.py's main-path index and times each variant with
CUDA events at the first main-path batch of each exec mode, in turns
(as built, memory only, lookups only, as built), after holding "as
built" bitwise against the plain version there.  Beside the times it
prints the byte bound, the lookup floor and the code bytes the batch
reads, and the registers and spills ptxas reports for each variant.

Then it builds chip_smoke.py's nbits=8 index, whose K = 256 runs K1's
generic instantiations in every mode, and times, at each mode's first
batch, "as built" against "generic uncapped": the generic kernel
without its two-CTAs-per-SM register cap (``__launch_bounds__(NT,
2)``), in turns (as built, uncapped, uncapped, as built), after
holding both bitwise against the plain version there.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# variant -> ((file, anchor, text that replaces it), ...)
VARIANTS = {
    "memory only": (
        ("adc.cuh",
         "acc[q] = acc[q] + *reinterpret_cast<const float*>(e + 4 * q * MB * K);",
         "acc[q] = acc[q] + __uint_as_float(static_cast<uint32_t>(e - base));"),
        ("adc.cuh", "acc = acc + ql[(2 * c) * K + (byte & 15u)];",
         "acc = acc + __uint_as_float(byte & 15u);"),
        ("adc.cuh", "acc = acc + ql[(2 * c + 1) * K + (byte >> 4)];",
         "acc = acc + __uint_as_float(byte >> 4);"),
        ("adc.cuh", "acc = acc + ql[c * K + byte];",
         "acc = acc + __uint_as_float(byte);"),
    ),
    # the main path's instantiations: codes < 16 derived from the item
    "lookups only": (
        ("pq_scan.cu", "sidx[j] = tile_idx[s0 + j];", "sidx[j] = s0 + j;"),
        ("pq_scan.cu", "for (int v = 0; v < V; ++v) r[v] = __ldg(row + v);",
         "for (int v = 0; v < V; ++v) {\n"
         "      const uint32_t h = ((uint32_t)f * 4u + v) * 0x9E3779B1u;\n"
         "      r[v] = make_uint4(h & 0x0F0F0F0Fu, (h >> 3) & 0x0F0F0F0Fu,\n"
         "                        (h >> 7) & 0x0F0F0F0Fu,"
         " (h >> 11) & 0x0F0F0F0Fu);\n    }"),
    ),
}
# the generic instantiations without their register cap
UNCAPPED = ("generic uncapped", (
    ("pq_scan.cu", "__launch_bounds__(NT, 2) pq_scan_generic(",
     "__launch_bounds__(NT) pq_scan_generic("),))


def build_variant(build, name, edits):
    """Compile a changed copy of K1; returns (library, ptxas lines)."""
    out = ROOT / "build" / "k1_limits" / name.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    texts = {f: (build.CSRC / f).read_text() for f in ("pq_scan.cu", "adc.cuh")}
    for f, anchor, repl in edits:
        if texts[f].count(anchor) != 1:
            raise SystemExit(f"k1_limits: anchor not found once in {f}: "
                             f"{anchor!r}")
        texts[f] = texts[f].replace(anchor, repl)
    for f, text in texts.items():
        (out / f).write_text(text)
    so = out / "libpq_scan.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                        str(out / "pq_scan.cu")], capture_output=True,
                       text=True)
    if r.returncode:
        raise SystemExit(f"k1_limits: nvcc failed for {name}:\n" + r.stdout
                         + r.stderr)
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in build._SIGNATURES["pq_scan"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib, ptxas_lines(r.stdout + r.stderr)


def ptxas_lines(text):
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_limits: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core import IndexConfig, build_index
    from repro_torch.data import make_dataset
    from repro_torch.kernels import build, pq_scan, ref

    stock = build.load
    libs = {"as built": stock("pq_scan")}
    for stem, text in getattr(build.build_all, "logs", {}).items():
        if stem == "pq_scan":
            for ln in ptxas_lines(text):
                print(f"ptxas: as built: {ln}", flush=True)
    for name, edits in (*VARIANTS.items(), UNCAPPED):
        libs[name], lines = build_variant(build, name, edits)
        for ln in lines:
            print(f"ptxas: {name}: {ln}", flush=True)
    current = {}
    build.load = lambda stem: (current["lib"] if stem == "pq_scan"
                               else stock(stem))
    dev = torch.device("cuda")
    x, q, _ = make_dataset("sift1m", args.seed, n=args.n, n_queries=1024,
                           device=dev)
    index = build_index(x, IndexConfig(**cs.INDEX), device=dev,
                        generator=torch.Generator().manual_seed(args.seed))
    card, limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].split(", ")
    print(f"limits: {card}, {limit} W", flush=True)
    rate = cs.lookup_rate(torch)
    for mode, bsz in cs.RUNS:
        k1, _, qt, _ = cs.mode_inputs(index, q[:bsz].contiguous(), mode)
        lut, codes, tiles = k1
        current["lib"] = libs["as built"]
        got = pq_scan.pq_scan_tiled_kernel(*k1, query_tile=qt)
        if not torch.equal(got, ref.pq_scan_tiled_ref(*k1, query_tile=qt)):
            raise SystemExit(f"k1_limits: K1 differs from its plain version "
                             f"in {mode}")
        del got
        nbytes, lookups = cs.k1_bound(torch, k1)
        bms, by = cs.bound_ms(sum(nbytes.values()), lookups)
        code_reads = tiles.numel() * codes.shape[1] * codes.shape[2]
        times = []
        for name in ("as built", "memory only", "lookups only", "as built"):
            current["lib"] = libs[name]
            ms = cs.cuda_ms(torch, lambda: pq_scan.pq_scan_tiled_kernel(
                *k1, query_tile=qt))
            times.append(f"{name} {ms:.4f} ms")
        print(f"limits: {mode} B={lut.shape[0]} QT={qt} S={tiles.shape[1]}: "
              + ", ".join(times) + f"; bound {bms:.4f} ms ({by}), lookup "
              f"floor {lookups / rate * 1e3:.4f} ms ({lookups} lookups), "
              f"code reads {code_reads} B = "
              f"{code_reads / cs.HBM_BYTES_PER_S * 1e3:.4f} ms at the HBM "
              "rate", flush=True)
    del index, x, q
    x, q, _ = make_dataset("sift1m", args.seed, n=cs.NBITS8_N,
                           n_queries=1024, device=dev)
    index = build_index(x, IndexConfig(**cs.NBITS8_INDEX), device=dev,
                        generator=torch.Generator().manual_seed(args.seed))
    for mode, bsz in cs.RUNS:
        k1, _, qt, _ = cs.mode_inputs(index, q[:bsz].contiguous(), mode)
        lut, codes, tiles = k1
        want = ref.pq_scan_tiled_ref(*k1, query_tile=qt)
        times = []
        for name in ("as built", UNCAPPED[0], UNCAPPED[0], "as built"):
            current["lib"] = libs[name]
            if not torch.equal(pq_scan.pq_scan_tiled_kernel(
                    *k1, query_tile=qt), want):
                raise SystemExit(f"k1_limits: {name} K1 differs from its "
                                 f"plain version at nbits8 {mode}")
            ms = cs.cuda_ms(torch, lambda: pq_scan.pq_scan_tiled_kernel(
                *k1, query_tile=qt))
            times.append(f"{name} {ms:.4f} ms")
        lookups = cs.k1_bound(torch, k1)[1]
        print(f"limits: nbits8 {mode} B={lut.shape[0]} QT={qt} "
              f"S={tiles.shape[1]} K={lut.shape[2]}: " + ", ".join(times)
              + f"; lookup floor {lookups / rate * 1e3:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
