#!/usr/bin/env python3
"""Where a row-select CTA spends its time, on one NVIDIA H100.

    python3 tools/select_phases.py [--seed 0] [--n 1000000]

Compiles a copy of ``src/repro_torch/kernels/csrc/topk_select.cu`` with
``clock64`` counters added (thread 0 of each CTA records them after the
barrier that ends each phase; the kernel itself is unchanged), builds
chip_smoke.py's main-path index with the pq4 plane, and runs the copy on
the candidate rows of the wide two-tier case's first batch of each mode
(K3's scan to rows at fetch 16,000: k 100, k_factor 10, pq4 x 16), at
fetch 16,000 and at the plane's fetch 400, and on K3's merge shape of
the wide grouped batch (64 rows of 21 sorted lists of 16,000), each
bitwise against the plain version.  Per CTA it reports, in
microseconds at the SM clock nvidia-smi reads: the threshold (radix
select passes), the compaction, the sort and the output.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("threshold", "compact", "sort", "output", "total")

# (anchor in topk_select.cu, text that replaces it)
PROBES = (
    ("namespace {\n", "namespace {\n__device__ long long* g_phase;\n"),
    ("  const int n = row_n ? min(max(row_n[b], 0), W) : W;\n",
     "  const int n = row_n ? min(max(row_n[b], 0), W) : W;\n"
     "  const long long T0 = clock64();\n"),
    ("  // 2. compaction, in row order",
     "  __syncthreads();\n  const long long T1 = clock64();\n"
     "  // 2. compaction, in row order"),
    ("  // 3. LSD radix sort",
     "  const long long T2 = clock64();\n  // 3. LSD radix sort"),
    ("  // 4. output: the survivors in order, then pads\n",
     "  const long long T3 = clock64();\n"
     "  // 4. output: the survivors in order, then pads\n"),
    ("      out_id[ob + i] = -1;\n    }\n  }\n}\n",
     "      out_id[ob + i] = -1;\n    }\n  }\n  __syncthreads();\n"
     "  if (tid == 0 && g_phase) {\n"
     "    const long long T4 = clock64();\n"
     "    long long* o = g_phase + 5 * (size_t)b;\n"
     "    o[0] = T1 - T0; o[1] = T2 - T1; o[2] = T3 - T2; o[3] = T4 - T3;\n"
     "    o[4] = T4 - T0;\n  }\n}\n"),
    ('extern "C" {\n',
     'extern "C" {\n'
     "int set_phase_buffer(void* p) {\n"
     "  return (int)cudaMemcpyToSymbol(g_phase, &p, sizeof(p));\n}\n"),
)


def build_probed(build):
    """Compile the probed copy of the row select; returns the library."""
    text = (build.CSRC / "topk_select.cu").read_text()
    for anchor, repl in PROBES:
        if text.count(anchor) != 1:
            raise SystemExit(f"select_phases: anchor not found once in "
                             f"topk_select.cu: {anchor!r}")
        text = text.replace(anchor, repl)
    out = ROOT / "build" / "select_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "select.cu").write_text(text)
    so = out / "libselect.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}",
                        "-o", str(so), str(out / "select.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit("select_phases: nvcc failed:\n" + r.stdout + r.stderr)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in build._SIGNATURES["topk_select"].items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib.set_phase_buffer.argtypes = [ctypes.c_void_p]
    lib.set_phase_buffer.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("select_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core import IndexConfig, RefineParams, build_index
    from repro_torch.data import make_dataset
    from repro_torch.kernels import build, ops, pq_scan, ref

    lib = build_probed(build)
    stock = build.load
    build.load = lambda stem: lib if stem == "topk_select" else stock(stem)
    dev = torch.device("cuda")
    x, q, _ = make_dataset("sift1m", args.seed, n=args.n, n_queries=1024,
                           device=dev)
    index = build_index(x, IndexConfig(**cs.INDEX), device=dev,
                        generator=torch.Generator().manual_seed(args.seed))
    card, limit, mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].split(", ")
    print(f"select phases: {card}, {limit} W, SM clock {mhz} MHz",
          flush=True)

    def run(what, rows, fetch):
        b = rows[0].shape[0]
        buf = torch.zeros(b * len(FIELDS), dtype=torch.int64, device=dev)
        if lib.set_phase_buffer(buf.data_ptr()):
            raise SystemExit("select_phases: set_phase_buffer failed")
        got = pq_scan.select_topk_kernel(*rows, fetch=fetch)
        torch.cuda.synchronize()
        lib.set_phase_buffer(None)
        want = ref.select_topk_ref(*rows, fetch=fetch)
        if not all(torch.equal(a, w) for a, w in zip(got, want)):
            raise SystemExit(f"select_phases: probed select differs, {what}")
        ms = cs.cuda_ms(torch, lambda: pq_scan.select_topk_kernel(
            *rows, fetch=fetch))
        vals = buf.reshape(-1, len(FIELDS)).double().cpu().T.tolist()
        n = rows[3] if len(rows) > 3 and rows[3] is not None else None
        kept = (f", {n.float().mean().item():.1f} entries a row"
                if n is not None else "")
        print(f"select phases: {what} B={b} W={rows[0].shape[1]}{kept} "
              f"fetch={fetch}: {ms:.4f} ms (us per CTA): " + ", ".join(
                  f"{f} mean {statistics.fmean(v) / float(mhz):.2f} max "
                  f"{max(v) / float(mhz):.2f}" for f, v in zip(FIELDS, vals)),
              flush=True)

    wide = dict(cs.WIDE, refine=RefineParams("pq4", 16))
    for mode, bsz in cs.RUNS:
        _, k3, qt, fetch, pw = cs.mode_inputs(index, q[:bsz].contiguous(),
                                              mode, **wide)
        lut, _ = ops.align(k3[0], k3[1], True)
        rows = pq_scan.pq_scan_rows_kernel(lut, *k3[1:], query_tile=qt,
                                           packed=True, plan_width=pw)[:4]
        for f in (fetch, 400):
            run(f"{mode} rows", rows, f)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    parts = cs.sorted_lists(torch, g, dev, 64, 21, 16000)
    run("merge lists", tuple(x.reshape(64, -1) for x in parts), 16000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
