#!/usr/bin/env python3
"""Where a K3 CTA spends its time, on one NVIDIA H100.

    python3 tools/k3_phases.py [--seed 0] [--n 1000000] [--wide]

Compiles a copy of ``src/repro_torch/kernels/csrc/pq_scan_topk.cu`` with
``clock64`` counters added (thread 0 of each scan CTA records them;
the kernel itself is unchanged), builds chip_smoke.py's main-path index,
and runs the copy once at the first batch of each exec mode, bitwise
against the plain version.  Per CTA it reports, in microseconds at the
SM clock nvidia-smi reads: set-up (tables into shared memory), staging
of the rounds' plan slots, scoring and queueing, flushes (sort + merge
of full queues, with retries; "networks" is the part spent in the sort
and merge networks themselves), and the final flush and write-out; and
the number of rounds and flushes.  Phases run one after another within
a CTA, so their sum is the CTA's time; CTAs on one SM overlap.  Each
mode runs twice: as built, and "alone", with the launch asking for
more shared memory than two CTAs can share, so that each CTA has its
SM to itself and its phases show what they cost without neighbours.
With ``--wide`` it runs chip_smoke.py's wide two-tier shape instead
(k 100, k_factor 10, the pq4 plane at refine factor 16: fetch 16,000),
where K3 takes its candidate-row form: the counters then time the scan
to rows (no flush runs; the row select that follows is not counted, but
is in the K3 time).
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("setup", "stage", "score", "flush", "tail", "total", "rounds",
          "flushes", "networks")

# (anchor in pq_scan_topk.cu, text that replaces it)
PROBES = (
    ("namespace {\n", "namespace {\n__device__ long long* g_phase;\n"),
    ("  extern __shared__ int smem[];\n  const int qi = blockIdx.x,",
     "  extern __shared__ int smem[];\n"
     "  long long T0 = clock64(), Tb = 0, Tc = 0, ph[9] = {0};\n"
     "  const int qi = blockIdx.x,"),
    ("  const int f_end = s1 * BLK;\n",
     "  __syncthreads();\n  ph[0] = clock64() - T0;\n"
     "  const int f_end = s1 * BLK;\n"),
    ("    const int sr = f0 / BLK;  // first position of the round\n",
     "    const int sr = f0 / BLK;  // first position of the round\n"
     "    const long long Ta = clock64();\n"),
    ("    __syncthreads();\n    const int f = f0 + tid;",
     "    __syncthreads();\n    Tb = clock64();\n    ph[1] += Tb - Ta;\n"
     "    const int f = f0 + tid;"),
    ("    }\n    __syncthreads();\n"
     "    while (!GS && __syncthreads_or(sel.any_full())) {\n"
     "      flush(sel);\n",
     "    }\n    __syncthreads();\n    Tc = clock64();\n    ph[2] += Tc - Tb;\n"
     "    ph[6]++;\n"
     "    while (!GS && __syncthreads_or(sel.any_full())) {\n"
     "      const long long Tn = clock64();\n"
     "      flush(sel);\n      ph[8] += clock64() - Tn;\n      ph[7]++;\n"),
    ("      __syncthreads();\n    }\n  }\n  __syncthreads();\n"
     "  if (!GS && sel.any_queued()) flush(sel);\n",
     "      __syncthreads();\n    }\n    ph[3] += clock64() - Tc;\n  }\n"
     "  __syncthreads();\n  const long long Te = clock64();\n"
     "  if (!GS && sel.any_queued()) flush(sel);\n"),
    ("    if (sdco[q]) atomicAdd(&dco[qi * QS + q], sdco[q]);\n}",
     "    if (sdco[q]) atomicAdd(&dco[qi * QS + q], sdco[q]);\n"
     "  if (tid == 0 && g_phase) {\n"
     "    ph[4] = clock64() - Te;\n    ph[5] = clock64() - T0;\n"
     "    long long* o = g_phase + 9 * ((size_t)split * gridDim.x + qi);\n"
     "    for (int i = 0; i < 9; ++i) o[i] = ph[i];\n  }\n}"),
    ('extern "C" {\n',
     'extern "C" {\n'
     "int set_phase_buffer(void* p) {\n"
     "  return (int)cudaMemcpyToSymbol(g_phase, &p, sizeof(p));\n}\n"),
)
# one CTA per SM: 120,000 B of shared memory, more than half of an SM's
ALONE = (("  const size_t smem =\n"
          "      scan_smem_bytes(M, K, QT, FW, BLK, global_tables != 0, gs);\n",
          "  const size_t smem0 =\n"
          "      scan_smem_bytes(M, K, QT, FW, BLK, global_tables != 0, gs);\n"
          "  const size_t smem = smem0 > 120000 ? smem0 : 120000;\n"),)


def build_probed(build, name, probes):
    """Compile a probed copy of K3; returns the loaded library."""
    text = (build.CSRC / "pq_scan_topk.cu").read_text()
    for anchor, repl in probes:
        if text.count(anchor) != 1:
            raise SystemExit(f"k3_phases: anchor not found once in "
                             f"pq_scan_topk.cu: {anchor!r}")
        text = text.replace(anchor, repl)
    out = ROOT / "build" / "k3_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(text)
    so = out / f"lib{name}.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}",
                        "-o", str(so), str(out / f"{name}.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit("k3_phases: nvcc failed:\n" + r.stdout + r.stderr)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in build._SIGNATURES["pq_scan_topk"].items():
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
    ap.add_argument("--wide", action="store_true",
                    help="the wide two-tier shape (fetch 16,000)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core import IndexConfig, build_index
    from repro_torch.data import make_dataset
    from repro_torch.kernels import build, pq_scan, ref

    libs = {"as built": build_probed(build, "phases", PROBES),
            "alone": build_probed(build, "phases_alone", PROBES + ALONE)}
    stock = build.load
    current = {}
    build.load = lambda stem: (current["lib"] if stem == "pq_scan_topk"
                               else stock(stem))
    dev = torch.device("cuda")
    x, q, _ = make_dataset("sift1m", args.seed, n=args.n, n_queries=1024,
                           device=dev)
    index = build_index(x, IndexConfig(**cs.INDEX), device=dev,
                        generator=torch.Generator().manual_seed(args.seed))
    card, limit, mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].split(", ")
    print(f"phases: {card}, {limit} W, SM clock {mhz} MHz", flush=True)
    params = {}
    current["lib"] = libs["as built"]
    if args.wide:
        from repro_torch.core import RefineParams
        params = dict(cs.WIDE, refine=RefineParams("pq4", 16))
    for mode, bsz in cs.RUNS:
        _, k3, qt, fetch, pw = cs.mode_inputs(index, q[:bsz].contiguous(),
                                              mode, **params)
        tiles = k3[4]
        splits, _ = pq_scan.topk_splits(*tiles.shape, k3[1].shape[1])
        kw = dict(query_tile=qt, fetch=fetch, packed=bool(params))
        want = ref.pq_scan_topk_ref(*k3, **kw)
        for how, lib in libs.items():
            current["lib"] = lib
            buf = torch.zeros(tiles.shape[0] * splits * len(FIELDS),
                              dtype=torch.int64, device=dev)
            if lib.set_phase_buffer(buf.data_ptr()):
                raise SystemExit("k3_phases: set_phase_buffer failed")
            got = pq_scan.pq_scan_topk_kernel(*k3, **kw, plan_width=pw)
            torch.cuda.synchronize()
            lib.set_phase_buffer(None)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"k3_phases: probed K3 differs in {mode}")
            ms = cs.cuda_ms(torch, lambda: pq_scan.pq_scan_topk_kernel(
                *k3, **kw, plan_width=pw))
            rows = buf.reshape(-1, len(FIELDS)).double().cpu().T.tolist()
            parts = []
            for name, vals in zip(FIELDS, rows):
                scale = 1.0 if name in ("rounds", "flushes") else float(mhz)
                parts.append(f"{name} mean "
                             f"{statistics.fmean(vals) / scale:.2f} "
                             f"max {max(vals) / scale:.2f}")
            print(f"phases: {mode} {how} B={bsz} QT={qt} S={tiles.shape[1]}"
                  f" splits={splits} CTAs={len(rows[0])} K3 {ms:.4f} ms "
                  "(us per CTA; counts): " + ", ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
