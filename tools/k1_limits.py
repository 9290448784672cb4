#!/usr/bin/env python3
"""What sets K1's pace on one NVIDIA H100: code traffic, table lookups or,
in the staged form, the staging of the tables.

    python3 tools/k1_limits.py [--seed 0] [--n 1000000]
    python3 tools/k1_limits.py --plane pq4      # or binary
    python3 tools/k1_limits.py --gist
    python3 tools/k1_limits.py --nbits8 [--n N]

Compiles copies of ``src/repro_torch/kernels/csrc/pq_scan.cu`` (with its
header ``adc.cuh``) changed at anchors in the source; the script fails
if an anchor no longer matches once.  The variants:

  * "as built"      the kernel the package builds, unchanged;
  * "memory only"   reads the tile lists and the code rows (and stages the
                    tables) and writes the output as built, but replaces
                    each table lookup with a register add of the code;
  * "lookups only"  derives each code row from its item index (no tile
                    list and no code row is read from device memory) and
                    does every table lookup and add as built: the fast,
                    packed and staged forms;
  * "staging only"  the staged form's ranges of tables staged as built,
                    pass by pass, with no code read, no lookup and no
                    output written: what the staging costs alone;
  * "generic uncapped"  the generic form without its two-CTAs-per-SM
                    register cap (``__launch_bounds__(NT, 2)``);
  * "k256 ranges of 8"  the k256 form's tiles with ranges of 8
                    subquantizers (two 64 KB buffers) at one CTA an SM,
                    beside the built ranges of 4 at two;
  * "k256 512 threads"  ranges of 8 at one CTA an SM of 512 threads, 4
                    items each (the same pass of 2,048 items);
  * "generic"       not a copy: the library as built with ``k1_form``
                    patched to pick the generic form (and its query
                    groups) where it picks k256, the form the nbits=8
                    path ran before k256.

With no option it builds chip_smoke.py's main-path index and times "as
built", "memory only", "lookups only", "as built" (in turns, CUDA events)
at the first batch of each exec mode, after holding "as built" bitwise
against the plain version there; then chip_smoke.py's nbits=8 index,
whose K = 256 runs the k256 form: as built, memory only, lookups only,
staging only, k256 ranges of 8, k256 512 threads, generic, as built,
each form held
bitwise.
``--plane pq4|binary`` attaches both compact planes to the main index
and times the packed form at the two-tier shapes (refine factor 4) in
the same turns; ``--gist`` builds chip_smoke.py's gist-shaped index
(PQ256x8: the staged form) and times as built, memory only, lookups
only, staging only, as built.  ``--nbits8`` runs the nbits=8 part
alone; with ``--n N`` too, on the N-vector corpus at the main path's
IVF4096 built at ``nbits=8`` (Faiss's ``IVF4096,PQ64``) instead of
chip_smoke.py's 80,000-vector IVF1024 index.  Beside the times: the byte bound, the
lookup floor, the code bytes the batch reads, and the registers and
spills ptxas reports for each variant.
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
        ("adc.cuh",
         "acc[q] = acc[q] + *reinterpret_cast<const float*>(el + 4 * q * M * K);",
         "acc[q] = acc[q] + __uint_as_float(static_cast<uint32_t>(el - base));"),
        ("adc.cuh",
         "acc[q] = acc[q] + *reinterpret_cast<const float*>(eh + 4 * q * M * K);",
         "acc[q] = acc[q] + __uint_as_float(static_cast<uint32_t>(eh - base));"),
        ("adc.cuh", "acc = acc + ql[(2 * c) * K + (byte & 15u)];",
         "acc = acc + __uint_as_float(byte & 15u);"),
        ("adc.cuh", "acc = acc + ql[(2 * c + 1) * K + (byte >> 4)];",
         "acc = acc + __uint_as_float(byte >> 4);"),
        ("adc.cuh", "acc = acc + ql[c * K + byte];",
         "acc = acc + __uint_as_float(byte);"),
        ("pq_scan.cu", "acc[i][0] = acc[i][0] + tb[j * SK + code];",
         "acc[i][0] = acc[i][0] + __uint_as_float(code);"),
        ("pq_scan.cu",
         "const float4 e = *reinterpret_cast<const float4*>(\n"
         "                  tb + 4 * ((2 * j + h) * SK + code));",
         "const float4 e = make_float4(\n"
         "                  __uint_as_float(code), __uint_as_float(code + 1),\n"
         "                  __uint_as_float(code + 2), __uint_as_float(code + h));"),
        # the k256 form
        ("adc.cuh", "acc = acc + t[j * 256 + code];",
         "acc = acc + __uint_as_float(code);"),
        ("pq_scan.cu", "const float4 lo = tb[(2 * j) * K256 + code];",
         "const float4 lo = make_float4(__uint_as_float(code), "
         "__uint_as_float(code + 1), __uint_as_float(code + 2), "
         "__uint_as_float(code + 3));"),
        ("pq_scan.cu", "const float4 hi = tb[(2 * j + 1) * K256 + code];",
         "const float4 hi = make_float4(__uint_as_float(code + 4), "
         "__uint_as_float(code + 5), __uint_as_float(code + 6), "
         "__uint_as_float(code + 7));"),
    ),
    # codes (< 16, or < 256 staged) derived from the item
    "lookups only": (
        ("pq_scan.cu", "sidx[j] = tile_idx[s0 + j];", "sidx[j] = s0 + j;"),
        ("pq_scan.cu", "for (int v = 0; v < V; ++v) r[v] = __ldg(row + v);",
         "for (int v = 0; v < V; ++v) {\n"
         "      const uint32_t h = ((uint32_t)f * 4u + v) * 0x9E3779B1u;\n"
         "      r[v] = make_uint4(h & 0x0F0F0F0Fu, (h >> 3) & 0x0F0F0F0Fu,\n"
         "                        (h >> 7) & 0x0F0F0F0Fu,"
         " (h >> 11) & 0x0F0F0F0Fu);\n    }"),
        ("pq_scan.cu",
         "const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));",
         "const uint32_t h = (uint32_t)(size_t)row * 0x9E3779B1u;\n"
         "      const uint4 v = make_uint4(h, h >> 3 | h << 29, h >> 7 | h "
         "<< 25, h >> 11 | h << 21);"),
        ("pq_scan.cu",
         "const uint2 v = __ldg(reinterpret_cast<const uint2*>(row));",
         "const uint32_t h = (uint32_t)(size_t)row * 0x9E3779B1u;\n"
         "      const uint2 v = make_uint2(h, h >> 7 | h << 25);"),
        ("pq_scan.cu",
         "const uint8_t* pc =\n"
         "            codes + (size_t)item[i] * MB + (PACKED ? m0 / 2 : m0);",
         "{\n          const uint32_t h = ((uint32_t)(first + i * NT) + m0)"
         " * 0x9E3779B1u;\n          d[i][0] = h;\n"
         "          d[i][CW - 1] ^= h >> 7 | h << 25;\n          continue;\n"
         "        }\n        const uint8_t* pc =\n"
         "            codes + (size_t)item[i] * MB + (PACKED ? m0 / 2 : m0);"),
        # the k256 form: the positions, and every code piece, from the item
        ("pq_scan.cu",
         "pidx[j] = tile_idx[(size_t)qi * S + s0 + j];\n  cp_async_wait_all();",
         "pidx[j] = s0 + j;\n  cp_async_wait_all();"),
        ("pq_scan.cu",
         "pidx[j] = tile_idx[(size_t)qi * S + s0 + j];\n  __syncthreads();",
         "pidx[j] = s0 + j;\n  __syncthreads();"),
        ("pq_scan.cu", "if (row) cur = __ldg(row);",
         "if (row) cur = k256_hash<Piece>(row);"),
        ("pq_scan.cu", "nxt = __ldg(row + v + 1);",
         "nxt = k256_hash<Piece>(row + v + 1);"),
        ("pq_scan.cu", "nxt = __ldg(next_row);",
         "nxt = k256_hash<Piece>(next_row);"),
        ("pq_scan.cu",
         "__ldg(reinterpret_cast<const uint2*>(rows[i] + m0));",
         "k256_hash<uint2>(rows[i] + m0);"),
        ("pq_scan.cu",
         "__ldg(reinterpret_cast<const uint32_t*>(rows[i] + m0));",
         "k256_hash<uint32_t>(rows[i] + m0);"),
        ("pq_scan.cu", "constexpr int K256 = 256;\n",
         "constexpr int K256 = 256;\n"
         "template <typename P>\n"
         "__device__ __forceinline__ P k256_hash(const void* p) {\n"
         "  const uint32_t h = (uint32_t)(size_t)p * 0x9E3779B1u;\n"
         "  P r;\n  uint32_t* w = reinterpret_cast<uint32_t*>(&r);\n"
         "  for (int i = 0; i < (int)(sizeof(P) / 4); ++i)\n"
         "    w[i] = h >> (3 * i) | h << (32 - 3 * i);\n"
         "  return r;\n}\n"),
    ),
    "staging only": (
        ("pq_scan.cu",
         "const int cnt = first < n ? min(IPT, (n - first + NT - 1) / NT) : 0;",
         "const int cnt = 0;"),
        ("pq_scan.cu",
         "const int cnt = first < n ? min(KIPT, (n - first + KNT - 1) / KNT) "
         ": 0;",
         "const int cnt = 0;"),
    ),
    # the k256 tile form sized for one CTA an SM: ranges of 8
    # subquantizers (two 64 KB buffers) and no register cap of two
    "k256 ranges of 8": (
        ("pq_scan.cu", "constexpr int KR = 4;", "constexpr int KR = 8;"),
        ("pq_scan.cu", "__launch_bounds__(KNT, 2) pq_scan_k256_tile(",
         "__launch_bounds__(KNT, 1) pq_scan_k256_tile("),
    ),
    # ... and with 512 threads of 4 items each: 16 warps an SM, as two
    # CTAs of ranges of 4 have, and half their code loads
    "k256 512 threads": (
        ("pq_scan.cu", "constexpr int KR = 4;", "constexpr int KR = 8;"),
        ("pq_scan.cu", "constexpr int KIPT = 8;", "constexpr int KIPT = 4;"),
        ("pq_scan.cu", "constexpr int KNT = 256;", "constexpr int KNT = 512;"),
        ("pq_scan.cu", "__launch_bounds__(KNT, 2) pq_scan_k256_tile(",
         "__launch_bounds__(KNT, 1) pq_scan_k256_tile("),
    ),
    "generic uncapped": (
        ("pq_scan.cu", "__launch_bounds__(NT, 2) pq_scan_generic(",
         "__launch_bounds__(NT) pq_scan_generic("),
    ),
}


# variants held bitwise against the plain version before they are timed
HELD = ("as built", "generic uncapped", "k256 ranges of 8",
        "k256 512 threads", "generic")


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


def k1_inputs(cs, ops, index, q, mode, **params):
    """K1's (lut, codes, tile_idx) at one batch of ``mode`` as the search
    path makes them (the packed tables padded as ops pads them), its
    query tile and whether its codes are packed."""
    sess = index.searcher(**dict(cs.SEARCH, **params), device=index.device)
    packed = sess._scan_state()[2]
    k1, _, qt, _, _ = cs.mode_inputs(index, q, mode, **params)
    if packed:
        k1 = (ops.align(k1[0], k1[1], True)[0],) + k1[1:]
    return k1, qt, packed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=None,
                    help="corpus size (default 1,000,000; with --nbits8 "
                    "chip_smoke.py's nbits=8 index, and with --n the main "
                    "path's IVF4096 at nbits=8)")
    shape = ap.add_mutually_exclusive_group()
    shape.add_argument("--nbits8", action="store_true",
                       help="the nbits=8 part alone")
    shape.add_argument("--plane", choices=("pq4", "binary"),
                       help="the packed form at the two-tier shapes")
    shape.add_argument("--gist", action="store_true",
                       help="the staged form on the gist-shaped index")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_limits: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core import IndexConfig, RefineParams, build_index
    from repro_torch.data import make_dataset
    from repro_torch.kernels import build, ops, pq_scan, ref

    stock = build.load
    libs = {"as built": stock("pq_scan")}
    for stem, text in getattr(build.build_all, "logs", {}).items():
        if stem == "pq_scan":
            for ln in ptxas_lines(text):
                print(f"ptxas: as built: {ln}", flush=True)
    if args.gist:
        names = ("memory only", "lookups only", "staging only")
    elif args.plane:
        names = ("memory only", "lookups only")
    else:
        names = ("memory only", "lookups only", "staging only",
                 "k256 ranges of 8", "k256 512 threads")
    for name in names:
        libs[name], lines = build_variant(build, name, VARIANTS[name])
        for ln in lines:
            print(f"ptxas: {name}: {ln}", flush=True)
    current = {}
    build.load = lambda stem: (current["lib"] if stem == "pq_scan"
                               else stock(stem))
    libs["generic"] = libs["as built"]
    k1_form = pq_scan.k1_form

    def use(name):
        """Run K1 as variant ``name`` from here on."""
        current["lib"] = libs[name]
        if name == "generic":
            pq_scan.k1_form = lambda *a: ("generic" if k1_form(*a) == "k256"
                                          else k1_form(*a))
        else:
            pq_scan.k1_form = k1_form
    dev = torch.device("cuda")
    card, limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].split(", ")
    print(f"limits: {card}, {limit} W", flush=True)
    rate = cs.lookup_rate(torch)

    def turns(what, index, q, order, **params):
        """Each variant in ``order`` timed at the first batch of each
        mode, after "as built" (and "generic uncapped") is held bitwise
        against the plain version."""
        for mode, bsz in cs.RUNS:
            k1, qt, packed = k1_inputs(cs, ops, index, q[:bsz].contiguous(),
                                       mode, **params)
            forms = {}
            lut, codes, tiles = k1
            kw = dict(query_tile=qt, packed=packed)
            want = ref.pq_scan_tiled_ref(*k1, **kw)
            for name in [n for n in order if n in HELD]:
                use(name)
                pq_scan.reset_launch_counts()
                if not torch.equal(pq_scan.pq_scan_tiled_kernel(*k1, **kw),
                                   want):
                    raise SystemExit(f"k1_limits: {name} K1 differs from "
                                     f"its plain version at {what} {mode}")
                forms[name] = {f: n for f, n in pq_scan.pq_scan_tiled_kernel
                               .forms.items() if n}
            del want
            nbytes, lookups = cs.k1_bound(torch, k1)
            bms, by = cs.bound_ms(sum(nbytes.values()), lookups)
            code_reads = tiles.numel() * codes.shape[1] * codes.shape[2]
            times = []
            for name in order:
                use(name)
                ms = cs.cuda_ms(torch, lambda: pq_scan.pq_scan_tiled_kernel(
                    *k1, **kw))
                times.append(f"{name} {ms:.4f} ms")
            print(f"limits: {what} {mode} B={lut.shape[0]} QT={qt} "
                  f"S={tiles.shape[1]} M={lut.shape[1]} K={lut.shape[2]} "
                  f"forms {forms}: " + ", ".join(times) + f"; bound "
                  f"{bms:.4f} ms ({by}), lookup floor "
                  f"{lookups / rate * 1e3:.4f} ms ({lookups} lookups), code "
                  f"reads {code_reads} B = "
                  f"{code_reads / cs.HBM_BYTES_PER_S * 1e3:.4f} ms at the "
                  "HBM rate", flush=True)

    if args.gist:
        x, q, _ = make_dataset("gist", args.seed, device=dev)
        index = build_index(x, IndexConfig(**cs.GIST_INDEX), device=dev,
                            generator=torch.Generator().manual_seed(
                                args.seed))
        turns("gist", index, q, ("as built", "memory only", "lookups only",
                                 "staging only", "as built"))
        return 0
    if not args.nbits8:
        x, q, _ = make_dataset("sift1m", args.seed, n=args.n or 1_000_000,
                               n_queries=1024, device=dev)
        index = build_index(x, IndexConfig(**cs.INDEX), device=dev,
                            generator=torch.Generator().manual_seed(
                                args.seed))
        order = ("as built", "memory only", "lookups only", "as built")
        if args.plane:
            cs.attach_planes(torch, index, "limits")
            turns(f"{args.plane} plane", index, q, order,
                  refine=RefineParams(args.plane, 4))
            return 0
        turns("main", index, q, order)
        del index, x, q
    n, cfg = ((cs.NBITS8_N, cs.NBITS8_INDEX) if not args.nbits8
              or args.n is None else (args.n, dict(cs.INDEX, nbits=8)))
    x, q, _ = make_dataset("sift1m", args.seed, n=n, n_queries=1024,
                           device=dev)
    index = build_index(x, IndexConfig(**cfg), device=dev,
                        generator=torch.Generator().manual_seed(args.seed))
    print(f"limits: nbits8 index n={n} " + " ".join(
        f"{k}={v}" for k, v in cfg.items()), flush=True)
    turns("nbits8", index, q, ("as built", "memory only", "lookups only",
                               "staging only", "k256 ranges of 8",
                               "k256 512 threads", "generic", "as built"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
