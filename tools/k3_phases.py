#!/usr/bin/env python3
"""Where a K3 CTA spends its time, on one NVIDIA H100.

    python3 tools/k3_phases.py [--seed 0] [--n N]
                               [--wide | --plane pq4|binary | --nbits8 |
                                --gist]
                               [--built-only] [--waves N]
    python3 tools/k3_phases.py --merge-paths [--seed 0]

Compiles a copy of ``src/repro_torch/kernels/csrc/pq_scan_topk.cu`` with
``clock64`` counters added (thread 0 of each scan CTA records them;
the kernel itself is unchanged), builds chip_smoke.py's main-path index,
and runs the copy once at the first batch of each exec mode, bitwise
against the plain version.  Per CTA it reports, in microseconds at the
SM clock nvidia-smi reads: set-up (tables into shared memory), staging
of the rounds' plan slots, scoring and queueing, flushes (sort + merge
of full queues, with retries and the round's closing barrier;
"networks" is the part spent in the sort and merge networks
themselves), and the final flush and write-out; and the number of
rounds and flushes.  Phases run one after another within a CTA, so
their sum is the CTA's time; CTAs on one SM overlap, so a phase also
holds the time its warp waited for the others' issue.  Each mode runs
twice: as built, and "alone", with the launch asking for more shared
memory than two CTAs can share, so that each CTA has its SM to itself
(``--built-only`` skips that run).  K3's time is that of the card's
work alone: calls captured in a CUDA graph and replayed (``device_ms``).

With ``--wide`` it runs chip_smoke.py's wide two-tier shape instead
(k 100, k_factor 10, the pq4 plane at refine factor 16: fetch 16,000),
where K3 takes its candidate-row form: the counters then time the scan
to rows (no flush runs; the row select that follows is not counted, but
is in the K3 time).  With ``--plane pq4|binary`` it runs chip_smoke.py's
two-tier shape (the main index, ``refine=RefineParams(plane, 4)``: fetch
400 over the plane's packed codes).  With ``--nbits8`` it builds
chip_smoke.py's nbits=8 index instead (80,000 vectors, IVF1024, PQ64x8:
64 KB of tables a query, K 256) and runs K3 at its fetch 100; with
``--n N`` too, the N-vector SIFT1M-shaped corpus at the main path's
IVF4096 built at ``nbits=8`` (Faiss's ``IVF4096,PQ64``).  With
``--gist`` it builds chip_smoke.py's gist-shaped index (50,000 x 256,
IVF1024, PQ256x8: 256 KB of tables a query, K3's global-table form) and
runs its 1,000 queries (B 1000 / 1000 / 64).  Where a tile
runs in several query groups, a CTA's phases are summed over its
tile's group launches (the counters add).  ``--waves N`` cuts K3 into N full
waves of CTAs instead of the number its wrapper picks from the shape
(the tool replaces ``k3_wave_splits`` for the run).

``--merge-paths`` builds no index: it times the merge alone on random
sorted lists, B=1024 with 2 to 8 lists and B=64 with 66, fetch 100 and
400 (random f32 and tie-heavy lists with 30% pads), bitwise against
its plain version, with its phases per CTA.  Where the source places
the entries of few lists directly (``MERGE_DIRECT``), a second copy
with that path compiled out times the search at the same lists.

Where K3 splits, its merge (``topk_merge``) is timed too, alone and
beside one ``torch.topk`` over the same lists, with its phases per CTA
(one query each).  The probes of the scan round and of the merge come
in one set per design of each (``ROUND_PROBES``, ``MERGE_PROBES``), the
first whose anchors all match is used, so a copy of this tool placed in
an unpacked parent commit (under ``build/``) times that commit's kernel
alike.
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
    ("namespace {\n", "namespace {\n__device__ long long* g_phase;\n"
     "__device__ long long* g_merge;\n"),
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
    ("    if (sdco[q]) atomicAdd(&dco[qi * QS + q], sdco[q]);\n}",
     "    if (sdco[q]) atomicAdd(&dco[qi * QS + q], sdco[q]);\n"
     "  if (tid == 0 && g_phase) {\n"
     "    ph[4] = clock64() - Te;\n    ph[5] = clock64() - T0;\n"
     "    long long* o = g_phase + 9 * ((size_t)split * gridDim.x + qi);\n"
     "    for (int i = 0; i < 9; ++i)\n"
     "      atomicAdd((unsigned long long*)(o + i), (unsigned long long)ph[i]);\n"
     "  }\n}"),
    ('extern "C" {\n',
     'extern "C" {\n'
     "int set_phase_buffer(void* p) {\n"
     "  return (int)cudaMemcpyToSymbol(g_phase, &p, sizeof(p));\n}\n"
     "int set_merge_buffer(void* p) {\n"
     "  return (int)cudaMemcpyToSymbol(g_merge, &p, sizeof(p));\n}\n"),
)
# A scan round's stage / score / flush probes, one set per design of the
# round (the first whose anchors all match is used): (design, probes).
ROUND_PROBES = (
    ("plan staged in the round, two barriers a round", (
        ("    __syncthreads();\n    const int f = f0 + tid;",
         "    __syncthreads();\n    Tb = clock64();\n    ph[1] += Tb - Ta;\n"
         "    const int f = f0 + tid;"),
        ("    bool again = __syncthreads_or(full);\n"
         "    while (!GS && again) {\n      flush(sel);\n",
         "    Tc = clock64();\n    ph[2] += Tc - Tb;\n    ph[6]++;\n"
         "    bool again = __syncthreads_or(full);\n"
         "    while (!GS && again) {\n"
         "      const long long Tn = clock64();\n"
         "      flush(sel);\n      ph[8] += clock64() - Tn;\n"
         "      ph[7]++;\n"),
        ("      again = __syncthreads_or(full);\n    }\n  }\n"
         "  __syncthreads();\n  if (!GS && sel.any_queued()) flush(sel);\n",
         "      again = __syncthreads_or(full);\n    }\n"
         "    ph[3] += clock64() - Tc;\n  }\n"
         "  __syncthreads();\n  const long long Te = clock64();\n"
         "  if (!GS && sel.any_queued()) flush(sel);\n"),
    )),
    ("plan staged in the round, three barriers a round", (
        ("    __syncthreads();\n    const int f = f0 + tid;",
         "    __syncthreads();\n    Tb = clock64();\n    ph[1] += Tb - Ta;\n"
         "    const int f = f0 + tid;"),
        ("    }\n    __syncthreads();\n"
         "    while (!GS && __syncthreads_or(sel.any_full())) {\n"
         "      flush(sel);\n",
         "    }\n    __syncthreads();\n    Tc = clock64();\n"
         "    ph[2] += Tc - Tb;\n    ph[6]++;\n"
         "    while (!GS && __syncthreads_or(sel.any_full())) {\n"
         "      const long long Tn = clock64();\n"
         "      flush(sel);\n      ph[8] += clock64() - Tn;\n"
         "      ph[7]++;\n"),
        ("      __syncthreads();\n    }\n  }\n  __syncthreads();\n"
         "  if (!GS && sel.any_queued()) flush(sel);\n",
         "      __syncthreads();\n    }\n    ph[3] += clock64() - Tc;\n"
         "  }\n  __syncthreads();\n  const long long Te = clock64();\n"
         "  if (!GS && sel.any_queued()) flush(sel);\n"),
    )),
)
# The merge's phases, one probe set per design of topk_merge: (design,
# fields, probes).  Thread 0 of each merge CTA writes its fields to
# g_merge; a field named "n_..." is a count, the others clocks.
MERGE_PROBES = (
    ("placement by counting", ("load", "search", "survivors",
                               "placement and output", "total", "n_placed"), (
        ("  const uint64_t pad = merge_key(inf(), PAD_POS);\n",
         "  const uint64_t pad = merge_key(inf(), PAD_POS);\n"
         "  long long T0 = clock64(), Tm = 0, mp[6] = {0};\n"),
        ("  int ns;  // real entries placed",
         "  mp[0] = clock64() - T0;\n  Tm = clock64();\n"
         "  int ns;  // real entries placed"),
        ("    // 3. survivors\n",
         "    mp[1] = clock64() - Tm;\n    Tm = clock64();\n"
         "    // 3. survivors\n"),
        ("    // 4. rank and output\n",
         "    mp[2] = clock64() - Tm;\n    Tm = clock64();\n"
         "    // 4. rank and output\n"),
        ("    out_id[o] = -1;\n  }\n}\n",
         "    out_id[o] = -1;\n  }\n"
         "  if (tid == 0 && g_merge) {\n    mp[3] = clock64() - Tm;\n"
         "    mp[4] = clock64() - T0;\n    mp[5] = ns;\n"
         "    for (int i = 0; i < 6; ++i) g_merge[6 * (size_t)b + i] = mp[i];\n"
         "  }\n}\n"),
    )),
    ("queue and network", ("seed", "filter", "flush", "final flush",
                           "output", "total", "n_rounds", "n_flushes"), (
        ("  const int b = blockIdx.x, tid = threadIdx.x;\n  Sel sel;\n",
         "  const int b = blockIdx.x, tid = threadIdx.x;\n  Sel sel;\n"
         "  long long T0 = clock64(), Tf = 0, mp[8] = {0};\n"),
        ("  if (tid == 0) sel.cnt[0] = 0;\n  __syncthreads();\n",
         "  if (tid == 0) sel.cnt[0] = 0;\n  __syncthreads();\n"
         "  mp[0] = clock64() - T0;\n"),
        ("    while (__syncthreads_or(sel.any_full())) {\n      flush(sel);\n",
         "    mp[6]++;\n"
         "    while (__syncthreads_or(sel.any_full())) {\n"
         "      Tf = clock64();\n      flush(sel);\n"
         "      mp[2] += clock64() - Tf;\n      mp[7]++;\n"),
        ("  if (sel.any_queued()) flush(sel);\n"
         "  for (int c = tid; c < fetch; c += MERGE_NT) {\n",
         "  mp[1] = clock64() - T0 - mp[0] - mp[2];\n  Tf = clock64();\n"
         "  if (sel.any_queued()) flush(sel);\n  mp[3] = clock64() - Tf;\n"
         "  Tf = clock64();\n"
         "  for (int c = tid; c < fetch; c += MERGE_NT) {\n"),
        ("    out_id[(size_t)b * fetch + c] = sel.ai[c];\n  }\n}\n",
         "    out_id[(size_t)b * fetch + c] = sel.ai[c];\n  }\n"
         "  if (tid == 0 && g_merge) {\n    mp[4] = clock64() - Tf;\n"
         "    mp[5] = clock64() - T0;\n"
         "    for (int i = 0; i < 8; ++i) g_merge[8 * (size_t)b + i] = mp[i];\n"
         "  }\n}\n"),
    )),
)
# The k256 form's phases (a CTA a query), where the source has the form:
# set-up (table copy, state), compaction of the windows' planned
# positions, a pass's loads and keep mask, its scoring, its filter (with
# flushes and the pass's closing barriers), and the final flush and
# write-out; passes and flushes counted.  Thread 0 of each CTA writes
# them to g_phase as the scan probes do.
K256_FIELDS = ("setup", "compact", "load", "score", "filter", "tail",
               "total", "passes", "flushes")
K256_PROBES = ("pq_scan_topk_k256", (
    ("  using Piece = typename K256Piece<CH>::type;\n"
     "  extern __shared__ __align__(16) int ksmem[];\n",
     "  using Piece = typename K256Piece<CH>::type;\n"
     "  extern __shared__ __align__(16) int ksmem[];\n"
     "  long long T0 = clock64(), Ta = 0, kp[9] = {0};\n"),
    ("  __syncthreads();\n\n  constexpr int SUB = KWIN / NT",
     "  __syncthreads();\n  kp[0] = clock64() - T0;\n\n"
     "  constexpr int SUB = KWIN / NT"),
    ("    int sl[SUB], bk[SUB], ru[SUB];\n",
     "    Ta = clock64();\n    int sl[SUB], bk[SUB], ru[SUB];\n"),
    ("    const int n = planned << lb;",
     "    kp[1] += clock64() - Ta;\n    const int n = planned << lb;"),
    ("      const int first = p0 + tid;\n      int iid[KIPT],",
     "      Ta = clock64();\n      kp[7]++;\n"
     "      const int first = p0 + tid;\n      int iid[KIPT],"),
    ("      for (int v = 0; v < P; ++v) {\n        Piece nxt[KIPT];",
     "      { const long long Tb = clock64(); kp[2] += Tb - Ta; Ta = Tb; }\n"
     "      for (int v = 0; v < P; ++v) {\n        Piece nxt[KIPT];"),
    ("      // the filter: a kept item whose push",
     "      { const long long Tb = clock64(); kp[3] += Tb - Ta; Ta = Tb; }\n"
     "      // the filter: a kept item whose push"),
    ("      while (again) {\n        flush(sel);\n",
     "      while (again) {\n        kp[8]++;\n        flush(sel);\n"),
    ("        again = __syncthreads_or(full);\n      }\n    }\n  }\n",
     "        again = __syncthreads_or(full);\n      }\n"
     "      kp[4] += clock64() - Ta;\n    }\n  }\n"
     "  const long long Te = clock64();\n"),
    ("  if (lane == 0 && ndco) atomicAdd(&dco[b], ndco);\n}",
     "  if (lane == 0 && ndco) atomicAdd(&dco[b], ndco);\n"
     "  if (tid == 0 && g_phase) {\n"
     "    kp[5] = clock64() - Te;\n    kp[6] = clock64() - T0;\n"
     "    long long* o = g_phase + 9 * ((size_t)split * gridDim.x + "
     "blockIdx.x);\n"
     "    for (int i = 0; i < 9; ++i)\n"
     "      atomicAdd((unsigned long long*)(o + i), (unsigned long long)kp[i]);\n"
     "  }\n}"),
))
# The GT form's phases (a CTA a query, its table staged by range), where
# the source has the form: set-up, compaction of the windows' planned
# positions, the keep steps (loads, rank_of, the kept list), a pass's
# waits for its ranges' copies (with their barriers), its scoring (piece
# loads and lookups), its filter (with flushes), and the final flush and
# write-out; passes and flushes counted.
GT_FIELDS = ("setup", "compact", "keep", "wait", "score", "filter", "tail",
             "total", "passes", "flushes")
GT_PROBES = ("pq_scan_topk_gt", (
    ("  extern __shared__ __align__(16) int gsmem[];\n",
     "  extern __shared__ __align__(16) int gsmem[];\n"
     "  long long T0 = clock64(), Ta = 0, gp[10] = {0};\n"),
    ("  __syncthreads();\n  int fill = 0, par = 0;",
     "  __syncthreads();\n  gp[0] = clock64() - T0;\n  int fill = 0, par = 0;"),
    ("    int sl[SUB], bk[SUB], ru[SUB];\n",
     "    Ta = clock64();\n    int sl[SUB], bk[SUB], ru[SUB];\n"),
    ("    const int n = planned << lb;",
     "    gp[1] += clock64() - Ta;\n    const int n = planned << lb;"),
    ("      int iid[GCK], oth[GCK], ps[GCK], rk[GCK];\n",
     "      Ta = clock64();\n      int iid[GCK], oth[GCK], ps[GCK], rk[GCK];\n"),
    ("      fill += kept;\n",
     "      fill += kept;\n      gp[2] += clock64() - Ta;\n"),
    ("    stage(0);\n    __syncthreads();\n",
     "    long long Tp = clock64();\n    gp[8]++;\n"
     "    stage(0);\n    __syncthreads();\n"),
    ("      asm volatile(\"cp.async.wait_group 0;\\n\" ::: \"memory\");\n"
     "      __syncthreads();\n",
     "      const long long Tw = clock64();\n"
     "      asm volatile(\"cp.async.wait_group 0;\\n\" ::: \"memory\");\n"
     "      __syncthreads();\n      gp[3] += clock64() - Tw;\n"),
    ("    // the filter: a kept item whose push",
     "    gp[4] += clock64() - Tp;\n    Tp = clock64();\n"
     "    // the filter: a kept item whose push"),
    ("    while (again) {\n      flush(sel);\n",
     "    while (again) {\n      gp[9]++;\n      flush(sel);\n"),
    ("      again = __syncthreads_or(full);\n    }\n  };\n",
     "      again = __syncthreads_or(full);\n    }\n"
     "    gp[5] += clock64() - Tp;\n  };\n"),
    ("  if (fill > 0) score_pass(fill);\n",
     "  if (fill > 0) score_pass(fill);\n  const long long Te = clock64();\n"),
    ("  if (lane == 0 && ndco) atomicAdd(&dco[b], ndco);\n}",
     "  if (lane == 0 && ndco) atomicAdd(&dco[b], ndco);\n"
     "  if (tid == 0 && g_phase) {\n"
     "    gp[6] = clock64() - Te;\n    gp[7] = clock64() - T0;\n"
     "    gp[4] -= gp[3];\n"
     "    long long* o = g_phase + 10 * ((size_t)split * gridDim.x + "
     "blockIdx.x);\n"
     "    for (int i = 0; i < 10; ++i)\n"
     "      atomicAdd((unsigned long long*)(o + i), (unsigned long long)gp[i]);\n"
     "  }\n}"),
))
# one CTA per SM: 120,000 B of shared memory, more than half of an SM's
# the merge with its direct placement compiled out: every list count
# takes the search
SEARCH_ONLY = (("constexpr int MERGE_DIRECT = 6;",
                "constexpr int MERGE_DIRECT = 0;"),)
# (one probe set per design of the launch's shared-memory line)
ALONE = (
    ("one table flag", (
        ("  const size_t smem = scan_smem_bytes(M, K, QT, FW, BLK, "
         "global_tables, gs);\n",
         "  const size_t smem0 = scan_smem_bytes(M, K, QT, FW, BLK, "
         "global_tables, gs);\n"
         "  const size_t smem = smem0 > 120000 ? smem0 : 120000;\n"),)),
    ("a global-tables bool", (
        ("  const size_t smem =\n"
         "      scan_smem_bytes(M, K, QT, FW, BLK, global_tables != 0, gs);\n",
         "  const size_t smem0 =\n"
         "      scan_smem_bytes(M, K, QT, FW, BLK, global_tables != 0, gs);\n"
         "  const size_t smem = smem0 > 120000 ? smem0 : 120000;\n"),)),
)


def scope(text, fn):
    """(start, end) of the definition of kernel ``fn`` in ``text`` (from
    its name to the first closing brace at column 0), or None."""
    at = text.find(f" {fn}(")
    if at < 0:
        return None
    return at, text.index("\n}\n", at) + 3


def scoped_matches(text, entry) -> bool:
    """Whether every anchor of a kernel's probe set, ``(kernel, probes)``,
    occurs once in that kernel's definition."""
    fn, probes = entry
    span = scope(text, fn)
    return span is not None and all(
        text[span[0]:span[1]].count(a) == 1 for a, _ in probes)


def apply_scoped(text, entry):
    """The probes of ``(kernel, probes)`` applied inside that kernel."""
    fn, probes = entry
    a, b = scope(text, fn)
    body = text[a:b]
    for anchor, repl in probes:
        body = body.replace(anchor, repl)
    return text[:a] + body + text[b:]


def matching(build, sets, what):
    """The entry of ``sets`` whose probes (its last item) all have their
    anchor once in pq_scan_topk.cu."""
    text = (build.CSRC / "pq_scan_topk.cu").read_text()
    for entry in sets:
        if all(text.count(anchor) == 1 for anchor, _ in entry[-1]):
            return entry
    raise SystemExit(f"k3_phases: no probe set matches {what} in "
                     "pq_scan_topk.cu")


def build_probed(build, name, probes, scoped=()):
    """Compile a probed copy of K3 (``scoped``: probe sets applied inside
    one kernel each); returns the loaded library."""
    text = (build.CSRC / "pq_scan_topk.cu").read_text()
    for entry in scoped:
        text = apply_scoped(text, entry)
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
    lib.set_merge_buffer.argtypes = [ctypes.c_void_p]
    lib.set_merge_buffer.restype = ctypes.c_int
    return lib


def device_ms(torch, fn, calls: int = 10, reps: int = 5) -> float:
    """Milliseconds of the card's work in one call of fn(), with no host
    work: ``calls`` calls captured in one CUDA graph (after two eager
    warm-up calls), replayed ``reps`` times between CUDA events (as
    chip_smoke.py's graph_ms; kept here so that the tool times a parent
    commit's kernels alike)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        g.replay()
    e.record()
    e.synchronize()
    del g
    return s.elapsed_time(e) / (reps * calls)


def summary(buf, fields, mhz) -> str:
    """Mean and max of each field over the CTAs that wrote ``buf``:
    microseconds at ``mhz``, or counts (``rounds``, ``flushes``,
    ``n_...``)."""
    rows = buf.reshape(-1, len(fields)).double().cpu().T.tolist()
    parts = []
    for name, vals in zip(fields, rows):
        count = (name in ("rounds", "flushes", "passes")
                 or name.startswith("n_"))
        scale = 1.0 if count else float(mhz)
        parts.append(f"{name} mean {statistics.fmean(vals) / scale:.2f} "
                     f"max {max(vals) / scale:.2f}")
    return ", ".join(parts)


def sm_clock(torch) -> str:
    """The card's SM clock in MHz, as nvidia-smi reads it while a spin
    kernel keeps the card busy (an idle card reads its lowest clock);
    printed with the card's name and power limit."""
    torch.cuda._sleep(2 * 10 ** 9)        # about a second of spinning
    card, limit, mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].split(", ")
    torch.cuda.synchronize()
    print(f"phases: {card}, {limit} W, SM clock {mhz} MHz", flush=True)
    return mhz


def nbits8_config(cs, args):
    """``--nbits8``: (n, IndexConfig kwargs) of chip_smoke.py's nbits=8
    index, or, with ``--n``, of the main path's index at nbits=8."""
    if args.n is None:
        return cs.NBITS8_N, cs.NBITS8_INDEX
    return args.n, dict(cs.INDEX, nbits=8)


def merge_paths(torch, cs, build, pq_scan, ref, current, probes, mfields,
                seed, scoped=()) -> int:
    """``--merge-paths``: the merge alone at few and many lists, as built
    and (where the source has a direct path) with the search only."""
    variants = {"as built": probes}
    text = (build.CSRC / "pq_scan_topk.cu").read_text()
    if text.count(SEARCH_ONLY[0][0]) == 1:
        variants["search only"] = probes + SEARCH_ONLY
    libs = {how: build_probed(build, f"merge_{i}", p, scoped)
            for i, (how, p) in enumerate(variants.items())}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = [(1024, n, f) for f in (100, 400) for n in (2, 3, 4, 5, 6, 8)]
    shapes += [(64, 66, 100), (64, 66, 400)]
    mhz = sm_clock(torch)
    for b, splits, fetch in shapes:
        for kind, pads, ints in (("random f32", 0.0, False),
                                 ("tie-heavy, 30% pads", 0.3, True)):
            parts = cs.sorted_lists(torch, g, dev, b, splits, fetch,
                                    pads=pads, ints=ints)
            want = ref.merge_topk_ref(*parts)
            flat = parts[0].reshape(b, -1)
            tms = device_ms(torch, lambda: torch.topk(
                flat, fetch, dim=1, largest=False, sorted=True))
            for how, lib in libs.items():
                current["lib"] = lib
                mbuf = torch.zeros(b * len(mfields), dtype=torch.int64,
                                   device=dev)
                if lib.set_merge_buffer(mbuf.data_ptr()):
                    raise SystemExit("k3_phases: set_merge_buffer failed")
                got = pq_scan.merge_topk_kernel(*parts)
                torch.cuda.synchronize()
                lib.set_merge_buffer(None)
                if not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise SystemExit(f"k3_phases: merge ({how}) differs at "
                                     f"{b} x {splits} x {fetch}, {kind}")
                ms = device_ms(torch, lambda: pq_scan.merge_topk_kernel(
                    *parts))
                print(f"merge paths: B={b} {splits} lists of {fetch} "
                      f"({kind}) {how}: {ms:.4f} ms, one torch.topk "
                      f"{tms:.4f} ms (us per CTA; counts): "
                      + summary(mbuf, mfields, mhz), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=None,
                    help="corpus size (default 1,000,000; with --nbits8 "
                    "chip_smoke.py's nbits=8 index, and with --n the main "
                    "path's IVF4096 at nbits=8)")
    shape = ap.add_mutually_exclusive_group()
    shape.add_argument("--wide", action="store_true",
                       help="the wide two-tier shape (fetch 16,000)")
    shape.add_argument("--plane", choices=("pq4", "binary"),
                       help="the two-tier shape over this plane (fetch 400)")
    shape.add_argument("--nbits8", action="store_true",
                       help="an nbits=8 index (PQ64x8, K 256)")
    shape.add_argument("--gist", action="store_true",
                       help="the gist-shaped index (PQ256x8: global tables)")
    ap.add_argument("--built-only", action="store_true",
                    help="skip the runs with each CTA alone on its SM")
    ap.add_argument("--waves", type=int, default=0,
                    help="cut K3 into this many full waves of CTAs (default: "
                    "as the wrapper picks them from the shape)")
    ap.add_argument("--merge-paths", action="store_true",
                    help="time the merge alone at few and many lists (no "
                    "index), with and without its direct path")
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
    if args.waves:          # N full waves, not the shape's choice
        def fixed_waves(groups, t, s, m, k, fw, blk, packed, device):
            wave = pq_scan.k3_wave(groups, m, k, fw, blk, packed, device)
            if getattr(groups, "k256", False):   # a CTA a query (k256, GT)
                t *= groups.largest
            return pq_scan.topk_splits(t, s, blk, args.waves * wave)
        pq_scan.k3_wave_splits = fixed_waves

    round_design, rprobes = matching(build, ROUND_PROBES, "the scan round")
    design, mfields, mprobes = matching(build, MERGE_PROBES, "topk_merge")
    probes = PROBES + rprobes + mprobes
    text = (build.CSRC / "pq_scan_topk.cu").read_text()
    scoped = tuple(e for e in (K256_PROBES, GT_PROBES)
                   if scoped_matches(text, e))
    for fn, _ in scoped:
        print(f"phases: {fn} probed", flush=True)
    print(f"phases: scan rounds: {round_design}; merge: {design}",
          flush=True)
    stock = build.load
    current = {}
    build.load = lambda stem: (current["lib"] if stem == "pq_scan_topk"
                               else stock(stem))
    if args.merge_paths:
        return merge_paths(torch, cs, build, pq_scan, ref, current, probes,
                           mfields, args.seed, scoped)
    libs = {"as built": build_probed(build, "phases", probes, scoped),
            "alone": build_probed(build, "phases_alone",
                                  probes + matching(build, ALONE,
                                                    "the launch")[-1],
                                  scoped)}
    dev = torch.device("cuda")
    if args.gist:
        x, q, _ = make_dataset("gist", args.seed, device=dev)
        n, cfg = x.shape[0], cs.GIST_INDEX
    else:
        n, cfg = nbits8_config(cs, args) if args.nbits8 else (
            args.n or 1_000_000, cs.INDEX)
        x, q, _ = make_dataset("sift1m", args.seed, n=n, n_queries=1024,
                               device=dev)
    index = build_index(x, IndexConfig(**cfg), device=dev,
                        generator=torch.Generator().manual_seed(args.seed))
    print(f"phases: index n={n} " + " ".join(
        f"{k}={v}" for k, v in cfg.items()), flush=True)
    mhz = sm_clock(torch)
    params = {}
    current["lib"] = libs["as built"]
    if args.wide or args.plane:
        from repro_torch.core import RefineParams
        params = (dict(cs.WIDE, refine=RefineParams("pq4", 16)) if args.wide
                  else dict(refine=RefineParams(args.plane, 4)))
        if args.plane:
            index.plane(args.plane)       # attach it (trains its codec)
    for mode, bsz in cs.RUNS:
        bsz = q[:bsz].shape[0]        # the gist index has 1,000 queries
        _, k3, qt, fetch, pw = cs.mode_inputs(index, q[:bsz].contiguous(),
                                              mode, **params)
        tiles = k3[4]
        m, k, blk = k3[0].shape[1], k3[0].shape[2], k3[1].shape[1]
        fw = pq_scan.topk_width(fetch)
        groups = pq_scan.k3_query_groups(m, k, qt, fw, blk)
        k256 = getattr(groups, "k256", False)
        form = getattr(groups, "form", "shared")
        fields = (GT_FIELDS if k256 and form == "GT" else K256_FIELDS if k256
                  else FIELDS)
        if hasattr(pq_scan, "k3_wave_splits"):
            splits, s_per = pq_scan.k3_wave_splits(
                groups, *tiles.shape, m, k, 0 if groups.global_state else fw,
                blk, bool(params), dev)
        else:                # a tree that splits K3 by the shape alone
            splits, s_per = pq_scan.topk_splits(*tiles.shape, blk)
        kw = dict(query_tile=qt, fetch=fetch, packed=bool(params))
        want = ref.pq_scan_topk_ref(*k3, **kw)
        for how, lib in libs.items():
            if how == "alone" and args.built_only:
                continue
            current["lib"] = lib
            ctas = tiles.shape[0] * (qt if k256 else 1) * splits
            buf = torch.zeros(ctas * len(fields), dtype=torch.int64,
                              device=dev)
            mbuf = torch.zeros(k3[0].shape[0] * len(mfields),
                               dtype=torch.int64, device=dev)
            if (lib.set_phase_buffer(buf.data_ptr())
                    or lib.set_merge_buffer(mbuf.data_ptr())):
                raise SystemExit("k3_phases: set_phase_buffer failed")
            got = pq_scan.pq_scan_topk_kernel(*k3, **kw, plan_width=pw)
            torch.cuda.synchronize()
            lib.set_phase_buffer(None)
            lib.set_merge_buffer(None)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"k3_phases: probed K3 differs in {mode}")
            ms = device_ms(torch, lambda: pq_scan.pq_scan_topk_kernel(
                *k3, **kw, plan_width=pw))
            parts = [summary(buf, fields, mhz)]
            print(f"phases: {mode} {how} B={bsz} QT={qt} S={tiles.shape[1]}"
                  f" fetch={fetch} form {form}, {len(groups)} launches, "
                  f"splits={splits} CTAs={ctas} K3 "
                  f"{ms:.4f} ms (us per CTA; counts): " + ", ".join(parts),
                  flush=True)
            if splits > 1 and how == "as built":
                parts = cs.split_parts(torch, k3, kw, splits, s_per)
                mms = device_ms(torch, lambda: pq_scan.merge_topk_kernel(
                    *parts))
                flat = parts[0].reshape(bsz, -1)
                tms = device_ms(torch, lambda: torch.topk(
                    flat, fetch, dim=1, largest=False, sorted=True))
                print(f"phases: {mode} merge ({design}) B={bsz} "
                      f"{splits} lists of {fetch}: {mms:.4f} ms alone, one "
                      f"torch.topk over the lists {tms:.4f} ms (us per CTA; "
                      "counts): " + summary(mbuf, mfields, mhz), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
