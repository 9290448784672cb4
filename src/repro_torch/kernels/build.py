"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each source under ``csrc/`` compiles with its own ``nvcc`` (all started
together) into a shared library with a plain C interface, in
``build/repro_torch/<hash of the sources>/`` at the root of the
checkout (listed in ``.gitignore``).  A missing ``nvcc`` or a failed
build raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("pq_scan.cu", "pq_scan_topk.cu", "topk_select.cu",
           "delta_scan_topk.cu", "pq_encode.cu")
HEADERS = ("adc.cuh", "queue_select.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
# (argtypes, restype) of each library's entry points (pointers and the
# stream are c_void_p, or ctypes would pass them as 32-bit ints)
_SIGNATURES = {
    "pq_scan": {
        "pq_scan_tiled_launch": ([_VOID] * 4 + [_INT] * 11 + [_VOID] * 2,
                                 _INT),
        "pq_scan_tiled_smem_bytes": ([_INT] * 5, ctypes.c_size_t),
        "pq_scan_tiled_scratch_bytes": ([_INT] * 5, ctypes.c_size_t),
    },
    "pq_scan_topk": {
        "pq_scan_topk_launch": ([_VOID] * 13 + [_INT] * 15 + [_VOID], _INT),
        "pq_scan_rows_launch": ([_VOID] * 14 + [_INT] * 14 + [_VOID], _INT),
        "topk_merge_launch": ([_VOID] * 6 + [_INT] * 3 + [_VOID], _INT),
        "pq_scan_topk_smem_bytes": ([_INT] * 7, ctypes.c_size_t),
        "topk_merge_smem_bytes": ([_INT] * 2, ctypes.c_size_t),
        "pq_scan_topk_ctas_per_sm": ([_INT] * 3 + [ctypes.c_size_t], _INT),
    },
    "topk_select": {
        "topk_select_launch": ([_VOID] * 8 + [_INT] * 4 + [_VOID], _INT),
        "topk_select_smem_bytes": ([_INT] * 2, ctypes.c_size_t),
        "topk_select_scratch_words": ([_INT] * 2, ctypes.c_size_t),
    },
    "delta_scan_topk": {
        "delta_scan_topk_launch": ([_VOID] * 13 + [_INT] * 13 + [_VOID],
                                   _INT),
        "delta_scan_topk_smem_bytes": ([_INT] * 6, ctypes.c_size_t),
        "delta_scan_topk_ctas_per_sm": ([_INT, ctypes.c_size_t], _INT),
    },
    "pq_encode": {
        "pq_encode_launch": ([_VOID] * 3 + [_INT] * 6 + [_VOID], _INT),
        "pq_encode_smem_bytes": ([_INT] * 3, ctypes.c_size_t),
        "pq_encode_ctas_per_sm": ([_INT, ctypes.c_size_t], _INT),
    },
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("repro_torch kernels: nvcc not found (needs the "
                           "CUDA toolkit, e.g. /usr/local/cuda/bin/nvcc)")
    return nvcc


def _build_dir() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build_all() -> Dict[str, Path]:
    """Compile every source (in parallel) unless its library exists;
    returns {stem: path of the .so}.  ``build_all.logs`` holds the
    compiler output of the last build (ptxas register and spill
    report included)."""
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {Path(s).stem: out / f"lib{Path(s).stem}.so" for s in SOURCES}
    todo = [s for s in SOURCES if not libs[Path(s).stem].exists()]
    procs = []
    if todo:
        nvcc = _nvcc()
        for src in todo:
            stem = Path(src).stem
            tmp = out / f"lib{stem}.{os.getpid()}.tmp.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs.append((stem, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    logs = {}
    failed = []
    for stem, tmp, p in procs:
        logs[stem] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(stem)
        else:
            os.replace(tmp, libs[stem])
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[s] for s in failed))
    build_all.logs = logs
    return libs


@functools.lru_cache(maxsize=None)
def load(stem: str) -> ctypes.CDLL:
    """The built library ``stem`` with its argtypes declared."""
    lib = ctypes.CDLL(str(build_all()[stem]))
    for fn_name, (argtypes, restype) in _SIGNATURES[stem].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.repro_cuda_error_string.argtypes = [_INT]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
