"""The port stands alone: it never imports JAX or the reference package,
and its entry points never move quietly to the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.")
             or n == "repro" or n.startswith("repro."))
print(len([n for n in sys.modules if n.startswith("repro_torch")]))
print(",".join(bad))
print(",".join(sorted(n for n in sys.modules
                      if n.startswith("repro_torch.gateway")
                      or n in ("repro_torch.core.dense",
                               "repro_torch.obs.export",
                               "repro_torch.obs.stats"))))
print(",".join(sorted(n for n in sys.modules
                      if n.startswith(("repro_torch.train",
                                       "repro_torch.optim",
                                       "repro_torch.dist"))
                      or n in ("repro_torch.tree",
                               "repro_torch.launch.train"))))
"""


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.splitlines()
    assert int(out[0]) >= 85, out          # every submodule was imported
    assert out[1] == "", f"loaded: {out[1]}"
    assert out[2].split(",") == [
        "repro_torch.core.dense", "repro_torch.gateway",
        "repro_torch.gateway.gateway", "repro_torch.gateway.loadgen",
        "repro_torch.gateway.queue", "repro_torch.gateway.telemetry",
        "repro_torch.obs.export", "repro_torch.obs.stats"], out
    assert out[3].split(",") == [
        "repro_torch.dist", "repro_torch.dist.checkpoint",
        "repro_torch.dist.elastic", "repro_torch.dist.sharding",
        "repro_torch.launch.train",
        "repro_torch.optim", "repro_torch.optim.adamw",
        "repro_torch.optim.compress", "repro_torch.train",
        "repro_torch.train.step", "repro_torch.tree"], out


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "tools/k1_limits.py", "tools/k3_phases.py",
       "tools/lm_profile.py"]))
def test_no_file_imports_jax_or_reference(path):
    roots = set(_imported_roots(ROOT / path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def _imported_modules(path: Path, package: str):
    """Every module ``path`` imports, at module level or inside a
    function, as an absolute name (``package`` is the file's own)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".")
            if node.level:
                base = base[:len(base) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            yield mod
            yield from (f"{mod}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in (PORT / "kernels").rglob("*.py")))
def test_kernels_never_import_core(path):
    """The kernel layer sits below the engine: its wrappers fall back to
    their plain versions in ``kernels/ref.py``, never to ``core``."""
    package = "repro_torch." + ".".join(
        Path(path).relative_to("src/repro_torch").parent.parts)
    mods = set(_imported_modules(ROOT / path, package))
    assert not {m for m in mods if m == "repro_torch.core"
                or m.startswith("repro_torch.core.")}, (path, sorted(mods))


def test_entry_points_refuse_to_fall_back_without_cuda(monkeypatch):
    from repro_torch.convert import index_from_numpy
    from repro_torch.core import IndexConfig, build_index, ground_truth
    from repro_torch.data import make_dataset
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((64, 8), np.float32)
    for call in (lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: make_dataset("unit"),
                 lambda: ground_truth(x, x[:2], 3),
                 lambda: build_index(x, IndexConfig(nlist=4)),
                 lambda: index_from_numpy({}, {})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_searcher_refuses_cuda_without_a_card(monkeypatch):
    from repro_torch.core import IndexConfig, build_index
    from repro_torch.data import make_dataset
    x, _, _ = make_dataset("unit", device="cpu", n=600, n_queries=4)
    idx = build_index(x, IndexConfig(nlist=8, kmeans_iters=2, pq_iters=2),
                      device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        idx.searcher(nprobe=2)
    assert idx.searcher(nprobe=2, device="cpu").params.nprobe == 2
