"""The port's cell planner against the reference's: every (arch, shape)
on both production meshes planned by both (the reference over
``AbstractMesh``, the port over meta-device meshes), compared in skip
policy, mode, note, every argument's shape and dtype, and every in / out
sharding spec.  Then each shape kind planned on a reduced architecture,
traced on meta tensors and run on the CPU (the mirror of
``tests/test_dryrun.py::test_plan_cell_lowers_reduced``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.launch import shapes as JSHP

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.dist.sharding import NamedSharding
from repro_torch.launch import shapes as TSHP
from repro_torch.launch.costpass import trace
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.optim.adamw import adamw_init
from repro_torch.tree import leaves, tree_map

CELLS = [(a, s, m) for a in ARCHS for s in SHAPES for m in ("pod1", "pod2")]


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(jnp.dtype(x.dtype))


def _j_specs(tree):
    return [tuple(s.spec) for s in jax.tree.leaves(tree)]


def _t_specs(tree):
    out = leaves(tree)
    assert all(isinstance(s, NamedSharding) for s in out)
    return [s.spec for s in out]


@pytest.fixture(scope="module")
def meshes():
    return {
        "pod1": (AbstractMesh((16, 16), ("data", "model")),
                 make_production_mesh(multi_pod=False)),
        "pod2": (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                 make_production_mesh(multi_pod=True)),
    }


@pytest.mark.parametrize("arch,shape,which", CELLS)
def test_plan_matches_reference(arch, shape, which, meshes):
    reason = TSHP.skip_reason(arch, shape)
    assert reason == JSHP.skip_reason(arch, shape)
    if reason:
        assert arch == "hubert-xlarge" and shape in ("decode_32k",
                                                     "long_500k")
        return
    jm, tm = meshes[which]
    want = JSHP.plan_cell(arch, shape, jm)
    got = TSHP.plan_cell(arch, shape, tm)
    assert (got.arch, got.shape) == (arch, shape)
    assert got.mode == want.mode
    assert got.note == want.note
    ja, ta = jax.tree.leaves(want.args), leaves(got.args)
    assert [tuple(t.shape) for t in ta] == [tuple(j.shape) for j in ja]
    assert [_dtype(t) for t in ta] == [_dtype(j) for j in ja]
    assert all(t.device.type == "meta" for t in ta)
    assert len(want.in_shardings) == len(got.in_shardings) == len(want.args)
    for jsub, tsub in zip(want.in_shardings, got.in_shardings):
        assert _t_specs(tsub) == _j_specs(jsub)
    if want.out_shardings is None:
        assert got.out_shardings is None
    else:
        assert len(got.out_shardings) == len(want.out_shardings)
        for jsub, tsub in zip(want.out_shardings, got.out_shardings):
            assert (tsub is None) == (jsub is None)
            if jsub is not None:
                assert _t_specs(tsub) == _j_specs(jsub)


def test_all_cells_and_long_knn_cfg():
    assert list(TSHP.all_cells()) == list(JSHP.all_cells())
    assert dataclasses.asdict(TSHP.LONG_KNN_CFG) == \
        dataclasses.asdict(JSHP.LONG_KNN_CFG)


def _concrete(x: torch.Tensor, g: torch.Generator, vocab: int, hi: int):
    """A CPU tensor of x's shape and dtype, drawn from g: ints in
    [0, vocab) for tokens, [-1, hi) for block tables, zeros for
    lengths; normals for floats; random bools."""
    shape = tuple(x.shape)
    if x.dtype == torch.int32:
        if len(shape) <= 1:
            return torch.zeros(shape, dtype=torch.int32)
        top = vocab if len(shape) <= 3 else hi
        low = 0 if len(shape) <= 3 else -1
        return torch.randint(low, top, shape, generator=g, dtype=torch.int32)
    if x.dtype == torch.bool:
        return torch.rand(shape, generator=g) < 0.8
    if x.dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    return (torch.randn(shape, generator=g) * 0.1).to(x.dtype)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_cell_traces_and_runs_reduced(shape, monkeypatch):
    """Every shape kind's plan traces on meta tensors and runs on the CPU
    at a reduced architecture and a shrunk shape table, with the same
    output shapes (full sizes are the dry-run's)."""
    arch = "qwen3-1.7b"
    tiny = dataclasses.replace(ARCHS[arch].reduced(), name=arch)
    monkeypatch.setattr(TSHP, "SHAPES", {shape: {
        **SHAPES[shape], "seq_len": 64, "global_batch": 4}})
    monkeypatch.setattr(TSHP, "ARCHS", dict(TSHP.ARCHS, **{arch: tiny}))
    kcfg = dataclasses.replace(TSHP.LONG_KNN_CFG, nlist=8, nprobe=2,
                               block=8, max_blocks_per_list=4, window=8)
    plan = TSHP.plan_cell(arch, shape, make_host_mesh(device="cpu"),
                          accum=2, knn_cfg=kcfg)
    assert plan.mode in ("train", "prefill", "decode", "rairs_knn",
                         "ssm_long")
    cost, meta_out = trace(plan.step_fn, plan.args)
    assert cost["flops"] > 0 and cost["peak_bytes"] >= cost["arg_bytes"] > 0
    g = torch.Generator().manual_seed(0)
    nb = kcfg.nlist * kcfg.max_blocks_per_list // 2
    args = tree_map(lambda x: _concrete(x, g, tiny.vocab, nb), plan.args)
    if plan.mode == "train":          # a fresh optimizer state
        args = (args[0], adamw_init(args[0]), args[2])
    out = plan.step_fn(*args)
    mo, co = leaves(meta_out), leaves(out)
    assert [tuple(t.shape) for t in co] == [tuple(t.shape) for t in mo]
    assert [t.dtype for t in co] == [t.dtype for t in mo]
    assert all(np.isfinite(t.float().numpy()).all() for t in co
               if t.is_floating_point() and t.dim() == 3)
