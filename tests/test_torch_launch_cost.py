"""The cost pass and the dry-run: FLOP counting (the ``out_dtype``
products included), the unroll flag, every reduced cell traced on meta
tensors, the dense cells' counts against a closed form of the port's
GEMMs, per-device argument bytes against the reference's specs, the
rairs cell, the peak estimator, and where the records go."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.launch import shapes as JSHP

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.rairs import CONFIG as R
from repro_torch.launch import costpass, dryrun
from repro_torch.launch import shapes as TSHP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers
from repro_torch.models.runtime_flags import (scan_unroll_arg, unroll_scans,
                                              unrolled)


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def count(fn, *args, mapping=True):
    fc = costpass.flop_counter() if mapping else \
        torch.utils.flop_counter.FlopCounterMode(display=False)
    with fc:
        fn(*args)
    return fc.get_total_flops()


def test_loop_of_products_counts_exactly():
    """A loop of L products counts exactly L x one (the mirror of the
    reference's unrolled-scan check; the port's loops always unroll)."""
    x, w = meta(64, 128), meta(12, 128, 128)

    def f(x, w):
        h = x
        for i in range(w.shape[0]):
            h = torch.tanh(layers._dot(h, w[i])).to(torch.bfloat16)
        return h.sum()
    one = 2 * 64 * 128 * 128
    assert count(f, x, w) == 12 * one
    assert count(lambda a, b: layers._dot(a, b), x, w[0]) == one


def test_out_dtype_products_are_counted():
    """``mm`` with ``out_dtype`` keeps the built-in formula; ``bmm``
    with ``out_dtype`` needs the pass's own (the built-in one takes the
    dtype for its ``out_shape`` and raises)."""
    a, b = meta(3, 8, 16), meta(3, 16, 32)
    mm = lambda: torch.mm(a[0], b[0], out_dtype=torch.float32)   # noqa
    bmm = lambda: torch.bmm(a, b, out_dtype=torch.float32)       # noqa
    assert count(mm, mapping=False) == count(mm) == 2 * 8 * 16 * 32
    assert count(bmm) == 3 * 2 * 8 * 16 * 32
    with pytest.raises(TypeError):
        count(bmm, mapping=False)
    # plain f32 products count alike under the mapping
    assert count(lambda: torch.bmm(a.float(), b.float())) == count(bmm)


def test_meta_tensors_take_the_cards_product_path():
    """Repair (a): a `_dot` / `_bmm` backward on meta tensors (the card's
    autograd Functions) gives gradients of the operands' shapes and
    dtypes."""
    for xa, xb, fn in ((meta(4, 8, 16, dtype=torch.float32),
                        meta(16, 32, dtype=torch.float32), layers._dot),
                       (meta(2, 3, 8, 16), meta(2, 3, 16, 32), layers._bmm)):
        a, b = xa.requires_grad_(), xb.requires_grad_()
        y = fn(a, b)
        assert y.dtype == torch.float32 and y.device.type == "meta"
        ga, gb = torch.autograd.grad(y.sum(), (a, b))
        assert (ga.shape, ga.dtype) == (a.shape, a.dtype)
        assert (gb.shape, gb.dtype) == (b.shape, b.dtype)
        # forward + both operands' gradients: three products of one size
        n = count(lambda: torch.autograd.grad(fn(a, b).sum(), (a, b)))
        assert n == 3 * count(lambda: fn(a, b))


def test_moe_routing_traces_on_meta():
    """Repair (b): `route_topk` and `moe_mlp` on meta tensors."""
    from repro_torch.models.moe import moe_mlp, route_topk
    st, sg, load = route_topk(meta(64, 8, dtype=torch.float32), 2, 20)
    assert (st.shape, st.dtype) == ((8, 20), torch.int32)
    assert (sg.shape, sg.dtype) == ((8, 20), torch.float32)
    assert load.shape == (8,)
    f32 = torch.float32
    y, load = moe_mlp(meta(2, 16, 64), meta(64, 4, dtype=f32),
                      meta(4, 64, 32, dtype=f32), meta(4, 64, 32, dtype=f32),
                      meta(4, 32, 64, dtype=f32), top_k=2)
    assert (y.shape, y.dtype, load.shape) == ((2, 16, 64), f32, (4,))


def test_unrolled_restores_state_and_changes_no_count():
    from repro_torch.models.transformer import abstract_params, train_loss
    cfg = dataclasses.replace(ARCHS["qwen3-1.7b"].reduced(), n_layers=8,
                              vocab=64)
    params = abstract_params(cfg)
    batch = {"tokens": meta(2, 32, dtype=torch.int32),
             "labels": meta(2, 32, dtype=torch.int32)}

    def loss():
        return train_loss(params, cfg, batch, remat=False)
    base = count(loss)
    assert not unroll_scans() and scan_unroll_arg() == 1
    with unrolled():
        assert unroll_scans() and scan_unroll_arg() is True
        full = count(loss)
        with unrolled():
            assert unroll_scans()
        assert unroll_scans()
    assert not unroll_scans()
    with pytest.raises(RuntimeError):
        with unrolled():
            raise RuntimeError
    assert not unroll_scans()
    assert full == base > 0


# ---------------------------------------------------------------------------
# every reduced cell, through run_cost
# ---------------------------------------------------------------------------
RED_SHAPES = {
    "train_4k": dict(kind="train", seq_len=64, global_batch=8),
    "prefill_32k": dict(kind="prefill", seq_len=64, global_batch=4),
    "decode_32k": dict(kind="decode", seq_len=64, global_batch=4),
    "long_500k": dict(kind="long_decode", seq_len=4096, global_batch=1),
}
RED_KNN = dict(nlist=16, nprobe=4, block=16, max_blocks_per_list=8,
               window=32)


@pytest.fixture
def reduced_table(monkeypatch, tmp_path):
    """The shape table shrunk, every architecture reduced, the knn cache
    cut, and the records in tmp_path."""
    monkeypatch.setattr(TSHP, "SHAPES", RED_SHAPES)
    monkeypatch.setattr(TSHP, "ARCHS", {
        a: dataclasses.replace(c.reduced(), name=a)
        for a, c in ARCHS.items()})
    monkeypatch.setattr(TSHP, "LONG_KNN_CFG", dataclasses.replace(
        TSHP.LONG_KNN_CFG, **RED_KNN))
    monkeypatch.setattr(costpass, "RESULTS_DIR", str(tmp_path / "cost"))
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path / "dryrun"))
    return tmp_path


def closed_form(cfg, kind, b, s, accum, kc):
    """GEMM FLOPs of one step of a dense architecture, from the port's
    products: q/k/v/o, the gated MLP, the flash loop's two products over
    every chunk (masked ones included), the unembedding (every CE chunk
    in training, the last position in prefill), the patch projection;
    training runs each period forward, again under remat, and backward
    (two products a product), the unembedding three times and the patch
    projection twice (its input takes no gradient)."""
    d, h, kvh, hd, ff, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.hd, cfg.d_ff, cfg.vocab)
    nl = cfg.n_layers

    def layer(t, attn):
        return (2 * t * d * (h * hd + 2 * kvh * hd) + 2 * t * h * hd * d
                + attn + 6 * t * d * ff)
    patch = 2 * (s // 4) * cfg.patch_dim * d if cfg.frontend == "patch" \
        else 0
    if kind == "train":
        mb = b // accum
        t = mb * s
        one = (nl * 4 * layer(t, 4 * mb * h * s * s * hd)
               + 3 * 2 * t * d * v + 2 * mb * patch)
        return accum * one
    if kind == "prefill":
        return (nl * layer(b * s, 4 * b * h * s * s * hd) + 2 * b * d * v
                + b * patch)
    if kind == "decode":
        return nl * layer(b, 4 * b * h * hd * s) + 2 * b * d * v
    keys = kc.nprobe * kc.max_blocks_per_list * kc.block + kc.window
    attn = 4 * b * h * hd * keys + 2 * b * kvh * kc.nlist * hd
    return nl * layer(b, attn) + 2 * b * d * v


CELLS = [(a, s) for a in ARCHS for s in SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_every_reduced_cell_traces(arch, shape, reduced_table):
    rec = costpass.run_cost(arch, shape)
    path = reduced_table / "cost" / f"{arch}__{shape}.json"
    assert json.loads(path.read_text()) == rec
    if TSHP.skip_reason(arch, shape):
        assert rec["status"] == "skipped"
        return
    assert rec["status"] == "ok", rec.get("error")
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0 and rec["ops"] > 0
    assert rec["peak_bytes"] > rec["arg_bytes"] > 0
    assert rec["transcendentals"] is None
    cfg = TSHP.ARCHS[arch]
    if cfg.moe_experts == 0 and cfg.attn_every == 0:
        info = RED_SHAPES[shape]
        want = closed_form(cfg, info["kind"], info["global_batch"],
                           info["seq_len"], 8, TSHP.LONG_KNN_CFG)
        assert rec["flops"] == want
    # cached: a second call reads the record
    assert costpass.run_cost(arch, shape) == rec


def test_dryrun_record_fields(reduced_table):
    rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", False)
    assert rec["status"] == "ok", rec.get("error")
    for k in ("generated_code_size_in_bytes", "transcendentals",
              "hlo_bytes", "collective_bytes"):
        assert rec[k] is None
    assert rec["temp_size_in_bytes"] == rec["peak_bytes"] - \
        costpass.run_cost("qwen3-1.7b", "decode_32k")["arg_bytes"]
    assert rec["plan_s"] >= 0 and rec["trace_s"] >= 0
    # the cache is placed, the logits are not: output bytes are the
    # cache's share on the mesh
    mesh = make_production_mesh()
    plan = TSHP.plan_cell("qwen3-1.7b", "decode_32k", mesh)
    assert rec["output_size_in_bytes"] == dryrun.sharded_bytes(
        plan.args[1], plan.in_shardings[1])
    pre = dryrun.run_cell("qwen3-1.7b", "prefill_32k", True)
    assert pre["status"] == "ok" and pre["output_size_in_bytes"] is None
    skip = dryrun.run_cell("hubert-xlarge", "long_500k", True)
    assert skip["status"] == "skipped"
    assert sorted(os.listdir(reduced_table / "dryrun")) == [
        "hubert-xlarge__long_500k__pod2.json",
        "qwen3-1.7b__decode_32k__pod1.json",
        "qwen3-1.7b__prefill_32k__pod2.json"]


def test_results_go_under_launch_results_torch():
    root = os.path.normpath(costpass.RESULTS_ROOT)
    assert root.endswith(os.path.join("launch_results", "torch"))
    assert os.path.normpath(costpass.RESULTS_DIR) == os.path.join(root,
                                                                  "cost")
    assert os.path.normpath(dryrun.RESULTS_DIR) == os.path.join(root,
                                                                "dryrun")
    from repro_torch.launch import hillclimb
    assert os.path.normpath(hillclimb.RESULTS) == os.path.join(
        root, "hillclimb.json")


# ---------------------------------------------------------------------------
# per-device argument bytes against the reference's specs (full width,
# plans only)
# ---------------------------------------------------------------------------
def _ref_arg_bytes(plan) -> int:
    total = 0
    for x, sh in zip(jax.tree.leaves(plan.args),
                     jax.tree.leaves(plan.in_shardings)):
        mesh_shape = dict(sh.mesh.shape)
        n = 1
        for entry in tuple(sh.spec):
            for a in (() if entry is None else (entry,)
                      if isinstance(entry, str) else entry):
                n *= mesh_shape[a]
        total += int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize // n
    return total


@pytest.mark.parametrize("which", ("pod1", "pod2"))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_argument_bytes_per_device_match_reference(arch, which):
    jm = AbstractMesh((16, 16), ("data", "model")) if which == "pod1" else \
        AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    tm = make_production_mesh(multi_pod=which == "pod2")
    for shape in SHAPES:
        if TSHP.skip_reason(arch, shape):
            continue
        want = _ref_arg_bytes(JSHP.plan_cell(arch, shape, jm))
        plan = TSHP.plan_cell(arch, shape, tm)
        assert dryrun.sharded_bytes(plan.args, plan.in_shardings) == want, \
            shape


@pytest.mark.parametrize("multi_pod", (False, True))
def test_rairs_cell_argument_bytes(multi_pod, monkeypatch, tmp_path):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    rec = dryrun.run_rairs_cell(multi_pod)
    assert rec["status"] == "ok" and rec["mode"] == "rairs_serve"
    assert rec["flops"] is None and rec["temp_size_in_bytes"] is None
    nd = 512 if multi_pod else 256
    tb = ((int(R.n_vectors * 1.15) // R.block) // nd + 1) * nd
    sharded = (tb * R.block * R.m_pq + 2 * tb * R.block * 4
               + R.n_vectors * R.d * 2 + 3 * nd * 4) // nd
    replicated = (R.nlist * (2 * 560 + 2 * 560 + 64) * 4
                  + R.nlist * R.d * 4 + R.m_pq * 16 * (R.d // R.m_pq) * 4
                  + 256 * R.d * 4)
    assert rec["argument_size_in_bytes"] == sharded + replicated
    assert len(dryrun.rairs_args(multi_pod)[0]) == 18


# ---------------------------------------------------------------------------
# the peak estimator
# ---------------------------------------------------------------------------
def test_peak_meter_exact_high_water_mark():
    arg = meta(250, dtype=torch.float32)                     # 1000 B
    meter = costpass.PeakMeter()
    assert meter.hold((arg, {"a": arg})) == 1000             # once

    def program(a):
        y = torch.zeros(500, device="meta")                  # +2000
        v = y.view(20, 25)                                   # a view
        y.add_(1.0)                                          # in place
        del y
        z = torch.zeros(100, device="meta")                  # +400: 3400
        del v                                                # -2000
        w = torch.zeros(1000, device="meta") + a.sum()       # 4000 + 4 +
        del z                                                # 4000 (out)
        return w
    with meter:
        out = program(arg)
    # arg 1000 + z 400 + w's sum 4 + the zeros 4000 + the sum's 4000
    assert meter.peak == 1000 + 400 + 4 + 4000 + 4000
    assert meter.live == 1000 + 4000
    del out
    assert meter.live == 1000
    assert meter.ops >= 6 and meter.bytes > 0
