"""The one-card hillclimb: its terms from a cost record, the card's
constants, the copied roofline formulas against the reference
benchmark's, and the iterations run at reduced width (the mesh-shape
ones marked not applicable on one card)."""
import dataclasses
import json
from pathlib import Path

import pytest

from benchmarks import roofline as JR

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import costpass, hillclimb, shapes
from repro_torch.serve.step import knn_decode_cache_specs
from repro_torch.tree import leaves

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def test_terms_from_a_record(monkeypatch, tmp_path):
    monkeypatch.setattr(costpass, "RESULTS_DIR", str(tmp_path))
    (tmp_path / "qwen3-8b__decode_32k.json").write_text(json.dumps(
        {"cell": "qwen3-8b__decode_32k", "status": "ok", "flops": 4.0e12}))
    t = hillclimb.terms("qwen3-8b", "decode_32k")
    assert t["t_compute"] == 4.0e12 / 989e12
    assert t["t_memory"] == hillclimb.analytic_bytes(
        "qwen3-8b", "decode_32k") / 3.35e12
    assert t["t_collective"] is None
    assert t["roofline_frac"] == t["t_compute"] / max(t["t_compute"],
                                                      t["t_memory"])
    t8 = hillclimb.terms("qwen3-8b", "decode_32k", flops=1.0, kv_bytes=1)
    assert t8["t_compute"] == 1.0 / 989e12 and t8["t_memory"] < t["t_memory"]


def test_the_constants_are_the_cards():
    assert (hillclimb.PEAK, hillclimb.HBM) == (989e12, 3.35e12)
    assert (hillclimb.CHIPS, hillclimb.TP, hillclimb.DP) == (1, 1, 1)
    tpu = ("197e12", "819e9", "50e9", "197 TFLOP", "819 GB")
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        assert not any(c in text for c in tpu), path


@pytest.mark.parametrize("arch", list(ARCHS))
def test_roofline_formulas_match_the_reference(arch, monkeypatch):
    """`model_flops`, `_param_counts` and `analytic_bytes` are copies of
    the reference benchmark's; at one card (its chip count patched to 1)
    they agree on every cell."""
    monkeypatch.setattr(JR, "CHIPS", 1)
    assert hillclimb._param_counts(ARCHS[arch]) == JR._param_counts(
        JR.ARCHS[arch])
    for shape in SHAPES:
        assert hillclimb.model_flops(arch, shape) == JR.model_flops(arch,
                                                                   shape)
        for kv in (1, 2):
            assert hillclimb.analytic_bytes(arch, shape, kv_bytes=kv) == \
                JR.analytic_bytes(arch, shape, tp=1, dp=1, kv_bytes=kv), \
                (shape, kv)


def test_int8_long_cache_bytes_at_full_width():
    cfg = ARCHS["qwen3-8b"]

    def cache_bytes(dt):
        kc = dataclasses.replace(shapes.LONG_KNN_CFG, cache_dtype=dt)
        return sum(costpass.nbytes(t) for t in leaves(
            knn_decode_cache_specs(cfg, kc, 1)))
    assert cache_bytes("int8") <= 0.55 * cache_bytes("bf16")


def test_hillclimb_iterations_reduced(monkeypatch, tmp_path):
    red = {a: dataclasses.replace(ARCHS[a].reduced(), name=a)
           for a in ("arctic-480b", "olmoe-1b-7b", "qwen3-8b")}
    monkeypatch.setattr(shapes, "ARCHS", dict(shapes.ARCHS, **red))
    monkeypatch.setattr(shapes, "SHAPES", {
        "train_4k": dict(kind="train", seq_len=32, global_batch=8),
        "prefill_32k": dict(kind="prefill", seq_len=64, global_batch=2),
        "long_500k": dict(kind="long_decode", seq_len=4096,
                          global_batch=1)})
    monkeypatch.setattr(costpass, "RESULTS_DIR", str(tmp_path / "cost"))
    monkeypatch.setattr(hillclimb, "RESULTS", str(tmp_path / "hc.json"))
    log = hillclimb.main()
    assert json.loads((tmp_path / "hc.json").read_text()) == json.loads(
        json.dumps(log, default=str))
    by = {(e["cell"], e["iteration"]): e for e in log}
    assert len(by) == len(log) == 12
    for cell, its in (("arctic-480b/train_4k", (2, 3)),
                      ("olmoe-1b-7b/prefill_32k", (1, 2, 3)),
                      ("qwen3-8b/long_500k", (3,))):
        for it in its:
            assert by[(cell, it)]["verdict"] == "not applicable on one card"
            assert by[(cell, it)]["hypothesis"]
    assert "TP16->8" in by[("arctic-480b/train_4k", 2)]["hypothesis"]
    assert "TP 8->4" in by[("olmoe-1b-7b/prefill_32k", 2)]["hypothesis"]
    a1 = by[("arctic-480b/train_4k", 1)]
    assert a1["verdict"] == "confirmed"        # bf16 grads: same FLOPs
    c1 = by[("qwen3-8b/long_500k", 1)]
    assert c1["verdict"] == "confirmed"
    assert c1["measured"]["cache_bytes_ratio"] <= 0.55
    assert c1["compile"]["plan_ok"] and c1["compile"]["peak_bytes"] > 0
    c2 = by[("qwen3-8b/long_500k", 2)]
    assert c2["compile"]["cache_bytes"] < c1["compile"]["cache_bytes"]
    assert c2["measured"]["t_memory"] < c1["measured"]["t_memory"]
    for e in log:
        if e["verdict"] not in ("baseline", "not applicable on one card"):
            assert e["measured"]["t_collective"] is None
