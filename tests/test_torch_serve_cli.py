"""The port's serve CLI (``python -m repro_torch.launch.serve``), on the
CPU at the ``unit`` size: the reference CLI's flags and errors, plain
and sharded serving (``--ndev``), the churn ops, ``--save`` / ``--load``
with ``--shards``, ``--gateway`` (with the epoch handover), ``--trace``
and ``--stats-format``; without ``--device cpu`` it needs a card."""
import json
import re

import pytest
import torch

from repro_torch.core import ShardedIndex, load_index
from repro_torch.launch import serve

UNIT = ["--device", "cpu", "--dataset", "unit", "--nlist", "64"]


def run(capsys, *args):
    assert serve.main(UNIT + list(args)) == 0
    return capsys.readouterr().out


def recalls(out):
    return [float(v) for v in re.findall(r"recall@10=([0-9.]+)", out)]


@pytest.mark.parametrize("argv,msg", [
    (["--shards", "2"], "--shards only applies to --save"),
    (["--ndev", "2", "--plan-reuse", "--exec-mode", "grouped"],
     "--plan-reuse is single-host only"),
    (["--plan-reuse"], "--plan-reuse needs --exec-mode grouped"),
    (["--ndev", "2", "--gateway", "--compact"],
     "--gateway --compact needs the un-sharded"),
    (["--load", "x.npz", "--save", "y.npz"], "--save with --load needs"),
    (["--offered-qps", "1,fast"], "--offered-qps must be comma-separated"),
    (["--ndev", "-1"], "--ndev must be >= 0"),
])
def test_argument_errors(capsys, argv, msg):
    with pytest.raises(SystemExit) as e:
        serve.main(UNIT + argv)
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_needs_a_card_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--dataset", "unit", "--nlist", "64"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--dataset", "unit", "--nlist", "64", "--ndev", "4"])


@pytest.mark.parametrize("ndev", ["0", "4"])
def test_serves_plain_and_sharded(capsys, ndev):
    out = run(capsys, "--batches", "2", "--batch-size", "100",
              "--ndev", ndev, "--exec-mode", "clustered", "--fused-topk")
    assert len(recalls(out)) == 2 and min(recalls(out)) > 0.9
    if ndev == "4":
        assert "serving over a 4-shard mesh on ['cpu']" in out
        assert "sharded searcher stats: {'sessions': 1" in out


def test_sharded_save_load_round_trip(capsys, tmp_path):
    """Churn, a 4-way v3 bundle, then a load served over 2 shards: the
    same recall as the run that saved it."""
    path = str(tmp_path / "churned")
    out1 = run(capsys, "--batches", "2", "--batch-size", "100",
               "--insert", "256", "--delete", "64", "--ndev", "4",
               "--save", path, "--shards", "4")
    assert "saved sharded (4-way) bundle" in out1
    assert "stream: epoch=0 version=2 live=5936 delta=253 dead=64" in out1
    loaded = load_index(path, device="cpu")
    assert loaded.n_live == 5936
    out2 = run(capsys, "--batches", "2", "--batch-size", "100",
               "--load", path, "--ndev", "2")
    assert "restored stream: epoch=0 version=2" in out2
    assert recalls(out2) == recalls(out1)
    sharded = load_index(path, mesh=serve.make_mesh(2, device="cpu"))
    assert isinstance(sharded, ShardedIndex) and sharded.streaming


def test_gateway_sharded_with_trace_and_stats(capsys, tmp_path):
    trace = str(tmp_path / "trace.json")
    out = run(capsys, "--ndev", "4", "--gateway", "--offered-qps", "400",
              "--gateway-requests", "64", "--max-batch", "16",
              "--trace", trace, "--stats-format", "json")
    assert "errors=0" in out and min(recalls(out)) > 0.9
    doc = json.load(open(trace))
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"stage.shard_scan", "stage.gather_finalize"} <= names
    snap = json.loads(out[out.index("{\n"):])
    assert snap["gateway"]["telemetry"]["counters"]["responses"] == 64
    assert snap["trace"]["spans"]["stage.shard_scan"]["count"] >= 1


def test_gateway_handover_on_a_stream(capsys):
    out = run(capsys, "--gateway", "--insert", "256", "--delete", "64",
              "--compact", "--offered-qps", "500,1000",
              "--gateway-requests", "128", "--max-batch", "16",
              "--stats-format", "prom")
    assert "handover installed: epoch=1" in out
    assert out.count("errors=0") == 2 and min(recalls(out)) > 0.9
    assert "rairs_gateway_telemetry_counters_handovers 1" in out
