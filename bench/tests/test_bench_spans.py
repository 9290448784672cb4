"""The per-layer readers of the program's spans and replay timing, over
tiny ``--trace 1`` runs on the CPU: each gives a number where its cell
runs the path it reads, and ``graph.device_ms_per_batch`` none (the CPU
replays no CUDA graph).  batch1024's traced run keeps the stretches it
had before these readers: none of them asks it for a profiled stretch."""
import time
from types import SimpleNamespace

import pytest
import torch

import tiny
import harness

CACHE = {}
SPAN_READERS = {
    "sift1m-rairs-stream.churn": [
        "stream.insert_ms_per_1k", "stream.insert.assign_ms_per_1k",
        "stream.insert.host_ms_per_1k", "stream.delete_ms_per_1k"],
    "sift1m-rairs.zipf-b64-reuse": [
        "stage_ms.merge_d2h", "stage_ms.merge_union"],
}
CASES = [(c, m) for c, ms in SPAN_READERS.items() for m in ms]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    root = tiny.write_tiny(tmp_path_factory.mktemp("tiny"))
    runs = {}

    def get(cell):
        if cell not in runs:
            spec = harness.load_cell(root, cell)
            runs[cell] = harness.run_cell(spec, 2 ** 31 + 11, 0.6, True,
                                          "cpu", time.perf_counter(),
                                          cache=CACHE)
        return runs[cell]
    return get


@pytest.mark.parametrize("cell,metric", CASES,
                         ids=[f"{c}-{m}" for c, m in CASES])
def test_span_readers_read_a_number(traced, cell, metric):
    run = traced(cell)
    assert metric in {m["name"] for m in run.spec.per_layer}
    v = harness.reader(metric).read(run)
    assert v is not None and v > 0


@pytest.mark.parametrize("cell", sorted(SPAN_READERS))
def test_graph_device_ms_is_none_on_the_cpu(traced, cell):
    run = traced(cell)
    assert run.graph_timed == (0, 0.0)       # collected: nothing timed
    assert harness.reader("graph.device_ms_per_batch").read(run) is None


@pytest.mark.parametrize("timed,want", [((4, 0.01), 2.5), ((0, 0.0), None)])
def test_graph_device_ms_on_a_card(timed, want):
    """On the card it is the timed device seconds over the timed calls."""
    run = SimpleNamespace(dev=torch.device("cuda"), graph_timed=timed)
    got = harness.reader("graph.device_ms_per_batch").read(run)
    assert got == (pytest.approx(want) if want is not None else None)


def test_batch1024_traced_stretches_unchanged():
    """No new reader adds a stretch to batch1024's traced run (a profiled
    stretch there would shorten the tracer's and move its stage spans)."""
    spec = harness.load_cell(tiny.ROOT, "sift1m-rairs.batch1024")
    assert harness._needs(spec) == {"profile_spans", "dco", "spans"}
