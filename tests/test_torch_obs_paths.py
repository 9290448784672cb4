"""The port's spans on the paths the benchmark runs untraced, on the CPU.

The write path (``StreamingIndex.insert`` / ``delete``), the plan-cache
merge (``Searcher._probe_merge``) and ``build_index`` record their spans
as trees: children inside their parent, one level down, with ``rows`` and
``d2h`` counters.  With only ``torch.profiler`` on, the same names are
the profiler's annotations and the tracer records nothing; results stay
bitwise equal.  Graph replays are timed by CUDA events while timing is
on: here a stand-in graph and stand-in events drive ``GraphExe``'s call,
since the CPU has neither.
"""
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import IndexConfig, SearchParams, build_index
from repro_torch.core.graphs import GraphExe
from repro_torch.core.searcher import Searcher

# the module (``obs.tracer`` is its function of that name)
tracer_mod = importlib.import_module("repro_torch.obs.tracer")

CFG = IndexConfig(nlist=32, strategy="rair", seil=True, kmeans_iters=4,
                  pq_iters=4)


@pytest.fixture(autouse=True)
def clean_tracer():
    if obs.enabled():
        obs.stop()
    yield
    if obs.enabled():
        obs.stop()


@pytest.fixture(scope="module")
def data(unit_data):
    x, q, _ = unit_data
    return np.asarray(x[:4000], np.float32), np.asarray(q[:48], np.float32)


@pytest.fixture(scope="module")
def index(data):
    return build_index(data[0], CFG, device="cpu")


def _stream(index, data):
    s = index.streaming()
    s.insert(data[0][:64])
    return s


# ---------------------------------------------------------------------------
# span trees
# ---------------------------------------------------------------------------
def _insert(index, data):
    s = _stream(index, data)
    with obs.trace() as tr:
        s.insert(data[0][100:137])
    return tr


def _delete(index, data):
    s = _stream(index, data)
    with obs.trace() as tr:
        s.delete(np.array([3, 7, 3, s.n_base + 5, 11]))
    return tr


def _merge(mode):
    def run(index, data):
        s = Searcher(index, SearchParams(k=10, nprobe=8, exec_mode=mode,
                                         plan_reuse=True))
        s(data[1])
        with obs.trace() as tr:
            s(data[1])
        return tr
    return run


def _build(index, data):
    with obs.trace() as tr:
        built = build_index(data[0][:2000], CFG, device="cpu")
    tr.built = built
    return tr


# path -> (action, parent, children, counters on spans)
TREES = {
    "insert": (_insert, "stream.insert",
               {"stream.insert.assign", "stream.insert.encode",
                "stream.insert.host", "stream.insert.mirror"},
               {"stream.insert": {"rows": 37},
                "stream.insert.assign": {"d2h": 1, "d2h_bytes": 37 * 2 * 4},
                "stream.insert.encode": {"d2h": 1}}),
    "delete": (_delete, "stream.delete",
               {"stream.delete.host", "stream.delete.mirror"},
               {"stream.delete": {"rows": 5}}),
    "merge_clustered": (_merge("clustered"), "stage.merge_unions_host",
                        {"merge.d2h", "merge.signatures", "merge.union",
                         "merge.h2d"},
                        {"merge.d2h": {"d2h": 3}}),
    "merge_grouped": (_merge("grouped"), "stage.merge_unions_host",
                      {"merge.d2h", "merge.signatures", "merge.union",
                       "merge.h2d"},
                      {"merge.d2h": {"d2h": 1}}),
    "build": (_build, None,
              {"build.train", "build.assign", "build.encode",
               "build.layout"},
              {"build.assign": {"rows": 2000, "d2h": 1},
               "build.encode": {"rows": 2000, "d2h": 1}}),
}


@pytest.mark.parametrize("path", sorted(TREES))
def test_span_trees(index, data, path):
    drive, parent, children, counters = TREES[path]
    tr = drive(index, data)
    spans = [r for r in tr.records if r["kind"] == "span"]
    names = {r["name"] for r in spans}
    assert children <= names, names
    if parent is None:                      # the build's phases are roots
        assert all(r["depth"] == 0 for r in spans
                   if r["name"] in children)
    else:
        (top,) = [r for r in spans if r["name"] == parent]
        kids = [r for r in spans if r["name"] in children]
        assert {r["name"] for r in kids} == children
        for r in kids:
            assert r["depth"] == top["depth"] + 1, r
            assert top["ts"] <= r["ts"]
            assert r["ts"] + r["dur"] <= top["ts"] + top["dur"]
    for name, want in counters.items():
        got = tr.stage_summary()[name]["counters"]
        for key, v in want.items():
            assert got[key] == v, (name, key, got)
    for r in spans:
        if "d2h" in r["args"]:
            assert r["args"]["d2h_bytes"] > 0


def test_build_seconds_are_the_spans(index, data):
    tr = _build(index, data)
    dur = {r["name"]: r["dur"] for r in tr.records}
    assert tr.built.build_seconds == {
        k: dur[f"build.{k}"] for k in ("train", "assign", "encode",
                                       "layout")}
    plain = build_index(data[0][:2000], CFG, device="cpu")
    assert set(plain.build_seconds) == set(tr.built.build_seconds)
    assert all(v > 0 for v in plain.build_seconds.values())


# ---------------------------------------------------------------------------
# tracer off, profiler on: annotations only, results unchanged
# ---------------------------------------------------------------------------
def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return {e["name"] for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "user_annotation"}


@pytest.mark.parametrize("path", ["insert", "delete", "merge_clustered",
                                  "search", "search_all_threads"])
def test_profiler_alone_sees_the_spans_tracer_records_nothing(
        index, data, path, tmp_path):
    """Also under a profiler of every thread (the benchmark's), which
    leaves this thread's own profiler state unset."""
    s = _stream(index, data)
    sess = Searcher(index, SearchParams(k=10, nprobe=8,
                                        exec_mode="clustered",
                                        plan_reuse=True))
    sess(data[1])
    act = {"insert": lambda: s.insert(data[0][200:230]),
           "delete": lambda: s.delete(np.array([1, 2, 9])),
           "merge_clustered": lambda: sess(data[1]),
           "search": lambda: Searcher(index, SearchParams(
               k=10, nprobe=8))(data[1])}[path.replace("_all_threads", "")]
    want = {"insert": {"stream.insert", "stream.insert.assign",
                       "stream.insert.host", "stream.insert.mirror"},
            "delete": {"stream.delete", "stream.delete.host",
                       "stream.delete.mirror"},
            "merge_clustered": {"stage.merge_unions_host", "merge.d2h",
                                "merge.union", "merge.h2d",
                                "searcher.h2d"},
            "search": {"searcher.h2d", "searcher.dispatch"}
            }[path.replace("_all_threads", "")]
    kw = {}
    if path.endswith("_all_threads"):
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    w0, taken = obs.work_count(), obs.events_taken()
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        assert obs.timing() and not obs.enabled()
        act()
    assert obs.work_count() == w0 and obs.tracer() is None
    assert obs.events_taken() == taken      # no graph on the CPU
    assert want <= _annotations(prof, tmp_path)


@pytest.mark.parametrize("params", [
    dict(), dict(fused_topk=True),
    dict(exec_mode="clustered", plan_reuse=True),
    dict(exec_mode="grouped", plan_reuse=True, fused_topk=True)])
def test_results_bitwise_equal_with_the_profiler_on(index, data, params):
    p = SearchParams(k=10, nprobe=8, **params)
    want = Searcher(index, p)(data[1])
    with profile(activities=[ProfilerActivity.CPU]):
        got = Searcher(index, p)(data[1])
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---------------------------------------------------------------------------
# replay timing, with a stand-in graph and stand-in events
# ---------------------------------------------------------------------------
class _Event:
    """A CUDA timing event's stand-in: ``record`` reads a shared clock that
    each replay advances; ``query`` is false until ``synchronize``
    while ``held``."""
    clock = 0.0
    held = False

    def __init__(self):
        self.t, self.done = None, True

    def record(self):
        self.t, self.done = _Event.clock, not _Event.held

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.t - self.t


def _replay():
    _Event.clock += 2.5                    # ms of device time a replay


@pytest.fixture()
def fake_exe(monkeypatch):
    monkeypatch.setattr(tracer_mod, "_new_event", _Event)
    monkeypatch.setattr(tracer_mod, "_FREE", [])
    monkeypatch.setattr(tracer_mod, "_PENDING",
                        tracer_mod.collections.deque())
    monkeypatch.setattr(_Event, "held", False)
    exe = object.__new__(GraphExe)
    x = torch.zeros(4)
    exe.inputs, exe.clone, exe._static = (x,), True, [x]
    exe.graph = SimpleNamespace(replay=_replay)
    exe.launches = {}
    exe.outputs = (x,)
    exe.timing = None
    return exe


@pytest.mark.parametrize("timing", ["off", "tracer", "profiler"])
def test_graph_replays_timed_only_while_timing_is_on(
        fake_exe, index, data, monkeypatch, timing):
    """A session call that replays two graphs: with the profiler alone
    both replays and the one call reach the session's ``DeviceTime``;
    with a tracer they go onto the spans as ``device_ms`` and the
    counters (the untraced dispatch's) stay still."""
    sess = Searcher(index, SearchParams(k=10, nprobe=8))
    sink = fake_exe.timing = sess.timing
    real = sess._dispatch
    outs = []

    def dispatch(bucket, qc):              # two replays, one session call
        for _ in range(2):
            outs.append(fake_exe(torch.ones(4)))
        return real(bucket, qc)
    monkeypatch.setattr(sess, "_dispatch", dispatch)
    taken, w0 = obs.events_taken(), obs.work_count()
    if timing == "off":
        sess(data[1])
        assert obs.replay_span("r", sink) is obs.span("x")  # the no-op
        assert obs.work_count() == w0
    elif timing == "tracer":
        with obs.trace() as tr:
            sess(data[1])
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            sess(data[1])
    obs.settle()
    assert all(torch.equal(o[0], torch.ones(4)) for o in outs)
    if timing == "off":
        assert (sink.calls, sink.replays, sink.seconds) == (0, 0, 0.0)
        assert obs.events_taken() == taken
        return
    assert obs.events_taken() == taken + 4
    if timing == "profiler":
        assert (sink.calls, sink.replays) == (1, 2)
        assert sink.seconds == pytest.approx(2 * 2.5e-3)
        return
    assert (sink.calls, sink.replays, sink.seconds) == (0, 0, 0.0)
    spans = [r for r in tr.records
             if r["kind"] == "span" and r["name"].startswith("graph.")]
    assert [r["name"] for r in spans] == [
        "graph.copy_in", "graph.replay", "graph.clone_out"] * 2
    assert [r["args"]["device_ms"] for r in spans
            if r["name"] == "graph.replay"] == [2.5, 2.5]


def test_pending_pairs_resolve_by_query_then_one_wait(fake_exe):
    sink = fake_exe.timing = obs.DeviceTime()
    taken = obs.events_taken()
    _Event.held = True                     # replays still on the device
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            fake_exe(torch.ones(4))
    assert sink.replays == 3 and sink.seconds == 0.0
    assert len(tracer_mod._PENDING) == 3
    tracer_mod._PENDING[0][1].done = True  # the first finished: a later
    _Event.held = False                    # replay's poll resolves it
    with profile(activities=[ProfilerActivity.CPU]):
        fake_exe(torch.ones(4))
    assert len(tracer_mod._PENDING) == 3 and sink.seconds == 2.5e-3
    obs.settle()
    assert not tracer_mod._PENDING and sink.replays == 4
    assert sink.seconds == pytest.approx(4 * 2.5e-3)
    # three pairs were made; the fourth replay reused the first, resolved
    # by its poll; all are back in the pool
    assert len(tracer_mod._FREE) == 6 and obs.events_taken() == taken + 8


def test_owners_fold_timed_replays(index, data):
    """``searcher_stats`` of both owners carries the timed counters, across
    a stream's retired sessions too (zero on the CPU: no graph)."""
    s = _stream(index, data)
    p = SearchParams(k=10, nprobe=8)
    sess = s.searcher(p, device="cpu")
    sess.timing.calls, sess.timing.seconds = 2, 0.5
    s.insert(data[0][300:310])             # retires the session
    s.searcher(p, device="cpu").timing.calls = 1
    st = s.searcher_stats()
    assert (st["timed_calls"], st["timed_device_s"]) == (3, 0.5)
    base = index.searcher_stats()
    assert {"timed_calls", "timed_device_s"} <= set(base)
