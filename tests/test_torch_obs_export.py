"""The port's trace export and unified stats (``repro_torch/obs/export.py``,
``obs/stats.py``) against the reference's, on the CPU.

``to_trace_events`` of a port tracer is the document the reference's
exporter renders from the same records, and has the layout of a
reference tracer's document for the same spans; ``validate_trace``
accepts and rejects the same documents; ``to_prometheus`` renders one
stats dict to identical text; the traffic models return equal dicts
(with and without a compact plane); ``snapshot_all`` has the
reference's keys, with and without a gateway.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro import gateway as jgw
from repro import obs as jobs
from repro.core import RefineParams as JRefine
from repro.core import SearchParams as JParams
from repro.core.searcher import Searcher as JSearcher
from repro.obs import export as jexport
from repro_torch import obs
from repro_torch.convert import index_from_numpy
from repro_torch.core import RefineParams, SearchParams
from repro_torch.core.searcher import Searcher
from repro_torch.gateway import Gateway, GatewayConfig

# spans of the port's session that the reference has no counterpart of
PORT_SPANS = {"searcher.h2d", "graph.copy_in", "graph.replay",
              "graph.clone_out", "merge.d2h", "merge.signatures",
              "merge.union", "merge.h2d"}
SEIL = ("block_codes", "block_ids", "block_other", "owned", "refs",
        "refs_other", "misc")
WAIT = 60.0


@pytest.fixture(autouse=True)
def clean_tracers():
    for mod in (obs, jobs):
        if mod.enabled():
            mod.stop()
    yield
    for mod in (obs, jobs):
        if mod.enabled():
            mod.stop()


@pytest.fixture(scope="module")
def tindex(rairs_index):
    j = rairs_index
    arrays = {f: np.asarray(getattr(j.arrays, f)) for f in SEIL}
    arrays.update(centroids=np.asarray(j.centroids),
                  codebooks=np.asarray(j.codebook.codebooks),
                  vectors=np.asarray(j.vectors), assigns=j.assigns,
                  codes=j.codes)
    return index_from_numpy(dataclasses.asdict(j.config), arrays,
                            device="cpu")


def _record(mod):
    """The spans and events of ``tests/test_obs.py``'s export round trip,
    on ``mod``'s tracer.  The second exemplar event lies a minute after
    the tracer's start, where no span of the recording reaches, so that
    sorting by time puts it last in both packages' documents."""
    with mod.trace() as tr:
        with mod.span("stage.demo", cat="device", approx_dco=3):
            with mod.span("inner"):
                pass
        tr.event("gateway.request", tr.t0, 1e-3, queued_ms=0.1)
        tr.event("gateway.request", tr.t0 + 60.0, 1e-3, queued_ms=0.2,
                 batch=4)
        with mod.span("gateway.flush", cat="gateway", batch=4):
            mod.fence(None)
    return tr


def _layout(doc):
    """A document without its clock: every field but ts / dur."""
    ev = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
          for e in doc["traceEvents"]]
    return dict(doc, traceEvents=ev)


def test_trace_events_are_the_reference_document():
    tr = _record(obs)
    got = obs.to_trace_events(tr)
    assert got == jexport.to_trace_events(tr)
    assert _layout(got) == _layout(jobs.to_trace_events(_record(jobs)))
    for e in got["traceEvents"]:
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0


def test_write_trace_round_trip_and_cli(tmp_path, capsys):
    tr = _record(obs)
    path = tmp_path / "trace.json"
    doc = obs.write_trace(tr, str(path))
    assert json.loads(path.read_text()) == doc
    assert obs.write_trace(doc, str(tmp_path / "again.json")) == doc
    from repro_torch.obs.export import main
    assert main([str(path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("ok: ") and "device=1" in out and "gateway=1" in out
    assert jexport.main([str(path)]) == 0      # the reference accepts it
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(ValueError):
        main([str(bad)])


_OK = {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 0,
                        "ts": 0.0, "dur": 1.0}]}
_DOCS = [
    _OK,
    [],                                             # not an object
    {"traceEvents": []},                            # empty
    {"traceEvents": [{"name": "a", "ph": "B", "pid": 1, "tid": 0}]},
    {"traceEvents": [{"ph": "X", "pid": 1, "tid": 0,
                      "ts": 0.0, "dur": 1.0}]},     # nameless
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 0,
                      "ts": -1.0, "dur": 1.0}]},    # negative ts
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 0,
                      "ts": 0.0, "dur": 1.0, "args": 7}]},
    {"traceEvents": [{"name": "a", "ph": "M", "pid": 1, "tid": "0"}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 0,
                      "ts": 0.0}]},                 # no dur
    {"traceEvents": [7]},
]


@pytest.mark.parametrize("i", range(len(_DOCS)))
def test_validate_trace_accepts_and_rejects_alike(i):
    doc = _DOCS[i]

    def verdict(fn):
        try:
            return ("ok", fn(doc) is doc)
        except ValueError as e:
            return ("refused", str(e))
    assert verdict(obs.validate_trace) == verdict(jobs.validate_trace)
    assert verdict(obs.validate_trace)[0] == ("ok" if i == 0 else "refused")


_STATS = [
    {"a": {"b": 1.5, "on": True}, "c": 2, "drop": ["x"], "strs": "no",
     "name.with-dots": 7},
    {"gateway": {"telemetry": {"counters": {"requests": 12, "shed": 0},
                               "latency": {"p50_ms": 0.25, "p99_ms": 1e-7},
                               "qps": 1234.5678901}, "closed": False},
     "schema_version": 1, "neg": -3.25, "big": 3e12},
]


@pytest.mark.parametrize("i", range(len(_STATS)))
def test_prometheus_text_identical(i):
    text = obs.to_prometheus(_STATS[i])
    assert text == jobs.to_prometheus(_STATS[i])
    assert obs.to_prometheus(_STATS[i], prefix="x") == jobs.to_prometheus(
        _STATS[i], prefix="x")
    lines = text.splitlines()
    assert text.endswith("\n") and lines == sorted(lines)


@pytest.mark.parametrize("scan_width,fetch", [(3200, 100), (1000, 1000),
                                              (54272, 400), (7, 3)])
def test_scan_traffic_model_equal(scan_width, fetch):
    assert (obs.scan_traffic_model(scan_width=scan_width, fetch=fetch)
            == jobs.scan_traffic_model(scan_width=scan_width, fetch=fetch))


@pytest.mark.parametrize("refine", [None, ("binary", 4), ("pq4", 4)])
@pytest.mark.parametrize("fused", [False, True])
def test_session_traffic_model_equal(rairs_index, tindex, refine, fused):
    kw = dict(k=10, nprobe=8, fused_topk=fused)
    tp = SearchParams(**kw, refine=None if refine is None
                      else RefineParams(*refine))
    jp = JParams(**kw, refine=None if refine is None else JRefine(*refine))
    got = obs.session_traffic_model(Searcher(tindex, tp))
    want = jobs.session_traffic_model(JSearcher(rairs_index, jp))
    assert got == want
    assert ("refine" in got) == (refine is not None)


def test_snapshot_all_keys_match_reference(rairs_index, tindex, unit_data):
    _, q, _ = unit_data
    qs = np.array(q[:16], np.float32)
    snaps = []
    for mod, sess in ((obs, tindex.searcher(SearchParams(k=10, nprobe=8),
                                            device="cpu")),
                      (jobs, rairs_index.searcher(JParams(k=10, nprobe=8)))):
        sess(qs)
        with mod.trace() as tr:
            sess(qs)
        snaps.append(mod.snapshot_all(searcher=sess, tracer=tr))
    got, want = snaps
    assert set(got) == set(want) == {"schema_version", "session",
                                     "hbm_model", "trace"}
    assert got["schema_version"] == want["schema_version"]
    for key in ("session", "hbm_model", "trace"):
        assert set(got[key]) == set(want[key]), key
    assert got["hbm_model"] == want["hbm_model"]
    # the port's session adds its own spans; on the CPU only the queries'
    # copy to the device (no graph, no plan-reuse merge here)
    assert (set(got["trace"]["spans"]) - PORT_SPANS
            == set(want["trace"]["spans"]))
    assert "searcher.h2d" in got["trace"]["spans"]
    assert got["trace"]["dco"] == want["trace"]["dco"]
    assert 0.0 < got["trace"]["stage_attribution"] <= 1.0
    assert "rairs_trace_stage_attribution" in obs.to_prometheus(got)
    assert set(obs.snapshot_all()) == set(jobs.snapshot_all())


def test_snapshot_all_with_gateway_keys_match_reference(rairs_index, tindex,
                                                        unit_data):
    _, q, _ = unit_data
    qs = np.array(q[:8], np.float32)
    snaps = []
    for gw_cls, cfg_cls, mod, idx in (
            (Gateway, GatewayConfig, obs, tindex),
            (jgw.Gateway, jgw.GatewayConfig, jobs, rairs_index)):
        with gw_cls(idx, k=10, nprobe=8,
                    config=cfg_cls(max_batch=8, max_delay_ms=2.0)) as gw:
            for v in qs:
                gw.search(v, timeout=WAIT)
            snaps.append(mod.snapshot_all(gateway=gw))
    got, want = snaps
    assert set(got) == set(want) == {"schema_version", "gateway", "session",
                                     "hbm_model"}
    assert set(got["gateway"]) == set(want["gateway"])
    assert (set(got["gateway"]["telemetry"])
            == set(want["gateway"]["telemetry"]))
    assert got["gateway"]["telemetry"]["counters"]["responses"] == 8
    assert got["hbm_model"] == want["hbm_model"]
    assert obs.to_prometheus(got).count("\n") > 20
