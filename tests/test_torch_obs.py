"""The port's tracer (``repro_torch/obs``) against the reference's, on the CPU.

Tracing off is the production path: the work counter does not move over
a session's dispatch, ``span()`` is a shared no-op and ``fence()``
returns its argument.  Tracing on changes when the host observes values,
never the values: ``seil_search`` under a tracer and the traced session
dispatches equal their untraced runs bitwise, and record the reference's
span names (its ``seil_search_traced``'s) with the same DCO counters.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import search as jsearch
from repro_torch import obs
from repro_torch.convert import index_from_numpy
from repro_torch.core import SearchParams
from repro_torch.core import search as tsearch
from repro_torch.core.searcher import Searcher

BUNDLE_FIELDS = ("block_codes", "block_ids", "block_other", "owned", "refs",
                 "refs_other", "misc")


@pytest.fixture(autouse=True)
def clean_tracers():
    """No tracer of either package leaks into or out of a test."""
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
    arrays = {f: np.asarray(getattr(j.arrays, f)) for f in BUNDLE_FIELDS}
    arrays.update(centroids=np.asarray(j.centroids),
                  codebooks=np.asarray(j.codebook.codebooks),
                  vectors=np.asarray(j.vectors), assigns=j.assigns,
                  codes=j.codes)
    return index_from_numpy(dataclasses.asdict(j.config), arrays,
                            device="cpu")


def _equal(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# tracer contracts
# ---------------------------------------------------------------------------
def test_start_stop_contracts():
    with pytest.raises(RuntimeError):
        obs.stop()                          # nothing active
    tr = obs.start()
    try:
        assert obs.enabled() and obs.tracer() is tr
        with pytest.raises(RuntimeError):
            obs.start()                     # no nested tracers
    finally:
        assert obs.stop() is tr
    assert not obs.enabled() and obs.tracer() is None
    with pytest.raises(ValueError):
        obs.Tracer(sample=0)
    with obs.trace() as tr2:
        assert obs.tracer() is tr2
    assert not obs.enabled()


def test_max_events_sampling_and_nesting():
    with obs.trace(max_events=2) as tr:
        for i in range(5):
            with obs.span(f"s{i}"):
                pass
    assert len(tr.records) == 2 and tr.dropped == 3
    with obs.trace(sample=3) as tr:
        hits = [tr.sampled() for _ in range(9)]
        tr.event("request", tr.t0, 1e-3)
        with obs.span("outer") as sp:
            sp.add(n=2)
            with obs.span("inner"):
                pass
    assert hits == [True, False, False] * 3
    ev, inner, outer = tr.records
    assert ev["kind"] == "event"
    assert (inner["name"], inner["depth"]) == ("inner", 1)
    assert (outer["name"], outer["depth"], outer["args"]) == ("outer", 0,
                                                              {"n": 2})
    summary = tr.stage_summary()
    assert summary["outer"]["counters"] == {"n": 2}


def test_disabled_tracing_does_no_work(tindex, unit_data):
    _, q, _ = unit_data
    s = Searcher(tindex, SearchParams(k=10, nprobe=8, exec_mode="clustered",
                                      plan_reuse=True))
    qs = torch.from_numpy(np.array(q[:32]))
    s(qs)
    assert not obs.enabled() and obs.tracer() is None
    w0, taken = obs.work_count(), obs.events_taken()
    s(qs)
    assert obs.work_count() == w0           # no span, event or fence
    assert obs.events_taken() == taken      # no replay timed
    assert not obs.timing()
    assert obs.span("a", cat="device") is obs.span("b")
    assert obs.replay_span("r", s.timing) is obs.span("b")
    x = torch.arange(3)
    assert obs.fence(x) is x
    assert torch.equal(obs.to_host(x), x)
    assert obs.work_count() == w0
    # the profiler alone: its annotations, nothing recorded here
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = s(qs)
    assert obs.work_count() == w0 and obs.tracer() is None
    assert obs.events_taken() == taken and s.timing.calls == 0
    names = {e.name for e in prof.events()}
    assert {"searcher.h2d", "searcher.dispatch", "stage.merge_unions_host",
            "merge.union"} <= names
    want = s(qs)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---------------------------------------------------------------------------
# traced == untraced, with the reference's spans and counters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["paged", "grouped", "clustered"])
@pytest.mark.parametrize("fused", [False, True])
def test_seil_search_under_tracer_matches_untraced_and_reference(
        rairs_index, tindex, unit_data, mode, fused):
    _, q, _ = unit_data
    qa = np.array(q[:32])
    kw = dict(nprobe=8, bigk=100, k=10,
              max_scan=rairs_index.default_max_scan(8), metric="l2",
              dedup_results=rairs_index.needs_result_dedup,
              oversample=rairs_index.result_oversample, exec_mode=mode,
              query_tile=8, fused_topk=fused)
    args = (tindex.arrays, tindex.centroids, tindex.codebook, tindex.vectors,
            torch.from_numpy(qa))
    plain = tsearch.seil_search(*args, **kw)
    with obs.trace() as tr:
        traced = tsearch.seil_search(*args, **kw)
    _equal(traced, plain)
    with jobs.trace() as jtr:
        jsearch.seil_search_traced(
            rairs_index.arrays, rairs_index.centroids, rairs_index.codebook,
            rairs_index.vectors, jnp.asarray(qa), **kw)
    got, want = tr.stage_summary(), jtr.stage_summary()
    assert set(got) == set(want)
    for name in want:
        assert got[name]["count"] == want[name]["count"], name
        assert got[name]["counters"] == want[name]["counters"], name
    scan = "stage.scan_blocks_topk" if fused else "stage.scan_blocks"
    assert got[scan]["counters"]["approx_dco"] == int(plain.approx_dco.sum())
    assert got["stage.finalize"]["counters"]["refine_dco"] == int(
        plain.refine_dco.sum())
    assert tr.fences == 4


def test_capture_under_tracer_fences_and_counts_nothing(tindex, unit_data,
                                                        monkeypatch):
    """While a CUDA graph captures (a session warmed up under an active
    tracer), ``seil_search``'s fences synchronize nothing and its spans
    read no counter (``int()`` of a device tensor would break the
    capture); the results are the plain ones.  The capture is faked on
    the CPU."""
    _, q, _ = unit_data
    kw = dict(nprobe=8, bigk=100, k=10, max_scan=64, fused_topk=True)
    args = (tindex.arrays, tindex.centroids, tindex.codebook, tindex.vectors,
            torch.from_numpy(np.array(q[:16])))
    plain = tsearch.seil_search(*args, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with obs.trace() as tr:
        assert not obs.recording()
        got = tsearch.seil_search(*args, **kw)
    _equal(got, plain)
    assert tr.fences == 0
    summary = tr.stage_summary()
    assert summary["stage.scan_blocks_topk"]["counters"] == {}
    assert summary["stage.finalize"]["counters"] == {}


@pytest.mark.parametrize("params,expect_spans", [
    (dict(), {"stage.select_lists", "stage.plan_blocks",
              "stage.scan_blocks", "stage.finalize"}),
    (dict(fused_topk=True), {"stage.scan_blocks_topk"}),
    (dict(exec_mode="clustered", plan_reuse=True),
     {"stage.probe_plan", "stage.merge_unions_host", "stage.scan_finalize"}),
    (dict(exec_mode="grouped", plan_reuse=True, fused_topk=True),
     {"stage.probe_plan", "stage.merge_unions_host", "stage.scan_finalize"}),
])
def test_traced_session_bitwise_identical(tindex, unit_data, params,
                                          expect_spans):
    _, q, _ = unit_data
    qs = torch.from_numpy(np.array(q[:48]))
    p = SearchParams(k=10, nprobe=8, **params)
    want = Searcher(tindex, p)(qs)
    s = Searcher(tindex, p)
    with obs.trace() as tr:
        got = s(qs)
    _equal(got, want)
    summary = tr.stage_summary()
    assert expect_spans <= set(summary), summary.keys()
    assert "searcher.dispatch" in summary
    if p.plan_reuse:                 # the session built its executables
        assert summary["searcher.compile"]["count"] == 2
        merge = summary["stage.merge_unions_host"]["counters"]
        assert merge["misses"] == merge["tiles"]       # a cold cache
    assert tr.fences > 0
