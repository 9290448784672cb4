"""The port's serving gateway (``repro_torch/gateway``) on the CPU.

Each test of ``tests/test_gateway.py`` has its counterpart here, over
the reference's unit index carried into the port; the gateway fault
cases of ``tests/test_faults.py`` too (sites ``gateway.dispatch`` and
``gateway.fold``).  Parity with the reference on the same inputs: a
deterministic flush (every query submitted, ``max_batch`` = the count)
answers bitwise as the reference gateway does (ids; distances within
rtol=atol=1e-5), the queue takes requests in the same order, the
latency histogram gives the same percentiles, ``degrade_ladder`` the
same ladder, admission the same signatures, and a handover under live
traffic leaves both packages' streams in the same state.  Every wait
has a timeout.
"""
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest

from repro import gateway as jgw
from repro.core import IndexConfig as JConfig
from repro.core import SearchParams as JParams
from repro.core import StreamConfig as JStreamConfig
from repro.core import StreamingIndex as JStream
from repro.core import build_index as j_build
from repro_torch.convert import index_from_numpy
from repro_torch.core import SearchParams, StreamConfig, StreamingIndex
from repro_torch.errors import (DeadlineExceeded, FaultInjected,
                                HandoverFailed, Overloaded, RairsError)
from repro_torch.faults import FaultPlan, FaultSpec
from repro_torch.gateway import (Gateway, GatewayClosed, GatewayConfig,
                                 LatencyHistogram, MemorySink,
                                 PendingRequest, RequestQueue,
                                 degrade_ladder, run_open_loop)
from repro_torch.gateway.telemetry import Telemetry

SEIL = ("block_codes", "block_ids", "block_other", "owned", "refs",
        "refs_other", "misc")
TOL = dict(rtol=1e-5, atol=1e-5)
CHAOS_SEED = 1234
WAIT = 60.0


def carry(j):
    """A reference ``RairsIndex`` as the port's, on the CPU."""
    arrays = {f: np.asarray(getattr(j.arrays, f)) for f in SEIL}
    arrays.update(centroids=np.asarray(j.centroids),
                  codebooks=np.asarray(j.codebook.codebooks),
                  vectors=np.asarray(j.vectors), assigns=j.assigns,
                  codes=j.codes)
    return index_from_numpy(dataclasses.asdict(j.config), arrays,
                            device="cpu")


@pytest.fixture(scope="module")
def tindex(rairs_index):
    return carry(rairs_index)


@pytest.fixture(scope="module")
def stream_base(unit_data, shared_trained):
    """The reference's 4,000-vector base of ``tests/test_gateway.py``."""
    x, _, _ = unit_data
    cents, cb = shared_trained
    return j_build(jax.random.PRNGKey(0), x[:4000],
                   JConfig(nlist=64, strategy="rair", seil=True),
                   centroids=cents, codebook=cb)


@pytest.fixture()
def stream_index(stream_base):
    """A fresh mutable port index per test."""
    return StreamingIndex(carry(stream_base), StreamConfig(delta_pad=512))


def host(q):
    return np.array(q, np.float32)


# ---------------------------------------------------------------------------
# config validation + lifecycle
# ---------------------------------------------------------------------------

def test_config_validation(tindex):
    with pytest.raises(ValueError):
        GatewayConfig(max_delay_ms=-1.0)
    with pytest.raises(ValueError):
        GatewayConfig(max_batch=0)
    with pytest.raises(ValueError):
        GatewayConfig(admission="lifo")
    with pytest.raises(ValueError):
        GatewayConfig(compact_delta_frac=0.0)
    with pytest.raises(ValueError):
        Gateway(tindex, k=10, nprobe=8,
                config=GatewayConfig(compact_delta_frac=0.5))


def test_submit_validates_and_close_rejects(tindex, unit_data):
    import torch
    _, q, _ = unit_data
    q = host(q)
    with Gateway(tindex, k=10, nprobe=8,
                 config=GatewayConfig(max_batch=4)) as gw:
        with pytest.raises(ValueError):
            gw.submit(q[0][:8])
        with pytest.raises(ValueError):
            gw.submit(q[:2])
        r = gw.search(q[0], timeout=WAIT)
        assert r.ids.shape == (10,) and r.ids.dtype == np.int64
        # a CPU tensor is a host query too
        rt = gw.search(torch.from_numpy(q[0]), timeout=WAIT)
        np.testing.assert_array_equal(rt.ids, r.ids)
        with pytest.raises(TypeError):
            gw.insert(q[:1])
        with pytest.raises(TypeError):
            gw.compact_async()
    assert gw.stats()["closed"]
    with pytest.raises(GatewayClosed):
        gw.submit(q[0])
    with pytest.raises(RuntimeError):
        gw.submit(q[0])


def test_submit_refuses_a_query_on_another_device(tindex, unit_data):
    """A client thread never touches the card: a query tensor off the
    host is refused (a meta tensor stands in for a CUDA one here)."""
    import torch
    _, q, _ = unit_data
    with Gateway(tindex, k=10, nprobe=8,
                 config=GatewayConfig(max_batch=2, warmup=False)) as gw:
        with pytest.raises(TypeError, match="host query"):
            gw.submit(torch.empty(q.shape[1], device="meta"))


# ---------------------------------------------------------------------------
# results: gateway == direct session, coalescing happens
# ---------------------------------------------------------------------------

def test_gateway_matches_direct_session(tindex, unit_data):
    _, q, _ = unit_data
    q = host(q)
    params = SearchParams(k=10, nprobe=8)
    direct = tindex.searcher(params, device="cpu")
    with Gateway(tindex, params,
                 config=GatewayConfig(max_batch=8, max_delay_ms=5.0)) as gw:
        pending = [gw.submit(q[i]) for i in range(16)]
        results = [p.result(WAIT) for p in pending]
    for i, r in enumerate(results):
        ref = direct(q[i:i + 1])
        np.testing.assert_array_equal(r.ids,
                                      ref.ids.numpy()[0].astype(np.int64))
        np.testing.assert_allclose(r.dists, ref.dists.numpy()[0], rtol=1e-5)


def test_burst_coalesces_and_deadline_flushes(tindex, unit_data):
    _, q, _ = unit_data
    q = host(q)
    with Gateway(tindex, k=10, nprobe=8,
                 config=GatewayConfig(max_batch=16, max_delay_ms=50.0)) as gw:
        pending = [gw.submit(q[i]) for i in range(32)]
        results = [p.result(WAIT) for p in pending]
        assert max(r.batch for r in results) > 1
        snap = gw.telemetry.snapshot()
        assert snap["batch_fill"] > 1.0
        assert snap["counters"]["responses"] == 32
        t0 = time.perf_counter()
        lone = gw.search(q[0], timeout=WAIT)
        assert lone.batch == 1
        assert time.perf_counter() - t0 < 5.0


def test_open_loop_generator(tindex, unit_data):
    _, q, _ = unit_data
    with Gateway(tindex, k=10, nprobe=8,
                 config=GatewayConfig(max_batch=8, max_delay_ms=2.0)) as gw:
        out = run_open_loop(gw, host(q[:32]), offered_qps=2000.0,
                            n_requests=64, timeout_s=WAIT, collect=True)
    assert out["errors"] == 0 and out["n_ok"] == 64
    assert out["p50_ms"] > 0 and out["p99_ms"] >= out["p50_ms"]
    assert out["mean_batch"] >= 1.0
    assert out["ok_ids"].shape == (64, 10)
    np.testing.assert_array_equal(out["ok_query_idx"], np.arange(64) % 32)


# ---------------------------------------------------------------------------
# queue semantics (no gateway)
# ---------------------------------------------------------------------------

def _req(sig, deadline=None):
    return PendingRequest(np.zeros(4, np.float32), sig, deadline=deadline)


def test_queue_drains_whole_lanes_oldest_first():
    qu = RequestQueue(grouped=True)
    a0, b0, a1 = _req(7), _req(3), _req(7)
    for r in (a0, b0, a1):
        qu.put(r)
    assert qu.take_batch(16) == [a0, a1, b0]
    assert qu.depth == 0 and qu.take_batch(4) == []


def test_queue_respects_max_batch_and_fifo_within_lane():
    qu = RequestQueue(grouped=False)
    reqs = [_req(i) for i in range(5)]
    for r in reqs:
        qu.put(r)
    assert qu.take_batch(3) == reqs[:3]
    assert qu.take_batch(3) == reqs[3:]


def test_queue_deadline_tightens_flush():
    qu = RequestQueue(grouped=True)
    now = time.perf_counter()
    qu.put(_req(1, deadline=now + 0.001))
    due = qu.oldest_flush_at(max_delay=10.0)
    assert due is not None and due - now < 0.1
    qu.take_batch(8)
    assert qu.oldest_flush_at(10.0) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_take_order_matches_reference(seed):
    """One sequence of puts (signatures, deadlines, a bound that sheds)
    through both packages' queues: the same requests shed, expired and
    taken, in the same order."""
    rng = np.random.default_rng(seed)
    n = 60
    sigs = rng.integers(0, 6, n)
    past = rng.random(n) < 0.15
    grouped = bool(seed % 2 == 0)
    qs = [RequestQueue(grouped=grouped, max_queue=40, policy="reject"),
          jgw.RequestQueue(grouped=grouped, max_queue=40, policy="reject")]
    idx = {}                     # id(request) -> its put's position
    shed = [[], []]
    now = time.perf_counter()
    for i in range(n):
        for side, (qu, cls, err) in enumerate(
                ((qs[0], PendingRequest, Overloaded),
                 (qs[1], jgw.PendingRequest, jgw.Overloaded))):
            r = cls(np.zeros(4, np.float32), int(sigs[i]),
                    deadline=now - 1.0 if past[i] else None)
            idx[id(r)] = i
            try:
                qu.put(r)
            except err:
                shed[side].append(i)
    assert shed[0] == shed[1]
    expired = [[idx[id(r)] for r in qu.take_expired(time.perf_counter())]
               for qu in qs]
    assert expired[0] == expired[1]
    while qs[0].depth or qs[1].depth:
        takes = [[idx[id(r)] for r in qu.take_batch(7)] for qu in qs]
        assert takes[0] == takes[1]
        assert takes[0]


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def test_latency_histogram_percentiles_never_understate():
    h = LatencyHistogram()
    vals = [1e-4, 5e-4, 1e-3, 5e-3, 1e-2]
    for v in vals:
        h.record(v)
    assert h.percentile(50) >= 5e-4
    assert h.percentile(99) >= h.percentile(50) >= h.percentile(10)
    snap = h.snapshot()
    assert snap["count"] == 5 and snap["max_ms"] == pytest.approx(10.0)
    assert set(snap) == {"count", "sum_ms", "mean_ms", "p50_ms", "p95_ms",
                         "p99_ms", "max_ms"}
    assert snap["sum_ms"] == pytest.approx(sum(vals) * 1e3)
    assert snap["mean_ms"] == pytest.approx(snap["sum_ms"] / snap["count"])
    empty = LatencyHistogram().snapshot()
    assert empty["count"] == 0 and empty["mean_ms"] == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_histogram_matches_reference(seed):
    rng = np.random.default_rng(seed)
    vals = np.exp(rng.uniform(np.log(1e-6), np.log(200.0), 500)).tolist()
    a, b = LatencyHistogram(), jgw.LatencyHistogram()
    for v in vals:
        a.record(v)
        b.record(v)
    assert a.counts == b.counts
    for pct in (0, 1, 10, 50, 90, 95, 99, 99.9, 100):
        assert a.percentile(pct) == b.percentile(pct)
    assert a.snapshot() == b.snapshot()


def test_telemetry_add_rejects_negative_deltas():
    tm = Telemetry()
    tm.add("approx_dco", 16.0)
    with pytest.raises(ValueError, match="monotone"):
        tm.add("approx_dco", -1.0)
    assert tm.snapshot()["counters"] == {}
    tm.add_signed("top1_dist", -3.5)
    tm.add_signed("top1_dist", 1.0)
    tm.inc("responses")
    assert tm.snapshot()["mean_top1_dist"] == pytest.approx(-2.5)


def test_periodic_sink_and_monotone_counters(tindex, unit_data):
    _, q, _ = unit_data
    q = host(q)
    sink = MemorySink()
    with Gateway(tindex, k=10, nprobe=8, sinks=(sink,),
                 config=GatewayConfig(max_batch=4, max_delay_ms=1.0,
                                      telemetry_interval_s=0.02)) as gw:
        for i in range(12):
            gw.search(q[i], timeout=WAIT)
        time.sleep(0.08)
        stats = gw.stats()
    assert stats["telemetry"]["counters"]["responses"] == 12
    assert stats["session"]["compiles"] >= 1
    kinds = [r["kind"] for r in sink.records]
    assert kinds[-1] == "gateway_final"
    assert "gateway_stats" in kinds
    for name in ("requests", "responses", "batches"):
        seq = [r["counters"].get(name, 0) for r in sink.records]
        assert seq == sorted(seq)
    assert all(r["counters"].get("errors", 0) == 0 for r in sink.records)


def test_warmup_ladder_precompiles_every_bucket(tindex, unit_data):
    _, q, _ = unit_data
    q = host(q)
    with Gateway(tindex, k=10, nprobe=5,
                 config=GatewayConfig(max_batch=4, max_delay_ms=1.0)) as gw:
        compiles_after_warmup = gw.stats()["session"]["compiles"]
        assert compiles_after_warmup >= 3     # buckets 1, 2, 4
        assert gw.stats()["session"]["buckets"] == [1, 2, 4]
        for i in range(6):
            gw.search(q[i], timeout=WAIT)
        assert gw.stats()["session"]["compiles"] == compiles_after_warmup


def test_telemetry_observe_atomic_under_threads():
    tm = Telemetry()
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            tm.observe(counters={"responses": 2, "batches": 1},
                       sums={"result_slots": 20.0, "result_filled": 18.0},
                       latencies=[(tm.latency, 1e-3), (tm.latency, 2e-3)])

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        bad = []
        for _ in range(300):
            snap = tm.snapshot()
            c, s = snap["counters"], snap["latency"]
            if c.get("responses", 0) != s["count"]:
                bad.append((c.get("responses", 0), s["count"]))
            if c.get("responses", 0) != 2 * c.get("batches", 0):
                bad.append(("responses/batches", c))
            slots = snap["counters"].get("responses", 0) * 10.0
            if abs(slots * 0.9 - (snap["result_fill_rate"] * slots)) > 1e-6:
                bad.append(("fill_rate", snap["result_fill_rate"]))
        assert not bad, bad[:5]
    finally:
        stop.set()
        for t in threads:
            t.join(10.0)
    before = tm.snapshot()
    with pytest.raises(ValueError):
        tm.observe(counters={"responses": 1}, sums={"approx_dco": -1.0})
    assert tm.snapshot()["counters"] == before["counters"]


# ---------------------------------------------------------------------------
# parity with the reference gateway
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("admission", ["signature", "fifo"])
def test_deterministic_flush_matches_reference(rairs_index, tindex,
                                               unit_data, admission):
    """Every query submitted before the flush, ``max_batch`` = the count:
    one batch in the same order in both packages, the same answers."""
    _, q, _ = unit_data
    q = host(q)
    n = 24
    kw = dict(max_batch=n, max_delay_ms=60_000.0, admission=admission,
              warmup=False)
    out = []
    for gw_cls, cfg_cls, idx, params in (
            (Gateway, GatewayConfig, tindex, SearchParams(k=10, nprobe=8)),
            (jgw.Gateway, jgw.GatewayConfig, rairs_index,
             JParams(k=10, nprobe=8))):
        with gw_cls(idx, params, config=cfg_cls(**kw)) as gw:
            pending = [gw.submit(q[i]) for i in range(n)]
            out.append([p.result(WAIT) for p in pending])
    for got, want in zip(*out):
        assert got.batch == want.batch == n
        assert (got.epoch, got.level) == (want.epoch, want.level)
        np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
        assert got.ids.dtype == np.asarray(want.ids).dtype
        np.testing.assert_allclose(got.dists, np.asarray(want.dists), **TOL)


@pytest.mark.parametrize("levels,factor,max_scan",
                         [(2, 0.5, None), (3, 0.5, 40), (2, 0.25, 9),
                          (4, 0.9, None)])
def test_degrade_ladder_matches_reference(levels, factor, max_scan):
    got = degrade_ladder(SearchParams(k=10, nprobe=8, max_scan=max_scan),
                         levels, factor)
    want = jgw.degrade_ladder(JParams(k=10, nprobe=8, max_scan=max_scan),
                              levels, factor)
    assert ([dataclasses.asdict(p) for p in got]
            == [dataclasses.asdict(p) for p in want])


def test_signatures_match_reference(rairs_index, tindex, unit_data):
    """Admission lanes: 1,000 queries get the same rank-0 list in both
    packages."""
    x, _, _ = unit_data
    rng = np.random.default_rng(5)
    xs = host(x)[rng.choice(x.shape[0], 1000, replace=False)]
    qs = (xs + rng.normal(0.0, 0.05, xs.shape)).astype(np.float32)
    cfg = dict(max_batch=4, warmup=False)
    with Gateway(tindex, k=10, nprobe=8,
                 config=GatewayConfig(**cfg)) as gw, \
            jgw.Gateway(rairs_index, k=10, nprobe=8,
                        config=jgw.GatewayConfig(**cfg)) as jg:
        got = [gw._signature(v) for v in qs]
        want = [jg._signature(v) for v in qs]
    assert got == want
    assert len(set(got)) > 20


def test_handover_under_live_traffic_matches_reference(stream_base,
                                                       unit_data):
    """The same mutations through both packages' gateways, the fold and
    install under live client traffic: afterwards the same handles
    resolve to the same ids, and a deterministic flush answers alike."""
    x, q, _ = unit_data
    x, q = host(x), host(q)
    cfg = dict(max_batch=8, max_delay_ms=1.0, warmup=False)
    finals = []
    for gw_cls, cfg_cls, stream, errs in (
            (Gateway, GatewayConfig,
             StreamingIndex(carry(stream_base), StreamConfig(delta_pad=512)),
             RairsError),
            (jgw.Gateway, jgw.GatewayConfig,
             JStream(stream_base, JStreamConfig(delta_pad=512)),
             jgw.RairsError)):
        with gw_cls(stream, k=10, nprobe=16, config=cfg_cls(**cfg)) as gw:
            ext = gw.insert(x[4000:4128])
            assert gw.delete(ext[:16]) == 16
            failures = []

            def client(seed):
                rng = np.random.default_rng(seed)
                for _ in range(10):
                    try:
                        gw.search(q[int(rng.integers(len(q)))], timeout=WAIT)
                    except errs as e:       # recorded, asserted below
                        failures.append(e)

            threads = [threading.Thread(target=client, args=(s,))
                       for s in range(2)]
            for t in threads:
                t.start()
            info = gw.compact_async("parity").wait(120.0)
            for t in threads:
                t.join(WAIT)
            assert not failures and not any(t.is_alive() for t in threads)
            pending = [gw.submit(q[i]) for i in range(8)]
            answers = [p.result(WAIT) for p in pending]
            finals.append((info, gw.resolve_ids(ext),
                           gw.resolve_ids(np.arange(4128)), answers,
                           gw.stats()["stream"]))
    (ti, tres, tall, tans, tst), (ji, jres, jall, jans, jst) = finals
    for key in ("epoch", "n_live", "dropped"):
        assert ti[key] == ji[key], key
    np.testing.assert_array_equal(ti["id_remap"], ji["id_remap"])
    np.testing.assert_array_equal(tres, jres)
    np.testing.assert_array_equal(tall, jall)
    assert tst == jst
    for a, b in zip(tans, jans):
        np.testing.assert_array_equal(a.ids, np.asarray(b.ids))
        np.testing.assert_allclose(a.dists, np.asarray(b.dists), **TOL)
        assert a.epoch == b.epoch == 1


# ---------------------------------------------------------------------------
# streaming: stable external ids + zero-downtime handover
# ---------------------------------------------------------------------------

def test_mutations_roundtrip_external_ids(stream_index, unit_data):
    x, q, _ = unit_data
    new = host(x[4000:4032])
    with Gateway(stream_index, k=10, nprobe=16,
                 config=GatewayConfig(max_batch=4, max_delay_ms=1.0)) as gw:
        ext = gw.insert(new)
        assert ext.shape == (32,)
        r = gw.search(new[0], timeout=WAIT)
        assert int(r.ids[0]) == int(ext[0])
        assert gw.delete(ext[:8]) == 8
        h = gw.compact_async("test")
        info = h.wait(120.0)
        assert h.state == "installed" and info["n_live"] > 0
        resolved = gw.resolve_ids(ext)
        assert (resolved[:8] == -1).all() and (resolved[8:] >= 0).all()
        r2 = gw.search(new[9], timeout=WAIT)
        assert int(r2.ids[0]) == int(ext[9])
        st = gw.stats()
        assert st["stream"]["epoch"] == 1
        assert st["telemetry"]["counters"]["handovers"] == 1
        assert st["handover"]["state"] == "idle"
        assert st["handover"]["last"]["reason"] == "test"


def test_handover_under_live_traffic(stream_index, unit_data):
    x, q, _ = unit_data
    x, q = host(x), host(q)
    cfg = GatewayConfig(max_batch=8, max_delay_ms=1.0)
    with Gateway(stream_index, k=10, nprobe=16, config=cfg) as gw:
        gw.insert(x[4000:4128])
        failures, results = [], []
        res_lock = threading.Lock()

        def client(seed):
            rng = np.random.default_rng(seed)
            for _ in range(25):
                try:
                    r = gw.search(q[int(rng.integers(len(q)))], timeout=WAIT)
                    with res_lock:
                        results.append(r)
                except Exception as e:        # noqa: BLE001 — recorded
                    failures.append(e)

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(3)]
        for t in threads:
            t.start()
        h = gw.compact_async("churn")
        h.wait(120.0)
        for t in threads:
            t.join(WAIT)

        assert not failures and not any(t.is_alive() for t in threads)
        st = gw.stats()
        assert st["telemetry"]["counters"].get("errors", 0) == 0
        assert st["telemetry"]["counters"].get("stale_retries", 0) == 0
        assert st["stream"]["epoch"] == 1
        epochs = {r.epoch for r in results}
        assert 0 in epochs
        all_ids = np.unique(np.concatenate([r.ids for r in results]))
        all_ids = all_ids[all_ids >= 0]
        assert (gw.resolve_ids(all_ids) >= 0).all()


def test_handover_with_mutating_on_request_hook(stream_index, unit_data):
    """``run_open_loop``'s ``on_request`` hook inserts and deletes while
    ``compact_async`` folds and installs (the shape of the card's stream
    check): no client error, no deleted id served, every served id
    resolves after install."""
    x, q, _ = unit_data
    x, q = host(x), host(q)
    with Gateway(stream_index, k=10, nprobe=16,
                 config=GatewayConfig(max_batch=8, max_delay_ms=1.0)) as gw:
        ext = gw.insert(x[4000:4064])
        deleted = []
        state = {}

        def hook(i):
            if i == 10:
                state["h"] = gw.compact_async("hook")
            if i % 8 == 3:
                new = gw.insert(x[4064 + i:4064 + i + 2] + 0.001)
                gw.delete(new[:1])
                deleted.append(int(new[0]))

        out = run_open_loop(gw, q[:48], offered_qps=1000.0, n_requests=96,
                            timeout_s=WAIT, on_request=hook, collect=True)
        state["h"].wait(120.0)
        gw.delete(ext[:4])
        deleted += ext[:4].tolist()
        after = run_open_loop(gw, q[:48], offered_qps=1000.0, n_requests=32,
                              timeout_s=WAIT, collect=True)
        assert out["errors"] == 0 and out["n_ok"] == 96
        assert after["errors"] == 0 and after["n_ok"] == 32
        assert gw.stats()["stream"]["epoch"] == 1
        served = np.unique(np.concatenate([out["ok_ids"].ravel(),
                                           after["ok_ids"].ravel()]))
        served = served[served >= 0]
        assert not set(after["ok_ids"].ravel().tolist()) & set(deleted)
        live = gw.resolve_ids(served)
        assert (live[~np.isin(served, deleted)] >= 0).all()


# ---------------------------------------------------------------------------
# fault sites: gateway.dispatch, gateway.fold (tests/test_faults.py)
# ---------------------------------------------------------------------------

def test_dispatch_fault_fails_typed_and_recovers(tindex, unit_data):
    _, q, _ = unit_data
    q = host(q)
    plan = FaultPlan(CHAOS_SEED, (
        FaultSpec("gateway.dispatch", kind="raise", at=(0,)),))
    with plan.installed():
        with Gateway(tindex, k=10, nprobe=8,
                     config=GatewayConfig(max_batch=4, max_delay_ms=1.0,
                                          warmup=False)) as gw:
            with pytest.raises(FaultInjected):
                gw.submit(q[0]).result(WAIT)
            assert gw.search(q[1], timeout=WAIT).ids.shape == (10,)
            snap = gw.telemetry.snapshot()
            assert snap["counters"]["errors"] >= 1
            assert snap["counters"]["responses"] >= 1
    assert plan.visits("gateway.dispatch") >= 2


def test_expired_request_fails_at_dequeue_and_close_drains(tindex,
                                                           unit_data):
    _, q, _ = unit_data
    q = host(q)
    with Gateway(tindex, k=10, nprobe=8,
                 config=GatewayConfig(max_batch=4, warmup=False)) as gw:
        before = gw.telemetry.counter("responses")
        with pytest.raises(DeadlineExceeded):
            gw.submit(q[0], deadline_s=-0.001).result(WAIT)
        assert gw.telemetry.counter("deadline_failures") == 1
        assert gw.telemetry.counter("responses") == before
        assert gw.submit(q[1], deadline_s=30.0).result(WAIT).ids.shape \
            == (10,)
    gw = Gateway(tindex, k=10, nprobe=8,
                 config=GatewayConfig(max_batch=8, warmup=False))
    pending = [gw.submit(q[i % len(q)]) for i in range(24)]
    gw.close()
    assert all(p.result(WAIT).ids.shape == (10,) for p in pending)


def test_degradation_ladder_steps_down_and_recovers(tindex, unit_data):
    _, q, _ = unit_data
    q = host(q)
    params = SearchParams(k=10, nprobe=8)
    ladder = degrade_ladder(params, levels=2)
    assert [p.nprobe for p in ladder] == [8, 4, 2]
    plan = FaultPlan(CHAOS_SEED, (
        FaultSpec("gateway.dispatch", kind="delay", prob=1.0,
                  delay_s=0.01, max_hits=30),))
    with plan.installed():
        with Gateway(tindex, params,
                     config=GatewayConfig(
                         max_batch=4, max_delay_ms=0.5, max_queue=8,
                         overload="block", degrade=ladder[1:],
                         degrade_hold=1, warmup=False)) as gw:
            pending = [gw.submit(q[i % len(q)]) for i in range(64)]
            results = [p.result(WAIT) for p in pending]
            assert {r.level for r in results} - {0}
            assert gw.telemetry.snapshot()["counters"][
                "degrade_steps_down"] >= 1
            deadline = time.time() + 30.0
            while time.time() < deadline:
                if gw.search(q[0], timeout=WAIT).level == 0:
                    break
                time.sleep(0.01)
            assert gw.stats()["quality"]["level"] == 0
            assert gw.telemetry.counter("degrade_steps_up") >= 1


def test_overload_rejects_typed_and_accounts(tindex, unit_data):
    _, q, _ = unit_data
    q = host(q)
    plan = FaultPlan(CHAOS_SEED, (
        FaultSpec("gateway.dispatch", kind="delay", prob=1.0,
                  delay_s=0.02),))
    n = 60
    with plan.installed():
        with Gateway(tindex, k=10, nprobe=8,
                     config=GatewayConfig(max_batch=4, max_delay_ms=1.0,
                                          max_queue=8, overload="reject",
                                          warmup=False)) as gw:
            out = run_open_loop(gw, q[:32], offered_qps=5000.0,
                                n_requests=n, timeout_s=WAIT, tick_ms=0.0)
            c = gw.telemetry.snapshot()["counters"]
    assert out["errors"] == 0
    assert out["n_ok"] + out["shed"] + out["deadline_failed"] == n
    assert out["shed"] > 0 and out["n_ok"] > 0
    assert c["shed"] == out["shed"] and c["responses"] == out["n_ok"]


def test_fold_crash_retries_then_succeeds(stream_index, unit_data):
    x, q, _ = unit_data
    plan = FaultPlan(CHAOS_SEED, (
        FaultSpec("gateway.fold", kind="raise", at=(0,)),))
    with plan.installed():
        with Gateway(stream_index, k=10, nprobe=8,
                     config=GatewayConfig(max_batch=8, warmup=False,
                                          handover_retries=2,
                                          handover_backoff_s=0.01)) as gw:
            gw.insert(host(x[2000:2032]))
            epoch0 = stream_index.epoch
            h = gw.compact_async("chaos")
            info = h.wait(WAIT)
            assert h.state == "installed" and info["epoch"] == epoch0 + 1
            assert gw.telemetry.counter("handover_retries") == 1
            assert gw.search(host(q[0]), timeout=WAIT).epoch == epoch0 + 1
    assert plan.fired() == 1


def test_fold_crash_exhausts_retries_rolls_back(stream_index, unit_data):
    x, q, _ = unit_data
    x, q = host(x), host(q)
    plan = FaultPlan(CHAOS_SEED, (
        FaultSpec("gateway.fold", kind="raise", prob=1.0),))
    with Gateway(stream_index, k=10, nprobe=8,
                 config=GatewayConfig(max_batch=8, warmup=False,
                                      handover_retries=1,
                                      handover_backoff_s=0.01)) as gw:
        ext = gw.insert(x[2000:2064])
        gw.delete(ext[:8])
        epoch0, version0 = stream_index.epoch, stream_index.version
        resolved0 = gw.resolve_ids(ext)
        with plan.installed():
            h = gw.compact_async("chaos")
            with pytest.raises(HandoverFailed) as ei:
                h.wait(WAIT)
            assert isinstance(ei.value.__cause__, FaultInjected)
        assert stream_index.epoch == epoch0
        assert gw.telemetry.counter("handover_failures") == 1
        r = gw.search(q[0], timeout=WAIT)
        assert r.epoch == epoch0 and r.ids.shape == (10,)
        np.testing.assert_array_equal(gw.resolve_ids(ext), resolved0)
        assert stream_index.version == version0
        assert gw.compact_async("retry").wait(WAIT)["epoch"] == epoch0 + 1
        resolved1 = gw.resolve_ids(ext)
        assert (resolved1[:8] == -1).all() and (resolved1[8:] >= 0).all()
