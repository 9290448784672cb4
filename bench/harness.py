"""One run of one cell: set-up, the measured window, the judgement.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, its configuration file, its traffic file
``bench/traffic/<traffic>.json``, its limits ``bench/limits/<cell>.json``
(those of ``correct`` that depend on the traffic, over the configuration's
own) and one reader per metric, ``bench/metrics/<metric>.py``.  The traffic file is read by one general
generator here:

* ``loop``: ``closed`` (one client; its next batch leaves once the last
  batch's ids and distances are on the host);
* ``queries``: ``cycle`` (the pool in order from an offset the seed
  draws, cycled) or ``zipf`` (a sequence of ``length`` queries fixed by
  ``rank_seed``: Zipf(``a``) popularity over a permutation of the pool,
  plus Gaussian ``jitter`` times the pool's std; the seed draws the batch
  it starts from, cycled).  Every seed sends the same queries, so the
  seed changes the order of the work and not its kind;
* ``search``: the serving fields of the program's ``SearchParams``;
* ``writes`` (a stream): inserts and deletes made in set-up, and the
  rates at which the window's writes fall due;
* ``warm_s``: seconds of the same traffic before the window, in set-up.

A ``--trace 1`` run splits the window into stretches as its per-layer
readers ask (``NEEDS`` in each reader): ``profile`` (the profiler on, the
tracer off: graphs replay as in the untimed path), ``profile_spans`` (the
profiler and the tracer, a few batches) and ``spans`` (the tracer alone).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, List, Optional

import numpy as np
import torch

import datagen
import devtrace
import reference

BENCH = Path(__file__).resolve().parent
PROFILE_S = 2.0          # longest profiled stretch (tracer off)
SPAN_BATCHES = 16        # batches profiled with the tracer on


# ---------------------------------------------------------------------------
# finding a cell
# ---------------------------------------------------------------------------
def load_cell(root: Path, name: str) -> SimpleNamespace:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its
    configuration, traffic and the metrics it reports."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = dict(config["limits"], **json.loads(
        (root / "bench" / "limits" / f"{name}.json").read_text())["limits"])
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if name in m.get("workloads", [name])
             and ("workloads" in m or m["moves"] in e2e_names)]
    return SimpleNamespace(name=name, cell=cell, config=config,
                           traffic=traffic, limits=limits, end_to_end=e2e,
                           per_layer=layer, root=root)


def reader(name: str):
    """The module ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the traffic's queries
# ---------------------------------------------------------------------------
class Queries:
    """The stream of queries a cell sends: ``batch(j)`` is batch ``j`` as
    a host array and the keys that name its rows; ``exact(keys)`` the
    same rows rebuilt for the reference."""

    def __init__(self, spec: dict, pool: np.ndarray, batch: int, seed: int):
        self.kind, self.b, self.pool = spec["kind"], batch, pool
        rng = np.random.default_rng([seed, 17])
        p = pool.shape[0]
        if self.kind == "cycle":
            self.seq = np.concatenate([pool, pool[:batch]])
            self.offset = int(rng.integers(p))
        elif self.kind == "zipf":
            length = int(spec["length"])
            if length % batch:
                raise ValueError("zipf length must be a multiple of batch")
            w = 1.0 / np.arange(1, p + 1) ** float(spec["a"])
            fixed = np.random.default_rng(int(spec["rank_seed"]))
            rank = fixed.permutation(p)
            picks = rank[fixed.choice(p, length, p=w / w.sum())]
            scale = float(pool.std()) * float(spec["jitter"])
            self.seq = (pool[picks] + fixed.normal(
                0.0, scale, (length, pool.shape[1]))).astype(np.float32)
            self.offset = batch * int(rng.integers(length // batch))
        else:
            raise ValueError(f"unknown query kind {self.kind!r}")

    def batch(self, j: int):
        b = self.b
        if self.kind == "cycle":
            s = (self.offset + j * b) % self.pool.shape[0]
            return self.seq[s:s + b], (s + np.arange(b)) % self.pool.shape[0]
        s = (self.offset + j * b) % self.seq.shape[0]
        return self.seq[s:s + b], s + np.arange(b)

    def exact(self, keys: np.ndarray) -> np.ndarray:
        return (self.seq if self.kind == "zipf" else self.pool)[keys]


# ---------------------------------------------------------------------------
# a stream's writes
# ---------------------------------------------------------------------------
class Writes:
    """The write log of a stream cell, drawn in set-up from the seed, and
    its application: set-up writes, then before each batch every window
    write that is due.  ``log`` replays it for the reference."""

    def __init__(self, spec: dict, n_base: int, seconds: float, seed: int):
        self.spec = spec
        self.n_base = n_base
        self.setup_ins = int(spec["setup_inserts"])
        self.setup_del = int(spec["setup_deletes"])
        self.ins_rate = float(spec["insert_per_s"])
        self.del_rate = float(spec["delete_per_s"])
        self.win_ins = int(math.floor(self.ins_rate * seconds)) + 1
        self.win_del = int(math.floor(self.del_rate * seconds)) + 1
        rng = np.random.default_rng([seed, 29])
        self.deletes = reference.draw_deletes(
            rng, n_base, self.setup_ins, self.setup_del,
            np.arange(self.win_ins) / self.ins_rate,
            np.arange(self.win_del) / self.del_rate)
        self.n_inserts = self.setup_ins + self.win_ins
        self.ni = self.nd = 0            # window writes applied
        self.seconds = 0.0               # time spent writing in the window
        self.written = 0                 # vectors written in the window
        self.ack_mismatch = 0

    def _insert(self, stream, vecs: np.ndarray, first: int) -> None:
        ids = stream.insert(vecs)
        want = self.n_base + first + np.arange(vecs.shape[0])
        self.ack_mismatch += int((np.asarray(ids) != want).sum())

    def setup(self, stream, vecs: np.ndarray) -> None:
        step = int(self.spec["insert_chunk"])
        for s in range(0, self.setup_ins, step):
            self._insert(stream, vecs[s:min(s + step, self.setup_ins)], s)
        stream.delete(self.deletes[:self.setup_del])

    def apply_due(self, stream, vecs: np.ndarray, elapsed: float) -> None:
        ni = min(self.win_ins, int(math.floor(elapsed * self.ins_rate)) + 1)
        nd = min(self.win_del, int(math.floor(elapsed * self.del_rate)) + 1)
        if ni == self.ni and nd == self.nd:
            return
        t0 = time.perf_counter()
        if ni > self.ni:
            a, b = self.setup_ins + self.ni, self.setup_ins + ni
            self._insert(stream, vecs[a:b], a)
        if nd > self.nd:
            stream.delete(self.deletes[self.setup_del + self.nd:
                                       self.setup_del + nd])
        _sync(stream.device)
        self.seconds += time.perf_counter() - t0
        self.written += (ni - self.ni) + (nd - self.nd)
        self.ni, self.nd = ni, nd

    @property
    def applied(self):
        """(inserts, deletes) applied so far, set-up included."""
        return self.setup_ins + self.ni, self.setup_del + self.nd

    def log(self) -> reference.WriteLog:
        return reference.WriteLog(self.n_base, self.n_inserts, self.deletes)


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------
def set_precision() -> None:
    """float32 matmuls in float32 (TF32 off), as the configuration states."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def make_inputs(spec, seed: int, seconds: float, dev) -> SimpleNamespace:
    """Everything the traffic sends, made from the seed on ``dev``, and
    the checksums the reference holds its rebuilt copies to."""
    data, tr = spec.config["data"], spec.traffic
    mix, x = datagen.corpus(data, dev)
    pool = datagen.queries(data, x)
    inp = SimpleNamespace(x=x, mix=mix, x_sum=datagen.checksum(x),
                          pool_sum=datagen.checksum(pool),
                          pool=pool.cpu().numpy(), writes=None, ins=None)
    inp.queries = Queries(tr["queries"], inp.pool, int(tr.get("batch", 1)),
                          seed)
    if "writes" in tr:
        inp.writes = Writes(tr["writes"], x.shape[0], seconds, seed)
        ins = datagen.inserts(data, mix, seed, inp.writes.n_inserts)
        inp.ins_sum = datagen.checksum(ins)
        inp.ins = ins.cpu().numpy()
    return inp


def build(spec, inp, dev, cache: Optional[dict] = None):
    """The index over the corpus (reused from ``cache`` when given)."""
    from repro_torch.core import IndexConfig, build_index
    key = json.dumps(spec.config["index"], sort_keys=True)
    if cache is not None and key in cache:
        return cache[key], 0.0
    t0 = time.perf_counter()
    index = build_index(inp.x, IndexConfig(**spec.config["index"]),
                        device=dev)
    _sync(dev)
    sec = time.perf_counter() - t0
    if cache is not None:
        cache[key] = index
    return index, sec


def search_params(spec):
    from repro_torch.core import SearchParams
    kw = dict(spec.config["search"], **spec.traffic.get("search", {}))
    if kw.get("batch_buckets") is not None:
        kw["batch_buckets"] = tuple(kw["batch_buckets"])
    return SearchParams(**kw)


class Program:
    """The system under test as the window drives it: a session over the
    frozen index, or a session over a stream (renewed after each write)."""

    def __init__(self, spec, index, inp, dev):
        self.spec, self.index, self.inp, self.dev = spec, index, inp, dev
        self.params = search_params(spec)
        self.stream = None
        self.setup_writes_s = 0.0
        if inp.writes is not None:
            from repro_torch.core import StreamConfig
            self.stream = index.streaming(
                StreamConfig(**spec.config["stream"]))
            t0 = time.perf_counter()
            inp.writes.setup(self.stream, inp.ins)
            _sync(dev)
            self.setup_writes_s = time.perf_counter() - t0

    def warm(self) -> float:
        """Capture every executable the traffic uses; returns seconds."""
        t0 = time.perf_counter()
        self.session().warmup_widths(int(self.spec.traffic["batch"]))
        _sync(self.dev)
        return time.perf_counter() - t0

    def session(self):
        owner = self.stream if self.stream is not None else self.index
        return owner.searcher(self.params, device=self.dev)

    def compiles(self) -> int:
        """Executables captured so far (the program's own count)."""
        owner = self.stream if self.stream is not None else self.index
        return int(owner.searcher_stats()["compiles"])

    def delta_postings(self) -> Optional[tuple]:
        """A stream's fullest delta list and the posting width its device
        mirror is padded to (a width that grows recaptures the graphs)."""
        d = getattr(self.stream, "_delta", None)
        if d is None or not hasattr(d, "post_n"):
            return None     # no stream, or a program that keeps no such lists
        return int(d.post_n.max()) if d.nlist else 0, int(d.post_width)


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------
class Record:
    """What the window's batches were sent and answered."""

    def __init__(self):
        self.keys: List[np.ndarray] = []
        self.ids: List[np.ndarray] = []
        self.dists: List[np.ndarray] = []
        self.t1: List[float] = []
        self.applied: List[tuple] = []
        self.dco: List[np.ndarray] = []

    def __len__(self):
        return len(self.keys)


class Clock:
    """The window's clock for a stream's writes: it runs only inside
    ``with clock:`` blocks, so the work between traced stretches (the
    profiler's start and stop) brings no writes due."""

    def __init__(self):
        self.spent, self.t0 = 0.0, None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spent += time.perf_counter() - self.t0
        self.t0 = None
        return False

    def elapsed(self) -> float:
        return self.spent + (time.perf_counter() - self.t0)


def closed_loop(prog: Program, inp, rec: Optional[Record], j0: int,
                elapsed: Callable[[], float], t_end: float,
                dco: bool = False, max_batches: Optional[int] = None) -> int:
    """Send batches until ``t_end`` (or ``max_batches`` are sent); returns
    the next batch number.  Writes (a stream) fall due by ``elapsed()``,
    the window's clock; none are applied while ``rec`` is None."""
    w = inp.writes
    j = j0
    while time.perf_counter() < t_end and (
            max_batches is None or j - j0 < max_batches):
        if w is not None and rec is not None:
            w.apply_due(prog.stream, inp.ins, elapsed())
        sess = prog.session()
        q, keys = inp.queries.batch(j)
        j += 1
        with torch.profiler.record_function(devtrace.BATCH):
            r = sess(torch.from_numpy(q))
            ids = r.ids.cpu().numpy()
            dists = r.dists.cpu().numpy()
        t1 = time.perf_counter()
        if rec is None:
            continue
        rec.keys.append(keys)
        rec.ids.append(ids)
        rec.dists.append(dists)
        rec.t1.append(t1)
        rec.applied.append(w.applied if w is not None else (0, 0))
        if dco:
            rec.dco.append(r.approx_dco.cpu().numpy())
    return j


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------
def _needs(spec) -> set:
    out = set()
    for m in spec.per_layer:
        out |= set(getattr(reader(m["name"]), "NEEDS", ()))
    return out


def run_cell(spec, seed: int, seconds: float, trace: bool, dev,
             t_start: float, cache: Optional[dict] = None) -> SimpleNamespace:
    """Set up, run the window, read the program's counters, free the
    program and return the run's record.  ``cache`` keeps built indexes
    across runs of one process."""
    from repro_torch import obs
    set_precision()
    tr = spec.traffic
    if tr.get("loop", "closed") != "closed":
        raise ValueError(f"traffic {spec.cell['traffic']!r}: only a closed "
                         f"loop is driven, not {tr['loop']!r}")
    run = SimpleNamespace(spec=spec, seed=seed, seconds=seconds,
                          trace=trace, dev=torch.device(dev), parts={},
                          prof=None, prof_spans=None, tracer=None)
    t = time.perf_counter()
    run.parts["before_s"] = t - t_start
    inp = make_inputs(spec, seed, seconds, dev)
    _sync(dev)
    run.parts["data_s"] = time.perf_counter() - t
    index, run.build_s = build(spec, inp, dev, cache)
    run.parts["build_s"] = run.build_s
    prog = Program(spec, index, inp, dev)
    run.parts["setup_writes_s"] = prog.setup_writes_s
    run.capture_s = prog.warm()
    run.parts["capture_s"] = run.capture_s
    needs = _needs(spec) if trace else set()
    run.inp, run.prog = inp, prog
    cuda = run.dev.type == "cuda"

    # what set-up made lives on; no collection in the window walks it
    gc.collect()
    gc.freeze()
    t = time.perf_counter()
    j = closed_loop(prog, inp, None, 0, lambda: 0.0,
                    t + float(tr.get("warm_s", 0.0)))
    run.parts["warm_s"] = time.perf_counter() - t
    compiles0 = prog.compiles()
    postings0 = prog.delta_postings()
    rec = Record()
    t_win = time.perf_counter()
    run.setup_s = t_win - t_start
    plan0 = _plan_stats(prog)
    dco = "dco" in needs
    clock = Clock()
    # traced: a profiled stretch (tracer off), a few batches profiled
    # with the tracer on, then the tracer alone; each stretch keeps
    # its own length, and the writes' clock stops between stretches
    left = seconds
    if "profile" in needs:
        d = min(PROFILE_S, seconds / 3)
        with devtrace.Stretch() as st, clock:
            j = closed_loop(prog, inp, rec, j, clock.elapsed,
                            time.perf_counter() + d, dco)
        run.prof, left = st, seconds - d
    if "profile_spans" in needs:
        n0 = len(rec)
        with devtrace.Stretch() as st, clock:
            tracer = obs.start()
            try:
                j = closed_loop(prog, inp, rec, j, clock.elapsed,
                                float("inf"), dco,
                                max_batches=SPAN_BATCHES)
            finally:
                obs.stop()
        run.prof_spans = SimpleNamespace(stretch=st, tracer=tracer,
                                         batches=range(n0, len(rec)))
    with clock:
        if "spans" in needs:
            run.tracer = obs.start()
        try:
            j = closed_loop(prog, inp, rec, j, clock.elapsed,
                            time.perf_counter() + left, dco)
        finally:
            if run.tracer is not None:
                obs.stop()
    run.rec = rec
    run.window_s = (rec.t1[-1] - t_win) if len(rec) else seconds
    run.plan = (plan0, _plan_stats(prog))
    if postings0 is not None:
        postings1 = prog.delta_postings()
        run.parts["delta_fullest"] = [postings0[0], postings1[0]]
        run.parts["delta_width"] = [postings0[1], postings1[1]]
    run.parts["window_compiles"] = prog.compiles() - compiles0
    if inp.writes is not None:
        run.readback = readback(prog, inp, seed)
    run.memory_peak = (torch.cuda.max_memory_allocated(run.dev) if cuda
                       else 0)
    # the idle share is read where graphs replay (tracer off); where the
    # profiler could place nothing there, busy and window come from the
    # stretch profiled with the tracer on, and the result says so
    run.prof_readings = None
    for name, st in (("tracer off", run.prof), ("tracer on", getattr(
            run.prof_spans, "stretch", None))):
        r = devtrace.readings(st) if st is not None else None
        if r is not None:
            run.prof_readings = dict(r, stretch=name, cats=dict(st.cats))
            break
    for m in (spec.per_layer if trace else ()):
        mod = reader(m["name"])
        if hasattr(mod, "collect"):
            mod.collect(run)
    inp.x = run.prog = prog = index = None
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return run


def _plan_stats(prog) -> Optional[dict]:
    if not prog.params.plan_reuse:
        return None
    return dataclasses.asdict(prog.session().plan_stats)


def readback(prog: Program, inp, seed: int) -> SimpleNamespace:
    """After the window: each of a batch of acknowledged inserts, searched
    for with its own vector, must come back first; each of a batch of
    deleted vectors must not come back.  The most recent writes are in
    both batches, the rest drawn from the seed."""
    w, b = inp.writes, int(prog.spec.traffic["batch"])
    n_ins, n_del = w.applied
    live = w.log().live(n_ins, n_del)
    ins_live = np.nonzero(live[w.n_base:w.n_base + n_ins])[0]
    rng = np.random.default_rng([seed, 53])

    def pick(ids):
        half = min(b // 2, ids.size)
        rest = rng.choice(ids[:ids.size - half],
                          min(b - half, ids.size - half), replace=False)
        return np.concatenate([ids[ids.size - half:], rest])

    out = SimpleNamespace(ins_ids=w.n_base + pick(ins_live),
                          del_ids=pick(w.deletes[:n_del]))
    sess = prog.session()
    for name, ids in (("ins", out.ins_ids), ("del", out.del_ids)):
        q = np.empty((ids.size, inp.ins.shape[1]), np.float32)
        new = ids >= w.n_base
        q[new] = inp.ins[ids[new] - w.n_base]
        rows = torch.from_numpy(ids[~new].astype(np.int64)).to(inp.x.device)
        q[~new] = inp.x[rows].cpu().numpy()
        r = sess(torch.from_numpy(q))
        setattr(out, name, (r.ids.cpu().numpy(), r.dists.cpu().numpy()))
    return out
