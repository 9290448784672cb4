"""graph.device_ms_per_batch: device ms of a batch's CUDA graph replays on
the dispatch the benchmark times (tracer off, graphs replaying), from CUDA
timing events around each replay: the owner's ``searcher_stats()``,
``timed_device_s`` x 1e3 / ``timed_calls``.  The program times replays
into these counters only with no tracer active, so the reading covers
the profiled stretch alone.  That stretch runs under the benchmark's
profiler, which traces the card (CUPTI) and delays each launch inside a
replay: the reading is the replay's device time plus that delay, above
what the same replay takes with no card profiler (PERF.md section 3).
batch1024 is not read: its traced run has no profiled stretch, and
``chip_smoke.py``'s replay-timing phase reads its replay instead."""
NEEDS = ("profile",)


def collect(run):
    """Read the counters while the program is alive."""
    prog = run.prog
    owner = prog.stream if prog.stream is not None else prog.index
    st = owner.searcher_stats()
    calls, sec = 0, 0.0
    for s in (st, st.get("base") or {}):     # a pristine stream's base
        calls += s.get("timed_calls", 0)
        sec += s.get("timed_device_s", 0.0)
    run.graph_timed = (calls, sec)


def read(run):
    calls, sec = getattr(run, "graph_timed", (0, 0.0))
    if run.dev.type != "cuda" or not calls:
        return None
    return sec * 1e3 / calls
