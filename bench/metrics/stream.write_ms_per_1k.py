"""stream.write_ms_per_1k: the benchmark's clock around the window's
``insert`` and ``delete`` calls, synchronised, in ms per 1,000 vectors
written (inserted or deleted)."""


def read(run):
    w = run.inp.writes
    if w is None or not w.written:
        return None
    return w.seconds * 1e3 / (w.written / 1e3)
