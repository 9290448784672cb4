"""Readings of the program's spans in the stretch with the tracer on
(``run.tracer``): a span's mean ms, or its total ms per 1,000 of the rows
that a span counted (its counter ``rows``).  None where the program
records no such span."""


def _summary(run, name):
    if run.tracer is None:
        return None
    return run.tracer.stage_summary().get(name)


def mean_ms(run, name: str):
    s = _summary(run, name)
    return s["mean_ms"] if s else None


def ms_per_1k(run, name: str, rows_of: str):
    """Total ms of the spans ``name`` per 1,000 of the rows counted by
    the spans ``rows_of``."""
    s, r = _summary(run, name), _summary(run, rows_of)
    rows = r["counters"].get("rows", 0) if r else 0
    if not s or not rows:
        return None
    return s["total_s"] * 1e3 / (rows / 1e3)
