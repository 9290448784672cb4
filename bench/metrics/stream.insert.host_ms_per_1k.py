"""stream.insert.host_ms_per_1k: ms of the span ``stream.insert.host``
(the delta segment's host append and the id maps' concatenation) per
1,000 rows inserted, in the stretch with the tracer on."""
from spans import ms_per_1k

NEEDS = ("spans",)


def read(run):
    return ms_per_1k(run, "stream.insert.host", "stream.insert")
