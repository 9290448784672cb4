"""stream.insert.assign_ms_per_1k: ms of the span ``stream.insert.assign``
(the batch to the card, the assignment strategy, its lists back to the
host) per 1,000 rows inserted, in the stretch with the tracer on."""
from spans import ms_per_1k

NEEDS = ("spans",)


def read(run):
    return ms_per_1k(run, "stream.insert.assign", "stream.insert")
