"""stream.insert_ms_per_1k: ms of the span ``stream.insert`` (the whole
of ``StreamingIndex.insert``, device phases fenced) per 1,000 of the rows
it inserted (its counter ``rows``), in the stretch with the tracer on."""
from spans import ms_per_1k

NEEDS = ("spans",)


def read(run):
    return ms_per_1k(run, "stream.insert", "stream.insert")
