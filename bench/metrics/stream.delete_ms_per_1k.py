"""stream.delete_ms_per_1k: ms of the span ``stream.delete`` (the whole
of ``StreamingIndex.delete``, the mirror's patch fenced) per 1,000 of the
ids it was given (its counter ``rows``), in the stretch with the tracer
on."""
from spans import ms_per_1k

NEEDS = ("spans",)


def read(run):
    return ms_per_1k(run, "stream.delete", "stream.delete")
