"""stage_ms.merge_union: mean ms of the span ``merge.union`` (the plan
cache's lookup, ``merge_unions_host``, the cache's update, the live
count and the width), in the stretch with the tracer on."""
from spans import mean_ms

NEEDS = ("spans",)


def read(run):
    return mean_ms(run, "merge.union")
