"""stage_ms.merge_d2h: mean ms of the span ``merge.d2h`` (the plan-cache
merge's synchronising copies of the probe's unions, selection and
permutation to the host), in the stretch with the tracer on."""
from spans import mean_ms

NEEDS = ("spans",)


def read(run):
    return mean_ms(run, "merge.d2h")
