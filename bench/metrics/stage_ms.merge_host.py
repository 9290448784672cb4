"""stage_ms.merge_host: mean ms of the span ``stage.merge_unions_host``
(the plan-cache merge on the host), in the stretch with the tracer on."""
NEEDS = ("spans",)


def read(run):
    if run.tracer is None:
        return None
    s = run.tracer.stage_summary().get("stage.merge_unions_host")
    return s["mean_ms"] if s else None
