"""stage_ms.delta_scan: mean ms per batch of the span ``stage.delta_scan``
(a stream's delta segment scanned beside the base), in the stretch with
the tracer on."""
NEEDS = ("spans",)


def read(run):
    if run.tracer is None:
        return None
    s = run.tracer.stage_summary().get("stage.delta_scan")
    return s["mean_ms"] if s else None
