"""stage_ms.scan: mean ms per batch of the scan stage's span
(``stage.scan_blocks_topk``, or ``stage.scan_blocks`` unfused), eager and
fenced, in the stretch with the tracer on."""
NEEDS = ("spans",)


def read(run):
    if run.tracer is None:
        return None
    summ = run.tracer.stage_summary()
    s = summ.get("stage.scan_blocks_topk") or summ.get("stage.scan_blocks")
    return s["mean_ms"] if s else None
