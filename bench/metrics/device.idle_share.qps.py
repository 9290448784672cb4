"""device.idle_share.qps: 1 - busy / stretch, the share of a profiled
stretch (tracer off, graphs replaying as untraced) in which no kernel,
copy or memset ran on the card, from ``torch.profiler``'s trace."""
NEEDS = ("profile",)


def read(run):
    r = run.prof_readings
    if run.dev.type != "cuda" or r is None or r["stretch"] != "tracer off":
        return None
    return 1.0 - r["busy_s"] / r["window_s"]
