"""plan.hit_share: of the tiles the plan-reuse session dispatched in the
window, the share whose union the plan cache already covered: hits over
hits + extends + misses, from the session's ``plan_stats``."""


def read(run):
    plan = getattr(run, "plan", None)
    if not plan or plan[0] is None:
        return None
    a, b = plan
    d = {k: b[k] - a[k] for k in ("hits", "extends", "misses")}
    n = sum(d.values())
    return d["hits"] / n if n else None
