"""search_qps: queries answered in the window over the window's seconds.
Closed loop: the window runs from its start until the last batch's ids
and distances are on the host."""


def read(run):
    if run.rec is None or not len(run.rec):
        return None
    return sum(len(k) for k in run.rec.keys) / run.window_s
