"""recall_at_10: mean over the window's answered queries of |returned ∩
exact top-10| / 10, the exact top-10 being the plain reference's over the
vectors live when the query was answered (``judge.py``)."""


def read(run):
    return run.verdict.recall
