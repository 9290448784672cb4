"""scan.dco_per_query: ADC distance computations per query, from the
counter each answer carries (``approx_dco``: the base scan's, and a
stream's delta scan's), summed over the traced window's queries."""
NEEDS = ("dco",)


def read(run):
    if run.rec is None or not run.rec.dco:
        return None
    n = sum(len(d) for d in run.rec.dco)
    return float(sum(int(d.sum()) for d in run.rec.dco)) / n
