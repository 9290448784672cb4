"""scan_roofline: the scan stage's share of its roofline, in %: the least
time the card could take for the batch's scan (``roofline.py``: bytes of
the probed lists' blocks, the tables and the candidate output at
3.35 TB/s, or DCO x M f32 adds at 67 TFLOP/s, the larger) over the device
time of the operations that ran inside the stage's span, summed over the
batches of the stretch profiled with the tracer on."""
import numpy as np
import torch

import devtrace
import roofline

NEEDS = ("profile_spans", "dco")
SPANS = ("stage.scan_blocks_topk", "stage.scan_blocks")


def collect(run):
    """Count the least time of each profiled batch while the index is
    alive (its lists and centroids)."""
    ps = run.prof_spans
    if ps is None:
        return
    index, p = run.prog.index, run.prog.params
    a, cb = index.arrays, index.codebook
    least = []
    for b in ps.batches:
        q = torch.from_numpy(np.ascontiguousarray(
            run.inp.queries.exact(run.rec.keys[b]))).to(index.device)
        probed = roofline.probed_lists(index.centroids, q, p.nprobe)
        n_bytes = roofline.scan_bytes(
            (a.owned, a.refs, a.misc), probed, block=a.block_size,
            m=cb.m, nbits=index.config.nbits, ksub=cb.ksub, fetch=p.bigk)
        adds = float(run.rec.dco[b].sum()) * cb.m
        least.append(roofline.least_seconds(n_bytes, adds))
    ps.least = least
    ps.measured = devtrace.kernels_in(
        ps.stretch, devtrace.span_intervals(ps.tracer, SPANS))


def read(run):
    ps = run.prof_spans
    if run.dev.type != "cuda" or ps is None or not getattr(
            ps, "measured", None):
        return None
    if len(ps.measured) != len(ps.least) or not sum(ps.measured):
        return None
    return 100.0 * sum(ps.least) / sum(ps.measured)
