"""A session's executables on the card: the port's counterpart of the
reference's ahead-of-time executable per batch bucket.

An executable is one CUDA graph (``GraphExe``): the search function
captured once over static input buffers and replayed for every batch of
its key, so a batch costs one graph launch instead of some hundred
kernel launches from Python.  (On the CPU a session keeps the eager
function under the same key.)

Capture follows PyTorch's rules: the function runs once eagerly on a
side stream first (that builds the kernel libraries and sets each
kernel's shared-memory attribute, neither of which may happen during
capture), then the graph records it.  The search path makes no host
synchronization, so it captures whole.  A capture that fails raises;
nothing switches to eager execution on the card.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import obs
from ..kernels.pq_scan import add_launch_counts, launch_counts


def flat_tensors(x) -> list:
    """The tensors of ``x`` (nested tuples and NamedTuples), in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for y in x for t in flat_tensors(y)]
    raise TypeError(f"executables take tensors and tuples, got {type(x)}")


def clone_tensors(x):
    """A copy of ``x`` (nested tuples and NamedTuples of tensors) whose
    tensors are clones."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if hasattr(x, "_fields"):
        return type(x)(*(clone_tensors(y) for y in x))
    return tuple(clone_tensors(y) for y in x)


class GraphExe:
    """``fn(*inputs)`` captured into one CUDA graph over the static
    tensors ``inputs`` (nested tuples of tensors on the card).

    A call copies each argument tensor into its static buffer, unless it
    is that very buffer (a ``plan_reuse`` session's scan graph reads its
    probe graph's outputs in place), replays the graph and returns its
    static outputs, or clones of them with ``clone=True``.

    Graphs of one session share its memory ``pool``.  That is safe
    because a session replays one graph at a time, clones the outputs
    that leave it before the next replay, and replays a scan graph only
    right after its bucket's probe graph, whose outputs it reads.

    A call runs in three spans, ``graph.copy_in``, ``graph.replay`` and
    ``graph.clone_out`` (``obs``); while timing is on the replay is
    bracketed by CUDA timing events, its device time going to
    ``timing``, the replaying session's ``obs.DeviceTime`` (or to the
    span while a tracer is active).

    Launch counts (``kernels/pq_scan.py``): the eager run's launches are
    real and stay counted.  The capture launches nothing on the card, so
    the increments the wrappers made while it recorded are taken back
    and kept in ``launches``; every replay adds them again, so the
    counters stay counts of launches on the card.
    """

    def __init__(self, fn: Callable, inputs: tuple, *, pool=None,
                 clone: bool = True, timing=None):
        self.inputs = inputs
        self.clone = clone
        self.timing = timing
        self._static = flat_tensors(inputs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*inputs)
        torch.cuda.current_stream().wait_stream(side)
        before = launch_counts(forms=True)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.outputs = fn(*inputs)
        finally:
            after = launch_counts(forms=True)
            self.launches = {k: after[k] - before[k] for k in after}
            add_launch_counts({k: -n for k, n in self.launches.items()})

    def __call__(self, *args):
        given = flat_tensors(args)
        if len(given) != len(self._static):
            raise ValueError(f"graph takes {len(self._static)} tensors, got "
                             f"{len(given)}")
        with obs.span("graph.copy_in", cat="device"):
            for src, dst in zip(given, self._static):
                if src is not dst:
                    dst.copy_(src)
        with obs.replay_span("graph.replay", self.timing):
            self.graph.replay()
        add_launch_counts(self.launches)
        if not self.clone:
            return self.outputs
        with obs.span("graph.clone_out", cat="device"):
            return clone_tensors(self.outputs)
