"""Runtime flags controlling how a step is traced.

UNROLL_SCANS: the reference keeps its layer / microbatch / chunk loops
as ``lax.scan`` and re-lowers each cell with every scan unrolled for
its cost pass, because XLA counts a while-loop body once.  The port has
no scans: its loops are Python loops that run every trip eagerly, so a
trace on meta tensors counts every trip with or without the flag, and
setting it changes no count.  The flag is kept so that
``launch/costpass.py`` enters ``unrolled()`` as the reference does and
so that code reading it means the same in both packages.
"""
import contextlib
import threading

_state = threading.local()


def unroll_scans() -> bool:
    return getattr(_state, "unroll", False)


@contextlib.contextmanager
def unrolled():
    prev = unroll_scans()
    _state.unroll = True
    try:
        yield
    finally:
        _state.unroll = prev


def scan_unroll_arg():
    return True if unroll_scans() else 1
