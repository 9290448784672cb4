"""Async serving gateway of the port (counterpart of ``repro/gateway``;
DESIGN.md §10).

Deadline-batched request queue + probe-signature admission over the
port's ``Searcher`` sessions (a CUDA graph per dispatch bucket on the
card), zero-downtime epoch handover for streaming indexes, and
first-class pluggable telemetry::

    from repro_torch.gateway import Gateway, GatewayConfig, LogSink

    with Gateway(index, k=10, nprobe=8,
                 config=GatewayConfig(max_delay_ms=2.0, max_batch=64),
                 sinks=(LogSink(),)) as gw:
        ids = gw.search(q).ids          # blocking, or gw.submit(q) async
        print(gw.stats()["telemetry"]["batch_fill"])

Queries are host vectors (numpy); answers are host arrays.  The gateway
serves on the index's device.

Overload resilience (DESIGN.md §13): ``GatewayConfig(max_queue=...,
overload="reject"|"block")`` bounds admission (shed requests fail with
``repro_torch.errors.Overloaded``), ``degrade=degrade_ladder(params)``
steps quality down under sustained queue pressure and back up when load
recedes, and requests past their deadline fail typed at dequeue.
"""
from ..errors import (DeadlineExceeded, GatewayClosed,  # noqa: F401
                      HandoverFailed, Overloaded, RairsError)
from .gateway import (Gateway, GatewayConfig, Handover,  # noqa: F401
                      degrade_ladder)
from .loadgen import run_open_loop  # noqa: F401
from .queue import PendingRequest, RequestQueue, RequestResult  # noqa: F401
from .telemetry import (LatencyHistogram, LogSink, MemorySink,  # noqa: F401
                        Telemetry, TelemetrySink)
