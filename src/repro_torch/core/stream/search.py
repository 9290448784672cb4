"""The stream's delta scan (counterpart of the delta scan in
``repro/core/stream/search.py``): the candidates the mutable delta
segment adds to a batch, beside the base's.  ``core/search.py``'s
``seil_search`` and ``scan_finalize`` run it as their delta stage when a
stream passes its state (``DeltaInputs``, with the tombstone mask
``live``); its candidates enter ``finalize_candidates`` through
``extra_d`` / ``extra_i`` and compete with the base's under the same
top-bigK and refinement rules.

The delta segment is scanned in one of two ways.  While its capacity is
at most the routing threshold (``IndexConfig.delta_route_min``, default
``nlist * block``) every live slot gets one ADC distance per query
(exhaustive).  Above it the scan is **routed**: each probed list
contributes the delta slots posted under it (``DeltaSegment.post``),
each slot scored once, at its lowest-ranked probed assigned list (the
delta side of ``listVisited``).

DCO: the exhaustive path counts one ADC distance per live slot per
query, the routed path one per live slot reachable through the probed
lists; dead slots cost nothing.

The routed scan with its top-``fetch`` cut is one hand-written kernel on
the card (``kernels/ops.py::delta_scan_topk``, ``csrc/delta_scan_topk.cu``):
a CTA a query walks each probed list's postings up to its first pad and
scores only the kept slots against the query's table in shared memory,
over ascending m as K1 sums, keeping the stable top-``fetch``.  Its plain
version (``kernels/ref.py::routed_delta_topk``, the CPU's path) and the
exhaustive scan (on every device; the reference's is plain JAX, no
Pallas) are torch gather-and-sums.  The exhaustive scan, whose codes
every query shares, is one ``F.embedding_bag(mode="sum")`` a chunk: a
bag a slot over its M rows of the chunk's (M * K, B) table, added in
order from zero (``chip_smoke.py`` holds it bitwise against a loop of
one gather and one add per m on the card, and
``tools/delta_scan_chunks.py`` times both: 4.2x faster at capacity
131,072).  Like the plain routed scan it cuts the batch into query
chunks of at most ``kernels/ref.py::DELTA_CHUNK_BYTES`` (256 MiB) of
working set: 40 bytes a query and slot, the f32 sums, their masked copy
and the int64 selection keys.  Each query keeps only its stable
top-``fetch`` delta candidates (``fetch`` the finalize budget,
``finalize_fetch``): finalize's stable selection over the base stream
followed by the delta stream gives the same candidates from those alone,
in the same order, so the results are the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...kernels import ops
from ...kernels.ref import _rows_per_chunk, _stable_top


class DeltaInputs(NamedTuple):
    """The delta segment's device mirrors a search reads."""
    codes: torch.Tensor    # (cap, M) uint8 padded delta buffer
    ids: torch.Tensor      # (cap,) int32 global ids, -1 dead/unused
    post: torch.Tensor     # (nlist, L) int32 slot postings, -1 pad
    assigns: torch.Tensor  # (cap, m) int32 assigned lists per slot


def _table_index(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(C, M) codes as int64 rows of an (M * K)-row table: m * K + code."""
    m = codes.shape[1]
    return codes.long() + torch.arange(m, device=codes.device) * k


def _adc_columns(lut: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """sum_m lut[b, m, codes[c, m]] over ascending m for codes shared by
    every query, given as ``_table_index`` rows: (B, M, K) x (C, M) ->
    (B, C) f32."""
    b, m, k = lut.shape
    table = lut.reshape(b, m * k).t().contiguous()          # (M*K, B)
    return F.embedding_bag(index, table, mode="sum").t()


def delta_adc(lut: torch.Tensor, delta_codes: torch.Tensor) -> torch.Tensor:
    """ADC distances of every delta slot: (B, M, K) lut x (C, M) codes
    -> (B, C).  d[b, c] = sum_m lut[b, m, codes[c, m]], ascending m."""
    return _adc_columns(lut, _table_index(delta_codes, lut.shape[2]))


def _delta_candidates(lut, delta_codes, delta_ids, delta_post,
                      delta_assigns, sel, rank_of, route_delta: bool,
                      fetch: int):
    """``(dd, di, per-query delta DCO, walked)`` through the routed scan
    (``ops.delta_scan_topk``: the kernel on the card; ``walked`` the
    posted slots each query read) or the exhaustive one (``walked``
    None), each query's stream cut to its stable top-``fetch``."""
    if route_delta:
        return ops.delta_scan_topk(lut, delta_codes, delta_ids, delta_post,
                                   delta_assigns, sel, rank_of, fetch=fetch)
    return (*exhaustive_delta_candidates(lut, delta_codes, delta_ids, fetch),
            None)


def exhaustive_delta_candidates(lut, delta_codes, delta_ids, fetch: int):
    """Every live slot of ``delta_codes`` / ``delta_ids`` (-1: dead or
    unused) scored for every query, each query's stream cut to its
    stable top-``fetch`` in query chunks (module docstring): ``(dd, di,
    per-query delta DCO)``.  A mesh shard passes its own slots
    (``core/distributed.py``)."""
    b = lut.shape[0]
    alive = delta_ids >= 0                                  # (cap,)
    cap = delta_ids.shape[0]
    index = _table_index(delta_codes, lut.shape[2])        # (cap, M)
    ids = delta_ids[None, :]
    step = _rows_per_chunk(b, 40 * cap)
    dds, dis = [], []
    for s in range(0, b, step):
        d = _adc_columns(lut[s:s + step], index)
        d = torch.where(alive[None, :], d, torch.inf)
        dd, di = _stable_top(d, ids.expand(d.shape[0], cap), fetch)
        dds.append(dd)
        dis.append(di)
    dco = alive.sum().to(torch.int32).expand(b).contiguous()
    return torch.cat(dds), torch.cat(dis), dco
