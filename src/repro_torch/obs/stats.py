"""Unified stats schema + the modeled scan-stage memory traffic (the
port's counterpart of ``repro/obs/stats.py``).

``snapshot_all`` folds every counter surface the stack already computes
— session compile/cache stats, plan-cache hit/extend/miss and union
widths, gateway telemetry, streaming epoch state, per-stage time/DCO
from tracer span counters, and the analytic traffic model of the scan
stage — into ONE dict with the reference's documented layout (see the
function docstring; rendered to Prometheus text by
``repro_torch.obs.to_prometheus``).

``scan_traffic_model`` is the reference's scan/finalize boundary
traffic model, unchanged, so a snapshot of either package counts the
same bytes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .tracer import Tracer

SNAPSHOT_SCHEMA_VERSION = 1


def scan_traffic_model(*, scan_width: int, fetch: int) -> Dict[str, float]:
    """Analytic minimum bytes/query exchanged with device memory around
    the scan/finalize boundary:

      unfused: the scan materializes the full ``scan_width`` candidate
        stream for finalize to re-read — 8 B each (f32 distance + i32
        id), written once and read once;
      fused:   only the top-``fetch`` accumulator leaves the scan —
        12 B written each (f32 distance + i32 flat position + i32 id),
        8 B of which finalize reads back.
    """
    unfused_write = scan_width * 8.0
    fused_write = fetch * 12.0
    return {
        "unfused_scan_write": unfused_write,
        "fused_scan_write": fused_write,
        "write_reduction_x": unfused_write / fused_write,
        "unfused_roundtrip": 2 * unfused_write,
        "fused_roundtrip": fused_write + fetch * 8.0,
        "roundtrip_reduction_x":
            2 * unfused_write / (fused_write + fetch * 8.0),
    }


def session_traffic_model(searcher) -> Dict[str, Any]:
    """The scan-stage traffic model at a live session's operating point
    (scan width from the resolved params, fetch from the index's
    finalize contract).

    When the session runs the two-tier ladder (``params.refine``) a
    ``refine`` sub-dict reports the tier split: the
    compact plane's geometry (m_compact LUT lookups and packed
    code bytes per scanned item vs the full plane's m_full), the
    widened ``bigk_eff`` survivor budget, the modeled per-query code
    read traffic of each tier-1 variant, and the weighted total-ops
    model (tier-1 LUT lookups + tier-2 exact dims) against the
    single-tier baseline — the reference's accounting, field for
    field."""
    from ..core.search import finalize_fetch
    p = searcher.params
    idx = searcher.index
    base = getattr(idx, "base", idx)          # StreamingIndex -> base
    blk = int(base.arrays.block_codes.shape[1])
    scan_width = p.max_scan * blk
    fetch = min(finalize_fetch(p.bigk_eff, idx.result_oversample,
                               idx.needs_result_dedup), scan_width)
    out = {"scan_width": scan_width, "fetch": fetch, "block": blk,
           "max_scan": p.max_scan, "fused_topk": p.fused_topk,
           "bytes_per_query": scan_traffic_model(scan_width=scan_width,
                                                 fetch=fetch)}
    plane = getattr(searcher, "_plane", None)
    if plane is not None:
        m_full = int(base.codebook.m)
        dim = int(base.vectors.shape[1])
        tier1_ops = scan_width * plane.m
        tier2_ops = p.bigk_eff * dim
        single_ops = scan_width * m_full + p.bigk * dim
        out["refine"] = {
            "plane": plane.backend,
            "refine_factor": p.refine.refine_factor,
            "bigk": p.bigk, "bigk_eff": p.bigk_eff,
            "m_compact": plane.m, "m_full": m_full,
            "lookups_per_item": plane.m,
            "code_bytes_per_item": plane.bytes_per_item,
            "full_code_bytes_per_item": m_full,
            "tier1_code_read_bytes": scan_width * plane.bytes_per_item,
            "single_tier_code_read_bytes": scan_width * m_full,
            "tier1_ops": tier1_ops, "tier2_ops": tier2_ops,
            "total_ops": tier1_ops + tier2_ops,
            "single_tier_ops": single_ops,
            "total_ops_reduction_x": single_ops / (tier1_ops + tier2_ops),
        }
    return out


def _trace_section(tracer: Tracer) -> Dict[str, Any]:
    summary = tracer.stage_summary()
    stage_s = sum(v["total_s"] for name, v in summary.items()
                  if name.startswith("stage."))
    disp = summary.get("searcher.dispatch")
    section: Dict[str, Any] = {
        "spans": summary,
        "fences": tracer.fences,
        "dropped": tracer.dropped,
        "events": len(tracer.records),
    }
    if disp and disp["total_s"] > 0:
        # fraction of end-to-end dispatch wall time attributed to named
        # engine stages
        section["stage_attribution"] = stage_s / disp["total_s"]
    # per-stage DCO: the delta-vs-base scan split plus refine, straight
    # from span counters
    dco = {}
    for name, v in summary.items():
        for key in ("approx_dco", "delta_dco", "refine_dco"):
            if key in v["counters"]:
                dco[f"{name}.{key}"] = v["counters"][key]
    if dco:
        section["dco"] = dco
    return section


def snapshot_all(*, gateway=None, gateway_stats: Optional[dict] = None,
                 searcher=None, tracer: Optional[Tracer] = None
                 ) -> Dict[str, Any]:
    """One coherent stats dict across the stack.  Schema (top-level
    keys, each present only when its source was supplied):

      schema_version  int — bump on layout changes.
      session   ``Searcher.compile_stats()``: compiles /
                warmup_compiles / calls / dispatches / cache_hits /
                padded_rows / buckets, plus ``plan`` (hit_rate,
                hits/extends/misses, mean_union_live / mean_own_live /
                mean_width) when the session runs plan_reuse.
      gateway   ``Gateway.stats()``: telemetry counters + gauges +
                derived rates (qps, batch_fill, bucket_fill,
                *_dco_per_query, result_fill_rate, mean_top1_dist) +
                latency/queue_wait/dispatch histograms, queue depth,
                handover + session + stream state.
      hbm_model ``session_traffic_model``: scan_width / fetch / block /
                max_scan / fused_topk + modeled bytes_per_query
                (unfused vs fused write and roundtrip, reductions);
                plus ``refine`` (tier geometry, per-tier ops and code
                read traffic, total_ops_reduction_x vs single-tier)
                when the session runs the two-tier ladder.
      trace     per-span-name aggregates (count / total_s / mean_ms /
                summed counters), fence + drop counts, and
                ``stage_attribution`` (stage time / dispatch time) and
                ``dco`` (per-stage DCO incl. the delta-vs-base scan
                split) when the trace carried them.
    """
    out: Dict[str, Any] = {"schema_version": SNAPSHOT_SCHEMA_VERSION}
    if gateway is not None and gateway_stats is None:
        gateway_stats = gateway.stats()
    if gateway_stats is not None:
        out["gateway"] = gateway_stats
    if searcher is None and gateway is not None:
        searcher = getattr(gateway, "_last_session", None)
    if searcher is not None:
        out["session"] = searcher.compile_stats()
        out["hbm_model"] = session_traffic_model(searcher)
    if tracer is not None:
        out["trace"] = _trace_section(tracer)
    return out
