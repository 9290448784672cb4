"""RAIRS ANN serving entry point of the port (counterpart of
``repro/launch/serve.py``): build (or load) an index over a synthetic
corpus and serve batched queries through a searcher session, on one
card (``--device cpu`` runs the plain PyTorch versions on the CPU).

``PYTHONPATH=src python -m repro_torch.launch.serve --dataset sift1m
--nprobe 16 --batches 4``

Persistence (skip the train and build on repeat runs):

``... --save /tmp/sift1m.npz``      # first run: build then save
``... --load /tmp/sift1m.npz``      # later runs: load, serve at once

Streaming ops (corpus churn through the mutable index).  ``--insert N``
holds the last N corpus vectors out of the build and appends them
through the delta path; ``--delete N`` tombstones N random live ids;
``--compact`` folds delta and tombstones into a fresh base epoch.  Saved
bundles carry the streaming state, so an insert -> delete -> save /
load round trip resumes with the same delta segment and tombstones:

``... --insert 512 --delete 128 --compact --save /tmp/churned.npz``

``--load`` composes with the churn ops; bundles record how many corpus
rows they consumed, so repeated ``--insert`` runs keep appending fresh
rows instead of duplicating indexed ones.

Sharded serving is a deployment flag, not a code path: ``--ndev N``
shards the index (frozen or streaming) over an N-shard mesh
(``make_mesh``: round-robin over the visible cards, so four shards on
one card share it) and serves through the same session API
(``index.shard(mesh).searcher(params)``).  ``--shards N`` makes
``--save`` write a v3 sharded bundle (manifest + per-shard npz) that
``--load`` reassembles:

``... --ndev 4 --save /tmp/sift1m_sharded --shards 4``

Gateway serving: ``--gateway`` swaps the closed-loop batch loop for the
serving gateway: an open-loop arrival generator submits single-query
requests at ``--offered-qps``, the gateway coalesces them into batch
buckets on a ``--max-delay-ms`` deadline, and the run prints per load
point the p50 / p95 / p99 latency and the recall of the answers, then
the gateway's telemetry:

``... --gateway --offered-qps 200,400,800 --gateway-requests 512``

With churn ops, ``--gateway --compact`` runs the zero-downtime epoch
handover: the compaction folds on a background thread while requests
keep flowing, and the new epoch installs between batches.

Observability: ``--trace out.json`` traces the serving phase (stage
spans from the gateway flush down to the per-shard scan, device work
fenced at stage boundaries) and writes a Chrome/Perfetto trace-event
file (check it with ``python -m repro_torch.obs.export out.json``);
``--stats-format prom|json`` prints the unified ``snapshot_all`` stats
after serving.

The reference picks its platform from ``JAX_PLATFORMS``; here the device
is explicit: ``--device`` (default CUDA, raising when there is no card).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import obs
from ..core import (IndexConfig, RefineParams, SearchParams, StreamConfig,
                    StreamingIndex, available_strategies, build_index,
                    dco_summary, ground_truth, load_index, make_mesh,
                    read_index_meta, recall_at_k, save_index)
from ..data import make_dataset
from ..device import resolve_device


def refine_params(args):
    """``RefineParams`` from --refine-plane / --refine-factor (None: off)."""
    if args.refine_plane is None:
        return None
    return RefineParams(plane=args.refine_plane,
                        refine_factor=args.refine_factor)


def search_params(args) -> SearchParams:
    return SearchParams(
        k=args.k, nprobe=args.nprobe, max_scan=args.max_scan,
        exec_mode=args.exec_mode, use_kernel=args.use_kernel,
        fused_topk=args.fused_topk, plan_reuse=args.plan_reuse,
        refine=refine_params(args))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def apply_stream_ops(index, args, x, rows_used: int):
    """Wrap ``index`` for mutation and run the requested churn ops.

    ``rows_used`` is how many corpus rows the index has consumed (build
    and earlier inserts, kept in the bundle's provenance), so --insert
    only appends fresh rows.  Returns ``(stream, rows_used')``."""
    stream = (index if isinstance(index, StreamingIndex)
              else index.streaming(StreamConfig(delta_pad=args.delta_pad)))
    if args.insert:
        take = min(args.insert, x.shape[0] - rows_used)
        if take < args.insert:
            print(f"--insert {args.insert}: only {max(take, 0)} fresh corpus "
                  f"rows remain ({rows_used} already consumed)")
        if take > 0:
            t0 = time.perf_counter()
            ids = stream.insert(x[rows_used:rows_used + take])
            rows_used += take
            print(f"inserted {len(ids)} vectors (ids {ids[0]}..{ids[-1]}) "
                  f"via the delta path in {time.perf_counter() - t0:.2f}s "
                  f"(no layout rebuild)")
    if args.delete:
        rng = np.random.default_rng(0)
        live = stream.live_ids()
        victims = rng.choice(live, size=min(args.delete, len(live)),
                             replace=False)
        t0 = time.perf_counter()
        n = stream.delete(victims)
        print(f"tombstoned {n} ids in {time.perf_counter() - t0:.2f}s")
    if args.compact:
        info = stream.compact()
        print(f"compacted to epoch {info['epoch']}: n_live={info['n_live']} "
              f"dropped={info['dropped']} in {info['seconds']:.2f}s "
              f"(layout {info['layout_seconds']:.2f}s)")
    print(f"  stream: epoch={stream.epoch} version={stream.version} "
          f"live={stream.n_live} delta={stream.n_delta} "
          f"dead={stream.n_dead}")
    return stream, rows_used


def truth(index, q, k: int, dev) -> np.ndarray:
    """Exact top-k of ``q`` over the index's own live corpus (under churn
    over the survivors, ids mapped back)."""
    metric = index.config.metric
    if isinstance(index, StreamingIndex):
        live = index.live_ids()
        return live[ground_truth(index.live_vectors(), q, k, metric=metric,
                                 device=dev)]
    return ground_truth(index.vectors, q, k, metric=metric, device=dev)


def run_gateway(serving, args, q, gt, compact_async: bool = False):
    """Serve an open-loop arrival stream through the gateway at each
    offered load point (recall of its answers against ``gt``, the exact
    top-k of ``q``); with ``compact_async``, a zero-downtime epoch
    handover mid-stream (streaming indexes)."""
    from ..gateway import (Gateway, GatewayConfig, LogSink, degrade_ladder,
                           run_open_loop)

    params = search_params(args)
    ladder = (degrade_ladder(params, levels=args.degrade_levels)[1:]
              if args.degrade_levels else None)
    cfg = GatewayConfig(max_delay_ms=args.max_delay_ms,
                        max_batch=args.max_batch,
                        admission=args.admission,
                        max_queue=args.max_queue,
                        overload=args.overload,
                        drain_s=args.drain_s,
                        degrade=ladder,
                        telemetry_interval_s=args.telemetry_interval)
    sinks = (LogSink(),) if args.telemetry_interval > 0 else ()
    with Gateway(serving, params, config=cfg, sinks=sinks) as gw:
        for point, qps in enumerate(args.offered_qps):
            handover = None
            if compact_async and point == 0:
                # fire the handover after ~1/4 of the stream so it folds
                # under live traffic and installs between batches
                trigger = max(1, args.gateway_requests // 4)

                def on_request(i, gw=gw, trigger=trigger):
                    nonlocal handover
                    if i == trigger and handover is None:
                        handover = gw.compact_async("serve_cli")
            else:
                on_request = None
            out = run_open_loop(gw, q, qps, args.gateway_requests,
                                seed=point, on_request=on_request,
                                collect=True)
            rec = (recall_at_k(out["ok_ids"], gt[out["ok_query_idx"]])
                   if out["n_ok"] else 0.0)
            print(f"load {qps:g} qps: achieved={out['achieved_qps']:.0f} "
                  f"p50={out['p50_ms']:.2f}ms p95={out['p95_ms']:.2f}ms "
                  f"p99={out['p99_ms']:.2f}ms "
                  f"mean_batch={out['mean_batch']:.1f} "
                  f"recall@{args.k}={rec:.4f} "
                  f"shed={out['shed']} levels={out['levels']} "
                  f"errors={out['errors']}")
            if handover is not None:
                info = handover.wait(300)
                print(f"  handover installed: epoch={info['epoch']} "
                      f"replayed_inserts={info['replayed_inserts']} "
                      f"replayed_deletes={info['replayed_deletes']}")
        tel = gw.stats()["telemetry"]
        print(f"gateway: qps={tel['qps']:.0f} "
              f"batch_fill={tel['batch_fill']:.1f} "
              f"bucket_fill={tel['bucket_fill']:.2f} "
              f"p50={tel['latency']['p50_ms']:.2f}ms "
              f"p99={tel['latency']['p99_ms']:.2f}ms "
              f"counters={tel['counters']}")
        # snapshot while the gateway (and any tracer) is live, so
        # --stats-format renders one stack-wide view
        return obs.snapshot_all(gateway=gw, tracer=obs.tracer())


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        epilog="Async serving: --gateway runs the deadline-batched "
               "gateway (repro_torch.gateway) behind an open-loop arrival "
               "generator instead of the closed-loop batch loop, e.g. "
               "`python -m repro_torch.launch.serve --gateway "
               "--offered-qps 200,400 --gateway-requests 256`.")
    ap.add_argument("--device", default=None,
                    help="where the index lives and the search runs "
                         "(default: CUDA, an error without a card; 'cpu' "
                         "runs the plain PyTorch versions)")
    ap.add_argument("--dataset", default="sift1m")
    ap.add_argument("--strategy", default="rair",
                    choices=available_strategies())
    ap.add_argument("--no-seil", action="store_true")
    ap.add_argument("--nlist", type=int, default=256)
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--max-scan", type=int, default=None,
                    help="per-query block budget (default: index-derived)")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--exec-mode", default="paged",
                    choices=("paged", "grouped", "clustered"),
                    help="engine scan mode: per-query paging, list-major "
                         "batched execution (paper §5.3), or locality-"
                         "clustered per-tile unions")
    ap.add_argument("--plan-reuse", action="store_true",
                    help="incremental plans: reuse block unions across "
                         "adjacent batches (grouped/clustered only) and "
                         "report plan-cache stats")
    ap.add_argument("--use-kernel", action="store_true",
                    help="accepted for the reference's command lines; the "
                         "device picks the kernels (CUDA on the card, the "
                         "plain versions on the CPU)")
    ap.add_argument("--fused-topk", action="store_true",
                    help="fuse candidate selection into the scan stage "
                         "(K3 on the card)")
    ap.add_argument("--refine-plane", default=None,
                    choices=("pq4", "binary", "full"),
                    help="two-tier ladder: scan this compact plane in "
                         "tier-1 and exactly re-rank the widened survivor "
                         "set in tier-2 ('full' = widening-only ablation)")
    ap.add_argument("--refine-factor", type=int, default=4, metavar="R",
                    help="tier-1 survivor widening: tier-2 re-ranks "
                         "bigk*R candidates (R=1 is bitwise the "
                         "single-tier path)")
    ap.add_argument("--save", metavar="PATH", default=None,
                    help="persist the index bundle (after any stream ops)")
    ap.add_argument("--load", metavar="PATH", default=None,
                    help="load an index bundle from PATH (skips train+build)")
    ap.add_argument("--insert", type=int, default=0, metavar="N",
                    help="hold N corpus vectors out of the build and insert "
                         "them through the streaming delta path")
    ap.add_argument("--delete", type=int, default=0, metavar="N",
                    help="tombstone N random live ids")
    ap.add_argument("--compact", action="store_true",
                    help="fold delta + tombstones into a fresh base epoch")
    ap.add_argument("--delta-pad", type=int, default=256,
                    help="delta-segment capacity bucket quantum")
    ap.add_argument("--ndev", type=int, default=0, metavar="N",
                    help="serve through a ShardedIndex over an N-shard mesh "
                         "(round-robin over the visible cards, or N shards "
                         "on --device; same session API; 0 = one shard-"
                         "less index)")
    ap.add_argument("--shards", type=int, default=0, metavar="N",
                    help="with --save: write a v3 sharded bundle "
                         "(manifest + N per-shard npz files)")
    ap.add_argument("--gateway", action="store_true",
                    help="serve an open-loop arrival stream through the "
                         "async deadline-batched gateway instead of the "
                         "closed-loop batch loop")
    ap.add_argument("--offered-qps", default="200",
                    help="comma-separated open-loop load points "
                         "(requests/s) for --gateway")
    ap.add_argument("--gateway-requests", type=int, default=256,
                    metavar="N", help="requests per load point")
    ap.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="gateway micro-batch flush deadline")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="gateway coalescing target (flushes early when "
                         "a full bucket accumulates)")
    ap.add_argument("--max-queue", type=int, default=None, metavar="N",
                    help="bounded admission: cap the gateway queue at N "
                         "requests (default: unbounded)")
    ap.add_argument("--overload", default="reject",
                    choices=("reject", "block"),
                    help="policy when the bounded queue is full: reject "
                         "sheds typed (Overloaded), block applies "
                         "backpressure to producers")
    ap.add_argument("--drain-s", type=float, default=None, metavar="S",
                    help="close() grace window: drain queued requests "
                         "for up to S seconds, then fail leftovers with "
                         "GatewayClosed (default: drain fully; 0 = "
                         "fail-fast)")
    ap.add_argument("--degrade-levels", type=int, default=0, metavar="L",
                    help="arm a graceful-degradation ladder with L "
                         "reduced-effort rungs below the configured "
                         "params (halved nprobe/max_scan per rung; "
                         "needs --max-queue; 0 = off)")
    ap.add_argument("--admission", default="signature",
                    choices=("signature", "fifo"),
                    help="gateway admission: group requests by rank-0 "
                         "probed list, or plain arrival order")
    ap.add_argument("--telemetry-interval", type=float, default=0.0,
                    metavar="S", help="emit a structured gateway "
                         "telemetry line every S seconds (0 = off)")
    ap.add_argument("--trace", metavar="FILE", default=None,
                    help="trace the serving phase (stage spans with "
                         "device fencing) and write a Chrome/Perfetto "
                         "trace-event JSON to FILE")
    ap.add_argument("--trace-sample", type=int, default=1, metavar="N",
                    help="with --trace: record one gateway request "
                         "exemplar per N requests")
    ap.add_argument("--stats-format", default=None,
                    choices=("json", "prom"),
                    help="print the unified snapshot_all() stats "
                         "(session + gateway + traffic model + trace "
                         "aggregates) after serving, as pretty JSON or "
                         "Prometheus text exposition")
    return ap


def check_args(ap, args) -> None:
    """The reference's argument errors (``ap.error``: exit code 2)."""
    try:
        args.offered_qps = [float(v) for v in
                            str(args.offered_qps).split(",") if v]
    except ValueError:
        ap.error(f"--offered-qps must be comma-separated numbers, "
                 f"got {args.offered_qps!r}")
    if args.ndev < 0:
        ap.error(f"--ndev must be >= 0, got {args.ndev}")
    if args.ndev and args.plan_reuse:
        ap.error("--plan-reuse is single-host only (the plan cache "
                 "merges host-side between dispatches)")
    if args.shards and not args.save:
        ap.error("--shards only applies to --save")
    if args.plan_reuse and args.exec_mode == "paged":
        ap.error("--plan-reuse needs --exec-mode grouped or clustered "
                 "(paged scans have no block union to reuse)")
    stream_ops = bool(args.insert or args.delete or args.compact)
    if args.gateway and args.compact and args.ndev:
        ap.error("--gateway --compact needs the un-sharded streaming "
                 "index (the handover folds a StreamingIndex epoch)")
    if args.load and args.save and not stream_ops:
        ap.error("--save with --load needs stream ops (an unmutated "
                 "loaded bundle is never re-written); add "
                 "--insert/--delete/--compact to churn then persist")


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    check_args(ap, args)
    dev = resolve_device(args.device)
    stream_ops = bool(args.insert or args.delete or args.compact)
    gateway_handover = bool(args.gateway and args.compact)
    if gateway_handover:
        # the gateway runs the compaction as a zero-downtime handover
        # mid-stream instead of a blocking fold before serving starts
        args.compact = False

    x, q, spec = make_dataset(args.dataset, device=dev)
    rows_used = x.shape[0]
    if args.load:
        meta = read_index_meta(args.load)
        saved_ds = meta.get("extra", {}).get("dataset")
        if saved_ds is not None and saved_ds != args.dataset:
            ap.error(f"{args.load} was built over dataset {saved_ds!r}, "
                     f"not --dataset {args.dataset!r}; recall against the "
                     f"wrong corpus is meaningless")
        t0 = time.perf_counter()
        index = load_index(args.load, device=dev)
        cfg = index.config
        if index.vectors.shape[1] != x.shape[1]:
            ap.error(f"{args.load} holds {index.vectors.shape[1]}-d vectors "
                     f"but --dataset {args.dataset} is {x.shape[1]}-d")
        rows_used = meta.get("extra", {}).get(
            "corpus_rows_used", index.vectors.shape[0])
        streaming = isinstance(index, StreamingIndex)
        print(f"loaded {cfg.strategy}{'+SEIL' if cfg.seil else ''} "
              f"{'streaming ' if streaming else ''}index over "
              f"{index.vectors.shape[0]} vectors from {args.load} "
              f"in {time.perf_counter() - t0:.1f}s (train+build skipped; "
              f"--strategy/--nlist/--no-seil come from the bundle)")
        if streaming:
            print(f"  restored stream: epoch={index.epoch} "
                  f"version={index.version} live={index.n_live} "
                  f"delta={index.n_delta} dead={index.n_dead}")
    else:
        cfg = IndexConfig(nlist=args.nlist, strategy=args.strategy,
                          seil=not args.no_seil, metric=spec.metric)
        # --insert serves held-out corpus rows so churned recall is honest
        holdout = min(args.insert, x.shape[0] // 2)
        x_build = x[:x.shape[0] - holdout] if holdout else x
        rows_used = x_build.shape[0]
        t0 = time.perf_counter()
        index = build_index(x_build, cfg, device=dev,
                            generator=torch.Generator().manual_seed(0))
        phases = {k: round(v, 1) for k, v in index.build_seconds.items()}
        print(f"built {args.strategy}{'' if args.no_seil else '+SEIL'} index "
              f"over {x_build.shape[0]} vectors in "
              f"{time.perf_counter() - t0:.1f}s (phases: {phases}) on {dev}")

    if stream_ops or isinstance(index, StreamingIndex):
        index, rows_used = apply_stream_ops(index, args, x, rows_used)
    if args.save:
        t0 = time.perf_counter()
        save_index(index, args.save,
                   extra={"dataset": args.dataset,
                          "corpus_rows_used": int(rows_used)},
                   shards=args.shards or None)
        what = (f"sharded ({args.shards}-way) bundle" if args.shards
                else "index bundle")
        print(f"saved {what} to {args.save} "
              f"in {time.perf_counter() - t0:.1f}s")
    base = index.base if isinstance(index, StreamingIndex) else index
    print(f"  blocks={base.stats.n_blocks} items={base.stats.n_items_stored} "
          f"refs={base.stats.n_ref_entries} "
          f"logical={base.stats.logical_bytes / 1e6:.1f}MB")

    serving = index
    if args.ndev:
        mesh = make_mesh(args.ndev, device=args.device)
        serving = index.shard(mesh)
        print(f"serving over a {args.ndev}-shard mesh on "
              f"{sorted({str(d) for d in mesh.devices})} (block/vector "
              f"shards of ~{base.stats.n_blocks // args.ndev} blocks; "
              f"same session API)")
    nq = (q.shape[0] if args.gateway
          else min(args.batches * args.batch_size, q.shape[0]))
    gt = truth(index, q[:nq], args.k, dev)
    if args.trace:
        obs.start(sample=args.trace_sample)
    if args.gateway:
        snap = run_gateway(serving, args, q.cpu().numpy(), gt,
                           compact_async=gateway_handover)
        finish_obs(args, snap)
        return 0
    searcher = serving.searcher(search_params(args), device=dev)
    for b in range(args.batches):
        lo, hi = b * args.batch_size, (b + 1) * args.batch_size
        qb = q[lo:hi]
        if qb.shape[0] == 0:
            break
        t0 = time.perf_counter()
        res = searcher(qb)
        sync(dev)
        dt = time.perf_counter() - t0
        rec = recall_at_k(res.ids, gt[lo:hi])
        s = dco_summary(res)
        st = searcher.stats
        print(f"batch {b}: recall@{args.k}={rec:.4f} "
              f"dco/query={s['total_dco']:.0f} "
              f"qps={qb.shape[0] / dt:.0f} "
              f"compile[new={st.compiles} hit={st.cache_hits} "
              f"buckets={list(searcher.buckets)}]")
    if args.plan_reuse:
        print(f"plan-cache stats: {searcher.compile_stats()['plan']}")
    if isinstance(index, StreamingIndex):
        print(f"stream searcher stats: {index.searcher_stats()}")
    if args.ndev:
        print(f"sharded searcher stats: {serving.searcher_stats()}")
    finish_obs(args, obs.snapshot_all(searcher=searcher,
                                      tracer=obs.tracer()))
    return 0


def finish_obs(args, snap) -> None:
    """Stop the tracer and write the trace-event file (``--trace``), then
    render the unified ``snapshot_all`` stats (``--stats-format``)."""
    if args.trace:
        tr = obs.stop()
        doc = obs.write_trace(tr, args.trace)
        print(f"trace: {len(doc['traceEvents'])} trace events "
              f"({tr.fences} fences, {tr.dropped} dropped) -> "
              f"{args.trace}")
    if args.stats_format == "prom":
        sys.stdout.write(obs.to_prometheus(snap))
    elif args.stats_format == "json":
        print(json.dumps(snap, indent=1, default=float))


if __name__ == "__main__":
    sys.exit(main())
