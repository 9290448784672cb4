#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of RAIRS on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0] [--n 1000000] [--queries 10000]

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device   — card name, and name + power limit from nvidia-smi;
  2. build    — compile the CUDA kernels from src/repro_torch/kernels/csrc;
  3. kernels  — each kernel against its plain PyTorch version on the card,
                bitwise, over a sweep of shapes and layouts: K1 in every
                form and grid choice (long S, K 4 / 16 / 256, QT 1 to
                64, query groups, packed with odd Mc; the compact-plane
                form at MB 8 / 16, QT 1 / 8 / 64, odd S; the staged form
                for global tables at M 256 / 232 / 250 / 470 / 3701, K
                256 / 128 / 16, QT 1 / 3 / 8, a short last range, two
                passes a split; the k256 form at K 256, QT 1 / 3 / 8 /
                16 / 64, M 64 / 72 / 40 / 42, a short last range, many
                splits), each launch in the form its shape
                names; K3 also split over the grid (few
                tiles, long S, sparse plans), in query groups and with
                global tables (GT: QT 1 / 3 / 8 / 64, M 256 / 264 /
                240, fetch 100 / 400, one split and many, two passes a
                query; GT-ldg at M 250), in its k256 form (QT 1 / 3 /
                8 / 64, M 64 / 72 / 40, fetch 100 / 400, one split and
                many), and
                in its candidate-row form (fetch
                9000, 16000, the plan width, 40000: one scan to rows
                per query group, held alone against scan_rows_ref, and
                one row select); the row select alone (rows up to
                336,000 entries, fills with garbage past them, -0.0
                beside +0.0, fetch up to 40000); K3's merge on random
                sorted lists (tie-heavy and random f32, 30% pads or most
                entries pads, at 64 x 66 x 100 / 400, 1024 x 5 x 100 /
                400 and the path's shapes, timed beside torch.topk at the
                former; fetch up to 40000: where the lists pass shared
                memory through the row select); K2's tile-row check;
                the PQ encode kernel against its plain version at SIFT's
                PQ64x4 / PQ64x8, the gist shape, the pq4 and binary
                planes and a dsub of 3, n 1 to 65,537 (codes equal but
                at f32 ties, at most 1e-5 of them; bitwise alike
                whatever the batch), timed at 38 and 65,536 rows;
  4. main     — a SIFT1M-shaped corpus (n x 128, made on the card from
                --seed), a RAIRS index built on the card (IVF4096,
                PQ64x4, block 32, rair + SEIL; determinism: built twice
                in this process, bitwise equal), exact top-10 ground
                truth, then search sessions (a CUDA graph per bucket,
                captured by warmup first): paged / clustered at B=1024
                and grouped at B=64, each with fused_topk off and on:
                recall@10, DCO, QPS, kernel launch counts; all six runs
                must agree on ids and DCO; each beside a loop of eager
                seil_search calls on the same batches (same results);
                one traced batch per mode (stage spans, bitwise equal to
                the untraced batch); the paged fused graph replayed
                with replay timing off and then on (CUDA events: the
                session's timed counters move only while on, their
                device ms a call 0.85-1.0 of a synchronised host clock;
                then printed under a host-only and a card profiler);
                plan reuse in grouped B=64 and
                clustered B=1024 (warmup_widths first; plan stats), which
                must agree with the six runs, with K1 and K3 held at a
                batch whose unions the plan cache widened; clustered at
                query_tile 64 (query groups); peak device memory with the
                sessions' graphs; an inner-product build through
                paged+fused; an nbits=8 index (PQ64x8: K1 and K3 in
                their k256 forms, every launch) in all six modes;
                a gist-shaped index (PQ256x8: 256 KB of tables per query,
                K1 and K3 with global tables) in all six modes; a small
                index searched on the card and on the CPU;
  5. timing   — each kernel, bitwise against its plain version at the
                shapes of each exec mode's first batch (main path and
                gist and nbits=8 indexes; K1 and K3 in the form each
                path must take: fast and shared on the main path,
                packed on the planes, staged and GT on the gist index,
                k256 at nbits=8, by their launches by form), then both
                timed (CUDA events; a kernel by
                replays of a CUDA graph of its calls, graph_ms, so no
                host work counts) beside the kernel's bound and lookup
                floor on this card (K3's merge also alone where K3
                splits, beside torch.topk), and the union fill of
                grouped and clustered mode; the device time of each
                search stage for one batch of each exec mode, fused off
                and on;
  6. refine   — on the main index, both compact planes attached (pq4
                Mc=16 and binary Mc=32; train / encode / layout seconds),
                two-tier sessions at refine factor 4 in the six modes
                (which must agree; recall@10 beside the single tier),
                refine factor 1 bitwise the plain session, plan reuse
                with the pq4 plane (grouped B=64, clustered B=1024,
                warmup_widths first) equal to the plain two-tier
                sessions, and the wide case (k=100, pq4 x 16: fetch
                16,000) in the six modes, fused equal to unfused, where
                K3 takes its candidate-row form (a scan to rows and a row
                select, no merge); K1 and K3 held and timed at each
                mode's first batch at the plane shapes (and the row
                select alone at the pq4 plane's fetch 400; K1 + one
                torch.topk beside K3) and the wide shape (its two
                launches alone too, a torch.topk beside the select, K1 +
                one torch.topk beside K3), and the
                device time of each stage of one wide batch per mode;
     gateway  — on the main index, the main path's params (paged, fused,
                nprobe 32): the dense path on 1,024 queries against a
                paged session whose budget drops no block (DCO and
                scanned blocks equal, ids within 2; the nprobe sweep
                bitwise single runs; seconds, peak memory); 4,096
                queries through a Gateway (max_batch 256, 2 ms), fused
                and unfused, each answer the direct session's or a
                classified near-tie; the serve sweep (BENCH_serve.json's
                protocol: per-request capacity, then 1.5x and 20x it,
                20,000 requests a point: QPS, p50 / p95 / p99, mean
                batch, 0 errors, recall@10 >= 0.5); overload
                (BENCH_overload.json's: max_queue 1024, reject, a
                two-level ladder at 0.5x / 1x / 2x the saturating rate,
                beside the unbounded gateway at 2x, 10,000 requests a
                point, each flush slowed by an injected 50 ms dispatch
                delay so that one client thread can offer 2x; at 2x the
                gateway sheds or steps down, and levels 1 and 2 answer
                over the three points with recall@10 >= 0.4);
                clustered with plan reuse behind signature admission; a
                traced flush bitwise the untraced one, its trace
                exported, validated and read back, the unified snapshot
                as Prometheus text; launches of the gateway runs by
                form; the card's busy share of the 20x point (its
                flushes at their buckets' device times); K1, K3 and the
                merge held and timed at the first flushed batch;
     sharded  — on the main index, a one-shard mesh and a four-shard mesh
                on cuda:0 (make_mesh) in the six runs: one shard bitwise
                the plain session (ids, distances, four counters); four
                shards held by the reference's multi-device contract
                (counters and sorted distances exact, id sets equal;
                recall@10 >= 0.5) to a plain session at one shard's
                derived budget, which never truncates (the main path's
                max_scan drops blocks, and a per-shard window would drop
                others); QPS beside the plain sessions', one batch through
                the graph and through the eager step, a traced batch
                bitwise equal (stage.shard_scan, stage.gather_finalize);
                each shard's K1 and K3 (and merge) held bitwise and timed
                at each mode's first batch; golden_v1 at four shards on the
                card and on the CPU, its four-way v3 bundle loaded with
                mesh=; the serve CLI (--ndev 4) as a subprocess, closed
                loop and behind the gateway.  In phase stream: the stream
                at four shards, at capacity 131,072 against the stream's
                sessions and at 262,144 against one shard, a pinned
                session stale after the deletes, the shards placed anew
                after the compaction;
     stream   — first the routed delta scan's kernel bitwise against
                its plain version on synthetic deltas at the churn
                cell's shapes (capacity 262,144, nprobe 32, fetch 200,
                posting width 256 / 512, B 1024 / 64, K 16 / 256, L2
                and inner-product tables; its GT and GS forms), each
                timed beside the plain version (graph replays); then
                streaming on the main index's configuration: a draw of
                n + n/4 vectors of the sift1m spec, the index built on the
                first n, the last n/4 inserted in 8 batches (append
                vectors/s); the six modes at capacity 131,072
                (exhaustive delta scan) and 262,144 (routed), agreeing,
                recall@10 over the live set, a traced batch a mode
                bitwise equal (stage.delta_scan) and the delta scan alone
                timed; n/8 deletes, half base, half delta (delete
                vectors/s; no deleted id returned), the six modes again,
                plan reuse (grouped B=64) and the pq4 plane at refine
                factor 4 agreeing with their plain counterparts; K1 and
                K3 with the tombstones' dead tile held bitwise at each
                mode's first batch and timed; a steady state inside one
                capacity bucket (no new graph, no layout build, every
                session reissued); compact() bitwise equal to build_seil
                over the survivors' stored assignments and codes, beside
                a full build whose differing assignments must be f32
                ties; begin_compact with fold() on a thread while batches
                are served and the stream mutates, then install(),
                external ids resolving across the epochs; a Gateway over
                the stream (`stream gateway` lines): insert / delete
                round trips through external ids, open-loop traffic
                before, during and after a compact_async handover whose
                first fold attempt is made to fail (retried) while an
                on_request hook inserts and deletes: no client error, no
                deleted id served, every served id resolving after
                install, latency percentiles of the three segments; the
                stream saved, reloaded and answering bitwise alike;
     multi    — an m-assignment index (80,000 x 128, IVF1024, PQ64x4,
                multi_m=3) built on the card, in the six modes;
     persist  — the nbits=8 index with both planes saved as one file and
                as four shards, loaded on the card, searched bitwise
                equal to the index in memory; the golden v1 bundle
                answered alike on the card and on the CPU; a bit-flipped
                copy refused with CorruptBundleError naming the member
                (the 1M index is not saved: compressing its ~0.6 GB
                would dominate the run).
     lm       — the LM serving path, after every session and index is
                released (no kernel of its own: the reference's LM side
                reaches no pallas_call): the ten architectures reduced
                (B 2, S 64), params from a CPU generator, prefill,
                decode and train_loss on the card against the CPU
                (logits within 2e-2 of max|CPU|, argmax over all 128
                rows >= 0.95, every sublayer from the CPU's input within
                5e-3, loss in (3, 12)), and decode against teacher-forced
                prefill for the reference's five (capacity 8: < 0.05,
                argmax > 0.9); Qwen3-8B at full width and depth (36
                layers, bf16 serving weights from a seeded CUDA
                generator, B 1 of prefill_32k's 32): prefill at S 32,768
                (ms, tokens/s), the teacher-forcing pair, 32 greedy decode
                steps (ms/step beside the bytes bound), peak memory; the
                long_500k shape at its width (2 of 36 layers; keys and
                values made on the card with bursty topics): the kNN
                cache build (blocks used of nb_cap, dropped table
                entries; S halved while it passes nb_cap, listed as a
                cut), the attention output against exact attention over
                all keys at nprobe 1 / 4 / 16 / 64, decode_step_long
                ms/step over 16 steps, and nprobe == nlist exact within
                0.05 at S 16,384 (no entry dropped).  Callable alone:
                ``chip_smoke.lm_path(torch, torch.device("cuda"), 0)``.
     train    — the training path, after phase lm (no kernel of its own:
                the reference's training reaches no pallas_call): the
                ten architectures reduced (B 2, S 64, accum 2), params
                from a CPU generator, on the card against the CPU: the
                loss (within 1e-3 relative), every leaf's gradient
                (within 5e-2 of max|CPU|; hubert's embed exactly zero),
                grad_norm (1e-2 relative), remat on and off bitwise on
                the card, every sublayer's VJP from the CPU's input and
                cotangent (2e-2), adamw_update from the CPU's gradients
                (1e-6), make_train_step bitwise its parts; _dot / _bmm
                backward at Qwen3-1.7B's layer shapes against the CPU's
                autograd (1e-2); on the reduced qwen3-1.7b a checkpoint
                restored bitwise and the next step from it bitwise the
                uninterrupted one; the train CLI (3 steps, a checkpoint
                every 2) and its rerun resuming at step 2 with the same
                loss, as subprocesses; Qwen3-1.7B at full width and depth
                (f32 masters and AdamW state; S 4096, global batch 8 of
                train_4k's 256, TrainConfig(): accum 8, remat): 4 steps
                on one synthetic batch, the loss finite and falling,
                seconds, tokens/s, model FLOP/s and its share of the
                bf16 dense peak, the last step under torch.profiler
                (card against host time, kernels by time), adamw_update
                alone, parameter and state bytes, peak memory.
                Callable alone: ``chip_smoke.train_path(torch,
                torch.device("cuda"), 0)``.
     launch   — the launch tooling, after phase train (no kernel: it
                traces on meta tensors): all 76 (cell, mesh) pairs
                planned at full width on the 16x16 and 2x16x16 meta
                meshes (mode, argument bytes a device) and the rairs
                cell's arguments; Qwen3-8B prefill_32k (batch 1) and
                Qwen3-1.7B train_4k (batch 8, accum 8) traced once each
                on meta tensors: the peak-live estimate beside
                max_memory_allocated of one call of that step in phases
                lm and train (reset just before it; the bytes resident
                then beyond the call's inputs taken off; the ratio must
                lie in [0.67, 1.5]), GEMM FLOPs beside
                model_flops (and train_flops).  Callable alone after
                lm_full and train_full have run.
The line before the last is a JSON object {"kernels": [...]}, the last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
INDEX = dict(nlist=4096, m_pq=64, nbits=4, block=32, strategy="rair",
             seil=True)                              # the main path's index
SEARCH = dict(k=10, nprobe=32, k_factor=10)          # the main path's params
# its searches: exec mode and batch size (grouped's unfused scan holds
# (B, U, BLK) f32 with U up to B * S, hence the smaller batch)
RUNS = (("paged", 1024), ("clustered", 1024), ("grouped", 64))
# the nbits=8 index: 80,000 SIFT1M-shaped vectors, IVF1024, PQ64x8
NBITS8_N, NBITS8_INDEX = 80_000, dict(INDEX, nlist=1024, nbits=8)
# plan-reuse sessions on the main index: exec mode and batch size
REUSE_RUNS = (("grouped", 64), ("clustered", 1024))
# the gist-shaped index (50,000 x 256): IVF1024, PQ256x8, 256 KB of tables
# per query, above a CTA's shared memory
GIST_INDEX = dict(INDEX, nlist=1024, m_pq=256, nbits=8)
# two-tier sessions: the recall@10 floor (a sanity floor: a broken plane
# scan finds nothing), and the wide case (fetch 16,000 = k 100 x k_factor
# 10 x refine_factor 16) on the first WIDE_QUERIES queries
REFINE_FLOOR = 0.2
WIDE = dict(k=100, k_factor=10)
WIDE_QUERIES = 2048
# the kernels the main path's runs launch (fetch 100: K3's shared-memory
# form, split and merged) and those of the wide case (fetch 16,000: K3's
# candidate-row form, a scan to rows and a row select, no merge)
MAIN_KERNELS = ("pq_scan_tiled_kernel", "pq_scan_topk_kernel",
                "merge_topk_kernel")
WIDE_KERNELS = ("pq_scan_tiled_kernel", "pq_scan_topk_kernel",
                "select_topk_kernel")
# the m-assignment index: 80,000 SIFT1M-shaped vectors, IVF1024, PQ64x4,
# every vector in three lists (stored three times: no shared cells, so the
# results are deduplicated by id)
MULTI_N, MULTI_INDEX = 80_000, dict(INDEX, nlist=1024, seil=False,
                                    multi_m=3)
# the stream phase: n / 4 held-out vectors inserted in this many batches
# (half of them reach capacity 131,072 = nlist * block at n = 1M, the last
# exhaustive bucket; all of them 262,144, routed)
STREAM_BATCHES = 8
# the routed delta scan's kernel held and timed at the churn cell's routed
# delta (capacity 262,144, nprobe 32 of 4096 lists, M 64, fetch 200) at
# each posting width, batch and K, L2 and inner-product tables; then its
# GT form (M 256, K 256: 256 KB of table) and its GS form (fetch 9000)
DELTA_CHECK = dict(cap=262_144, nlist=4096, p=32, m=64)
DELTA_FETCH = 200
DELTA_WIDTHS, DELTA_BATCHES, DELTA_KS = (256, 512), (1024, 64), (16, 256)
DELTA_FORM_CASES = (("GT", dict(m=256, k=256), 64, DELTA_FETCH),
                    ("GS", dict(width=512), 64, 9000))
# the largest gap between two assignment decisions, relative to
# |x|^2 + |c|^2, that an f32 distance matmul may round either way
TIE_REL = 1e-5
# the PQ encode kernel held against its plain version at SIFT's PQ64x4 and
# PQ64x8, the gist-shaped PQ256x8, the planes at D 128 (pq4: dsub 8;
# binary: groups of 4 bits) and a dsub of 3 (the kernel's generic path),
# as (M, K, dsub), at these row counts (38: a churn batch's inserts;
# 65,537: past one chunk of the plain loop), and timed at ENCODE_TIMED
ENCODE_SHAPES = {"sift PQ64x4": (64, 16, 2), "sift PQ64x8": (64, 256, 2),
                 "gist PQ256x8": (256, 256, 1), "pq4 plane": (16, 16, 8),
                 "binary plane": (32, 16, 4), "dsub 3": (32, 16, 3)}
ENCODE_SIZES = (1, 37, 38, 8192, 65536, 65537)
ENCODE_TIMED = (38, 65536)
# at most this share of the kernel's codes (rounded up) may differ from
# the plain version's, each an f32 tie (encode_ties)
ENCODE_DIFF_SHARE = 1e-5
# the gateway phase: the main path's params (paged, fused) behind the
# gateway; flushes of up to GW_BATCH requests, GW_DELAY_MS deadline
GATEWAY = dict(SEARCH, exec_mode="paged", fused_topk=True)
GW_BATCH, GW_DELAY_MS = 256, 2.0
GW_EQUAL = 4096            # queries of the equality bursts
GW_REQUESTS = 20_000       # requests of a serve or overload point
GW_CALIBRATE = 2_000       # back-to-back requests that measure a capacity
GW_SERVE_LOADS = (1.5, 20.0)          # x per-request capacity
GW_OVERLOAD_LOADS = (0.5, 1.0, 2.0)   # x the batched saturating rate
GW_OVERLOAD_REQUESTS = 10_000   # requests of an overload point
GW_SLOW_S = 0.05           # the delay injected into each overload flush
GW_DEGRADED_FLOOR = 0.4    # recall@10 of a degraded level (DESIGN.md §13)
GW_MAX_QUEUE = 1024
GW_WAIT = 120.0            # the longest any request is waited for
DENSE_QUERIES = 1024
# the stream's gateway: requests a segment (before / after the
# handover; twice that during it), offered rate, vectors to insert
STREAM_GW_REQUESTS, STREAM_GW_QPS, STREAM_GW_INSERTS = 3_000, 2_000.0, 16_384


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, reps: int = 10, warm: int = 2) -> float:
    """Milliseconds a call of fn() takes on the card: CUDA events around
    ``reps`` calls made back to back, over ``reps``.  The host prepares a
    call while the card runs the one before, so a call whose kernels take
    longer than its host work is timed by its kernels (one call alone
    between two events would count the host work before its first
    launch as well)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def graph_ms(torch, fn, calls: int = 10, reps: int = 5) -> float:
    """Milliseconds of the card's work in one call of fn(), with no host
    work: ``calls`` calls captured in one CUDA graph (after two eager
    warm-up calls), the graph replayed ``reps`` times between CUDA
    events.  A kernel's wrapper spends tens of microseconds on the host,
    as long as a small kernel runs; the sessions replay graphs, so this
    is the time the path sees."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        g.replay()
    e.record()
    e.synchronize()
    del g
    return s.elapsed_time(e) / (reps * calls)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions on synthetic inputs
# ---------------------------------------------------------------------------
def synth_plan(torch, g, dev, *, b, s, tb, blk, m, k, nlist, nid, ints,
               p_valid=0.85):
    """A consistent (store, plan, lut, rank_of, sel, live): duplicate ids,
    invalid items, misc co-assignments; ``ints`` makes integer LUTs so
    exact distance ties are everywhere; ``p_valid`` of the plan slots
    are valid."""
    from repro_torch.core.engine import BlockStore, QueryPlan

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev)
    lut = (ri(0, 3, (b, m, k)).float() if ints
           else torch.randn(b, m, k, generator=g, device=dev))
    codes = ri(0, k, (tb, blk, m)).to(torch.uint8)
    ids = ri(-1, nid, (tb, blk)).int()
    other = ri(-1, nlist, (tb, blk)).int()
    blocks = torch.stack([torch.randperm(tb, generator=g, device=dev)[:s]
                          for _ in range(b)]).int()
    ranks = torch.sort(ri(0, nlist, (b, s)), dim=1).values.int()
    valid = torch.rand(b, s, generator=g, device=dev) < p_valid
    rank_of = torch.where(torch.rand(b, nlist, generator=g, device=dev) < 0.5,
                          ri(0, nlist, (b, nlist)),
                          torch.full((b, nlist), 2 ** 30, device=dev)).int()
    sel = torch.sort(ri(0, nlist, (b, 3)), dim=1).values.int()
    live = torch.rand(nid, generator=g, device=dev) < 0.8
    store = BlockStore(codes, ids, other)
    plan = QueryPlan(blocks, ranks, valid, torch.zeros(b, dtype=torch.int32,
                                                       device=dev))
    return store, plan, lut, rank_of, sel, live


# K1 cases that reach every instantiation and grid choice of pq_scan.cu:
# (query_tile, B, S, BLK, M, K, packed); TB = 400
K1_CASES = (
    (1, 2, 1000, 32, 64, 16, False),     # main-path QT=1, long S, 2 tiles
    (8, 8, 300, 32, 64, 16, False),      # main-path QT=8, one tile
    (8, 16, 1000, 128, 64, 16, False),   # BLK 128, uneven last range
    (16, 32, 40, 32, 64, 16, False),     # QT 16 and 32: chunks of 8
    (32, 64, 40, 32, 64, 16, False),
    (64, 64, 40, 32, 64, 16, False),     # 256 KB of tables: two groups
    (1, 4, 300, 32, 64, 4, False),       # K 4: generic; K 256: k256
    (8, 16, 40, 32, 64, 4, False),
    (1, 4, 300, 32, 64, 256, False),
    (8, 8, 40, 32, 64, 256, False),      # 512 KB of tables: one launch
    (1, 2, 300, 32, 256, 256, False),    # 256 KB for one query: global
    (8, 8, 300, 32, 256, 256, False),    # tables, staged in ranges, at
    (64, 64, 40, 32, 256, 256, False),   # most 8 queries a launch
    (1, 2, 300, 24, 64, 16, False),      # BLK not a power of two
    (1, 2, 300, 32, 63, 16, True),       # packed, odd Mc
    (8, 16, 300, 32, 15, 16, True),
)
# K1 cases of the compact-plane and staged forms, and the form each must
# take: (query_tile, B, S, BLK, M, K, packed, form[, TB]); TB = 400
K1_FORM_CASES = (
    (1, 4, 301, 32, 16, 16, True, "packed"),     # pq4: MB 8, odd S
    (8, 16, 301, 32, 16, 16, True, "packed"),
    (64, 128, 77, 32, 16, 16, True, "packed"),
    (1, 4, 301, 32, 32, 16, True, "packed"),     # binary: MB 16
    (8, 16, 301, 32, 32, 16, True, "packed"),
    (64, 128, 77, 32, 32, 16, True, "packed"),
    (4, 8, 301, 32, 32, 16, True, "generic"),    # QT 4: the generic loop
    (1, 4, 301, 24, 16, 16, True, "generic"),    # BLK 24: the generic loop
    (1, 3, 301, 32, 256, 256, False, "staged"),  # M 256, K 256
    (8, 16, 301, 32, 256, 256, False, "staged"),
    (3, 6, 129, 32, 256, 256, False, "staged"),  # QT 3
    (1, 2, 77, 32, 232, 256, False, "staged"),   # M 232: one query's last
    (8, 8, 77, 32, 232, 256, False, "staged"),   # range of 16 is short
    (1, 2, 77, 32, 250, 256, False, "staged"),   # M 250: short last ranges,
    (8, 8, 77, 32, 250, 256, False, "staged"),   # rows read byte by byte
    (8, 8, 40, 32, 470, 128, False, "staged"),   # K 128
    (1, 2, 40, 32, 3701, 16, True, "staged"),    # packed, odd Mc
    (8, 8, 1100, 32, 256, 256, False, "staged"),  # 34 splits of a tile
    (8, 8, 9, 4096, 256, 256, False, "staged", 20),  # two passes a split
    # the k256 form (unpacked K 256, one query's tables in shared memory):
    # QT 1 (the table whole; rows in 16- or 8-byte pieces at M 64 / 72 /
    # 40), QT 3 / 8 / 16 / 64 (ranges of 4 subquantizers, 8 queries a CTA,
    # QT 16 and 64 in groups over the grid), M 42 (a short last range, rows
    # read byte by byte), S not a multiple of a pass, many splits, two
    # passes a split; M 60 at QT 1 keeps the generic loop
    (1, 4, 301, 32, 64, 256, False, "k256"),
    (1, 4, 301, 32, 72, 256, False, "k256"),
    (1, 2, 77, 32, 40, 256, False, "k256"),
    (3, 6, 129, 32, 64, 256, False, "k256"),
    (8, 16, 301, 32, 64, 256, False, "k256"),
    (8, 8, 77, 32, 42, 256, False, "k256"),
    (8, 8, 77, 32, 72, 256, False, "k256"),
    (16, 16, 1100, 32, 64, 256, False, "k256"),
    (64, 64, 40, 32, 64, 256, False, "k256"),
    (8, 8, 9, 4096, 64, 256, False, "k256", 20),
    (1, 4, 77, 32, 60, 256, False, "generic"),
)


def k1_case(torch, g, dev, qt, b, s, blk, m, k, packed, form=None, tb=400):
    """K1 on random tables, codes and tile lists, bitwise against its
    plain version; the case must cover what its comment says and (where
    ``form`` is given) every launch must take that form."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.pq_scan import (k1_plan, launch_counts,
                                             pq_scan_tiled_kernel,
                                             reset_launch_counts)
    from repro_torch.quant import pack_nibbles
    lut = torch.randn(b, m, k, generator=g, device=dev)
    codes = torch.randint(0, k, (tb, blk, m), generator=g,
                          device=dev).to(torch.uint8)
    if packed:
        codes = torch.from_numpy(pack_nibbles(codes.cpu().numpy())).to(dev)
    tiles = torch.randint(0, tb, (b // qt, s), generator=g, device=dev).int()
    lut_a, codes_a = ops.align(lut, codes, packed)
    ptr = codes_a.data_ptr()
    groups, s_per = k1_plan(b // qt, s, blk, lut_a.shape[1], k, qt,
                            packed=packed, codes_align=min(16, ptr & -ptr))
    splits = -(-s // s_per)
    reset_launch_counts()
    out = pq_scan_tiled_kernel(lut_a, codes_a, tiles, query_tile=qt,
                               packed=packed)
    used = launch_counts(forms=True)
    want = ref.pq_scan_tiled_ref(lut_a, codes_a, tiles, query_tile=qt,
                                 packed=packed)
    torch.cuda.synchronize()
    name = f"K1 qt={qt} B={b} S={s} blk={blk} m={m} k={k} packed={packed}"
    check(used["pq_scan_tiled_kernel"] == len(groups),
          f"{name}: not one launch per query group")
    check(form is None or used[f"pq_scan_tiled_kernel[{form}]"]
          == len(groups), f"{name}: launches by form {json.dumps(used)}, "
          f"want {form}")
    check(s < 300 or splits > 1, f"{name}: long S ran one split")
    one_query = 4 * lut_a.shape[1] * k + 4 * s_per
    check(groups.global_tables == (one_query > 232448),
          f"{name}: global tables {groups.global_tables} for {one_query} B "
          "of shared memory per query")
    check(4 * qt * lut_a.shape[1] * k <= 232448 or len(groups) > 1
          or groups.global_tables or groups.k256,
          f"{name}: oversize tables in one group")
    check(not groups.global_tables or groups.largest <= 8,
          f"{name}: a staged launch of {groups.largest} queries")
    check(torch.equal(out, want),
          f"{name} ({splits} splits of {s_per}, groups {groups}): max err "
          f"{(out - want).abs().max().item()}")


def check_kernels(torch, dev, seed):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.pq_scan import (launch_counts, merge_by_select,
                                             merge_topk_kernel,
                                             pq_scan_paged_kernel,
                                             pq_scan_tiled_kernel,
                                             reset_launch_counts)
    from repro_torch.quant import pack_nibbles
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n_k1 = 0
    # K1: query tiles, unpacked / packed (odd Mc too), BLK, M
    for qt in (1, 8, 16):
        for blk in (32, 128):
            for m in (16, 64):
                for packed in (False, True):
                    mc = m - 1 if packed else m      # odd Mc when packed
                    b, s, tb = 2 * qt, 7, 50
                    lut = torch.randn(b, mc, 16, generator=g, device=dev)
                    codes = torch.randint(0, 16, (tb, blk, mc), generator=g,
                                          device=dev).to(torch.uint8)
                    if packed:
                        codes = torch.from_numpy(
                            pack_nibbles(codes.cpu().numpy())).to(dev)
                    tiles = torch.randint(0, tb, (b // qt, s), generator=g,
                                          device=dev).int()
                    lut_a, codes_a = ops.align(lut, codes, packed)
                    out = pq_scan_tiled_kernel(lut_a, codes_a, tiles,
                                               query_tile=qt, packed=packed)
                    want = ref.pq_scan_tiled_ref(lut_a, codes_a, tiles,
                                                 query_tile=qt, packed=packed)
                    torch.cuda.synchronize()
                    check(torch.equal(out, want),
                          f"K1 qt={qt} blk={blk} m={mc} packed={packed}: "
                          f"max err {(out - want).abs().max().item()}")
                    n_k1 += 1
    log(f"kernels: K1 bitwise equal to plain version in {n_k1} cases")
    n_k1 = 0
    for case in K1_CASES:
        k1_case(torch, g, dev, *case)
        n_k1 += 1
    log(f"kernels: K1 bitwise equal to plain version in {n_k1} more cases "
        "(long S, K 4 / 16 / 256, QT 1 / 8 / 16 / 32 / 64, query groups, "
        "global tables at M 256 K 256, BLK 24 / 128, packed with odd Mc)")
    for case in K1_FORM_CASES:
        k1_case(torch, g, dev, *case)
    log(f"kernels: K1 bitwise equal to plain version, each launch in its "
        f"form, in {len(K1_FORM_CASES)} cases (packed MB 8 / 16 at QT 1 / 8 "
        "/ 64, odd S; staged at M 256 / 232 / 250 / 470 / 3701 packed, "
        "K 256 / 128 / 16, QT 1 / 3 / 8, short last ranges, two passes a "
        "split; k256 at QT 1 / 3 / 8 / 16 / 64, M 64 / 72 / 40 / 42, a "
        "short last range, many splits, two passes a split)")
    # K2: per-query rows under query_tile > 1 must raise
    lut = torch.randn(4, 16, 16, generator=g, device=dev)
    codes = torch.randint(0, 16, (9, 32, 16), generator=g,
                          device=dev).to(torch.uint8)
    rows = torch.tensor([[1, 2], [3, 4], [5, 6], [7, 8]], dtype=torch.int32,
                        device=dev)
    try:
        pq_scan_paged_kernel(lut, codes, rows, query_tile=2)
        fail("K2 accepted disagreeing tile rows")
    except ValueError as e:
        check("tile rows" in str(e), f"K2 raised the wrong error: {e}")
    shared = rows[[0, 0, 2, 2]]
    check(torch.equal(pq_scan_paged_kernel(lut, codes, shared, query_tile=2),
                      ref.pq_scan_paged_ref(lut, codes, shared)),
          "K2 shared rows disagree with the plain version")
    log("kernels: K2 raises ValueError on disagreeing tile rows")
    # K3: layouts x unpacked / packed (odd Mc) x dead tile x fetch x
    # (tie-heavy ints | random f32); one split each (S = 12)
    n_k3 = 0
    for mode in ("paged", "grouped", "clustered"):
        for packed in (False, True):
            for ints in (True, False):
                for with_dead in (False, True):
                    for fetch in (100, 200):
                        k3_case(torch, g, dev, mode=mode, packed=packed,
                                ints=ints, with_dead=with_dead, fetch=fetch,
                                qt=4, s=12, tb=40)
                        n_k3 += 1
    log(f"kernels: K3 bitwise equal to plain version in {n_k3} cases")
    # K3 split over the grid: few tiles, long S (uneven last split), plan
    # slots valid at 85% or 5% (splits that keep fewer than fetch items)
    n_split = 0
    for mode in ("paged", "grouped", "clustered"):
        for qt in (4, 8):
            for packed, ints, with_dead in ((False, True, False),
                                            (True, True, True),
                                            (False, False, True),
                                            (True, False, False)):
                for p_valid in (0.85, 0.05):
                    splits, short, _ = k3_case(
                        torch, g, dev, mode=mode, packed=packed, ints=ints,
                        with_dead=with_dead, fetch=100, qt=qt, s=300, tb=400,
                        p_valid=p_valid)
                    check(splits > 1, f"K3 split case {mode} qt={qt} ran "
                          "one split")
                    check(short or p_valid > 0.5, f"K3 split case {mode} "
                          f"qt={qt} p_valid={p_valid}: every split kept "
                          "fetch items")
                    n_split += 1
    log(f"kernels: K3 split over the grid bitwise equal to plain version "
        f"in {n_split} cases")
    # K3 where a tile's state does not fit in one CTA: QT 64 at M 64, K 16
    # (461 KB) and QT 8 at M 60, K 256 (515 KB; M 60 keeps the shared
    # form) run in query groups
    n_groups = 0
    for mode in ("grouped", "clustered"):
        for qt, b, m, k in ((64, 64, 64, 16), (8, 16, 60, 256)):
            for ints in (True, False):
                _, _, groups = k3_case(
                    torch, g, dev, mode=mode, packed=False, ints=ints,
                    with_dead=ints, fetch=100, qt=qt, s=40, tb=60, b=b, m=m,
                    k=k)
                check(len(groups) > 1 and groups.form == "shared",
                      f"K3 group case {mode} qt={qt} k={k} ran one group")
                n_groups += 1
    log(f"kernels: K3 in query groups bitwise equal to plain version in "
        f"{n_groups} cases")
    # K3's k256 form (unpacked K 256: a CTA a query of a tile, one
    # launch): QT 1 (paged) / 3 / 8 / 64, M 64 / 72 / 40 (rows in 16- and
    # 8-byte pieces), fetch 100 and 400, with and without tombstones,
    # tie-heavy and random f32, one split (S 12) and many (S 300, sparse
    # plans too)
    n_k256, k256_splits = 0, set()
    for mode, qt, b in (("paged", 1, 16), ("grouped", 3, 12),
                        ("clustered", 8, 16), ("grouped", 8, 16),
                        ("clustered", 64, 64)):
        for m, fetch, ints, with_dead, s, p_valid in (
                (64, 100, True, True, 12, 0.85),
                (64, 400, False, False, 300, 0.85),
                (72, 100, False, True, 300, 0.05),
                (40, 400, True, False, 40, 0.85)):
            splits, _, groups = k3_case(
                torch, g, dev, mode=mode, packed=False, ints=ints,
                with_dead=with_dead, fetch=fetch, qt=qt, s=s, tb=400, b=b,
                m=m, k=256, p_valid=p_valid)
            check(groups.k256 and len(groups) == 1,
                  f"K3 k256 case {mode} qt={qt} m={m}: form {groups.form}, "
                  f"{len(groups)} launches")
            k256_splits.add(min(splits, 2))
            n_k256 += 1
    check(k256_splits == {1, 2}, "K3 k256 cases: not both one split and "
          "many")
    log(f"kernels: K3's k256 form bitwise equal to plain version in {n_k256} "
        "cases (QT 1 / 3 / 8 / 64, M 64 / 72 / 40, fetch 100 / 400, "
        "tombstones, one split and many)")
    # K3 where one query's table passes a CTA's shared memory (M 256 / 264
    # / 240 at K 256: 240-264 KB): the GT form (a CTA a query, its kept
    # items listed, the table staged by range; M 264: rows in 8-byte
    # pieces and a short last range), QT 1 / 3 / 8 / 64, fetch 100 and
    # 400, tombstones or none, tie-heavy and random f32, one split (S 12 /
    # 40) and many (S 300, sparse plans too); a query of 2,000-2,600 kept
    # items in one split (B 300: one wave of CTAs, so one split): two
    # passes.  Then M 250 (not a multiple of 8): the GT-ldg form (tables
    # through __ldg), groups of up to 64 by the selection state alone
    n_global, gt_splits = 0, set()
    for mode, qt, b in (("paged", 1, 16), ("grouped", 3, 12),
                        ("clustered", 8, 16), ("grouped", 8, 16),
                        ("clustered", 64, 64)):
        for m, fetch, ints, with_dead, s, p_valid in (
                (256, 100, True, True, 12, 0.85),
                (264, 400, False, False, 300, 0.85),
                (240, 100, False, True, 300, 0.05),
                (256, 400, True, False, 40, 0.85)):
            splits, _, groups = k3_case(
                torch, g, dev, mode=mode, packed=False, ints=ints,
                with_dead=with_dead, fetch=fetch, qt=qt, s=s, tb=400, b=b,
                m=m, k=256, p_valid=p_valid)
            check(groups.form == "GT" and len(groups) == 1,
                  f"K3 GT case {mode} qt={qt} m={m}: form {groups.form}, "
                  f"{len(groups)} launches")
            gt_splits.add(min(splits, 2))
            n_global += 1
    check(gt_splits == {1, 2}, "K3 GT cases: not both one split and many")
    for ints in (True, False):
        splits, _, groups = k3_case(
            torch, g, dev, mode="paged", packed=False, ints=ints,
            with_dead=False, fetch=100, qt=1, s=120, tb=400, b=300, m=256,
            k=256, p_valid=0.95)
        check(groups.form == "GT" and splits == 1, f"K3 GT two-pass case: "
              f"form {groups.form}, {splits} splits")
        n_global += 1
    for mode in ("paged", "grouped", "clustered"):
        _, _, groups = k3_case(
            torch, g, dev, mode=mode, packed=False, ints=True,
            with_dead=True, fetch=100, qt=8, s=40, tb=60, b=16, m=250,
            k=256)
        check(groups.form == "GT-ldg", f"K3 GT-ldg case {mode}: form "
              f"{groups.form}")
        n_global += 1
    log(f"kernels: K3 with global tables bitwise equal to plain version in "
        f"{n_global} cases (GT at QT 1 / 3 / 8 / 64, M 256 / 264 / 240, "
        "fetch 100 / 400, tombstones, one split and many, two passes a "
        "query; GT-ldg at M 250)")
    # K3 where one query's selection arrays pass a CTA's shared memory
    # (fetch above 8192): the candidate-row form, a scan to rows and a row
    # select, with the tables in shared memory (M 16 / 15) or global memory
    # (M 256, K 256); fetch 9000, 16000, the whole plan width (400 slots of
    # 32 lanes) and, over a long S (1600 slots), 40000 (survivors beyond a
    # CTA's shared memory); the scan to rows held alone too
    n_rows = 0
    for mode in ("paged", "grouped", "clustered"):
        for packed, ints, with_dead, m, k, fetch, s, tb in (
                (False, True, False, None, 16, 9000, 400, 600),
                (True, False, True, None, 16, 16000, 400, 600),
                (False, True, True, 256, 256, 9000, 400, 600),
                (False, True, False, None, 16, 400 * 32, 400, 600),
                (True, True, True, None, 16, 40000, 1600, 2000)):
            _, _, groups = k3_case(
                torch, g, dev, mode=mode, packed=packed, ints=ints,
                with_dead=with_dead, fetch=fetch, qt=4, s=s, tb=tb, b=8, m=m,
                k=k, timed=k == 256)
            check(groups.global_state and groups.global_tables == (k == 256),
                  f"K3 row case {mode} m={m} fetch={fetch}: form global "
                  f"tables {groups.global_tables}, global state "
                  f"{groups.global_state}")
            n_rows += 1
    log(f"kernels: K3's candidate-row form (scan to rows, then the row "
        f"select; fetch 9000 / 16000 / the plan width / 40000) bitwise equal "
        f"to the plain K3 in {n_rows} cases, its scan to rows to "
        "scan_rows_ref")
    # the row select alone: rows longer than shared memory, fills below the
    # width with garbage past them, tie-heavy and signed-zero distances,
    # fetch from 400 to 40000 (survivors in the scratch tensor)
    n_sel = 0
    for b, w, fetch, fill, zeros in ((64, 17792, 400, True, False),
                                     (64, 17792, 16000, True, True),
                                     (16, 336000, 16000, False, True),
                                     (8, 120000, 40000, True, False),
                                     (8, 30000, 40000, True, True),
                                     (4, 5000, 9000, False, False),
                                     (3, 100, 1, True, True)):
        select_case(torch, g, dev, b, w, fetch, fill, zeros)
        n_sel += 1
    log(f"kernels: row select bitwise equal to select_topk_ref in {n_sel} "
        "cases (rows up to 336000 entries, fetch 1 to 40000, -0.0 beside "
        "+0.0)")
    # the merge alone: random ascending lists, tie-heavy (integer
    # distances, -0.0 beside +0.0) or random f32, 30% pads or pad-heavy
    # (each list holds fewer real entries than fetch); the shapes of a
    # 4-CTA-a-SM split (66 lists of 100 / 400 at B=64, 5 lists at B=1024)
    # and of the path's (fewer lists) among them, the former timed; where
    # the keys of one query pass a CTA's shared memory it runs the row
    # select over the concatenated lists
    n_merge = 0
    for b, splits, fetch, pads, ints in (
            (1, 2, 1, 0.3, True), (7, 5, 100, 0.3, True),
            (64, 66, 100, 0.3, True), (64, 66, 100, 0.7, True),
            (64, 66, 400, 0.3, True), (64, 66, 400, 0.6, True),
            (1024, 5, 100, 0.3, True), (1024, 5, 400, 0.3, True),
            (1024, 5, 400, 0.9, True), (64, 99, 100, 0.3, True),
            (64, 33, 400, 0.6, True), (1024, 2, 400, 0.3, True),
            (1024, 3, 100, 0.3, True), (16, 3, 200, 1.0, True),
            (3, 300, 37, 0.3, True), (2, 6, 3000, 0.3, True),
            (8, 3, 9000, 0.3, True), (64, 21, 16000, 0.3, True),
            (4, 3, 40000, 0.3, True), (64, 66, 100, 0.3, False),
            (64, 66, 400, 0.3, False), (1024, 5, 100, 0.3, False),
            (1024, 5, 400, 0.3, False)):
        parts = sorted_lists(torch, g, dev, b, splits, fetch, pads, ints)
        reset_launch_counts()
        got = merge_topk_kernel(*parts)
        used = launch_counts()
        want = ref.merge_topk_ref(*parts)
        torch.cuda.synchronize()
        select = merge_by_select(splits, fetch)
        check(not select or splits * fetch > 26400,
              f"merge b={b} splits={splits} fetch={fetch}: the row select "
              "at a shape the path merges with topk_merge")
        check(used["merge_topk_kernel"] == int(not select)
              and used["select_topk_kernel"] == int(select),
              f"merge b={b} splits={splits} fetch={fetch}: launches "
              f"{json.dumps(used)}")
        for name, x, y in zip(("acc_d", "acc_pos", "acc_id"), got, want):
            check(torch.equal(x, y), f"merge b={b} splits={splits} "
                  f"fetch={fetch} pads={pads} ints={ints}: {name} differs")
        check(torch.equal(torch.signbit(got[0]), torch.signbit(want[0])),
              f"merge b={b} splits={splits} fetch={fetch}: signs of zero "
              "differ")
        if (b, splits, fetch) == (64, 21, 16000):
            time_merge(torch, parts, "timing: the wide grouped batch's "
                       "merge shape")
        if not ints:
            time_merge(torch, parts, "timing: the merge on random f32 "
                       "lists at the shapes of a 4-CTA-a-SM split")
        n_merge += 1
    log(f"kernels: K3 merge bitwise equal to plain version in {n_merge} "
        "cases (64 x 66 x 100 / 400, 1024 x 5 x 100 / 400 and the path's "
        "shapes, with 30% and with most entries pads, tie-heavy with -0.0 "
        "beside +0.0 and random f32; fetch 9000, 16000 and 40000 through "
        "the row select, rows up to 336000 entries)")


def encode_ties(torch, books, x, got, want, what, share=ENCODE_DIFF_SHARE):
    """(row, subquantizer) pairs where the encode kernel's codes ``got``
    differ from ``want``: at most ``share`` of the codes (rounded up;
    None: any number), each an f32 tie.  One f32 distance (x2 - 2 xc) +
    c2 over dsub products, summed in any order, is off by at most
    (2 dsub + 5) u (|x|^2 + |c|^2), u = 2^-24 (the package turns TF32
    off), so two encoders may pick either of two centroids whose f64
    distances to the row's slice lie within twice that: (4 dsub + 10) u
    of |x|^2 + the larger |c|^2 of the two.  Returns (pairs, largest gap
    relative to that scale)."""
    rows, cols = torch.nonzero(got != want, as_tuple=True)
    if share is not None:
        cap = math.ceil(share * got.numel())
        check(rows.numel() <= cap, f"{what}: {rows.numel()} of "
              f"{got.numel()} codes differ, more than {cap}")
    if rows.numel() == 0:
        return 0, 0.0
    dsub = books.shape[2]
    b64 = books.double()
    xs = x.double().reshape(x.shape[0], -1, dsub)[rows, cols]   # (P, dsub)
    cg = b64[cols, got[rows, cols].long()]                      # (P, dsub)
    cw = b64[cols, want[rows, cols].long()]
    scale = (xs * xs).sum(dim=1) + torch.maximum((cg * cg).sum(dim=1),
                                                 (cw * cw).sum(dim=1))
    gap = (((cg - xs) ** 2).sum(dim=1)
           - ((cw - xs) ** 2).sum(dim=1)).abs() / scale
    worst = float(gap.max())
    bad = int(gap.argmax())
    r, j = int(rows[bad]), int(cols[bad])
    check(worst <= (4 * dsub + 10) * 2.0 ** -24, f"{what}: row {r}, "
          f"subquantizer {j}: kernel code {int(got[r, j])}, other "
          f"{int(want[r, j])}, relative gap {worst:.3e}: not an f32 tie")
    return rows.numel(), worst


def encode_hold(torch, dev, seed):
    """The PQ encode kernel (``ops.pq_encode``) against its plain version
    (``pq_encode_plain``, run on the card) at ``ENCODE_SHAPES``: codes
    equal except at f32 ties (``encode_ties``), one launch a call, rows
    encoded alone, in ``ENCODE_SIZES`` batches and inside the largest
    bitwise alike; timed at ``ENCODE_TIMED`` rows (graph replays, and
    eager calls back to back) beside its byte bound and the plain
    version (eager: its launches are its cost)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.pq_scan import pq_encode_kernel as kern
    from repro_torch.kernels.ref import pq_encode_plain
    rows = {}
    for i, (what, (m, k, dsub)) in enumerate(ENCODE_SHAPES.items()):
        g = torch.Generator(device=dev).manual_seed(seed + i)
        n_max = max(ENCODE_SIZES)
        books = torch.randn((m, k, dsub), generator=g, device=dev)
        books[:, k - 1] = books[:, k // 2]     # a tie: the lower code wins
        x = torch.randn((n_max, m * dsub), generator=g, device=dev)
        x[::7, :dsub] = books[0, 3]            # rows on a centroid
        whole = ops.pq_encode(books, x)
        torch.cuda.synchronize()
        check(not bool((whole == k - 1).any()), f"encode {what}: the "
              f"duplicate centroid {k - 1} won over {k // 2}")
        planted = whole[::7].clone()
        planted[:, 0] = 3
        encode_ties(torch, books, x[::7], whole[::7], planted,
                    f"encode {what}: a row on centroid 3 of subquantizer 0",
                    share=None)
        for n in ENCODE_SIZES:
            before = kern.launches
            got = ops.pq_encode(books, x[:n])
            want = pq_encode_plain(books, x[:n])
            torch.cuda.synchronize()
            check(kern.launches == before + 1,
                  f"encode {what} n={n}: not one launch")
            check(torch.equal(got, whole[:n]), f"encode {what} n={n}: codes "
                  f"differ from the same rows encoded inside n={n_max}")
            diff, worst = encode_ties(torch, books, x[:n], got, want,
                                      f"encode {what} n={n}")
            line = (f"encode {what} n={n}: kernel codes bitwise those of the "
                    f"same rows inside n={n_max}; {diff} of {got.numel()} "
                    f"differ from the plain version, each an f32 tie "
                    f"(largest relative gap {worst:.2e})")
            if n in ENCODE_TIMED:
                ms = graph_ms(torch, lambda: ops.pq_encode(books, x[:n]))
                eager = cuda_ms(torch, lambda: ops.pq_encode(books, x[:n]))
                plain = cuda_ms(torch, lambda: pq_encode_plain(books, x[:n]),
                                reps=5, warm=1)
                nbytes = n * m * dsub * 4 + n * m + m * k * dsub * 4
                bms, by = bound_ms(nbytes, 2 * n * m * k * dsub)
                line += (f"; {ms:.4f} ms (graph replays), {eager:.4f} ms "
                         f"eager, bound {bms:.4f} ms ({by}; {nbytes} B), "
                         f"plain {plain:.4f} ms eager")
                rows[(what, n)] = dict(ms=ms, plain_ms=plain, bound_ms=bms,
                                       bound_by=by, eager_ms=eager)
            log(line)
        alone = torch.cat([ops.pq_encode(books, x[r:r + 1])
                           for r in (0, 37, n_max - 1)])
        check(torch.equal(alone, whole[[0, 37, n_max - 1]]),
              f"encode {what}: a row encoded alone differs")
        del books, x, whole
    return rows


def time_merge(torch, parts, what, err=0.0):
    """K3's merge on (B, splits, fetch) lists, timed beside its plain
    version, its bound (each list's d and pos read once, the ids of the
    real survivors only, the top-fetch written once; one comparison a
    candidate) and one torch.topk over the flattened distances.  Returns
    the kernel row (``err``: its max abs error, held elsewhere)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pq_scan import merge_topk_kernel
    from repro_torch.kernels.topk import PAD_POS
    b, splits, fetch = parts[0].shape
    ms = graph_ms(torch, lambda: merge_topk_kernel(*parts))
    pms = cuda_ms(torch, lambda: ref.merge_topk_ref(*parts), reps=3, warm=1)
    lms = topk_ms(torch, parts[0].reshape(b, -1), fetch)
    reals = (parts[1] != PAD_POS).reshape(b, -1).sum(dim=1)
    survivors = int(reals.clamp(max=fetch).sum().item())
    nbytes = parts[0].numel() * 8 + survivors * 4 + b * fetch * 12
    bms, by = bound_ms(nbytes, parts[0].numel())
    log(f"{what}: K3 merge B={b}, {splits} lists of {fetch}: "
        f"{ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms ({by}; "
        f"{nbytes} B), one torch.topk over the (B, splits * fetch) lists "
        f"{lms:.4f} ms (ties may come in another order)")
    return dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                max_abs_err=err, library_ms=lms)


def select_case(torch, g, dev, b, w, fetch, fill, zeros):
    """The row select on random (b, w) rows, bitwise against
    select_topk_ref: integer distances (ties everywhere), -0.0 beside
    +0.0 when ``zeros`` (and rows 0 and 1 alike but for the signs of
    their zeros), pos unique in a row, and with ``fill`` a random fill
    per row, the entries past it garbage."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pq_scan import (launch_counts,
                                             reset_launch_counts,
                                             select_topk_kernel)
    d = torch.randint(-3, 4, (b, w), generator=g, device=dev).float()
    pos = (torch.rand(b, 2 * w, generator=g, device=dev)
           .argsort(dim=1)[:, :w].int())
    if zeros:
        neg = torch.rand(b, w, generator=g, device=dev) < 0.5
        d = torch.where((d == 0) & neg, -0.0, d)
        # rows 0 and 1: the same entries, zeros -0.0 in one, +0.0 in the
        # other
        d[1], pos[1] = torch.where(d[0] == 0, 0.0, d[0]), pos[0]
        d[0] = torch.where(d[0] == 0, -0.0, d[0])
    ids = torch.randint(0, 1 << 20, (b, w), generator=g, device=dev).int()
    n = None
    if fill:
        n = torch.randint(0, w + 1, (b,), generator=g, device=dev).int()
        n[0] = w
        past = torch.arange(w, device=dev)[None, :] >= n[:, None]
        d = torch.where(past, torch.nan, d)
        pos = torch.where(past, -7, pos)
    reset_launch_counts()
    got = select_topk_kernel(d, pos, ids, n, fetch=fetch)
    used = launch_counts()
    want = ref.select_topk_ref(d, pos, ids, n, fetch=fetch)
    torch.cuda.synchronize()
    name = f"select b={b} w={w} fetch={fetch} fill={fill} zeros={zeros}"
    check(used["select_topk_kernel"] == 1, f"{name}: launches "
          f"{json.dumps(used)}")
    for what, x, y in zip(("acc_d", "acc_pos", "acc_id"), got, want):
        check(torch.equal(x, y), f"{name}: {what} differs")
    check(torch.equal(torch.signbit(got[0]), torch.signbit(want[0])),
          f"{name}: signs of zero differ")


def k3_case(torch, g, dev, *, mode, packed, ints, with_dead, fetch, qt, s,
            tb, p_valid=0.85, b=16, m=None, k=16, timed=False):
    """K3 on one synthetic plan in ``mode``, bitwise against its plain
    version (``timed``: then timed, a graph replay, beside its plain
    version and its bound).  Returns (splits, whether some split keeps
    < fetch items, query groups of a tile)."""
    from repro_torch.core.engine import fused_scan_args
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.pq_scan import (k3_query_groups, launch_counts,
                                             merge_by_select,
                                             pq_scan_topk_kernel,
                                             reset_launch_counts, topk_width)
    from repro_torch.kernels.topk import PAD_POS
    from repro_torch.quant import pack_nibbles
    store, plan, lut, rank_of, sel, live = synth_plan(
        torch, g, dev, b=b, s=s, tb=tb, blk=32,
        m=m or (15 if packed else 16), k=k, nlist=10, nid=300, ints=ints,
        p_valid=p_valid)
    if packed:
        store = store._replace(block_codes=torch.from_numpy(
            pack_nibbles(store.block_codes.cpu().numpy())).to(dev))
    lut_x, tiles, rank_x, slot_of, rank_u, qt, _ = fused_scan_args(
        store, plan, lut, rank_of, exec_mode=mode, query_tile=qt, sel=sel)
    lut_a, codes_a = ops.align(lut_x, store.block_codes, packed)
    dead = None
    if with_dead:
        ids = store.block_ids
        dead = ((ids >= 0) & ~live[ids.clamp_min(0).long()]).to(torch.uint8)
    args = (lut_a, codes_a, store.block_ids, store.block_other,
            tiles.contiguous(), rank_x.contiguous(), slot_of.contiguous(),
            rank_u.contiguous(), dead)
    kw = dict(query_tile=qt, fetch=fetch, packed=packed)
    fw, blk = topk_width(fetch), codes_a.shape[1]
    ptr = codes_a.data_ptr()
    groups = k3_query_groups(lut_a.shape[1], k, qt, fw, blk, packed=packed,
                             codes_align=min(16, ptr & -ptr))
    splits, s_per = k3_grid(groups, tiles, lut_a.shape[1], k, fw, blk, packed)
    reset_launch_counts()
    got = pq_scan_topk_kernel(*args, **kw, plan_width=s)
    used = launch_counts()
    forms = launch_counts(forms=True)
    check(forms[f"pq_scan_topk_kernel[{groups.form}]"] == len(groups),
          f"K3 {mode} qt={qt} fetch={fetch}: launches by form "
          f"{json.dumps(forms)}, want {len(groups)} {groups.form}")
    merged = splits > 1 and not groups.global_state
    by_select = merged and merge_by_select(splits, fetch)
    want_used = {"pq_scan_topk_kernel": len(groups),
                 "merge_topk_kernel": int(merged and not by_select),
                 "select_topk_kernel": int(groups.global_state or by_select)}
    check(all(used[n] == want_used.get(n, 0) for n in used),
          f"K3 {mode} qt={qt} fetch={fetch}: launches {json.dumps(used)}, "
          f"want {json.dumps(want_used)}")
    want = ref.pq_scan_topk_ref(*args, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("acc_d", "acc_pos", "acc_id", "dco"), got, want):
        check(torch.equal(x, y), f"K3 {mode} qt={qt} S={tiles.shape[1]} "
              f"packed={packed} ints={ints} dead={with_dead} fetch={fetch} "
              f"p_valid={p_valid}: {name} differs")
    if groups.global_state:
        hold_rows(torch, args, dict(query_tile=qt, packed=packed), s,
                  f"K3 rows {mode} qt={qt} fetch={fetch}")
    if timed:
        ms = graph_ms(torch, lambda: pq_scan_topk_kernel(*args, **kw,
                                                         plan_width=s))
        pms = cuda_ms(torch, lambda: ref.pq_scan_topk_ref(*args, **kw),
                      reps=3, warm=1)
        nbytes, ops = k3_bound(torch, args, fetch)
        bms, by = bound_ms(sum(nbytes.values()), ops)
        log(f"kernels: K3 {mode} B={b} S={s} QT={qt} M={lut_a.shape[1]} "
            f"K={k} fetch={fetch} in form {groups.form}, global tables "
            f"{groups.global_tables}, candidate rows {groups.global_state}: "
            f"{ms:.4f} ms (graph replay), plain {pms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}; {sum(nbytes.values())} B = "
            f"{json.dumps(nbytes)}; {ops} adds)")
    short = splits > 1 and any(
        bool((p[1] == PAD_POS).any())
        for p in split_parts(torch, args, kw, splits, s_per))
    return splits, short, groups


def k3_grid(groups, tiles, m, k, fw, blk, packed):
    """K3's (splits, s_per) over ``tiles`` in ``groups``' form, as its
    wrapper picks them (kernels/pq_scan.py::k3_wave_splits)."""
    from repro_torch.kernels.pq_scan import k3_wave_splits
    return k3_wave_splits(groups, *tiles.shape, m, k,
                          0 if groups.global_state else fw, blk, packed,
                          tiles.device)


def hold_rows(torch, args, kw, plan_width, what):
    """K3's scan to rows (pq_scan_rows_kernel) against scan_rows_ref: the
    same fills and DCO, and the same triples once each row's first
    row_n entries are put in pos order (the kernel appends in no
    particular order)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pq_scan import pq_scan_rows_kernel
    from repro_torch.kernels.topk import PAD_POS
    got = pq_scan_rows_kernel(*args, **kw, plan_width=plan_width)
    want = ref.scan_rows_ref(*args, **kw, plan_width=plan_width)
    torch.cuda.synchronize()
    for name, x, y in (("row_n", got[3], want[3]), ("dco", got[4], want[4])):
        check(torch.equal(x, y), f"{what}: {name} differs from scan_rows_ref")
    check(got[0].shape == want[0].shape, f"{what}: rows {tuple(got[0].shape)}"
          f", want {tuple(want[0].shape)}")
    past = (torch.arange(got[0].shape[1], device=got[0].device)[None, :]
            >= got[3][:, None])
    pos = torch.where(past, PAD_POS, got[1])
    order = torch.sort(pos, dim=1, stable=True).indices
    for name, x, y, pad in (("row_d", got[0], want[0], torch.inf),
                            ("row_pos", pos, want[1], PAD_POS),
                            ("row_id", got[2], want[2], -1)):
        x = torch.where(past, pad, x).gather(1, order)
        check(torch.equal(x, y), f"{what}: {name} differs from scan_rows_ref"
              " (in pos order)")


def split_parts(torch, args, kw, splits, s_per):
    """The plain K3 of each of the kernel's ranges of scan positions,
    stacked to (B, splits, fetch): what the merge kernel takes."""
    from repro_torch.kernels import ref
    lut, codes, ids, other, tiles, rank_of, slot_of, rank_u, dead = args
    s = tiles.shape[1]
    parts = []
    for y in range(splits):
        lo, hi = y * s_per, min(s, (y + 1) * s_per)
        parts.append(ref.pq_scan_topk_ref(
            lut, codes, ids, other, tiles[:, lo:hi].contiguous(), rank_of,
            slot_of[:, lo:hi].contiguous(), rank_u[:, lo:hi].contiguous(),
            dead, **kw))
    return tuple(torch.stack([p[i] for p in parts], dim=1).contiguous()
                 for i in range(3))


def sorted_lists(torch, g, dev, b, splits, fetch, pads=0.3, ints=True):
    """(B, splits, fetch) (d, pos, id) lists, each ascending by (d, pos)
    with pads last: integer distances (zeros of either sign; random f32
    in [0, 1) unless ``ints``), pos unique in a row, a share ``pads`` of
    the entries pads."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk import PAD_POS
    n = splits * fetch
    d = torch.randint(-1, 4, (b, n), generator=g, device=dev).float()
    neg = torch.rand(b, n, generator=g, device=dev) < 0.5
    d = torch.where((d == 0) & neg, -0.0, d)
    if not ints:
        d = torch.rand(b, n, generator=g, device=dev)
    pos = torch.rand(b, 4 * n, generator=g, device=dev).argsort(dim=1)[:, :n]
    idx = torch.randint(-1, 50, (b, n), generator=g, device=dev)
    pad = torch.rand(b, n, generator=g, device=dev) < pads
    d = torch.where(pad, torch.inf, d)
    pos = torch.where(pad, PAD_POS, pos).int()
    idx = torch.where(pad, -1, idx).int()
    lists = ref.merge_topk_ref(*(x.reshape(b * splits, 1, fetch)
                                 for x in (d, pos, idx)))
    return tuple(x.reshape(b, splits, fetch).contiguous() for x in lists)


# ---------------------------------------------------------------------------
# phase 5: kernels at the main path's shapes, with bounds
# ---------------------------------------------------------------------------
SECTOR = 32            # bytes of one L2 / device-memory sector


def sector_bytes(torch, byte_offsets) -> int:
    """Bytes of the distinct sectors that hold these byte offsets."""
    return torch.unique(byte_offsets // SECTOR).numel() * SECTOR


def k1_bound(torch, args):
    """Bytes K1 must move, by input, and its adds: the tables, each
    distinct code tile once, the tile lists, the (B, S, BLK) output."""
    lut, codes, tiles = args
    b, m, _ = lut.shape
    _, s = tiles.shape
    _, blk, mb = codes.shape
    nbytes = {"lut": lut.numel() * 4,
              "codes": torch.unique(tiles).numel() * blk * mb,
              "tile_idx": tiles.numel() * 4, "out": b * s * blk * 4}
    return nbytes, b * s * blk * m


def k3_bound(torch, args, fetch):
    """Bytes K3 must move, by input, and its adds, on this run's data:
    the ids of every paged block; the co-list of each valid item
    (item_ok); the rank_of sectors those co-lists point at; the code
    rows of the kept items only; the (B, fetch) triples and the DCO."""
    (lut, codes, ids, other, tiles, rank_of, slot_of, rank_u, dead) = args
    b, m, _ = lut.shape
    t, _ = tiles.shape
    _, blk, mb = codes.shape
    nlist = rank_of.shape[1]
    tl = tiles.long().repeat_interleave(b // t, dim=0)             # (B, S)
    item = tl[:, :, None] * blk + torch.arange(blk, device=tl.device)
    idb, ob = ids.reshape(-1)[item], other.reshape(-1)[item]
    ok = (idb >= 0) & (slot_of >= 0)[:, :, None]
    co = ok & (ob >= 0)
    cell = (torch.arange(b, device=tl.device)[:, None, None] * nlist
            + ob.clamp_min(0).long())
    dup = co & (rank_of.reshape(-1)[cell] < rank_u[:, :, None])
    keep = ok & ~dup
    if dead is not None:
        keep &= dead.reshape(-1)[item] == 0
    nbytes = {"lut": lut.numel() * 4,
              "block_ids": torch.unique(tl).numel() * blk * 4,
              "block_other": sector_bytes(torch, item[ok] * 4),
              "rank_of": sector_bytes(torch, cell[co] * 4),
              "codes": torch.unique(item[keep]).numel() * mb,
              "tile_idx": tiles.numel() * 4,
              "slot_of": slot_of.numel() * 4, "rank_u": rank_u.numel() * 4,
              "out": b * fetch * 12 + b * 4}
    if dead is not None:
        nbytes["dead"] = torch.unique(item[ok & ~dup]).numel()
    return nbytes, int(keep.sum().item()) * m


def bound_ms(nbytes, ops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def batch_inputs(index, queries, **params):
    """The main path's params (``params`` override SEARCH), K3's fetch
    and the stage inputs of one batch, as ``seil_search`` makes them in
    a session with these params (with ``refine``, over the compact
    plane's codes and codec, at the widened fetch)."""
    from repro_torch.core.engine import (plan_blocks, select_lists,
                                         store_from_arrays, tables_from_arrays)
    from repro_torch.core.pq import pq_lut
    from repro_torch.core.search import finalize_fetch
    sess = index.searcher(**dict(SEARCH, **params), device=index.device)
    p = sess.params
    arrays, codebook, _ = sess._scan_state()
    fetch = finalize_fetch(p.bigk_eff, index.result_oversample,
                           index.needs_result_dedup)
    tables = tables_from_arrays(arrays)
    sel = select_lists(queries, index.centroids, nprobe=p.nprobe)
    plan = plan_blocks(tables, sel, max_scan=p.max_scan)
    lut = pq_lut(codebook, queries)
    return p, fetch, tables, store_from_arrays(arrays), sel, plan, lut


def stage_breakdown(torch, index, queries, tag="stages", **params):
    """Median CUDA-event time of each seil_search stage for one batch,
    per exec mode at its main-path batch size, fused off and on: where a
    batch's device time goes (``params`` override SEARCH; with
    ``refine``, the scan stages over the compact plane)."""
    from repro_torch.core.engine import (finalize_candidates, plan_blocks,
                                         scan_blocks, scan_blocks_topk,
                                         select_lists)
    from repro_torch.core.pq import pq_lut
    _, codebook, packed = index.searcher(
        **dict(SEARCH, **params), device=index.device)._scan_state()
    for mode, bsz in RUNS:
        q = queries[:bsz].contiguous()
        p, fetch, tables, store, sel, plan, lut = batch_inputs(index, q,
                                                               **params)
        base = {
            "select": cuda_ms(torch, lambda: select_lists(
                q, index.centroids, nprobe=p.nprobe), reps=5, warm=1),
            "plan": cuda_ms(torch, lambda: plan_blocks(
                tables, sel, max_scan=p.max_scan), reps=5, warm=1),
            "lut": cuda_ms(torch, lambda: pq_lut(codebook, q), reps=5,
                           warm=1),
        }
        for fused in (False, True):
            if fused:
                def scan():
                    return scan_blocks_topk(
                        store, plan, lut, sel.rank_of, fetch=fetch,
                        exec_mode=mode, query_tile=p.query_tile,
                        sel=sel.sel, packed=packed)
            else:
                def scan():
                    return scan_blocks(store, plan, lut, sel.rank_of,
                                       exec_mode=mode,
                                       query_tile=p.query_tile, sel=sel.sel,
                                       packed=packed)
            out = scan()
            times = dict(base)
            times["scan"] = cuda_ms(torch, scan, reps=5, warm=1)
            times["finalize"] = cuda_ms(torch, lambda: finalize_candidates(
                out.flat_d, out.flat_i, bigk=p.bigk_eff, k=p.k,
                vectors=index.vectors, queries=q, metric="l2",
                dedup_results=index.needs_result_dedup,
                oversample=index.result_oversample), reps=5, warm=1)
            del out
            total = sum(times.values())
            log(f"{tag}: {mode:9s} fused={int(fused)} B={bsz} "
                f"total {total:.4f} ms: " + ", ".join(
                    f"{k} {v:.4f} ms ({100 * v / total:.1f}%)"
                    for k, v in times.items()))


def scan_inputs(index, fetch, store, plan, lut, rank_of, sel, mode,
                query_tile, perm=None, unions=None):
    """K1's and K3's inputs in ``mode`` for one planned batch:
    ``(k1_args, k3_args, query_tile, fetch, plan_width)``.  K1's inputs in each mode
    are K3's: per-tile scan lists in scan order (scan_blocks and
    scan_blocks_topk build the same ones); ``perm`` / ``unions`` as a
    plan_reuse session passes them."""
    from repro_torch.core.engine import fused_scan_args
    lx, tiles, rx, slot_of, rank_u, qt, _ = fused_scan_args(
        store, plan, lut, rank_of, exec_mode=mode, query_tile=query_tile,
        sel=sel, perm=perm, unions=unions)
    lx, tiles, codes = lx.contiguous(), tiles.contiguous(), store.block_codes
    fetch = min(fetch, plan.blocks.shape[1] * codes.shape[1])
    k3 = (lx, codes, store.block_ids, store.block_other, tiles,
          rx.contiguous(), slot_of.contiguous(), rank_u.contiguous(), None)
    return (lx, codes, tiles), k3, qt, fetch, plan.blocks.shape[1]


def mode_inputs(index, queries, mode, **params):
    """K1's and K3's inputs at one batch of ``mode`` as the main path
    makes them (``params`` override SEARCH): ``(k1_args, k3_args,
    query_tile, fetch, plan_width)``."""
    p, fetch, _, store, sel, plan, lut = batch_inputs(index, queries,
                                                      **params)
    return scan_inputs(index, fetch, store, plan, lut, sel.rank_of, sel.sel,
                       mode, p.query_tile)


def reuse_inputs(torch, index, q, mode, bsz):
    """K1's and K3's inputs (mode_inputs' tuple) at a batch of the
    ``mode`` plan_reuse session (fused off) whose scanned unions the plan
    cache widened beyond the batch's own.  After the session's run over
    ``q`` its cache holds the last batches' tiles; windows of ``q``
    shifted against them by eighths of a batch (drifting traffic: the
    same queries, other tile boundaries) are probed and merged by the
    session, as its dispatch does, until one scans a widened union."""
    from repro_torch.core.engine import store_from_arrays, union_live
    from repro_torch.core.graphs import clone_tensors
    from repro_torch.core.search import finalize_fetch
    sess = session(index, mode, bsz, False, plan_reuse=True)
    p = sess.params
    n = q.shape[0]
    for s in range(n - bsz - bsz // 8, -1, -(bsz // 8)):
        _, pr, unions = sess._probe_merge(bsz, q[s:s + bsz].contiguous())
        if bool((union_live(unions) > union_live(pr.unions)).any()):
            break
    else:
        fail(f"plan reuse {mode}: no batch scanned a widened union")
    pr = clone_tensors(pr)          # the probe graph's outputs, kept
    log(f"main, plan reuse {mode}: queries [{s}, {s + bsz}) scan "
        f"{int(union_live(unions).sum())} union entries, its own "
        f"{int(union_live(pr.unions).sum())}, at width {unions.shape[1]} "
        f"of {pr.unions.shape[1]}")
    fetch = finalize_fetch(p.bigk, index.result_oversample,
                           index.needs_result_dedup)
    return scan_inputs(index, fetch, store_from_arrays(index.arrays),
                       pr.plan, pr.lut, pr.rank_of, pr.sel, mode,
                       p.query_tile, perm=pr.perm, unions=unions)


def union_fill(index, queries, mode) -> float:
    """The share of K1's scan positions in ``mode`` (grouped or
    clustered) that are union padding clamped to block 0 (scan.py's
    ``_safe``): K1 scores them and nothing reads them."""
    from repro_torch.core.engine import (BIG, batch_union, cluster_order,
                                         tile_unions, union_dims)
    p, _, _, store, sel, plan, _ = batch_inputs(index, queries)
    b, s = plan.blocks.shape
    tb = store.block_codes.shape[0]
    if mode == "grouped":
        u = batch_union(plan, tb)
    else:
        perm = cluster_order(sel.sel).long()
        t, w = union_dims(b, s, tb, mode, p.query_tile)
        u = tile_unions(plan.blocks[perm], plan.valid[perm], t, w)
    return (u >= BIG).float().mean().item()


def lookup_rate(torch) -> float:
    """Table lookups a second if every SM serves one 4-byte shared-memory
    read per lane (32) per clock at its maximum clock: the floor of a
    scan whose work is its lookups."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"timing: lookup floor at 32 lookups a clock on each of {sms} SMs "
        f"at {mhz} MHz")
    return 32 * sms * float(mhz) * 1e6


def hold_kernels(torch, index, queries, mode, what, global_tables=None,
                 global_state=False, form=None, k3_form=None, **params):
    """hold_inputs at one batch of ``mode`` as the search path makes it
    (``params`` override SEARCH; with ``refine``, over the compact
    plane's packed codes)."""
    sess = index.searcher(**dict(SEARCH, **params), device=index.device)
    return hold_inputs(torch, mode_inputs(index, queries, mode, **params),
                       mode, what, global_tables, global_state,
                       packed=sess._scan_state()[2], form=form,
                       k3_form=k3_form)


def hold_inputs(torch, inputs, mode, what, global_tables=None,
                global_state=False, packed=False, form=None, k3_form=None):
    """K1 and K3 on ``inputs`` (mode_inputs' tuple; ``packed`` codes of a
    compact plane), with the launch counts set to 0 before each: each
    launched once per query group, K1 in the form ``form`` names (when
    given: every launch), K3 in the form ``k3_form`` names (when given),
    in the table form ``global_tables``
    names (when given) and K3 in the form ``global_state`` names (its
    candidate-row form: one scan per query group and one row select),
    and bitwise equal to its plain version; in that form the scan to rows
    alone equal to scan_rows_ref; where the shared form splits, its merge
    bitwise equal to merge_topk_ref and to the unsplit plain K3.  Returns
    ``(k1_args, k3_args, query_tile, fetch, max_abs_err by kernel, merge
    inputs or None, (K1's groups, K3's groups), packed, plan_width)``."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.pq_scan import (
        k1_plan, k3_query_groups, k3_wave, launch_counts, merge_by_select,
        merge_topk_kernel, pq_scan_tiled_kernel, pq_scan_topk_kernel,
        reset_launch_counts, topk_width)
    k1, k3, qt, fetch, pw = inputs
    if packed:            # the tables as ops pads them for a packed plane
        lut, _ = ops.align(k1[0], k1[1], True)
        k1, k3 = (lut,) + k1[1:], (lut,) + k3[1:]
    lut, codes, tiles = k1
    (b, m, k), (t, s), blk = lut.shape, tiles.shape, codes.shape[1]
    fw = topk_width(fetch)
    ptr = codes.data_ptr()
    align = min(16, ptr & -ptr)
    g1, _ = k1_plan(t, s, blk, m, k, qt, packed=packed, codes_align=align)
    g3 = k3_query_groups(m, k, qt, fw, blk, packed=packed, codes_align=align)
    splits, s_per = k3_grid(g3, tiles, m, k, fw, blk, packed)
    wave = k3_wave(g3, m, k, 0 if g3.global_state else fw, blk, packed,
                   tiles.device)
    shape = (f"{what} {mode} B={b} S={s} QT={qt} M={m} K={k} fetch={fetch}"
             + (" packed" if packed else ""))
    if global_tables is not None:
        check(g1.global_tables == global_tables
              and g3.global_tables == global_tables,
              f"{shape}: K1 / K3 global tables {g1.global_tables} / "
              f"{g3.global_tables}, want {global_tables}")
    check(g3.global_state == global_state, f"{shape}: K3 candidate-row form "
          f"{g3.global_state}, want {global_state}")
    check(k3_form is None or g3.form == k3_form, f"{shape}: K3 form "
          f"{g3.form}, want {k3_form}")
    by_select = splits > 1 and merge_by_select(splits, fetch)
    k3_launches = ({"pq_scan_topk_kernel": len(g3), "select_topk_kernel": 1}
                   if global_state or by_select else
                   {"pq_scan_topk_kernel": len(g3),
                    "merge_topk_kernel": int(splits > 1)})
    errs = {}
    for kid, fn, plain, args, kw, want_launches in (
            ("K1", pq_scan_tiled_kernel, ref.pq_scan_tiled_ref, k1,
             dict(query_tile=qt, packed=packed),
             {"pq_scan_tiled_kernel": len(g1)}),
            ("K3", pq_scan_topk_kernel, ref.pq_scan_topk_ref, k3,
             dict(query_tile=qt, fetch=fetch, packed=packed), k3_launches)):
        reset_launch_counts()
        got = (fn(*args, **kw, plan_width=pw) if kid == "K3"
               else fn(*args, **kw))
        used = launch_counts()
        check(all(n == want_launches.get(name, 0)
                  for name, n in used.items()),
              f"{kid} at {shape}: launches {json.dumps(used)}, want "
              f"{json.dumps(want_launches)}")
        if kid == "K1":
            k1_forms = {f: n for f, n in pq_scan_tiled_kernel.forms.items()
                        if n}
            check(form is None or k1_forms == {form: len(g1)},
                  f"K1 at {shape}: launches by form {k1_forms}, want "
                  f"{len(g1)} {form}")
        else:
            k3_forms = {f: n for f, n in pq_scan_topk_kernel.forms.items()
                        if n}
            check(k3_forms == {g3.form: len(g3)}, f"K3 at {shape}: launches "
                  f"by form {k3_forms}, want {len(g3)} {g3.form}")
        want = plain(*args, **kw)
        if kid == "K1":
            got, want = (got,), (want,)
        for x, y in zip(got, want):
            check(torch.equal(x, y), f"{kid} at {shape} differs from its "
                  "plain version")
        fin = torch.isfinite(want[0])
        errs[kid] = (got[0][fin] - want[0][fin]).abs().max().item()
        if kid == "K3":
            k3_want = want[:3]
        del got, want, fin
    parts = None
    if global_state:
        hold_rows(torch, k3, dict(query_tile=qt, packed=packed), pw,
                  f"{shape}: K3's scan to rows")
    elif splits > 1:
        # the plain top-fetch of each of the kernel's ranges, merged by
        # the kernel
        parts = split_parts(torch, k3, dict(query_tile=qt, fetch=fetch,
                                            packed=packed), splits, s_per)
        got = merge_topk_kernel(*parts)
        for x, y, z in zip(got, ref.merge_topk_ref(*parts), k3_want):
            check(torch.equal(x, y) and torch.equal(x, z),
                  f"K3 merge at {shape} differs from merge_topk_ref or from "
                  "the unsplit plain K3")
        fin = torch.isfinite(k3_want[0])
        errs["merge"] = (got[0][fin] - k3_want[0][fin]).abs().max().item()
        del got
    log(f"{what}: K1 (query groups {list(g1)}, launches by form "
        f"{json.dumps(k1_forms)}) and K3 "
        f"(query groups {list(g3)}, form {g3.form}, "
        f"{'global' if g3.global_tables else 'shared-memory'} tables, "
        + ("candidate rows and the row select" if g3.global_state else
           "shared-memory selection state")
        + f", {splits} splits, {wave} CTAs a wave"
        + f") launched as required and bitwise equal to their plain "
        f"versions at the {mode} batch B={b} S={s} QT={qt} M={m} K={k} "
        f"fetch={fetch}"
        + (" (packed plane)" if packed else "")
        + (", K3's merge too" if parts else "")
        + (", the scan to rows too" if g3.global_state else ""))
    return k1, k3, qt, fetch, errs, parts, (g1, g3), packed, pw


def time_held(torch, held, what, lookups_per_s):
    """Time K1 and K3 on what hold_kernels held (graph replays), beside
    the lookup floor; no plain version, no bound."""
    from repro_torch.kernels.pq_scan import (pq_scan_tiled_kernel,
                                             pq_scan_topk_kernel)
    k1, k3, qt, fetch = held[:4]
    packed = held[7]
    lut, _, tiles = k1
    k1_ms = graph_ms(torch, lambda: pq_scan_tiled_kernel(
        *k1, query_tile=qt, packed=packed))
    k3_ms = graph_ms(torch, lambda: pq_scan_topk_kernel(
        *k3, query_tile=qt, fetch=fetch, packed=packed, plan_width=held[8]))
    lookups = lut.shape[0] * tiles.shape[1] * k1[1].shape[1] * lut.shape[1]
    log(f"{what}: K1 {k1_ms:.4f} ms (lookup floor "
        f"{lookups / lookups_per_s * 1e3:.4f} ms), K3 {k3_ms:.4f} ms at "
        f"B={lut.shape[0]} S={tiles.shape[1]} QT={qt} K={lut.shape[2]}")


def topk_ms(torch, d, fetch):
    """Device ms (graph_ms) of one torch.topk of the ``fetch`` smallest of
    each row of ``d``, sorted: the library call beside a selection kernel
    (ties may come in another order; the port never calls it)."""
    return graph_ms(torch, lambda: torch.topk(
        d, min(fetch, d.shape[1]), dim=1, largest=False, sorted=True))


def kernel_rows(torch, held, mode, what, lookups_per_s):
    """K1 and K3 on what hold_kernels held, timed (CUDA events) beside
    their plain versions, bounds and lookup floors; K3's merge also
    alone where K3 splits (with one torch.topk over its lists beside
    it).  In K3's candidate-row form also its two launches alone, the
    scan to rows and the row select (with one torch.topk over the rows
    beside it).  At fetch 400 and above also K1 followed by one
    torch.topk over K1's scores, the yardstick of a fused scan.  Returns {"K1" | "K3" | "merge" | "rows" |
    "select": row}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pq_scan import (pq_scan_tiled_kernel,
                                             pq_scan_topk_kernel, topk_width)
    k1, k3, qt, fetch, errs, parts, (_, g3), packed, pw = held
    lx, codes, tiles = k1
    b = lx.shape[0]
    rows = {}
    for kid, fn, plain, args, kw, (nbytes, ops) in (
            ("K1", pq_scan_tiled_kernel, ref.pq_scan_tiled_ref, k1,
             dict(query_tile=qt, packed=packed), k1_bound(torch, k1)),
            ("K3", pq_scan_topk_kernel, ref.pq_scan_topk_ref, k3,
             dict(query_tile=qt, fetch=fetch, packed=packed),
             k3_bound(torch, k3, fetch))):
        ms = graph_ms(torch, lambda: (fn(*args, **kw, plan_width=pw)
                                     if kid == "K3" else fn(*args, **kw)))
        pms = cuda_ms(torch, lambda: plain(*args, **kw), reps=3, warm=1)
        total = sum(nbytes.values())
        bms, by = bound_ms(total, ops)
        rows[kid] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                         max_abs_err=errs[kid],
                         lookup_ms=ops / lookups_per_s * 1e3,
                         nbytes=nbytes, ops=ops)
        log(f"{what}: {kid} {mode} B={b} S={tiles.shape[1]} "
            f"QT={qt} M={lx.shape[1]} K={lx.shape[2]}"
            + (f" fetch={fetch}" if kid == "K3" else "")
            + f": {ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms "
            f"({by}; {total} B = {json.dumps(nbytes)}; {ops} adds); "
            f"{ops} lookups, lookup floor {rows[kid]['lookup_ms']:.4f} ms")
    if parts is not None:
        _, s_per = k3_grid(g3, tiles, lx.shape[1], lx.shape[2],
                           topk_width(fetch), codes.shape[1], packed)
        rows["merge"] = time_merge(
            torch, parts, f"{what}: {mode} s_per={s_per} (K3 "
            f"{rows['K3']['ms']:.4f} ms)", errs["merge"])
    if g3.global_state:
        rows.update(row_form_rows(torch, held, mode, what))
    if fetch >= 400:
        yard = graph_ms(torch, lambda: torch.topk(
            pq_scan_tiled_kernel(*k1, query_tile=qt, packed=packed)
            .reshape(b, -1), fetch, dim=1, largest=False, sorted=True))
        rows["K3"]["yardstick_ms"] = yard
        log(f"{what}: {mode} K1 + one torch.topk over its (B, S * BLK) "
            f"scores (fetch {fetch}, no keep mask): {yard:.4f} ms, beside "
            f"K3's {rows['K3']['ms']:.4f} ms"
            + (f" (scan to rows {rows['rows']['ms']:.4f} + select "
               f"{rows['select']['ms']:.4f})" if g3.global_state else ""))
    return rows


def row_form_rows(torch, held, mode, what, fetch=None):
    """K3's candidate-row form on what hold_inputs held, its two launches
    timed alone: the scan to rows beside scan_rows_ref and its bound
    (k3_bound's inputs, the kept triples and the fills out), and the row
    select at ``fetch`` (K3's when None) beside select_topk_ref, its
    bound (each kept entry's d and pos read once, the survivors' ids, the
    top-fetch written once) and one torch.topk over the rows' distances (entries past a fill set to
    +inf).  Returns {"rows": row, "select": row}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pq_scan import (pq_scan_rows_kernel,
                                             select_topk_kernel)
    k1, k3, qt, k3_fetch, errs, _, _, packed, pw = held
    fetch = k3_fetch if fetch is None else fetch
    b = k1[0].shape[0]
    kw = dict(query_tile=qt, packed=packed, plan_width=pw)
    out = {}
    rms = graph_ms(torch, lambda: pq_scan_rows_kernel(*k3, **kw))
    pms = cuda_ms(torch, lambda: ref.scan_rows_ref(*k3, **kw), reps=3,
                  warm=1)
    rd, rp, ri, rn, _ = pq_scan_rows_kernel(*k3, **kw)
    kept = int(rn.sum().item())
    nbytes, ops = k3_bound(torch, k3, k3_fetch)
    nbytes = dict(nbytes, out=kept * 12 + b * 8)
    bms, by = bound_ms(sum(nbytes.values()), ops)
    out["rows"] = dict(ms=rms, plain_ms=pms, bound_ms=bms, bound_by=by,
                       max_abs_err=errs.get("rows", 0.0),
                       lookup_ms=None, kept=kept)
    got = select_topk_kernel(rd, rp, ri, rn, fetch=fetch)
    want = ref.select_topk_ref(rd, rp, ri, rn, fetch=fetch)
    for x, y in zip(got, want):
        check(torch.equal(x, y), f"{what}: {mode} row select at fetch "
              f"{fetch} differs from select_topk_ref")
    fin = torch.isfinite(want[0])
    err = (got[0][fin] - want[0][fin]).abs().max().item()
    sms = graph_ms(torch, lambda: select_topk_kernel(rd, rp, ri, rn,
                                                    fetch=fetch))
    spms = cuda_ms(torch, lambda: ref.select_topk_ref(rd, rp, ri, rn,
                                                      fetch=fetch),
                   reps=3, warm=1)
    past = (torch.arange(rd.shape[1], device=rd.device)[None, :]
            >= rn[:, None])
    lms = topk_ms(torch, torch.where(past, torch.inf, rd), fetch)
    # d and pos of each kept entry, the fills, the survivors' ids, the output
    survivors = int(rn.clamp(max=fetch).sum().item())
    sbytes = kept * 8 + b * 4 + survivors * 4 + b * fetch * 12
    sbms, sby = bound_ms(sbytes, kept)
    out["select"] = dict(ms=sms, plain_ms=spms, bound_ms=sbms, bound_by=sby,
                         max_abs_err=err, library_ms=lms)
    log(f"{what}: {mode} B={b} rows of {rd.shape[1]} ({kept / b:.1f} kept a "
        f"query): scan to rows {rms:.4f} ms, plain {pms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}); row select at fetch {fetch} {sms:.4f} ms, "
        f"plain {spms:.4f} ms, bound {sbms:.4f} ms ({sby}; {sbytes} B), one "
        f"torch.topk over the rows {lms:.4f} ms (ties may come in another "
        "order)")
    return out


def time_kernels(torch, index, queries, lookups_per_s):
    """K1 and K3 at the shapes of the first main-path batch of each exec
    mode (grouped on its first 64 queries): held there (hold_kernels, in
    the shared-memory form), then timed (kernel_rows), with the union
    fill of grouped and clustered mode.  Returns {mode: rows}."""
    rows = {}
    for mode, bsz in RUNS:
        held = hold_kernels(torch, index, queries[:bsz].contiguous(), mode,
                            "timing", global_tables=False, form="fast")
        if mode != "paged":
            log(f"timing: K1 {mode} union fill "
                f"{union_fill(index, queries[:bsz], mode):.4f}: the share of "
                "K1's scan positions that are union padding, clamped to "
                "block 0, scored and never read")
        rows[mode] = kernel_rows(torch, held, mode, "timing", lookups_per_s)
    return rows


def kernel_json(rows, launches, gist_rows, gist_launches, nbits8_rows,
                nbits8_launches, plane_rows, plane_launches, wide_rows,
                wide_launches, stream_rows, stream_launches, gw_rows,
                gw_launches, shard_rows, shard_launches):
    """The {"kernels": [...]} entries: K1 and K3 at the main path's first
    paged batch, K3's merge at its first grouped batch (where most of its
    launches run), the
    global-table forms of K1 and K3 at the gist index's first paged
    batch, the k256 forms of K1 and K3 at the nbits=8 index's first batch
    of each mode (with that mode's launches; paged at both batch sizes),
    K1 and K3 at each compact plane's first paged batch, and K3's
    candidate-row form (its scan to rows, and the row select) at the
    wide case's first paged batch, and K1, K3 with the tombstones' dead
    tile and K3's merge on the stream phase (paged, the merge grouped,
    after the deletes; launches of its twelve six-mode runs), and K1, K3
    and its merge at the gateway phase's first flushed batch (launches of
    the gateway runs), and K1, K3 (and its merge, where K3 splits there)
    at shard 0's first paged (the merge: grouped) batch of the four-shard
    mesh (launches of its six runs), with their launches on the runs that
    use them."""
    src = "src/repro_torch/kernels/csrc/"
    planes = []
    for b in sorted(plane_rows):
        planes += [
            (f"pq_scan_tiled_kernel[{b} plane]", src + "pq_scan.cu",
             "src/repro/kernels/pq_scan.py:112", plane_rows[b]["paged"]["K1"],
             plane_launches[b]["pq_scan_tiled_kernel"]),
            (f"pq_scan_topk_kernel[{b} plane]", src + "pq_scan_topk.cu",
             "src/repro/kernels/pq_scan.py:311", plane_rows[b]["paged"]["K3"],
             plane_launches[b]["pq_scan_topk_kernel"])]
    gateway = [
        ("pq_scan_tiled_kernel[gateway, fast]", src + "pq_scan.cu",
         "src/repro/kernels/pq_scan.py:112", gw_rows["K1"],
         gw_launches["pq_scan_tiled_kernel[fast]"]),
        ("pq_scan_topk_kernel[gateway, shared]", src + "pq_scan_topk.cu",
         "src/repro/kernels/pq_scan.py:311", gw_rows["K3"],
         gw_launches["pq_scan_topk_kernel[shared]"])]
    if "merge" in gw_rows:      # K3 split at the first flush
        gateway.append(("merge_topk_kernel[gateway]",
                        src + "pq_scan_topk.cu",
                        "src/repro/kernels/topk.py:103", gw_rows["merge"],
                        gw_launches["merge_topk_kernel"]))
    shards = [
        ("pq_scan_tiled_kernel[shard, fast]", src + "pq_scan.cu",
         "src/repro/kernels/pq_scan.py:112", shard_rows["paged"]["K1"],
         shard_launches["pq_scan_tiled_kernel[fast]"]),
        ("pq_scan_topk_kernel[shard, shared]", src + "pq_scan_topk.cu",
         "src/repro/kernels/pq_scan.py:311", shard_rows["paged"]["K3"],
         shard_launches["pq_scan_topk_kernel[shared]"])]
    if "merge" in shard_rows["grouped"]:
        shards.append(("merge_topk_kernel[shard]", src + "pq_scan_topk.cu",
                       "src/repro/kernels/topk.py:103",
                       shard_rows["grouped"]["merge"],
                       shard_launches["merge_topk_kernel"]))
    out = []
    for name, source, replaces, row, n in planes + shards + [
            ("pq_scan_topk_kernel[candidate rows]", src + "pq_scan_topk.cu",
             "src/repro/kernels/pq_scan.py:311", wide_rows["paged"]["rows"],
             wide_launches["pq_scan_topk_kernel"]),
            ("select_topk_kernel", src + "topk_select.cu",
             "src/repro/kernels/topk.py:79", wide_rows["paged"]["select"],
             wide_launches["select_topk_kernel"])] + [
            ("pq_scan_tiled_kernel", src + "pq_scan.cu",
             "src/repro/kernels/pq_scan.py:112", rows["paged"]["K1"],
             launches["pq_scan_tiled_kernel"]),
            ("pq_scan_topk_kernel", src + "pq_scan_topk.cu",
             "src/repro/kernels/pq_scan.py:311", rows["paged"]["K3"],
             launches["pq_scan_topk_kernel"]),
            ("merge_topk_kernel", src + "pq_scan_topk.cu",
             "src/repro/kernels/topk.py:103", rows["grouped"]["merge"],
             launches["merge_topk_kernel"]),
            ("pq_scan_tiled_kernel[global tables]", src + "pq_scan.cu",
             "src/repro/kernels/pq_scan.py:112", gist_rows["paged"]["K1"],
             gist_launches["pq_scan_tiled_kernel"]),
            ("pq_scan_topk_kernel[global tables]", src + "pq_scan_topk.cu",
             "src/repro/kernels/pq_scan.py:311", gist_rows["paged"]["K3"],
             gist_launches["pq_scan_topk_kernel"]),
            ("pq_scan_tiled_kernel[stream, fast]", src + "pq_scan.cu",
             "src/repro/kernels/pq_scan.py:112", stream_rows["paged"]["K1"],
             stream_launches["pq_scan_tiled_kernel[fast]"]),
            ("pq_scan_topk_kernel[stream, shared, dead]",
             src + "pq_scan_topk.cu", "src/repro/kernels/pq_scan.py:311",
             stream_rows["paged"]["K3"],
             stream_launches["pq_scan_topk_kernel[shared]"]),
            ("merge_topk_kernel[stream]", src + "pq_scan_topk.cu",
             "src/repro/kernels/topk.py:103", stream_rows["grouped"]["merge"],
             stream_launches["merge_topk_kernel"]),
        ] + gateway + [
            (f"{kern}[k256, nbits8 {mode}]", src + source,
             f"src/repro/kernels/pq_scan.py:{line}", nbits8_rows[mode][kid],
             nbits8_launches[mode][kern])
            for mode, _ in RUNS
            for kid, kern, source, line in (
                ("K1", "pq_scan_tiled_kernel", "pq_scan.cu", 112),
                ("K3", "pq_scan_topk_kernel", "pq_scan_topk.cu", 311))]:
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": n,
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row.get("library_ms")})
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def main_path(torch, dev, args):
    from repro_torch.core import IndexConfig, build_index, ground_truth
    from repro_torch.data import make_dataset
    from repro_torch.kernels.pq_scan import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    x, q, spec = make_dataset("sift1m", args.seed, n=args.n,
                              n_queries=args.queries, device=dev)
    torch.cuda.synchronize()
    log(f"main: data sift1m-shaped n={x.shape[0]} d={x.shape[1]} "
        f"queries={q.shape[0]} in {time.perf_counter() - t0:.2f} s")
    cfg = IndexConfig(**INDEX)
    t0 = time.perf_counter()
    index = build_index(x, cfg, generator=torch.Generator().manual_seed(
        args.seed), device=dev)
    log(f"main: build {time.perf_counter() - t0:.2f} s, phases "
        + json.dumps({k: round(v, 3) for k, v in index.build_seconds.items()}))
    log(f"main: SeilStats {index.stats}")
    determinism(torch, index, x, args.seed)
    log(f"main: device memory allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    t0 = time.perf_counter()
    gt = ground_truth(x, q, 10, device=dev)
    log(f"main: exact top-10 ground truth in {time.perf_counter() - t0:.2f} s")

    results = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for mode, bsz in RUNS:
        for fused in (False, True):
            results[(mode, fused)] = search_run(torch, index, q, gt, mode,
                                                bsz, fused)
    launches = launch_counts()
    forms = launch_counts(forms=True)
    log(f"main: launches over the six runs {json.dumps(forms)}")
    check(all(launches[k] > 0 for k in MAIN_KERNELS),
          "a kernel of the main path was never launched")
    check(forms["pq_scan_tiled_kernel[fast]"] == launches[
        "pq_scan_tiled_kernel"], "main: a K1 launch left the fast form")
    check(forms["pq_scan_topk_kernel[shared]"] == launches[
        "pq_scan_topk_kernel"], "main: a K3 launch left the shared form")
    check_agree(torch, results, "main")
    # the sessions' CUDA graphs beside eager seil_search on the same
    # batches, and one traced batch per mode
    for mode, bsz in RUNS:
        for fused in (False, True):
            eager_run(torch, index, q, mode, bsz, fused,
                      results[(mode, fused)])
    for mode, bsz in RUNS:
        for fused in (False, True):
            traced_batch(torch, index, q, mode, bsz, fused)
    traced_capture(torch, index, q)
    replay_timing(torch, index, q)
    # plan reuse: the same ids and counters as the plain runs, then K1
    # and K3 held at a batch whose unions the plan cache widened
    reuse = {}
    for mode, bsz in REUSE_RUNS:
        for fused in (False, True):
            reset_launch_counts()
            reuse[(f"{mode} plan_reuse", fused)] = search_run(
                torch, index, q, gt, mode, bsz, fused, plan_reuse=True)
            kern = "pq_scan_topk_kernel" if fused else "pq_scan_tiled_kernel"
            check(launch_counts()[kern] > 0, f"plan reuse {mode} "
                  f"fused={int(fused)} never launched {kern}")
    check_agree(torch, {**reuse, ("paged", False): results[("paged", False)]},
                "main, plan reuse")
    # the same index in clustered mode at query_tile=64: K1's tables
    # (256 KB) and K3's state pass a CTA's shared memory, so both run in
    # query groups
    qt64 = {}
    for fused in (False, True):
        reset_launch_counts()
        qt64[("clustered qt=64", fused)] = search_run(
            torch, index, q, gt, "clustered", 1024, fused, query_tile=64)
        used = launch_counts()
        kern = "pq_scan_topk_kernel" if fused else "pq_scan_tiled_kernel"
        check(used[kern] > 0, f"clustered qt=64 fused={int(fused)} never "
              f"launched {kern}")
        log(f"main: clustered qt=64 fused={int(fused)} launches "
            f"{json.dumps(used)}")
    check_agree(torch, {**qt64, ("paged", False): results[("paged", False)]},
                "main, clustered qt=64")
    log(f"main: device memory with the {len(SESSIONS)} sessions' CUDA "
        f"graphs: allocated {torch.cuda.memory_allocated() / 2 ** 30:.3f} "
        f"GiB, reserved {torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB; "
        f"peak over the runs above (sessions, eager loops, traced "
        f"batches) {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    held_reuse = {mode: hold_inputs(torch, reuse_inputs(torch, index, q,
                                                        mode, bsz),
                                    mode, "main, plan reuse",
                                    global_tables=False, form="fast")
                  for mode, bsz in REUSE_RUNS}
    release_sessions(torch, "main")
    held = hold_kernels(torch, index, q[:1024].contiguous(), "clustered",
                        "main, clustered qt=64", global_tables=False,
                        form="fast", query_tile=64)
    return index, q, gt, launches, held, held_reuse, results


SESSIONS = {}   # the runs' sessions, with their CUDA graphs


def session(index, mode, bsz, fused, **params):
    """The session of one run (``Searcher(index, params)``, what
    ``index.searcher`` caches; ``params`` override SEARCH), kept in
    SESSIONS until release_sessions drops it with its graphs."""
    from repro_torch.core import SearchParams, Searcher
    p = SearchParams(**{**SEARCH, "exec_mode": mode, "fused_topk": fused,
                        "batch_buckets": (bsz,), **params})
    key = (id(index), p)
    if key not in SESSIONS:
        SESSIONS[key] = Searcher(index, p)
    return SESSIONS[key]


def release_sessions(torch, what):
    """Drop every session and the device memory of its CUDA graphs
    (their pools stay reserved, not allocated, between replays); logs
    how much that was."""
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    n = len(SESSIONS)
    SESSIONS.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{what}: {n} sessions released; device memory reserved fell by "
        f"{(before - torch.cuda.memory_reserved()) / 2 ** 30:.3f} GiB, "
        "what their CUDA graphs held")


def search_run(torch, index, q, gt, mode, bsz, fused, tag="main",
               floor=0.5, **params):
    """One session over all of ``q`` at batch size ``bsz``, its CUDA
    graphs captured first (``warmup``; with plan_reuse the whole width
    ladder, ``warmup_widths``): the result, after the recall@10 floor
    and shape checks, with its log line (QPS and launches of the timed
    run alone; plan stats with plan_reuse)."""
    from repro_torch.core import recall_at_k
    from repro_torch.kernels.pq_scan import launch_counts
    searcher = session(index, mode, bsz, fused, **params)
    reuse = searcher.params.plan_reuse
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if reuse:
        searcher.warmup_widths(bsz)
    else:
        searcher.warmup(bsz)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    before = launch_counts()
    t0 = time.perf_counter()
    res = searcher(q)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    rec = recall_at_k(res.ids[:, :10].cpu().numpy(), gt)
    qt = "" if mode == "paged" else f" QT={searcher.params.query_tile}"
    ref = searcher.params.refine
    log(f"{tag}: {mode:9s} B={bsz:4d}{qt} fused={int(fused)}"
        + (" plan_reuse" if reuse else "")
        + (f" refine={ref.plane}x{ref.refine_factor} fetch "
           f"{searcher.params.bigk_eff}" if ref else "")
        + f" recall@10={rec:.4f} approx_dco/q="
        f"{res.approx_dco.float().mean().item():.1f} refine_dco/q="
        f"{res.refine_dco.float().mean().item():.1f} "
        f"dropped/q={res.dropped_blocks.float().mean().item():.3f} "
        f"qps={q.shape[0] / dt:.1f} launches={json.dumps(delta)}; "
        f"{searcher.stats.warmup_compiles} CUDA graphs captured by "
        f"{'warmup_widths' if reuse else 'warmup'} in {warm:.2f} s before "
        "the run")
    if reuse:
        st = searcher.compile_stats()
        pl = st["plan"]
        log(f"{tag}: {mode} fused={int(fused)} plan_reuse: hit_rate "
            f"{pl['hit_rate']:.4f} mean_union_live "
            f"{pl['mean_union_live']:.1f} mean_own_live "
            f"{pl['mean_own_live']:.1f} mean_width {pl['mean_width']:.1f} "
            f"tiles {pl['tiles']} hits {pl['hits']} extends "
            f"{pl['extends']} misses {pl['misses']} sig_deep_split "
            f"{pl['sig_deep_split']}; compiles {st['compiles']} "
            f"(warmup {st['warmup_compiles']}) cache_hits "
            f"{st['cache_hits']}")
    check(rec >= floor, f"{tag}: recall@10 {rec} below the {floor} floor")
    check(bool(torch.isfinite(res.dists).all()),
          "non-finite distances in a result")
    check(tuple(res.ids.shape) == (q.shape[0], searcher.params.k),
          "result ids of the wrong shape")
    return res


def eager_run(torch, index, q, mode, bsz, fused, want):
    """A loop of eager seil_search calls over the batches the session
    dispatched (padded alike): its QPS beside the session's graphs, and
    the same ids and counters as the session's run ``want``."""
    from repro_torch.core import seil_search
    from repro_torch.core.search import SearchResult
    p = session(index, mode, bsz, fused).params
    kw = dict(nprobe=p.nprobe, bigk=p.bigk, k=p.k, max_scan=p.max_scan,
              metric=index.config.metric,
              dedup_results=index.needs_result_dedup,
              oversample=index.result_oversample, exec_mode=mode,
              query_tile=p.query_tile, fused_topk=fused)

    def batch(s):
        qc = q[s:s + bsz]
        if qc.shape[0] < bsz:
            qc = torch.cat([qc, qc.new_zeros((bsz - qc.shape[0],
                                              q.shape[1]))])
        return seil_search(index.arrays, index.centroids, index.codebook,
                           index.vectors, qc, **kw)
    batch(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [batch(s) for s in range(0, q.shape[0], bsz)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = SearchResult(*(torch.cat(a)[:q.shape[0]] for a in zip(*outs)))
    for f in ("ids", "approx_dco", "refine_dco", "scanned_blocks",
              "dropped_blocks"):
        check(torch.equal(getattr(got, f), getattr(want, f)),
              f"eager {mode} fused={int(fused)} disagrees with the "
              f"session's graphs on {f}")
    same_d = torch.equal(got.dists, want.dists)
    sess = session(index, mode, bsz, fused)
    qb = q[:bsz].contiguous()
    replay_ms = cuda_ms(torch, lambda: sess(qb))
    eager_ms = cuda_ms(torch, lambda: batch(0))
    log(f"graphs: {mode:9s} B={bsz:4d} fused={int(fused)}: eager "
        f"seil_search loop qps={q.shape[0] / dt:.1f} over the session's "
        f"batches; same ids and counters as the session, distances "
        f"{'bitwise equal' if same_d else 'not bitwise equal'}; one "
        f"batch (CUDA events, 10 back to back): graph replay {replay_ms:.4f} "
        f"ms, eager {eager_ms:.4f} ms")


def traced_batch(torch, index, q, mode, bsz, fused):
    """One batch of the ``mode`` session under the tracer (the eager,
    stage-fenced dispatch): bitwise equal to the same batch through the
    session's graph; its stage spans."""
    from repro_torch import obs
    sess = session(index, mode, bsz, fused)
    qb = q[:bsz].contiguous()
    want = sess(qb)
    torch.cuda.synchronize()     # the first span must not wait for this
    with obs.trace() as tr:
        got = sess(qb)
    for f in want._fields:
        check(torch.equal(getattr(got, f), getattr(want, f)),
              f"traced {mode} fused={int(fused)} differs from the untraced "
              f"batch on {f}")
    spans = {k: v for k, v in tr.stage_summary().items()
             if k.startswith("stage.")}
    log(f"traced: {mode:9s} B={bsz:4d} fused={int(fused)}: bitwise equal "
        f"to the untraced batch; {tr.fences} fences; spans (ms, host clock "
        "after a device fence): " + ", ".join(
            f"{k} {v['mean_ms']:.4f}" for k, v in spans.items())
        + f"; counters {json.dumps({k: v['counters'] for k, v in spans.items()})}")


def traced_capture(torch, index, q):
    """A session's graph captured while a tracer is active, as a gateway
    warms its sessions on its own thread whatever the tracer: the
    capture itself neither fences nor reads a counter (only the eager run
    before it does, four fences), and the graph then answers the first
    run's batch bitwise as the session captured untraced does."""
    from repro_torch import obs
    from repro_torch.core import SearchParams, Searcher
    mode, bsz = RUNS[0]
    qb = q[:bsz].contiguous()
    want = session(index, mode, bsz, True)(qb)
    sess = Searcher(index, SearchParams(**{
        **SEARCH, "exec_mode": mode, "fused_topk": True,
        "batch_buckets": (bsz,)}))
    with obs.trace() as tr:
        sess.warmup(bsz)
    check(sess.stats.compiles == 1 and tr.fences == 4,
          f"traced capture: {sess.stats.compiles} captures, {tr.fences} "
          "fences (want 1 and the eager run's 4)")
    got = sess(qb)
    for f in want._fields:
        check(torch.equal(getattr(got, f), getattr(want, f)),
              f"traced capture: {mode} B={bsz} differs from the session "
              f"captured untraced on {f}")
    log(f"traced capture: {mode} B={bsz} fused=1 captured under the tracer "
        f"({tr.fences} fences, the eager run's); its replay bitwise the "
        "untraced session's")


REPLAY_CALLS = 200      # session calls of the replay-timing phase


def replay_timing(torch, index, q, n=REPLAY_CALLS):
    """The main path's graph (paged, fused, B=1024) replayed ``n`` times
    through its session with replay timing off, then ``n`` times with it
    on (``torch.profiler`` collecting the host only, so the dispatch is
    the untraced one): the session's timed counters and the event pool
    move only while timing is on, every call is timed, and the timed
    device ms a call lies within 0.85-1.0 of a synchronised host clock
    around the same calls (a pair around part of the graph reads less).
    Then ``n`` calls as the benchmark makes them (the ids read back after
    each), under the host-only profiler and under one that also traces
    the card (CUPTI, as the benchmark's profiled stretch): printed side
    by side, the second holds the card profiler's launch delay."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    sess = session(index, "paged", 1024, True)
    qb = q[:1024].contiguous()
    tm = sess.timing

    def loop(read_back=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            r = sess(qb)
            if read_back:
                r.ids.cpu()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    def timed(activities, read_back):
        obs.settle()
        calls0, sec0 = tm.calls, tm.seconds
        with profile(activities=activities):
            check(obs.timing(), "replay timing: the profiler does not "
                  "turn timing on")
            host_ms = loop(read_back)
        obs.settle()
        calls = tm.calls - calls0
        check(calls == n, f"replay timing: {calls} of {n} calls timed")
        return host_ms, (tm.seconds - sec0) * 1e3 / calls

    sess(qb)
    obs.settle()
    calls0, sec0, taken0 = tm.calls, tm.seconds, obs.events_taken()
    off_ms = loop()
    obs.settle()
    check((tm.calls, tm.seconds, obs.events_taken())
          == (calls0, sec0, taken0),
          "replay timing: the timed counters moved with timing off")
    on_ms, dev_ms = timed([ProfilerActivity.CPU], False)
    ratio = dev_ms / on_ms
    log(f"replay timing: paged B=1024 fused=1, {n} calls: host clock "
        f"{off_ms:.4f} ms a call with timing off, {on_ms:.4f} ms on; "
        f"timed device {dev_ms:.4f} ms a call ({ratio:.3f} of the host "
        f"clock); {obs.events_taken() - taken0} events taken")
    check(0.85 <= ratio <= 1.0, f"replay timing: timed device ms {dev_ms} "
          f"is {ratio} of the host clock's {on_ms}, outside 0.85-1.0")
    _, host_prof = timed([ProfilerActivity.CPU], True)
    _, card_prof = timed([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         True)
    log(f"replay timing: ids read back after each call: timed device "
        f"{host_prof:.4f} ms a call under a host-only profiler, "
        f"{card_prof:.4f} ms under one tracing the card "
        f"({card_prof / host_prof:.3f} of it)")


def check_agree(torch, results, what):
    """Every run agrees with paged unfused on ids and DCO counters, and
    on distances within 1e-5."""
    base = results[("paged", False)]
    same_d = 0
    for key, res in results.items():
        for f in ("ids", "approx_dco", "refine_dco", "scanned_blocks"):
            check(torch.equal(getattr(res, f), getattr(base, f)),
                  f"{what}: {key} disagrees with paged unfused on {f}")
        # the exact re-rank reduces over D in batches of 1024 or 64 rows,
        # which may round differently: f32 at the port's 1e-5 tolerance
        check(torch.allclose(res.dists, base.dists, rtol=1e-5, atol=1e-5),
              f"{what}: {key} disagrees with paged unfused on dists beyond "
              "1e-5")
        same_d += int(torch.equal(res.dists, base.dists))
    log(f"{what}: all {len(results)} runs agree on ids and DCO counters, "
        f"and on distances within 1e-5 ({same_d} of {len(results)} "
        "bitwise)")


def six_runs(torch, index, q, gt, tag, by_mode=None):
    """The six exec-mode runs of a side index and a paged run at
    grouped's batch size, each run's launches counted alone and required:
    the runs at one batch size must agree, and the rows where the two
    batch sizes disagree must be explained (``batch_size_ties``).
    Returns the summed launches (and adds each mode's to ``by_mode``)."""
    from repro_torch.kernels.pq_scan import launch_counts, reset_launch_counts
    results, total = {}, {}
    pb, gb = dict(RUNS)["paged"], dict(RUNS)["grouped"]
    for mode, bsz in RUNS + (("paged", gb),):
        for fused in (False, True):
            if (mode, bsz, fused) == ("paged", gb, True):
                continue
            reset_launch_counts()
            results[(mode, bsz, fused)] = search_run(
                torch, index, q, gt, mode, bsz, fused, tag=tag)
            used = launch_counts(forms=True)
            kern = "pq_scan_topk_kernel" if fused else "pq_scan_tiled_kernel"
            check(used[kern] > 0, f"{tag} {mode} fused={int(fused)} never "
                  f"launched {kern}")
            log(f"{tag}: {mode} B={bsz} fused={int(fused)} launches "
                f"{json.dumps(used)}")
            for k, n in used.items():
                total[k] = total.get(k, 0) + n
                if by_mode is not None:
                    d = by_mode.setdefault(mode, {})
                    d[k] = d.get(k, 0) + n
    for bsz in (pb, gb):
        check_agree(torch, {("paged", False) if k == ("paged", bsz, False)
                            else k: r for k, r in results.items()
                            if k[1] == bsz}, f"{tag}, B={bsz}")
    batch_size_ties(torch, index, q, results[("paged", pb, False)],
                    results[("paged", gb, False)], pb, gb, tag)
    release_sessions(torch, tag)
    return total


def batch_size_ties(torch, index, q, a, b, bsz_a, bsz_b, what):
    """Runs at two batch sizes may disagree only on queries whose stage-1
    selection differs between them, and only where the centroid
    distances of the first two lists that swap differ by no more than
    the two batch sizes' matmuls round that query's distances apart
    (twice the largest difference between its two computed distance
    rows): a matmul of another batch size may round the other way.
    Logs the count and the largest such gap."""
    from repro_torch.core.engine import select_lists
    from repro_torch.core.kmeans import pairwise_sq_l2
    p = session(index, "paged", bsz_a, False).params
    n = q.shape[0]

    def stage1(bsz):
        sels, cds = [], []
        for s in range(0, n, bsz):
            qc = q[s:s + bsz]
            qc = torch.cat([qc, qc.new_zeros((bsz - qc.shape[0],
                                              q.shape[1]))])
            sels.append(select_lists(qc, index.centroids,
                                     nprobe=p.nprobe).sel)
            cds.append(pairwise_sq_l2(qc, index.centroids))
        return torch.cat(sels)[:n], torch.cat(cds)[:n]
    (sa, ca), (sb, cb) = stage1(bsz_a), stage1(bsz_b)
    differ = ((a.ids != b.ids).any(dim=1) | (a.approx_dco != b.approx_dco)
              | (a.refine_dco != b.refine_dco)
              | (a.scanned_blocks != b.scanned_blocks))
    sel_differ = (sa != sb).any(dim=1)
    check(not bool((differ & ~sel_differ).any()),
          f"{what}: B={bsz_a} and B={bsz_b} disagree on queries whose "
          "stage-1 selections agree")
    worst = 0.0
    for r in torch.nonzero(sel_differ).flatten().tolist():
        worst = max(worst, stage1_tie(r, sa[r], sb[r], ca[r], cb[r],
                                      f"{what}: B={bsz_a} / B={bsz_b}"))
    log(f"{what}: B={bsz_a} and B={bsz_b} runs disagree on "
        f"{int(differ.sum())} of {n} queries, each a stage-1 near-tie "
        f"({int(sel_differ.sum())} queries select lists in another order "
        "at the two batch sizes, each swap within the rounding between "
        f"them; largest relative gap {worst:.2e})")


def stage1_tie(r, sa, sb, ca, cb, what):
    """Query ``r``'s stage-1 selections ``sa`` / ``sb`` at two batch
    shapes, from its centroid distances ``ca`` / ``cb`` at each: the first
    two lists that swap must lie within twice the rounding between the
    shapes (the largest difference between ``ca`` and ``cb``).  Returns
    their relative gap."""
    j = int((sa != sb).nonzero()[0])
    da, db = ca[sa[j].long()].item(), ca[sb[j].long()].item()
    noise = (ca - cb).abs().max().item()
    check(abs(da - db) <= 2 * noise,
          f"{what}: query {r} selects list {int(sa[j])} or {int(sb[j])} at "
          f"rank {j}, {da} against {db}, beyond the rounding {noise} "
          "between the two shapes: not a tie")
    return abs(da - db) / max(abs(da), 1e-30)


def nbits8_path(torch, dev, seed, lookups_per_s):
    """An nbits=8 index (PQ64x8: 64 KB of tables per query) built on the
    card and searched in every exec mode, fused off and on; at
    query_tile 8 a tile's tables (512 KB) pass a CTA's shared memory, and
    K1 and K3 take their k256 forms (one launch a call: K1 stages a
    tile's tables in ranges, K3 runs a CTA a query).  Then K1 and K3 are
    held at each mode's first batch and timed beside their plain
    versions, bounds and lookup floors.  Returns ({mode: rows}, launches
    of the six runs by mode)."""
    from repro_torch.core import IndexConfig, build_index, ground_truth
    from repro_torch.data import make_dataset
    x, q, _ = make_dataset("sift1m", seed, n=NBITS8_N, n_queries=1024,
                           device=dev)
    t0 = time.perf_counter()
    index = build_index(x, IndexConfig(**NBITS8_INDEX),
                        generator=torch.Generator().manual_seed(seed),
                        device=dev)
    gt = ground_truth(x, q, 10, device=dev)
    log(f"nbits8: sift1m-shaped n={x.shape[0]} IVF1024 PQ64x8 built in "
        f"{time.perf_counter() - t0:.2f} s")
    by_mode = {}
    launches = six_runs(torch, index, q, gt, "nbits8", by_mode)
    for kern in ("pq_scan_tiled_kernel", "pq_scan_topk_kernel"):
        check(launches[f"{kern}[k256]"] == launches[kern] > 0,
              f"nbits8: a {kern} launch left the k256 form")
    log("nbits8: launches by mode (paged at both batch sizes) "
        + json.dumps({mode: {k: n for k, n in used.items() if n}
                      for mode, used in by_mode.items()}))
    rows = {}
    for mode, bsz in RUNS:
        held = hold_kernels(torch, index, q[:bsz].contiguous(), mode,
                            "nbits8", global_tables=False, form="k256",
                            k3_form="k256")
        rows[mode] = kernel_rows(torch, held, mode, "timing: nbits8",
                                 lookups_per_s)
        del held
    persist_path(torch, dev, index, q)
    return rows, by_mode


def gist_path(torch, dev, seed, lookups_per_s):
    """A gist-shaped index (50,000 x 256, IVF1024, PQ256x8: 256 KB of
    tables per query, more than a CTA's shared memory) built on the card
    and searched in every exec mode, fused off and on: K1 and K3 run in
    their global-table form.  Then both are held at each mode's first
    batch, in that form, and timed beside their plain versions, bounds
    and lookup floors.  Returns ({mode: rows}, launches of the six
    runs)."""
    from repro_torch.core import IndexConfig, build_index, ground_truth
    from repro_torch.data import make_dataset
    x, q, _ = make_dataset("gist", seed, device=dev)
    t0 = time.perf_counter()
    index = build_index(x, IndexConfig(**GIST_INDEX),
                        generator=torch.Generator().manual_seed(seed),
                        device=dev)
    gt = ground_truth(x, q, 10, device=dev)
    log(f"gist: gist-shaped n={x.shape[0]} d={x.shape[1]} "
        f"queries={q.shape[0]} IVF1024 PQ256x8 built in "
        f"{time.perf_counter() - t0:.2f} s")
    launches = six_runs(torch, index, q, gt, "gist")
    check(launches["pq_scan_tiled_kernel[staged]"]
          == launches["pq_scan_tiled_kernel"] > 0,
          "gist: a K1 launch left the staged form")
    check(launches["pq_scan_topk_kernel[GT]"]
          == launches["pq_scan_topk_kernel"] > 0,
          "gist: a K3 launch left the GT form")
    rows = {}
    for mode, bsz in RUNS:
        held = hold_kernels(torch, index, q[:bsz].contiguous(), mode,
                            "gist", global_tables=True, form="staged",
                            k3_form="GT")
        rows[mode] = kernel_rows(torch, held, mode, "timing: gist",
                                 lookups_per_s)
        del held
    return rows, launches


def ip_path(torch, dev, seed):
    from repro_torch.core import (IndexConfig, SearchParams, build_index,
                                  ground_truth, recall_at_k)
    from repro_torch.data import make_dataset
    x, q, _ = make_dataset("t2i", seed, n_queries=1024, device=dev)
    index = build_index(x, IndexConfig(nlist=1024, m_pq=64, metric="ip"),
                        generator=torch.Generator().manual_seed(seed),
                        device=dev)
    gt = ground_truth(x, q, 10, metric="ip", device=dev)
    res = index.searcher(SearchParams(k=10, nprobe=32, fused_topk=True),
                         device=dev)(q)
    rec = recall_at_k(res.ids, gt)
    log(f"ip: t2i-shaped n={x.shape[0]} nlist=1024 paged+fused "
        f"recall@10={rec:.4f}")
    check(bool(torch.isfinite(res.dists).all()), "ip: non-finite distances")
    check(rec > 0.0, "ip: recall is zero")


def small_reference(torch, dev, seed):
    """A small index searched on the card and, moved to the CPU, through
    the plain versions: same ids up to near-ties of float rounding."""
    import dataclasses
    from repro_torch.core import IndexConfig, SearchParams, build_index
    from repro_torch.core.pq import PQCodebook
    from repro_torch.core.seil import SeilArrays
    from repro_torch.data import make_dataset
    x, q, _ = make_dataset("unit", seed, device=dev)
    gpu = build_index(x, IndexConfig(nlist=64),
                      generator=torch.Generator().manual_seed(seed),
                      device=dev)
    cpu = dataclasses.replace(
        gpu, centroids=gpu.centroids.cpu(),
        codebook=PQCodebook(gpu.codebook.codebooks.cpu()),
        arrays=SeilArrays(**{f.name: getattr(gpu.arrays, f.name).cpu()
                             for f in dataclasses.fields(SeilArrays)}),
        vectors=gpu.vectors.cpu())
    for mode in ("paged", "grouped", "clustered"):
        for fused in (False, True):
            p = SearchParams(k=10, nprobe=8, exec_mode=mode, fused_topk=fused)
            a = gpu.searcher(p, device=dev)(q)
            b = cpu.searcher(p, device="cpu")(q.cpu())
            same = (a.ids.cpu() == b.ids).float().mean().item()
            check(same >= 0.99, f"small {mode} fused={fused}: only {same:.4f}"
                  " of ids agree between card and CPU")
            both = a.ids.cpu() == b.ids
            err = (a.dists.cpu()[both] - b.dists[both]).abs().max().item()
            check(err <= 1e-3, f"small {mode}: dist err {err}")
    log("small: card and CPU plain path agree on a 6000-vector index "
        "(>= 0.99 of ids, distances within 1e-3) in all six modes")


# ---------------------------------------------------------------------------
# phase 6: the two-tier search, m-assignment and persistence
# ---------------------------------------------------------------------------
def attach_planes(torch, index, what):
    """Both compact planes on ``index`` (``index.plane``), the codec trained
    first so the log can split train / encode + layout / layout seconds."""
    from repro_torch.quant import (PLANE_BACKENDS, plane_block_codes,
                                   train_plane)
    for i, b in enumerate(PLANE_BACKENDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codec = train_plane(b, index.vectors, iters=index.config.pq_iters,
                            generator=torch.Generator().manual_seed(17 + i))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pp = index.plane(b, codec=codec)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        plane_block_codes(pp.codes, index.arrays.block_ids)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        check(pp.codec is codec and index.plane(b) is pp,
              f"{what}: plane {b} not cached with its codec")
        log(f"{what}: plane {b} Mc={pp.m} ({pp.bytes_per_item} code bytes "
            f"per item, the full plane {index.arrays.block_codes.shape[2]}): "
            f"train {t1 - t0:.3f} s, encode + layout {t2 - t1:.3f} s "
            f"(layout alone {t3 - t2:.3f} s)")


def refine_path(torch, index, q, gt, plain, lookups_per_s):
    """Two-tier sessions on the main index: both planes at refine factor 4
    in the six modes (which must agree), recall beside the single-tier
    runs ``plain``; refine_factor 1 bitwise the plain session; plan reuse
    with the pq4 plane in grouped B=64 and clustered B=1024 (warmup_widths
    first), ids and DCO equal to the plain two-tier sessions; then the
    wide case (k=100, pq4 x 16: fetch 16,000, K3 in its candidate-row
    form: a scan to rows and a row select) in the six modes on the first
    WIDE_QUERIES queries, fused equal to unfused.  Then, sessions
    released, K1 and K3 held and timed at each mode's first batch at the
    plane shapes (and the row select at the pq4 plane's fetch 400) and at
    the wide shape, and the device time of each stage of one wide batch
    per mode, fused off and on.  Returns ({plane: {mode: rows}}, {plane:
    launches}, {mode: wide rows}, wide launches)."""
    from repro_torch.core import RefineParams, recall_at_k
    from repro_torch.kernels.pq_scan import launch_counts, reset_launch_counts
    from repro_torch.quant import PLANE_BACKENDS
    attach_planes(torch, index, "refine")
    launches = {}
    for b in PLANE_BACKENDS:
        runs = {}
        reset_launch_counts()
        for mode, bsz in RUNS:
            for fused in (False, True):
                runs[(mode, fused)] = search_run(
                    torch, index, q, gt, mode, bsz, fused, tag=f"refine {b}",
                    floor=REFINE_FLOOR, refine=RefineParams(b, 4))
        launches[b] = launch_counts(forms=True)
        check(all(launches[b][k] > 0 for k in MAIN_KERNELS),
              f"refine {b}: a kernel was never launched")
        check(launches[b]["pq_scan_tiled_kernel[packed]"]
              == launches[b]["pq_scan_tiled_kernel"],
              f"refine {b}: a K1 launch left the packed form")
        check_agree(torch, runs, f"refine {b}")
        if b == "pq4":
            reuse_with_plane(torch, index, q, gt, runs)
        r = runs[("paged", False)]
        log(f"refine {b}: recall@10 {recall_at_k(r.ids.cpu(), gt):.4f} "
            f"(single tier {recall_at_k(plain[('paged', False)].ids.cpu(), gt):.4f}); "
            f"approx DCO/q {r.approx_dco.float().mean().item():.1f}, refine "
            f"DCO/q {r.refine_dco.float().mean().item():.1f} (single tier "
            f"{plain[('paged', False)].refine_dco.float().mean().item():.1f})"
            f"; launches over its six runs {json.dumps(launches[b])}")
        for fused in (False, True):
            rf1 = search_run(torch, index, q, gt, "paged", 1024, fused,
                             tag=f"refine {b} rf=1",
                             refine=RefineParams(b, 1))
            want = plain[("paged", fused)]
            for f in rf1._fields:
                check(torch.equal(getattr(rf1, f), getattr(want, f)),
                      f"refine {b} rf=1 fused={int(fused)} differs from the "
                      f"plain session on {f}")
        log(f"refine {b}: refine_factor=1 sessions bitwise equal to the "
            "plain sessions (paged, fused off and on)")
    release_sessions(torch, "refine")
    # the wide case: fetch 16,000 (FW 16384)
    qw, gw = q[:WIDE_QUERIES].contiguous(), gt[:WIDE_QUERIES]
    wide, runs = dict(WIDE, refine=RefineParams("pq4", 16)), {}
    reset_launch_counts()
    for mode, bsz in RUNS:
        for fused in (False, True):
            runs[(mode, fused)] = search_run(torch, index, qw, gw, mode, bsz,
                                             fused, tag="refine wide",
                                             **wide)
            # an unfused graph at B=1024 keeps its (B, 16000, D) re-rank
            # gather (8.4 GB) in its pool: one session at a time
            release_sessions(torch, f"refine wide {mode} fused={int(fused)}")
    wide_launches = launch_counts()
    log(f"refine wide: launches over the six runs "
        f"{json.dumps(wide_launches)}")
    check(all(wide_launches[k] > 0 for k in WIDE_KERNELS)
          and wide_launches["merge_topk_kernel"] == 0,
          "refine wide: a kernel of K3's candidate-row form was never "
          "launched, or a merge ran")
    check_agree(torch, runs, "refine wide (fetch 16000)")
    rows = {b: {} for b in PLANE_BACKENDS}
    for b in PLANE_BACKENDS:
        for mode, bsz in RUNS:
            held = hold_kernels(torch, index, q[:bsz].contiguous(), mode,
                                f"refine {b}", global_tables=False,
                                form="packed", refine=RefineParams(b, 4))
            rows[b][mode] = kernel_rows(torch, held, mode,
                                        f"timing: refine {b}",
                                        lookups_per_s)
            if b == "pq4":
                # the row select at fetch 400, for the record: the shape
                # alone keeps K3's shared-memory form here
                rows[b][mode].update(row_form_rows(
                    torch, held, mode, f"timing: refine {b} rows"))
            del held
    wide_rows = {}
    for mode, bsz in RUNS:
        held = hold_kernels(torch, index, q[:bsz].contiguous(), mode,
                            "refine wide", global_tables=False,
                            global_state=True, form="packed", **wide)
        wide_rows[mode] = kernel_rows(torch, held, mode,
                                      "timing: refine wide", lookups_per_s)
        del held
    stage_breakdown(torch, index, q[:1024].contiguous(), "stages wide",
                    **wide)
    return rows, launches, wide_rows, wide_launches


def reuse_with_plane(torch, index, q, gt, runs):
    """Plan reuse with the pq4 plane at refine factor 4 in grouped B=64
    and clustered B=1024, fused off and on, each session's width ladder
    captured first (warmup_widths): ids and DCO counters equal to the
    plain two-tier sessions of the same mode ``runs``."""
    from repro_torch.core import RefineParams
    for mode, bsz in REUSE_RUNS:
        for fused in (False, True):
            res = search_run(torch, index, q, gt, mode, bsz, fused,
                             tag="refine pq4 plan_reuse", floor=REFINE_FLOOR,
                             plan_reuse=True, refine=RefineParams("pq4", 4))
            want = runs[(mode, fused)]
            for f in ("ids", "approx_dco", "refine_dco", "scanned_blocks"):
                check(torch.equal(getattr(res, f), getattr(want, f)),
                      f"refine pq4 plan_reuse {mode} fused={int(fused)} "
                      f"differs from the plain two-tier session on {f}")
    log("refine pq4: plan reuse (grouped B=64, clustered B=1024, fused off "
        "and on) equal to the plain two-tier sessions on ids and DCO")


def multi_path(torch, dev, seed):
    """An m-assignment index (multi_m=3: every vector in three lists,
    stored unshared) built on the card and searched in every exec mode,
    fused off and on: the runs must agree (``six_runs``)."""
    from repro_torch.core import IndexConfig, build_index, ground_truth
    from repro_torch.data import make_dataset
    x, q, _ = make_dataset("sift1m", seed, n=MULTI_N, n_queries=1024,
                           device=dev)
    t0 = time.perf_counter()
    index = build_index(x, IndexConfig(**MULTI_INDEX),
                        generator=torch.Generator().manual_seed(seed),
                        device=dev)
    gt = ground_truth(x, q, 10, device=dev)
    check(index.assigns.shape == (MULTI_N, 3)
          and bool((index.assigns[:, 1:] > index.assigns[:, :-1]).all()),
          "multi: assignments are not three distinct sorted lists")
    log(f"multi: sift1m-shaped n={x.shape[0]} IVF1024 PQ64x4 multi_m=3 "
        f"built in {time.perf_counter() - t0:.2f} s, phases "
        + json.dumps({k: round(v, 3) for k, v in index.build_seconds.items()})
        + f"; {index.stats}")
    six_runs(torch, index, q, gt, "multi")


def persist_path(torch, dev, index, q):
    """The nbits=8 index with both planes saved as one file and as four
    shards, loaded on the card, and searched bitwise equal to the index
    in memory (paged and clustered fused, plain and two-tier); the
    repository's golden v1 bundle answered alike on the card and on the
    CPU; a bit-flipped copy refused with CorruptBundleError naming the
    member."""
    import tempfile
    from repro_torch.core import (RefineParams, SearchParams, Searcher,
                                  load_index, save_index)
    from repro_torch.errors import CorruptBundleError
    attach_planes(torch, index, "persist")
    qb = q[:1024].contiguous()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        single, sharded = Path(tmp) / "nbits8.npz", Path(tmp) / "nbits8"
        t0 = time.perf_counter()
        save_index(index, single, extra={"by": "chip_smoke.py"})
        t1 = time.perf_counter()
        save_index(index, sharded, shards=4)
        t2 = time.perf_counter()
        loaded = {}
        for name, path in (("one file", single), ("4 shards", sharded)):
            t3 = time.perf_counter()
            loaded[name] = load_index(path, device=dev)
            torch.cuda.synchronize()
            nbytes = (path.stat().st_size if path.is_file() else
                      sum(f.stat().st_size for f in path.iterdir()))
            log(f"persist: {name}: {nbytes} bytes, saved in "
                f"{(t1 - t0) if path == single else (t2 - t1):.2f} s, "
                f"loaded on the card in {time.perf_counter() - t3:.2f} s")
        n = 0
        for mode in ("paged", "clustered"):
            for refine in (None, RefineParams("pq4", 4),
                           RefineParams("binary", 4)):
                p = SearchParams(**SEARCH, exec_mode=mode, fused_topk=True,
                                 refine=refine)
                want = Searcher(index, p)(qb)
                for name, idx in loaded.items():
                    got = Searcher(idx, p)(qb)
                    for f in want._fields:
                        check(torch.equal(getattr(got, f), getattr(want, f)),
                              f"persist: {name} {mode} refine={refine} "
                              f"differs from the index in memory on {f}")
                    n += 1
        log(f"persist: {n} sessions of the loaded bundles bitwise equal to "
            "the index in memory (paged and clustered fused; plain, pq4 x 4 "
            "and binary x 4)")
        raw = bytearray(single.read_bytes())
        raw[raw.index(b"vectors.npy") + 4096] ^= 0x10
        bad = Path(tmp) / "flipped.npz"
        bad.write_bytes(bytes(raw))
        try:
            load_index(bad, device=dev)
            fail("persist: a bit-flipped bundle loaded")
        except CorruptBundleError as e:
            check(str(e).startswith("flipped.npz:vectors"),
                  f"persist: CorruptBundleError does not name the member: {e}")
            log(f"persist: a bit-flipped copy raised CorruptBundleError: {e}")
    del loaded
    gc.collect()
    golden = ROOT / "tests" / "data" / "golden_v1.npz"
    on_card, on_cpu = load_index(golden, device=dev), load_index(golden,
                                                                 device="cpu")
    qg = on_cpu.vectors[:8] + 0.01
    same_d = 0
    for mode in ("paged", "grouped", "clustered"):
        for fused in (False, True):
            p = SearchParams(k=5, nprobe=2, exec_mode=mode, fused_topk=fused)
            a = Searcher(on_card, p)(qg.to(dev))
            b = Searcher(on_cpu, p)(qg)
            for f in ("ids", "approx_dco", "refine_dco", "scanned_blocks",
                      "dropped_blocks"):
                check(torch.equal(getattr(a, f).cpu(), getattr(b, f)),
                      f"golden v1 {mode} fused={int(fused)}: card and CPU "
                      f"differ on {f}")
            check(torch.allclose(a.dists.cpu(), b.dists, rtol=1e-5,
                                 atol=1e-5),
                  f"golden v1 {mode}: distances differ beyond 1e-5")
            same_d += int(torch.equal(a.dists.cpu(), b.dists))
    log(f"persist: tests/data/golden_v1.npz answers alike on the card and "
        f"on the CPU in all six modes (ids and DCO equal; distances "
        f"within 1e-5, {same_d} of 6 bitwise)")


# ---------------------------------------------------------------------------
# the determinism check and the stream phase
# ---------------------------------------------------------------------------
def determinism(torch, index, x, seed):
    """A second build of the main index from the same data and seed, in
    this process: centroids, codebooks, assignments, codes and every SEIL
    array bitwise equal to the first (k-means sums each list in a fixed
    order, ``kmeans.segment_sum``).  Also k-means's segment sum on the
    card beside the CPU's on one k-means step's input (logged: the order
    is fixed on both, the same order is not promised)."""
    from repro_torch.core import IndexConfig, build_index
    from repro_torch.core.kmeans import assign_nearest, segment_sum
    from repro_torch.core.seil import SEIL_FIELDS
    t0 = time.perf_counter()
    again = build_index(x, IndexConfig(**INDEX),
                        generator=torch.Generator().manual_seed(seed),
                        device=x.device)
    torch.cuda.synchronize()
    pairs = [("centroids", index.centroids, again.centroids),
             ("codebooks", index.codebook.codebooks,
              again.codebook.codebooks),
             ("vectors", index.vectors, again.vectors)]
    pairs += [(f, getattr(index.arrays, f), getattr(again.arrays, f))
              for f in SEIL_FIELDS]
    for name, a, b in pairs:
        check(torch.equal(a, b), f"determinism: a second build differs on "
              f"{name}")
    check(np.array_equal(index.assigns, again.assigns)
          and np.array_equal(index.codes, again.codes),
          "determinism: a second build differs on assigns or codes")
    check(index.stats == again.stats, "determinism: SeilStats differ")
    xs = x[:65536]
    a = assign_nearest(xs, index.centroids)
    card = segment_sum(xs, a, index.config.nlist)
    cpu = segment_sum(xs.cpu(), a.cpu(), index.config.nlist)
    log(f"determinism: a second build of the main index in "
        f"{time.perf_counter() - t0:.2f} s is bitwise equal to the first "
        f"(centroids, codebooks, assigns, codes, {len(SEIL_FIELDS)} SEIL "
        f"arrays, SeilStats); k-means's segment sum over 65,536 rows on the "
        f"card {'bitwise equal to' if torch.equal(card[0].cpu(), cpu[0]) else 'differs from'} "
        f"the CPU's (max abs difference "
        f"{(card[0].cpu() - cpu[0]).abs().max().item():.3e})")


def live_truth(stream, q):
    """(live ids, tombstone mask, exact top-10 over the live vectors as
    positions among the live ids) of the stream as it stands."""
    from repro_torch.core import ground_truth
    return (stream.live_ids(), ~stream.live_mask(),
            ground_truth(stream.live_vectors(), q, 10, device=q.device))


def live_recall(truth, ids, what, floor):
    """recall@10 of result ``ids`` (internal ids) against ``truth``
    (live_truth over the same queries); no tombstoned id may come
    back."""
    from repro_torch.core import recall_at_k
    live, dead, gt = truth
    got = ids.cpu().numpy()
    ok = got >= 0
    check(not dead[got[ok]].any(), f"{what}: a deleted id was returned")
    pos = np.where(ok, np.searchsorted(live, np.clip(got, 0, None)), -1)
    rec = recall_at_k(pos[:, :10], gt[:got.shape[0]])
    check(rec >= floor, f"{what}: recall@10 {rec} below the {floor} floor")
    return rec


def stream_session(stream, mode, bsz, fused, **params):
    from repro_torch.core import SearchParams
    return stream.searcher(SearchParams(
        **{**SEARCH, "exec_mode": mode, "fused_topk": fused,
           "batch_buckets": (bsz,), **params}), device=stream.device)


def stream_runs(torch, stream, q, tag, floor=0.5):
    """The six exec-mode sessions on the stream, graphs captured first:
    ids and DCO agree, recall@10 against exact top-10 over the live set,
    QPS; one traced batch a mode bitwise equal to the untraced one, with
    its stage spans (``stage.delta_scan`` among them); the delta scan
    alone timed at each mode's first batch.  Returns the results."""
    from repro_torch import obs
    from repro_torch.core.engine import select_lists
    from repro_torch.core.pq import pq_lut
    from repro_torch.core.stream.search import _delta_candidates, delta_adc
    from repro_torch.core.search import finalize_fetch
    routed = stream.routes_at(SEARCH["nprobe"])
    truth = live_truth(stream, q)
    results = {}
    for mode, bsz in RUNS:
        for fused in (False, True):
            sess = stream_session(stream, mode, bsz, fused)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.warmup(bsz)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = sess(q)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rec = live_recall(truth, res.ids, f"{tag} {mode}", floor)
            check(bool(torch.isfinite(res.dists).all()),
                  f"{tag}: non-finite distances")
            results[(mode, fused)] = res
            log(f"{tag}: {mode:9s} B={bsz:4d} fused={int(fused)} "
                f"recall@10={rec:.4f} approx_dco/q="
                f"{res.approx_dco.float().mean().item():.1f} qps="
                f"{q.shape[0] / dt:.1f}; {sess.stats.warmup_compiles} CUDA "
                f"graphs captured by warmup in {warm:.2f} s")
    check_agree(torch, results, tag)
    spans = {}
    for mode, bsz in RUNS:
        for fused in (False, True):
            sess = stream_session(stream, mode, bsz, fused)
            qb = q[:bsz].contiguous()
            want = sess(qb)
            torch.cuda.synchronize()
            with obs.trace() as tr:
                got = sess(qb)
            for f in want._fields:
                check(torch.equal(getattr(got, f), getattr(want, f)),
                      f"{tag}: traced {mode} fused={int(fused)} differs "
                      f"from the untraced batch on {f}")
            summ = tr.stage_summary()
            check("stage.delta_scan" in summ, f"{tag}: no delta_scan span")
            spans[(mode, fused)] = summ["stage.delta_scan"]
            log(f"{tag}: traced {mode:9s} B={bsz:4d} fused={int(fused)}: "
                f"bitwise equal to the untraced batch; spans (ms, host clock "
                "after a device fence): " + ", ".join(
                    f"{k} {v['mean_ms']:.4f}" for k, v in summ.items()
                    if k.startswith("stage."))
                + f"; delta_dco {summ['stage.delta_scan']['counters']}")
    dv = stream._device_state()
    post = dv.delta_post if routed else dv.no_post
    for mode, bsz in RUNS:
        qb = q[:bsz].contiguous()
        p = stream_session(stream, mode, bsz, False).params
        sel = select_lists(qb, stream.centroids, nprobe=p.nprobe)
        lut = pq_lut(stream.codebook, qb)
        fetch = finalize_fetch(p.bigk_eff, stream.result_oversample,
                               stream.needs_result_dedup)
        ms = cuda_ms(torch, lambda: _delta_candidates(
            lut, dv.delta_codes, dv.delta_ids, post, dv.delta_assigns,
            sel.sel, sel.rank_of, routed, fetch), reps=3, warm=1)
        sums = ""
        if not routed and mode == "paged":
            # the exhaustive ADC sums (one embedding_bag a chunk) against
            # one gather and one add per m, bitwise: ascending m
            got = delta_adc(lut[:256], dv.delta_codes)

            def loop():
                out = torch.zeros_like(got)
                for j in range(lut.shape[1]):
                    out += torch.index_select(lut[:256, j, :], 1,
                                              dv.delta_codes[:, j].long())
                return out
            check(torch.equal(got, loop()), f"{tag}: the delta ADC sums "
                  "differ from a loop over ascending m")
            bag_ms = cuda_ms(torch, lambda: delta_adc(lut[:256],
                                                      dv.delta_codes),
                             reps=3, warm=1)
            sums = (f"; its ADC sums over 256 queries {bag_ms:.4f} ms, "
                    f"bitwise a per-m loop's "
                    f"({cuda_ms(torch, loop, reps=3, warm=1):.4f} ms)")
        log(f"{tag}: delta scan alone ({'routed' if routed else 'exhaustive'}"
            f", capacity {dv.capacity}, posting width "
            f"{stream._delta.post_width}) at the {mode} batch B={bsz}: "
            f"{ms:.4f} ms (CUDA events, 3 back to back){sums}")
    return results


def stream_hold(torch, stream, q, lookups_per_s):
    """K1 and K3 with the stream's dead tile (its tombstones) at the first
    batch of each mode, bitwise against their plain versions, and timed
    (paged and grouped) beside bounds and plain versions."""
    rows = {}
    store_ids = stream.base.arrays.block_ids
    live = stream._device_state().live_full
    dead = ((store_ids >= 0) & ~live[store_ids.clamp_min(0).long()]).to(
        torch.uint8)
    check(bool(dead.any()), "stream: the dead tile has no tombstones")
    for mode, bsz in RUNS:
        k1, k3, qt, fetch, pw = mode_inputs(stream.base,
                                            q[:bsz].contiguous(), mode)
        held = hold_inputs(torch, (k1, k3[:-1] + (dead,), qt, fetch, pw),
                           mode, "stream", global_tables=False, form="fast",
                           k3_form="shared")
        if mode != "clustered":
            rows[mode] = kernel_rows(torch, held, mode, "timing: stream",
                                     lookups_per_s)
        del held
    return rows


def delta_inputs(torch, dev, seed, b, *, cap, nlist=4096, p=32, m=64, k=16,
                 width=256, signed=False):
    """Routed-delta inputs made on the card from ``seed``: (lut, codes,
    ids, post, assigns, sel, rank_of) as ``ops.delta_scan_topk`` takes
    them.  Uniform codes, 5% dead slots, two assigned lists a slot,
    uniform over the lists (above width 256 a quarter of the slots' first
    list among 256 hot lists, so that their rows pass 256); postings in
    slot order, each row a prefix of slots (past the width left out);
    ``p`` distinct random lists a query and their ranks (2**30
    elsewhere); tables uniform in [0, 4), or in [-2, 2) where ``signed``
    (inner product)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lut = torch.rand((b, m, k), generator=g, device=dev) * 4
    if signed:
        lut -= 2
    codes = torch.randint(0, k, (cap, m), generator=g, device=dev,
                          dtype=torch.uint8)
    ids = torch.arange(cap, dtype=torch.int32, device=dev) + 1_000_000
    ids[torch.rand(cap, generator=g, device=dev) < 0.05] = -1
    assigns = torch.randint(0, nlist, (cap, 2), generator=g, device=dev,
                            dtype=torch.int32)
    if width > 256:
        hot = torch.rand(cap, generator=g, device=dev) < 0.25
        assigns[:, 0] = torch.where(hot, assigns[:, 0] % 256, assigns[:, 0])
    # postings: each slot under its distinct lists, in slot order
    lists = torch.cat([assigns[:, 0], assigns[:, 1]])
    slots = torch.arange(cap, device=dev).repeat(2)
    keep = torch.cat([torch.ones(cap, dtype=torch.bool, device=dev),
                      assigns[:, 1] != assigns[:, 0]])
    lists, slots = lists[keep].long(), slots[keep]
    order = torch.sort(lists * cap + slots).indices
    lists, slots = lists[order], slots[order]
    start = torch.searchsorted(lists, torch.arange(nlist, device=dev))
    col = torch.arange(lists.numel(), device=dev) - start[lists]
    post = torch.full((nlist, width), -1, dtype=torch.int32, device=dev)
    fit = col < width
    post[lists[fit], col[fit]] = slots[fit].to(torch.int32)
    sel = torch.stack([torch.randperm(nlist, generator=g, device=dev)[:p]
                       for _ in range(b)]).to(torch.int32)
    rank_of = torch.full((b, nlist), 2 ** 30, dtype=torch.int32, device=dev)
    rank_of.scatter_(1, sel.long(), torch.arange(
        p, dtype=torch.int32, device=dev).expand(b, p).contiguous())
    return lut, codes, ids, post, assigns, sel, rank_of


def delta_hold(torch, dev, seed):
    """The routed delta scan's kernel (``ops.delta_scan_topk``) bitwise
    against its plain version (``routed_delta_topk``: ids, distances, the
    kept count and the walk) at ``DELTA_CHECK``'s shapes, one launch a
    call in the form its shape names, each timed by graph replays beside
    the plain version (module docstring, phase stream)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.pq_scan import delta_scan_topk_kernel as kern
    from repro_torch.kernels.ref import routed_delta_topk
    cases = [(f"L {w} K {k} {'ip' if signed else 'l2'}", dict(width=w, k=k,
              signed=signed), b, DELTA_FETCH, "shared")
             for w in DELTA_WIDTHS for k in DELTA_KS
             for signed in (False, True) for b in DELTA_BATCHES]
    cases += [(f"form {form}", kw, b, fetch, form)
              for form, kw, b, fetch in DELTA_FORM_CASES]
    for i, (what, kw, b, fetch, form) in enumerate(cases):
        shape = dict(DELTA_CHECK, **kw)
        args = delta_inputs(torch, dev, seed + i, b, **shape)
        forms = dict(kern.forms)
        got = ops.delta_scan_topk(*args, fetch=fetch)
        want = routed_delta_topk(*args, fetch)
        torch.cuda.synchronize()
        check(kern.forms[form] == forms[form] + 1
              and sum(kern.forms.values()) == sum(forms.values()) + 1,
              f"delta scan {what} B={b}: not one launch of form {form}")
        for name, g_, w_ in zip(("distances", "ids", "dco", "walked"), got,
                                want):
            check(torch.equal(g_, w_), f"delta scan {what} B={b}: {name} "
                  "differ from the plain version")
        ms = graph_ms(torch, lambda: ops.delta_scan_topk(*args, fetch=fetch))
        plain_ms = graph_ms(torch, lambda: routed_delta_topk(*args, fetch),
                            calls=2, reps=2)
        kept, walked = got[2].double().mean(), got[3].double().mean()
        log(f"delta scan {what} B={b} fetch {fetch}: kernel bitwise the "
            f"plain version ({form} form); {ms:.4f} ms (graph replays), "
            f"plain {plain_ms:.4f} ms; kept {kept:.1f} of {walked:.1f} "
            f"walked a query, cap {shape['cap']}, P*L "
            f"{shape['p'] * shape.get('width', 256)}")
        del args, got, want


def stream_path(torch, dev, args, lookups_per_s):
    """Streaming on the main index's configuration (module docstring,
    phase stream).  Returns (kernel rows, launches of the six-mode runs by
    name and form)."""
    from repro_torch.core import (IndexConfig, RefineParams, build_index,
                                  build_seil_call_count)
    from repro_torch.data import make_dataset
    from repro_torch.kernels.pq_scan import launch_counts, reset_launch_counts
    delta_hold(torch, dev, args.seed)
    n, n_ins = args.n, args.n // 4
    per = n_ins // STREAM_BATCHES
    x, q, _ = make_dataset("sift1m", args.seed, n=n + n_ins,
                           n_queries=args.queries, device=dev)
    t0 = time.perf_counter()
    base = build_index(x[:n], IndexConfig(**INDEX),
                       generator=torch.Generator().manual_seed(args.seed),
                       device=dev)
    torch.cuda.synchronize()
    log(f"stream: a sift1m-shaped draw of {n + n_ins} x {x.shape[1]}: the "
        f"main index's configuration built on its first {n} in "
        f"{time.perf_counter() - t0:.2f} s; {STREAM_BATCHES} batches of "
        f"{per} inserted")
    stream = base.streaming()
    builds = build_seil_call_count()
    reset_launch_counts()
    for i in range(STREAM_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = stream.insert(x[n + i * per:n + (i + 1) * per])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(np.array_equal(ids, np.arange(n + i * per, n + (i + 1) * per)),
              "stream: inserted ids are not the next ids")
        log(f"stream: insert batch {i + 1}: {per / dt:.1f} vectors/s "
            f"(assign + encode + buffer patches), capacity "
            f"{stream._delta.capacity}, posting width "
            f"{stream._delta.post_width}, routed "
            f"{stream.routes_at(SEARCH['nprobe'])}")
        if i + 1 in (STREAM_BATCHES // 2, STREAM_BATCHES):
            # at full size: capacity 131,072 = nlist * block, the last
            # exhaustive bucket, then 262,144, routed
            routed = stream.routes_at(SEARCH["nprobe"])
            check(args.n != 1_000_000 or routed == (i + 1 == STREAM_BATCHES),
                  f"stream: capacity {stream._delta.capacity} routes "
                  f"{routed}")
            state = "routed" if routed else "exhaustive"
            stream_runs(torch, stream, q, f"stream {state} ({i + 1} batches)")
            shard_view, pinned = sharded_stream(torch, stream, q, state)
    launches = launch_counts(forms=True)
    check(build_seil_call_count() == builds, "stream: an insert built a "
          "layout")
    for kern, form in (("pq_scan_tiled_kernel", "fast"),
                       ("pq_scan_topk_kernel", "shared")):
        check(launches[kern] > 0 and launches[f"{kern}[{form}]"]
              == launches[kern], f"stream: {kern} launches "
              f"{launches[kern]}, {launches[f'{kern}[{form}]']} {form}")
    check(launches["merge_topk_kernel"] > 0, "stream: no merge launch")
    check(args.n != 1_000_000 or launches["delta_scan_topk_kernel"] > 0,
          "stream: the routed delta scan launched no kernel")
    log(f"stream: launches over the twelve runs {json.dumps(launches)}")
    # deletes: half base, half delta
    rng = np.random.default_rng(args.seed)
    victims = np.concatenate([
        rng.choice(n, n_ins // 4, replace=False),
        n + rng.choice(n_ins, n_ins // 4, replace=False)])
    t0 = time.perf_counter()
    for part in np.array_split(victims, 10):
        stream.delete(part)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(stream.n_dead == victims.size, "stream: delete count")
    log(f"stream: deleted {victims.size} ids (half base, half delta) at "
        f"{victims.size / dt:.1f} vectors/s")
    sharded_stream_stale(torch, shard_view, pinned, q)
    del pinned
    stream_runs(torch, stream, q, "stream deleted")
    # plan reuse (grouped B=64) and the pq4 plane at refine factor 4
    bsz = dict(RUNS)["grouped"]
    plain = stream_session(stream, "grouped", bsz, False)(q[:8 * bsz])
    reuse = stream_session(stream, "grouped", bsz, False, plan_reuse=True)
    reuse.warmup_widths(bsz)
    got = reuse(q[:8 * bsz])
    check_agree(torch, {("paged", False): plain,
                        ("grouped plan_reuse", False): got},
                "stream, plan reuse")
    ps = reuse.compile_stats()["plan"]
    log(f"stream: plan reuse grouped B={bsz}: hit_rate {ps['hit_rate']:.4f}, "
        f"mean_width {ps['mean_width']:.1f}")
    stream.plane("pq4")
    two = {}
    for mode, b in RUNS:
        for fused in (False, True):
            two[(mode, fused)] = stream_session(
                stream, mode, b, fused,
                refine=RefineParams("pq4", 4))(q[:2048])
    rec = live_recall(live_truth(stream, q[:2048]), two[("paged", True)].ids,
                      "stream pq4 x 4", REFINE_FLOOR)
    check_agree(torch, two, "stream, pq4 x 4")
    log(f"stream: pq4 x 4 two-tier sessions in the six modes agree; "
        f"recall@10 {rec:.4f} over the live set")
    rows = stream_hold(torch, stream, q, lookups_per_s)
    # steady state inside one capacity bucket and posting width, with a
    # pq4 x 4 session a round: the plane's delta codes patched in place
    cap, width = stream._delta.capacity, stream._delta.post_width
    st0 = stream.searcher_stats()
    plane_buf = stream._plane_delta_codes("pq4")
    paged = dict(RUNS)["paged"]
    small = min(1024, (cap - stream._delta.count) // 10)
    spare = torch.from_numpy(steady_rows(stream, 10 * small)).to(dev)
    t_ins = t_del = 0.0
    for r in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = stream.insert(spare[r * small:(r + 1) * small])
        torch.cuda.synchronize()
        t_ins += time.perf_counter() - t0
        t0 = time.perf_counter()
        stream.delete(np.concatenate([new[:small // 2],
                                      stream.live_ids()[:small // 2]]))
        torch.cuda.synchronize()
        t_del += time.perf_counter() - t0
        for mode, b in RUNS:
            for fused in (False, True):
                stream_session(stream, mode, b, fused)(q[:b])
        stream_session(stream, "paged", paged, True,
                       refine=RefineParams("pq4", 4))(q[:paged])
    st = stream.searcher_stats()
    check(stream._delta.capacity == cap and stream._delta.post_width == width,
          "stream: the steady state left its capacity bucket or posting "
          "width")
    check(st["compiles"] == st0["compiles"], f"stream: steady churn "
          f"captured {st['compiles'] - st0['compiles']} new graphs")
    check(st["invalidations"] - st0["invalidations"]
          == 10 * (2 * len(RUNS) + 1),
          "stream: a session was not reissued after each round's "
          "mutations")
    check(build_seil_call_count() == builds, "stream: churn built a layout")
    check(stream._plane_delta_codes("pq4") is plane_buf, "stream: the pq4 "
          "plane's delta codes were made anew, not patched in place")
    differ = plane_differs(stream, "pq4", plane_buf)
    check(differ.size == 0, f"stream: the pq4 plane's delta codes of rows "
          f"{differ[:20]}, patched a batch at a time, differ from one encode "
          "of the whole delta buffer (one encode kernel, codes independent "
          "of the batch)")
    log("stream: the pq4 plane's delta codes, patched a batch at a time, "
        "are bitwise one encode of the whole delta buffer")
    log(f"stream: steady state, 10 rounds of {small} inserts and {small} "
        f"deletes inside capacity {cap}: append {10 * small / t_ins:.1f} "
        f"vectors/s, delete {10 * small / t_del:.1f} vectors/s; compiles "
        f"{st['compiles']} (none new), {st['invalidations'] - st0['invalidations']} "
        f"stale sessions reissued; device memory allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, reserved "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB with the "
        "stream's graphs")
    stream_compact(torch, stream, q, x, n, args)
    sharded_stream_compacted(torch, stream, shard_view, q)
    return rows, launches


def steady_rows(stream, count, margin=8):
    """``count`` copies of delta vectors whose assigned lists keep
    ``margin`` free posting columns after all of them are inserted, so
    that the posting width (a captured shape of the routed sessions) does
    not grow: a steady state inside one bucket."""
    d = stream._delta
    room = d.post_width - margin - d.post_n.astype(np.int64)
    rows = []
    for s in range(d.count):
        lists = np.unique(d.assigns[s])
        if (room[lists] > 0).all():
            room[lists] -= 1
            rows.append(s)
            if len(rows) == count:
                return d.vectors[rows]
    fail(f"stream: only {len(rows)} of {count} rows fit the posting width")


def plane_differs(stream, backend, codes):
    """Rows of a plane's delta codes ``codes`` (encoded a batch at a
    time) that differ from one encode of the whole delta buffer: none
    may, as the encode kernel's codes depend on the row alone."""
    from repro_torch.quant import encode_plane
    want = encode_plane(stream.plane(backend).codec, stream._delta.vectors)
    return np.nonzero((codes.cpu().numpy() != want).any(axis=1))[0]


def assign_ties(torch, stream_vecs, centroids, a, b, cfg):
    """Rows whose stored assignment ``a`` differs from a fresh one ``b``:
    each must be an f32 tie, the f64 gap between the two decisions within
    the rounding of an f32 (n, nlist) distance matmul.  Returns (rows,
    largest relative gap)."""
    rows = np.nonzero((a != b).any(axis=1))[0]
    worst = 0.0
    c64 = centroids.double().cpu()
    for r in rows.tolist():
        xr = stream_vecs[r].double().cpu()
        d2 = ((c64 - xr) ** 2).sum(dim=1)
        srt = torch.sort(d2)
        cand = srt.indices[:cfg.n_cands]
        res = c64[cand] - xr
        loss = d2[cand] + cfg.lam * (res @ res[0])
        scale = float(xr @ xr + (c64[cand] ** 2).sum(dim=1).max())
        lists = sorted(set(a[r].tolist()) ^ set(b[r].tolist()))
        gaps = []
        for la in lists:
            for lb in lists:
                if la < lb:
                    gaps.append(abs(float(d2[la] - d2[lb])))
                    ia, ib = (cand == la).nonzero(), (cand == lb).nonzero()
                    if ia.numel() and ib.numel():
                        gaps.append(abs(float(loss[ia[0, 0]]
                                              - loss[ib[0, 0]])))
        gap = min(gaps) / scale if gaps else float("inf")
        check(gap <= TIE_REL, f"stream compaction: row {r} assigned "
              f"{a[r].tolist()} at insert and {b[r].tolist()} by a full "
              f"build, relative gap {gap:.3e}: not an f32 tie")
        worst = max(worst, gap)
    return rows, worst


def stream_compact(torch, stream, q, x, n, args):
    """compact() bitwise against build_seil over the survivors' stored
    assignments and codes; beside a full build_index with the frozen
    training (rows assigned otherwise must be f32 ties, and every code
    equal: the build and the inserts encoded with the same kernel);
    begin_compact -> fold() on a thread while batches are served and the
    stream mutates -> install(), external ids resolving across both
    epochs; the stream saved, reloaded and answering alike."""
    import tempfile
    import threading
    from repro_torch.core import (build_index, build_seil, load_index,
                                  save_index)
    from repro_torch.core.seil import SEIL_FIELDS
    live = stream.live_mask()
    keep_assigns = stream.assigns[live]
    keep_codes = stream.codes[live]
    keep_vecs = stream.vectors[torch.from_numpy(
        np.nonzero(live)[0]).to(stream.device)]
    handles = stream.external_ids(stream.live_ids()[::997])
    torch.cuda.synchronize()
    info = stream.compact()
    torch.cuda.synchronize()
    log(f"stream: compact() {info['seconds']:.2f} s (layout "
        f"{info['layout_seconds']:.2f} s): {info['n_live']} live, "
        f"{info['dropped']} dropped, epoch {info['epoch']}")
    cfg = stream.config
    want, want_stats = build_seil(
        keep_assigns, keep_codes, np.arange(keep_codes.shape[0],
                                            dtype=np.int32),
        cfg.nlist, block=cfg.block, shared=cfg.seil and cfg.multi_m == 2,
        code_bits=cfg.nbits, device=stream.device)
    for f in SEIL_FIELDS:
        check(torch.equal(getattr(stream.base.arrays, f), getattr(want, f)),
              f"stream: the compacted layout differs from build_seil over "
              f"the survivors on {f}")
    check(stream.base.stats == want_stats and torch.equal(
        stream.base.vectors, keep_vecs), "stream: compacted stats/vectors")
    t0 = time.perf_counter()
    full = build_index(keep_vecs, cfg, centroids=stream.centroids,
                       codebook=stream.codebook, device=stream.device)
    torch.cuda.synchronize()
    rows, worst = assign_ties(torch, keep_vecs, stream.centroids,
                              keep_assigns, full.assigns, cfg)
    code_rows = np.nonzero((keep_codes != full.codes).any(axis=1))[0]
    log(f"stream: a full build_index over the {keep_codes.shape[0]} "
        f"survivors with the frozen training ({time.perf_counter() - t0:.2f}"
        f" s) assigns {rows.size} rows otherwise than their inserts did "
        f"(each an f32 tie, largest relative gap {worst:.2e}: {rows[:20]}) "
        f"and encodes {code_rows.size} rows otherwise")
    check(code_rows.size == 0, f"stream: the full build encodes rows "
          f"{code_rows[:20]} otherwise than the build and inserts did (one "
          "encode kernel, codes independent of the batch)")
    same = all(torch.equal(getattr(full.arrays, f),
                           getattr(stream.base.arrays, f))
               for f in SEIL_FIELDS)
    log(f"stream: the full build's layout is "
        f"{'bitwise equal to' if same else 'not bitwise equal to'} the "
        "compacted one")
    del full, want
    resolved = stream.resolve_ids(handles)
    check((resolved >= 0).all() and np.array_equal(
        stream.external_ids(resolved), handles), "stream: external ids do "
        "not resolve after compact()")
    # zero-downtime compaction with a mutation tail
    stream.insert(x[n:n + 4096] + 0.002)
    stream.delete(stream.live_ids()[:2048])
    handles = stream.external_ids(stream.live_ids()[::991])
    pend = stream.begin_compact()
    worker = threading.Thread(target=pend.fold)
    t0 = time.perf_counter()
    worker.start()
    served = 0
    tail = []
    while worker.is_alive() or served < 4:
        tail.append(stream.external_ids(stream.insert(
            x[n + 4096 + 256 * served:n + 4096 + 256 * (served + 1)]
            + 0.003)))
        stream.delete(stream.live_ids()[served * 64:(served + 1) * 64])
        for mode, b in RUNS:
            stream_session(stream, mode, b, True)(q[:b])
        served += 1
    worker.join()
    t_fold = time.perf_counter() - t0
    info = pend.install()
    torch.cuda.synchronize()
    tail_handles = np.concatenate(tail)
    check(info["replayed_inserts"] > 0 and info["replayed_deletes"] > 0,
          "stream: begin_compact replayed no tail")
    for h in (handles, tail_handles):
        got = stream.resolve_ids(h)
        check(np.array_equal(stream.external_ids(got[got >= 0]),
                             h[got >= 0]), "stream: external ids do not "
              "round-trip across the epochs")
    check((stream.resolve_ids(tail_handles) >= 0).sum() > 0,
          "stream: no tail insert resolves after install()")
    log(f"stream: begin_compact: fold() on a thread for {t_fold:.2f} s "
        f"while {served} rounds of six batches were served and the stream "
        f"mutated; install() {info['seconds']:.2f} s in all (layout "
        f"{info['layout_seconds']:.2f} s), replayed "
        f"{info['replayed_inserts']} inserts and "
        f"{info['replayed_deletes']} deletes, epoch {info['epoch']}; "
        "external ids resolve across both epochs")
    stream_runs(torch, stream, q[:2048], "stream epoch 2")
    stream_gateway(torch, stream, q, x, n, args.seed)
    res = {(mode, True): stream_session(stream, mode, b, True)(q[:2048])
           for mode, b in RUNS}
    # persistence: the mutated stream saved, reloaded, answering alike
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = Path(tmp) / "stream.npz"
        t0 = time.perf_counter()
        save_index(stream, path)
        t1 = time.perf_counter()
        back = load_index(path, device=stream.device)
        torch.cuda.synchronize()
        log(f"stream: saved {path.stat().st_size} bytes in {t1 - t0:.2f} s,"
            f" loaded on the card in {time.perf_counter() - t1:.2f} s")
    check(type(back).__name__ == "StreamingIndex" and back.version
          == stream.version and np.array_equal(back.live_mask(),
                                               stream.live_mask()),
          "stream: the reloaded bundle's epoch state differs")
    for mode, b in RUNS:
        got = stream_session(back, mode, b, True)(q[:2048])
        for f in got._fields:
            check(torch.equal(getattr(got, f),
                              getattr(res[(mode, True)], f)),
                  f"stream: the reloaded stream differs in {mode} on {f}")
    log("stream: the reloaded stream answers bitwise alike in the three "
        "modes (fused)")


# ---------------------------------------------------------------------------
# phase gateway: the serving gateway over the main index's sessions
# ---------------------------------------------------------------------------
class Recorder:
    """A gateway as ``run_open_loop`` sees it (``submit``) that keeps each
    request's handle: the load generator returns ids, not each answer's
    batch size or quality level."""

    def __init__(self, gw):
        self.gw, self.reqs = gw, []

    def submit(self, query):
        req = self.gw.submit(query)
        self.reqs.append(req)
        return req


def recording_gateway():
    """``Gateway`` that keeps the queries of its first flushed batch
    (``first``), the batch K1 and K3 are held at."""
    from repro_torch.gateway import Gateway

    class Recording(Gateway):
        first = None

        def _dispatch(self, batch):
            if self.first is None:
                self.first = np.stack([r.query for r in batch])
            super()._dispatch(batch)
    return Recording


def gw_answers(reqs, k=10):
    """Host arrays of finished requests: ok, ids (n, k) (-1 where the
    request failed), dists, batch size, quality level, epoch; and
    ``errors``, the distinct failures other than shedding, each with its
    count and the traceback of its first occurrence."""
    from repro_torch.errors import Overloaded
    import traceback
    n = len(reqs)
    out = dict(ok=np.zeros(n, bool), ids=np.full((n, k), -1, np.int64),
               dists=np.full((n, k), np.inf, np.float32),
               batch=np.zeros(n, np.int64), level=np.zeros(n, np.int64),
               epoch=np.zeros(n, np.int64), errors={})
    for i, req in enumerate(reqs):
        try:
            r = req.result(GW_WAIT)
        except Overloaded:
            continue
        except Exception as e:
            err = out["errors"].setdefault(repr(e), [0, "".join(
                traceback.format_exception(type(e), e, e.__traceback__))])
            err[0] += 1
            continue
        out["ok"][i] = True
        out["ids"][i], out["dists"][i] = r.ids, r.dists
        out["batch"][i], out["level"][i], out["epoch"][i] = (
            r.batch, r.level, r.epoch)
    return out


def level_recall(ans, gt, pool):
    """recall@10 of the answered requests by quality level (request i
    asked query i % pool)."""
    from repro_torch.core import recall_at_k
    qi = np.arange(ans["ok"].size) % pool
    out = {}
    for lv in np.unique(ans["level"][ans["ok"]]):
        m = ans["ok"] & (ans["level"] == lv)
        out[int(lv)] = recall_at_k(ans["ids"][m], gt[qi[m]])
    return out


def gw_errors(ans) -> str:
    """The distinct failures gw_answers found, for a failure message."""
    return "; ".join(f"{n} x {e}\n{tb}"
                     for e, (n, tb) in ans["errors"].items())


def gw_point(what, pt, rec, floor=0.5, ans=None, degraded_floor=None):
    """Check and log one open-loop point: every request typed (no untyped
    error), level-0 recall@10 at or above ``floor`` and that of the
    degraded levels at or above ``degraded_floor``."""
    check(pt["errors"] == 0 and pt["closed"] == 0,
          f"{what}: {pt['errors']} untyped errors, {pt['closed']} closed"
          + (": " + gw_errors(ans) if ans is not None else ""))
    check(pt["n_ok"] + pt["shed"] + pt["deadline_failed"]
          == pt["n_requests"], f"{what}: requests unaccounted for")
    check(0 not in rec or rec[0] >= floor,
          f"{what}: level-0 recall@10 {rec.get(0)} below {floor}")
    check(degraded_floor is None or all(
        v >= degraded_floor for lv, v in rec.items() if lv > 0),
          f"{what}: a degraded level's recall@10 below {degraded_floor}: "
          f"{rec}")
    log(f"{what}: offered {pt['offered_qps']:.1f} qps, achieved "
        f"{pt['achieved_qps']:.1f} qps, p50 / p95 / p99 {pt['p50_ms']:.3f} / "
        f"{pt['p95_ms']:.3f} / {pt['p99_ms']:.3f} ms, mean batch "
        f"{pt['mean_batch']:.2f}; {pt['n_ok']} ok, {pt['shed']} shed, "
        f"{pt['deadline_failed']} deadline-failed, 0 errors; responses by "
        f"level {json.dumps(pt['levels'])}, recall@10 by level "
        + json.dumps({k: round(v, 4) for k, v in rec.items()}))


def gateway_ties(torch, index, q, pairs, want_bsz, what):
    """Rows a gateway answered otherwise than the direct session (run at
    batch size ``want_bsz``): ``pairs`` of (query row, the gateway
    batch's bucket).  As in batch_size_ties, each must be a stage-1
    near-tie (stage1_tie) between the query at row 0 of a zero-padded
    batch of the bucket and in its chunk of ``want_bsz``.  Returns the
    largest relative gap."""
    from repro_torch.core.engine import select_lists
    from repro_torch.core.kmeans import pairwise_sq_l2

    def stage1(qb, b):
        qb = torch.cat([qb, qb.new_zeros((b - qb.shape[0], qb.shape[1]))])
        return (select_lists(qb, index.centroids, nprobe=SEARCH["nprobe"]).sel,
                pairwise_sq_l2(qb, index.centroids))
    direct, worst = {}, 0.0
    for r, b in pairs:
        sa, ca = (t[0] for t in stage1(q[r:r + 1], int(b)))
        c = r // want_bsz
        if c not in direct:
            direct[c] = stage1(q[c * want_bsz:(c + 1) * want_bsz], want_bsz)
        sb, cb = (t[r % want_bsz] for t in direct[c])
        check(not torch.equal(sa, sb), f"{what}: query {r} (bucket {b}) is "
              "answered otherwise than by the session although stage 1 "
              "agrees")
        worst = max(worst, stage1_tie(r, sa, sb, ca, cb,
                                      f"{what}: buckets {b} / {want_bsz}"))
    return worst


def gw_equal(torch, index, q, ans, rows, want, want_bsz, params, what):
    """A gateway's answers (``gw_answers`` of requests asking query
    ``rows[i]``; the gateway's ``params`` bucket its batches) against the
    direct session's host ids / dists at batch size ``want_bsz``:
    differing rows classified (gateway_ties) and logged."""
    p = params
    check(bool(ans["ok"].all()),
          f"{what}: a request failed: " + gw_errors(ans))
    wi, wd = want
    differ = np.nonzero((ans["ids"] != wi[rows]).any(axis=1))[0]
    pairs = [(int(rows[i]), p.bucket_for(int(ans["batch"][i])))
             for i in differ]
    same = np.setdiff1d(np.arange(rows.size), differ)
    check(np.allclose(ans["dists"][same], wd[rows[same]], rtol=1e-5,
                      atol=1e-5), f"{what}: equal ids with other distances")
    worst = gateway_ties(torch, index, q, pairs, want_bsz, what)
    log(f"{what}: {rows.size} answers, {rows.size - differ.size} equal to "
        f"the direct session's (B={want_bsz}); {differ.size} differ, each a "
        f"stage-1 near-tie (the centroid product rounds otherwise at the "
        f"gateway's bucket; largest relative gap {worst:.2e})")
    return differ.size


def gw_reserved(torch, what):
    log(f"{what}: device memory allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, reserved "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB")


def dense_check(torch, index, q):
    """The dense path on the first DENSE_QUERIES queries at the main
    path's nprobe against a paged session whose budget drops no block,
    at the dense chunk's batch size (one stage-1 shape for both): DCO
    and scanned blocks equal, ids within 2 a row; the nprobe sweep
    against single runs; seconds and peak memory."""
    from repro_torch.core import (dense_search, dense_search_multi,
                                  make_dense_aux)
    idx = index
    qd = q[:DENSE_QUERIES].contiguous()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    idx._dense_aux = make_dense_aux(idx.arrays, idx.codebook)
    torch.cuda.synchronize()
    t_aux = time.perf_counter() - t0
    aux_b = sum(t.numel() * t.element_size()
                for t in vars(idx._dense_aux).values())
    dense_search(idx, qd[:128], nprobe=SEARCH["nprobe"], k=SEARCH["k"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rd = dense_search(idx, qd, nprobe=SEARCH["nprobe"], k=SEARCH["k"])
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    a = idx.arrays
    cap = SEARCH["nprobe"] * (a.owned.shape[1] + a.refs.shape[1]
                              + a.misc.shape[1])
    sess = session(idx, "paged", 128, True, max_scan=cap)
    sess.warmup(128)
    rb = sess(qd)
    check(int(rb.dropped_blocks.max()) == 0, "dense: the blocked session "
          "dropped blocks")
    for f in ("approx_dco", "refine_dco", "scanned_blocks"):
        check(torch.equal(getattr(rb, f), getattr(rd, f)),
              f"dense: {f} differs from the blocked session's")
    gb, gd = rb.ids.cpu().numpy(), rd.ids.cpu().numpy()
    sym = [len(set(gb[i][gb[i] >= 0].tolist())
               ^ set(gd[i][gd[i] >= 0].tolist())) for i in range(len(gb))]
    check(max(sym) <= 2, f"dense: ids of a query differ by {max(sym)} from "
          "the blocked session's (at most 2)")
    multi = dense_search_multi(idx, qd, nprobes=(8, SEARCH["nprobe"]),
                               k=SEARCH["k"])
    for p, r in zip((8, SEARCH["nprobe"]), multi):
        single = rd if p == SEARCH["nprobe"] else dense_search(
            idx, qd, nprobe=p, k=SEARCH["k"])
        for f in r._fields:
            check(torch.equal(getattr(r, f), getattr(single, f)),
                  f"dense: the nprobe sweep differs from nprobe={p} on {f}")
    log(f"dense: aux built in {t_aux:.2f} s ({aux_b / 2 ** 30:.3f} GiB on "
        f"the card: {idx._dense_aux.dec.shape[0]} decoded items); "
        f"{DENSE_QUERIES} queries at nprobe {SEARCH['nprobe']} in "
        f"{t_dense:.4f} s ({DENSE_QUERIES / t_dense:.1f} qps, chunks of "
        f"128), peak device memory {peak / 2 ** 30:.3f} GiB above the "
        f"index; against paged B=128 max_scan={cap} (drops no block): "
        f"approx / refine DCO and scanned blocks equal per query (approx "
        f"DCO/q {rd.approx_dco.float().mean().item():.1f}), ids equal on "
        f"{sum(s == 0 for s in sym)} of {len(sym)} queries, the rest within "
        f"{max(sym)}; the nprobe sweep (8, {SEARCH['nprobe']}) bitwise "
        "equal to single runs")
    idx._dense_aux = None
    release_sessions(torch, "dense")


def gateway_path(torch, index, q, gt, results, lookups_per_s):
    """The serving gateway on the main index (module docstring, phase
    gateway).  Returns (kernel rows at the fused gateway's first flushed
    batch, launches of the gateway runs by name and form)."""
    from repro_torch.core import SearchParams
    from repro_torch.gateway import Gateway, GatewayConfig, run_open_loop
    from repro_torch.kernels.pq_scan import launch_counts, reset_launch_counts
    dense_check(torch, index, q)
    qh = q.cpu().numpy()            # clients submit host vectors
    # the direct sessions' answers (the main path's B=1024 runs) on the
    # host: this thread does no CUDA work while a gateway is live
    want = {key: (results[key].ids.cpu().numpy().astype(np.int64),
                  results[key].dists.cpu().numpy())
            for key in (("paged", True), ("paged", False),
                        ("clustered", True))}
    pb = dict(RUNS)["paged"]
    params = SearchParams(**GATEWAY)
    cfg = GatewayConfig(max_batch=GW_BATCH, max_delay_ms=GW_DELAY_MS)
    torch.cuda.synchronize()
    reset_launch_counts()
    # equality: a burst of GW_EQUAL queries through a fused gateway (K3
    # and its merge) and an unfused one (K1)
    eq, first = {}, None
    for fused in (True, False):
        t0 = time.perf_counter()
        gw = recording_gateway()(index, dataclasses.replace(
            params, fused_topk=fused), config=cfg)
        warm = time.perf_counter() - t0
        with gw:
            t0 = time.perf_counter()
            ans = gw_answers([gw.submit(qh[i]) for i in range(GW_EQUAL)])
            dt = time.perf_counter() - t0
            tel = gw.stats()["telemetry"]
        if fused:
            first = gw.first
        eq[fused] = (ans, dt, warm, tel)
    for fused in (True, False):
        ans, dt, warm, tel = eq[fused]
        gw_equal(torch, index, q, ans, np.arange(GW_EQUAL),
                 want[("paged", fused)], pb, params,
                 f"gateway equality fused={int(fused)}")
        log(f"gateway equality fused={int(fused)}: {GW_EQUAL} queries in "
            f"{dt:.3f} s ({GW_EQUAL / dt:.1f} qps, a burst), batches "
            f"{tel['counters']['batches']}, batch fill "
            f"{tel['batch_fill']:.2f}, bucket fill {tel['bucket_fill']:.3f}; "
            f"dispatch p50 / p99 {tel['dispatch']['p50_ms']:.3f} / "
            f"{tel['dispatch']['p99_ms']:.3f} ms; the ladder's "
            f"{tel['counters'].get('warmup_compiles', 0)} CUDA graphs "
            f"captured in {warm:.2f} s at start")
    gw_reserved(torch, "gateway equality")
    # the serve sweep (BENCH_serve.json's protocol at full width)
    per = GatewayConfig(max_batch=1, max_delay_ms=0.0, admission="fifo")
    with Gateway(index, params, config=per) as gw:
        gw.search(qh[0], timeout=GW_WAIT)
        cal = run_open_loop(gw, qh, 1e6, GW_CALIBRATE, seed=99,
                            timeout_s=GW_WAIT)
        ptel = gw.stats()["telemetry"]
    check(cal["errors"] == 0 and cal["n_ok"] == GW_CALIBRATE,
          "gateway: per-request calibration failed requests")
    cap = cal["achieved_qps"]
    log(f"gateway serve: per-request capacity (max_batch=1, max_delay_ms=0, "
        f"{GW_CALIBRATE} back-to-back arrivals) {cap:.1f} qps, p50 / p99 "
        f"{cal['p50_ms']:.3f} / {cal['p99_ms']:.3f} ms; dispatch p50 "
        f"{ptel['dispatch']['p50_ms']:.4f} ms")
    with Gateway(index, params, config=cfg) as gw:
        gw_reserved(torch, "gateway serve, batched gateway warm")
        for i, f in enumerate(GW_SERVE_LOADS):
            rec = Recorder(gw)
            pt = run_open_loop(rec, qh, f * cap, GW_REQUESTS, seed=i,
                               timeout_s=GW_WAIT)
            ans = gw_answers(rec.reqs)
            gw_point(f"gateway serve {f}x per-request capacity", pt,
                     level_recall(ans, gt, qh.shape[0]), ans=ans)
        served = (pt, ans)
        # the saturating rate of the batched gateway (back-to-back arrivals)
        sat = run_open_loop(gw, qh, 1e6, GW_CALIBRATE, seed=98,
                            timeout_s=GW_WAIT)["achieved_qps"]
        tel = gw.stats()["telemetry"]
        t_sig = gw_signature_us(gw, qh)
    log(f"gateway serve: batched saturating rate {sat:.1f} qps "
        f"({sat / cap:.2f}x per-request); over the sweep batch fill "
        f"{tel['batch_fill']:.2f}, bucket fill {tel['bucket_fill']:.3f}, "
        f"dispatch p50 / p99 {tel['dispatch']['p50_ms']:.3f} / "
        f"{tel['dispatch']['p99_ms']:.3f} ms, queue wait p50 / p99 "
        f"{tel['queue_wait']['p50_ms']:.3f} / "
        f"{tel['queue_wait']['p99_ms']:.3f} ms; admission signature "
        f"{t_sig:.1f} us a query on the host")
    gw_overload(torch, index, qh, gt, params, cfg)
    # clustered with plan reuse behind signature admission
    cl = dataclasses.replace(params, exec_mode="clustered", plan_reuse=True,
                             batch_buckets=(GW_BATCH,))
    t0 = time.perf_counter()
    with Gateway(index, cl, config=cfg) as gw:
        warm = time.perf_counter() - t0
        rec = Recorder(gw)
        pt = run_open_loop(rec, qh[:GW_EQUAL], GW_SERVE_LOADS[-1] * cap,
                           2 * GW_EQUAL, seed=5, timeout_s=GW_WAIT)
        st = gw.stats()["session"]
    ans = gw_answers(rec.reqs)
    gw_point("gateway clustered plan_reuse", pt,
             level_recall(ans, gt, GW_EQUAL), ans=ans)
    gw_equal(torch, index, q, ans, np.arange(2 * GW_EQUAL) % GW_EQUAL,
             want[("clustered", True)], pb, cl,
             "gateway clustered plan_reuse")
    pl = st["plan"]
    log(f"gateway clustered plan_reuse: {warm:.2f} s to warm "
        f"({st['warmup_compiles']} CUDA graphs, the width ladder of bucket "
        f"{GW_BATCH}); hit_rate {pl['hit_rate']:.4f} tiles {pl['tiles']} "
        f"hits {pl['hits']} extends {pl['extends']} misses {pl['misses']} "
        f"mean_width {pl['mean_width']:.1f} mean_union_live "
        f"{pl['mean_union_live']:.1f}")
    gw_traced(torch, index, qh, params)
    torch.cuda.synchronize()
    launches = launch_counts(forms=True)
    log(f"gateway: launches over the gateway runs {json.dumps(launches)}")
    for kern, form in (("pq_scan_tiled_kernel", "fast"),
                       ("pq_scan_topk_kernel", "shared")):
        check(launches[kern] > 0 and launches[f"{kern}[{form}]"]
              == launches[kern], f"gateway: {kern} launches "
              f"{launches[kern]}, {launches[f'{kern}[{form}]']} {form}")
    gw_flush_split(torch, index, qh, served, tel, t_sig, sat)
    release_gateway_sessions(torch, index)
    # K1, K3 and the merge at the fused gateway's first flushed batch
    b = params.bucket_for(first.shape[0])
    qf = torch.from_numpy(first).to(q.device)
    qf = torch.cat([qf, qf.new_zeros((b - qf.shape[0], qf.shape[1]))])
    held = hold_kernels(torch, index, qf, "paged",
                        f"gateway first flush ({first.shape[0]} queries)",
                        global_tables=False, form="fast")
    rows = kernel_rows(torch, held, "paged", "gateway", lookups_per_s)
    check("merge" not in rows or launches["merge_topk_kernel"] > 0,
          "gateway: K3 splits at the first flush and no merge launched")
    return rows, launches


def gw_overload(torch, index, qh, gt, params, cfg):
    """BENCH_overload.json's protocol at full width: the unbounded
    gateway and a bounded one (reject, a two-level ladder) at fractions
    of their saturating rate.  The one-thread client submits about as
    fast as the batched gateway serves, so it cannot offer twice that
    rate: every flush is slowed by GW_SLOW_S (a ``gateway.dispatch``
    delay fault) so that the dispatcher saturates first.  At 2x the
    bounded gateway must shed or step down, and over the three points
    levels 1 and 2 must answer, each above its recall floor."""
    from repro_torch.faults import FaultPlan, FaultSpec
    from repro_torch.gateway import (Gateway, GatewayConfig, degrade_ladder,
                                     run_open_loop)
    slow = FaultPlan(0, (FaultSpec("gateway.dispatch", kind="delay",
                                   prob=1.0, delay_s=GW_SLOW_S),))
    ladder = degrade_ladder(params, 2)
    ov = GatewayConfig(max_batch=GW_BATCH, max_delay_ms=GW_DELAY_MS,
                       max_queue=GW_MAX_QUEUE, overload="reject",
                       degrade=ladder[1:])
    with slow.installed():
        with Gateway(index, params, config=cfg) as gw:
            gw.search(qh[0], timeout=GW_WAIT)
            sat = run_open_loop(gw, qh, 1e6, GW_CALIBRATE, seed=96,
                                timeout_s=GW_WAIT)["achieved_qps"]
            rec = Recorder(gw)
            unb = run_open_loop(rec, qh, 2 * sat, GW_OVERLOAD_REQUESTS,
                                seed=97, timeout_s=GW_WAIT)
        ans = gw_answers(rec.reqs)
        gw_point("gateway overload 2x, unbounded", unb,
                 level_recall(ans, gt, qh.shape[0]), ans=ans)
        check(unb["shed"] == 0, "gateway overload: the unbounded gateway shed")
        t0 = time.perf_counter()
        with Gateway(index, params, config=ov) as gw:
            log(f"gateway overload: flushes slowed by {GW_SLOW_S * 1e3:.0f} "
                f"ms; saturating rate {sat:.1f} qps; ladder nprobe "
                f"{[p.nprobe for p in ladder]} max_scan "
                f"{[p.max_scan for p in gw._ladder]}, "
                f"{gw.telemetry.counter('warmup_compiles')} CUDA graphs "
                f"captured in {time.perf_counter() - t0:.2f} s")
            gw_reserved(torch, "gateway overload, 3 levels warm")
            levels = {}
            for i, f in enumerate(GW_OVERLOAD_LOADS):
                rec = Recorder(gw)
                down = gw.telemetry.counter("degrade_steps_down")
                pt = run_open_loop(rec, qh, f * sat, GW_OVERLOAD_REQUESTS,
                                   seed=10 + i, timeout_s=GW_WAIT)
                down = gw.telemetry.counter("degrade_steps_down") - down
                ans = gw_answers(rec.reqs)
                gw_point(f"gateway overload {f}x saturating, degrade", pt,
                         level_recall(ans, gt, qh.shape[0]), ans=ans,
                         degraded_floor=GW_DEGRADED_FLOOR)
                for lv, n in pt["levels"].items():
                    levels[lv] = levels.get(lv, 0) + n
            c = gw.stats()["telemetry"]["counters"]
    # the ladder keeps its level from one point to the next (as in the
    # reference's bench), so it may reach level 2 before the 2x point
    check(pt["shed"] > 0 or down > 0, "gateway overload: nothing shed and "
          "the ladder never stepped down at 2x")
    check(all(levels.get(str(lv), 0) > 0 for lv in (1, 2)),
          f"gateway overload: levels 1 and 2 did not both answer over the "
          f"three points ({levels})")
    log(f"gateway overload: p99 at 2x {pt['p99_ms']:.3f} ms bounded against "
        f"{unb['p99_ms']:.3f} ms unbounded; steps down "
        f"{c.get('degrade_steps_down', 0)}, up {c.get('degrade_steps_up', 0)}"
        f", shed {c.get('shed', 0)}, responses by level "
        f"{json.dumps(levels)} over the three points; at 2x shed "
        f"{pt['shed']}, steps down {down}")


def gw_signature_us(gw, qh, n=1000):
    """Microseconds of one admission signature on the host: the
    gateway's own scorer, its dispatcher idle."""
    t0 = time.perf_counter()
    for i in range(n):
        gw._signature(qh[i])
    return (time.perf_counter() - t0) / n * 1e6


def gw_flush_split(torch, index, qh, served, tel, t_sig, sat):
    """Where the serve sweep's top point (``served``: its run_open_loop
    result and gw_answers) spent its time: each flush it counted (its
    requests' batch sizes) at its bucket's device time (one session call,
    a graph replay: CUDA events around calls back to back), summed over
    the point's wall time, is the card's busy share; beside the
    telemetry's dispatch time and the host's admission cost."""
    from repro_torch.core import SearchParams
    pt, ans = served
    params = SearchParams(**GATEWAY)
    sess = index.searcher(params, device=index.device)
    sizes, reqs = np.unique(ans["batch"][ans["ok"]], return_counts=True)
    flushes = {}
    for s, n in zip(sizes.tolist(), reqs.tolist()):
        check(n % s == 0, f"gateway split: {n} requests in batches of {s}")
        b = params.bucket_for(s)
        flushes[b] = flushes.get(b, 0) + n // s
    ms = {}
    for b in sorted(flushes):
        qb = torch.from_numpy(qh[:b]).to(index.device)
        ms[b] = cuda_ms(torch, lambda: sess(qb))
    busy = sum(flushes[b] * ms[b] for b in flushes)
    log(f"gateway split: the {GW_SERVE_LOADS[-1]}x point's "
        f"{sum(flushes.values())} flushes by bucket "
        f"{json.dumps(flushes)}, a session call at each bucket "
        + ", ".join(f"B={b} {ms[b]:.4f} ms" for b in sorted(ms))
        + f": the card busy {busy:.1f} ms of the point's "
        f"{pt['wall_s'] * 1e3:.1f} ms ({100 * busy / (pt['wall_s'] * 1e3):.1f}"
        f"%); the gateway's dispatch (take to fulfil: host, copies and card) "
        f"p50 {tel['dispatch']['p50_ms']:.4f} ms; admission {t_sig:.1f} us a "
        f"request on the client's thread, {t_sig * sat / 1e4:.1f}% of a "
        f"second at the saturating {sat:.1f} qps")


def gw_traced(torch, index, qh, params):
    """A deterministic flush (every request queued before the batch is
    taken) untraced and under the tracer: bitwise equal answers; the
    exported trace valid with gateway.request / gateway.flush events,
    written and read back by the export CLI; the unified snapshot renders
    to Prometheus text."""
    import tempfile
    from repro_torch import obs
    from repro_torch.gateway import Gateway, GatewayConfig
    from repro_torch.obs.export import main as export_main
    n = GW_BATCH
    det = GatewayConfig(max_batch=n, max_delay_ms=60_000.0)
    with Gateway(index, params, config=det) as gw:
        plain = gw_answers([gw.submit(qh[i]) for i in range(n)])
        with obs.trace() as tr:
            traced = gw_answers([gw.submit(qh[i]) for i in range(n)])
        snap = obs.snapshot_all(gateway=gw, tracer=tr)
    check(bool((plain["batch"] == n).all() and (traced["batch"] == n).all()),
          "gateway traced: the flush was not one batch")
    check(np.array_equal(plain["ids"], traced["ids"]) and np.array_equal(
        plain["dists"], traced["dists"]), "gateway traced: the traced "
          "answers differ from the untraced ones")
    doc = obs.validate_trace(obs.to_trace_events(tr))
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    check({"gateway.request", "gateway.flush", "gateway.submit",
           "searcher.dispatch"} <= names,
          f"gateway traced: events {sorted(names)}")
    text = obs.to_prometheus(snap)
    check(len(text.splitlines()) > 50 and "rairs_gateway_telemetry_qps"
          in text, "gateway traced: the Prometheus text is empty")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = Path(tmp) / "gateway_trace.json"
        obs.write_trace(tr, str(path))
        check(export_main([str(path)]) == 0, "gateway traced: the export "
              "CLI refused the trace")
        size = path.stat().st_size
    spans = tr.stage_summary()
    log(f"gateway traced: a flush of {n} bitwise equal to the untraced one; "
        f"{len(doc['traceEvents'])} trace events ({size} bytes), "
        f"{tr.fences} fences; {len(text.splitlines())} Prometheus lines; "
        f"spans (ms, mean): " + ", ".join(
            f"{k} {v['mean_ms']:.4f}" for k, v in sorted(spans.items())))


def release_gateway_sessions(torch, index):
    """Drop the sessions the gateways made on the index (its searcher
    cache) and the device memory of their CUDA graphs."""
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    n = len(index.__dict__.pop("_searcher_cache", {}))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"gateway: {n} sessions released; device memory reserved fell by "
        f"{(before - torch.cuda.memory_reserved()) / 2 ** 30:.3f} GiB")
def stream_gateway(torch, stream, q, x, n, seed):
    """A gateway over the stream (module docstring, phase stream): insert
    / delete round trips through external ids, then open-loop traffic
    before, during and after a ``compact_async`` handover whose first
    fold attempt is made to fail (retried), with an ``on_request`` hook
    inserting and deleting meanwhile: no client error, no deleted id
    served, every served id resolving after install."""
    import threading
    from repro_torch.core import SearchParams
    from repro_torch.faults import FaultPlan, FaultSpec
    from repro_torch.gateway import Gateway, GatewayConfig, run_open_loop
    qh = q[:GW_EQUAL].cpu().numpy()
    xs = (x[n:n + STREAM_GW_INSERTS] + 0.005).cpu().numpy()
    epoch0 = stream.epoch
    cfg = GatewayConfig(max_batch=GW_BATCH, max_delay_ms=GW_DELAY_MS,
                        handover_retries=2, handover_backoff_s=0.05)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gw = Gateway(stream, SearchParams(**GATEWAY), config=cfg)
    warm = time.perf_counter() - t0
    plan = FaultPlan(seed, (FaultSpec("gateway.fold", kind="raise",
                                      at=(0,)),))
    served, deleted, pts = [], set(), {}
    state = {"next": 256}
    try:
        ext = gw.insert(xs[:256])
        r = gw.search(xs[0], timeout=GW_WAIT)
        check(int(r.ids[0]) == int(ext[0]), "stream gateway: an inserted "
              "vector is not its own nearest neighbour by external id")
        check(gw.delete(ext[:64]) == 64, "stream gateway: delete count")
        res = gw.resolve_ids(ext)
        check(bool((res[:64] == -1).all() and (res[64:] >= 0).all()),
              "stream gateway: external ids do not round-trip")
        deleted.update(ext[:64].tolist())
        pre = set(deleted)

        def segment(name, count, seed_, hook=None):
            rec = Recorder(gw)
            pt = run_open_loop(rec, qh, STREAM_GW_QPS, count, seed=seed_,
                               timeout_s=GW_WAIT, on_request=hook)
            ans = gw_answers(rec.reqs)
            check(pt["n_ok"] == count and pt["errors"] == 0
                  and pt["shed"] == 0 and pt["closed"] == 0,
                  f"stream gateway {name}: client errors {json.dumps(pt)}: "
                  + gw_errors(ans))
            served.append(ans["ids"][ans["ok"]].ravel())
            pts[name] = (pt, ans)
            return ans

        segment("before", STREAM_GW_REQUESTS, 21)

        def hook(i):
            if i == 0:
                state["t0"] = time.perf_counter()
                h = state["h"] = gw.compact_async("gateway")
                threading.Thread(target=lambda: (
                    h._done.wait(GW_WAIT),
                    state.setdefault("t1", time.perf_counter())),
                    daemon=True).start()
            if i % 40 == 20 and state["next"] + 16 <= xs.shape[0]:
                s = state["next"]
                state["next"] = s + 16
                new = gw.insert(xs[s:s + 16])
                gw.delete(new[:4])
                deleted.update(new[:4].tolist())

        with plan.installed():
            during = segment("during", 2 * STREAM_GW_REQUESTS, 22, hook)
            info = state["h"].wait(GW_WAIT)
        handover_s = state.get("t1", time.perf_counter()) - state["t0"]
        check(state["h"].state == "installed" and plan.fired() == 1
              and gw.telemetry.counter("handover_retries") == 1,
              "stream gateway: the injected fold failure was not retried "
              "into an install")
        check(not set(during["ids"].ravel().tolist()) & pre,
              "stream gateway: an id deleted before the handover was served")
        after = segment("after", STREAM_GW_REQUESTS, 23)
        check(not set(after["ids"].ravel().tolist()) & deleted,
              "stream gateway: a deleted id was served after install")
        # a capacity jump in the new epoch drops every graph of the old
        # capacity; the gateway's next flush captures into the epoch's
        # pool again (kept alive by its anchor graph)
        cap = stream._delta.capacity
        grow = cap - stream._delta.count + 1
        s = state["next"]
        check(s + grow <= xs.shape[0], "stream gateway: too few vectors "
              "left for a capacity jump")
        jumped = gw.insert(xs[s:s + grow])
        state["next"] = s + grow
        check(stream._delta.capacity > cap, "stream gateway: no capacity "
              "jump")
        r = gw.search(xs[s + grow - 1], timeout=GW_WAIT)
        check(int(r.ids[0]) == int(jumped[-1]), "stream gateway: the "
              "capacity jump's last insert is not its own nearest neighbour")
        served.append(r.ids)
        check(bool((after["epoch"] == stream.epoch).all()),
              "stream gateway: an answer after install from an old epoch")
        ids = np.unique(np.concatenate(served))
        ids = ids[(ids >= 0) & ~np.isin(ids, list(deleted))]
        check(bool((gw.resolve_ids(ids) >= 0).all()), "stream gateway: a "
              "served id does not resolve after install")
        c = gw.stats()["telemetry"]["counters"]
    finally:
        gw.close()
    check(c.get("errors", 0) == 0, "stream gateway: dispatch errors")
    ep = np.bincount(during["epoch"] - epoch0, minlength=2)
    log(f"stream gateway: ladder warm in {warm:.2f} s; insert / delete "
        f"round trip through external ids; handover {handover_s:.3f} s from "
        f"compact_async to installed (fold retried once after an injected "
        f"failure; fold + install {info['seconds']:.3f} s, layout "
        f"{info['layout_seconds']:.3f} s, replayed "
        f"{info['replayed_inserts']} inserts and {info['replayed_deletes']} "
        f"deletes, epoch {epoch0} -> {info['epoch']}); {len(deleted) - 64} "
        f"deletes by the on_request hook; a capacity jump after install "
        f"(capacity {cap} -> {stream._delta.capacity}) captured again; "
        f"'during' answers by epoch {ep.tolist()}; {ids.size} served ids "
        f"resolve after install; stale retries {c.get('stale_retries', 0)},"
        f" client errors 0")
    for name in ("before", "during", "after"):
        pt = pts[name][0]
        log(f"stream gateway {name}: {pt['n_ok']} requests at "
            f"{pt['offered_qps']:.0f} qps offered, achieved "
            f"{pt['achieved_qps']:.1f}, p50 / p95 / p99 {pt['p50_ms']:.3f} / "
            f"{pt['p95_ms']:.3f} / {pt['p99_ms']:.3f} ms, mean batch "
            f"{pt['mean_batch']:.2f}")


# ---------------------------------------------------------------------------
# phase sharded: one index over a mesh of shards, and the serve CLI
# ---------------------------------------------------------------------------
SHARDS = 4                  # the phase's mesh: four shards on cuda:0
SHARD_STREAM_RUNS = (("paged", False), ("paged", True), ("clustered", True))
CLI_SERVE = ("--ndev", "4", "--batches", "4", "--batch-size", "1024",
             "--fused-topk")
CLI_GATEWAY = ("--ndev", "4", "--gateway", "--offered-qps", "2000",
               "--gateway-requests", "2048", "--max-batch", "256")


def shard_session(sharded, mode, bsz, fused, **params):
    """A ShardedSearcher of one run (``params`` override SEARCH), kept in
    SESSIONS; its CUDA graphs live in the placement's executable cache
    until release_shards."""
    from repro_torch.core import SearchParams, ShardedSearcher
    p = SearchParams(**{**SEARCH, "exec_mode": mode, "fused_topk": fused,
                        "batch_buckets": (bsz,), **params})
    key = (id(sharded), p)
    if key not in SESSIONS:
        SESSIONS[key] = ShardedSearcher(sharded, p)
    return SESSIONS[key]


def release_shards(torch, index, what):
    """Drop the index's sharded views, their placements (with the
    executable caches and graph pools) and the sessions of SESSIONS."""
    index.__dict__.pop("_shard_cache", None)
    index.__dict__.pop("_placement_cache", None)
    release_sessions(torch, what)


def mesh_contract(torch, got, want, what):
    """The reference's multi-device contract (tests/test_sharded.py):
    every counter exact, sorted distances exact, the same id set per
    query.  Returns how many rows have the same ids in the same order."""
    for f in ("approx_dco", "refine_dco", "scanned_blocks",
              "dropped_blocks"):
        check(torch.equal(getattr(got, f), getattr(want, f)),
              f"{what}: {f} differs")
    check(torch.equal(got.dists.sort(dim=1).values,
                      want.dists.sort(dim=1).values),
          f"{what}: sorted distances differ")
    a, b = got.ids.cpu().numpy(), want.ids.cpu().numpy()
    for i, (x, y) in enumerate(zip(a, b)):
        check(set(x[x >= 0]) == set(y[y >= 0]),
              f"{what}: query {i} returns another id set")
    return int((a == b).all(axis=1).sum())


def timed_run(torch, sess, q, bsz):
    """A session's graphs captured (``warmup``), then one run over all of
    ``q``: (result, QPS, warmup seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.warmup(bsz)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = sess(q)
    torch.cuda.synchronize()
    return res, q.shape[0] / (time.perf_counter() - t0), warm


def sharded_run(torch, sess, q, gt, mode, bsz, fused, tag):
    """``timed_run`` of a mesh session, after the recall floor and shape
    checks, with its log line: (result, QPS)."""
    from repro_torch.core import recall_at_k
    res, qps, warm = timed_run(torch, sess, q, bsz)
    rec = recall_at_k(res.ids.cpu().numpy(), gt)
    log(f"{tag}: {mode:9s} B={bsz:4d} fused={int(fused)} recall@10="
        f"{rec:.4f} approx_dco/q={res.approx_dco.float().mean().item():.1f} "
        f"dropped/q={res.dropped_blocks.float().mean().item():.3f} "
        f"qps={qps:.1f} (max_scan_local {sess.max_scan_local}, max_scan "
        f"{sess.params.max_scan}); {sess.stats.warmup_compiles} CUDA graph "
        f"captured by warmup in {warm:.2f} s")
    check(rec >= 0.5, f"{tag}: recall@10 {rec} below the 0.5 floor")
    check(bool(torch.isfinite(res.dists).all()), f"{tag}: non-finite dists")
    check(tuple(res.ids.shape) == (q.shape[0], SEARCH["k"]),
          f"{tag}: result ids of the wrong shape")
    return res, qps


def shard_inputs(torch, sess, queries, mode, rank):
    """K1's and K3's inputs (mode_inputs' tuple) of shard ``rank`` at one
    batch of the mesh session ``sess``, as its serve step makes them: the
    shard's own block rows, its windowed plan at ``max_scan_local``."""
    from repro_torch.core.distributed import plan_shard, shard_geometry
    from repro_torch.core.engine import select_lists
    from repro_torch.core.pq import PQCodebook, pq_lut
    from repro_torch.core.search import finalize_fetch
    shards = sess._call_inputs()
    sh = shards[rank]
    p = sess.params
    sel = select_lists(queries, sh.centroids, nprobe=p.nprobe)
    lut = pq_lut(PQCodebook(sh.codebooks), queries)
    store, plan = plan_shard(sh, sel,
                             block_lo=shard_geometry(shards, rank)[0],
                             max_scan_local=sess.max_scan_local)
    fetch = finalize_fetch(p.bigk_eff, sess.index.result_oversample,
                           sess.index.needs_result_dedup)
    return scan_inputs(sess.index, fetch, store, plan, lut, sel.rank_of,
                       sel.sel, mode, p.query_tile)


def sharded_path(torch, index, q, gt, results, lookups_per_s, smi):
    """The main index over a one-shard mesh and a four-shard mesh on
    cuda:0 (module docstring, phase sharded).  Returns (kernel rows of
    shard 0 at each mode's first batch, launches of the four-shard six
    runs by name and form)."""
    from repro_torch import obs
    from repro_torch.core import make_mesh
    from repro_torch.kernels.pq_scan import launch_counts
    dev = index.device
    on = None if dev.type == "cuda" else dev   # the CPU: a rehearsal
    meshes = {1: make_mesh(1, device=on), SHARDS: make_mesh(SHARDS,
                                                            device=on)}
    card = meshes[1].devices[0]
    check(meshes[SHARDS].devices == (card,) * SHARDS,
          f"sharded: make_mesh({SHARDS}) on one card gave "
          f"{meshes[SHARDS].devices}")
    nprobe = SEARCH["nprobe"]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    budgets = {n: index.shard(m).derived_max_scan_local(nprobe)
               for n, m in meshes.items()}
    index.shard(meshes[SHARDS])._ensure_state()
    torch.cuda.synchronize()
    log(f"sharded: {SHARDS} shards on {card}: placed with "
        f"{(torch.cuda.memory_allocated() - mem0) / 2 ** 20:.1f} MiB of new "
        f"device memory (views of the index; a padded last block shard is "
        f"a copy); derived per-shard budgets at nprobe {nprobe}: "
        f"{json.dumps(budgets)} against the session's max_scan "
        f"{index.default_max_scan(nprobe)}, which drops blocks: the "
        f"{SHARDS}-shard runs are held to a plain session at max_scan "
        f"{budgets[1]} (one shard's derived budget, which never "
        f"truncates), the one-shard runs bitwise to the main path's")
    release_shards(torch, index, "sharded placement")
    qps, launches = {}, {1: {}, SHARDS: {}}
    for mode, bsz in RUNS:
        for fused in (False, True):
            key = (mode, fused)
            plain, qps[("plain",) + key], _ = timed_run(
                torch, session(index, mode, bsz, fused), q, bsz)
            full, qps[("full",) + key], _ = timed_run(
                torch, session(index, mode, bsz, fused, max_scan=budgets[1]),
                q, bsz)
            for f in plain._fields:
                check(torch.equal(getattr(plain, f), getattr(results[key], f)),
                      f"sharded: the plain {mode} fused={int(fused)} rerun "
                      f"differs from the main path's on {f}")
            check(not bool(full.dropped_blocks.any()), "sharded: max_scan "
                  f"{budgets[1]} dropped blocks")
            out = {}
            for ndev, mesh in meshes.items():
                sess = shard_session(index.shard(mesh), mode, bsz, fused)
                before = launch_counts(forms=True)
                out[ndev], qps[(ndev,) + key] = sharded_run(
                    torch, sess, q, gt, mode, bsz, fused, f"sharded {ndev}")
                after = launch_counts(forms=True)
                for k in after:
                    launches[ndev][k] = (launches[ndev].get(k, 0) + after[k]
                                         - before[k])
            for f in plain._fields:
                check(torch.equal(getattr(out[1], f), getattr(plain, f)),
                      f"sharded 1: {mode} fused={int(fused)} is not bitwise "
                      f"the plain session on {f}")
            same = mesh_contract(torch, out[SHARDS], full,
                                 f"sharded {SHARDS}: {mode} "
                                 f"fused={int(fused)}")
            # the graph against the eager step, and a traced batch
            sess = shard_session(index.shard(meshes[SHARDS]), mode, bsz,
                                 fused)
            qb = q[:bsz].contiguous()
            want = sess(qb)
            fn, ins = sess._search_fn(), sess._call_inputs()
            eager = fn(qb, *ins)
            for f in want._fields:
                check(torch.equal(getattr(eager, f), getattr(want, f)),
                      f"sharded {SHARDS}: the eager step differs from the "
                      f"graph on {f}")
            torch.cuda.synchronize()
            with obs.trace() as tr:
                traced = sess(qb)
            for f in want._fields:
                check(torch.equal(getattr(traced, f), getattr(want, f)),
                      f"sharded {SHARDS}: traced {mode} fused={int(fused)} "
                      f"differs from the untraced batch on {f}")
            spans = tr.stage_summary()
            for name in ("stage.shard_scan", "stage.gather_finalize"):
                check(name in spans, f"sharded {SHARDS}: no {name} span")
            g_ms = cuda_ms(torch, lambda: sess(qb))
            e_ms = cuda_ms(torch, lambda: fn(qb, *ins))
            log(f"sharded {SHARDS}: {mode:9s} B={bsz:4d} fused={int(fused)}: "
                f"counters and sorted distances exact, id sets equal to the "
                f"plain session at max_scan {budgets[1]} ({same} of "
                f"{q.shape[0]} rows in its order); qps "
                f"{qps[(SHARDS,) + key]:.1f} against the plain session's "
                f"{qps[('plain',) + key]:.1f} (at max_scan {budgets[1]}: "
                f"{qps[('full',) + key]:.1f}) and one shard's "
                f"{qps[(1,) + key]:.1f}; one batch (CUDA events, 10 back to "
                f"back): graph {g_ms:.4f} ms, eager step {e_ms:.4f} ms; a "
                f"traced batch bitwise equal, spans (ms) "
                + ", ".join(f"{k} {v['mean_ms']:.4f}" for k, v in
                            spans.items() if k.startswith("stage."))
                + f" ({smi})")
            del fn, ins
            release_shards(torch, index, f"sharded {mode} fused={int(fused)}")
    for ndev, tally in launches.items():
        for kern, form in (("pq_scan_tiled_kernel", "fast"),
                           ("pq_scan_topk_kernel", "shared")):
            check(tally[kern] > 0 and tally[f"{kern}[{form}]"]
                  == tally[kern], f"sharded {ndev}: {kern} launches "
                  f"{tally[kern]}, {tally[f'{kern}[{form}]']} {form}")
        log(f"sharded {ndev}: launches over the six runs "
            f"{json.dumps(tally)}")
    check(launches[SHARDS]["pq_scan_tiled_kernel"]
          == SHARDS * launches[1]["pq_scan_tiled_kernel"],
          "sharded: four shards did not launch K1 four times as often as "
          "one shard")
    # each shard's K1 and K3 at each mode's first batch, bitwise against
    # their plain versions, and timed
    rows = {}
    sharded = index.shard(meshes[SHARDS])
    for mode, bsz in RUNS:
        sess = shard_session(sharded, mode, bsz, False)
        qb = q[:bsz].contiguous()
        for rank in range(SHARDS):
            held = hold_inputs(torch, shard_inputs(torch, sess, qb, mode,
                                                   rank),
                               mode, f"sharded shard {rank}",
                               global_tables=False, form="fast",
                               k3_form="shared")
            r = kernel_rows(torch, held, mode, f"timing: shard {rank}",
                            lookups_per_s)
            if rank == 0:
                rows[mode] = r
            del held
    check("merge" not in rows["grouped"]
          or launches[SHARDS]["merge_topk_kernel"] > 0,
          "sharded: K3 splits at a shard's grouped batch and no merge ran")
    release_shards(torch, index, "sharded kernels")
    sharded_small(torch, on)
    sharded_cli(torch, on)
    return rows, launches[SHARDS]


def sharded_small(torch, on):
    """tests/data/golden_v1.npz (14 blocks, 96 vectors: a padded last
    block shard) at four shards on the card and on the CPU: ids and DCO
    exact, distances within 1e-5; its four-way v3 bundle, written from the
    mesh and loaded with ``mesh=``, bitwise the mesh in memory (and over
    two shards within the multi-device contract)."""
    import tempfile
    from repro_torch.core import (SearchParams, load_index, make_mesh,
                                  save_index)
    golden = ROOT / "tests" / "data" / "golden_v1.npz"
    on_card = load_index(golden, device=on).shard(make_mesh(SHARDS,
                                                             device=on))
    on_cpu = load_index(golden, device="cpu").shard(
        make_mesh(SHARDS, device="cpu"))
    qg = on_cpu.vectors[:8] + 0.01
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        save_index(on_card, Path(tmp) / "golden4")
        n_files = len(list((Path(tmp) / "golden4").glob("shard_*.npz")))
        check(n_files == SHARDS, f"sharded: {n_files} bundle shards")
        back = load_index(Path(tmp) / "golden4",
                          mesh=make_mesh(SHARDS, device=on))
        two = load_index(Path(tmp) / "golden4", mesh=make_mesh(2, device=on))
        for mode in ("paged", "grouped", "clustered"):
            for fused in (False, True):
                p = SearchParams(k=5, nprobe=2, exec_mode=mode,
                                 fused_topk=fused)
                a = on_card.searcher(p)(qg)
                b = on_cpu.searcher(p)(qg)
                for f in ("ids", "approx_dco", "refine_dco",
                          "scanned_blocks", "dropped_blocks"):
                    check(torch.equal(getattr(a, f).cpu(), getattr(b, f)),
                          f"sharded golden v1 {mode} fused={int(fused)}: "
                          f"card and CPU differ on {f}")
                check(torch.allclose(a.dists.cpu(), b.dists, rtol=1e-5,
                                     atol=1e-5),
                      f"sharded golden v1 {mode}: distances beyond 1e-5")
                c = back.searcher(p)(qg)
                for f in a._fields:
                    check(torch.equal(getattr(c, f), getattr(a, f)),
                          f"sharded: the reloaded 4-shard bundle {mode} "
                          f"differs on {f}")
                mesh_contract(torch, two.searcher(p)(qg), a,
                              f"sharded: the bundle over 2 shards {mode}")
    log(f"sharded: tests/data/golden_v1.npz at {SHARDS} shards answers "
        "alike on the card and on the CPU in all six modes (ids and DCO "
        f"equal, distances within 1e-5); its {SHARDS}-way v3 bundle, "
        "loaded with mesh=, bitwise equal, and over 2 shards within the "
        "multi-device contract")


def sharded_cli(torch, on):
    """``python -m repro_torch.launch.serve --ndev 4`` as a subprocess,
    closed loop and behind the gateway, on its default device (the card;
    ``on``, the CPU, in a rehearsal): each exits 0 and reads recall@10
    >= 0.5 (the gateway with no client error)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    where = () if on is None else ("--device", str(on))
    for argv in (CLI_SERVE + where, CLI_GATEWAY + where):
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", *argv]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=600)
        dt = time.perf_counter() - t0
        check(out.returncode == 0, f"sharded CLI {' '.join(argv)} exited "
              f"{out.returncode}: {out.stderr[-2000:]}")
        lines = out.stdout.splitlines()
        recs = [float(w.split("=")[1]) for ln in lines for w in ln.split()
                if w.startswith("recall@10=")]
        check(recs and min(recs) >= 0.5, f"sharded CLI {' '.join(argv)}: "
              f"recall {recs}")
        if "--gateway" in argv:
            check(all("errors=0" in ln for ln in lines
                      if ln.startswith("load ")), "sharded CLI gateway: "
                  "client errors")
        for ln in lines:
            if ln.startswith(("built", "serving", "batch", "load",
                              "gateway", "sharded searcher")):
                log(f"sharded CLI: {ln}")
        log(f"sharded CLI: {' '.join(argv)}: exit 0 in {dt:.1f} s, "
            f"recall@10 {min(recs):.4f}-{max(recs):.4f}")


def own_counts(fn):
    """Run ``fn()`` outside the launch counts around it: returns its
    result and its own launches, which are taken back out of the
    counters (a phase's counts stay those of its own runs)."""
    from repro_torch.kernels.pq_scan import add_launch_counts, launch_counts
    before = launch_counts(forms=True)
    out = fn()
    after = launch_counts(forms=True)
    mine = {k: after[k] - before[k] for k in after}
    add_launch_counts({k: -n for k, n in mine.items()})
    return out, mine


def sharded_stream(torch, stream, q, state):
    """The stream sharded four ways on cuda:0 in SHARD_STREAM_RUNS, at one
    shard's derived budget (which never truncates, so that the counters
    can agree): at the exhaustive capacity held to the stream's own
    sessions, at the routed one to a one-shard mesh (a mesh's delta scan
    is always exhaustive).  Their launches stay out of the stream's
    counts.  Returns the four-shard view and a session pinned now (the
    stale check after the deletes)."""
    from repro_torch.core import make_mesh
    on = None if stream.device.type == "cuda" else stream.device
    sharded = stream.shard(make_mesh(SHARDS, device=on))
    one = stream.shard(make_mesh(1, device=on))
    full = one.derived_max_scan_local(SEARCH["nprobe"])

    def run():
        for mode, fused in SHARD_STREAM_RUNS:
            bsz = dict(RUNS)[mode]
            sess = shard_session(sharded, mode, bsz, fused, max_scan=full)
            res, qps, _ = timed_run(torch, sess, q, bsz)
            if state == "exhaustive":
                against = "the stream's session"
                ref = stream_session(stream, mode, bsz, fused, max_scan=full)
            else:
                against = "one shard"
                ref = shard_session(one, mode, bsz, fused, max_scan=full)
            ref, ref_qps, _ = timed_run(torch, ref, q, bsz)
            same = mesh_contract(torch, res, ref, f"sharded stream {state} "
                                 f"{mode} fused={int(fused)}")
            log(f"sharded stream {state} (capacity "
                f"{stream._delta.capacity}): {mode:9s} B={bsz:4d} "
                f"fused={int(fused)} at {SHARDS} shards, max_scan {full}: "
                f"qps {qps:.1f}, approx_dco/q "
                f"{res.approx_dco.float().mean().item():.1f}; against "
                f"{against} (qps {ref_qps:.1f}): counters and sorted "
                f"distances exact, id sets equal, {same} of {q.shape[0]} "
                f"rows in its order")
    _, mine = own_counts(run)
    log(f"sharded stream {state}: launches (outside the stream's counts) "
        f"{json.dumps({k: n for k, n in mine.items() if n})}")
    sess = shard_session(sharded, "paged", dict(RUNS)["paged"], False,
                         max_scan=full)
    for view in (sharded, one):
        view._placement.exec_cache.clear()
    release_sessions(torch, f"sharded stream {state}")
    return sharded, sess


def sharded_stream_stale(torch, sharded, sess, q):
    """After the deletes the pinned mesh session raises StaleSessionError,
    and a fresh one answers."""
    from repro_torch.errors import StaleSessionError
    try:
        sess(q[:64])
        fail("sharded stream: a session pinned before the deletes answered")
    except StaleSessionError as e:
        log(f"sharded stream: after the deletes the pinned session raised "
            f"StaleSessionError ({str(e)[:80]}...)")


def sharded_stream_compacted(torch, stream, sharded, q):
    """After compaction the mesh places the new epoch's base and answers
    as the stream's own session does (at one shard's derived budget)."""
    from repro_torch.core import make_mesh
    pl = sharded._placement
    base0 = pl.base
    on = None if stream.device.type == "cuda" else stream.device
    full = stream.shard(make_mesh(1, device=on)).derived_max_scan_local(
        SEARCH["nprobe"])

    def run():
        bsz = dict(RUNS)["paged"]
        res = shard_session(sharded, "paged", bsz, True, max_scan=full)(q)
        want = stream_session(stream, "paged", bsz, True, max_scan=full)(q)
        return mesh_contract(torch, res, want, "sharded stream compacted")
    same, _ = own_counts(run)
    check(pl.base is not base0 and pl.base_epoch == stream.epoch,
          "sharded stream: compaction did not re-place the shards")
    log(f"sharded stream: after compaction (epoch {stream.epoch}) the "
        f"shards were placed anew and paged fused answers as the stream's "
        f"session ({same} of {q.shape[0]} rows in its order)")
    stream.__dict__.pop("_shard_cache", None)
    stream.__dict__.pop("_placement_cache", None)
    release_sessions(torch, "sharded stream compacted")


# ---------------------------------------------------------------------------
# phase lm: the LM serving path (the ten architectures reduced, card against
# CPU; Qwen3-8B at full width and depth; RAIRS-kNN attention at long_500k)
# ---------------------------------------------------------------------------
LM_ARCH = "qwen3-8b"        # the full-width model of the phase
LM_TOL = 2e-2               # whole-model logits, card against CPU
LM_SUBLAYER_TOL = 5e-3      # one sublayer from the CPU's input
LM_ARGMAX_MIN = 0.95
LM_TF_ARCHS = ("qwen3-8b", "gemma-2b", "qwen2-vl-7b", "jamba-1.5-large-398b",
               "mamba2-2.7b")
LM_B, LM_S = 2, 64          # the reduced architectures' batch
LM_FULL_S = 32_768          # prefill_32k's length; its batch of 32 cut to 1
LM_DECODE_STEPS = 32
LM_LONG_S = 524_288         # long_500k's length (B 1)
LM_LONG_PERIODS = 2         # of Qwen3-8B's 36: a K+V pool is 4.3 GB a layer
LM_LONG_STEPS = 16
LM_NPROBES = (1, 4, 16, 64)
LM_EXACT = dict(s=16_384, nlist=64, nprobe=64, max_blocks_per_list=64,
                window=16)  # nprobe == nlist, no entry dropped: exact


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def lm_batch(torch, cfg, seed, b=LM_B, s=LM_S):
    """A batch of the reference tests' shape, from numpy with ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "frame":
        out["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    if cfg.frontend == "patch":
        out["patch_embeds"] = rng.standard_normal(
            (b, s // 4, cfg.patch_dim)).astype(np.float32)
    if cfg.m_rope:
        out["positions3"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(s, dtype=np.int32)[None, None], (3, b, s)))
    return {k: torch.from_numpy(v) for k, v in out.items()}


def rel_err(torch, ref, got) -> float:
    ref, got = ref.float().cpu(), got.float().cpu()
    return float((ref - got).abs().max() / ref.abs().max().clamp_min(1e-30))


def on(torch, tree, dev):
    from repro_torch.models.mamba2 import MambaState
    if isinstance(tree, dict):
        return {k: on(torch, v, dev) for k, v in tree.items()}
    if isinstance(tree, MambaState):
        return MambaState(*(t.to(dev) for t in tree))
    if isinstance(tree, tuple):
        return tuple(t.to(dev) for t in tree)
    return tree.to(dev)


def lm_sublayers(torch, cfg, cpu_p, dev_p, batch, dev) -> float:
    """Every sublayer of every period on the card from the CPU's input,
    held to the CPU's output and cache piece; the largest error."""
    from repro_torch.models import transformer as T
    worst = 0.0
    h = T.embed_inputs(cpu_p, cfg, batch)
    pos = T._positions(cfg, batch, h)
    dpos = pos.to(dev)
    for p in range(cfg.n_periods):
        cp, dp = T._index(cpu_p["blocks"], p), T._index(dev_p["blocks"], p)
        for j, (mixer, mlp) in enumerate(cfg.slot_kinds()):
            hin = h.to(dev)
            if mixer == "attn":
                h, c = T._attn_sublayer(cfg, cp[f"s{j}"], h, pos, "prefill")
                dh, dc = T._attn_sublayer(cfg, dp[f"s{j}"], hin, dpos,
                                          "prefill")
            else:
                h, c = T._ssm_sublayer(cfg, cp[f"s{j}"], h, "prefill")
                dh, dc = T._ssm_sublayer(cfg, dp[f"s{j}"], hin, "prefill")
            errs = [rel_err(torch, h, dh)] + [rel_err(torch, a, b)
                                              for a, b in zip(c, dc)]
            if mlp != "none":
                hin = h.to(dev)
                h = T._mlp_sublayer(cfg, cp[f"s{j}"], h, mlp)
                errs.append(rel_err(torch, h, T._mlp_sublayer(
                    cfg, dp[f"s{j}"], hin, mlp)))
            check(max(errs) <= LM_SUBLAYER_TOL,
                  f"lm {cfg.name} period {p} slot {j} ({mixer}/{mlp}): card "
                  f"against CPU {max(errs):.3e} > {LM_SUBLAYER_TOL}")
            worst = max(worst, *errs)
    return worst


def lm_reduced(torch, dev, seed, smi):
    """The ten architectures reduced: prefill, decode and the loss on the
    card and on the CPU from one set of params (a CPU generator)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cpu = torch.device("cpu")
    for arch in sorted(ARCHS):
        t0 = time.perf_counter()
        cfg = ARCHS[arch].reduced()
        cpu_p = T.init_params(cfg, torch.Generator().manual_seed(seed), cpu)
        dev_p = on(torch, cpu_p, dev)
        batch = lm_batch(torch, cfg, seed)
        dbatch = on(torch, batch, dev)
        lc, cc = T.prefill(cpu_p, cfg, batch, cache_slack=2)
        ld, cd = T.prefill(dev_p, cfg, dbatch, cache_slack=2)
        err = rel_err(torch, lc, ld)
        check(torch.isfinite(ld).all().item(), f"lm {arch}: prefill logits")
        hc, _ = T.forward(cpu_p, cfg, batch, mode="prefill")
        hd, _ = T.forward(dev_p, cfg, dbatch, mode="prefill")
        ac = L._dot(hc, T._unembed_w(cpu_p, cfg)).argmax(-1)
        ad = L._dot(hd, T._unembed_w(dev_p, cfg)).argmax(-1).cpu()
        agree = (ac == ad).float().mean().item()
        loss = float(T.train_loss(dev_p, cfg, dbatch))
        line = (f"lm {arch}: card against CPU prefill logits {err:.3e} "
                f"(<= {LM_TOL}), argmax over {ac.numel()} rows {agree:.4f}, "
                f"train_loss {loss:.4f}")
        check(err <= LM_TOL, line)
        check(agree >= LM_ARGMAX_MIN, line)
        check(3.0 < loss < 12.0, line)
        line += (f", sublayers from the CPU's input <= "
                 f"{lm_sublayers(torch, cfg, cpu_p, dev_p, batch, dev):.3e}")
        if cfg.has_decode:
            tok = batch["tokens"][:, :1]
            dc, _ = T.decode_step(cpu_p, cfg, cc, tok)
            dd, _ = T.decode_step(dev_p, cfg, cd, tok.to(dev))
            derr = rel_err(torch, dc, dd)
            line += f", decode {derr:.3e}"
            check(derr <= LM_TOL and torch.isfinite(dd).all().item(), line)
        if arch in LM_TF_ARCHS:
            tf_err, tf_agree = lm_teacher_forcing(torch, arch, seed, dev)
            line += f", decode vs teacher-forced prefill {tf_err:.3e} " \
                    f"argmax {tf_agree:.2f}"
            check(tf_err < 0.05 and tf_agree > 0.9, line)
        log(line + f" ({time.perf_counter() - t0:.2f} s) [{smi}]")


def lm_teacher_forcing(torch, arch, seed, dev):
    """tests/test_models.py's check on the card: capacity_factor 8, decode
    of token S-1 against prefill of S.  -> (relative error, argmax share)"""
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(ARCHS[arch].reduced(), capacity_factor=8.0)
    params = on(torch, T.init_params(cfg, torch.Generator().manual_seed(seed),
                                     "cpu"), dev)
    batch = on(torch, lm_batch(torch, cfg, seed), dev)
    batch.pop("labels")
    full, _ = T.prefill(params, cfg, batch)
    short = {k: (v[:, :, :LM_S - 1] if k == "positions3"
                 else v[:, :LM_S - 1] if v.shape[1] == LM_S else v)
             for k, v in batch.items()}
    _, cache = T.prefill(params, cfg, short, cache_slack=2)
    dec, _ = T.decode_step(params, cfg, cache,
                           batch["tokens"][:, LM_S - 1:LM_S])
    a, b = full[:, 0], dec[:, 0]
    return (rel_err(torch, a, b),
            (a.argmax(-1) == b.argmax(-1)).float().mean().item())


def leaves(tree):
    """The tensors of a nested dict / tuple tree."""
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, tuple):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def timed_s(torch, fn):
    """Host seconds of fn(), from a synchronised card to a synchronised
    card, and fn's result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def lm_full(torch, dev, seed, smi, cfg=None, s=LM_FULL_S):
    """Qwen3-8B at full width and depth, B=1: prefill at s, the
    teacher-forcing pair (prefill s-1, decode token s against prefill
    s's last logits), then greedy decode steps.  Returns the params."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as T
    cfg = cfg or ARCHS[LM_ARCH]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(seed)
    t_init, params = timed_s(torch, lambda: T.init_params(
        cfg, g, dev, serve_dtype=torch.bfloat16))
    n_par = sum(t.numel() for t in leaves(params))
    w_bytes = tree_bytes(params)
    tokens = torch.randint(0, cfg.vocab, (1, s), generator=g, device=dev,
                           dtype=torch.int32)
    t_short, (_, short) = timed_s(torch, lambda: T.prefill(
        params, cfg, {"tokens": tokens[:, :s - 1]}, cache_slack=1))
    dec, _ = T.decode_step(params, cfg, short, tokens[:, s - 1:s])
    del short
    torch.cuda.empty_cache()
    peak_before, other = launch_mark(torch, (params, tokens))
    t_pre, (last, cache) = timed_s(torch, lambda: T.prefill(
        params, cfg, {"tokens": tokens}, cache_slack=LM_DECODE_STEPS))
    LAUNCH_PEAKS["prefill"] = (torch.cuda.max_memory_allocated(), other)
    tf_err = rel_err(torch, last[:, 0], dec[:, 0])
    same = bool((last[:, 0].argmax(-1) == dec[:, 0].argmax(-1)).all())
    check(torch.isfinite(last).all().item() and tf_err < 0.05,
          f"lm full: decode of token {s} against prefill {s}: {tf_err:.3e}")
    tok = last.argmax(-1).to(torch.int32)
    steps = []
    for _ in range(LM_DECODE_STEPS):
        dt, (logits, cache) = timed_s(torch, lambda: T.decode_step(
            params, cfg, cache, tok))
        check(torch.isfinite(logits).all().item(), "lm full: decode logits")
        tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        steps.append(dt)
    check(int(cache["len"][0]) == s + LM_DECODE_STEPS, "lm full: cache len")
    kv_bytes = tree_bytes(cache["blocks"])
    embed_row = cfg.d_model * params["embed"].element_size()
    step_bytes = w_bytes - params["embed"].numel() * params[
        "embed"].element_size() + embed_row + kv_bytes
    ms = 1e3 * float(np.median(steps[1:]))
    bound = 1e3 * step_bytes / HBM_BYTES_PER_S
    peak = max(peak_before, torch.cuda.max_memory_allocated()) / 2**30
    log(f"lm full: {cfg.name} d {cfg.d_model} x {cfg.n_layers} layers, "
        f"{n_par / 1e9:.3f} B params ({w_bytes / 2**30:.2f} GiB in serving "
        f"dtypes, init {t_init:.1f} s), B 1 [{smi}]")
    log(f"lm full: prefill S {s}: {1e3 * t_pre:.1f} ms, "
        f"{s / t_pre:.1f} tokens/s (S {s - 1}: {1e3 * t_short:.1f} ms, the "
        f"first call) [{smi}]")
    log(f"lm full: teacher forcing (prefill {s - 1} + decode token {s} "
        f"against prefill {s}): rel err {tf_err:.3e} (< 0.05), argmax "
        f"{'equal' if same else 'differs'} [{smi}]")
    log(f"lm full: {LM_DECODE_STEPS} greedy decode steps at kv {s}: "
        f"{ms:.3f} ms/step median (first {1e3 * steps[0]:.3f}), bound "
        f"{bound:.3f} ms ({step_bytes / 1e9:.3f} GB a step: weights "
        f"{(step_bytes - kv_bytes) / 1e9:.3f} + f32 K/V cache "
        f"{kv_bytes / 1e9:.3f}, at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
        f"{bound / ms:.3f} of it; peak {peak:.2f} GiB [{smi}]")
    del cache, last, dec
    return params


def topic_kv(torch, dev, seed, s, kvh, hd, n_topics=16, burst=128):
    """Keys with examples/long_context_retrieval.py's structure, made on
    the card: bursty topics along the sequence plus noise; random values.
    -> (keys (1, s, kvh, hd), values, topics)"""
    g = torch.Generator(device=dev).manual_seed(seed)
    topics = torch.randn((n_topics, kvh, hd), generator=g, device=dev)
    topic_of = (torch.arange(s, device=dev) // burst) % n_topics
    keys = topics[topic_of] + 0.3 * torch.randn((s, kvh, hd), generator=g,
                                                device=dev)
    vals = torch.randn((1, s, kvh, hd), generator=g, device=dev)
    return keys[None], vals, topics


def exact_attention(torch, q, keys, vals):
    """Softmax attention of one query over every key, in f32.
    q (1, 1, H, hd); keys/vals (1, S, kvH, hd)."""
    _, _, h, hd = q.shape
    kvh = keys.shape[2]
    qg = q[0, 0].reshape(kvh, h // kvh, hd)
    sc = torch.einsum("grd,sgd->grs", qg / float(np.sqrt(hd)), keys[0])
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("grs,sgd->grd", p, vals[0]).reshape(1, 1, h, hd)


def lm_exact_invariant(torch, dev, seed, smi, cfg):
    """nprobe == nlist with no table entry dropped equals exact attention
    within 0.05 (tests/test_models.py's invariant) at the model's width."""
    from repro_torch.models.retrieval import (KnnAttnConfig, build_knn_cache,
                                              rairs_attention_decode)
    e = LM_EXACT
    kcfg = KnnAttnConfig(nlist=e["nlist"], nprobe=e["nprobe"],
                         max_blocks_per_list=e["max_blocks_per_list"],
                         window=e["window"])
    keys, vals, _ = topic_kv(torch, dev, seed + 101, e["s"], cfg.n_kv_heads,
                             cfg.hd)
    cache, st = build_knn_cache(keys, vals, kcfg, seed=seed)
    check(sum(st.dropped) == 0, f"lm exact: {sum(st.dropped)} table entries "
          "dropped where the invariant needs none")
    q = torch.randn((1, 1, cfg.n_heads, cfg.hd), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
    out = rairs_attention_decode(q, cache, torch.tensor(
        [e["s"]], dtype=torch.int32, device=dev), kcfg)
    err = rel_err(torch, exact_attention(torch, q, keys, vals), out)
    check(err < 0.05, f"lm exact: nprobe == nlist off exact by {err:.3e}")
    log(f"lm long: invariant at S {e['s']}, nlist {e['nlist']} = nprobe, "
        f"maxb {e['max_blocks_per_list']} (blocks used {max(st.blocks)} of "
        f"{st.nb_cap}, 0 dropped): rel err against exact attention "
        f"{err:.3e} (< 0.05) [{smi}]")


def lm_long(torch, dev, seed, smi, params, cfg=None, s=LM_LONG_S):
    """long_500k at Qwen3-8B's width: a RAIRS-kNN cache per attention
    layer of the first LM_LONG_PERIODS (keys and values made on the card),
    the error against exact attention by nprobe, and decode_step_long."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.retrieval import (KnnAttnConfig, build_knn_cache,
                                              rairs_attention_decode)
    from repro_torch.serve import make_long_decode_step
    periods = LM_LONG_PERIODS
    cfg = dataclasses.replace(cfg or ARCHS[LM_ARCH],
                              n_layers=periods * (cfg or ARCHS[LM_ARCH]).period)
    kcfg = KnnAttnConfig()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm_exact_invariant(torch, dev, seed, smi, cfg)
    cuts = []
    while True:
        try:
            t_build, slots, first = lm_long_build(torch, dev, seed, smi, cfg,
                                                  kcfg, s)
            break
        except IndexError as e:             # the reference raises here too
            log(f"lm long: S {s}: {e} [{smi}]")
            check(s > kcfg.window, "lm long: no S fits nb_cap")
            s //= 2
            cuts.append(s)
    if cuts:
        log(f"lm long: cut: S {LM_LONG_S} -> {s} (the largest power of two "
            f"whose cells fit nb_cap {kcfg.nlist * kcfg.max_blocks_per_list // 2})")
    keys, vals, topics = first
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    rep = cfg.n_heads // cfg.n_kv_heads
    q = (topics[5][:, None].expand(cfg.n_kv_heads, rep, cfg.hd)
         .reshape(1, 1, cfg.n_heads, cfg.hd)
         + 0.1 * torch.randn((1, 1, cfg.n_heads, cfg.hd), generator=g,
                             device=dev))
    ref = exact_attention(torch, q, keys, vals)
    layer0 = {k: v[0] for k, v in slots.items()}
    errs = []
    for nprobe in LM_NPROBES:
        out = rairs_attention_decode(
            q, layer0, torch.tensor([s], dtype=torch.int32, device=dev),
            dataclasses.replace(kcfg, nprobe=nprobe))
        errs.append(f"nprobe {nprobe}: {rel_err(torch, ref, out):.3e}")
    del keys, vals, layer0
    log(f"lm long: attention output against exact attention over all {s} "
        f"keys (layer 0, one query near topic 5): " + ", ".join(errs)
        + f" [{smi}]")
    sub = {k: (v if k != "blocks" else _slice_periods(v, periods))
           for k, v in params.items()}
    cache = {"blocks": {"s0": slots},
             "len": torch.full((1,), s, dtype=torch.int32, device=dev)}
    step = make_long_decode_step(cfg, kcfg)
    tok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    times = []
    for _ in range(LM_LONG_STEPS):
        dt, (logits, cache) = timed_s(torch, lambda: step(sub, cache, tok))
        check(torch.isfinite(logits).all().item(), "lm long: logits")
        tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        times.append(dt)
    check(int(cache["len"][0]) == s + LM_LONG_STEPS, "lm long: cache len")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"lm long: decode_step_long, {periods} of {ARCHS[LM_ARCH].n_layers} "
        f"layers at kv {s} (nprobe {kcfg.nprobe}, window {kcfg.window}): "
        f"{1e3 * float(np.median(times[1:])):.3f} ms/step median over "
        f"{LM_LONG_STEPS} (first {1e3 * times[0]:.3f}); build "
        f"{t_build:.2f} s; peak {peak:.2f} GiB [{smi}]")
    log(f"lm long: cut: depth {ARCHS[LM_ARCH].n_layers} -> {periods} layers "
        f"(a layer's bf16 K+V block pool is "
        f"{2 * slots['k_blocks'][0].numel() * 2 / 1e9:.2f} GB)")


def _slice_periods(tree, n):
    if isinstance(tree, dict):
        return {k: _slice_periods(v, n) for k, v in tree.items()}
    return tree[:n]


def lm_long_build(torch, dev, seed, smi, cfg, kcfg, s):
    """One kNN slot cache per layer, stacked over the layers.  Raises
    IndexError where a layer's cells pass nb_cap."""
    from repro_torch.models.retrieval import build_knn_cache
    t0 = time.perf_counter()
    per, first = [], None
    for p in range(cfg.n_periods):
        keys, vals, topics = topic_kv(torch, dev, seed + 11 * p, s,
                                      cfg.n_kv_heads, cfg.hd)
        dt, (cache, st) = timed_s(torch, lambda: build_knn_cache(
            keys, vals, kcfg, seed=seed + p))
        log(f"lm long: layer {p} kNN cache at S {s}: built in {dt:.2f} s, "
            f"blocks used {min(st.blocks)}-{max(st.blocks)} of nb_cap "
            f"{st.nb_cap} per kv head, table entries dropped "
            f"{sum(st.dropped)} (per kv head {min(st.dropped)}-"
            f"{max(st.dropped)}) [{smi}]")
        per.append(cache)
        first = first or (keys, vals, topics)
        del keys, vals
    slots = {k: torch.stack([c[k] for c in per]) for k in per[0]}
    del per
    torch.cuda.empty_cache()
    return time.perf_counter() - t0, slots, first


def lm_path(torch, dev, seed, smi=None):
    """Phase lm, callable alone (build no kernel: the LM side has none)."""
    smi = smi or smi_line()
    t0 = time.perf_counter()
    lm_reduced(torch, dev, seed, smi)
    params = lm_full(torch, dev, seed, smi)
    lm_long(torch, dev, seed, smi, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm: phase {time.perf_counter() - t0:.1f} s [{smi}]")


# ---------------------------------------------------------------------------
# phase train: the training path (the ten architectures reduced, card against
# CPU; Qwen3-1.7B at full width and depth; checkpoint resume; the train CLI)
# ---------------------------------------------------------------------------
TRAIN_ARCH = "qwen3-1.7b"     # the full-width model of the phase
TRAIN_GRAD_TOL = 5e-2         # a leaf's gradient, card against CPU
TRAIN_SUB_TOL = 2e-2          # a sublayer's VJP from the CPU's input
TRAIN_LOSS_RTOL = 1e-3
TRAIN_UPDATE_TOL = 1e-6       # adamw_update from identical gradients
TRAIN_MM_TOL = 1e-2           # _dot / _bmm backward against CPU autograd
TRAIN_S = 4096                # train_4k's length
TRAIN_BATCH = 8               # train_4k's global batch of 256, cut
TRAIN_STEPS = 4
TRAIN_SMALL = dict(batch=4, seq=64, accum=2)   # resume check (reduced)
BF16_PEAK_FLOPS = 989e12      # H100 SXM dense bf16
TRAIN_TOP_KERNELS = 16
TRAIN_GNORM_RTOL = 1e-2       # grad_norm, card against CPU
CLI_TRAIN = ("--arch", TRAIN_ARCH, "--steps", "3", "--ckpt-every", "2")


def named_leaves(tree, path=""):
    """(path, tensor) in the order of ``repro_torch.tree.leaves``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or range(len(tree))
        for k, v in zip(names, tree):
            yield from named_leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def to_dev(tree, dev):
    """A tree of tensors (``OptState`` included) on ``dev``."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def leaf_errs(torch, ref, got):
    """{path: max|ref - got| / max|ref|} over matching leaves (an all-zero
    reference leaf reads max|got|)."""
    out = {}
    for (n, a), (_, b) in zip(named_leaves(ref), named_leaves(got)):
        a, b = a.float().cpu(), b.float().cpu()
        m = float(a.abs().max())
        out[n] = float((a - b).abs().max()) / m if m > 0 \
            else float(b.abs().max())
    return out


def train_grads(torch, cfg, params, batch, remat=True, accum=2):
    from repro_torch.train import TrainConfig, accumulate_grads
    return accumulate_grads(cfg, TrainConfig(accum=accum, remat=remat),
                            params, batch)


def train_sublayers(torch, cfg, cpu_p, dev_p, batch, dev, seed) -> float:
    """Every sublayer's VJP on the card from the CPU's input and a random
    cotangent, held to the CPU's (the input's cotangent and each param's
    gradient); the largest error."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, unflatten
    g = torch.Generator().manual_seed(seed + 7)
    worst = 0.0
    h = T.embed_inputs(cpu_p, cfg, batch)
    pos = T._positions(cfg, batch, h)
    dpos = pos.to(dev)

    def vjp(fn, hin, sub, ct):
        hin = hin.detach().requires_grad_()
        req = [x.detach().requires_grad_() for x in leaves(sub)]
        out = fn(hin, unflatten(sub, req))
        return out.detach(), torch.autograd.grad(
            out, [hin] + req, grad_outputs=ct.to(out.device),
            materialize_grads=True)

    for p in range(cfg.n_periods):
        cp, dp = T._index(cpu_p["blocks"], p), T._index(dev_p["blocks"], p)
        for j, (mixer, mlp) in enumerate(cfg.slot_kinds()):
            steps = [("attn" if mixer == "attn" else "ssm",
                      lambda hh, pp, ps: (
                          T._attn_sublayer(cfg, pp, hh, ps, "train")
                          if mixer == "attn" else
                          T._ssm_sublayer(cfg, pp, hh, "train"))[0])]
            if mlp != "none":
                steps.append((mlp, lambda hh, pp, ps: T._mlp_sublayer(
                    cfg, pp, hh, mlp)))
            for what, fn in steps:
                ct = torch.randn(h.shape, generator=g).to(h.dtype)
                out, gc_ = vjp(lambda hh, pp: fn(hh, pp, pos), h,
                               cp[f"s{j}"], ct)
                _, gd = vjp(lambda hh, pp: fn(hh, pp, dpos), h.to(dev),
                            dp[f"s{j}"], ct)
                errs = [rel_err(torch, a, b) if a.abs().max() > 0
                        else float(b.abs().max()) for a, b in zip(gc_, gd)]
                check(max(errs) <= TRAIN_SUB_TOL,
                      f"train {cfg.name} period {p} slot {j} ({what}): VJP "
                      f"card against CPU {max(errs):.3e} > {TRAIN_SUB_TOL}")
                worst = max(worst, *errs)
                h = out
    return worst


def train_reduced(torch, dev, seed, smi):
    """The ten architectures reduced: one train step's loss, gradients
    (remat on and off) and grad_norm on the card against the CPU, from
    one set of params and one batch; the update from identical gradients;
    every sublayer's VJP teacher-forced; the step entry point."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.train import TrainConfig, make_train_step
    cpu = torch.device("cpu")
    for arch in sorted(ARCHS):
        t0 = time.perf_counter()
        cfg = ARCHS[arch].reduced()
        cpu_p = T.init_params(cfg, torch.Generator().manual_seed(seed), cpu)
        dev_p = on(torch, cpu_p, dev)
        batch = lm_batch(torch, cfg, seed)
        dbatch = on(torch, batch, dev)
        lc, gc_ = train_grads(torch, cfg, cpu_p, batch)
        ld, gd = train_grads(torch, cfg, dev_p, dbatch)
        _, gd_off = train_grads(torch, cfg, dev_p, dbatch, remat=False)
        lerr = abs(float(lc) - float(ld)) / abs(float(lc))
        errs = leaf_errs(torch, gc_, gd)
        worst = max(errs, key=errs.get)
        remat_same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            named_leaves(gd), named_leaves(gd_off)))
        # the update from identical (the CPU's) gradients
        opt_c = adamw_init(cpu_p)
        pc, oc, mc = adamw_update(gc_, opt_c, cpu_p, TrainConfig().optim)
        pd, od, md = adamw_update(to_dev(gc_, dev), to_dev(opt_c, dev),
                                  dev_p, TrainConfig().optim)
        _, _, md_own = adamw_update(gd, to_dev(opt_c, dev), dev_p,
                                    TrainConfig().optim)
        uerr = max(max(leaf_errs(torch, pc, pd).values()),
                   max(leaf_errs(torch, oc.mu, od.mu).values()),
                   max(leaf_errs(torch, oc.nu, od.nu).values()),
                   rel_err(torch, mc["grad_norm"], md["grad_norm"]),
                   rel_err(torch, mc["lr"], md["lr"]))
        gnerr = rel_err(torch, mc["grad_norm"], md_own["grad_norm"])
        line = (f"train {arch}: card against CPU loss {float(ld):.6f} "
                f"(rel {lerr:.2e} <= {TRAIN_LOSS_RTOL}), gradients <= "
                f"{errs[worst]:.3e} of max|CPU| ({worst}; <= "
                f"{TRAIN_GRAD_TOL}), grad_norm {float(md_own['grad_norm']):.4f}"
                f" (rel {gnerr:.2e} <= {TRAIN_GNORM_RTOL}), remat on/off "
                f"{'bitwise equal' if remat_same else 'DIFFER'}, update from "
                f"the CPU's gradients {uerr:.2e} (<= {TRAIN_UPDATE_TOL})")
        log(line + f" [{smi}]")
        check(torch.isfinite(ld).item() and lerr <= TRAIN_LOSS_RTOL, line)
        check(errs[worst] <= TRAIN_GRAD_TOL, line)
        check(gnerr <= TRAIN_GNORM_RTOL, line)
        check(remat_same, line)
        check(uerr <= TRAIN_UPDATE_TOL, line)
        if cfg.frontend == "frame":     # the frame front end never reads it
            check(not gd["embed"].any() and not gc_["embed"].any(),
                  f"train {arch}: embed gradient not zero")
        sub = train_sublayers(torch, cfg, cpu_p, dev_p, batch, dev, seed)
        # the entry point: one step equals the accumulation + the update
        opt_d = to_dev(opt_c, dev)
        step = make_train_step(cfg, TrainConfig(accum=2))
        ps, os_, ms = step(dev_p, opt_d, dbatch)
        pu, ou, mu = adamw_update(gd, opt_d, dev_p, TrainConfig().optim)
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            named_leaves((ps, os_)), named_leaves((pu, ou))))
        check(same and torch.equal(ms["loss"], ld),
              f"train {arch}: make_train_step differs from its parts")
        log(f"train {arch}: sublayer VJPs from the CPU's input <= {sub:.3e} "
            f"(<= {TRAIN_SUB_TOL}); make_train_step equal to its parts "
            f"({time.perf_counter() - t0:.2f} s) [{smi}]")


def train_mm(torch, dev, seed, smi):
    """`_dot` / `_bmm` backward on the card (the cotangent rounded to bf16)
    against the CPU's autograd (f32 cotangent), at Qwen3-1.7B's layer
    shapes: an MLP product and the two attention products of a chunk."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(seed + 5)
    for fn, ashape, bshape in ((L._dot, (TRAIN_S, 2048), (2048, 6144)),
                               (L._bmm, (16, TRAIN_S, 128), (16, 128, 1024)),
                               (L._bmm, (16, TRAIN_S, 1024), (16, 1024, 128))):
        a = torch.randn(ashape, generator=g)
        b = torch.randn(bshape, generator=g)
        ct = torch.randn(ashape[:-1] + bshape[-1:], generator=g)
        res = []
        for d in (torch.device("cpu"), dev):
            ar, br = (a.to(d).requires_grad_(), b.to(d).requires_grad_())
            y = fn(ar, br)
            res.append((y.detach(),) + torch.autograd.grad(y, [ar, br],
                                                           ct.to(d)))
        yerr, aerr, berr = (rel_err(torch, c, d) for c, d in zip(*res))
        line = (f"train mm: {fn.__name__} {ashape} @ {bshape}: card against "
                f"CPU autograd: product {yerr:.2e}, gradients {aerr:.3e} / "
                f"{berr:.3e} of max|CPU| (<= {TRAIN_MM_TOL})")
        log(line + f" [{smi}]")
        check(max(aerr, berr) <= TRAIN_MM_TOL and yerr <= 1e-5, line)


def train_flops(cfg, tokens: int, s: int) -> float:
    """Model FLOPs of one step: 6 N T for the products (the tied unembed
    counted in N), and the attention's two products over every chunk
    (the causally masked half included, as the loop computes it), three
    times (forward and backward); remat's recompute not counted."""
    n = sum(int(np.prod(sp.shape)) for sp in _spec_leaves(cfg))
    attn = 4 * s * cfg.n_heads * cfg.hd * cfg.n_layers * tokens
    return 6.0 * n * tokens + 3.0 * attn


def _spec_leaves(cfg):
    from repro_torch.models.transformer import ParamSpec, param_specs

    def walk(t):
        if isinstance(t, ParamSpec):
            yield t
        else:
            for k in sorted(t):
                yield from walk(t[k])
    return list(walk(param_specs(cfg)))


def train_full(torch, dev, seed, smi, cfg=None, s=TRAIN_S,
               batch=TRAIN_BATCH):
    """Qwen3-1.7B at full width and depth: f32 masters and AdamW state on
    the card, TrainConfig() (accum 8, remat), TRAIN_STEPS steps on one
    synthetic batch; step seconds, tokens/s, FLOP share, card against host
    time of the last step (profiler), the update alone, memory."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.optim import adamw_update
    from repro_torch.train import TrainConfig, init_all, make_train_step
    cfg = cfg or ARCHS[TRAIN_ARCH]
    tcfg = TrainConfig()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(seed)
    t_init, (params, opt) = timed_s(torch, lambda: init_all(cfg, g, dev))
    n_par = sum(t.numel() for t in leaves(params))
    data = synthetic_lm_batch(torch.Generator(device=dev).manual_seed(seed),
                              cfg, batch, s)
    step = make_train_step(cfg, tcfg)
    tokens = batch * s
    flops = train_flops(cfg, tokens, s)
    log(f"train full: {cfg.name} d {cfg.d_model} x {cfg.n_layers} layers, "
        f"{n_par / 1e9:.4f} B params; params {tree_bytes(params) / 1e9:.3f} "
        f"GB + AdamW state {tree_bytes(opt) / 1e9:.3f} GB (f32; init "
        f"{t_init:.1f} s); S {s}, global batch {batch}, accum {tcfg.accum}, "
        f"remat {tcfg.remat}; {flops / 1e12:.1f} model TFLOP a step [{smi}]")
    losses, secs = [], []
    busy = None
    for i in range(TRAIN_STEPS):
        if i == TRAIN_STEPS - 1:
            busy, (dt, (params, opt, m)) = profiled(
                torch, lambda: timed_s(torch, lambda: step(params, opt,
                                                           data)))
        elif i == 1:      # one call measured for phase launch
            peak_before, other = launch_mark(torch, (params, opt, data))
            dt, (params, opt, m) = timed_s(torch, lambda: step(params, opt,
                                                               data))
            LAUNCH_PEAKS["train"] = (torch.cuda.max_memory_allocated(), other)
        else:
            dt, (params, opt, m) = timed_s(torch, lambda: step(params, opt,
                                                               data))
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        check(np.isfinite(loss) and np.isfinite(gn),
              f"train full: step {i + 1} loss {loss} grad_norm {gn}")
        losses.append(loss)
        secs.append(dt)
        log(f"train full: step {i + 1}: loss {loss:.6f}, grad_norm "
            f"{gn:.4f}, lr {float(m['lr']):.3e}, {dt:.3f} s, "
            f"{tokens / dt:.1f} tokens/s, {flops / dt / 1e12:.1f} model "
            f"TFLOP/s ({flops / dt / BF16_PEAK_FLOPS:.4f} of the bf16 dense "
            f"peak) [{smi}]")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"train full: the loss did not fall every step: {losses}")
    peak = max(peak_before, torch.cuda.max_memory_allocated()) / 2**30
    sec = float(np.median(secs[1:]))
    log(f"train full: {TRAIN_STEPS} steps, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (ln V {np.log(cfg.vocab):.4f}); step {sec:.3f} s "
        f"median of steps 2-{TRAIN_STEPS} (first {secs[0]:.3f}), "
        f"{tokens / sec:.1f} tokens/s, {flops / sec / 1e12:.1f} model "
        f"TFLOP/s = {flops / sec / BF16_PEAK_FLOPS:.4f} of 989; peak "
        f"{peak:.2f} GiB [{smi}]")
    if busy is None:
        log("train full: the profiler saw no device time: card busy share "
            "not measured")
    else:
        card_ms, rows = busy
        host_ms = 1e3 * secs[-1]
        kinds = {}
        for name, ms, _ in rows:
            kinds[kernel_kind(name)] = kinds.get(kernel_kind(name), 0.0) + ms
        log(f"train full: step {TRAIN_STEPS} under the profiler: card "
            f"{card_ms:.1f} ms of host {host_ms:.1f} ms "
            f"({card_ms / host_ms:.4f} busy; idle {host_ms - card_ms:.1f} ms"
            f"): " + ", ".join(f"{k} {ms:.1f} ms" for k, ms in sorted(
                kinds.items(), key=lambda kv: -kv[1])) + f" [{smi}]")
        for name, ms, calls in rows[:TRAIN_TOP_KERNELS]:
            log(f"train full:   {ms:9.1f} ms {calls:7d} x {name}")
    ms_upd = cuda_ms(torch, lambda: adamw_update(opt.mu, opt, params,
                                                 tcfg.optim), reps=3, warm=1)
    log(f"train full: adamw_update alone {ms_upd:.2f} ms (the moments as "
        f"stand-in gradients) [{smi}]")
    del params, opt, data, m
    gc.collect()
    torch.cuda.empty_cache()


_GENERIC_KERNEL = {"vectorized_elementwise_kernel", "elementwise_kernel",
                   "unrolled_elementwise_kernel", "gpu_kernel_impl_nocast",
                   "gpu_kernel_impl", "reduce_kernel", "func_wrapper_t",
                   "ReduceOp", "BinaryFunctor"}


def short_kernel(name: str) -> str:
    """The op a CUDA kernel's name carries (its functor or kernel
    function, past PyTorch's generic elementwise and reduce templates)."""
    import re
    if name.startswith(("Memcpy", "Memset")) or "<" not in name:
        return name
    for tok in re.findall(r"[A-Za-z_][A-Za-z0-9_]*", name):
        if tok in _GENERIC_KERNEL:
            continue
        if tok.endswith(("_kernel", "_kernel_cuda", "Ops")) \
                or "Functor" in tok or "gemm" in tok \
                or tok.startswith(("nvjet", "sm90", "cutlass")):
            return tok
    return name[:60]


def kernel_kind(short: str) -> str:
    if short.startswith(("nvjet", "sm90", "cutlass")) or "gemm" in short:
        return "GEMMs"
    if "copy" in short or short.startswith("Memcpy"):
        return "casts and copies"
    return "other elementwise and reductions"


def profiled(torch, fn):
    """fn() under torch.profiler (CUDA activity): ((card ms, [(kernel,
    ms, launches)] by kernel, most time first), fn's result); None for
    the first if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
    by = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            k = short_kernel(e.key)
            ms, n = by.get(k, (0.0, 0))
            by[k] = (ms + e.self_device_time_total / 1e3, n + e.count)
    if not by:
        return None, out
    rows = sorted(((k, ms, n) for k, (ms, n) in by.items()),
                  key=lambda r: -r[1])
    return (sum(r[1] for r in rows), rows), out


def train_resume(torch, dev, seed, smi):
    """Reduced Qwen3-1.7B on the card: one step, a checkpoint, the next
    step from memory and from the restored checkpoint: bitwise equal."""
    import tempfile
    from repro_torch.configs import ARCHS
    from repro_torch.dist.checkpoint import (latest_step, restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.train import TrainConfig, init_all, make_train_step
    cfg = ARCHS[TRAIN_ARCH].reduced()
    k = TRAIN_SMALL
    step = make_train_step(cfg, TrainConfig(accum=k["accum"]))
    params, opt = init_all(cfg, torch.Generator(device=dev).manual_seed(seed),
                           dev)
    b1, b2 = (synthetic_lm_batch(torch.Generator(device=dev).manual_seed(i),
                                 cfg, k["batch"], k["seq"]) for i in (1, 2))
    p1, o1, _ = step(params, opt, b1)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        save_checkpoint(tmp, 1, {"params": p1, "opt": o1})
        check(latest_step(tmp) == 1, "train resume: latest_step")
        r = restore_checkpoint(tmp, {"params": p1, "opt": o1})
    same_r = all(torch.equal(a, b) and a.device == b.device
                 for (_, a), (_, b) in zip(
                     named_leaves((r["params"], r["opt"])),
                     named_leaves((p1, o1))))
    check(same_r, "train resume: the restored state differs from the saved")
    p2, o2, m2 = step(p1, o1, b2)
    p2r, o2r, m2r = step(r["params"], r["opt"], b2)
    errs = leaf_errs(torch, (p2, o2), (p2r, o2r))
    bitwise = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        named_leaves((p2, o2, m2)), named_leaves((p2r, o2r, m2r))))
    line = (f"train resume: {cfg.name}, step 2 from the restored step-1 "
            f"checkpoint against step 2 in memory: "
            f"{'bitwise equal' if bitwise else 'DIFFERS'} (params and AdamW "
            f"state, loss {float(m2r['loss']):.6f}, grad_norm "
            f"{float(m2r['grad_norm']):.6f}; largest leaf error "
            f"{max(errs.values()):.2e})")
    log(line + f" [{smi}]")
    check(bitwise, line)


def train_cli_start(ckpt_dir, dev):
    """Start ``python -m repro_torch.launch.train`` (CLI_TRAIN, reduced,
    checkpoints in ``ckpt_dir``) on its default device (the card; ``dev``
    in a rehearsal on the CPU).  -> (process, start time)"""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    where = () if dev.type == "cuda" else ("--device", str(dev))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *CLI_TRAIN,
           "--ckpt-dir", str(ckpt_dir), *where]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT), time.perf_counter()


def train_cli_wait(started, smi):
    """Wait for a train CLI run: it exits 0; its lines."""
    proc, t0 = started
    out, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"train CLI exited {proc.returncode}: "
          f"{err[-2000:]}")
    lines = out.splitlines()
    for ln in lines:
        log(f"train CLI: {ln}")
    log(f"train CLI: {' '.join(CLI_TRAIN)}: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    return lines


def train_cli_resumed(first, second, ckpts, smi):
    """The first run (3 steps, a checkpoint at step 2) prints steps 0 and
    2; the rerun resumes from step 2 and its step 2 reads the first run's
    loss."""
    loss = {ln.split()[1]: ln.split()[3] for ln in first
            if ln.startswith("step")}
    again = [ln for ln in second if ln.startswith("step")]
    check(first[-1:] == ["done"] and set(loss) == {"0", "2"}
          and not any(ln.startswith("resumed") for ln in first),
          f"train CLI, first run: {first}")
    check(second[:1] == ["resumed from step 2"] and len(again) == 1
          and again[0].split()[1] == "2"
          and again[0].split()[3] == loss["2"] and second[-1:] == ["done"],
          f"train CLI, rerun: {second} (first run's step 2 loss "
          f"{loss.get('2')})")
    check(ckpts == ["step_00000002"], f"train CLI: checkpoints {ckpts}")
    log(f"train CLI: the rerun resumed from step 2 and read the first run's "
        f"step 2 loss {loss['2']} [{smi}]")


def train_path(torch, dev, seed, smi=None):
    """Phase train, callable alone (builds no kernel: the training path
    has none).  The train CLI's first run overlaps the checks that time
    nothing."""
    import os
    import tempfile
    smi = smi or smi_line()
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        first = train_cli_start(tmp, dev)
        train_reduced(torch, dev, seed, smi)
        train_mm(torch, dev, seed, smi)
        train_resume(torch, dev, seed, smi)
        first = train_cli_wait(first, smi)
        second = train_cli_wait(train_cli_start(tmp, dev), smi)
        train_cli_resumed(first, second, sorted(os.listdir(tmp)), smi)
    train_full(torch, dev, seed, smi)
    log(f"train: phase {time.perf_counter() - t0:.1f} s [{smi}]")


# ---------------------------------------------------------------------------
# phase launch: the launch tooling (plans of every cell on the production
# meshes; the two full-width cells the card ran, traced on meta tensors and
# held against the card)
# ---------------------------------------------------------------------------
LAUNCH_PEAKS = {}             # kind -> (max_memory_allocated of one call,
                              #  bytes resident then that it does not take)
LAUNCH_RATIO = (0.67, 1.5)    # the call's peak over the meta estimate
LAUNCH_CELLS = (("prefill", LM_ARCH, "prefill_32k", 1),
                ("train", TRAIN_ARCH, "train_4k", TRAIN_BATCH))


def launch_mark(torch, inputs):
    """Before the one call that phase launch holds its estimate against
    (the caller synchronizes after it, then reads max_memory_allocated):
    collects garbage and resets the peak statistics.  -> (the peak so
    far, the bytes resident beyond the call's inputs)."""
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.max_memory_allocated()
    other = torch.cuda.memory_allocated() - tree_bytes(inputs)
    torch.cuda.reset_peak_memory_stats()
    return before, other


def launch_plans():
    """Every (cell, mesh) pair planned at full width on the production
    meshes (plans only): mode and argument bytes a device."""
    from repro_torch.launch import dryrun, shapes
    from repro_torch.launch.mesh import make_production_mesh
    t0 = time.perf_counter()
    meshes = (("pod1", make_production_mesh()),
              ("pod2", make_production_mesh(multi_pod=True)))
    n = 0
    for arch, shape in shapes.all_cells():
        reason = shapes.skip_reason(arch, shape)
        if reason:
            log(f"launch plan: {arch} {shape}: skipped ({reason})")
            continue
        per = []
        for which, mesh in meshes:
            plan = shapes.plan_cell(arch, shape, mesh)
            nb = dryrun.sharded_bytes(plan.args, plan.in_shardings)
            per.append(f"{which} {nb} ({nb / 2**30:.3f} GiB)")
            n += 1
        log(f"launch plan: {arch} {shape}: mode {plan.mode}, argument "
            f"bytes a device " + ", ".join(per))
    for mp in (False, True):
        nb = dryrun.rairs_arg_bytes(mp)
        log(f"launch plan: rairs-sift1b serve: mode rairs_serve, argument "
            f"bytes a device {'pod2' if mp else 'pod1'} {nb} "
            f"({nb / 2**30:.3f} GiB)")
    check(n == 76, f"launch: {n} (cell, mesh) pairs planned, not 76")
    log(f"launch: {n} (cell, mesh) pairs and the rairs cell planned in "
        f"{time.perf_counter() - t0:.1f} s (plans only, no trace)")


def launch_estimates(smi):
    """The two cells the card ran at full width (phases lm and train),
    planned at the batch they ran and traced once on meta tensors: the
    peak-live estimate beside the card's max_memory_allocated of one call
    of the step, the GEMM FLOPs beside model_flops (and train_flops)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import costpass, hillclimb, shapes
    from repro_torch.launch.mesh import make_host_mesh
    saved = shapes.SHAPES
    lo, hi = LAUNCH_RATIO
    try:
        for kind, arch, shape, batch in LAUNCH_CELLS:
            shapes.SHAPES = dict(saved, **{shape: dict(
                saved[shape], global_batch=batch)})
            info = shapes.SHAPES[shape]
            plan = shapes.plan_cell(arch, shape,
                                    make_host_mesh(device="meta"))
            cost, out = costpass.trace(plan.step_fn, plan.args)
            del out
            est = cost["peak_bytes"]
            check(kind in LAUNCH_PEAKS,
                  f"launch: no measured peak for {kind} (run lm_full and "
                  f"train_full first)")
            card, other = LAUNCH_PEAKS[kind]
            ratio = (card - other) / est
            mf = hillclimb.model_flops(arch, shape)
            line = (f"launch {kind}: {arch} {shape} at batch {batch} "
                    f"(S {info['seq_len']}): traced on meta in "
                    f"{cost['trace_s']} s, {cost['ops']} ops; peak estimate "
                    f"{est} B ({est / 2**30:.2f} GiB; arguments "
                    f"{cost['arg_bytes'] / 2**30:.2f} GiB); the card's "
                    f"max_memory_allocated of one call {card} B "
                    f"({card / 2**30:.2f} GiB, {card / est:.4f} of the "
                    f"estimate), of which {other} B ({other / 2**30:.2f} "
                    f"GiB) were resident and not the call's inputs: the "
                    f"call with its inputs {card - other} B, ratio "
                    f"{ratio:.4f} (in [{lo}, {hi}]); GEMM FLOPs "
                    f"{cost['flops']:.6e} against model_flops {mf:.6e}: "
                    f"{cost['flops'] / mf:.4f}")
            if kind == "train":
                tf = train_flops(ARCHS[arch], batch * info["seq_len"],
                                 info["seq_len"])
                line += (f", against train_flops {tf:.6e}: "
                         f"{cost['flops'] / tf:.4f}")
            log(line + f"; unfused bytes {cost['bytes_accessed']:.6e} "
                f"[{smi}]")
            check(lo <= ratio <= hi, line)
    finally:
        shapes.SHAPES = saved


def launch_path(torch, smi=None):
    """Phase launch (no kernel: the launch tooling plans and traces on
    meta tensors).  Needs LAUNCH_PEAKS from lm_full and train_full."""
    smi = smi or smi_line()
    t0 = time.perf_counter()
    launch_plans()
    launch_estimates(smi)
    log(f"launch: phase {time.perf_counter() - t0:.1f} s [{smi}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device: {name} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s into {next(iter(libs.values())).parent}")
    for stem, text in getattr(build.build_all, "logs", {}).items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {stem}: {line.strip()}")

    check_kernels(torch, dev, args.seed)
    encode_hold(torch, dev, args.seed)
    index, q, gt, launches, held, held_reuse, results = main_path(torch, dev,
                                                                  args)
    rate = lookup_rate(torch)
    time_held(torch, held, "timing: clustered qt=64", rate)
    for mode, h in held_reuse.items():
        time_held(torch, h, f"timing: plan reuse {mode}", rate)
    del held, held_reuse
    rows = time_kernels(torch, index, q[:1024].contiguous(), rate)
    stage_breakdown(torch, index, q[:1024].contiguous())
    refine = refine_path(torch, index, q, gt, results, rate)
    gateway = gateway_path(torch, index, q, gt, results, rate)
    shard = sharded_path(torch, index, q, gt, results, rate, smi)
    del index, results
    gc.collect()
    torch.cuda.empty_cache()
    stream = stream_path(torch, dev, args, rate)
    gc.collect()
    torch.cuda.empty_cache()
    ip_path(torch, dev, args.seed)
    multi_path(torch, dev, args.seed)
    nbits8 = nbits8_path(torch, dev, args.seed, rate)
    gist_rows, gist_launches = gist_path(torch, dev, args.seed, rate)
    small_reference(torch, dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    lm_path(torch, dev, args.seed, smi)
    train_path(torch, dev, args.seed, smi)
    launch_path(torch, smi)
    kernels = kernel_json(rows, launches, gist_rows, gist_launches, *nbits8,
                          *refine, *stream, *gateway, *shard)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
