"""K3's global-table form (``GT``: unpacked K = 256 with one query's table
above a CTA's shared memory, PQ256x8), on the CPU.

On the card such a shape takes the GT form from the shape alone
(``kernels/pq_scan.py::gt_fits``), one launch a call, a CTA a query of a
tile and a split (``csrc/pq_scan_topk.cu::pq_scan_topk_gt``):

  * the positions its query plans are compacted a window of KWIN at a
    time, in ascending order;
  * their items are tested GCK a thread at a time (id, tombstone, the
    SEIL rank test) and the kept ones appended to a list, in order;
  * once the list holds a pass of GIPT x NT items (or at the end), the
    pass is scored against the table staged in ranges of GR
    subquantizers (the last one short where M % GR), each item's row
    read in pieces of 16 or 8 bytes, byte j of a little-endian word the
    code of subquantizer ``4 * word + j``; each sum carried from range
    to range;
  * the pass's scores go through the filter: a queue of FW entries,
    pushes that beat the accumulator's fetch-th key, flushes when the
    queue fills, pending items retried with their held scores.

A plain twin of that order runs here and equals the plain version
(``ref.py``) bitwise, and the Pallas kernel in interpret mode (ids,
positions and DCO exact; distances bitwise on integer tables, within
rtol=atol=1e-5 on random f32 ones).  The CUDA kernel is held bitwise
against ``ref.py`` on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pq_scan as jpq
from repro_torch.core import engine as teng
from repro_torch.kernels import pq_scan as tpq
from repro_torch.kernels import ref as tref
from repro_torch.kernels.topk import PAD_POS

TOL = dict(rtol=1e-5, atol=1e-5)
# pq_scan_topk.cu: threads of a CTA, window of positions, items a thread
# scores in a pass, items a thread tests at a time, subquantizers a range
GT = dict(nt=256, kwin=512, ipt=8, ck=4, gr=16)


def t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, mode, *, qt, m, b, s, tb=None, blk=32, nlist=10, nid=300,
            ints=True, p_valid=0.85, dead=True):
    """K3's inputs in ``mode`` (as fused_scan_args makes them) at K 256:
    duplicate ids, invalid items, co-assignments, tombstones."""
    rng = np.random.default_rng(seed)
    tb = tb or s + 20
    lut = (rng.integers(0, 3, (b, m, 256)) if ints
           else rng.standard_normal((b, m, 256))).astype(np.float32)
    store = teng.BlockStore(
        t(rng.integers(0, 256, (tb, blk, m)).astype(np.uint8)),
        t(rng.integers(-1, nid, (tb, blk)).astype(np.int32)),
        t(rng.integers(-1, nlist, (tb, blk)).astype(np.int32)))
    plan = teng.QueryPlan(
        t(np.stack([rng.choice(tb, s, replace=False)
                    for _ in range(b)]).astype(np.int32)),
        t(np.sort(rng.integers(0, nlist, (b, s)), 1).astype(np.int32)),
        t(rng.random((b, s)) < p_valid), torch.zeros(b, dtype=torch.int32))
    rank_of = t(np.where(rng.random((b, nlist)) < 0.5,
                         rng.integers(0, nlist, (b, nlist)),
                         2 ** 30).astype(np.int32))
    sel = t(np.sort(rng.choice(nlist, (b, 3)), 1).astype(np.int32))
    live = rng.random(nid) < 0.8
    ids = store.block_ids.numpy()
    tomb = (t(((ids >= 0) & ~live[np.maximum(ids, 0)]).astype(np.uint8))
            if dead else None)
    lut_x, tiles, rank_x, slot_of, rank_u, q, _ = teng.fused_scan_args(
        store, plan, t(lut), rank_of, exec_mode=mode, query_tile=qt, sel=sel)
    return (lut_x.contiguous(), store.block_codes, store.block_ids,
            store.block_other, tiles.contiguous(), rank_x.contiguous(),
            slot_of, rank_u, tomb), q


def range_scores(lut_q, rows, ch, gr):
    """The GT form's sums for one query: rows (n, M) uint8 read range by
    range (``gr`` subquantizers, the last one short where M % gr), each
    range in pieces of ``ch`` bytes, each piece as 32-bit little-endian
    words, byte j of word w the code of subquantizer ``m0 + ch * v + 4 *
    w + j``; one f32 add at a time.  Returns the sums and the
    subquantizers in the order they were added."""
    n, m = rows.shape
    words = np.ascontiguousarray(rows).view("<u4")            # (n, M / 4)
    acc = np.zeros(n, np.float32)
    order = []
    for m0 in range(0, m, gr):
        for v in range(min(gr, m - m0) // ch):
            for j in range(ch):
                sub = m0 + ch * v + j
                w = words[:, sub // 4]
                code = (w >> np.uint32(8 * (j % 4))) & np.uint32(255)
                acc = acc + lut_q[sub][code.astype(np.int64)]
                order.append(sub)
    return acc, order


def _less(a, b):
    return a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])


class Filter:
    """The shared filter of one query (pq_scan_topk.cu's Sel, push_warp,
    flush): an accumulator of FW triples ascending by (d, pos), a queue
    of FW; a scored item is queued if it beats the accumulator's
    fetch-th key, an item whose push finds the queue full waits, a full
    queue is flushed (merged into the accumulator) and the waiting items
    are tried again with their held scores."""

    def __init__(self, fetch):
        self.fetch, self.fw = fetch, tpq.topk_width(fetch)
        self.acc = [(np.float32(np.inf), PAD_POS, -1)] * self.fw
        self.queue, self.flushes = [], 0

    def _push(self, it, pend):
        if not _less(it, self.acc[self.fetch - 1]):
            return False
        if len(self.queue) >= self.fw:
            pend.append(it)
            return True
        self.queue.append(it)
        return len(self.queue) >= self.fw

    def flush(self):
        self.acc = sorted(self.acc + self.queue,
                          key=lambda e: (float(e[0]), e[1]))[:self.fw]
        self.queue = []
        self.flushes += 1

    def offer(self, items):
        """One pass's scored items, in the order the CTA pushes them."""
        pend = []
        full = False
        for it in items:
            full |= self._push(it, pend)
        while full:
            self.flush()
            retry, pend, full = pend, [], False
            for it in retry:
                full |= self._push(it, pend)

    def result(self):
        if self.queue:
            self.flush()
        return self.acc[:self.fetch]


def gt_twin(args, *, qt, fetch, splits, ch=16, nt=256, kwin=512, ipt=8, ck=4,
            gr=16, stats=None):
    """K3's GT form, step by step: for each query of each tile and each of
    ``splits`` ranges of positions, windows of ``kwin`` planned positions
    (ascending), keep steps of ``ck * nt`` items appending the kept ones
    to the list, a pass of ``ipt * nt`` items scored (``range_scores``)
    and offered to the filter whenever the list holds one (the rest moved
    to the front), the last partial pass at the end; each split's
    top-``fetch`` merged over the splits (``merge_topk_ref``, what the
    card's merge computes).  ``stats`` collects (passes, flushes) per
    CTA."""
    lut, codes, ids, other, tiles, rank_of, slot_of, rank_u, dead = (
        x.numpy() if x is not None else None for x in args)
    b, m, _ = lut.shape
    _, s = tiles.shape
    blk = codes.shape[1]
    rows_all = codes.reshape(-1, m)
    ids_f, oth_f = ids.reshape(-1), other.reshape(-1)
    dead_f = None if dead is None else dead.reshape(-1)
    s_per = max(1, -(-s // splits))
    pass_items, step = ipt * nt, ck * nt
    parts = np.zeros((3, b, splits, fetch), np.float64)
    parts[0], parts[1], parts[2] = np.inf, PAD_POS, -1
    dco = np.zeros(b, np.int32)
    for bq in range(b):
        tile = bq // qt
        for y in range(splits):
            filt, kept, passes = Filter(fetch), [], 0

            def score_pass(entries):
                item = np.array([e[0] for e in entries])
                d, _ = range_scores(lut[bq], rows_all[item], ch, gr)
                filt.offer([(d[i], e[1], e[2])
                            for i, e in enumerate(entries)])

            for w0 in range(y * s_per, min(s, (y + 1) * s_per), kwin):
                w1 = min(s, (y + 1) * s_per, w0 + kwin)
                pos = [p for p in range(w0, w1) if slot_of[bq, p] >= 0]
                n = len(pos) * blk
                for f0 in range(0, n, step):
                    for f in range(f0, min(n, f0 + step)):
                        p, ln = pos[f // blk], f % blk
                        item = int(tiles[tile, p]) * blk + ln
                        iid = int(ids_f[item])
                        dco[bq] += iid >= 0
                        ok = iid >= 0 and (dead_f is None or dead_f[item] == 0)
                        o = int(oth_f[item])
                        if ok and o >= 0:
                            ok = rank_of[bq, o] >= rank_u[bq, p]
                        if ok:
                            kept.append((item, int(slot_of[bq, p]) * blk + ln,
                                         iid))
                    if len(kept) >= pass_items:
                        score_pass(kept[:pass_items])
                        kept = kept[pass_items:]
                        passes += 1
            if kept:
                score_pass(kept)
                passes += 1
            if stats is not None:
                stats.append((passes, filt.flushes))
            for c, (d, p, i) in enumerate(filt.result()):
                parts[:, bq, y, c] = (d, p, i)
    merged = tref.merge_topk_ref(
        torch.from_numpy(parts[0].astype(np.float32)),
        torch.from_numpy(parts[1].astype(np.int32)),
        torch.from_numpy(parts[2].astype(np.int32)))
    return merged[0], merged[1], merged[2], torch.from_numpy(dco)


def _check(got, want, exact=True):
    for name, g, w in zip(("acc_d", "acc_pos", "acc_id", "dco"), got, want):
        w = np.asarray(w)
        if name == "acc_d" and not exact:
            np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("m,ch", [(256, 16), (264, 8), (240, 16)])
def test_range_order_is_ascending_m(m, ch):
    """Ranges of 16 (M 264: a short last range of 8; M 240: 15 ranges),
    pieces and bytes in order: every subquantizer once, ascending, and
    the sum bitwise the plain K1's."""
    rng = np.random.default_rng(m)
    lut = rng.standard_normal((1, m, 256)).astype(np.float32)
    codes = rng.integers(0, 256, (5, 32, m)).astype(np.uint8)
    tiles = np.array([[3, 0, 4]], np.int32)
    acc, order = range_scores(lut[0], codes[[3, 0, 4]].reshape(-1, m), ch,
                              GT["gr"])
    assert order == list(range(m))
    want = tref.pq_scan_tiled_ref(t(lut), t(codes), t(tiles), query_tile=1)
    np.testing.assert_array_equal(acc, want.numpy().reshape(-1))


# mode, QT, B, M, fetch, splits, tombstones, tie-heavy integer tables
TWIN_CASES = [
    ("paged", 1, 3, 256, 100, 1, True, True),
    ("paged", 1, 2, 264, 400, 1, False, False),
    ("clustered", 8, 8, 256, 100, 1, True, False),
    ("clustered", 3, 6, 240, 400, 2, True, True),
    ("grouped", 8, 8, 264, 100, 3, False, True),
    ("grouped", 3, 6, 256, 400, 1, True, False),
]


@pytest.mark.parametrize("mode,qt,b,m,fetch,splits,dead,ints", TWIN_CASES)
def test_gt_order_is_the_plain_topk(mode, qt, b, m, fetch, splits, dead,
                                    ints):
    """The GT form's order (windows, keep steps, passes, ranges, the
    filter with held scores) at the card's constants: bitwise the plain
    K3 (ids, positions, distances, DCO)."""
    args, q = _inputs(b + m + fetch, mode, qt=qt, m=m, b=b, s=9, ints=ints,
                      dead=dead)
    ch = 16 if m % 16 == 0 else 8
    got = gt_twin(args, qt=q, fetch=fetch, splits=splits, ch=ch, **GT)
    want = tref.pq_scan_topk_ref(*args, query_tile=q, fetch=fetch)
    _check(got, want)
    assert (got[1] < PAD_POS).any()


@pytest.mark.parametrize("mode,qt,b,m,fetch,splits,dead,ints", TWIN_CASES)
def test_gt_order_is_the_pallas_kernel(mode, qt, b, m, fetch, splits, dead,
                                       ints):
    """The same twin against the Pallas kernel in interpret mode: ids,
    positions and DCO exact; distances bitwise on integer tables (every
    sum exact), within rtol=atol=1e-5 on random f32 ones."""
    args, q = _inputs(b + m + fetch, mode, qt=qt, m=m, b=b, s=5, ints=ints,
                      dead=dead)
    ch = 16 if m % 16 == 0 else 8
    got = gt_twin(args, qt=q, fetch=fetch, splits=splits, ch=ch, **GT)
    pallas = jpq.pq_scan_topk_kernel(
        *(None if x is None else jnp.asarray(x.numpy()) for x in args),
        query_tile=q, fetch=fetch, interpret=True)
    _check(got, pallas, exact=ints)


@pytest.mark.parametrize("ints", [True, False])
def test_gt_passes_windows_and_flushes(ints):
    """Small passes (16 items), windows (3 positions) and keep steps (8
    items) so that a query takes many passes, its list moves its rest to
    the front, and its queue (FW 32 at fetch 20) fills and flushes with
    items waiting: still bitwise the plain K3, over one split and four."""
    args, q = _inputs(11 + ints, "clustered", qt=3, m=264, b=6, s=7,
                      ints=ints)
    small = dict(nt=4, kwin=3, ipt=4, ck=2, gr=16)
    want = tref.pq_scan_topk_ref(*args, query_tile=q, fetch=20)
    for splits in (1, 4):
        stats = []
        got = gt_twin(args, qt=q, fetch=20, splits=splits, ch=8,
                      stats=stats, **small)
        _check(got, want)
        if splits == 1:
            assert max(p for p, _ in stats) >= 8
            assert max(f for _, f in stats) >= 2


def test_gt_query_above_one_pass_at_the_card_constants():
    """A query with more kept items than one pass of 2,048 (S 130 of 32
    lanes, no tombstones): two passes, bitwise the plain K3."""
    args, q = _inputs(5, "paged", qt=1, m=256, b=1, s=130, p_valid=0.97,
                      dead=False, ints=False)
    kept = tref.scan_rows_ref(*args, query_tile=q)[3]
    assert int(kept[0]) > GT["ipt"] * GT["nt"]
    stats = []
    got = gt_twin(args, qt=q, fetch=100, splits=1, stats=stats, **GT)
    assert stats[0][0] == 2
    _check(got, tref.pq_scan_topk_ref(*args, query_tile=q, fetch=100))


# ---------------------------------------------------------------------------
# form selection, shared memory, splits and counts
# ---------------------------------------------------------------------------
def _smem(m, k, n, fw, blk, tables, gs):
    """pq_scan_topk.cu's pq_scan_topk_smem_bytes, written out: the GT
    form's CTA (tables 3) holds two ranges of 16 tables, one query's
    selection state, a window of 512 compacted positions (three ints and
    a count a warp's 32), the kept list of 2,048 + 1,024 entries (three
    ints) and two sets of a step's 4 x 8 warp counts; k256 (tables 2) and
    the others as in tests/test_torch_k256_forms.py."""
    if tables == 3:
        return 4 * (2 * 16 * 256 + 6 * fw + 5 + 3 * 512 + 16 + 3 * 3072
                    + 2 * 4 * 8)
    if tables == 2:
        return 4 * (m * k + 6 * fw + 5 + 3 * 512 + 512 // 32)
    p = max(1, 256 // blk)
    return 4 * ((0 if tables else n * m * k) + (0 if gs else 6 * n * fw + n)
                + n * p + n)


class _Lib:
    pq_scan_topk_smem_bytes = staticmethod(_smem)


@pytest.mark.parametrize("m,k,fw,qt,packed,align,form", [
    (256, 256, 128, 1, False, 16, "GT"),        # gist, paged
    (256, 256, 128, 8, False, 16, "GT"),        # clustered / grouped
    (256, 256, 512, 8, False, 16, "GT"),        # fetch 400
    (264, 256, 128, 8, False, 8, "GT"),         # rows in 8-byte pieces
    (240, 256, 4096, 3, False, 16, "GT"),       # fetch 4,000: 170 KB
    (256, 256, 8192, 8, False, 16, "GT-ldg"),   # its state: 267 KB
    (250, 256, 128, 8, False, 16, "GT-ldg"),    # M not a multiple of 8
    (256, 256, 128, 8, False, 4, "GT-ldg"),     # rows not 8-byte aligned
    (3701, 16, 128, 1, True, 16, "GT-ldg"),     # packed, M in the thousands
    (256, 256, 16384, 8, False, 16, "GS"),      # fetch 16,000: rows
    (64, 256, 128, 8, False, 16, "k256"),       # nbits=8: the k256 form
    (64, 16, 128, 8, False, 16, "shared")])     # the main path
def test_k3_form_from_the_shape(monkeypatch, m, k, fw, qt, packed, align,
                                form):
    monkeypatch.setattr(tpq.build, "load", lambda stem: _Lib)
    groups = tpq.k3_query_groups(m, k, qt, fw, 32, packed=packed,
                                 codes_align=align)
    assert groups.form == form
    assert groups.form in tpq.K3_FORMS
    if form in ("GT", "k256"):
        assert groups == [(0, qt)] and groups.k256
    if form != "GS":
        assert groups.global_tables == (form in ("GT", "GT-ldg"))
    assert groups.tables == {"GT": 3, "k256": 2, "GT-ldg": 1,
                             "shared": 0}.get(form, groups.tables)
    assert _smem(m, k, groups.largest, fw, 32, groups.tables,
                 int(groups.global_state)) <= tpq.SMEM_LIMIT


def test_gt_holds_two_ctas_an_sm_at_the_gist_path():
    """The gist path's CTA (fetch 100): 79,188 B, two to an SM's 228 KB
    with a block's 1 KB reserve; fetch 400 too."""
    one = _smem(256, 256, 1, 128, 32, 3, 0)
    assert one == 79188
    assert 2 * (one + 1024) <= 233472 < 3 * (one + 1024)
    two = _smem(256, 256, 1, 512, 32, 3, 0)
    assert 2 * (two + 1024) <= 233472


def test_query_groups_report_the_gt_forms():
    for groups, form, tables in (
            (tpq.QueryGroups([(0, 8)], global_tables=True, k256=True),
             "GT", 3),
            (tpq.QueryGroups([(0, 8)], global_tables=True), "GT-ldg", 1),
            (tpq.QueryGroups([(0, 8)], global_tables=True,
                             global_state=True), "GS", 1),
            (tpq.QueryGroups([(0, 8)], k256=True), "k256", 2)):
        assert (groups.form, groups.tables) == (form, tables)


@pytest.mark.parametrize("t_,qt,s,want", [
    (1000, 1, 136, 1),       # gist paged: a CTA a query, 3.8 waves
    (125, 8, 1088, 1),       # clustered: 1000 queries
    (8, 8, 2679, 4),         # grouped: 64 queries, one wave of 264
    (1, 64, 2679, 4),
    (2, 3, 300, 9)])
def test_gt_splits_count_queries_not_tiles(monkeypatch, t_, qt, s, want):
    """k3_wave_splits cuts the GT form's splits for the tile's queries, as
    k256's: one full wave (two CTAs an SM) of T * QT CTAs a split, two
    where one wave cuts a query's positions 8 ways or more; the ranges
    cover [0, S) exactly."""
    monkeypatch.setattr(tpq.build, "load", lambda stem: _Lib)
    monkeypatch.setattr(tpq, "_k3_ctas", lambda *a: 2 * 132)
    groups = tpq.QueryGroups([(0, qt)], global_tables=True, k256=True)
    splits, s_per = tpq.k3_wave_splits(groups, t_, s, 256, 256, 128, 32,
                                       False, "cuda:0")
    assert splits == want
    ranges = [(y * s_per, min(s, (y + 1) * s_per)) for y in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi > lo for lo, hi in ranges)


def test_gt_form_counts_follow_graph_replays():
    """GT and GT-ldg are counted apart, beside K3's launch count: a CUDA
    graph's replay adds them (core/graphs.py's add_launch_counts), and a
    CPU call adds neither."""
    tpq.reset_launch_counts()
    before = tpq.launch_counts(forms=True)
    assert {"pq_scan_topk_kernel[GT]",
            "pq_scan_topk_kernel[GT-ldg]"} <= set(before)
    args, q = _inputs(3, "clustered", qt=8, m=256, b=8, s=3)
    tpq.pq_scan_topk_kernel(*args, query_tile=q, fetch=20)
    assert tpq.launch_counts(forms=True) == before
    replay = {"pq_scan_topk_kernel": 3, "pq_scan_topk_kernel[GT]": 2,
              "pq_scan_topk_kernel[GT-ldg]": 1, "merge_topk_kernel": 2}
    for _ in range(2):
        tpq.add_launch_counts(replay)
    after = tpq.launch_counts(forms=True)
    for name, n in replay.items():
        assert after[name] == 2 * n
    assert after["pq_scan_topk_kernel[k256]"] == 0
    tpq.reset_launch_counts()
    assert tpq.launch_counts(forms=True) == before
