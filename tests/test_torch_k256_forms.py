"""The k256 forms of K1 and K3 (unpacked K = 256: PQ64x8), on the CPU.

On the card an ``nbits=8`` index's K1 and K3 take their k256 forms, from
the shape alone (``kernels/pq_scan.py::k1_form`` and ``k256_fits``), one
launch a call:

  * K1 at QT 1 holds the query's table whole in shared memory and reads
    each code row in pieces of 16 or 8 bytes, extracting byte j of a
    little-endian word as subquantizer ``4 * word + j``;
  * K1 on tiles interleaves the tables of each group of 8 queries by
    query in device memory ([M][2][256] float4s: queries 4h .. 4h + 3 of
    a code side by side), copies ranges of 4 subquantizers as they are,
    and carries each (item, query) sum from one range to the next;
  * K3 runs a CTA a query of a tile: it compacts the positions its query
    plans (the result does not depend on their order), scores their
    items 4 a thread, and keeps its top-F of each split, which the merge
    joins.

Plain twins of those orders run here and equal the plain versions
(``ref.py``) bitwise on random f32 tables, and the Pallas kernels in
interpret mode bitwise on integer tables (every sum exact) and within
rtol=atol=1e-5 on random f32 ones.  The CUDA kernels are held bitwise
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
NT = 256                        # threads of a CTA (both kernels)
K1_RANGE, K1_GROUP = 4, 8       # pq_scan.cu's KR and KQ
K3_WINDOW, K3_ITEMS = 512, 4    # pq_scan_topk.cu's KWIN and KIPT


def t(a):
    return torch.from_numpy(np.array(a))


def _k1_inputs(seed, b, m, tb, blk, s, qt, ints=False):
    rng = np.random.default_rng(seed)
    lut = (rng.integers(-8, 9, (b, m, 256)) if ints
           else rng.standard_normal((b, m, 256))).astype(np.float32)
    codes = rng.integers(0, 256, (tb, blk, m)).astype(np.uint8)
    tiles = rng.integers(0, tb, (b // qt, s)).astype(np.int32)
    return lut, codes, tiles


def _pallas_k1(lut, codes, tiles, qt):
    return np.asarray(jpq.pq_scan_tiled_kernel(
        jnp.asarray(lut), jnp.asarray(codes), jnp.asarray(tiles),
        query_tile=qt, interpret=True))


def piece_codes(rows: np.ndarray, ch: int) -> np.ndarray:
    """The codes the k256 forms read from rows (..., M) uint8, in the
    order they add them: pieces of ``ch`` bytes, each split into 32-bit
    little-endian words, byte j of word w the code of subquantizer
    ``ch * piece + 4 * w + j``.  Returns (..., M) codes and their
    subquantizers, both in that order."""
    m = rows.shape[-1]
    words = np.ascontiguousarray(rows).view("<u4")           # (..., M / 4)
    codes, subs = [], []
    for v in range(m // ch):
        for j in range(ch):
            w = words[..., (ch * v + j) // 4]
            codes.append((w >> np.uint32(8 * (j % 4))) & np.uint32(255))
            subs.append(ch * v + j)
    return np.stack(codes, -1).astype(np.int64), np.array(subs)


def k1_one_twin(lut, codes, tiles, ch):
    """K1's k256 form at QT 1: each item's row through ``piece_codes``,
    one f32 add at a time."""
    rows = tref._tile_codes(codes, tiles, False).numpy()     # (B, S, BLK, M)
    c, subs = piece_codes(rows, ch)
    lut = lut.numpy()
    acc = np.zeros(rows.shape[:-1], np.float32)
    for i, m in enumerate(subs):
        acc = acc + lut[:, m][np.arange(lut.shape[0])[:, None, None],
                              c[..., i]]
    return torch.from_numpy(acc.reshape(lut.shape[0], -1, rows.shape[2]))


def interleave(lut, t_, qs, qt):
    """k256_interleave: (B, M, 256) tables -> (T, G, M, 2, 256, 4), the
    queries of group g at [.., h, code, j] = query 8g + 4h + j, 0 past
    QT."""
    b, m, _ = lut.shape
    g_ = -(-qt // K1_GROUP)
    il = torch.zeros((t_, g_, m, 2, 256, 4))
    for tile in range(t_):
        for q in range(qt):
            g, r = divmod(q, K1_GROUP)
            il[tile, g, :, r // 4, :, r % 4] = lut[tile * qs + q]
    return il


def k1_tile_twin(lut, codes, tiles, *, qt, pass_items):
    """K1's k256 form on tiles: the interleaved tables, for each group a
    pass of ``pass_items`` items scored against each range of K1_RANGE
    subquantizers (the last one short where M % K1_RANGE), copied whole
    from the interleaved run, every sum carried from range to range."""
    b, m, _ = lut.shape
    t_, s = tiles.shape
    il = interleave(lut, t_, qt, qt)
    rows = tref._tile_codes(codes, tiles, False).reshape(t_, -1, m).long()
    n = rows.shape[1]
    out = torch.empty((t_, qt, n))
    for g in range(il.shape[1]):
        nq = min(K1_GROUP, qt - K1_GROUP * g)
        for p0 in range(0, n, pass_items):
            c = rows[:, p0:p0 + pass_items]                 # (T, P, M)
            acc = torch.zeros((t_, c.shape[1], K1_GROUP))
            for m0 in range(0, m, K1_RANGE):
                buf = il[:, g, m0:m0 + K1_RANGE].clone()    # the range run
                for j in range(buf.shape[1]):
                    for h in range(2 if nq > 4 else 1):
                        e = torch.gather(
                            buf[:, j, h], 1,
                            c[:, :, m0 + j, None].expand(-1, -1, 4))
                        acc[..., 4 * h:4 * h + 4] = acc[..., 4 * h:4 * h + 4] + e
            out[:, K1_GROUP * g:K1_GROUP * g + nq, p0:p0 + pass_items] = \
                acc[..., :nq].transpose(1, 2)
    return out.reshape(b, s, -1)


@pytest.mark.parametrize("m,ch", [(64, 16), (64, 8), (72, 8), (40, 8)])
def test_k1_one_query_order_is_the_plain_sum(m, ch):
    """Rows in 16- or 8-byte pieces, bytes of little-endian words: the
    subquantizers come in ascending order, and the sum is bitwise the
    plain K1 and the Pallas kernel (integer tables: bitwise; random f32:
    within 1e-5)."""
    for ints in (False, True):
        lut, codes, tiles = _k1_inputs(m + ch, 3, m, 9, 32, 4, 1, ints)
        assert list(piece_codes(codes[:1, :1], ch)[1]) == list(range(m))
        got = k1_one_twin(t(lut), t(codes), t(tiles), ch)
        want = tref.pq_scan_tiled_ref(t(lut), t(codes), t(tiles),
                                      query_tile=1)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        pallas = _pallas_k1(lut, codes, tiles, 1)
        if ints:
            np.testing.assert_array_equal(got.numpy(), pallas)
        else:
            np.testing.assert_allclose(got.numpy(), pallas, **TOL)


@pytest.mark.parametrize("qt,m", [(8, 64), (3, 64), (8, 42), (16, 72),
                                  (5, 40)])
def test_k1_tile_order_is_the_plain_sum(qt, m):
    """Interleaved tables, ranges of 4 (M 42: a short last range of 2),
    groups of 8 queries (QT 16: two; QT 3 and 5: one part full), passes
    that leave a short last one: bitwise the plain K1, and the Pallas
    kernel (integer tables: bitwise; random f32: within 1e-5)."""
    for ints in (False, True):
        lut, codes, tiles = _k1_inputs(qt + m, 2 * qt, m, 7, 32, 3, qt,
                                       ints)
        got = k1_tile_twin(t(lut), t(codes), t(tiles), qt=qt, pass_items=40)
        want = tref.pq_scan_tiled_ref(t(lut), t(codes), t(tiles),
                                      query_tile=qt)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        pallas = _pallas_k1(lut, codes, tiles, qt)
        if ints:
            np.testing.assert_array_equal(got.numpy(), pallas)
        else:
            np.testing.assert_allclose(got.numpy(), pallas, **TOL)


def test_interleave_puts_each_query_in_its_lane():
    lut = torch.arange(2 * 11 * 3 * 256, dtype=torch.float32).reshape(
        22, 3, 256)
    il = interleave(lut, 2, 11, 11)                 # 2 tiles of 11: G 2
    assert il.shape == (2, 2, 3, 2, 256, 4)
    for tile, q, m, c in ((0, 0, 0, 0), (1, 10, 2, 255), (0, 5, 1, 7)):
        g, r = divmod(q, 8)
        assert il[tile, g, m, r // 4, c, r % 4] == lut[tile * 11 + q, m, c]
    assert (il[:, 1, :, :, :, 3] == 0).all()        # queries 11 .. 15
    assert (il[:, 1, :, 1] == 0).all()


def _k3_inputs(seed, mode, *, qt, m, b, s, tb=20, blk=32, nlist=10,
               nid=300, ints=True):
    """K3's inputs in ``mode`` (as fused_scan_args makes them) at K 256:
    duplicate ids, invalid items, co-assignments, a dead tile."""
    rng = np.random.default_rng(seed)
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
        t(rng.random((b, s)) < 0.85), torch.zeros(b, dtype=torch.int32))
    rank_of = t(np.where(rng.random((b, nlist)) < 0.5,
                         rng.integers(0, nlist, (b, nlist)),
                         2 ** 30).astype(np.int32))
    sel = t(np.sort(rng.choice(nlist, (b, 3)), 1).astype(np.int32))
    live = rng.random(nid) < 0.8
    ids = store.block_ids.numpy()
    dead = t(((ids >= 0) & ~live[np.maximum(ids, 0)]).astype(np.uint8))
    lut_x, tiles, rank_x, slot_of, rank_u, q, _ = teng.fused_scan_args(
        store, plan, t(lut), rank_of, exec_mode=mode, query_tile=qt, sel=sel)
    return (lut_x.contiguous(), store.block_codes, store.block_ids,
            store.block_other, tiles.contiguous(), rank_x.contiguous(),
            slot_of, rank_u, dead), q


def k3_twin(args, *, qt, fetch, splits, ch=16, seed=0):
    """K3's k256 form: for each query of each tile and each of ``splits``
    ranges of positions, the positions the query plans, compacted a
    window of K3_WINDOW at a time (in a random order here: the result
    does not depend on it; the kernel keeps them ascending); their items (valid
    ones counted into the DCO) kept as the plain version keeps them,
    scored through ``piece_codes``; the split's top-``fetch`` of its kept
    items by (d, pos), then the splits' lists merged (``merge_topk_ref``,
    what the card's merge computes)."""
    lut, codes, ids, other, tiles, rank_of, slot_of, rank_u, dead = args
    b, m, _ = lut.shape
    t_, s = tiles.shape
    blk = codes.shape[1]
    rng = np.random.default_rng(seed)
    s_per = max(1, -(-s // splits))
    parts = torch.full((3, b, splits, fetch), 0.0)
    parts[0] = float("inf")
    parts[1] = PAD_POS
    parts[2] = -1
    dco = torch.zeros(b, dtype=torch.int32)
    lane = torch.arange(blk)
    for bq in range(b):
        tile = bq // qt
        for y in range(splits):
            kept = []
            for w0 in range(y * s_per, min(s, (y + 1) * s_per), K3_WINDOW):
                w1 = min(s, (y + 1) * s_per, w0 + K3_WINDOW)
                pos = [p for p in range(w0, w1) if slot_of[bq, p] >= 0]
                for p in rng.permutation(pos).tolist():
                    item = int(tiles[tile, p]) * blk + lane
                    iid = ids.reshape(-1)[item]
                    dco[bq] += int((iid >= 0).sum())
                    oth = other.reshape(-1)[item]
                    keep = (iid >= 0) & (dead.reshape(-1)[item] == 0)
                    keep &= (oth < 0) | (rank_of[bq, oth.clamp_min(0)]
                                         >= rank_u[bq, p])
                    c, subs = piece_codes(
                        codes.reshape(-1, m)[item].numpy(), ch)
                    d = np.zeros(blk, np.float32)
                    for i, mm in enumerate(subs):
                        d = d + lut[bq, mm].numpy()[c[:, i]]
                    for ln in torch.nonzero(keep).flatten().tolist():
                        kept.append((float(d[ln]),
                                     int(slot_of[bq, p]) * blk + ln,
                                     int(iid[ln])))
            if kept:
                row = torch.tensor([[k[0] for k in kept]])
                got = tref.select_topk_ref(
                    row, torch.tensor([[k[1] for k in kept]]).int(),
                    torch.tensor([[k[2] for k in kept]]).int(), fetch=fetch)
                for i in range(3):
                    parts[i, bq, y] = got[i][0].to(parts.dtype)
    merged = tref.merge_topk_ref(parts[0].contiguous(),
                                 parts[1].int().contiguous(),
                                 parts[2].int().contiguous())
    return merged[0], merged[1], merged[2], dco


@pytest.mark.parametrize("mode,qt,b,m,splits", [
    ("paged", 1, 3, 64, 1), ("clustered", 8, 8, 64, 1),
    ("grouped", 8, 8, 64, 3), ("clustered", 4, 8, 72, 2),
    ("grouped", 3, 6, 40, 1)])
def test_k3_order_is_the_plain_topk(mode, qt, b, m, splits):
    """A CTA a query, positions compacted in any order, splits merged:
    bitwise the plain K3 (ids, positions, distances, DCO) and the Pallas
    kernel in interpret mode (integer tables: every sum exact)."""
    args, q = _k3_inputs(b + m + splits, mode, qt=qt, m=m, b=b, s=5)
    fetch = 40
    ch = 16 if m % 16 == 0 else 8
    got = k3_twin(args, qt=q, fetch=fetch, splits=splits, ch=ch)
    want = tref.pq_scan_topk_ref(*args, query_tile=q, fetch=fetch)
    for name, g, w in zip(("acc_d", "acc_pos", "acc_id", "dco"), got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    assert (got[1] < PAD_POS).any()
    pallas = jpq.pq_scan_topk_kernel(*(jnp.asarray(x.numpy()) for x in args),
                                     query_tile=q, fetch=fetch,
                                     interpret=True)
    for name, g, w in zip(("acc_d", "acc_pos", "acc_id", "dco"), got,
                          pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def test_k3_order_is_the_plain_topk_on_random_f32():
    args, q = _k3_inputs(7, "clustered", qt=8, m=64, b=8, s=5, ints=False)
    got = k3_twin(args, qt=q, fetch=30, splits=2)
    want = tref.pq_scan_topk_ref(*args, query_tile=q, fetch=30)
    for name, g, w in zip(("acc_d", "acc_pos", "acc_id", "dco"), got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


# ---------------------------------------------------------------------------
# form selection, shared memory and splits at the K 256 shapes
# ---------------------------------------------------------------------------
def _k3_smem(m, k, n, fw, blk, tables, gs):
    """pq_scan_topk.cu's pq_scan_topk_smem_bytes, written out: the k256
    form's CTA (tables 2) holds one query's table and selection state, a
    window of KWIN compacted positions (three ints each) and a count a
    warp's 32 of them; the other forms as in
    tests/test_torch_query_groups.py."""
    if tables == 2:
        return 4 * (m * k + 6 * fw + 5 + 3 * K3_WINDOW + K3_WINDOW // 32)
    p = max(1, NT // blk)
    return 4 * ((0 if tables else n * m * k) + (0 if gs else 6 * n * fw + n)
                + n * p + n)


@pytest.mark.parametrize("m,k,fw,packed,align,fits", [
    (64, 256, 128, False, 16, True),       # nbits=8, fetch 100
    (64, 256, 512, False, 16, True),       # fetch 400
    (72, 256, 128, False, 8, True),        # rows in 8-byte pieces
    (40, 256, 512, False, 8, True),
    (64, 256, 128, False, 4, False),       # rows not 8-byte aligned
    (60, 256, 128, False, 16, False),      # M not a multiple of 8
    (256, 256, 128, False, 16, False),     # gist: 256 KB of tables
    (64, 256, 16384, False, 16, False),    # fetch 16,000: candidate rows
    (64, 16, 128, False, 16, False),       # K 16: the shared form
    (32, 16, 512, True, 16, False)])       # a packed plane
def test_k3_k256_form_from_the_shape(m, k, fw, packed, align, fits):
    assert tpq.k256_fits(m, k, fw, 32, packed, align, _k3_smem) == fits


def test_k3_k256_holds_three_ctas_an_sm_at_nbits8():
    """The nbits=8 path's CTA (M 64, fetch 100): 74,836 B, three to an
    SM's 228 KB with a block's 1 KB reserve; fetch 400: two."""
    one = _k3_smem(64, 256, 8, 128, 32, 2, 0)
    assert one == 74836 and one == _k3_smem(64, 256, 1, 128, 32, 2, 0)
    assert 3 * (one + 1024) <= 233472 < 4 * (one + 1024)
    two = _k3_smem(64, 256, 8, 512, 32, 2, 0)
    assert 2 * (two + 1024) <= 233472 < 3 * (two + 1024)


def test_query_groups_report_the_k256_form():
    for groups, form, tables in (
            (tpq.QueryGroups([(0, 8)], k256=True), "k256", 2),
            (tpq.QueryGroups([(0, 2), (2, 5), (5, 8)]), "shared", 0),
            (tpq.QueryGroups([(0, 8)], global_tables=True), "GT-ldg", 1),
            (tpq.QueryGroups([(0, 8)], global_tables=True, k256=True),
             "GT", 3),
            (tpq.QueryGroups([(0, 8)], global_state=True), "GS", 0),
            (tpq.QueryGroups([(0, 8)], global_tables=True,
                             global_state=True), "GS", 1)):
        assert (groups.form, groups.tables) == (form, tables)
        assert groups.form in tpq.K3_FORMS


@pytest.mark.parametrize("t_,qt,s,want", [
    (1024, 1, 173, 1),       # paged: a CTA a query fills the card
    (128, 8, 1384, 1),       # clustered: 1024 queries, 2.6 waves
    (8, 8, 4064, 6),         # grouped: 64 queries, one wave of 396
    (1, 64, 4064, 6),
    (2, 3, 300, 9)])
def test_k3_k256_splits_count_queries_not_tiles(monkeypatch, t_, qt, s,
                                                want):
    """k3_wave_splits cuts the k256 form's splits for the tile's queries:
    one full wave (here 3 CTAs an SM) of T * QT CTAs a split, two where
    one wave cuts a query's positions 8 ways or more; the ranges cover
    [0, S) exactly."""
    class Lib:
        @staticmethod
        def pq_scan_topk_smem_bytes(m, k, n, fw, blk, gt, gs):
            assert gt == 2 and n == qt
            return 74836
    monkeypatch.setattr(tpq.build, "load", lambda stem: Lib)
    monkeypatch.setattr(tpq, "_k3_ctas", lambda *a: 3 * 132)
    groups = tpq.QueryGroups([(0, qt)], k256=True)
    splits, s_per = tpq.k3_wave_splits(groups, t_, s, 64, 256, 128, 32,
                                       False, "cuda:0")
    assert splits == want
    ranges = [(y * s_per, min(s, (y + 1) * s_per)) for y in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi > lo for lo, hi in ranges)
    waves = 2 if 3 * 132 // (t_ * qt) >= 8 else 1
    assert t_ * qt * splits <= max(waves * 3 * 132, t_ * qt)


@pytest.mark.parametrize("t_,qt,s,blk", [
    (128, 8, 1384, 32), (8, 8, 4064, 32), (1, 64, 40, 32), (2, 16, 1100, 32),
    (1, 8, 9, 4096), (4, 3, 129, 32), (1, 8, 0, 32)])
def test_k1_k256_tile_splits_cover_s_exactly(t_, qt, s, blk):
    """K1's k256 tiles split like the staged form, over the T * G CTAs of
    a split (G groups of 8 queries): the ranges cover [0, S) exactly, and
    a CTA holds one pass of 2,048 items where a position fits in one."""
    g = tpq.k1_k256_groups(qt)
    assert g == -(-qt // 8)
    splits, s_per = tpq.staged_splits(t_ * g, s, blk)
    ranges = [(y * s_per, min(s, (y + 1) * s_per)) for y in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert s == 0 or all(b > a for a, b in ranges)
    assert blk > tpq.K1_STAGED_PASS or s_per * blk <= tpq.K1_STAGED_PASS


def test_k1_k256_splits_at_the_nbits8_shapes():
    """Clustered (128 tiles of S 1384) and grouped (8 of S 4064): one
    pass of 2,048 items a CTA, 2,816 and 512 CTAs."""
    assert tpq.staged_splits(128, 1384, 32) == (22, 63)
    assert tpq.staged_splits(8, 4064, 32) == (64, 64)


def test_k3_form_counts_follow_graph_replays():
    """K3's launches by form are counters beside its launch count: a CUDA
    graph's replay adds both (core/graphs.py's add_launch_counts), and a
    CPU call adds neither."""
    tpq.reset_launch_counts()
    before = tpq.launch_counts(forms=True)
    assert set(before) >= {f"pq_scan_topk_kernel[{f}]" for f in tpq.K3_FORMS}
    assert set(before) >= {f"pq_scan_tiled_kernel[{f}]" for f in tpq.K1_FORMS}
    args, q = _k3_inputs(3, "clustered", qt=8, m=64, b=8, s=3)
    tpq.pq_scan_topk_kernel(*args, query_tile=q, fetch=20)
    assert tpq.launch_counts(forms=True) == before
    replay = {"pq_scan_topk_kernel": 3, "pq_scan_topk_kernel[k256]": 2,
              "pq_scan_topk_kernel[GS]": 1, "pq_scan_tiled_kernel": 2,
              "pq_scan_tiled_kernel[k256]": 2}
    tpq.add_launch_counts(replay)
    tpq.add_launch_counts(replay)
    after = tpq.launch_counts(forms=True)
    for name, n in replay.items():
        assert after[name] == 2 * n
    assert after["pq_scan_topk_kernel[shared]"] == 0
    tpq.add_launch_counts({k: -n for k, n in replay.items()})
    tpq.add_launch_counts({k: -n for k, n in replay.items()})
    assert tpq.launch_counts(forms=True) == before
    tpq.reset_launch_counts()
