"""K3 split over ranges of scan positions, and its merge, on the CPU.

On the card K3 scans a tile's positions in ``topk_splits`` ranges, one
CTA each, and ``merge_topk_kernel`` merges the ranges' top-``fetch``
lists.  The CUDA kernels run only on the card (chip_smoke.py holds them
bitwise against the plain versions there).  These tests hold the plain
versions of that scheme: splitting S, taking the plain top-``fetch`` of
each range and merging with ``merge_topk_ref`` gives the unsplit
``pq_scan_topk_ref`` bitwise (which tests/test_torch_kernels.py holds
against the JAX reference); the merge equals a numpy lexsort and the
reference's bitonic ``merge_topf``; and ``topk_splits`` covers S.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import topk as jtopk
from repro_torch.core import engine as teng
from repro_torch.kernels import pq_scan as tpq
from repro_torch.kernels import ref as tref
from repro_torch.kernels.topk import PAD_POS


def t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, mode, *, b=16, s=24, tb=40, blk=32, m=8, k=16, nlist=10,
            nid=300, tie_heavy=True, qt=4):
    """K3's inputs in ``mode`` (as fused_scan_args makes them) from a
    numpy plan with duplicate ids, invalid items and co-assignments."""
    rng = np.random.default_rng(seed)
    lut = (rng.integers(0, 3, (b, m, k)) if tie_heavy
           else rng.standard_normal((b, m, k))).astype(np.float32)
    store = teng.BlockStore(
        t(rng.integers(0, k, (tb, blk, m)).astype(np.uint8)),
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
    return (lut_x, store.block_codes, store.block_ids, store.block_other,
            tiles.contiguous(), rank_x, slot_of, rank_u, dead), q


def _cuts(s, n, rng):
    """n ranges covering [0, s): uneven, with an empty one when n > 2."""
    inner = np.sort(rng.integers(0, s + 1, n - 1))
    if n > 2:
        inner[1] = inner[0]                     # an empty range
    return [0, *inner.tolist(), s]


@pytest.mark.parametrize("mode", teng.EXEC_MODES)
@pytest.mark.parametrize("n_splits", [1, 2, 3, 7])
@pytest.mark.parametrize("tie_heavy", [True, False])
def test_split_ranges_merge_to_unsplit_topk(mode, n_splits, tie_heavy):
    """Top-fetch of each range, merged, == the unsplit top-fetch, and the
    ranges' DCO counts sum to the unsplit DCO: bitwise."""
    args, qt = _inputs(3 + n_splits, mode, tie_heavy=tie_heavy)
    kw = dict(query_tile=qt, fetch=40)
    want = tref.pq_scan_topk_ref(*args, **kw)
    lut, codes, ids, other, tiles, rank_of, slot_of, rank_u, dead = args
    cuts = _cuts(tiles.shape[1], n_splits, np.random.default_rng(n_splits))
    parts = [tref.pq_scan_topk_ref(
        lut, codes, ids, other, tiles[:, lo:hi].contiguous(), rank_of,
        slot_of[:, lo:hi].contiguous(), rank_u[:, lo:hi].contiguous(), dead,
        **kw) for lo, hi in zip(cuts[:-1], cuts[1:])]
    got = tref.merge_topk_ref(*(torch.stack([p[i] for p in parts], dim=1)
                                for i in range(3)))
    for name, g, w in zip(("acc_d", "acc_pos", "acc_id"), got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    np.testing.assert_array_equal(sum(p[3] for p in parts).numpy(),
                                  want[3].numpy())
    assert (want[1] < PAD_POS).any()            # something was kept


def test_split_ranges_keep_fewer_than_fetch():
    """Ranges with fewer kept items than fetch merge their pads right."""
    args, qt = _inputs(11, "paged", s=6, tb=12)
    kw = dict(query_tile=qt, fetch=200)
    want = tref.pq_scan_topk_ref(*args, **kw)
    lut, codes, ids, other, tiles, rank_of, slot_of, rank_u, dead = args
    parts = [tref.pq_scan_topk_ref(
        lut, codes, ids, other, tiles[:, lo:lo + 2].contiguous(), rank_of,
        slot_of[:, lo:lo + 2].contiguous(), rank_u[:, lo:lo + 2].contiguous(),
        dead, **kw) for lo in (0, 2, 4)]
    assert all((p[1] == PAD_POS).any() for p in parts)
    got = tref.merge_topk_ref(*(torch.stack([p[i] for p in parts], dim=1)
                                for i in range(3)))
    for g, w in zip(got, want[:3]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert (got[1][:, -1] == PAD_POS).all() and (got[2][:, -1] == -1).all()


def _sorted_lists(rng, b, splits, fetch, pad_frac=0.3, zeros=False):
    """(B, splits, fetch) triples, each list ascending by (d, pos) with
    pads last; integer distances (ties everywhere; with ``zeros`` -0.0
    beside +0.0), pos unique per row, a share ``pad_frac`` pads."""
    d = rng.integers(-1 if zeros else 0, 4,
                     (b, splits, fetch)).astype(np.float32)
    if zeros:
        d[(d == 0) & (rng.random(d.shape) < 0.5)] = -0.0
    pos = np.stack([rng.permutation(4 * splits * fetch)[:splits * fetch]
                    for _ in range(b)]).reshape(b, splits, fetch)
    idx = rng.integers(-1, 50, (b, splits, fetch))
    pad = rng.random((b, splits, fetch)) < pad_frac
    d[pad], pos[pad], idx[pad] = np.inf, PAD_POS, -1
    order = np.lexsort((pos, d), axis=-1)
    return [np.take_along_axis(x, order, -1).astype(dt) for x, dt in
            ((d, np.float32), (pos, np.int32), (idx, np.int32))]


@pytest.mark.parametrize("b,splits,fetch", [(1, 1, 1), (3, 2, 5),
                                            (2, 7, 100), (4, 66, 13)])
def test_merge_topk_ref_matches_lexsort(b, splits, fetch):
    d, p, i = _sorted_lists(np.random.default_rng(fetch), b, splits, fetch)
    got = tref.merge_topk_ref(t(d), t(p), t(i))
    flat = [x.reshape(b, -1) for x in (d, p, i)]
    order = np.lexsort((flat[1], flat[0]), axis=-1)[:, :fetch]
    for g, x in zip(got, flat):
        np.testing.assert_array_equal(g.numpy(),
                                      np.take_along_axis(x, order, -1))


@pytest.mark.parametrize("f", [16, 64, 128])
def test_merge_topk_ref_matches_reference_merge_topf(f):
    """Two lists: the port's merge == the reference's bitonic merge_topf
    (K4), the in-kernel accumulator update of the Pallas K3."""
    d, p, i = _sorted_lists(np.random.default_rng(100 + f), 3, 2, f)
    want = jtopk.merge_topf([jnp.asarray(x[:, 0]) for x in (d, p, i)],
                            [jnp.asarray(x[:, 1]) for x in (d, p, i)])
    got = tref.merge_topk_ref(t(d), t(p), t(i))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _reference_fold(d, p, i):
    """The reference's merge: merge_topf (K4's bitonic accumulator
    update) folded over the lists, each padded to a power-of-two width
    first (its network's width)."""
    b, splits, fetch = d.shape
    f = jtopk.pow2_ceil(fetch)
    pads = ((0, 0), (0, 0), (0, f - fetch))
    lists = [jnp.asarray(np.pad(x, pads, constant_values=c))
             for x, c in ((d, np.inf), (p, PAD_POS), (i, -1))]
    merge = jax.jit(jtopk.merge_topf)
    acc = [x[:, 0] for x in lists]
    for s in range(1, splits):
        acc = merge(acc, [x[:, s] for x in lists])
    return [np.asarray(x)[:, :fetch] for x in acc]


def _merge_key(d, pos):
    """topk_merge's 64-bit key (csrc/pq_scan_topk.cu::merge_key): the
    f32 bits made monotone, -0.0 as +0.0, above pos."""
    u = np.ascontiguousarray(d, np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    u = np.where(u >> 31, ~u, u | np.uint32(0x80000000)).astype(np.uint64)
    return (u << np.uint64(32)) | pos.astype(np.uint32).astype(np.uint64)


def _counting_merge(d, p, i):
    """A numpy model of the CUDA merge (topk_merge).  Up to six lists each
    real entry is placed at its index plus the keys below it in the other
    lists.  Beyond, the fetch-th key T of the union is fixed four bits a
    round by counting the keys below 15 candidates (done early when the
    first candidate rejected has exactly fetch keys below it), the
    survivors (the keys below the end of the search) are taken in list
    order and each is placed by counting the survivors below it.  Pads
    after the real entries."""
    b, splits, fetch = d.shape
    keys = _merge_key(d, p).reshape(b, -1)
    pad = _merge_key(np.float32([np.inf]), np.int32([PAD_POS]))[0]
    out = [np.full((b, fetch), c, x.dtype)
           for x, c in ((d, np.inf), (p, PAD_POS), (i, -1))]
    if splits <= 6:         # MERGE_DIRECT: each real entry placed directly
        lists = keys.reshape(b, splits, fetch)
        for r in range(b):
            real = np.flatnonzero(keys[r] != pad)
            # own index + the keys below in the others: the keys below in
            # every list (a list's own keys below an entry are its index)
            at = sum(np.searchsorted(lists[r, o], keys[r, real])
                     for o in range(splits))
            keep = at < fetch
            for o, x in zip(out, (d, p, i)):
                o[r, at[keep]] = x[r].reshape(-1)[real[keep]]
        return out
    v = np.zeros(b, np.uint64)
    end = np.zeros(b, np.uint64)                 # 0: still searching
    for shift in range(60, -1, -4):
        cands = v[:, None] | (np.arange(1, 16, dtype=np.uint64)
                              << np.uint64(shift))[None, :]
        below = (keys[:, None, :] < cands[:, :, None]).sum(axis=2)
        j = (below < fetch).sum(axis=1)          # accepted: a prefix
        assert ((below < fetch) == (np.arange(15) < j[:, None])).all()
        exact = (j < 15) & (below[np.arange(b), np.minimum(j, 14)] == fetch)
        done = exact & (end == 0)
        end[done] = cands[done, j[done]]
        v |= j.astype(np.uint64) << np.uint64(shift)
    rest = end == 0
    end[rest] = np.where(v[rest] == pad, pad, v[rest] + np.uint64(1))
    for r in range(b):
        surv = np.flatnonzero(keys[r] < end[r])
        assert len(surv) <= fetch
        rank = (keys[r][surv][None, :] < keys[r][surv][:, None]).sum(axis=1)
        assert sorted(rank.tolist()) == list(range(len(surv)))
        for o, x in zip(out, (d, p, i)):
            o[r, rank] = x[r].reshape(-1)[surv]
    return out


@pytest.mark.parametrize("b,splits,fetch,pad_frac", [
    (64, 66, 400, 0.3), (64, 66, 400, 0.7), (64, 66, 100, 0.7),
    (64, 99, 100, 0.3), (1024, 5, 400, 0.3), (1024, 5, 400, 0.9),
    (1024, 2, 400, 0.3), (1024, 3, 100, 0.6), (5, 3, 200, 1.0)])
def test_merge_at_the_path_shapes(b, splits, fetch, pad_frac):
    """The merge at K3's grouped (66 or 99 lists) and clustered (2 to 5
    lists) shapes, tie-heavy, -0.0 beside +0.0, with 30% pads or with fewer real
    entries in each list than fetch: the wrapper on the CPU, the plain
    version, a numpy lexsort, the reference's merge_topf folded over the
    lists, and a model of the CUDA kernel's counting scheme agree."""
    d, p, i = _sorted_lists(np.random.default_rng(splits * fetch + b), b,
                            splits, fetch, pad_frac, zeros=True)
    got = tpq.merge_topk_kernel(t(d), t(p), t(i))
    want = tref.merge_topk_ref(t(d), t(p), t(i))
    flat = [x.reshape(b, -1) for x in (d, p, i)]
    order = np.lexsort((flat[1], flat[0]), axis=-1)[:, :fetch]
    fold = _reference_fold(d, p, i)
    model = _counting_merge(d, p, i)
    for name, g, w, x, f, m in zip(("acc_d", "acc_pos", "acc_id"), got,
                                   want, flat, fold, model):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
        np.testing.assert_array_equal(g.numpy(),
                                      np.take_along_axis(x, order, -1),
                                      err_msg=name)
        np.testing.assert_array_equal(g.numpy(), f, err_msg=name)
        np.testing.assert_array_equal(g.numpy(), m, err_msg=name)
    np.testing.assert_array_equal(np.signbit(got[0].numpy()),
                                  np.signbit(model[0]))
    if pad_frac > 0.5:       # some list held fewer real entries than fetch
        assert ((p < PAD_POS).sum(axis=-1) < fetch).all()


def test_merge_wrapper_on_cpu_is_the_plain_version():
    d, p, i = _sorted_lists(np.random.default_rng(5), 2, 3, 9)
    before = tpq.launch_counts()
    got = tpq.merge_topk_kernel(t(d), t(p), t(i))
    want = tref.merge_topk_ref(t(d), t(p), t(i))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tpq.launch_counts() == before


@pytest.mark.parametrize("t_,s,blk", [
    (1024, 556, 32), (128, 4448, 32), (8, 35584, 32), (1, 0, 32),
    (1, 1, 32), (4, 300, 32), (16, 300, 32), (2, 1000, 128), (3, 97, 8),
    (1, 10 ** 6, 1)])
def test_topk_splits_cover_s_exactly(t_, s, blk):
    # targets k3_wave_splits passes on the H100: one or two waves of 2, 3
    # or 6 CTAs a SM
    for target in (264, 396, 528, 792, 1584):
        splits, s_per = tpq.topk_splits(t_, s, blk, target)
        assert (splits, s_per) == tpq.topk_splits(t_, s, blk, target)
        assert 1 <= splits <= 65535 and s_per >= 1
        ranges = [(y * s_per, min(s, (y + 1) * s_per))
                  for y in range(splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == s
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        if s:
            assert all(hi > lo for lo, hi in ranges)
        if splits > 1:       # at least a few rounds of items per split
            per_round = max(1, tpq.TOPK_THREADS // blk)
            assert s_per >= 4 * per_round
            assert t_ * splits <= target


@pytest.mark.parametrize("target", [264, 396, 528, 792, 1056, 2112])
@pytest.mark.parametrize("t_,s", [(1024, 556), (128, 4448), (125, 1088),
                                  (8, 35584), (8, 2679), (3, 97), (1, 0)])
def test_topk_splits_cover_s_at_each_target(target, t_, s):
    """At the targets k3_wave_splits passes (one or two waves of 2 to 8
    CTAs a SM on 132 SMs) the ranges still cover [0, S) exactly, none is
    empty, and the CTAs stay within the target unless one split each
    already passes it."""
    splits, s_per = tpq.topk_splits(t_, s, 32, target)
    ranges = [(y * s_per, min(s, (y + 1) * s_per)) for y in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if s:
        assert all(hi > lo for lo, hi in ranges)
    assert t_ * splits <= max(target, t_)


def test_k3_wave_splits_picks_one_or_two_waves(monkeypatch):
    """One full wave of the CTAs the card holds (here 3 a SM), two where
    one wave cuts a tile 8 ways or more (grouped), one split where the
    tiles alone fill the card (paged)."""
    class Lib:
        @staticmethod
        def pq_scan_topk_smem_bytes(m, k, n, fw, blk, gt, gs):
            return 60000
    monkeypatch.setattr(tpq.build, "load", lambda stem: Lib)
    monkeypatch.setattr(tpq, "_k3_ctas", lambda *a: 3 * 132)
    groups = tpq.QueryGroups([(0, 8)])

    def splits(t_, s):
        return tpq.k3_wave_splits(groups, t_, s, 64, 16, 128, 32, False,
                                  "cuda:0")[0]
    assert splits(1024, 556) == 1
    assert splits(128, 4448) == 3            # 396 // 128: one wave
    assert splits(8, 35584) == 99            # 49 a tile: two waves
    monkeypatch.setattr(tpq, "_k3_ctas", lambda *a: 2 * 132)  # fetch 400
    assert (splits(1024, 556), splits(128, 4448), splits(8, 35584)) == \
        (1, 2, 66)


def test_topk_splits_at_the_main_path_shapes():
    """Paged B=1024 keeps one split (no merge); clustered and grouped
    spread a tile's positions over the CTAs the card holds at once, at
    the targets ``k3_wave_splits`` passes on the H100's 132 SMs: 3 CTAs
    a SM at fetch 100, 2 at fetch 400, one wave clustered and two
    grouped.  These are the splits the path runs: 1 / 3 / 99 at fetch
    100, 1 / 2 / 66 at fetch 400."""
    for per_sm, want in ((3, (1, 3, 99)), (2, (1, 2, 66))):
        wave = per_sm * 132
        got = (tpq.topk_splits(1024, 556, 32, wave)[0],
               tpq.topk_splits(128, 4448, 32, wave)[0],
               tpq.topk_splits(8, 35584, 32, 2 * wave)[0])
        assert got == want
        for t_, splits, target in zip((1024, 128, 8), got,
                                      (wave, wave, 2 * wave)):
            assert t_ * splits <= max(target, t_)
    assert [tpq.topk_width(f) for f in (1, 32, 33, 100, 200)] == \
        [32, 32, 64, 128, 256]
