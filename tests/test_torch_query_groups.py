"""Query groups and K1's grid split, on the CPU.

On the card a query tile whose tables (K1) or selection state (K3) do
not fit in a CTA's shared memory is scanned in ``query_groups``, one
launch per group, and K1 cuts a tile's scan positions into
``scan_splits`` ranges.  Both helpers are pure and tested directly.
The split rests on one property of the functions: every output row
depends only on its own query's rows and the tile's list.  Here the
plain versions run group by group, on the rows each launch takes, and
the result equals the whole plain K1 / K3 bitwise and the Pallas
kernels in interpret mode at rtol=atol=1e-5 (K3 on integer LUTs, where
every sum is exact, so its positions, ids and DCO compare bitwise).
On the CPU the wrappers run the whole tile through the plain version,
at any size.  The CUDA kernels, query groups included, are held
against the plain versions on the card by chip_smoke.py, which runs
these shapes too.
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


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("qt,per_query,fixed,max_group", [
    (1, 4096, 0, 0), (8, 4096, 4 * 1024, 0), (64, 4096, 4 * 278, 0),
    (8, 65536, 4 * 40, 0), (64, 7208, 0, 64), (100, 1, 0, 64),
    (7, 1000, 0, 3), (13, 20000, 50000, 0)])
def test_query_groups_cover_the_tile(qt, per_query, fixed, max_group):
    groups = tpq.query_groups(qt, per_query, fixed, max_group=max_group)
    assert groups[0][0] == 0 and groups[-1][1] == qt
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    sizes = [q1 - q0 for q0, q1 in groups]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert all(fixed + n * per_query <= tpq.SMEM_LIMIT for n in sizes)
    fit = (tpq.SMEM_LIMIT - fixed) // per_query
    if max_group:
        assert max(sizes) <= max_group
        fit = min(fit, max_group)
    assert len(groups) == -(-qt // fit)            # as few as can be


def test_query_groups_at_the_shapes_that_need_them():
    """Clustered query_tile=64 at PQ64x4 and any nbits=8 tile of 8."""
    assert tpq.query_groups(64, 4 * 64 * 16, 4 * 1024) == [(0, 32), (32, 64)]
    assert tpq.query_groups(8, 4 * 64 * 256, 4 * 1024) == [(0, 2), (2, 5),
                                                           (5, 8)]
    assert tpq.query_groups(8, 4 * 64 * 16, 4 * 1024) == [(0, 8)]
    # K3's state for one query at M 64, K 16, fetch 100, BLK 32: 7208 B
    assert tpq.query_groups(64, 7208, max_group=64) == [(0, 32), (32, 64)]


def test_one_query_above_shared_memory_raises():
    """One query's 256 KB of tables no longer raises: the tables stay in
    global memory (the kernels' global-table form) and the tile is one
    group; only a query whose state without its tables passes the limit
    raises.  The plain version on the CPU answers the same shape."""
    groups = tpq.query_groups(1, 4 * 256 * 256, 0)
    assert groups == [(0, 1)] and groups.global_tables
    with pytest.raises(ValueError, match="besides its tables"):
        tpq.query_groups(1, 4 * 256 * 256 + tpq.SMEM_LIMIT + 1, 0,
                         table_bytes=4 * 256 * 256)
    lut, codes, tiles = _k1_inputs(3, 2, 256, 256, 3, 32, 2, 1)
    got = tpq.pq_scan_tiled_kernel(t(lut), t(codes), t(tiles), query_tile=1)
    np.testing.assert_array_equal(got.numpy(), tref.pq_scan_tiled_ref(
        t(lut), t(codes), t(tiles), query_tile=1).numpy())


def _k1_smem(m, k, s_per):
    """pq_scan.cu's pq_scan_tiled_smem_bytes, written out: the tables, or
    (global tables: the staged form) two range buffers, of 16 tables of
    256 floats for one query, of 8 x 8 for more."""
    def smem(n, g):
        staged = 0 if n < 1 else 2 * 4 * 256 * (16 if n == 1 else 64)
        return (staged if g else 4 * n * m * k) + 4 * s_per
    return smem


def _k3_smem(m, k, fw, blk):
    """pq_scan_topk.cu's pq_scan_topk_smem_bytes, written out."""
    p = max(1, tpq.TOPK_THREADS // blk)
    return lambda n, g: 4 * ((0 if g else n * m * k) + 6 * n * fw + n
                             + n * p + n)


@pytest.mark.parametrize("qt", [1, 8, 64, 100])
def test_global_tables_chosen_at_m256_nbits8(qt):
    """m_pq=256 at nbits=8 (gist-shaped, dsub=1): 256 KB of tables per
    query.  K1 and K3 take the global-table form from the shape alone,
    without raising: K1 stages the tables in ranges, in groups of at most
    K1_STAGED_QUERIES (the sums it carries in registers), K3 in groups
    of at most 64 sized by its selection state alone."""
    k1 = tpq.k1_groups(qt, _k1_smem(256, 256, 1024))
    assert k1.global_tables
    assert len(k1) == -(-qt // tpq.K1_STAGED_QUERIES)
    assert k1[0][0] == 0 and k1[-1][1] == qt
    assert k1.largest <= tpq.K1_STAGED_QUERIES
    k3 = tpq._library_groups(qt, _k3_smem(256, 256, 128, 32),
                             max_group=tpq.MAX_QUERY_TILE)
    assert k3.global_tables
    assert len(k3) == -(-qt // tpq.MAX_QUERY_TILE)
    assert k3[0][0] == 0 and k3[-1][1] == qt
    # the tables of a group of 8 in shared memory would need 2 MB
    assert 4 * 8 * 256 * 256 > tpq.SMEM_LIMIT


@pytest.mark.parametrize("m,k,qt,groups", [
    (64, 16, 8, [(0, 8)]), (64, 16, 64, [(0, 32), (32, 64)]),
    (64, 256, 8, [(0, 2), (2, 5), (5, 8)])])
def test_tables_stay_in_shared_memory_where_one_query_fits(m, k, qt, groups):
    """Shapes where one query's tables fit keep the shared-memory form
    and its query groups (the main path, query_tile=64, nbits=8 at
    M=64)."""
    k1 = tpq.k1_groups(qt, _k1_smem(m, k, 1024))
    assert k1 == groups and not k1.global_tables
    k3 = tpq._library_groups(qt, _k3_smem(m, k, 128, 32),
                             max_group=tpq.MAX_QUERY_TILE)
    assert not k3.global_tables


@pytest.mark.parametrize("t_,s,blk", [
    (1024, 556, 32), (128, 4448, 32), (8, 35584, 32), (1, 0, 32),
    (1, 1, 32), (2, 1000, 32), (16, 1000, 128), (3, 97, 24),
    (1, 200000, 32), (1000, 5000, 1)])
def test_scan_splits_cover_s_exactly(t_, s, blk):
    splits, s_per = tpq.scan_splits(t_, s, blk)
    assert 1 <= splits <= 65535 and 1 <= s_per <= tpq.K1_MAX_POSITIONS
    ranges = [(y * s_per, min(s, (y + 1) * s_per)) for y in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if s:
        assert all(hi > lo for lo, hi in ranges)
    if splits > max(1, -(-s // tpq.K1_MAX_POSITIONS)):  # for the grid
        assert s_per * blk >= tpq._K1_MIN_ITEMS
        assert t_ * (splits - 1) < tpq._K1_TARGET_CTAS


def test_scan_splits_at_the_main_path_shapes():
    """Paged B=1024: 2 splits (2048 CTAs); clustered 9 (1152); grouped
    132 (1056)."""
    assert tpq.scan_splits(1024, 556, 32) == (2, 278)
    assert tpq.scan_splits(128, 4448, 32) == (9, 495)
    assert tpq.scan_splits(8, 35584, 32) == (132, 270)


def _k1_inputs(seed, b, m, k, tb, blk, s, qt):
    rng = np.random.default_rng(seed)
    lut = rng.standard_normal((b, m, k)).astype(np.float32)
    codes = rng.integers(0, k, (tb, blk, m)).astype(np.uint8)
    tiles = rng.integers(0, tb, (b // qt, s)).astype(np.int32)
    return lut, codes, tiles


def _in_groups(fn, groups, qt, b, rows, *args, **kw):
    """``fn`` once per query group on rows ``tile * qt + [q0, q1)`` of
    each per-query input (the positions ``rows`` of ``args``), at
    query_tile ``q1 - q0``, its outputs put back in those rows: what the
    card's launches of a query-group split compute."""
    out = None
    for q0, q1 in groups:
        idx = (torch.arange(0, b, qt)[:, None]
               + torch.arange(q0, q1)[None, :]).reshape(-1)
        sub = [x[idx] if i in rows else x for i, x in enumerate(args)]
        got = fn(*sub, **dict(kw, query_tile=q1 - q0))
        got = got if isinstance(got, tuple) else (got,)
        if out is None:
            out = tuple(torch.empty((b, *y.shape[1:]), dtype=y.dtype)
                        for y in got)
        for x, y in zip(out, got):
            x[idx] = y
    return out


@pytest.mark.parametrize("qt,m,k", [(8, 64, 256), (64, 64, 16)])
def test_k1_query_groups_match_whole_plain_and_pallas(qt, m, k):
    lut, codes, tiles = _k1_inputs(qt + k, 2 * qt, m, k, 10, 32, 3, qt)
    _, s_per = tpq.scan_splits(2, 3, 32)
    # K1's shared memory: each query's tables, and the staged positions
    groups = tpq.query_groups(qt, 4 * m * k, 4 * s_per)
    assert len(groups) > 1
    got, = _in_groups(tref.pq_scan_tiled_ref, groups, qt, 2 * qt, (0,),
                      t(lut), t(codes), t(tiles))
    whole = tref.pq_scan_tiled_ref(t(lut), t(codes), t(tiles), query_tile=qt)
    np.testing.assert_array_equal(got.numpy(), whole.numpy())
    want = jpq.pq_scan_tiled_kernel(jnp.asarray(lut), jnp.asarray(codes),
                                    jnp.asarray(tiles), query_tile=qt,
                                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k", [4, 256])
@pytest.mark.parametrize("qt", [1, 8])
def test_plain_k1_matches_pallas_at_k(k, qt):
    """K beside the 16 of tests/test_torch_kernels.py's SWEEP: 2-bit and
    8-bit codes."""
    lut, codes, tiles = _k1_inputs(k + qt, 2 * qt, 16, k, 9, 32, 4, qt)
    want = jpq.pq_scan_tiled_kernel(jnp.asarray(lut), jnp.asarray(codes),
                                    jnp.asarray(tiles), query_tile=qt,
                                    interpret=True)
    got = tref.pq_scan_tiled_ref(t(lut), t(codes), t(tiles), query_tile=qt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _k3_inputs(seed, mode, *, qt, m, k, b, s=4, tb=20, blk=32, nlist=10,
               nid=300):
    """K3's inputs in ``mode`` (as fused_scan_args makes them) from a
    numpy plan with integer LUTs, duplicate ids, invalid items,
    co-assignments and a dead tile."""
    rng = np.random.default_rng(seed)
    lut = rng.integers(0, 3, (b, m, k)).astype(np.float32)
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
    assert q == qt
    return (lut_x.contiguous(), store.block_codes, store.block_ids,
            store.block_other, tiles.contiguous(), rank_x.contiguous(),
            slot_of, rank_u, dead)


@pytest.mark.parametrize("mode", ["grouped", "clustered"])
@pytest.mark.parametrize("qt,m,k,b", [(8, 64, 256, 16), (64, 64, 16, 64)])
def test_k3_query_groups_match_whole_plain_and_pallas(mode, qt, m, k, b):
    args = _k3_inputs(qt + k, mode, qt=qt, m=m, k=k, b=b)
    kw = dict(query_tile=qt, fetch=40)
    # K3's state for one query (pq_scan_topk_smem_bytes): tables, six
    # FW-wide selection arrays, a count, the round's plan slots and DCO
    fw = tpq.topk_width(40)
    per = 4 * (m * k + 6 * fw + 1 + tpq.TOPK_THREADS // 32 + 1)
    groups = tpq.query_groups(qt, per, max_group=tpq.MAX_QUERY_TILE)
    assert len(groups) > 1
    # per-query inputs: lut, rank_of, slot_of, rank_u
    got = _in_groups(tref.pq_scan_topk_ref, groups, qt, args[0].shape[0],
                     (0, 5, 6, 7), *args, fetch=40)
    whole = tref.pq_scan_topk_ref(*args, **kw)
    for name, g, w in zip(("acc_d", "acc_pos", "acc_id", "dco"), got, whole):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    want = jpq.pq_scan_topk_kernel(*(jnp.asarray(x.numpy()) for x in args),
                                   interpret=True, **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for name, g, w in zip(("acc_pos", "acc_id", "dco"), got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (got[1] < PAD_POS).any()              # something was kept


# ---------------------------------------------------------------------------
# K3's candidate-row form (fetch above 8192)
# ---------------------------------------------------------------------------
def _k3_smem_gs(m, k, fw, blk):
    """pq_scan_topk.cu's pq_scan_topk_smem_bytes with its global-state
    flag, written out: tables, six FW-wide selection arrays and a queue
    fill (none in the candidate-row form), the round's plan slots and
    DCO."""
    p = max(1, tpq.TOPK_THREADS // blk)
    return lambda n, g, gs=0: 4 * ((0 if g else n * m * k)
                                   + (0 if gs else 6 * n * fw + n) + n * p
                                   + n)


@pytest.mark.parametrize("m,k,fw,qt,tables,state,groups", [
    # fetch 16,000 (FW 16384) on PQ64x4, pq4 (M 16) and binary (M 32)
    # planes: 393 KB of state per query, tables back in shared memory
    (64, 16, 16384, 8, False, True, [(0, 8)]),
    (16, 16, 16384, 8, False, True, [(0, 8)]),
    (32, 16, 16384, 1, False, True, [(0, 1)]),
    (64, 16, 16384, 64, False, True, [(0, 32), (32, 64)]),
    # both moved: 256 KB of tables and 393 KB of state per query
    (256, 256, 16384, 8, True, True, [(0, 8)]),
    # FW 8192: one query's state (196 KB) still fits beside its tables
    (64, 16, 8192, 8, False, False, [(0, 1), (1, 2), (2, 3), (3, 4),
                                     (4, 5), (5, 6), (6, 7), (7, 8)]),
    # the main path and the gist index keep their PR 14 forms
    (64, 16, 128, 8, False, False, [(0, 8)]),
    (256, 256, 128, 8, True, False, [(0, 8)])])
def test_k3_form_from_the_shape(m, k, fw, qt, tables, state, groups):
    got = tpq._library_groups(qt, _k3_smem_gs(m, k, fw, 32),
                              max_group=tpq.MAX_QUERY_TILE,
                              movable_state=True)
    assert (got.global_tables, got.global_state) == (tables, state)
    assert got == groups and got.largest == max(b - a for a, b in groups)
    assert 4 * 6 * fw > tpq.SMEM_LIMIT or not state
    # what stays in shared memory fits
    smem = _k3_smem_gs(m, k, fw, 32)
    assert smem(got.largest, int(tables), int(state)) <= tpq.SMEM_LIMIT


def test_query_groups_moves_state_only_when_given():
    """Without ``state_bytes`` (K1, or a caller that cannot move it) a
    query whose rest does not fit still raises."""
    per = 4 * (64 * 16 + 6 * 16384 + 10)
    with pytest.raises(ValueError, match="besides its tables"):
        tpq.query_groups(8, per, table_bytes=4 * 64 * 16)
    g = tpq.query_groups(8, per, table_bytes=4 * 64 * 16,
                         state_bytes=4 * 6 * 16384)
    assert g == [(0, 8)] and g.global_state and not g.global_tables


def _wide_store_plan(seed, b=8, s=360, tb=400, blk=32, m=16, nlist=10,
                     nid=20000):
    """A plan of b queries over s of tb blocks with integer LUTs (every
    sum exact), 95% valid slots and few co-assigned items: more than
    8192 kept candidates per query."""
    rng = np.random.default_rng(seed)
    d = dict(
        lut=rng.integers(0, 3, (b, m, 16)).astype(np.float32),
        codes=rng.integers(0, 16, (tb, blk, m)).astype(np.uint8),
        ids=rng.integers(-1, nid, (tb, blk)).astype(np.int32),
        other=np.where(rng.random((tb, blk)) < 0.9, -1,
                       rng.integers(0, nlist, (tb, blk))).astype(np.int32),
        blocks=np.stack([rng.choice(tb, s, replace=False)
                         for _ in range(b)]).astype(np.int32),
        ranks=np.sort(rng.integers(0, nlist, (b, s)), 1).astype(np.int32),
        valid=rng.random((b, s)) < 0.95,
        rank_of=rng.integers(0, nlist, (b, nlist)).astype(np.int32),
        sel=np.sort(rng.choice(nlist, (b, 3)), 1).astype(np.int32))
    return d


@pytest.mark.parametrize("mode", ["paged", "grouped", "clustered"])
def test_plain_k3_and_merge_above_fetch_8192(mode):
    """At fetch 9000 (FW 16384: the candidate-row form on the card) the
    port's fused scan, through the plain K3, equals the reference's
    non-kernel path (unfused scan, then the stable top-fetch) bitwise:
    integer LUTs make every sum exact.  And the plain merge of the
    plain K3's split ranges equals the whole."""
    from repro.core import engine as jeng
    d = _wide_store_plan(90)
    b = d["lut"].shape[0]
    fetch = 9000
    assert tpq.topk_width(fetch) == 16384
    jstore = jeng.BlockStore(*(jnp.asarray(d[k])
                               for k in ("codes", "ids", "other")))
    jplan = jeng.QueryPlan(jnp.asarray(d["blocks"]), jnp.asarray(d["ranks"]),
                           jnp.asarray(d["valid"]), jnp.zeros(b, jnp.int32))
    tstore = teng.BlockStore(*(t(d[k]) for k in ("codes", "ids", "other")))
    tplan = teng.QueryPlan(t(d["blocks"]), t(d["ranks"]), t(d["valid"]),
                           torch.zeros(b, dtype=torch.int32))
    kw = dict(fetch=fetch, exec_mode=mode, query_tile=4)
    want = jeng.scan_blocks_topk(jstore, jplan, jnp.asarray(d["lut"]),
                                 jnp.asarray(d["rank_of"]), use_kernel=False,
                                 sel=jnp.asarray(d["sel"]), **kw)
    got = teng.scan_blocks_topk(tstore, tplan, t(d["lut"]), t(d["rank_of"]),
                                sel=t(d["sel"]), **kw)
    for f in ("flat_d", "flat_i", "approx_dco", "scanned_blocks"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.flat_d.shape == (b, fetch)
    assert bool(torch.isfinite(got.flat_d).all())    # > fetch kept
    # the merge: the plain top-fetch of three ranges of scan positions
    # (K3's splits), merged, is the top-fetch of the whole
    args = teng.fused_scan_args(tstore, tplan, t(d["lut"]), t(d["rank_of"]),
                                exec_mode=mode, query_tile=4, sel=t(d["sel"]))
    lut, tiles, rank_of, slot_of, rank_u, qt, _ = args
    common = (lut.contiguous(), tstore.block_codes, tstore.block_ids,
              tstore.block_other)
    whole = tref.pq_scan_topk_ref(*common, tiles.contiguous(),
                                  rank_of.contiguous(), slot_of, rank_u,
                                  query_tile=qt, fetch=fetch)
    s = tiles.shape[1]
    cuts = [0, s // 3, 2 * s // 3, s]
    parts = [tref.pq_scan_topk_ref(
        *common, tiles[:, a:c].contiguous(), rank_of.contiguous(),
        slot_of[:, a:c].contiguous(), rank_u[:, a:c].contiguous(),
        query_tile=qt, fetch=fetch) for a, c in zip(cuts, cuts[1:])]
    merged = tpq.merge_topk_kernel(*(torch.stack([p[i] for p in parts], 1)
                                     for i in range(3)))
    for name, x, y in zip(("acc_d", "acc_pos", "acc_id"), merged, whole):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)
