"""The port's engine stages against the JAX reference, fed identical inputs.

Integer outputs (lists, ranks, plans, unions, ids, counters) compare
bitwise; f32 distances at rtol=atol=1e-5.  Where a test wants bitwise
ids out of a float stage it feeds integer-valued data, so every sum is
exact in any order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.pq import PQCodebook as JPQ
from repro.core.pq import pq_lut as j_lut
from repro.core.pq import pq_lut_ip as j_lut_ip
from repro_torch.core import engine as teng
from repro_torch.core.pq import PQCodebook, pq_lut, pq_lut_ip

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_select_lists_bitwise(rairs_index, unit_data, metric):
    _, q, _ = unit_data
    c = np.asarray(rairs_index.centroids)
    want = jeng.select_lists(q[:64], jnp.asarray(c), nprobe=8, metric=metric)
    got = teng.select_lists(t(q[:64]), t(c), nprobe=8, metric=metric)
    eq(got.sel, want.sel, "sel")
    eq(got.rank_of, want.rank_of, "rank_of")


def test_rank_table_and_ties():
    """Equal centroid distances keep the lower list id first."""
    c = np.zeros((6, 4), np.float32)
    c[3] = 1.0
    q = np.zeros((2, 4), np.float32)
    want = jeng.select_lists(jnp.asarray(q), jnp.asarray(c), nprobe=4)
    got = teng.select_lists(t(q), t(c), nprobe=4)
    eq(got.sel, want.sel)
    eq(got.rank_of, want.rank_of)
    eq(teng.rank_table(t(np.array([[2, 0]], np.int32)), 4),
       jeng.rank_table(jnp.asarray([[2, 0]], jnp.int32), 4))


def _tables(arrays):
    j = jeng.tables_from_arrays(arrays)
    tt = teng.ListTables(*(t(np.asarray(x)) for x in j))
    return j, tt


@pytest.mark.parametrize("window", [False, True])
def test_plan_blocks_bitwise(rairs_index, unit_data, window):
    _, q, _ = unit_data
    sel = jeng.select_lists(q[:48], rairs_index.centroids, nprobe=12)
    jt, tt = _tables(rairs_index.arrays)
    tsel = teng.ListSelection(t(sel.sel), t(sel.rank_of))
    kw = dict(max_scan=40)
    if window:
        kw.update(local_lo=50, local_count=120)
    want = jeng.plan_blocks(jt, sel, **kw)
    got = teng.plan_blocks(tt, tsel, **kw)
    for f in want._fields:
        eq(getattr(got, f), getattr(want, f), f)
    cw, rw = jeng.gather_candidates(jt, sel)
    cg, rg = teng.gather_candidates(tt, tsel)
    eq(cg, cw)
    eq(rg, rw)
    # the derived owned_other directory matches the reference's
    eq(tt.owned_other, jt.owned_other)


def test_plan_budget_drops_bitwise():
    rng = np.random.default_rng(0)
    cand = np.where(rng.random((5, 30)) < 0.6,
                    rng.integers(0, 50, (5, 30)), -1).astype(np.int32)
    rank = rng.integers(0, 4, (5, 30)).astype(np.int32)
    want = jeng.compact_plan(jnp.asarray(cand), jnp.asarray(rank), 9)
    got = teng.compact_plan(t(cand), t(rank), 9)
    for f in want._fields:
        eq(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_luts(rairs_index, unit_data, metric):
    _, q, _ = unit_data
    cb = np.asarray(rairs_index.codebook.codebooks)
    jf, tf = (j_lut, pq_lut) if metric == "l2" else (j_lut_ip, pq_lut_ip)
    want = jf(JPQ(jnp.asarray(cb)), q[:16])
    got = tf(PQCodebook(t(cb)), t(q[:16]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cluster_order_and_unions_bitwise():
    rng = np.random.default_rng(1)
    sel = rng.integers(0, 5, (16, 6)).astype(np.int32)     # many equal prefixes
    eq(teng.cluster_order(t(sel)), jeng.cluster_order(jnp.asarray(sel)))
    blocks = rng.integers(0, 40, (16, 7)).astype(np.int32)
    valid = rng.random((16, 7)) < 0.8
    for b, s, tb, mode, qt in [(16, 7, 40, "grouped", 8),
                               (16, 7, 40, "clustered", 4),
                               (16, 7, 30, "clustered", 6)]:
        assert teng.union_dims(b, s, tb, mode, qt) == \
            jeng.union_dims(b, s, tb, mode, qt)
        n_tiles, w = jeng.union_dims(b, s, tb, mode, qt)
        eq(teng.tile_unions(t(blocks), t(valid), n_tiles, w),
           jeng.tile_unions(jnp.asarray(blocks), jnp.asarray(valid),
                            n_tiles, w))
    assert [teng.fit_tile(12, q) for q in (1, 5, 8, 16)] == \
        [jeng.fit_tile(12, q) for q in (1, 5, 8, 16)]


def test_plan_slot_maps_bitwise():
    rng = np.random.default_rng(2)
    b, s, tb = 8, 5, 30
    blocks = np.stack([rng.choice(tb, s, replace=False)
                       for _ in range(b)]).astype(np.int32)
    ranks = rng.integers(0, 9, (b, s)).astype(np.int32)
    valid = rng.random((b, s)) < 0.8
    unions = jeng.tile_unions(jnp.asarray(blocks), jnp.asarray(valid), 2,
                              min(4 * s, tb))
    want = jeng.plan_slot_maps(jnp.asarray(blocks), jnp.asarray(ranks),
                               jnp.asarray(valid), unions)
    got = teng.plan_slot_maps(t(blocks), t(ranks), t(valid),
                              t(np.asarray(unions)))
    for g, w in zip(got, want):
        eq(g, w)


def _store_plan(seed, tie_heavy):
    rng = np.random.default_rng(seed)
    b, s, tb, blk, m, nlist, nid = 8, 6, 14, 32, 8, 10, 300
    d = dict(
        lut=(rng.integers(0, 3, (b, m, 16)) if tie_heavy
             else rng.standard_normal((b, m, 16))).astype(np.float32),
        codes=rng.integers(0, 16, (tb, blk, m)).astype(np.uint8),
        ids=rng.integers(-1, nid, (tb, blk)).astype(np.int32),
        other=rng.integers(-1, nlist, (tb, blk)).astype(np.int32),
        blocks=np.stack([rng.choice(tb, s, replace=False)
                         for _ in range(b)]).astype(np.int32),
        ranks=np.sort(rng.integers(0, nlist, (b, s)), 1).astype(np.int32),
        valid=rng.random((b, s)) < 0.85,
        rank_of=np.where(rng.random((b, nlist)) < 0.5,
                         rng.integers(0, nlist, (b, nlist)),
                         2 ** 30).astype(np.int32),
        sel=np.sort(rng.choice(nlist, (b, 3)), 1).astype(np.int32))
    jstore = jeng.BlockStore(*(jnp.asarray(d[k])
                               for k in ("codes", "ids", "other")))
    jplan = jeng.QueryPlan(jnp.asarray(d["blocks"]), jnp.asarray(d["ranks"]),
                           jnp.asarray(d["valid"]), jnp.zeros(b, jnp.int32))
    tstore = teng.BlockStore(*(t(d[k]) for k in ("codes", "ids", "other")))
    tplan = teng.QueryPlan(t(d["blocks"]), t(d["ranks"]), t(d["valid"]),
                           torch.zeros(b, dtype=torch.int32))
    return d, jstore, jplan, tstore, tplan


@pytest.mark.parametrize("exec_mode", jeng.EXEC_MODES)
@pytest.mark.parametrize("tie_heavy", [False, True])
def test_scan_blocks(exec_mode, tie_heavy):
    d, js, jp, ts, tp = _store_plan(11, tie_heavy)
    want = jeng.scan_blocks(js, jp, jnp.asarray(d["lut"]),
                            jnp.asarray(d["rank_of"]), exec_mode=exec_mode,
                            query_tile=4, sel=jnp.asarray(d["sel"]))
    got = teng.scan_blocks(ts, tp, t(d["lut"]), t(d["rank_of"]),
                           exec_mode=exec_mode, query_tile=4, sel=t(d["sel"]))
    if tie_heavy:
        eq(got.flat_d, want.flat_d, "flat_d")
    else:
        np.testing.assert_allclose(got.flat_d.numpy(),
                                   np.asarray(want.flat_d), **TOL)
    for f in ("flat_i", "approx_dco", "scanned_blocks"):
        eq(getattr(got, f), getattr(want, f), f)


def _finalize_inputs(seed, metric):
    rng = np.random.default_rng(seed)
    b, w, n, dim = 6, 90, 50, 8
    vectors = rng.integers(-3, 4, (n, dim)).astype(np.float32)
    queries = rng.integers(-3, 4, (b, dim)).astype(np.float32)
    flat_d = rng.integers(0, 20, (b, w)).astype(np.float32)
    flat_d[rng.random((b, w)) < 0.2] = np.inf
    flat_i = rng.integers(-1, n, (b, w)).astype(np.int32)   # duplicate ids
    extra_d = rng.integers(0, 20, (b, 7)).astype(np.float32)
    extra_i = rng.integers(0, n + 5, (b, 7)).astype(np.int32)
    live = rng.random(n + 5) < 0.8
    return dict(flat_d=flat_d, flat_i=flat_i, vectors=vectors,
                queries=queries, extra_d=extra_d, extra_i=extra_i, live=live)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("hooks", [False, True])
def test_finalize_bitwise(metric, dedup, hooks):
    d = _finalize_inputs(7, metric)
    kw = dict(bigk=12, k=5, metric=metric, dedup_results=dedup, oversample=2)
    jkw, tkw = {}, {}
    if hooks:
        for name in ("extra_d", "extra_i", "live"):
            jkw[name] = jnp.asarray(d[name])
            tkw[name] = t(d[name])
    want = jeng.finalize_candidates(
        jnp.asarray(d["flat_d"]), jnp.asarray(d["flat_i"]),
        vectors=jnp.asarray(d["vectors"]), queries=jnp.asarray(d["queries"]),
        **kw, **jkw)
    got = teng.finalize_candidates(
        t(d["flat_d"]), t(d["flat_i"]), vectors=t(d["vectors"]),
        queries=t(d["queries"]), **kw, **tkw)
    for g, w, name in zip(got, want, ("ids", "dists", "refine_dco")):
        eq(g, w, name)


def test_preselect_stable_ties():
    d = _finalize_inputs(3, "l2")
    want = jeng.preselect_candidates(jnp.asarray(d["flat_d"]),
                                     jnp.asarray(d["flat_i"]), fetch=30)
    got = teng.preselect_candidates(t(d["flat_d"]), t(d["flat_i"]), fetch=30)
    for g, w in zip(got, want):
        eq(g, w)
