"""K3's candidate-row form and the row select, on the CPU.

Above fetch 8192 the card runs K3 as two launches: a scan that appends
every kept triple (d, pos, id) to its query's candidate row, and a row
select that takes the stable top-fetch of each row under (d, pos).  Here
their plain versions (``ref.scan_rows_ref``, ``ref.select_topk_ref``)
are held against the contract (``ref.pq_scan_topk_ref``) and against
the reference's non-kernel fused scan, bitwise (integer LUTs make every
sum exact and tie everywhere); the select alone against a numpy lexsort
(with -0.0 and +0.0 ties) and against the reference's ``merge_topf``;
and the shape rules of the form.  On the CPU the wrappers are the plain
versions.  The CUDA kernels are held against these plain versions on
the card by chip_smoke.py, at the same shapes and larger.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.kernels.topk import merge_topf as j_merge_topf
from repro_torch.core import engine as teng
from repro_torch.kernels import pq_scan as tpq
from repro_torch.kernels import ref as tref
from repro_torch.kernels.topk import PAD_POS


def t(a):
    return torch.from_numpy(np.array(a))


def _wide(seed, b=8, s=360, tb=400, blk=32, m=16, nlist=10, nid=20000):
    """A plan of b queries over s of tb blocks with integer LUTs (every
    sum exact, ties everywhere), 95% valid slots and few co-assigned
    items: more than 8192 kept candidates per query."""
    rng = np.random.default_rng(seed)
    return dict(
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


@pytest.fixture(scope="module")
def wide():
    return _wide(90)


def _k3_args(d, mode):
    store = teng.BlockStore(*(t(d[k]) for k in ("codes", "ids", "other")))
    plan = teng.QueryPlan(t(d["blocks"]), t(d["ranks"]), t(d["valid"]),
                          torch.zeros(d["lut"].shape[0], dtype=torch.int32))
    lut, tiles, rank_of, slot_of, rank_u, qt, inv = teng.fused_scan_args(
        store, plan, t(d["lut"]), t(d["rank_of"]), exec_mode=mode,
        query_tile=4, sel=t(d["sel"]))
    args = (lut.contiguous(), store.block_codes, store.block_ids,
            store.block_other, tiles.contiguous(), rank_of.contiguous(),
            slot_of, rank_u)
    return args, qt, store, plan, inv


# fetch 9000 and 16000 (FW 16384: the candidate-row form on the card), and
# the whole plan width (360 slots x 32 lanes)
@pytest.mark.parametrize("fetch", [9000, 16000, 360 * 32])
@pytest.mark.parametrize("mode", ["paged", "grouped", "clustered"])
def test_rows_then_select_equal_the_contract(wide, mode, fetch):
    d = wide
    args, qt, store, plan, inv = _k3_args(d, mode)
    pw = d["blocks"].shape[1]
    rows = tref.scan_rows_ref(*args, query_tile=qt, plan_width=pw)
    row_d, row_pos, row_id, row_n, dco = rows
    assert row_d.shape == (d["lut"].shape[0], pw * 32)
    # canonical rows: the kept triples in ascending pos, then pads
    kept = torch.arange(row_d.shape[1]) < row_n[:, None].long()
    assert bool((row_pos[kept] < PAD_POS).all())
    assert bool((row_pos[~kept] == PAD_POS).all())
    assert bool((row_id[~kept] == -1).all())
    assert bool((row_pos[:, 1:] >= row_pos[:, :-1]).all())
    got = tref.select_topk_ref(row_d, row_pos, row_id, row_n, fetch=fetch)
    want = tref.pq_scan_topk_ref(*args, query_tile=qt, fetch=fetch)
    for name, x, y in zip(("acc_d", "acc_pos", "acc_id", "dco"),
                          got + (dco,), want):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)
    # the reference's non-kernel path: unfused scan, then a stable top-fetch
    jstore = jeng.BlockStore(*(jnp.asarray(d[k])
                               for k in ("codes", "ids", "other")))
    jplan = jeng.QueryPlan(jnp.asarray(d["blocks"]), jnp.asarray(d["ranks"]),
                           jnp.asarray(d["valid"]),
                           jnp.zeros(d["lut"].shape[0], jnp.int32))
    j = jeng.scan_blocks_topk(jstore, jplan, jnp.asarray(d["lut"]),
                              jnp.asarray(d["rank_of"]), fetch=fetch,
                              exec_mode=mode, query_tile=4, use_kernel=False,
                              sel=jnp.asarray(d["sel"]))
    fused = teng.scan_blocks_topk(store, plan, t(d["lut"]), t(d["rank_of"]),
                                  fetch=fetch, exec_mode=mode, query_tile=4,
                                  sel=t(d["sel"]))
    np.testing.assert_array_equal(fused.flat_d.numpy(), np.asarray(j.flat_d))
    np.testing.assert_array_equal(fused.flat_i.numpy(), np.asarray(j.flat_i))
    np.testing.assert_array_equal(fused.approx_dco.numpy(),
                                  np.asarray(j.approx_dco))
    # and the select over the rows is what the fused scan returns, in the
    # batch order (the scan clamps fetch to the plan width; pads past it)
    if inv is not None:
        got = tuple(x[inv] for x in got)
    w = fused.flat_d.shape[1]
    assert w == min(fetch, pw * 32)
    np.testing.assert_array_equal(got[0][:, :w].numpy(), fused.flat_d.numpy())
    np.testing.assert_array_equal(got[2][:, :w].numpy(), fused.flat_i.numpy())
    assert bool((got[1][:, w:] == PAD_POS).all())


def test_rows_keep_fewer_than_the_plan_width(wide):
    """A row is BLK times the plan width, whatever the launch's S (the
    union width in grouped and clustered mode), and never overflows: a
    query keeps at most one item per (plan slot, lane)."""
    for mode in ("paged", "grouped", "clustered"):
        args, qt, _, _, _ = _k3_args(wide, mode)
        s = args[4].shape[1]
        pw = wide["blocks"].shape[1]
        rows = tref.scan_rows_ref(*args, query_tile=qt, plan_width=pw)
        assert rows[0].shape[1] == tpq.row_width(s, 32, pw) == pw * 32
        assert int(rows[3].max()) <= pw * 32
        if mode != "paged":
            assert s > pw             # the union is wider than one plan


def _lexsort_top(d, p, i, fetch):
    """numpy: stable by (d, pos), -0.0 equal to +0.0, padded."""
    out = []
    for r in range(d.shape[0]):
        o = np.lexsort((p[r], d[r]))[:fetch]
        row = [d[r][o], p[r][o], i[r][o]]
        short = fetch - len(o)
        row = [np.concatenate([x, np.full(short, v, x.dtype)])
               for x, v in zip(row, (np.inf, PAD_POS, -1))]
        out.append(row)
    return [np.stack([o[k] for o in out]) for k in range(3)]


@pytest.mark.parametrize("b,w,fetch,fill", [
    (4, 300, 50, None), (4, 300, 300, None), (4, 300, 400, None),
    (3, 2000, 100, "part"), (3, 2000, 1500, "part"), (2, 64, 10, "empty")])
def test_select_matches_lexsort_with_signed_zeros(b, w, fetch, fill):
    """Tie-heavy rows with -0.0 and +0.0 at equal distances: ties go by
    pos, the two zeros are one value, and entries past the fill count as
    pads whatever they hold."""
    rng = np.random.default_rng(w + fetch)
    d = rng.integers(-2, 3, (b, w)).astype(np.float32)
    d[d == 0] = np.where(rng.random(int((d == 0).sum())) < 0.5, -0.0, 0.0)
    assert (np.signbit(d) & (d == 0)).any() and (~np.signbit(d) & (d == 0)).any()
    p = np.stack([rng.permutation(4 * w)[:w] for _ in range(b)]).astype(
        np.int32)
    i = rng.integers(0, 1000, (b, w)).astype(np.int32)
    n = None
    if fill == "part":
        n = rng.integers(w // 4, w, b).astype(np.int32)
    elif fill == "empty":
        n = np.zeros(b, np.int32)
    got = tref.select_topk_ref(t(d), t(p), t(i), None if n is None else t(n),
                               fetch=fetch)
    dn, pn, in_ = d.copy(), p.copy(), i.copy()
    if n is not None:
        past = np.arange(w)[None, :] >= n[:, None]
        dn[past], pn[past], in_[past] = np.inf, PAD_POS, -1
    want = _lexsort_top(dn, pn, in_, fetch)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), y)
    # the signs of the zeros come through as the rows hold them
    np.testing.assert_array_equal(np.signbit(got[0].numpy()),
                                  np.signbit(want[0]))


@pytest.mark.parametrize("fetch", [5, 40])
def test_select_signed_zeros_of_two_queries_order_alike(fetch):
    """Two queries whose rows hold the same positions and distances, the
    zeros of one -0.0 and of the other +0.0: both select the same
    positions in the same order (-0.0 equals +0.0, ties go by pos), and
    each keeps its own zeros' sign."""
    rng = np.random.default_rng(fetch)
    w = 64
    d = rng.integers(0, 3, w).astype(np.float32)
    d[d == 0] = -0.0
    p = rng.permutation(4 * w)[:w].astype(np.int32)
    rows_d = np.stack([d, np.abs(d)])
    assert np.signbit(rows_d[0]).any() and not np.signbit(rows_d[1]).any()
    got = tref.select_topk_ref(t(rows_d), t(np.stack([p, p])),
                               t(np.stack([p, p]) + 7), fetch=fetch)
    np.testing.assert_array_equal(got[1][0].numpy(), got[1][1].numpy())
    zeros = got[0][0].numpy() == 0
    assert zeros.any()
    assert np.signbit(got[0][0].numpy()[zeros]).all()
    assert not np.signbit(got[0][1].numpy()).any()
    want = _lexsort_top(rows_d, np.stack([p, p]), np.stack([p, p]) + 7,
                        fetch)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), y)


@pytest.mark.parametrize("b,splits,f", [(2, 2, 16), (3, 5, 32), (2, 3, 64)])
def test_select_over_split_lists_is_the_merge(b, splits, f):
    """The merge above fetch 8192 runs the row select over the (B,
    splits * F) concatenated lists: equal to merge_topk_ref and to the
    reference's merge_topf folded over the lists."""
    rng = np.random.default_rng(splits * f)
    n = splits * f
    d = rng.integers(0, 4, (b, n)).astype(np.float32)
    p = np.stack([rng.permutation(4 * n)[:n] for _ in range(b)]).astype(
        np.int32)
    i = rng.integers(-1, 50, (b, n)).astype(np.int32)
    pad = rng.random((b, n)) < 0.3
    d[pad], p[pad], i[pad] = np.inf, PAD_POS, -1
    lists = tref.merge_topk_ref(*(t(x).reshape(b * splits, 1, f)
                                  for x in (d, p, i)))
    parts = [x.reshape(b, splits, f).contiguous() for x in lists]
    got = tref.select_topk_ref(*(x.reshape(b, n) for x in parts), fetch=f)
    want = tref.merge_topk_ref(*parts)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    acc = [jnp.asarray(x[:, 0].numpy()) for x in parts]
    for s in range(1, splits):
        acc = j_merge_topf(acc, [jnp.asarray(x[:, s].numpy())
                                 for x in parts])
    for x, y in zip(got, acc):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    # the wrapper on the CPU is the plain version
    before = tpq.launch_counts()
    w = tpq.select_topk_kernel(*(x.reshape(b, n) for x in parts), fetch=f)
    assert tpq.launch_counts() == before
    for x, y in zip(w, got):
        assert torch.equal(x, y)


# the candidate-row form splits like the shared one, for the waves of its
# own occupancy (6 CTAs a SM on the H100's 132 SMs: one wave of 792 CTAs,
# two where one wave cuts a tile 8 ways or more); its scratch is the rows:
# 12 bytes an entry and a fill a row.  The ids keep the names these cases
# were first collected under.
@pytest.mark.parametrize("t_,qt,s,blk,pw,splits,rows_bytes", [
    (1024, 1, 556, 32, 556, 1, 1024 * (12 * 17792 + 4)),  # wide paged
    (128, 8, 4448, 32, 556, 6, 1024 * (12 * 17792 + 4)),  # wide clustered
    (8, 8, 35584, 32, 556, 198, 64 * (12 * 17792 + 4)),   # wide grouped
    (2, 4, 300, 32, 300, 9, 8 * (12 * 9600 + 4)),         # few tiles
    (8, 1, 400, 32, None, 12, 8 * (12 * 12800 + 4))],     # no plan width
    ids=["1024-1-556-32-556-1-218632192", "128-8-4448-32-556-5-218632192",
         "8-8-35584-32-556-66-13664512", "2-4-300-32-300-9-921632",
         "8-1-400-32-None-12-1228832"])
def test_row_form_splits_and_scratch_from_the_shape(monkeypatch, t_, qt, s,
                                                    blk, pw, splits,
                                                    rows_bytes):
    class Lib:
        @staticmethod
        def pq_scan_topk_smem_bytes(m, k, n, fw, blk, gt, gs):
            return 40000
    monkeypatch.setattr(tpq.build, "load", lambda stem: Lib)
    monkeypatch.setattr(tpq, "_k3_ctas", lambda *a: 6 * 132)
    groups = tpq.QueryGroups([(0, qt)], global_state=True)
    got, s_per = tpq.k3_wave_splits(groups, t_, s, 16, 16, 0, blk, True,
                                    "cuda:0")
    assert got == splits and splits == max(1, -(-s // s_per))
    assert t_ * qt * (12 * tpq.row_width(s, blk, pw) + 4) == rows_bytes
    assert tpq.row_width(s, blk, pw) == blk * min(s, pw or s)
    # the splits cap of the old global-state form is gone
    for name in ("k3_splits", "state_words", "STATE_BUDGET",
                 "merge_global_state"):
        assert not hasattr(tpq, name)


def test_wide_rows_are_the_plan_width():
    """At the wide two-tier shapes (plan width 556 slots of 32 lanes) the
    rows are 17,792 entries whatever S: 1,024 / 1,024 / 64 rows, about
    219 MB at B=1024."""
    for s in (556, 4448, 35584):
        assert tpq.row_width(s, 32, 556) == 17792
    assert 218e6 < 1024 * (12 * tpq.row_width(556, 32, 556) + 4) < 219e6
