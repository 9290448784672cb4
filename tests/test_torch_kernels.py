"""The port's scan kernels against the JAX reference, on the CPU.

On the CPU every wrapper takes its plain version (kernels/ref.py), so
these tests hold the plain versions — which the CUDA kernels must match
bitwise on the card (chip_smoke.py) — against the Pallas kernels in
interpret mode and against the reference's jnp oracles.  f32 distances
compare at rtol=atol=1e-5 (one-hot dot_general and gather-sum round
differently in the last ulp); with integer-valued LUTs every sum is
exact in any order, so those compare bitwise, ids and positions too.
The CUDA kernels themselves are held against these plain versions on
the card by chip_smoke.py (the card's machine has no JAX, which every
test here imports).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import (EXEC_MODES, BlockStore, QueryPlan,
                               preselect_candidates, scan_blocks,
                               scan_blocks_topk)
from repro.kernels import ops as jops
from repro.kernels import pq_scan as jpq
from repro.kernels.topk import PAD_POS as J_PAD_POS
from repro.quant.nibbles import pack_nibbles as j_pack
from repro_torch.core import engine as teng
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pq_scan as tpq
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk as ttopk

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


# the shape sweep of tests/test_kernels.py
SWEEP = [(1, 4, 16, 3, 32, 2), (4, 8, 16, 10, 32, 6), (8, 64, 16, 32, 32, 5),
         (2, 16, 16, 7, 128, 3), (2, 32, 8, 5, 64, 4), (16, 2, 16, 4, 32, 1)]


def _scan_inputs(seed, b, m, k, tb, blk, s):
    rng = np.random.default_rng(seed)
    lut = rng.standard_normal((b, m, k)).astype(np.float32)
    codes = rng.integers(0, k, (tb, blk, m)).astype(np.uint8)
    idx = rng.integers(0, tb, (b, s)).astype(np.int32)
    return lut, codes, idx


@pytest.mark.parametrize("b,m,k,tb,blk,s", SWEEP)
def test_plain_k1_paged_matches_pallas(b, m, k, tb, blk, s):
    lut, codes, idx = _scan_inputs(b * 131 + m, b, m, k, tb, blk, s)
    want = np.asarray(jops.pq_scan_paged(jnp.asarray(lut), jnp.asarray(codes),
                                         jnp.asarray(idx)))
    got = tops.pq_scan_paged(t(lut), t(codes), t(idx)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode,qt", [("grouped", 1), ("grouped", 4),
                                     ("tiled", 2), ("tiled", 8)])
def test_plain_k1_tiles_match_pallas(mode, qt):
    b, m, k, tb, blk, s = 8, 16, 16, 12, 32, 5
    lut, codes, idx = _scan_inputs(9 + qt, b, m, k, tb, blk, s)
    if mode == "grouped":
        want = jops.pq_scan_grouped(jnp.asarray(lut), jnp.asarray(codes),
                                    jnp.asarray(idx[0]), query_tile=qt)
        got = tops.pq_scan_grouped(t(lut), t(codes), t(idx[0]), query_tile=qt)
    else:
        tiles = idx[: b // qt]
        want = jops.pq_scan_tiled(jnp.asarray(lut), jnp.asarray(codes),
                                  jnp.asarray(tiles), query_tile=qt)
        got = tops.pq_scan_tiled(t(lut), t(codes), t(tiles), query_tile=qt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mc", [8, 15])
def test_plain_k1_packed_plane_matches_pallas(mc):
    """Nibble-packed planes, odd Mc included (the LUT zero-pad to 2*MB)."""
    lut, codes, idx = _scan_inputs(mc, 4, mc, 16, 9, 32, 3)
    packed = j_pack(codes)
    want = jops.pq_scan_paged(jnp.asarray(lut), jnp.asarray(packed),
                              jnp.asarray(idx), packed=True)
    got = tops.pq_scan_paged(t(lut), t(packed), t(idx), packed=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the unpacked scan of the same codes
    plain = tops.pq_scan_paged(t(lut), t(codes), t(idx))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_plain_k1_integer_luts_bitwise():
    rng = np.random.default_rng(3)
    lut = rng.integers(0, 5, (4, 16, 16)).astype(np.float32)
    codes = rng.integers(0, 16, (10, 32, 16)).astype(np.uint8)
    idx = rng.integers(0, 10, (4, 6)).astype(np.int32)
    want = np.asarray(jops.pq_scan_paged(jnp.asarray(lut), jnp.asarray(codes),
                                         jnp.asarray(idx)))
    np.testing.assert_array_equal(
        tops.pq_scan_paged(t(lut), t(codes), t(idx)).numpy(), want)


def test_k2_tile_row_invariant():
    lut, codes, idx = _scan_inputs(1, 4, 8, 16, 9, 32, 3)
    with pytest.raises(ValueError, match="tile rows"):
        tpq.pq_scan_paged_kernel(t(lut), t(codes), t(idx), query_tile=2)
    shared = idx[[0, 0, 2, 2]]
    out = tpq.pq_scan_paged_kernel(t(lut), t(codes), t(shared), query_tile=2)
    np.testing.assert_array_equal(
        out.numpy(), tref.pq_scan_paged_ref(t(lut), t(codes), t(shared)).numpy())


def test_cpu_wrappers_launch_no_kernel():
    lut, codes, idx = _scan_inputs(2, 2, 8, 16, 5, 32, 2)
    before = tpq.launch_counts(forms=True)
    tops.pq_scan_paged(t(lut), t(codes), t(idx))
    # the routed delta scan: 3 queries probing 2 of 4 lists over 6 slots
    # (slot 4 dead), each slot posted under its distinct assigned lists
    assigns = np.array([[0, 2], [1, 1], [0, 3], [2, 2], [2, 1], [2, 0]],
                       np.int32)
    post = np.array([[0, 2, 5, -1], [1, 4, -1, -1], [0, 3, 4, 5],
                     [2, -1, -1, -1]], np.int32)
    sel = np.array([[0, 2], [1, 2], [3, 0]], np.int32)
    rank_of = np.full((3, 4), 2 ** 30, np.int32)
    rank_of[np.arange(3)[:, None], sel] = np.arange(2)
    dd, di, dco, walked = tops.delta_scan_topk(
        t(lut[:1].repeat(3, 0)), t(codes[0, :6]),
        t(np.array([0, 1, 2, 3, -1, 5], np.int32)), t(post), t(assigns),
        t(sel), t(rank_of), fetch=4)
    assert tpq.launch_counts(forms=True) == before
    np.testing.assert_array_equal(walked.numpy(), [7, 6, 4])
    np.testing.assert_array_equal(dco.numpy(), [4, 4, 3])
    assert dd.shape == di.shape == (3, 4) and int(di[2, 3]) == -1


def _delta_smem(m, k, nlist, p, fw, form):
    """csrc/delta_scan_topk.cu's smem_words, in bytes: the table (not
    GT), the rank_of row (RANK), the probed lists and their offsets, one
    query's selection state (not GS: six FW-wide arrays, its fill and
    flush widths), the kept count."""
    return 4 * ((0 if form & tpq.DELTA_GT else m * k)
                + (nlist if form & tpq.DELTA_RANK else 0) + 2 * p + 1
                + (0 if form & tpq.DELTA_GS else 6 * fw + 5) + 1)


@pytest.mark.parametrize("shape,form,name", [
    ((64, 16, 4096, 32, 256), tpq.DELTA_RANK, "shared"),       # churn
    ((64, 256, 4096, 32, 256), tpq.DELTA_RANK, "shared"),      # PQ64x8
    ((64, 256, 65536, 32, 256), 0, "shared"),  # rank row left in global
    ((256, 256, 4096, 32, 256), tpq.DELTA_GT | tpq.DELTA_RANK, "GT"),
    ((64, 16, 4096, 32, 16384), tpq.DELTA_GS | tpq.DELTA_RANK, "GS"),
    ((256, 256, 65536, 32, 16384), tpq.DELTA_GS | tpq.DELTA_GT, "GT-GS"),
])
def test_delta_form_from_shape(shape, form, name):
    """The delta scan's form is the first that fits a block's shared
    memory: the rank_of row leaves it before the table, the selection
    state last."""
    assert tpq.delta_form(*shape, _delta_smem) == form
    assert tpq.delta_form_name(form) == name
    with pytest.raises(ValueError):
        tpq.delta_form(64, 16, 4096, 40_000, 256, _delta_smem)


@pytest.mark.parametrize("b,p,wave,splits", [
    (1024, 32, 660, 1), (64, 32, 660, 10), (64, 4, 660, 4), (1, 32, 660, 32),
    (660, 32, 660, 1), (0, 32, 660, 32)])
def test_delta_splits_from_batch(b, p, wave, splits):
    """A query's walk splits over as many CTAs as keep the batch within
    one wave, at most one a probed list."""
    assert tpq.delta_splits(b, p, wave) == splits


# ---------------------------------------------------------------------------
# K3: fused scan -> top-k
# ---------------------------------------------------------------------------
def synth(seed, *, b=8, s=5, tb=12, blk=32, m=4, k=16, nlist=10, nid=200,
          tie_heavy=False):
    """numpy (store, plan, lut, rank_of, sel, live) with duplicate ids,
    invalid items and misc co-assignments (tests/test_fused.py's _synth)."""
    rng = np.random.default_rng(seed)
    if tie_heavy:
        lut = rng.integers(0, 3, (b, m, k)).astype(np.float32)
    else:
        lut = rng.standard_normal((b, m, k)).astype(np.float32)
    return dict(
        lut=lut,
        codes=rng.integers(0, k, (tb, blk, m)).astype(np.uint8),
        ids=rng.integers(-1, nid, (tb, blk)).astype(np.int32),
        other=rng.integers(-1, nlist, (tb, blk)).astype(np.int32),
        blocks=np.stack([rng.choice(tb, s, replace=False)
                         for _ in range(b)]).astype(np.int32),
        ranks=np.sort(rng.integers(0, nlist, (b, s)), axis=1).astype(np.int32),
        valid=rng.random((b, s)) < 0.85,
        rank_of=np.where(rng.random((b, nlist)) < 0.5,
                         rng.integers(0, nlist, (b, nlist)),
                         2 ** 30).astype(np.int32),
        sel=np.sort(rng.choice(nlist, (b, 3), replace=True), 1).astype(np.int32),
        live=rng.random(nid) < 0.8)


def jax_side(d):
    store = BlockStore(jnp.asarray(d["codes"]), jnp.asarray(d["ids"]),
                       jnp.asarray(d["other"]))
    plan = QueryPlan(jnp.asarray(d["blocks"]), jnp.asarray(d["ranks"]),
                     jnp.asarray(d["valid"]),
                     jnp.zeros(d["blocks"].shape[0], jnp.int32))
    return store, plan


def torch_side(d):
    store = teng.BlockStore(t(d["codes"]), t(d["ids"]), t(d["other"]))
    plan = teng.QueryPlan(t(d["blocks"]), t(d["ranks"]), t(d["valid"]),
                          torch.zeros(d["blocks"].shape[0], dtype=torch.int32))
    return store, plan


@pytest.mark.parametrize("exec_mode", EXEC_MODES)
@pytest.mark.parametrize("with_live", [False, True])
def test_plain_k3_matches_fused_oracle(exec_mode, with_live):
    """Port scan_blocks_topk (plain K3 on the CPU) == JAX
    scan_blocks_topk(use_kernel=False), bitwise on tie-heavy plans."""
    d = synth(17 + EXEC_MODES.index(exec_mode), tie_heavy=True)
    js, jp = jax_side(d)
    ts, tp = torch_side(d)
    want = scan_blocks_topk(js, jp, jnp.asarray(d["lut"]),
                            jnp.asarray(d["rank_of"]), fetch=16,
                            exec_mode=exec_mode, use_kernel=False,
                            query_tile=4, sel=jnp.asarray(d["sel"]),
                            live=jnp.asarray(d["live"]) if with_live else None)
    got = teng.scan_blocks_topk(ts, tp, t(d["lut"]), t(d["rank_of"]),
                                fetch=16, exec_mode=exec_mode, query_tile=4,
                                sel=t(d["sel"]),
                                live=t(d["live"]) if with_live else None)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("exec_mode", EXEC_MODES)
def test_plain_k3_random_luts(exec_mode):
    """Random f32 LUTs: distances at 1e-5, counters bitwise."""
    d = synth(5, tie_heavy=False)
    js, jp = jax_side(d)
    ts, tp = torch_side(d)
    want = scan_blocks_topk(js, jp, jnp.asarray(d["lut"]),
                            jnp.asarray(d["rank_of"]), fetch=24,
                            exec_mode=exec_mode, query_tile=4,
                            sel=jnp.asarray(d["sel"]))
    got = teng.scan_blocks_topk(ts, tp, t(d["lut"]), t(d["rank_of"]),
                                fetch=24, exec_mode=exec_mode, query_tile=4,
                                sel=t(d["sel"]))
    np.testing.assert_allclose(got.flat_d.numpy(), np.asarray(want.flat_d),
                               **TOL)
    np.testing.assert_array_equal(got.approx_dco.numpy(),
                                  np.asarray(want.approx_dco))


def test_plain_k3_matches_pallas_kernel_interpret():
    """The plain K3 against the Pallas kernel itself (interpret mode):
    all four outputs bitwise on a tie-heavy grouped layout, dead tile on."""
    d = synth(23, b=4, s=3, tb=6, tie_heavy=True)
    b, s = d["blocks"].shape
    slot_of = np.where(d["valid"], np.arange(s)[None, :], -1).astype(np.int32)
    dead = (~d["live"][np.maximum(d["ids"], 0)] & (d["ids"] >= 0)
            ).astype(np.uint8)
    args = (d["lut"], d["codes"], d["ids"], d["other"], d["blocks"],
            d["rank_of"], slot_of, d["ranks"], dead)
    want = jpq.pq_scan_topk_kernel(*map(jnp.asarray, args), query_tile=1,
                                   fetch=40, interpret=True)
    got = tref.pq_scan_topk_ref(*map(t, args), query_tile=1, fetch=40)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert ttopk.PAD_POS == J_PAD_POS


@pytest.mark.parametrize("fetch", [100, 400])
def test_plain_k3_packed_plane_matches_pallas_kernel_interpret(fetch):
    """The plain K3 on a nibble-packed plane (the two-tier search's pq4
    shape: M 16 in 8 code bytes) against the Pallas kernel in interpret
    mode, at the planes' fetch 400 (FW 512) and at 100: all four outputs
    bitwise, tie-heavy, dead tile on; two tiles of two queries with 896
    planned items each, so that most of them keep more than fetch 400
    and one keeps fewer (pads)."""
    d = synth(29, b=4, s=7, tb=10, blk=128, m=16, tie_heavy=True)
    b, s = d["blocks"].shape
    slot_of = np.where(d["valid"], np.arange(s)[None, :], -1).astype(np.int32)
    dead = (~d["live"][np.maximum(d["ids"], 0)] & (d["ids"] >= 0)
            ).astype(np.uint8)
    tiles = d["blocks"][::2]            # query tile 2: row 0's list
    args = (d["lut"], j_pack(d["codes"]), d["ids"], d["other"], tiles,
            d["rank_of"], slot_of, d["ranks"], dead)
    want = jpq.pq_scan_topk_kernel(*map(jnp.asarray, args), query_tile=2,
                                   fetch=fetch, interpret=True, packed=True)
    got = tref.pq_scan_topk_ref(*map(t, args), query_tile=2, fetch=fetch,
                                packed=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the selection bites: a query keeps more items than fetch
    assert ((got[1] < ttopk.PAD_POS).sum(axis=1) == fetch).any()


def test_plain_k3_pads_short_streams():
    """fetch beyond the candidate stream pads with (+inf, PAD_POS, -1)."""
    d = synth(8, b=2, s=1, tb=3, blk=8)
    b, s = d["blocks"].shape
    slot_of = np.zeros((b, s), np.int32)
    acc_d, acc_pos, acc_id, dco = tref.pq_scan_topk_ref(
        t(d["lut"]), t(d["codes"]), t(d["ids"]), t(d["other"]),
        t(d["blocks"]), t(d["rank_of"]), t(slot_of), t(d["ranks"]),
        query_tile=1, fetch=20)
    assert acc_d.shape == (2, 20)
    assert torch.isinf(acc_d[:, 8:]).all()
    assert (acc_pos[:, 8:] == ttopk.PAD_POS).all()
    assert (acc_id[:, 8:] == -1).all()


def test_unfused_reference_equals_fused_plain():
    """preselect over the port's unfused stream == its fused stream."""
    d = synth(31, tie_heavy=True)
    ts, tp = torch_side(d)
    for mode in EXEC_MODES:
        out = teng.scan_blocks(ts, tp, t(d["lut"]), t(d["rank_of"]),
                               exec_mode=mode, query_tile=4, sel=t(d["sel"]))
        ids = torch.where(torch.isfinite(out.flat_d), out.flat_i, -1)
        cd, ci = teng.preselect_candidates(out.flat_d, ids, fetch=16)
        fused = teng.scan_blocks_topk(ts, tp, t(d["lut"]), t(d["rank_of"]),
                                      fetch=16, exec_mode=mode, query_tile=4,
                                      sel=t(d["sel"]))
        np.testing.assert_array_equal(fused.flat_d.numpy(), cd.numpy())
        np.testing.assert_array_equal(fused.flat_i.numpy(), ci.numpy())
        # and the JAX unfused stream agrees bitwise on integer LUTs
        js, jp = jax_side(d)
        jout = scan_blocks(js, jp, jnp.asarray(d["lut"]),
                           jnp.asarray(d["rank_of"]), exec_mode=mode,
                           query_tile=4, sel=jnp.asarray(d["sel"]))
        jd, _ = preselect_candidates(jout.flat_d, jout.flat_i, fetch=16)
        np.testing.assert_array_equal(cd.numpy(), np.asarray(jd))


# ---------------------------------------------------------------------------
# K4: the selection network
# ---------------------------------------------------------------------------
def _lex_sorted(d, p, i):
    order = np.lexsort((p, d), axis=-1)
    return [np.take_along_axis(x, order, -1) for x in (d, p, i)]


@pytest.mark.parametrize("n", [2, 8, 64, 256])
def test_bitonic_sort_matches_lexsort(n):
    rng = np.random.default_rng(n)
    d = rng.integers(0, 4, (3, n)).astype(np.float32)     # heavy ties
    d[0, : n // 4] = np.inf
    p = np.stack([rng.permutation(n) for _ in range(3)]).astype(np.int32)
    i = rng.integers(-1, 50, (3, n)).astype(np.int32)
    got = ttopk.bitonic_sort([t(d), t(p), t(i)])
    for g, w in zip(got, _lex_sorted(d, p, i)):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("f", [4, 16, 128])
def test_merge_topf_is_global_topf(f):
    rng = np.random.default_rng(f)
    acc = [rng.integers(0, 5, (2, f)).astype(np.float32),
           rng.permutation(2 * f)[:f][None].repeat(2, 0).astype(np.int32)]
    new_p = np.setdiff1d(np.arange(4 * f), acc[1][0])[:f]
    new = [rng.integers(0, 5, (2, f)).astype(np.float32),
           new_p[None].repeat(2, 0).astype(np.int32)]
    acc = _lex_sorted(acc[0], acc[1], acc[1])
    new = _lex_sorted(new[0], new[1], new[1])
    got = ttopk.merge_topf([t(x) for x in acc], [t(x) for x in new])
    want = _lex_sorted(np.concatenate([acc[0], new[0]], 1),
                       np.concatenate([acc[1], new[1]], 1),
                       np.concatenate([acc[2], new[2]], 1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w[:, :f])


def test_bitonic_rejects_non_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        ttopk.bitonic_sort([torch.zeros(1, 6), torch.zeros(1, 6)])
    assert [ttopk.pow2_ceil(n) for n in (1, 2, 3, 100, 128, 129)] == \
        [1, 2, 4, 128, 128, 256]
