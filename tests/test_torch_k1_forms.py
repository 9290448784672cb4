"""K1's compact-plane and staged forms, and their shape rules, on the CPU.

On the card K1 takes one of four forms for a launch, from the shape
alone (``kernels/pq_scan.py::k1_form``).  Two of them walk the tables in
another order than the plain loop, but form every sum alike: one f32
accumulator per (item, query), over ascending m, one add at a time:

  * ``packed`` (the compact planes, K 16, MB 8 or 16 code bytes) turns
    each 32-bit code word into two offset words, ``(w & 0x0F0F0F0F) << 2``
    for the lo nibbles and ``(w >> 2) & 0x3C3C3C3C`` for the hi nibbles,
    and adds lo, then hi, byte by byte;
  * ``staged`` (one query's tables above a CTA's shared memory) scores a
    pass of items against one range of R subquantizers' tables at a
    time, carrying each sum from one range to the next.

Plain twins of those two orders run here.  They equal the plain K1
(``ref.pq_scan_tiled_ref``) bitwise on random f32 tables, and the Pallas
kernel in interpret mode bitwise on integer tables (every sum exact, so
any order of adds agrees) and at rtol=atol=1e-5 on random f32 tables.
The CUDA kernels are held bitwise against ``ref.pq_scan_tiled_ref`` on
the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pq_scan as jpq
from repro_torch.kernels import pq_scan as tpq
from repro_torch.kernels import ref as tref
from repro_torch.quant import pack_nibbles, unpack_nibbles

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, b, m, k, tb, blk, s, qt, ints=False):
    rng = np.random.default_rng(seed)
    lut = (rng.integers(-8, 9, (b, m, k)) if ints
           else rng.standard_normal((b, m, k))).astype(np.float32)
    codes = rng.integers(0, k, (tb, blk, m)).astype(np.uint8)
    tiles = rng.integers(0, tb, (b // qt, s)).astype(np.int32)
    return lut, codes, tiles


def _pallas(lut, codes, tiles, qt, packed=False):
    return np.asarray(jpq.pq_scan_tiled_kernel(
        jnp.asarray(lut), jnp.asarray(codes), jnp.asarray(tiles),
        query_tile=qt, interpret=True, packed=packed))


def staged_twin(lut, codes, tiles, *, query_tile, r, pass_items,
                packed=False):
    """K1 in the staged form's order: the tile's S * BLK items in passes
    of ``pass_items``; in each pass the tables of ``r`` subquantizers at a
    time (the last range short where M % r), copied into a range buffer
    laid out as the kernel lays it out (one query: [r][256]; up to 8:
    [r][2][256][4], query q at half q // 4, lane q % 4), every item's QT
    sums carried from one range to the next."""
    b, m, k = lut.shape
    t_, s = tiles.shape
    codes_t = tref._tile_codes(codes, tiles, packed).reshape(t_, -1, m)
    n = codes_t.shape[1]
    tabs = lut.reshape(t_, query_tile, m, k)
    out = torch.empty((t_, query_tile, n), dtype=torch.float32)
    for p0 in range(0, n, pass_items):
        c = codes_t[:, p0:p0 + pass_items].long()           # (T, P, M)
        acc = torch.zeros((t_, query_tile, c.shape[1]), dtype=torch.float32)
        for m0 in range(0, m, r):
            nr = min(r, m - m0)
            buf = torch.full((t_, r, 2, 256, 4), float("nan"))
            for q in range(query_tile):
                buf[:, :nr, q // 4, :k, q % 4] = tabs[:, q, m0:m0 + nr, :]
            for j in range(nr):
                for q in range(query_tile):
                    acc[:, q] = acc[:, q] + torch.gather(
                        buf[:, j, q // 4, :, q % 4], 1, c[:, :, m0 + j])
        out[:, :, p0:p0 + pass_items] = acc
    return out.reshape(b, s, -1)


def packed_offsets(words: np.ndarray) -> np.ndarray:
    """The packed form's lookups of code rows given as 32-bit words (...,
    MB / 4): the flat entry ``m * 16 + code_m`` of each lookup, in the
    order the kernel adds them.  Each word gives a lo and a hi offset
    word, each byte an entry's byte offset (code * 4); byte j of word v is
    code byte c = 4v + j: subquantizer 2c (lo), then 2c + 1 (hi)."""
    w = words.astype(np.uint32)
    lo = (w & np.uint32(0x0F0F0F0F)) << np.uint32(2)
    hi = (w >> np.uint32(2)) & np.uint32(0x3C3C3C3C)
    out = []
    for v in range(w.shape[-1]):
        for j in range(4):
            c = 4 * v + j
            for half, sub in ((lo, 2 * c), (hi, 2 * c + 1)):
                byte = (half[..., v] >> np.uint32(8 * j)) & np.uint32(255)
                out.append(byte.astype(np.int64) // 4 + sub * 16)
    return np.stack(out, axis=-1)


def packed_twin(lut, codes, tiles, *, query_tile):
    """K1 over nibble-packed codes (TB, BLK, MB) in the packed form's
    order: each row's words through ``packed_offsets``, one add at a
    time."""
    b, m, k = lut.shape
    t_, s = tiles.shape
    rows = codes.numpy()[tiles.numpy()]                     # (T, S, BLK, MB)
    words = rows.reshape(*rows.shape[:-1], -1, 4).view("<u4")[..., 0]
    offs = t(packed_offsets(words)).reshape(t_, 1, -1, m)   # (T, 1, N, M)
    flat = lut.reshape(t_, query_tile, 1, m * k)
    acc = torch.zeros((t_, query_tile, offs.shape[2]), dtype=torch.float32)
    for j in range(m):
        idx = offs[:, :, :, j].expand(-1, query_tile, -1)
        acc = acc + torch.gather(flat[:, :, 0, :], 2, idx)
    return acc.reshape(b, s, -1)


@pytest.mark.parametrize("qt", [1, 8])
@pytest.mark.parametrize("m,r", [(32, 16), (40, 16), (40, 8), (256, 8)])
def test_staged_order_is_the_plain_sum(qt, m, r):
    """Range by range with a carried accumulator (R 16 and 8, a short last
    range at M 40, R 16), in passes that leave a short last one: bitwise
    the plain K1, and the Pallas kernel (integer tables: bitwise; random
    f32: within 1e-5)."""
    for ints in (False, True):
        lut, codes, tiles = _inputs(m + r + qt, 2 * qt, m, 256, 7, 32, 3,
                                    qt, ints)
        got = staged_twin(t(lut), t(codes), t(tiles), query_tile=qt, r=r,
                          pass_items=40)
        want = tref.pq_scan_tiled_ref(t(lut), t(codes), t(tiles),
                                      query_tile=qt)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        pallas = _pallas(lut, codes, tiles, qt)
        if ints:
            np.testing.assert_array_equal(got.numpy(), pallas)
        else:
            np.testing.assert_allclose(got.numpy(), pallas, **TOL)


@pytest.mark.parametrize("mb", [8, 16])
def test_packed_offsets_address_each_table_in_ascending_m(mb):
    """For random code words the offset rule addresses exactly
    lut[m][code_m], m ascending, for MB 8 (pq4) and 16 (binary)."""
    rng = np.random.default_rng(mb)
    words = rng.integers(0, 2 ** 32, (500, mb // 4), dtype=np.uint64)
    words = words.astype(np.uint32)
    codes = unpack_nibbles(t(words.view(np.uint8)), 2 * mb).numpy()
    want = codes + 16 * np.arange(2 * mb)[None, :]
    np.testing.assert_array_equal(packed_offsets(words), want)


@pytest.mark.parametrize("qt", [1, 8])
@pytest.mark.parametrize("mc", [16, 32])
def test_packed_order_is_the_plain_sum(qt, mc):
    """The packed form's order at Mc 16 (pq4) and 32 (binary): bitwise the
    plain K1, and the Pallas kernel in interpret mode (integer tables:
    bitwise; random f32: within 1e-5)."""
    for ints in (False, True):
        lut, codes, tiles = _inputs(mc + qt, 2 * qt, mc, 16, 9, 32, 3, qt,
                                    ints)
        codes = pack_nibbles(codes)
        got = packed_twin(t(lut), t(codes), t(tiles), query_tile=qt)
        want = tref.pq_scan_tiled_ref(t(lut), t(codes), t(tiles),
                                      query_tile=qt, packed=True)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        pallas = _pallas(lut, codes, tiles, qt, packed=True)
        if ints:
            np.testing.assert_array_equal(got.numpy(), pallas)
        else:
            np.testing.assert_allclose(got.numpy(), pallas, **TOL)


@pytest.mark.parametrize("t_,s,blk", [
    (1, 0, 32), (1, 1, 32), (1000, 136, 32), (125, 400, 32), (8, 1500, 32),
    (8, 1100, 32), (1, 9, 4096), (3, 301, 32), (2, 77, 24), (64, 40, 32),
    (1, 5000, 1), (2000, 3, 32)])
def test_staged_splits_cover_s_exactly(t_, s, blk):
    splits, s_per = tpq.staged_splits(t_, s, blk)
    ranges = [(y * s_per, min(s, (y + 1) * s_per)) for y in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert s == 0 or all(b > a for a, b in ranges)
    assert s_per <= tpq.K1_MAX_POSITIONS
    # one pass a CTA where a position fits in one
    assert blk > tpq.K1_STAGED_PASS or s_per * blk <= tpq.K1_STAGED_PASS


def test_staged_splits_at_the_gist_shapes():
    """Paged (1000 queries of ~136 positions): one pass a split; grouped
    (8 tiles): split further, towards two CTAs an SM."""
    assert tpq.staged_splits(1000, 136, 32) == (3, 46)
    assert tpq.staged_splits(125, 400, 32) == (7, 58)
    assert tpq.staged_splits(8, 1500, 32) == (33, 46)


def _k1_smem(m, k, s_per):
    """pq_scan.cu's pq_scan_tiled_smem_bytes, written out (the staged
    form's buffers: 16 tables of 256 floats for one query, 8 x 8 for
    more, twice)."""
    def smem(n, g):
        staged = 0 if n < 1 else 2 * 4 * 256 * (16 if n == 1 else 64)
        return (staged if g else 4 * n * m * k) + 4 * s_per
    return smem


# (name, M, K, MB, packed, QT of a launch, form); rows 16-byte aligned
FORM_SHAPES = [
    ("main", 64, 16, 64, False, 1, "fast"),
    ("main tile", 64, 16, 64, False, 8, "fast"),
    ("main qt=64 group", 64, 16, 64, False, 32, "fast"),
    ("pq4", 16, 16, 8, True, 1, "packed"),
    ("pq4 tile", 16, 16, 8, True, 8, "packed"),
    ("binary", 32, 16, 16, True, 1, "packed"),
    ("binary qt=64", 32, 16, 16, True, 64, "packed"),
    ("binary qt=4", 32, 16, 16, True, 4, "generic"),
    ("odd Mc", 64, 16, 32, True, 8, "generic"),
    ("nbits8", 64, 256, 64, False, 1, "k256"),
    ("nbits8 group", 64, 256, 64, False, 3, "k256"),
    ("K 4", 64, 4, 64, False, 8, "generic"),
    ("nbits8 tile", 64, 256, 64, False, 8, "k256"),
    ("nbits8 qt=64", 64, 256, 64, False, 64, "k256"),
    ("K 256, M 72", 72, 256, 72, False, 1, "k256"),
    ("K 256, M 40", 40, 256, 40, False, 1, "k256"),
    ("K 256, M 60 tile", 60, 256, 60, False, 8, "k256"),
    ("K 256, M 60", 60, 256, 60, False, 1, "generic"),
]


@pytest.mark.parametrize("name,m,k,mb,packed,qt,form", FORM_SHAPES)
def test_k1_form_from_the_shape(name, m, k, mb, packed, qt, form):
    assert tpq.k1_form(m, k, 32, mb, qt, packed, False, 16) == form
    # a BLK that is not a power of two keeps the generic loop
    assert tpq.k1_form(m, k, 24, mb, qt, packed, False, 16) == "generic"


def test_k1_form_needs_aligned_rows_and_picks_staged_for_global_tables():
    assert tpq.k1_form(64, 16, 32, 64, False, 8, False, 8) == "generic"
    # k256: rows in 8-byte pieces at QT 1; a tile reads them by ranges
    assert tpq.k1_form(64, 256, 32, 64, 1, False, False, 8) == "k256"
    assert tpq.k1_form(64, 256, 32, 64, 1, False, False, 4) == "generic"
    assert tpq.k1_form(64, 256, 32, 64, 8, False, False, 1) == "k256"
    assert tpq.k1_form(32, 16, 32, 16, True, 8, False, 8) == "generic"
    assert tpq.k1_form(16, 16, 32, 8, True, 8, False, 8) == "packed"
    assert tpq.k1_form(16, 16, 32, 8, True, 8, False, 4) == "generic"
    for qt in (1, 3, 8):
        assert tpq.k1_form(256, 256, 32, 256, False, qt, True, 1) == "staged"


@pytest.mark.parametrize("m,k,qt,groups,form", [
    (256, 256, 1, [(0, 1)], "staged"),       # gist paged
    (256, 256, 8, [(0, 8)], "staged"),       # gist tile
    (256, 256, 64, [(8 * g, 8 * g + 8) for g in range(8)], "staged"),
    (64, 256, 8, [(0, 8)], "k256"),          # nbits8: one launch
    (64, 256, 1, [(0, 1)], "k256"),          # nbits8 paged
    (64, 256, 64, [(0, 64)], "k256"),
    (16, 16, 8, [(0, 8)], "packed"),         # pq4
    (32, 16, 64, [(0, 64)], "packed"),       # binary, query_tile 64
    (64, 16, 64, [(0, 32), (32, 64)], "fast")])
def test_k1_groups_and_form_at_the_path_shapes(m, k, qt, groups, form):
    packed = m < 64
    k256 = tpq.k1_form(m, k, 32, m // 2 if packed else m, qt, packed, False,
                       16) == "k256"
    got = tpq.k1_groups(qt, _k1_smem(m, k, 1024), k256)
    assert got == groups
    assert got.k256 == (form == "k256")
    forms = {tpq.k1_form(m, k, 32, m // 2 if packed else m, q1 - q0, packed,
                         got.global_tables, 16) for q0, q1 in got}
    assert forms == {form}


def test_form_counts_follow_graph_replays():
    """K1's launches by form are counters beside its launch count: a CUDA
    graph's replay adds both (core/graphs.py), and a CPU call adds
    neither."""
    tpq.reset_launch_counts()
    before = tpq.launch_counts(forms=True)
    assert set(before) >= {f"pq_scan_tiled_kernel[{f}]"
                           for f in tpq.K1_FORMS}
    lut, codes, tiles = _inputs(0, 8, 16, 16, 5, 32, 2, 8)
    tpq.pq_scan_tiled_kernel(t(lut), t(codes), t(tiles), query_tile=8)
    assert tpq.launch_counts(forms=True) == before
    tpq.add_launch_counts({"pq_scan_tiled_kernel": 2,
                           "pq_scan_tiled_kernel[staged]": 2})
    after = tpq.launch_counts(forms=True)
    assert after["pq_scan_tiled_kernel[staged]"] == 2
    assert tpq.launch_counts() == dict(tpq.launch_counts(),
                                       pq_scan_tiled_kernel=2)
    tpq.reset_launch_counts()
    assert tpq.launch_counts(forms=True) == before
