"""The PQ encode kernel (``kernels/csrc/pq_encode.cu``) and its dispatch.

Shapes: SIFT's PQ64x4 and PQ64x8, the gist shape (PQ256x8 at D 256), the
pq4 and binary planes at D 128 (dsub 8 and 4) and a dsub of 3 (the
kernel's generic path).  Two encoders' codes may differ only at f32 ties
(``tie_window``), and in at most ``DIFF_SHARE`` of the codes.

On the card (tests marked ``cuda``; they skip without a CUDA device or
``nvcc``): the kernel against the plain loop, codes equal but at f32
ties; codes bitwise independent of the batch a row is encoded in; one
launch a call; the stream's insert through the kernel.  The file imports
no JAX at module level, so it also runs where JAX is missing:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_pq_encode.py

On the CPU: ``pq_encode`` of a CPU tensor takes the plain loop (no launch)
and gives the codes that loop gave before the kernel existed, equal to
the JAX reference's but at f32 ties (so the kernel is tied to the
reference through the plain loop), and the insert's encode span carries
``kernel`` 0.
"""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import IndexConfig, PQCodebook, build_index, pq_encode
from repro_torch.data import make_dataset
from repro_torch.kernels import build, ops
from repro_torch.kernels.pq_scan import pq_encode_kernel

# (M, K, dsub): SIFT PQ64x4 and PQ64x8, the gist-shaped PQ256x8 at D 256,
# the planes at D 128 (pq4: compact_subdim 8; binary: groups of 4 bits),
# and a dsub the kernel has no instantiation for (its generic path)
SHAPES = {"sift-pq64x4": (64, 16, 2), "sift-pq64x8": (64, 256, 2),
          "gist-pq256x8": (256, 256, 1), "pq4-plane": (16, 16, 8),
          "binary-plane": (32, 16, 4), "generic-dsub3": (32, 16, 3)}
# at most this share of the kernel's codes may differ from the plain
# loop's (rounded up): the card measured 0 to 4 f32 ties in 4,194,304
DIFF_SHARE = 1e-5
# and from the JAX reference's, which XLA rounds otherwise: at dsub 1 many
# rows lie within rounding of two 1-D centroids (25 of 76,800 codes of
# the gist shape differ from the plain loop's on the CPU, all f32 ties)
REF_DIFF_SHARE = 1e-3
SIZES = (1, 37, 8192, 65537)


def _loop_encode(books: torch.Tensor, x: torch.Tensor,
                 chunk: int = 65536) -> torch.Tensor:
    """The plain loop as it stood before the kernel: a distance matmul and
    argmin per subquantizer."""
    n = x.shape[0]
    m, _, dsub = books.shape
    out = torch.empty((n, m), dtype=torch.uint8)
    for s in range(0, n, chunk):
        xs = x[s:s + chunk].reshape(-1, m, dsub)
        for j in range(m):
            c = books[j]
            x2 = torch.sum(xs[:, j] * xs[:, j], dim=-1, keepdim=True)
            d = torch.clamp_min(x2 - 2.0 * (xs[:, j] @ c.T)
                                + torch.sum(c * c, dim=-1)[None, :], 0.0)
            out[s:s + chunk, j] = torch.argmin(d, dim=-1).to(torch.uint8)
    return out


def _inputs(shape, n, seed):
    """Codebook and rows from ``seed`` (CPU), with exact ties planted: a
    duplicated centroid (the lower code must win) and rows that sit on a
    centroid."""
    m, k, dsub = shape
    g = torch.Generator().manual_seed(seed)
    books = torch.randn((m, k, dsub), generator=g)
    books[:, k - 1] = books[:, k // 2]
    x = torch.randn((n, m * dsub), generator=g)
    for r in range(0, n, 7):
        j = r % m
        x[r, j * dsub:(j + 1) * dsub] = books[j, (r * 5) % k]
    return books, x


def tie_window(dsub: int) -> float:
    """The largest f64 gap between two centroids' distances to a row,
    relative to |x|^2 + the larger |c|^2 of the two, that two f32
    encoders may round either way.  One f32 distance (x2 - 2 xc) + c2
    over dsub products, summed in any order, is off by at most
    (2 dsub + 5) u (|x|^2 + |c|^2), u = 2^-24 (the package turns TF32
    off); two encoders may each pick one of two centroids whose exact
    distances lie within twice that."""
    return (4 * dsub + 10) * 2.0 ** -24


def _assert_ties(books, x, got, want, share=DIFF_SHARE):
    """Each (row, subquantizer) where ``got`` and ``want`` differ must be an
    f32 tie: the f64 distances of the two centroids within ``tie_window``;
    and at most ``share`` of the codes (rounded up) may differ."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    rows, cols = np.nonzero(got != want)
    if share is not None:
        assert rows.size <= np.ceil(share * got.size), (rows.size, got.size)
    if rows.size == 0:
        return
    b64 = books.double().numpy()
    dsub = b64.shape[2]
    xs = x.double().numpy().reshape(x.shape[0], -1, dsub)[rows, cols]
    bg, bw = b64[cols, got[rows, cols]], b64[cols, want[rows, cols]]
    dg, dw = ((bg - xs) ** 2).sum(1), ((bw - xs) ** 2).sum(1)
    scale = (xs * xs).sum(1) + np.maximum((bg * bg).sum(1), (bw * bw).sum(1))
    gap = np.abs(dg - dw) / scale
    bad = int(gap.argmax())
    assert gap[bad] <= tie_window(dsub), (
        int(rows[bad]), int(cols[bad]), int(got[rows[bad], cols[bad]]),
        int(want[rows[bad], cols[bad]]), float(gap[bad]))


def _reference_codes(books, x):
    """The JAX reference's codes (``repro.core.pq.pq_encode``), on a
    machine with no card: the reference is held against the port on the
    CPU only.  Skips where JAX is missing or a card is present."""
    if torch.cuda.is_available():
        pytest.skip("the JAX reference runs on the CPU only, and would take "
                    "the card here")
    pytest.importorskip("jax")
    from repro.core import pq as jpq
    return torch.from_numpy(np.array(jpq.pq_encode(
        jpq.PQCodebook(books.cpu().numpy()), x.cpu().numpy())))


@pytest.fixture(scope="module")
def card():
    """The CUDA device with the kernels built; skips without a device or
    a CUDA compiler (a failed build raises)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the encode kernel has no CPU form")
    try:
        build._nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    build.build_all()
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_against_plain(card, shape, n):
    books, x = _inputs(SHAPES[shape], n, seed=n)
    got = ops.pq_encode(books.to(card), x.to(card))
    torch.cuda.synchronize()
    want = pq_encode(PQCodebook(books), x)
    assert got.shape == want.shape and got.dtype == torch.uint8
    assert int(got.max()) < SHAPES[shape][1]
    _assert_ties(books, x, got, want)
    # planted ties: centroid k - 1 duplicates k // 2, so it never wins; a
    # row on centroid c of subquantizer j codes c, or a centroid whose
    # distance rounds to the same clamped 0 (an f32 tie of c)
    m, k, _ = SHAPES[shape]
    got = got.cpu()
    assert not bool((got == k - 1).any())
    planted = got.clone()
    for r in range(0, n, 7):
        c = (r * 5) % k
        planted[r, r % m] = k // 2 if c == k - 1 else c
    _assert_ties(books, x, got, planted, share=None)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_codes_bitwise_independent_of_the_batch(card, shape):
    books, x = _inputs(SHAPES[shape], 65537, seed=1)
    books, x = books.to(card), x.to(card)
    whole = ops.pq_encode(books, x)
    batch = ops.pq_encode(books, x[1000:1037])
    alone = torch.cat([ops.pq_encode(books, x[r:r + 1])
                       for r in (0, 1000, 1036, 65536)])
    torch.cuda.synchronize()
    assert torch.equal(batch, whole[1000:1037])
    assert torch.equal(alone, whole[[0, 1000, 1036, 65536]])


@pytest.mark.cuda
def test_one_launch_a_call(card):
    books, x = _inputs(SHAPES["sift-pq64x4"], 300, seed=2)
    books, x = books.to(card), x.to(card)
    for n in (1, 38, 300):
        before = pq_encode_kernel.launches
        pq_encode(PQCodebook(books), x[:n])
        assert pq_encode_kernel.launches == before + 1
    before = pq_encode_kernel.launches
    assert pq_encode(PQCodebook(books), x[:0]).shape == (0, 64)
    assert pq_encode_kernel.launches == before


@pytest.mark.cuda
def test_insert_encodes_through_the_kernel(card):
    x, _, _ = make_dataset("unit", device=card)
    index = build_index(x[:4000], IndexConfig(nlist=32, kmeans_iters=4,
                                              pq_iters=4), device=card)
    stream = index.streaming()
    before = pq_encode_kernel.launches
    with obs.trace() as tr:
        stream.insert(x[4000:4038])
    assert pq_encode_kernel.launches == before + 1
    (span,) = [r for r in tr.records if r["kind"] == "span"
               and r["name"] == "stream.insert.encode"]
    assert span["args"]["kernel"] == 1
    want = ops.pq_encode(index.codebook.codebooks, x[4000:4038])
    assert np.array_equal(stream._delta.codes[:38], want.cpu().numpy())


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture
def one_thread():
    """One intra-op thread while the plain loop runs.  At 300 rows a
    subquantizer's (300, K 256) distances pass the size at which torch
    splits an op over its thread pool, so the gist shape's loops fork and
    join some 6,000 times a call; where other processes hold the cores
    (the suite's parallel workers) each join waits for descheduled
    threads, and the call took minutes instead of a fraction of a second.
    The codes do not depend on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", (1, 37, 300))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cpu_takes_the_plain_loop(one_thread, shape, n):
    books, x = _inputs(SHAPES[shape], n, seed=3)
    before = pq_encode_kernel.launches
    got = pq_encode(PQCodebook(books), x)
    assert pq_encode_kernel.launches == before
    assert torch.equal(got, _loop_encode(books, x))
    assert torch.equal(pq_encode_kernel(books, x), got)
    assert torch.equal(ops.pq_encode(books, x), got)
    assert pq_encode_kernel.launches == before


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cpu_codes_against_reference(one_thread, shape):
    books, x = _inputs(SHAPES[shape], 300, seed=5)
    _assert_ties(books, x, pq_encode(PQCodebook(books), x),
                 _reference_codes(books, x), REF_DIFF_SHARE)


def test_insert_encode_span_counts_no_kernel_on_the_cpu():
    x, _, _ = make_dataset("unit", device="cpu")
    index = build_index(x[:3000], IndexConfig(nlist=16, kmeans_iters=3,
                                              pq_iters=3), device="cpu")
    stream = index.streaming()
    before = pq_encode_kernel.launches
    with obs.trace() as tr:
        stream.insert(x[3000:3037])
    assert pq_encode_kernel.launches == before
    (span,) = [r for r in tr.records if r["kind"] == "span"
               and r["name"] == "stream.insert.encode"]
    assert span["args"]["kernel"] == 0
    assert np.array_equal(stream._delta.codes[:37], _loop_encode(
        index.codebook.codebooks, x[3000:3037]).numpy())
