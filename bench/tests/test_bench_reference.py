"""The plain reference of the benchmark against brute force in NumPy."""
import numpy as np
import pytest
import torch

import tiny  # noqa: F401  (puts bench/ on the path)
import reference


def _brute(x, q, k, live=None):
    d = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64))
         ** 2).sum(-1)
    if live is not None:
        d[:, ~live] = np.inf
    return np.argsort(d, axis=1, kind="stable")[:, :k], d


@pytest.mark.parametrize("chunk", [7, 64, 1 << 18])
@pytest.mark.parametrize("masked", [False, True])
def test_exact_topk_matches_brute_force(chunk, masked):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 12)).astype(np.float32)
    q = rng.normal(size=(9, 12)).astype(np.float32)
    live = rng.random(300) > 0.3 if masked else None
    want, d = _brute(x, q, 5, live)
    ids, dist = reference.exact_topk(
        torch.from_numpy(x), torch.from_numpy(q), 5, chunk=chunk,
        live=None if live is None else torch.from_numpy(live))
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_allclose(dist.numpy(),
                               np.take_along_axis(d, want, 1), rtol=1e-4,
                               atol=1e-4)


def test_tf32_control_reads_a_gap_the_program_does_not():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(500, 32)).astype(np.float32)) * 5
    q = torch.from_numpy(rng.normal(size=(20, 32)).astype(np.float32)) * 5
    ids, _ = reference.exact_topk(x, q, 10)
    direct = ((x[ids] - q[:, None, :]) ** 2).sum(-1)      # as the program
    gap, short = reference.dist_gap(x, q, ids, direct)
    assert gap < 1e-6 and short == 0
    cid, cd = reference.exact_topk(x, q, 10, tf32=True)
    cgap, _ = reference.dist_gap(x, q, cid, cd)
    assert cgap > 30 * max(gap, 1e-8)


def test_dist_gap_catches_an_altered_id_and_a_short_answer():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(200, 8)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    ids, _ = reference.exact_topk(x, q, 6)
    d = ((x[ids] - q[:, None, :]) ** 2).sum(-1)
    bad = ids.clone()
    bad[1, 2] = (bad[1, 2] + 1) % 200
    assert reference.dist_gap(x, q, bad, d)[0] > 1e-3
    short = ids.clone()
    short[3, 5] = -1
    assert reference.dist_gap(x, q, short, d) == (
        reference.dist_gap(x, q, ids, d)[0], 1)
    out = ids.clone()
    out[0, 0] = 999
    assert reference.dist_gap(x, q, out, d)[0] == float("inf")


def test_recall_hits():
    truth = np.array([[1, 2, 3, 4], [5, 6, 7, 8]])
    found = np.array([[4, 3, 9, -1], [-1, -1, -1, -1]])
    np.testing.assert_allclose(reference.recall_hits(found, truth), [0.5, 0])


def test_write_log_replays_the_live_set():
    rng = np.random.default_rng(3)
    n_base, setup_ins, setup_del = 50, 20, 10
    ins_due = np.arange(30) / 10.0
    del_due = np.arange(25) / 10.0
    dels = reference.draw_deletes(rng, n_base, setup_ins, setup_del,
                                  ins_due, del_due)
    assert len(set(dels.tolist())) == dels.size == setup_del + 25
    assert (dels[:setup_del] < n_base + setup_ins).all()
    for j, t in enumerate(del_due):
        # a window delete only takes an id live by its due time
        n_ins = setup_ins + int((ins_due <= t).sum())
        assert dels[setup_del + j] < n_base + n_ins
    log = reference.WriteLog(n_base, setup_ins + 30, dels)
    live = log.live(setup_ins + 5, setup_del + 3)
    want = np.zeros(n_base + setup_ins + 30, bool)
    want[:n_base + setup_ins + 5] = True
    want[dels[:setup_del + 3]] = False
    np.testing.assert_array_equal(live, want)
    assert live.sum() == n_base + setup_ins + 5 - setup_del - 3
