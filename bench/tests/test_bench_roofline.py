"""The scan's least time counted by hand on a tiny layout."""
import pytest
import torch

import tiny  # noqa: F401
import roofline


def test_scan_bytes_counts_each_probed_block_once():
    # 4 lists; -1 pads.  Block 3 is owned by list 0 and referenced by
    # list 2, block 5 sits in list 1's misc and list 3's misc.
    owned = torch.tensor([[0, 3], [1, -1], [2, -1], [4, -1]])
    refs = torch.tensor([[-1], [-1], [3], [-1]])
    misc = torch.tensor([[-1], [5], [-1], [5]])
    probed = torch.tensor([[0, 2], [2, 1]])       # lists 0, 1, 2
    n = roofline.scan_bytes((owned, refs, misc), probed, block=32, m=64,
                            nbits=4, ksub=16, fetch=100)
    blocks = 5                                    # 0, 3, 1, 5, 2
    per_block = 32 * 64 // 2 + 32 * 4             # codes + ids
    tables = 2 * 64 * 16 * 4                      # (B, M, K) f32
    out = 2 * 100 * 8                             # (B, fetch) f32 + int32
    assert n == blocks * per_block + tables + out


def test_least_time_takes_the_larger_bound():
    assert roofline.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)


def test_probed_lists_are_the_nearest_centroids():
    c = torch.tensor([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0], [5.0, 5.0]])
    q = torch.tensor([[9.0, 1.0], [1.0, 8.0]])
    got = roofline.probed_lists(c, q, 2)
    assert [sorted(r) for r in got.tolist()] == [[1, 3], [2, 3]]


def test_spread_and_bound():
    assert roofline.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert roofline.bound_from([0.0001]) == 0.01
    assert roofline.bound_from([0.004, 0.01]) == pytest.approx(0.05)
