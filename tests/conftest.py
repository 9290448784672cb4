import os
import sys

# Tests and benches must see the real single-device CPU backend; only
# launch/dryrun.py sets xla_force_host_platform_device_count (see spec).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import numpy as np
import pytest

from repro.core import IndexConfig, build_index, ground_truth
from repro.data import make_dataset


@pytest.fixture(scope="session")
def unit_data():
    x, q, spec = make_dataset("unit")
    gt10 = ground_truth(x, q, 10)
    return x, q, gt10


@pytest.fixture(scope="session")
def rairs_index(unit_data):
    x, _, _ = unit_data
    cfg = IndexConfig(nlist=64, strategy="rair", seil=True,
                      kmeans_iters=8, pq_iters=6)
    return build_index(jax.random.PRNGKey(0), x, cfg)


@pytest.fixture(scope="session")
def shared_trained(unit_data):
    """centroids+codebook trained once and shared across strategy builds."""
    x, _, _ = unit_data
    cfg = IndexConfig(nlist=64, kmeans_iters=8, pq_iters=6)
    idx = build_index(jax.random.PRNGKey(0), x, cfg)
    return idx.centroids, idx.codebook


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc (skips without them)")
