"""The traffic files as the generator reads them: every seed sends the same
queries in another order, and a stream's window stays inside the capacity
its set-up captured graphs for."""
import json

import numpy as np
import pytest

import tiny
import harness

MANIFEST = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
POOL = np.random.default_rng(0).normal(size=(300, 8)).astype(np.float32)
KINDS = [{"kind": "cycle"},
         {"kind": "zipf", "a": 1.1, "jitter": 0.02, "length": 640,
          "rank_seed": 3}]


def _sent(spec, seed, batch=32, n=None):
    qs = harness.Queries(spec, POOL, batch, seed)
    n = n or (spec.get("length", POOL.shape[0] * batch) // batch)
    rows = [qs.batch(j)[0] for j in range(n)]
    return np.concatenate(rows)


@pytest.mark.parametrize("spec", KINDS, ids=[k["kind"] for k in KINDS])
def test_every_seed_sends_the_same_queries(spec):
    a, b = _sent(spec, 1), _sent(spec, 2 ** 31 + 7)
    assert not np.array_equal(a, b)             # another order
    key = lambda r: np.lexsort(r.T[::-1])      # noqa: E731
    np.testing.assert_array_equal(a[key(a)], b[key(b)])


def test_zipf_keys_rebuild_the_rows_sent():
    qs = harness.Queries(KINDS[1], POOL, 32, 5)
    for j in (0, 7, 19, 20):
        q, keys = qs.batch(j)
        np.testing.assert_array_equal(qs.exact(keys), q)


@pytest.mark.parametrize("w", [w for w in MANIFEST["workloads"]
                               if "writes" in json.loads(
                                   (tiny.BENCH / "traffic" /
                                    f"{w['traffic']}.json").read_text())],
                         ids=lambda w: w["name"])
def test_a_window_of_writes_stays_in_its_capacity_bucket(w):
    """Set-up's inserts and a whole window's stay under the next
    power-of-two bucket above set-up's, so no capacity jump (and no
    capture) falls in the window."""
    tr = json.loads((tiny.BENCH / "traffic" / f"{w['traffic']}.json"
                     ).read_text())["writes"]
    setup = tr["setup_inserts"]
    cap = 1 << int(np.ceil(np.log2(setup)))
    end = setup + int(tr["insert_per_s"] * MANIFEST["run_seconds"]) + 1
    assert end <= cap
