"""A run with the timed path broken underneath must come out not correct,
and so must the control; a sound run must come out correct.

Each test drives the whole of a tiny run on the CPU (the harness's look
for a card is the only part skipped), with the program patched where it
produces answers or takes writes."""
import time

import pytest
import torch

import tiny
import harness
import judge

CACHE = {}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write_tiny(tmp_path_factory.mktemp("tiny"))


def _run(root, cell, seed=7):
    spec = harness.load_cell(root, cell)
    return harness.run_cell(spec, seed, 0.15, False, "cpu",
                            time.perf_counter(), cache=CACHE)


def _patch_answers(monkeypatch, alter):
    from repro_torch.core.search import SearchResult
    from repro_torch.core.searcher import Searcher
    call = Searcher.__call__

    def broken(self, queries):
        r = call(self, queries)
        ids, dists = alter(r.ids.clone(), r.dists.clone())
        return SearchResult(ids, dists, *r[2:])
    monkeypatch.setattr(Searcher, "__call__", broken)


def _altered(ids, dists):
    """One answer's first id replaced where it is produced."""
    ids[0, 0] = (ids[0, 0] + 1) % 3000
    return ids, dists


def _half(ids, dists):
    """Half of the batch left out: its rows repeat the other half's."""
    h = (ids.shape[0] + 1) // 2
    ids[h:], dists[h:] = ids[:ids.shape[0] - h], dists[:ids.shape[0] - h]
    return ids, dists


CELLS = ["sift1m-rairs.batch1024", "sift1m-rairs-stream.churn",
         "sift1m-rairs.zipf-b64-reuse"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_control_is_not(root, cell):
    run = _run(root, cell)
    v = judge.judge(run)
    assert v.correct, v.checks
    c = judge.judge(run, control=True)
    assert not c.correct and not c.checks["dist_gap"]["ok"], c.checks


@pytest.mark.parametrize("fault", [_altered, _half],
                         ids=["answer_altered", "half_batch_left_out"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_answers_are_not_correct(root, cell, fault, monkeypatch):
    _patch_answers(monkeypatch, fault)
    assert not judge.judge(_run(root, cell)).correct


@pytest.mark.parametrize("what", ["insert", "delete"])
def test_stream_state_left_unchanged_is_not_correct(root, what,
                                                    monkeypatch):
    from repro_torch.core.stream.streaming import StreamingIndex
    if what == "insert":
        insert = StreamingIndex.insert

        def unsearched(self, x):      # acknowledged, never searchable
            ids = insert(self, x)
            self._mask_device(ids, ids - self.n_base)
            return ids
        monkeypatch.setattr(StreamingIndex, "insert", unsearched)
    else:
        monkeypatch.setattr(StreamingIndex, "delete", lambda self, ids: 0)
    v = judge.judge(_run(root, "sift1m-rairs-stream.churn"))
    assert not v.correct
    bad = {k for k, c in v.checks.items() if not c["ok"]}
    assert bad & ({"readback", "dist_gap"} if what == "insert"
                  else {"dead"}), v.checks


def test_the_reference_rebuilds_the_inputs(root):
    run = _run(root, "sift1m-rairs-stream.churn", seed=2 ** 31 + 5)
    ref = judge.rebuild(run)
    assert ref.x.shape[0] == tiny.DATA["n"] + run.inp.writes.n_inserts
    run.inp.x_sum += 1
    with pytest.raises(RuntimeError):
        judge.rebuild(run)
    assert torch.isfinite(ref.x).all()


@pytest.mark.parametrize("cell", CELLS)
def test_fewer_lists_probed_is_not_correct(root, cell):
    """A scan that drops candidates (one list probed of the configuration's
    four) fails the recall limit, as the control's nprobe faults do."""
    import control
    spec = control.with_nprobe(harness.load_cell(root, cell), 1)
    run = harness.run_cell(spec, 11, 0.15, False, "cpu",
                           time.perf_counter(), cache=CACHE)
    v = judge.judge(run)
    assert not v.correct and not v.checks["recall"]["ok"], v.checks
    assert v.checks["dist_gap"]["ok"], v.checks
