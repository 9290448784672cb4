"""The judgement of a run: the plain reference, run once the window has
closed and the program is freed, over inputs it rebuilds from the seed.

It compares every answer the window's traffic got (and a stream's
read-back batches) with exact search over the vectors live when the answer
was given, and returns the numbers compared, each beside its limit:

* ``dist_gap``: the largest gap between a returned distance and the exact
  float64 distance of the returned id, over ``|q|^2 + |x|^2``;
* ``recall``: mean recall@k of the window's answers against the exact
  top-k, held to the cell's limit (``bench/limits/<cell>.json``), which
  lies between the sound runs' readings and those of a scan that drops
  candidates, the program at half its nprobe (PERF.md);
* ``short``: answers with fewer than k ids (exact: 0);
* a stream's guarantees, exact: ``dead`` (a deleted id returned), ``ack``
  (an insert acknowledged under another id than the next in order),
  ``readback`` (an acknowledged insert not found first by its own vector).

``control=True`` judges instead the reference itself computed one
precision lower (TF32 matmuls), put in the program's place.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List

import numpy as np
import torch

import datagen
import reference

BLOCK = 2048          # queries per block of the reference's search
GAP_BLOCK = 32768     # answers per block of the distance check


def rebuild(run) -> SimpleNamespace:
    """The run's corpus, query rows and inserts, made again from the
    seed and held to the checksums taken in set-up."""
    import harness
    data, dev = run.spec.config["data"], run.dev
    mix, x = datagen.corpus(data, dev)
    pool = datagen.queries(data, x)
    if datagen.checksum(x) != run.inp.x_sum or \
            datagen.checksum(pool) != run.inp.pool_sum:
        raise RuntimeError("the corpus or the queries came out differently "
                           "when made again from the seed")
    tr = run.spec.traffic
    queries = harness.Queries(tr["queries"], pool.cpu().numpy(),
                              int(tr.get("batch", 1)), run.seed)
    out = SimpleNamespace(x=x, queries=queries, n_base=x.shape[0])
    if run.inp.writes is not None:
        ins = datagen.inserts(data, mix, run.seed, run.inp.writes.n_inserts)
        if datagen.checksum(ins) != run.inp.ins_sum:
            raise RuntimeError("the inserts came out differently when made "
                               "again from the seed")
        out.x = torch.cat([x, ins])
    return out


def _rows(ref, keys: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        ref.queries.exact(keys), np.float32)).to(ref.x.device)


def _topk(x, q, k, live=None, tf32=False):
    ids, d = [], []
    for s in range(0, q.shape[0], BLOCK):
        i, dd = reference.exact_topk(x, q[s:s + BLOCK], k, live=live,
                                     tf32=tf32)
        ids.append(i)
        d.append(dd)
    return torch.cat(ids), torch.cat(d)


class Tally:
    """Running maxima and counts over groups of judged answers."""

    def __init__(self):
        self.gap, self.short, self.dead = 0.0, 0, 0
        self.hits: List[np.ndarray] = []

    def add(self, x, q, ids, dists, truth=None, live=None, inv=None):
        """``q`` (n, d) on the device, or with ``inv`` its unique rows
        and the row of each answer; ``ids`` / ``dists`` (n, k) host
        arrays; ``truth`` (n, k) exact ids for recall, or None."""
        for s in range(0, ids.shape[0], GAP_BLOCK):
            qs = (q[s:s + GAP_BLOCK] if inv is None else q[torch.from_numpy(
                inv[s:s + GAP_BLOCK]).to(q.device)])
            g, sh = reference.dist_gap(
                x, qs,
                torch.from_numpy(ids[s:s + GAP_BLOCK].astype(np.int64)),
                torch.from_numpy(dists[s:s + GAP_BLOCK]))
            self.gap = max(self.gap, g)
            self.short += sh
        if live is not None:
            valid = ids >= 0
            inside = np.where(valid & (ids < live.size), ids, 0)
            self.dead += int((valid & ((ids >= live.size)
                                       | ~live[inside])).sum())
        if truth is not None:
            self.hits.append(reference.recall_hits(ids, truth))


def judge(run, control: bool = False) -> SimpleNamespace:
    """Judge ``run`` (the program's answers, or with ``control`` the
    reference's at TF32); returns ``recall`` (the window's mean),
    ``checks`` (name -> value, limit, pass) and ``correct``."""
    ref = rebuild(run)
    tally = Tally()
    extra = {}
    if run.inp.writes is None:
        _frozen(run, ref, tally, control)
    else:
        extra = _stream(run, ref, tally, control)
    recall = (float(np.concatenate(tally.hits).mean()) if tally.hits
              else float("nan"))
    lim = run.spec.limits
    checks = {
        "dist_gap": (tally.gap, lim["dist_gap"], "<="),
        "recall": (recall, lim["recall_at_10"], ">="),
        "short": (tally.short, 0, "<="),
    }
    if run.inp.writes is not None:
        checks["dead"] = (tally.dead, 0, "<=")
    checks.update(extra)
    out = {}
    for name, (v, limit, how) in checks.items():
        ok = (v <= limit) if how == "<=" else (v >= limit)
        out[name] = {"value": v, "limit": limit, "pass": how,
                     "ok": bool(ok)}
    return SimpleNamespace(recall=recall, checks=out,
                           correct=all(c["ok"] for c in out.values()))


def _frozen(run, ref, tally, control):
    k = run.spec.config["search"]["k"]
    keys, ids, dists = (np.concatenate(a) for a in (
        run.rec.keys, run.rec.ids, run.rec.dists))
    uniq, inv = np.unique(keys, return_inverse=True)
    q = _rows(ref, uniq)
    truth = _topk(ref.x, q, k)[0].cpu().numpy()
    if control:
        ci, cd = _topk(ref.x, q, k, tf32=True)
        ids, dists = ci.cpu().numpy()[inv], cd.cpu().numpy()[inv]
    tally.add(ref.x, q, ids, dists, truth=truth[inv], inv=inv)


def _stream(run, ref, tally, control):
    rec, w = run.rec, run.inp.writes
    k = run.spec.config["search"]["k"]
    log = w.log()
    for b in range(len(rec)):
        live = log.live(*rec.applied[b])
        lt = torch.from_numpy(live).to(ref.x.device)
        q = _rows(ref, rec.keys[b])
        truth = _topk(ref.x, q, k, live=lt)[0].cpu().numpy()
        ids, dists = rec.ids[b], rec.dists[b]
        if control:
            ci, cd = _topk(ref.x, q, k, live=lt, tf32=True)
            ids, dists = ci.cpu().numpy(), cd.cpu().numpy()
        tally.add(ref.x, q, ids, dists, truth=truth, live=live)
    rb = run.readback
    live = log.live(*w.applied)
    lt = torch.from_numpy(live).to(ref.x.device)
    miss = 0
    for name, ids_q in (("ins", rb.ins_ids), ("del", rb.del_ids)):
        q = ref.x[torch.from_numpy(ids_q.astype(np.int64)).to(ref.x.device)]
        ids, dists = getattr(rb, name)
        if control:
            ci, cd = _topk(ref.x, q, k, live=lt, tf32=True)
            ids, dists = ci.cpu().numpy(), cd.cpu().numpy()
        tally.add(ref.x, q, ids, dists, live=live)
        if name == "ins":
            miss = int((ids[:, 0] != ids_q).sum())
    return {"ack": (w.ack_mismatch, 0, "<="),
            "readback": (miss, 0, "<=")}

