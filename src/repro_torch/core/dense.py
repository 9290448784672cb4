"""Dense (GEMM) scoring path (counterpart of ``repro/core/dense.py``):
the same answers and DCO accounting as the blocked SEIL scan, scored as
one product against the decoded items.

With ``by_residual=False`` the ADC estimate ``sum_m LUT[m, code_m]``
equals the exact squared distance to the PQ-decoded vector, so scoring
every *stored item* against a query batch is one product with the
decoded item matrix, and SEIL semantics (which blocks are scanned,
cell-level dedup, misc-item dedup, DCO counts) reduce to per-item masks:

  * a shared full block of cell_{i,j} is scanned iff i or j is probed,
    at effective rank min(rank_i, rank_j) — exactly once (Alg. 5);
  * a misc/owned block is scanned iff its home list is probed;
  * a misc item with co-assigned list o is discarded (after counting its
    DCO) iff rank(o) < scan rank of its block.

The product stays a ``torch.matmul`` (full f32: the package turns TF32
off); the masks and ``finalize_candidates`` are plain PyTorch.  The
blocked path (search.py) remains the deployment layout.

Memory: a chunk of B queries holds a few (B, TB*BLK) tensors at once
(scores, ranks, masks) and ``finalize_candidates`` sorts whole rows, so
``chunk`` bounds the peak (about 8 tensors of B x TB*BLK x 4 bytes).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from .engine import BIG, finalize_candidates
from .engine.select import rank_table
from .kmeans import pairwise_sq_l2
from .pq import PQCodebook
from .search import SearchResult
from .seil import SeilArrays


@dataclasses.dataclass
class DenseAux:
    dec: torch.Tensor          # (TB*BLK, D) decoded items (0 where invalid)
    dec_norm2: torch.Tensor    # (TB*BLK,)
    ids: torch.Tensor          # (TB*BLK,) int32, -1 invalid
    other: torch.Tensor        # (TB*BLK,) int32 co-assigned list, -1 none
    block_l1: torch.Tensor     # (TB,) home list, -1 unused block
    block_l2: torch.Tensor     # (TB,) co-list for shared full blocks, -1 else


def _block_lists(owned: np.ndarray, misc: np.ndarray, bo: np.ndarray,
                 tb: int):
    """(block_l1, block_l2) as the reference's loop over lists writes
    them: list by list, its owned blocks then its misc blocks, each visit
    setting the block's home list (the last visit wins); an owned block
    whose items carry a co-assigned list takes the first one as its
    co-list."""
    nlist = owned.shape[0]
    lists = np.broadcast_to(np.arange(nlist, dtype=np.int32)[:, None],
                            (nlist, owned.shape[1] + misc.shape[1]))
    blocks = np.concatenate([owned, misc], axis=1)       # visit order
    ok = blocks >= 0
    vb, vl = blocks[ok][::-1], lists[ok][::-1]
    uniq, last = np.unique(vb, return_index=True)        # last visit wins
    block_l1 = np.full(tb, -1, np.int32)
    block_l1[uniq] = vl[last]
    block_l2 = np.full(tb, -1, np.int32)
    ob = owned[owned >= 0]
    valid = bo[ob] >= 0                                  # (n_owned, BLK)
    has = valid.any(axis=1)
    first = valid.argmax(axis=1)
    block_l2[ob[has]] = bo[ob[has], first[has]]
    return block_l1, block_l2


def make_dense_aux(arrays: SeilArrays, codebook: PQCodebook) -> DenseAux:
    """The decoded items and their block metadata, built on the host in
    numpy as the reference builds them (so the arrays are bitwise the
    reference's) and moved to the arrays' device."""
    dev = arrays.block_codes.device
    tb, blk, m = arrays.block_codes.shape
    codes = arrays.block_codes.cpu().numpy().reshape(tb * blk, m)
    books = codebook.codebooks.cpu().numpy()
    dec = books[np.arange(m)[None, :], codes].reshape(tb * blk, -1)
    ids = arrays.block_ids.cpu().numpy().reshape(-1)
    dec[ids < 0] = 0.0
    bo = arrays.block_other.cpu().numpy()
    block_l1, block_l2 = _block_lists(arrays.owned.cpu().numpy(),
                                      arrays.misc.cpu().numpy(), bo, tb)
    return DenseAux(
        dec=torch.from_numpy(dec).to(dev),
        dec_norm2=torch.from_numpy((dec * dec).sum(-1)).to(dev),
        ids=torch.from_numpy(ids).to(dev),
        other=torch.from_numpy(bo.reshape(-1)).to(dev),
        block_l1=torch.from_numpy(block_l1).to(dev),
        block_l2=torch.from_numpy(block_l2).to(dev),
    )


def _ranks(rank_of: torch.Tensor, lists: torch.Tensor) -> torch.Tensor:
    """rank_of[:, lists] where lists >= 0, else BIG."""
    return torch.where(lists >= 0, rank_of[:, lists.clamp_min(0).long()],
                       BIG)


def _dense_chunk(aux: DenseAux, centroids, vectors, queries, *,
                 nprobes: tuple, bigk: int, k: int, metric: str,
                 dedup_results: bool, blk: int, oversample: int = 2):
    bq = queries.shape[0]
    nlist = centroids.shape[0]
    xd = queries @ aux.dec.T                                 # (B, TB*BLK)
    if metric == "l2":
        # q2 - 2 q.dec + |dec|^2, in place on the product
        scores = xd.mul_(-2.0).add_((queries * queries).sum(-1)[:, None]) \
            .add_(aux.dec_norm2[None, :])
        cd = pairwise_sq_l2(queries, centroids)
    else:
        scores = xd.neg_()
        cd = -(queries @ centroids.T)
    pmax = max(nprobes)
    # the stable ascending order: equal distances keep the lower list id
    # first, as lax.top_k of -cd
    sel_full = torch.sort(cd, dim=1, stable=True).indices[:, :pmax] \
        .to(torch.int32)
    item_valid = aux.ids >= 0
    has_other = aux.other >= 0

    outs = []
    for p in nprobes:
        rank_of = rank_table(sel_full[:, :p], nlist)        # (B, nlist)
        scan_rank = torch.minimum(_ranks(rank_of, aux.block_l1),
                                  _ranks(rank_of, aux.block_l2))  # (B, TB)
        scanned = scan_rank < BIG
        computed = scanned.repeat_interleave(blk, dim=1) & item_valid[None, :]
        dup = has_other[None, :] & (
            _ranks(rank_of, aux.other)
            < scan_rank.repeat_interleave(blk, dim=1))
        keep = computed & ~dup
        # each (B, TB*BLK) mask goes as soon as it is used: at 1M items a
        # chunk of 128 holds ~0.2-0.9 GB in each
        del dup
        approx_dco = computed.sum(1).to(torch.int32)
        del computed
        flat_d = torch.where(keep, scores, torch.inf)
        del keep
        out_ids, out_d, refine_dco = finalize_candidates(
            flat_d, aux.ids[None, :].expand(bq, -1), bigk=bigk, k=k,
            vectors=vectors, queries=queries, metric=metric,
            dedup_results=dedup_results, oversample=oversample)
        del flat_d
        outs.append(SearchResult(
            ids=out_ids, dists=out_d, approx_dco=approx_dco,
            refine_dco=refine_dco,
            scanned_blocks=scanned.sum(1).to(torch.int32),
            dropped_blocks=torch.zeros(bq, dtype=torch.int32,
                                       device=queries.device)))
    return tuple(outs)


def dense_search_multi(index, queries, *, nprobes: Sequence[int], k: int,
                       k_factor: int = 10, chunk: int = 128
                       ) -> List[SearchResult]:
    """Score once per chunk, slice per-nprobe — shares the product across
    the whole nprobe sweep (used by benchmark curves).  Runs on the
    index's device; the results are tensors there.  The aux is built on
    first use and kept on the index (``index._dense_aux``), as the
    reference keeps it."""
    if getattr(index, "_dense_aux", None) is None:
        index._dense_aux = make_dense_aux(index.arrays, index.codebook)
    aux = index._dense_aux
    dev = aux.dec.device
    if isinstance(queries, np.ndarray):
        queries = torch.from_numpy(queries)
    queries = queries.to(device=dev, dtype=torch.float32)
    nprobes = tuple(int(p) for p in nprobes)
    bigk = k * k_factor
    nq = queries.shape[0]
    per_probe = [[] for _ in nprobes]
    for s in range(0, nq, chunk):
        outs = _dense_chunk(
            aux, index.centroids, index.vectors, queries[s:s + chunk],
            nprobes=nprobes, bigk=bigk, k=k, metric=index.config.metric,
            dedup_results=index.needs_result_dedup,
            blk=index.arrays.block_size,
            oversample=index.result_oversample)
        for i, r in enumerate(outs):
            per_probe[i].append(r)
    return [SearchResult(*(torch.cat(a) for a in zip(*rs)))
            for rs in per_probe]


def dense_search(index, queries, *, nprobe: int, k: int, k_factor: int = 10,
                 chunk: int = 128) -> SearchResult:
    return dense_search_multi(index, queries, nprobes=(nprobe,), k=k,
                              k_factor=k_factor, chunk=chunk)[0]
