"""Carry a built index across from numpy arrays.

``index_from_numpy`` takes an index as plain numpy arrays under the
member names of the reference's index bundle (``block_codes``,
``block_ids``, ``block_other``, ``owned``, ``refs``, ``refs_other``,
``misc``, ``centroids``, ``codebooks``, ``vectors``, ``assigns`` and
optionally ``codes``) plus its config as a dict, and returns the port's
``RairsIndex`` on ``device``.  The storage statistics are derived from
the arrays, so nothing beyond the bundle's arrays is needed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.index import IndexConfig, RairsIndex
from .core.pq import PQCodebook
from .core.seil import SEIL_FIELDS, SeilStats, arrays_to_device
from .device import DeviceLike, resolve_device


def _stats_from(arrays: Dict[str, np.ndarray], cfg: IndexConfig
                ) -> SeilStats:
    ids = np.asarray(arrays["block_ids"])
    refs = np.asarray(arrays["refs"])
    refs_other = np.asarray(arrays["refs_other"])
    misc = np.asarray(arrays["misc"])
    # one reference entry per (home list, referencing list) cell with blocks
    lists, cols = np.nonzero(refs >= 0)
    cells = np.unique(refs_other[lists, cols].astype(np.int64) * cfg.nlist
                      + lists)
    misc_blocks = misc[misc >= 0]
    return SeilStats(
        n_vectors=int(np.asarray(arrays["vectors"]).shape[0]),
        n_items_stored=int((ids >= 0).sum()),
        n_ref_entries=int(len(cells)),
        n_blocks=int(ids.shape[0]),
        n_misc_items=int((ids[misc_blocks] >= 0).sum()),
        code_bytes_per_item=np.asarray(arrays["block_codes"]).shape[2]
        * cfg.nbits / 8.0)


def index_from_numpy(config: dict, arrays: Dict[str, np.ndarray],
                     device: DeviceLike = None) -> RairsIndex:
    """Rebuild the port's index from a config dict and numpy arrays."""
    dev = resolve_device(device)
    cfg = IndexConfig(**config)

    def tensor(name, dtype=None):
        t = torch.from_numpy(np.array(arrays[name]))
        return t.to(device=dev, dtype=dtype)
    codes = arrays.get("codes")
    return RairsIndex(
        config=cfg,
        centroids=tensor("centroids", torch.float32),
        codebook=PQCodebook(tensor("codebooks", torch.float32)),
        arrays=arrays_to_device({f: arrays[f] for f in SEIL_FIELDS}, dev),
        vectors=tensor("vectors", torch.float32),
        stats=_stats_from(arrays, cfg),
        assigns=np.asarray(arrays["assigns"]),
        codes=None if codes is None else np.asarray(codes, np.uint8))
