"""Carry a built index across from numpy arrays.

``index_from_numpy`` takes an index as plain numpy arrays under the
member names of the reference's index bundle (``block_codes``,
``block_ids``, ``block_other``, ``owned``, ``refs``, ``refs_other``,
``misc``, ``centroids``, ``codebooks``, ``vectors``, ``assigns`` and
optionally ``codes``) plus its config as a dict, and returns the port's
``RairsIndex`` on ``device``.  The storage statistics are derived from
the arrays, so nothing beyond the bundle's arrays is needed.

``lm_params_from_numpy``, ``lm_cache_from_numpy`` and
``knn_cache_from_numpy`` carry the LM side across: the reference's
params or caches as nested dicts of numpy arrays (bf16 arrays as numpy
``bfloat16``, a ``MambaState`` as an ``(h, conv)`` pair), keyed and
period-stacked as the port's functional core takes them.
``opt_state_from_numpy`` carries the reference's AdamW state across.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.index import IndexConfig, RairsIndex
from .core.pq import PQCodebook
from .core.seil import SEIL_FIELDS, SeilStats, arrays_to_device
from .device import DeviceLike, resolve_device
from .models.mamba2 import MambaState
from .models.transformer import SERVE_CAST
from .optim.adamw import OptState


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


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bf16, bit for bit
        return torch.from_numpy(np.array(a.view(np.uint16))).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def lm_params_from_numpy(tree, device: DeviceLike = None, serve_dtype=None):
    """The reference's LM params (nested dict of numpy arrays) as the
    port's tree on ``device``; with ``serve_dtype`` the leaves in
    ``models.transformer.SERVE_CAST`` are cast to it (the others stay
    f32)."""
    dev = resolve_device(device)

    def conv(t, key):
        if isinstance(t, dict):
            return {k: conv(v, k) for k, v in t.items()}
        x = _tensor(t, dev)
        return x.to(serve_dtype) if serve_dtype is not None \
            and key in SERVE_CAST else x
    return conv(tree, None)


def opt_state_from_numpy(state, device: DeviceLike = None) -> OptState:
    """The reference's ``OptState`` (its ``mu`` / ``nu`` trees and
    ``step``, as numpy arrays, in field order) as the port's on
    ``device``."""
    dev = resolve_device(device)
    mu, nu, step = state
    return OptState(mu=lm_params_from_numpy(mu, dev),
                    nu=lm_params_from_numpy(nu, dev),
                    step=_tensor(step, dev))


def lm_cache_from_numpy(cfg, cache, device: DeviceLike = None):
    """The reference's decode cache (``{"blocks": {s_j: (k, v) or (h,
    conv)}, "len"}``) on ``device``; ``cfg.slot_kinds()`` tells the
    attention pairs from the Mamba states."""
    dev = resolve_device(device)
    blocks = {}
    for j, (mixer, _) in enumerate(cfg.slot_kinds()):
        a, b = cache["blocks"][f"s{j}"]
        pair = (_tensor(a, dev), _tensor(b, dev))
        blocks[f"s{j}"] = pair if mixer == "attn" else MambaState(*pair)
    return {"blocks": blocks, "len": _tensor(cache["len"], dev)}


def knn_cache_from_numpy(slot, device: DeviceLike = None):
    """A RAIRS-kNN slot cache (a dict of numpy arrays) on ``device``.
    A whole long-context cache is taken too: dicts are walked, and a
    pair is a Mamba state."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return MambaState(*(conv(v) for v in t))
        return _tensor(t, dev)
    return conv(slot)
