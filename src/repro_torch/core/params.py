"""SearchParams — the frozen, validated query-side parameter object.

The same fields and validation as the reference (``repro/core/params.py``),
so one params object works in both packages.  ``max_scan=None`` means
"derive the per-query block budget from the index"; ``resolve`` pins it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .engine import EXEC_MODES

# default pad-and-dispatch buckets: powers of two up to this cap; larger
# batches are chunked
MAX_AUTO_BUCKET = 1024

REFINE_PLANES = ("pq4", "binary", "full")


@dataclasses.dataclass(frozen=True)
class RefineParams:
    """Two-tier scan knobs (quantization ladder): tier 1 scans the
    compact ``plane`` ("pq4" | "binary"; "full" keeps the full plane and
    only widens) and keeps ``bigk * refine_factor`` survivors; tier 2
    re-ranks them exactly."""
    plane: str = "pq4"
    refine_factor: int = 4

    def __post_init__(self):
        if self.plane not in REFINE_PLANES:
            raise ValueError(
                f"plane must be one of {REFINE_PLANES}, got {self.plane!r}")
        if self.refine_factor < 1:
            raise ValueError(
                f"refine_factor must be >= 1, got {self.refine_factor}")


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Validated query parameters (paper Alg. 2 knobs + engine controls).

    k            final neighbours per query
    nprobe       probed lists (Alg. 2 L1)
    k_factor     refinement oversampling: bigK = k * k_factor
    max_scan     per-query block budget (None -> index default)
    exec_mode    "paged" | "grouped" | "clustered"
    use_kernel   kept so one params object serves both packages; in the
                 port it picks nothing: the tensors' device does.  On
                 CUDA the scan always runs the CUDA kernels (K1, and K3
                 with ``fused_topk``); on the CPU their plain versions.
    fused_topk   fuse the scan with the stable top-fetch selection (K3)
    query_tile   grouped/clustered query tile
    plan_reuse   incremental plans (probe -> plan-cache merge -> scan)
    batch_buckets  optional ascending pad-and-dispatch bucket sizes;
                 None -> powers of two up to MAX_AUTO_BUCKET
    refine       two-tier scan over a compact plane (RefineParams)
    """
    k: int = 10
    nprobe: int = 16
    k_factor: int = 10
    max_scan: Optional[int] = None
    exec_mode: str = "paged"
    use_kernel: bool = False
    fused_topk: bool = False
    query_tile: int = 8
    plan_reuse: bool = False
    batch_buckets: Optional[Tuple[int, ...]] = None
    refine: Optional[RefineParams] = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {self.nprobe}")
        if self.k_factor < 1:
            raise ValueError(f"k_factor must be >= 1, got {self.k_factor}")
        if self.max_scan is not None and self.max_scan < 1:
            raise ValueError(f"max_scan must be >= 1 or None, got {self.max_scan}")
        if self.exec_mode not in EXEC_MODES:
            raise ValueError(
                f"exec_mode must be one of {EXEC_MODES}, got {self.exec_mode!r}")
        if self.query_tile < 1:
            raise ValueError(f"query_tile must be >= 1, got {self.query_tile}")
        if self.plan_reuse and self.exec_mode == "paged":
            raise ValueError(
                "plan_reuse needs a union-based exec_mode ('grouped' or "
                "'clustered'); paged scans have no batch union to reuse")
        if self.batch_buckets is not None:
            bb = tuple(int(b) for b in self.batch_buckets)
            if not bb or any(b < 1 for b in bb) or list(bb) != sorted(set(bb)):
                raise ValueError(
                    "batch_buckets must be a non-empty ascending tuple of "
                    f"positive sizes, got {self.batch_buckets!r}")
            object.__setattr__(self, "batch_buckets", bb)
        if self.refine is not None and not isinstance(self.refine,
                                                      RefineParams):
            raise ValueError(
                f"refine must be a RefineParams or None, got "
                f"{self.refine!r}")

    @property
    def bigk(self) -> int:
        return self.k * self.k_factor

    @property
    def bigk_eff(self) -> int:
        """Tier-1 survivor budget: bigK widened by the refine factor."""
        if self.refine is None:
            return self.bigk
        return self.bigk * self.refine.refine_factor

    @property
    def active_plane(self) -> Optional[str]:
        """The compact-plane backend the scan substitutes, or None when
        the program is the plain single-tier one (no refine, the "full"
        widening ablation, or refine_factor=1)."""
        r = self.refine
        if r is None or r.plane == "full" or r.refine_factor == 1:
            return None
        return r.plane

    def resolve(self, index) -> "SearchParams":
        """Pin index-dependent defaults and cross-check against the index."""
        nlist = index.config.nlist
        if self.nprobe > nlist:
            raise ValueError(
                f"nprobe={self.nprobe} exceeds the index's nlist={nlist}")
        if self.max_scan is not None:
            return self
        return dataclasses.replace(
            self, max_scan=index.default_max_scan(self.nprobe))

    def bucket_for(self, batch: int) -> int:
        """Smallest dispatch bucket that fits `batch` (after chunking)."""
        if self.batch_buckets is not None:
            for b in self.batch_buckets:
                if b >= batch:
                    return b
            return self.batch_buckets[-1]
        if batch >= MAX_AUTO_BUCKET:
            return MAX_AUTO_BUCKET
        b = 1
        while b < batch:
            b *= 2
        return b

    @property
    def max_chunk(self) -> int:
        """Largest batch a single dispatch handles; bigger batches chunk."""
        if self.batch_buckets is not None:
            return self.batch_buckets[-1]
        return MAX_AUTO_BUCKET
