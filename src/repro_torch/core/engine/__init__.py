"""Staged ANN query engine of the port:

    select_lists  -> ListSelection   centroid top-nprobe
    plan_blocks   -> QueryPlan       cell-level dedup + budget compaction
    scan_blocks   -> ScanOut         ADC scan (K1), paged|grouped|clustered
    scan_blocks_topk -> ScanOut      fused scan -> top-fetch (K3)
    finalize_candidates              top-bigK + id-dedup + exact refine
"""
from .cluster import (CLUSTER_DEPTH, EXTEND_SLACK,  # noqa: F401
                      cluster_order, fit_tile, merge_unions_host, plan_width,
                      tile_signatures, tile_unions, union_dims, union_live,
                      width_buckets)
from .finalize import finalize_candidates, preselect_candidates  # noqa: F401
from .fused import (fused_scan_args, plan_slot_maps,  # noqa: F401
                    scan_blocks_topk)
from .plan import compact_plan, gather_candidates, plan_blocks  # noqa: F401
from .scan import EXEC_MODES, batch_union, scan_blocks  # noqa: F401
from .select import rank_table, select_lists  # noqa: F401
from .types import (BIG, BlockStore, ListSelection, ListTables,  # noqa: F401
                    PlanProbe, QueryPlan, ScanOut, store_from_arrays,
                    tables_from_arrays)
