"""RAIRS core of the port: k-means IVF training, product quantization,
AIR-metric assignment, the SEIL layout and the staged searcher."""
from .assign import (STRATEGY_REGISTRY, available_strategies,  # noqa: F401
                     candidate_lists, get_strategy, rair_assign,
                     register_strategy, single_assign)
from .index import IndexConfig, RairsIndex, build_index  # noqa: F401
from .kmeans import kmeans_fit, kmeans_loop, pairwise_sq_l2  # noqa: F401
from .metrics import ground_truth, recall_at_k  # noqa: F401
from .params import (MAX_AUTO_BUCKET, RefineParams,  # noqa: F401
                     SearchParams)
from .pq import PQCodebook, pq_encode, pq_lut, pq_lut_ip, pq_train  # noqa
from .search import SearchResult, finalize_fetch, seil_search  # noqa: F401
from .searcher import PlanStats, Searcher, SearcherStats  # noqa: F401
from .seil import SeilArrays, SeilStats, build_seil  # noqa: F401
