"""RAIRS core of the port: k-means IVF training, product quantization,
AIR-metric assignment, the SEIL layout, the staged searcher, the dense
(product) scoring path, streaming (a mutable index over a frozen base),
sharding (one index over a mesh of shards) and index persistence."""
from .assign import (STRATEGY_REGISTRY, air_skip_fraction,  # noqa: F401
                     available_strategies, candidate_lists, get_strategy,
                     rair_assign, rair_assign_multi, register_strategy,
                     single_assign)
from .dense import (DenseAux, dense_search, dense_search_multi,  # noqa: F401
                    make_dense_aux)
from .distributed import build_serve_step, distributed_search  # noqa: F401
from .index import (IndexConfig, RairsIndex, build_index,  # noqa: F401
                    insert_batch)
from .io import (CHECKSUM_FORMAT_VERSION, INDEX_FORMAT,  # noqa: F401
                 INDEX_FORMAT_VERSION, PLANE_FORMAT_VERSION,
                 SHARDED_FORMAT_VERSION, load_index, read_index_meta,
                 save_index)
from .kmeans import (kmeans_fit, kmeans_loop,  # noqa: F401
                     kmeans_step_sharded, pairwise_sq_l2, segment_sum)
from .metrics import (dco_summary, ground_truth,  # noqa: F401
                      per_query_recall, recall_at_k)
from .params import (MAX_AUTO_BUCKET, RefineParams,  # noqa: F401
                     SearchParams)
from .pq import (PQCodebook, pq_adc, pq_decode, pq_encode,  # noqa: F401
                 pq_lut, pq_lut_ip, pq_train)
from .search import SearchResult, finalize_fetch, seil_search  # noqa: F401
from .searcher import PlanStats, Searcher, SearcherStats  # noqa: F401
from .seil import (SeilArrays, SeilStats, build_id_map,  # noqa: F401
                   build_seil, build_seil_call_count, cell_stats,
                   delete_ids, vectors_in_large_cells)
from .sharded import (Mesh, ShardedIndex, ShardedSearcher,  # noqa: F401
                      make_mesh)
from .stream import DeltaInputs, DeltaSegment, delta_adc  # noqa: F401
from .stream.streaming import (PendingCompaction,  # noqa: F401
                               StaleSessionError, StreamConfig,
                               StreamingIndex, StreamingSearcher,
                               StreamStats)
