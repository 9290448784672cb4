"""The paper's own workload: RAIRS ANN serving at production scale.

SIFT1B-like: 1B vectors, D=128, nlist=32768 (paper §6.1), PQ M=64
nbits=4, sharded over the ("pod","data") axes; a serve step scores a
query batch (centroid top-nprobe -> SEIL block scan -> refine)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class RairsServeConfig:
    name: str = "rairs-sift1b"
    n_vectors: int = 1_000_000_000
    d: int = 128
    nlist: int = 32768
    m_pq: int = 64
    block: int = 128          # TPU-native block (lane width)
    nprobe: int = 64
    k: int = 10
    k_factor: int = 10
    query_batch: int = 4096
    max_scan_blocks: int = 4096   # per-query static scan budget


CONFIG = RairsServeConfig()
