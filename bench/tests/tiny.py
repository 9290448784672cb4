"""A tiny copy of the benchmark's cells for the CPU tests: the real
manifest, configuration and traffic files, cut to a size a test run holds
and written into a temporary checkout."""
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

DATA = dict(n=3000, d=16, n_queries=256, latent=8, n_components=8)
INDEX = dict(nlist=16, m_pq=8, kmeans_iters=4, pq_iters=4)
NPROBE = 4
# recall at this size reads 0.97-0.99 at NPROBE and 0.83-0.89 at one list
LIMITS = dict(recall_at_10=0.93)
TRAFFIC = {
    "batch1024": dict(batch=32, search={"exec_mode": "paged",
                                        "batch_buckets": [32]}),
    "churn": dict(batch=32, search={"exec_mode": "paged",
                                    "batch_buckets": [32]},
                  writes=dict(setup_inserts=600, setup_deletes=200,
                              insert_chunk=256, insert_per_s=400,
                              delete_per_s=400)),
    "zipf-b64-reuse": dict(batch=16, search={
        "exec_mode": "clustered", "plan_reuse": True, "batch_buckets": [16]}),
}


def write_tiny(root: Path) -> Path:
    """The benchmark's cells at the tiny size under ``root``."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "bench" / "configs").mkdir(parents=True, exist_ok=True)
    (root / "bench" / "traffic").mkdir(parents=True, exist_ok=True)
    (root / "bench" / "limits").mkdir(parents=True, exist_ok=True)
    for c in manifest["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["data"].update(DATA)
        cfg["index"].update(INDEX)
        cfg["search"]["nprobe"] = NPROBE
        (root / c["file"]).write_text(json.dumps(cfg))
    for w in manifest["workloads"]:
        name = w["traffic"]
        tr = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
        tr.update(TRAFFIC[name], warm_s=0.05)
        if tr["queries"]["kind"] == "zipf":
            tr["queries"]["length"] = 512
        (root / "bench" / "traffic" / f"{name}.json").write_text(
            json.dumps(tr))
        write_limits(root, w["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def write_limits(root: Path, cell: str) -> None:
    """The cell's limits file, with the tiny size's recall limit."""
    (root / "bench" / "limits" / f"{cell}.json").write_text(
        json.dumps({"limits": LIMITS}))
