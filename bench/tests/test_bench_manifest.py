"""``BENCHMARK.json`` against the contract's shape, and the harness's
imports."""
import json
import re
import subprocess
import sys

import pytest

import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["paths"] == ["bench"]
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    for w in MANIFEST["command"]:
        assert not w.startswith("/") and ".." not in w


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_names_units_and_readers(m):
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if "bound" in m else {"layer", "moves"})
    assert set(m) - {"workloads"} == keys
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert (tiny.BENCH / "metrics" / f"{m['name']}.py").exists()
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        e2e = {e["name"]: e for e in MANIFEST["end_to_end"]}
        assert m["moves"] in e2e
        # every cell that reports this metric reports what it moves
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= moved
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("w", MANIFEST["workloads"],
                         ids=[w["name"] for w in MANIFEST["workloads"]])
def test_cells_find_their_files(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    conf = {c["name"]: c for c in MANIFEST["configs"]}[w["config"]]
    assert conf["file"].startswith("bench/configs/")
    assert (tiny.ROOT / conf["file"]).exists()
    assert (tiny.BENCH / "traffic" / f"{w['traffic']}.json").exists()
    limits = json.loads((tiny.BENCH / "limits" / f"{w['name']}.json"
                         ).read_text())["limits"]
    assert 0 < limits["recall_at_10"] < 1
    e2e = [m for m in MANIFEST["end_to_end"]
           if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(w["name"] in m.get("workloads", ())
               for m in MANIFEST["per_layer"])


def test_configs_name_their_cuts():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for text in (c["why"], c["source"]):
            assert 1 <= len(text) <= 200 and not set(text) & {"\n", "\t"}
        assert NAME.match(c["name"]) and all(map(NAME.match, c["reduced"]))
        cfg = json.loads((tiny.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg) and len(c["reduced"]) <= 16
        assert set(c["reduced"]) <= set(cfg["assumed"])


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    import harness
    root = tiny.write_tiny(tmp_path)
    m = json.loads((root / "BENCHMARK.json").read_text())
    (root / "bench" / "traffic" / "batch64.json").write_text(json.dumps(
        dict(json.loads((root / "bench" / "traffic" /
                         "batch1024.json").read_text()), batch=64)))
    m["workloads"].append({"name": "sift1m-rairs.batch64",
                           "config": "sift1m-rairs", "traffic": "batch64",
                           "chips": 1, "why": "a later cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    with pytest.raises(FileNotFoundError):        # no limits of its own
        harness.load_cell(root, "sift1m-rairs.batch64")
    tiny.write_limits(root, "sift1m-rairs.batch64")
    spec = harness.load_cell(root, "sift1m-rairs.batch64")
    assert spec.traffic["batch"] == 64
    assert spec.config["index"]["nlist"] == tiny.INDEX["nlist"]
    # it reports setup_s, and the per-layer metrics listed for all cells
    # only where they say so
    assert {m["name"] for m in spec.end_to_end} == {"setup_s"}
    assert spec.per_layer == []


_PROBE = """
import sys
sys.path[:0] = [{bench!r}, {src!r}]
top = lambda: sorted({{m.split(".")[0] for m in sys.modules}})
import reference
print(top())
import harness, judge, datagen, devtrace, roofline, run, control
import repro_torch.core, repro_torch.obs
for f in sorted((harness.BENCH / "metrics").glob("*.py")):
    harness.reader(f.stem)
print(top())
"""


def test_imports_load_no_jax_nor_the_jax_package():
    """The reference loads nothing of the program; the harness, its
    scripts and every metric reader load neither JAX nor the JAX package
    (top-level names compared whole: ``repro_torch`` is not ``repro``)."""
    code = _PROBE.format(bench=str(tiny.BENCH), src=str(tiny.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    ref, everything = (set(eval(line)) for line in out.strip().splitlines())
    jax = {"jax", "jaxlib", "flax", "repro"}
    assert not ref & (jax | {"repro_torch"})
    assert not everything & jax
