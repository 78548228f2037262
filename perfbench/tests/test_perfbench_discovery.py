"""Every name in ``BENCHMARK.json`` finds its files; the harness loads no
JAX; the plain references import nothing of the port."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from perfbench.harness import core
from perfbench.harness.trace import reduce_events

ROOT = core.ROOT
BENCH = core.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower",
                                                                                     "higher")
    texts = [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
    texts += [m["layer"] for m in BENCH["per_layer"]] + [c["source"] for c in BENCH["configs"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files(w):
    cell = core.find_cell(BENCH, w["name"])
    assert cell.config["name"] == w["config"]
    for kind, name in (("drivers", cell.traffic["driver"]), ("systems", cell.config["model"]),
                       ("reference", w["config"]), ("flops", w["config"])):
        assert os.path.isfile(os.path.join(core.BENCH_DIR, kind, f"{name}.py")), (kind, name)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
    assert set(cell.traffic["limits"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_a_reader_that_finds_nothing_in_an_empty_record(m):
    assert core.load_part("metrics", m["name"]).read({}) is None


def test_config_files_lie_under_paths_and_state_precision():
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        cfg = core.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["precision"] == {"dtype": "float32", "tf32": False}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_references_import_nothing_of_the_port_or_jax():
    ref_dir = os.path.join(core.BENCH_DIR, "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref_dir, f))}
            assert not tops & {"jax", "jaxlib", "flax", "perfbench",
                               "image_search_engine_for_historical_research_tpu",
                               "image_search_engine_for_historical_research_tpu_torch"}, f


_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
import perfbench.run as run
from perfbench.harness import core
from perfbench.tests.tiny import run_tiny
for name in {cells!r}:
    run_tiny(name, seconds=1.0)
refs = [core.load_part("reference", c["name"]) for c in core.load_benchmark()["configs"]]
print(json.dumps(sorted(sys.modules)))
"""


def test_a_run_loads_no_jax_module_compared_by_whole_top_level_name():
    cells = [w["name"] for w in BENCH["workloads"]]
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=ROOT, cells=cells)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert core.forbidden_loaded(mods) == []
    assert "image_search_engine_for_historical_research_tpu_torch" in {m.split(".")[0]
                                                                       for m in mods}
    assert core.forbidden_loaded(["jax.numpy", "image_search_engine_for_historical_research_tpu",
                                  "image_search_engine_for_historical_research_tpu_torch.ops"]) \
        == ["image_search_engine_for_historical_research_tpu", "jax.numpy"]


def test_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_trace_reduction_merges_overlaps_and_names_gaps():
    dev = [("gemm", 10, 40), ("topk", 30, 50), ("copy", 70, 80)]
    host = [("bench.window", 0, 100), ("aten::cpu", 45, 75), ("wait", 0, 100)]
    out = reduce_events(dev, host, (0, 100))
    assert out["busy_s"] == 50e-9 and out["window_s"] == 100e-9
    assert dict(out["device_ops"])["gemm"] == 30e-9
    gaps = dict(out["idle_gaps"])
    assert gaps.keys() == {"aten::cpu", "wait"}
    assert abs(gaps["aten::cpu"] - 20e-9) < 1e-15 and abs(gaps["wait"] - 30e-9) < 1e-15
