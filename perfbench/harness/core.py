"""The benchmark's shared machinery: finding a cell's files by name, the run
context, the correctness checks and the result line.

Nothing here names a configuration, a traffic mix or a metric. A cell in
``BENCHMARK.json`` names its configuration (``configs[].file``) and its
traffic mix (``perfbench/traffic/<traffic>.json``); the mix names its
driver (``perfbench/drivers/<driver>.py``), the configuration its system
(``perfbench/systems/<model>.py``), its plain reference
(``perfbench/reference/<config>.py``) and its operation counts
(``perfbench/flops/<config>.py``); every metric is read by
``perfbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# top-level module names that must not be loaded by a run (compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "image_search_engine_for_historical_research_tpu")


def process_start_time() -> float:
    """Wall-clock time at which this process started (Linux ``/proc``), so
    that set-up counts the interpreter's own start and torch's import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def set_cache_env(root: str = ROOT) -> None:
    """Fixed build and kernel cache directories inside the checkout, and no
    JAX behind a library's back."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded(modules=None) -> List[str]:
    """Names in ``sys.modules`` whose top-level name (before the first dot)
    is one of ``FORBIDDEN_MODULES``, compared whole."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


_MODULES: Dict[str, Any] = {}


def load_part(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold ``-`` and
    ``.``, so it is loaded by its path)."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if path in _MODULES:
        return _MODULES[path]
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r}: {path}")
    mod_name = "perfbench_" + kind + "_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    _MODULES[path] = mod
    return mod


@dataclass
class Cell:
    """One entry of ``workloads`` with its configuration and traffic mix."""

    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _reports(metric: Dict[str, Any], cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def find_cell(bench: Dict[str, Any], workload: str, bench_dir: str = BENCH_DIR,
              root: str = ROOT) -> Cell:
    """The cell named ``workload``, its files, and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, e2e_names)]
    return Cell(workload, int(w["chips"]), w["config"], config, w["traffic"], traffic,
                e2e, per_layer)


@dataclass
class Check:
    """One number compared against its limit (passes when ``value <=
    limit``; a missing or non-finite value fails)."""

    name: str
    value: Optional[float]
    limit: float

    @property
    def ok(self) -> bool:
        return self.value is not None and math.isfinite(self.value) and self.value <= self.limit


class Context:
    """What a driver gets: the cell, the seed, the window's length, whether
    to trace, the device, and the set-up clock."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device: str,
                 t_process: Optional[float] = None):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_process = process_start_time() if t_process is None else t_process
        self.setup_s: Optional[float] = None
        self.trace_summary: Optional[Dict[str, Any]] = None

    def flops(self):
        return load_part("flops", self.cell.config_name)

    def reference(self):
        return load_part("reference", self.cell.config_name)

    def system(self):
        return load_part("systems", self.config["model"])

    def sync(self) -> None:
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def setup_done(self) -> None:
        """End of set-up: from the process's start to the window's start."""
        self.sync()
        self.setup_s = time.time() - self.t_process

    @contextmanager
    def window(self):
        """Brackets the measured window; with ``trace`` the profiler records
        it. Drivers take their own host clocks inside."""
        from .trace import Tracer

        if self.setup_s is None:
            self.setup_done()
        tracer = Tracer(self.trace and self.device.startswith("cuda"))
        with tracer:
            yield
            self.sync()
        self.trace_summary = tracer.summary()

    def memory_peak_bytes(self) -> int:
        import torch

        if not self.device.startswith("cuda"):
            return 0
        return max(torch.cuda.max_memory_allocated(i) for i in range(self.cell.chips))


@dataclass
class Outcome:
    """What a driver hands back: the record the metric readers read, the
    checks, and the attempted and failed counts."""

    record: Dict[str, Any]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int


def apply_precision(config: Dict[str, Any]) -> None:
    """TF32 on or off for matmuls and cuDNN, as the configuration states
    (``precision.tf32``; off unless stated)."""
    import torch

    tf32 = bool(config.get("precision", {}).get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def checks(traffic: Dict[str, Any], values: Dict[str, float]) -> List[Check]:
    """The traffic mix's ``limits``, each with the run's number."""
    return [Check(k, values[k], float(v)) for k, v in traffic["limits"].items()]


def read_metrics(metrics: List[Dict[str, Any]], record: Dict[str, Any],
                 bench_dir: str = BENCH_DIR) -> Dict[str, Dict[str, Any]]:
    """Each metric's reader over the run record; a reader that finds
    nothing returns ``None`` and the metric is left out."""
    out = {}
    for m in metrics:
        value = load_part("metrics", m["name"], bench_dir).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _finite(x):
    return x if (x is not None and math.isfinite(x)) else None


def result_line(correct: bool, outcome: Outcome, metrics: Dict[str, Any], device: Dict[str, Any],
                breakdown: Optional[Dict[str, Any]] = None) -> str:
    """The last line of standard output (the checks come last)."""
    res: Dict[str, Any] = {
        "correct": bool(correct),
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
        "metrics": metrics,
        "device": device,
    }
    if breakdown is not None:
        res["breakdown"] = breakdown
    res["checks"] = {c.name: {"value": _finite(c.value), "limit": c.limit} for c in outcome.checks}
    return json.dumps(res)


def check_lines(outcome: Outcome) -> List[str]:
    return [f"check {c.name} = {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}"
            for c in outcome.checks] + [f"check failed_requests = {outcome.failed} limit 0"]


def judge(outcome: Outcome) -> bool:
    return outcome.failed == 0 and outcome.attempted > 0 and all(c.ok for c in outcome.checks)
