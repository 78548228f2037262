"""Cells cut to a size the CPU runs in seconds: the same drivers, systems,
references and checks, at small images, galleries and shortlists."""

from __future__ import annotations

import copy

from perfbench.harness import core

OVERRIDES = {
    "solar-r1m.served-uploads": (
        {"image_size": 64, "architecture": "resnet50",
         "gallery": {"rows": 5000, "parts": {"a": 1000, "b": 4000}}},
        {"pool": 8, "scenes": 4, "sizes_hw": [[48, 64], [64, 48]], "rate_per_s": 4.0,
         "check_sample": 3, "client_threads": 8}),
    "solar-r1m.batch-q70": (
        {"gallery": {"rows": 20000, "parts": {"a": 20000}}},
        {"distinct_batches": 3, "queries_per_batch": 7, "K": 20, "check_batches": 3}),
    "loftr-outdoor.verify-b60": (
        {"resolution_wh": [160, 120]},
        {"pool": 16, "scenes": 4, "sizes_hw": [[96, 128]], "b": 8, "same_scene": 3,
         "distinct_requests": 4, "check_requests": 2}),
}


def tiny_cell(name: str, **traffic) -> core.Cell:
    cell = core.find_cell(core.load_benchmark(), name)
    cfg_over, tr_over = OVERRIDES[name]
    cfg = copy.deepcopy(cell.config)
    for k, v in cfg_over.items():
        if isinstance(v, dict):
            cfg[k].update(v)
        else:
            cfg[k] = v
    cell.config = cfg
    cell.traffic = {**copy.deepcopy(cell.traffic), **tr_over, **traffic}
    return cell


def run_tiny(name: str, seconds: float = 2.0, seed: int = 2**31 + 11, control=False, **traffic):
    cell = tiny_cell(name, **traffic)
    ctx = core.Context(cell, seed, seconds, False, "cpu")
    out = core.load_part("drivers", cell.traffic["driver"]).run(ctx, control=control)
    return cell, out
