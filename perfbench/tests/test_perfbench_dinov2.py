"""The ``dinov2-r1m.served-uploads-b4`` cell at a size the CPU runs in
seconds: its files are found by name, its FLOP counts equal ``torch``'s
counter over its plain reference, a sound run is correct, a run whose
ViT lets padded keys through is not, and its per-layer readers read the
port's spans and counters."""

import copy
import math
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.harness import core

CELL = "dinov2-r1m.served-uploads-b4"
CONFIG = "dinov2-vitl14-reg4-r1m-flat"
SMALL = {"patch_size": 14, "embed_dim": 64, "depth": 2, "num_heads": 4, "mlp_dim": 256,
         "num_register_tokens": 4, "pos_grid": 5, "image_size": 112,
         "gallery": {"rows": 5000, "parts": {"a": 1000, "b": 4000}, "dim": 64}}
TRAFFIC = {"pool": 8, "scenes": 4, "sizes_hw": [[84, 112], [112, 84]], "rate_per_s": 4.0,
           "check_sample": 3, "client_threads": 8}
METRICS = ["vit_mfu.served_vit", "vit_attention_roofline.served_vit",
           "vit_embed_ms.served_vit", "vit_attention_ms.served_vit", "vit_mlp_ms.served_vit",
           "vit_pad_token_pct.served_vit"]


def tiny_cell() -> core.Cell:
    cell = core.find_cell(core.load_benchmark(), CELL)
    cfg = copy.deepcopy(cell.config)
    for k, v in SMALL.items():
        if isinstance(v, dict):
            cfg[k].update(v)
        else:
            cfg[k] = v
    cell.config = cfg
    cell.traffic = {**copy.deepcopy(cell.traffic), **TRAFFIC}
    return cell


def run_tiny(seed: int = 2 ** 31 + 23, seconds: float = 2.0):
    cell = tiny_cell()
    ctx = core.Context(cell, seed, seconds, False, "cpu")
    return core.load_part("drivers", cell.traffic["driver"]).run(ctx)


def test_the_cell_finds_every_file_and_reports_its_metrics():
    bench = core.load_benchmark()
    cell = core.find_cell(bench, CELL)
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert entry["reduced"] == [] and cell.config["reduced"] == []
    for kind, name in (("drivers", "served_uploads_vit"), ("systems", "dinov2"),
                       ("reference", CONFIG), ("flops", CONFIG),
                       *(("metrics", m) for m in METRICS + ["uploads_per_s", "setup_s"])):
        assert os.path.isfile(os.path.join(core.BENCH_DIR, kind, f"{name}.py")), (kind, name)
    assert os.path.isfile(os.path.join(core.BENCH_DIR, "traffic", "served-uploads-b4.json"))
    assert {m["name"] for m in cell.end_to_end} == {"uploads_per_s", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == METRICS
    assert all(m["workloads"] == [CELL] for m in cell.per_layer)
    cfg = cell.config
    assert (cfg["patch_size"], cfg["embed_dim"], cfg["depth"], cfg["num_heads"],
            cfg["mlp_dim"], cfg["num_register_tokens"], cfg["pos_grid"]) \
        == (14, 1024, 24, 16, 4096, 4, 37)
    assert cfg["gallery"]["dim"] == cfg["embed_dim"] == cfg["outputdim"]
    assert cell.traffic["max_batch"] == 4 and cell.traffic["check_sample"] >= 8


@pytest.mark.parametrize("hw", [(84, 112), (112, 61), (112, 112)])
def test_upload_flops_equal_torch_counter_on_the_reference(hw):
    """The counts from shapes alone against ``torch``'s counter over the
    reference's three scales of one upload (patch embedding, linear layers,
    head-at-a-time attention), over its valid tokens."""
    fl = core.load_part("flops", CONFIG)
    ref = core.load_part("reference", CONFIG)
    cfg = tiny_cell().config
    sd = core.load_part("systems", "dinov2").state_dict(cfg, 5, "cpu")
    side = -(-cfg["image_size"] // 32) * 32              # the served canvas
    mask = torch.zeros(side, side, dtype=torch.bool)
    mask[:hw[0], :hw[1]] = True
    with FlopCounterMode(display=False) as fc:
        ref.descriptor_of(sd, torch.zeros(side, side, 3), mask, cfg)
    assert fc.get_total_flops() == fl.upload_flops(*hw, cfg)
    attention = fl.upload_attention_flops(*hw, cfg)
    n = [fl.valid_tokens(*hw, side, s, cfg) for s in cfg["scales"]]
    assert attention == sum(cfg["depth"] * 4 * k * k * cfg["embed_dim"] for k in n)
    assert 0 < attention < fl.upload_flops(*hw, cfg)


def test_the_served_photographs_count_as_published():
    """768 x 1024 on the 1024 canvas: 4,020 + 8,039 + 1,994 tokens."""
    fl = core.load_part("flops", CONFIG)
    cfg = core.find_cell(core.load_benchmark(), CELL).config
    for hw in ((768, 1024), (1024, 768)):
        assert [fl.valid_tokens(*hw, 1024, s, cfg) for s in cfg["scales"]] == [4020, 8039, 1994]
    assert math.isclose(fl.upload_flops(768, 1024, cfg), 1.6837e13, rel_tol=1e-3)


def test_a_sound_run_is_correct():
    out = run_tiny()
    assert core.judge(out), [(c.name, c.value, c.limit) for c in out.checks]
    assert out.record["upload_flops"] > out.record["attention_flops"] > 0


def test_a_vit_whose_mask_lets_padded_keys_through_is_not_correct(monkeypatch):
    from image_search_engine_for_historical_research_tpu_torch.models import vit

    real = vit.DinoV2Retrieval.embed

    def leaky(self, x, mask):
        tokens, keep = real(self, x, mask)
        return tokens, None if keep is None else torch.ones_like(keep)

    monkeypatch.setattr(vit.DinoV2Retrieval, "embed", leaky)
    out = run_tiny()
    assert not core.judge(out), [(c.name, c.value, c.limit) for c in out.checks]


def test_the_pad_share_reads_the_ports_counters():
    from image_search_engine_for_historical_research_tpu_torch.utils import tracing

    reader = core.load_part("metrics", "vit_pad_token_pct.served_vit")
    tracing.reset()
    tracing.enable()
    try:
        tracing.count("vit.token_rows", 400)
        tracing.count("vit.key_rows", torch.tensor(300))
        assert reader.read({"trace": {"busy_s": 1.0}}) == 25.0
        assert reader.read({}) is None
    finally:
        tracing.enable(False)
        tracing.reset()
    assert reader.read({"trace": {"busy_s": 1.0}}) is None


_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
import perfbench.run
from perfbench.tests.test_perfbench_dinov2 import run_tiny
run_tiny(seconds=1.0)
print(json.dumps(sorted(sys.modules)))
"""


def test_a_run_of_the_cell_loads_no_jax_module():
    import json
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=core.ROOT)],
                         capture_output=True, text=True, timeout=600, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert core.forbidden_loaded(mods) == []
    assert "image_search_engine_for_historical_research_tpu_torch.models.vit" in mods
