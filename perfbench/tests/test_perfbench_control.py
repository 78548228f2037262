"""The control of each cell comes out not correct: the plain reference in
TF32 (the precision below the configurations' f32), put in the program's
place, fails one of the cell's compared numbers, while the program on the
same inputs passes them all. On the card, at sizes a test run holds:

    python -m pytest perfbench/tests/test_perfbench_control.py -m cuda

(``calibrate.py --control`` reads the same at each cell's own size.)
"""

import pytest

from perfbench.harness import core
from perfbench.tests.tiny import tiny_cell

SIZES = {
    "solar-r1m.served-uploads": ({"image_size": 512, "architecture": "resnet101",
                                  "gallery": {"rows": 200000, "parts": {"a": 200000}}},
                                 {"rate_per_s": 6.0, "check_sample": 4, "pool": 16,
                                  "sizes_hw": [[384, 512], [512, 384]]}),
    "solar-r1m.batch-q70": ({"gallery": {"rows": 200000, "parts": {"a": 200000}}},
                            {"queries_per_batch": 70, "K": 100, "check_batches": 4}),
    "loftr-outdoor.verify-b60": ({"resolution_wh": [640, 480]},
                                 {"pool": 64, "scenes": 8, "sizes_hw": [[768, 1024]], "b": 60,
                                  "same_scene": 7, "check_requests": 2}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SIZES))
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303])
def test_the_control_is_not_correct(cuda, name, seed):
    cfg_over, tr_over = SIZES[name]
    cell = tiny_cell(name, **tr_over)
    for k, v in cfg_over.items():
        if isinstance(v, dict):
            cell.config[k].update(v)
        else:
            cell.config[k] = v
    ctx = core.Context(cell, seed, 5.0, False, cuda)
    out = core.load_part("drivers", cell.traffic["driver"]).run(ctx, control=True)
    assert core.judge(out), [(c.name, c.value, c.limit) for c in out.checks]
    control = out.record["control"]
    assert any(control[c.name] > c.limit for c in out.checks), (control, out.checks)
