"""The benchmark's FLOP and byte counts against hand counts, published
counts, and ``torch``'s own operation counter over the plain references
at small shapes."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.harness.core import load_part

SOLAR = load_part("flops", "solar-r101-r1m-flat")
LOFTR = load_part("flops", "loftr-outdoor-640x480")


def test_scan_counts_by_hand():
    flops, nbytes = SOLAR.scan_flops_bytes(2, 3, 4, 1)
    assert flops == 2 * 2 * 3 * 4
    assert nbytes == 3 * 4 * 4 + 2 * 4 * 4 + 2 * 1 * 8


def test_soa_counts_by_hand():
    # stage 4: 1024 channels, mid 256, 2 x 2 positions
    assert SOLAR.soa_flops(2, 2, 1024) == 3 * 2 * 1024 * 256 * 4 + 2 * 2 * 16 * 256 \
        + 2 * 256 * 1024 * 4


def test_resnets_match_published_multiply_adds():
    # torchvision: ResNet-50 4.089 and ResNet-101 7.801 GMACs at 224 px,
    # each with a 2048 x 1000 classifier that the descriptor replaces by
    # a 2048 x 2048 whitening
    for arch, gmacs in (("resnet50", 4.089), ("resnet101", 7.801)):
        got = SOLAR.net_flops(224, 224, arch, soa_layers="")
        want = 2 * (gmacs * 1e9 - 2048 * 1000) + 2 * 2048 * 2048
        assert abs(got - want) / want < 0.002, (arch, got, want)


def _solar_cfg():
    return {"architecture": "resnet50", "pooling": "gem", "soa_layers": "45",
            "whitening": True, "p": 3.0, "mean": [0.485, 0.456, 0.406],
            "std": [0.229, 0.224, 0.225], "scales": [1.0, 2 ** 0.5]}


def test_descriptor_count_equals_torch_counter_on_the_reference():
    ref = load_part("reference", "solar-r101-r1m-flat")
    cfg = _solar_cfg()
    sd = load_part("systems", "solar").state_dict(cfg, 3, "cpu")
    x = torch.zeros(1, 64, 64, 3)
    mask = torch.ones(1, 64, 64, dtype=torch.bool)
    with FlopCounterMode(display=False) as fc:
        for s in cfg["scales"]:
            side = int(64 * s)
            ref.net(sd, torch.zeros(1, side, side, 3) if s != 1 else x,
                    torch.ones(1, side, side, dtype=torch.bool) if s != 1 else mask,
                    "resnet50")
    assert fc.get_total_flops() == SOLAR.descriptor_flops(64, cfg["scales"], "resnet50")


def test_loftr_block_count_equals_torch_counter_on_the_reference():
    ref = load_part("reference", "loftr-outdoor-640x480")
    m = {"initial_dim": 16, "block_dims": [16, 24, 32], "d_model": 32, "nhead": 4,
         "layer_names": ["self", "cross"], "dsmax_temperature": 0.1, "thr": 0.2,
         "border_rm": 1, "max_matches": 64, "temp_bug_fix": False, "d_fine": 16,
         "fine_layer_names": ["self", "cross"], "fine_window": 5, "fine_concat_coarse": True}
    sd = load_part("systems", "loftr").state_dict({"matcher": m}, 4, "cpu")
    img = torch.rand(2, 64, 96)
    with FlopCounterMode(display=False) as fc:
        ref.counts(sd, img, img.flip(2), m)
    assert fc.get_total_flops() == LOFTR.block_flops(2, 64, 96, m)
