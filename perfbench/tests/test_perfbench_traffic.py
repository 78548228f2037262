"""The traffic generators give the same inputs for the same seed (also a
seed wider than 32 bits), the same work for every seed, and the open
loop's tail counts a stall."""

import threading
import time

import numpy as np
import torch

from perfbench.harness import gallery, photos
from perfbench.harness.core import load_part
from perfbench.harness.readers import percentile

SERVED = load_part("drivers", "served_uploads")
VERIFY = load_part("drivers", "verify_shortlists")
BIG = 2 ** 31 + 7


def test_arrivals_repeat_by_seed_and_offer_the_same_gaps():
    a, b = SERVED.arrivals(BIG, 9.0, 30.0), SERVED.arrivals(BIG, 9.0, 30.0)
    c = SERVED.arrivals(BIG + 1, 9.0, 30.0)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len(a) == 270 and abs(a[-1] - 30.0) < 1.0
    assert np.allclose(np.sort(np.diff(a, prepend=0)), np.sort(np.diff(c, prepend=0)))


def test_choices_use_every_photograph_equally():
    a = SERVED.choices(BIG, 512, 256)
    assert np.array_equal(a, SERVED.choices(BIG, 512, 256))
    assert np.bincount(a, minlength=256).tolist() == [2] * 256


def test_verify_requests_repeat_by_seed_and_hold_the_own_scene():
    scenes = np.arange(64) % 8
    a = VERIFY.requests(BIG, 5, scenes, 12, 3)
    b = VERIFY.requests(BIG, 5, scenes, 12, 3)
    assert all(qa == qb and np.array_equal(ca, cb) for (qa, ca), (qb, cb) in zip(a, b))
    for q, cand in a:
        assert len(set(cand.tolist())) == 12 and q not in cand
        assert (scenes[cand] == scenes[q]).sum() == 3


def test_gallery_queries_and_photographs_repeat_by_seed():
    g = {"rows": 300, "dim": 32, "n_centers": 16, "d_eff": 8, "spread": 0.1}
    x, y = gallery.make_gallery(BIG, g, "cpu"), gallery.make_gallery(BIG, g, "cpu")
    assert torch.equal(x, y) and not torch.equal(x, gallery.make_gallery(BIG + 1, g, "cpu"))
    assert torch.allclose(x.norm(dim=1), torch.ones(300), atol=1e-5)
    assert torch.equal(gallery.make_queries(BIG, g, 7, 0.1, "cpu"),
                       gallery.make_queries(BIG, g, 7, 0.1, "cpu"))
    p1 = photos.make_pool(BIG, 4, 2, [[24, 32], [32, 24]], 90, "cpu")
    p2 = photos.make_pool(BIG, 4, 2, [[24, 32], [32, 24]], 90, "cpu")
    assert p1.jpegs == p2.jpegs and p1.hw.tolist() == [[24, 32], [32, 24]] * 2


def test_weights_repeat_by_seed():
    cfg = {"architecture": "resnet50", "pooling": "gem", "soa_layers": "45",
           "whitening": True, "p": 3.0}
    solar = load_part("systems", "solar")
    a, b = solar.state_dict(cfg, BIG, "cpu"), solar.state_dict(cfg, BIG, "cpu")
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["features.soa4.v.weight"].abs().sum()) > 0      # SOA is live


class _OneServer:
    """A WSGI app that serves one request at a time; the first one stalls."""

    def __init__(self, stall):
        self.lock, self.stall, self.n = threading.Lock(), stall, 0

    def __call__(self, environ, start_response):
        environ["wsgi.input"].read()
        with self.lock:
            self.n += 1
            if self.n == 1:
                time.sleep(self.stall)
        start_response("200 OK", [("Content-Type", "application/json")])
        return [b'{"results": [{"id": 1}], "timing": {}}']


def test_tail_is_taken_from_due_times_so_a_stall_shows():
    class St:
        app = _OneServer(0.6)
        bodies = [b"x"]
        traffic = {"client_threads": 1, "schedule_seed": BIG}

        class front:
            requests_served = batches_run = 0

    out = SERVED.drive(St, 20.0, 1.0, BIG)
    lat = [r.latency_s for r in out["replies"]]
    assert all(r.ok for r in out["replies"]) and len(lat) == 20
    # requests due during the stall waited for it, though each was sent
    # only when the one client thread was free: their wait counts from due
    assert sum(x > 0.2 for x in lat) >= 3
    assert percentile(lat, 95) > 0.3
    assert max(out["lateness_s"]) > 0.2
    assert percentile([0.1] * 19 + [float("inf")], 95) == 0.1
    assert percentile([0.1] * 18 + [float("inf")] * 2, 95) == float("inf")
