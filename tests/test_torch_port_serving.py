"""Diffusion serving and request coalescing in the port against the JAX
package: ``SearchService(rerank="diffusion")`` on the same JPEGs, checkpoint,
feature store and diffusion artifact returns JAX's ids through
``query_image``, ``query_batch`` and a WSGI POST; ``CoalescingService``
returns ``query_image``'s results to concurrent callers."""

import io
import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.cli import online as j_online
from image_search_engine_for_historical_research_tpu.data import save_path_feature
from image_search_engine_for_historical_research_tpu.rerank import diffusion as jd
from image_search_engine_for_historical_research_tpu_torch.cli import online as t_online
from image_search_engine_for_historical_research_tpu_torch.cli.common import load_network
from image_search_engine_for_historical_research_tpu_torch.models import (
    from_flax_variables,
    to_flax_variables,
)
from image_search_engine_for_historical_research_tpu_torch.models import init_network as t_init
from image_search_engine_for_historical_research_tpu_torch.models.extract import extract_vectors
from image_search_engine_for_historical_research_tpu_torch.rerank import DiffusionOffline
from image_search_engine_for_historical_research_tpu_torch.serving import (
    CoalescingService,
    make_wsgi_app,
)
from torch_port_helpers import ONE_BLOCK, one_block_arch, perturbed_variables, write_images

K = 5


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    """12 gallery JPEGs (a feature store) + 200 clustered synthetic rows,
    an L2 service in each package over them, a JAX-built diffusion artifact
    (n_trunc=64, kd=10) and the port's diffusion service over it."""
    root = tmp_path_factory.mktemp("port_serving")
    data, outputs = root / "data", root / "outputs"
    with one_block_arch():
        tmodel = t_init({"architecture": ONE_BLOCK}, device="cpu")
        variables = perturbed_variables(to_flax_variables(tmodel.module.state_dict()), seed=4)
        ckpt = root / "net.pth"
        torch.save({"state_dict": from_flax_variables(variables),
                    "meta": {"architecture": ONE_BLOCK}}, ckpt)
        paths = write_images(data / "all", 15, seed=7)
        db_paths, q_paths = paths[:12], paths[12:]
        model = load_network(str(ckpt), ONE_BLOCK, device="cpu")
        vecs = extract_vectors(model, db_paths, image_size=96)
        save_path_feature("db", vecs, [os.path.relpath(p, data) for p in db_paths],
                          root=str(outputs))
        rng = np.random.default_rng(8)
        centers = rng.standard_normal((6, 2048))
        synth = centers[rng.integers(0, 6, 200)] + 0.7 * rng.standard_normal((200, 2048))
        synth /= np.linalg.norm(synth, axis=1, keepdims=True)
        save_path_feature("synth", synth.astype(np.float32),
                          [f"synth/{i}" for i in range(200)], root=str(outputs))

        argv = ["--datasets", "db,synth", "--data-root", str(data), "--matching-method", "L2",
                "--outputs", str(outputs), "--image-size", "96", "--multiscale", "[1]",
                "--K", str(K), "--network-path", str(ckpt), "--arch", ONE_BLOCK]
        jsvc = j_online.make_service(j_online.build_parser().parse_args(argv))
        off_j = jd.build_diffusion_offline(jnp.asarray(jsvc.vecs), n_trunc=64, kd=10)
        jsvc.rerank, jsvc.diffusion_offline = "diffusion", off_j
        off_t = DiffusionOffline(torch.as_tensor(np.asarray(off_j.trunc_ids)),
                                 torch.as_tensor(np.asarray(off_j.scores)))
        base = t_online.make_service(
            t_online.build_parser().parse_args(argv + ["--device", "cpu"]))
        tsvc = type(base)(base.model, base.index, base.vecs, base.paths, K=K,
                          scales=base.scales, image_size=96, rerank="diffusion",
                          diffusion_offline=off_t, image_root=str(data), device="cpu")
        yield jsvc, base, tsvc, q_paths, argv
        base.close()
        tsvc.close()


def _ids(results):
    return [r["id"] for r in results]


@pytest.mark.parametrize("kind", ["pq", "hnsw_pq", "ivfpq"])
def test_pq_family_services_match_jax(services, tmp_path, kind):
    """A JAX-built PQ, HNSW-PQ or IVF-PQ artifact (refine codes, so each
    searches ``adc+refine``) served by both packages with qge1: the same ids
    through ``query_image``, ``query_batch`` and a WSGI POST."""
    from image_search_engine_for_historical_research_tpu import index as jindex
    from image_search_engine_for_historical_research_tpu.serving.app import (
        SearchService as JSearchService,
    )
    from image_search_engine_for_historical_research_tpu_torch.index import load_index

    jsvc, base, _, q_paths, _ = services
    build = {"pq": lambda v: jindex.build_pq(v, M=16, Ks=64, iters=4, refine_M=16),
             "hnsw_pq": lambda v: jindex.build_hnsw_pq(v, M=16, Ks=64, iters=4, refine_M=16,
                                                       opq="refine", opq_iters=2),
             "ivfpq": lambda v: jindex.build_ivfpq(v, nlist=12, M=16, Ks=32, nprobe=6, iters=4,
                                                   refine_M=16)}[kind]
    jix = build(jsvc.vecs)
    jindex.save_index(jix, str(tmp_path / kind))
    tix = load_index(str(tmp_path / kind), device="cpu")
    jpq_svc = JSearchService(jsvc.model, jix, jsvc.vecs, jsvc.paths, K=K, scales=jsvc.scales,
                             image_size=96)
    tpq_svc = type(base)(base.model, tix, base.vecs, base.paths, K=K, scales=base.scales,
                         image_size=96, device="cpu")
    try:
        single = [_ids(tpq_svc.query_image(p)[0]) for p in q_paths]
        assert single == [_ids(jpq_svc.query_image(p)[0]) for p in q_paths]
        assert [_ids(r) for r, _ in tpq_svc.query_batch(q_paths)] == single
        app = make_wsgi_app(tpq_svc)
        payload = open(q_paths[0], "rb").read()
        status = {}
        body = b"".join(app({"REQUEST_METHOD": "POST", "CONTENT_TYPE": "image/jpeg",
                             "CONTENT_LENGTH": str(len(payload)),
                             "wsgi.input": io.BytesIO(payload), "HTTP_ACCEPT": "application/json"},
                            lambda st, h: status.setdefault("s", st)))
        assert status["s"] == "200 OK" and _ids(json.loads(body)["results"]) == single[0]
    finally:
        tpq_svc.close()


def test_diffusion_query_image_and_batch_match_jax(services):
    jsvc, _, tsvc, q_paths, _ = services
    single = []
    for p in q_paths:
        (jr, _), (tr, timing) = jsvc.query_image(p), tsvc.query_image(p)
        assert len(tr) == K and set(timing) == {"extract_s", "search_s", "rerank_s"}
        assert _ids(tr) == _ids(jr), p
        single.append(_ids(tr))
    batch = tsvc.query_batch(q_paths)                    # 3 queries -> slot 4
    assert [_ids(r) for r, _ in batch] == single
    assert batch[0][1]["slot"] == 4
    assert [_ids(r) for r, _ in jsvc.query_batch(q_paths)] == single


def test_diffusion_wsgi_post_matches_jax(services):
    jsvc, _, tsvc, q_paths, _ = services
    status = {}
    with open(q_paths[1], "rb") as f:
        payload = f.read()
    environ = {"REQUEST_METHOD": "POST", "CONTENT_TYPE": "image/jpeg",
               "CONTENT_LENGTH": str(len(payload)), "wsgi.input": io.BytesIO(payload),
               "HTTP_ACCEPT": "application/json"}
    out = json.loads(b"".join(make_wsgi_app(tsvc)(
        environ, lambda s, h: status.setdefault("s", s))))
    assert status["s"] == "200 OK"
    assert _ids(out["results"]) == _ids(jsvc.query_image(q_paths[1])[0])


def test_host_and_device_artifacts_give_the_same_ids(services, tmp_path):
    _, _, tsvc, q_paths, _ = services
    path = str(tmp_path / "off.npz")
    tsvc.diffusion_offline.save(path)
    host = DiffusionOffline.load(path, to_device=False)
    assert host.on_host
    hsvc = type(tsvc)(tsvc.model, tsvc.index, tsvc.vecs, tsvc.paths, K=K, scales=tsvc.scales,
                      image_size=96, rerank="diffusion", diffusion_offline=host, device="cpu")
    try:
        for p in q_paths:
            assert _ids(hsvc.query_image(p)[0]) == _ids(tsvc.query_image(p)[0]), p
        assert ([_ids(r) for r, _ in hsvc.query_batch(q_paths)]
                == [_ids(r) for r, _ in tsvc.query_batch(q_paths)])
    finally:
        hsvc.close()


def test_diffusion_service_arguments(services):
    _, base, tsvc, _, _ = services
    with pytest.raises(ValueError, match="diffusion_offline"):
        type(base)(base.model, base.index, base.vecs, base.paths, rerank="diffusion",
                   device="cpu")
    with pytest.raises(ValueError, match="rerank mode"):
        type(base)(base.model, base.index, base.vecs, base.paths, rerank="bogus",
                   device="cpu")


def test_coalescing_concurrent_callers_get_query_image_results(services):
    _, base, _, q_paths, _ = services
    expected = {p: _ids(base.query_image(p)[0]) for p in q_paths}
    cs = CoalescingService(base, max_batch=8, max_wait_ms=200.0)
    assert cs.K == base.K and cs.resolve_image_path(0) == base.resolve_image_path(0)
    reqs = [p for p in q_paths for _ in range(2)]
    out, errs = {}, []

    def worker(i, p):
        try:
            out[i] = _ids(cs.query_image(p)[0])
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i, p)) for i, p in enumerate(reqs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    cs.close()
    assert not errs and len(out) == len(reqs)
    for i, p in enumerate(reqs):
        assert out[i] == expected[p], p
    assert cs.requests_served == len(reqs) and cs.batches_run < len(reqs)
    with pytest.raises(RuntimeError, match="closed"):
        cs.query_image(q_paths[0])


@pytest.mark.parametrize("pipeline", [True, False])
def test_coalescing_corrupt_upload_fails_alone(services, tmp_path, pipeline):
    _, base, _, q_paths, _ = services
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    expected = {p: _ids(base.query_image(p)[0]) for p in q_paths}
    cs = CoalescingService(base, max_batch=8, max_wait_ms=200.0, pipeline=pipeline)
    results, errors = {}, {}

    def go(p):
        try:
            results[p] = _ids(cs.query_image(p)[0])
        except Exception as e:
            errors[p] = e

    threads = [threading.Thread(target=go, args=(p,)) for p in [q_paths[0], str(bad)]
               + list(q_paths[1:])]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    cs.close()
    assert set(errors) == {str(bad)}
    assert results == expected
    assert len(cs._threads) == (2 if pipeline else 1)


class _Stub:
    """Records which thread prepares and executes; batch 0's execute waits
    until batch 1's prepare has started, which happens only if prepare and
    execute overlap."""

    def __init__(self):
        self.second_prepare = threading.Event()
        self.threads = {"prepare": set(), "execute": set()}
        self.n_prepared = 0

    def prepare_batch(self, paths):
        self.threads["prepare"].add(threading.current_thread().name)
        self.n_prepared += 1
        if self.n_prepared == 2:
            self.second_prepare.set()
        return {"paths": list(paths)}

    def execute_batch(self, prepared):
        self.threads["execute"].add(threading.current_thread().name)
        if prepared["paths"] == ["p0"]:
            self.overlapped = self.second_prepare.wait(timeout=30)
        return [(p, {}) for p in prepared["paths"]]


def test_coalescing_pipeline_overlaps_prepare_and_execute():
    """No clock: batch 0's execute finishes only once batch 1's prepare has
    begun on the other thread. Prepare runs on the collector thread (host
    work only) and execute on the device thread; ``close`` joins both."""
    stub = _Stub()
    cs = CoalescingService(stub, max_batch=1, max_wait_ms=0.0, pipeline=True)
    first = threading.Thread(target=lambda: cs.query_image("p0"))
    first.start()
    while stub.n_prepared < 1:
        time.sleep(0.001)
    second = threading.Thread(target=lambda: cs.query_image("p1"))
    second.start()
    first.join(timeout=60)
    second.join(timeout=60)
    assert stub.overlapped
    assert stub.threads == {"prepare": {"serving-collector"}, "execute": {"serving-device"}}
    cs.close()
    assert not any(th.is_alive() for th in cs._threads)
    assert cs.batches_run == 2 and cs.requests_served == 2


def test_online_coalesce_builds_the_coalescing_service(services, monkeypatch):
    *_, argv = services
    seen = {}
    monkeypatch.setattr(t_online, "serve",
                        lambda svc, host, port, threaded=False: seen.update(svc=svc,
                                                                            threaded=threaded))
    with one_block_arch():
        t_online.main(argv + ["--device", "cpu", "--coalesce", "4"])
    svc = seen["svc"]
    try:
        assert isinstance(svc, CoalescingService) and seen["threaded"] is True
        assert svc.max_batch == 4 and svc.rerank == "qge1"
    finally:
        svc.close()
        svc._svc.close()
    with one_block_arch():
        t_online.main(argv + ["--device", "cpu"])
    assert not isinstance(seen["svc"], CoalescingService) and seen["threaded"] is False
    seen["svc"].close()
