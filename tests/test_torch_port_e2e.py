"""The ported slice end to end against the JAX package: JPEGs on disk -> feature
store -> HNSW index -> ``cli.online.make_service`` -> ``query_image``,
``query_batch`` and a WSGI POST, with the same checkpoint in both packages.

The JAX service searches through a test-local adapter that takes the Pallas
kernel route in interpret mode (``search_pallas``), the route the port's
``HNSWIndex.search`` takes by default (its kernel's plain version on CPU).
"""

import copy
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.cli import online as j_online
from image_search_engine_for_historical_research_tpu.data import save_path_feature
from image_search_engine_for_historical_research_tpu.index import build_flat_i8 as j_build_flat_i8
from image_search_engine_for_historical_research_tpu.index import build_hnsw as j_build
from image_search_engine_for_historical_research_tpu.index import (
    build_rpforest as j_build_rpforest,
)
from image_search_engine_for_historical_research_tpu.index import save_index as j_save
from image_search_engine_for_historical_research_tpu.index.base import (
    normalize_rows as j_normalize_rows,
)
from image_search_engine_for_historical_research_tpu.models import extract as j_extract
from image_search_engine_for_historical_research_tpu.models import init_network as j_init
from image_search_engine_for_historical_research_tpu_torch.cli import online as t_online
from image_search_engine_for_historical_research_tpu_torch.data import load_path_features
from image_search_engine_for_historical_research_tpu_torch.index import build_flat_i8
from image_search_engine_for_historical_research_tpu_torch.models import from_flax_variables
from image_search_engine_for_historical_research_tpu_torch.ops import beam_search as bs
from image_search_engine_for_historical_research_tpu_torch.rerank import build_diffusion_offline
from image_search_engine_for_historical_research_tpu_torch.serving import make_wsgi_app
from torch_port_helpers import ONE_BLOCK, one_block_arch, perturbed_variables, write_images

K = 5


class PallasRoute:
    """JAX ``HNSWIndex.search`` on the Pallas kernel route (interpret mode)."""

    def __init__(self, ix):
        self.ix = ix
        self.vectors = ix.vectors

    def search(self, q, k):
        q = j_normalize_rows(jnp.asarray(q))
        return self.ix.search_pallas(q, k, ef=max(self.ix.ef_default, k), interpret=True)


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_e2e")
    data, outputs = root / "data", root / "outputs"
    with one_block_arch():
        jmodel = j_init({"architecture": ONE_BLOCK})
        variables = perturbed_variables(jax.tree.map(np.asarray, jmodel.params), seed=3)
        ckpt = root / "net.pth"
        torch.save({"state_dict": from_flax_variables(variables),
                    "meta": {"architecture": ONE_BLOCK}}, ckpt)

        paths = write_images(data / "all", 15, seed=0)
        db_paths, q_paths = paths[:12], paths[12:]
        jmodel.params = jax.tree.map(jnp.asarray, variables)
        vecs = j_extract.extract_vectors(jmodel, db_paths, image_size=96,
                                         scales=j_extract.DEFAULT_SCALES)
        save_path_feature("db", vecs, [os.path.relpath(p, data) for p in db_paths],
                          root=str(outputs))
        j_save(j_build(vecs, m=4, ef_construction=16), str(outputs / "db" / "hnsw"))

        argv = ["--datasets", "db", "--data-root", str(data), "--matching-method", "HNSW",
                "--outputs", str(outputs), "--image-size", "96", "--K", str(K),
                "--network-path", str(ckpt), "--arch", ONE_BLOCK]
        jsvc = j_online.make_service(j_online.build_parser().parse_args(argv))
        jsvc.index = PallasRoute(jsvc.index)
        tsvc = t_online.make_service(
            t_online.build_parser().parse_args(argv + ["--device", "cpu"]))
        yield jsvc, tsvc, q_paths, argv
        tsvc.close()


def _ids(results):
    return [r["id"] for r in results]


def test_query_image_matches_jax(services):
    jsvc, tsvc, q_paths, _ = services
    launches = bs.launches
    for p in q_paths:
        (jr, _), (tr, timing) = jsvc.query_image(p), tsvc.query_image(p)
        assert len(tr) == K
        assert _ids(tr) == _ids(jr), p
        assert set(timing) == {"extract_s", "search_s", "rerank_s"}
    assert bs.launches == launches          # CPU: the plain version, no launch


def test_query_batch_matches_query_image_and_jax(services):
    jsvc, tsvc, q_paths, _ = services
    single = [_ids(tsvc.query_image(p)[0]) for p in q_paths]
    batch = tsvc.query_batch(q_paths)              # 3 queries -> slot 4
    assert [_ids(r) for r, _ in batch] == single
    assert batch[0][1]["batch"] == 3 and batch[0][1]["slot"] == 4
    jbatch = jsvc.query_batch(q_paths)
    assert [_ids(r) for r, _ in jbatch] == single
    assert tsvc.query_batch([]) == []


def test_wsgi_post_returns_same_ids(services):
    jsvc, tsvc, q_paths, _ = services
    app = make_wsgi_app(tsvc)
    status = {}

    def start_response(s, headers):
        status["s"] = s

    with open(q_paths[0], "rb") as f:
        payload = f.read()
    environ = {"REQUEST_METHOD": "POST", "CONTENT_TYPE": "image/jpeg",
               "CONTENT_LENGTH": str(len(payload)), "wsgi.input": io.BytesIO(payload),
               "HTTP_ACCEPT": "application/json"}
    out = json.loads(b"".join(app(environ, start_response)))
    assert status["s"] == "200 OK"
    assert _ids(out["results"]) == _ids(jsvc.query_image(q_paths[0])[0])

    img = b"".join(app({"REQUEST_METHOD": "GET", "PATH_INFO": f"/image/{out['results'][0]['id']}",
                        "wsgi.input": io.BytesIO(b"")}, start_response))
    assert status["s"] == "200 OK" and img[:2] == b"\xff\xd8"
    bad = {"REQUEST_METHOD": "POST", "CONTENT_TYPE": "text/plain", "CONTENT_LENGTH": "3",
           "wsgi.input": io.BytesIO(b"abc")}
    b"".join(app(bad, start_response))
    assert status["s"].startswith("400")
    assert b"<form" in b"".join(app({"REQUEST_METHOD": "GET", "wsgi.input": io.BytesIO(b"")},
                                    start_response))


@pytest.mark.parametrize("method", ["ANNOY", "L2_int8"])
def test_unported_matching_methods_exit(services, method):
    """Both methods are served with JAX's ids: ANNOY through ``cli.online``
    from the forest the JAX package wrote; L2_int8 (which neither package's
    ``cli.online`` serves) through a ``SearchService`` over each package's
    ``build_flat_i8``."""
    jsvc0, tsvc0, q_paths, argv = services
    outputs = argv[argv.index("--outputs") + 1]
    vecs, _ = load_path_features("db", root=outputs)
    if method == "ANNOY":
        j_save(j_build_rpforest(vecs, n_trees=4, leaf_size=4), os.path.join(outputs, "db",
                                                                             "rpforest"))
        sargv = argv + ["--matching-method", "ANNOY"]
        with one_block_arch():
            jsvc = j_online.make_service(j_online.build_parser().parse_args(sargv))
            tsvc = t_online.make_service(
                t_online.build_parser().parse_args(sargv + ["--device", "cpu"]))
        assert type(tsvc.index).__name__ == "RPForestIndex"
    else:
        jsvc, tsvc = copy.copy(jsvc0), copy.copy(tsvc0)
        jsvc.index = j_build_flat_i8(vecs)
        tsvc.index = build_flat_i8(vecs, device="cpu")
    try:
        for p in q_paths:
            assert _ids(tsvc.query_image(p)[0]) == _ids(jsvc.query_image(p)[0]), p
        assert [_ids(r) for r, _ in tsvc.query_batch(q_paths)] == [
            _ids(jsvc.query_image(p)[0]) for p in q_paths]
    finally:
        if method == "ANNOY":
            tsvc.close()


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank in this process, as ``data_mesh``
    starts it with no group running; destroyed after the test."""
    import torch.distributed as dist

    from image_search_engine_for_historical_research_tpu_torch.parallel import data_mesh

    assert not dist.is_initialized()
    try:
        yield data_mesh(device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_unported_modes_raise(services, world_of_one):
    """What the port once refused, a sharded diffusion build, now serves: the
    served gallery's artifact built over a mesh (a world of one) equals the
    unsharded one, and a service re-ranks with it as with that one.
    ``--coalesce`` and ``rerank="diffusion"`` are served
    (``tests/test_torch_port_serving.py``); ``--methods sift`` and ``loftr``
    re-rank, also beside other methods
    (``tests/test_torch_port_geometric.py``)."""
    _, tsvc, q_paths, _ = services
    vecs = torch.as_tensor(tsvc.vecs)
    plain = build_diffusion_offline(vecs, n_trunc=8, kd=4)
    sharded = build_diffusion_offline(vecs, n_trunc=8, kd=4, mesh=world_of_one)
    np.testing.assert_array_equal(sharded.trunc_ids.numpy(), plain.trunc_ids.numpy())
    np.testing.assert_array_equal(sharded.scores.numpy(), plain.scores.numpy())
    ranked = []
    for off in (plain, sharded):
        svc = copy.copy(tsvc)
        svc.rerank, svc.diffusion_offline = "diffusion", off
        ranked.append([_ids(svc.query_image(p)[0]) for p in q_paths])
    assert ranked[0] == ranked[1]
