"""Online query service: extraction + search + re-rank behind a WSGI app.

Port of ``image_search_engine_for_historical_research_tpu/serving/app.py``:
load the network and the gallery at
startup, take an uploaded image on ``POST /``, extract its descriptor, search
the index, re-rank (one qge1 iteration, or diffusion against a prebuilt
``rerank.DiffusionOffline`` artifact) and return the top-K gallery paths
(JSON for API clients, HTML for browsers). The batched path uploads a raw
uint8 canvas and normalizes it and builds the mask on the device; request
coalescing in front of it is ``serving.batching.CoalescingService``. The
batched path decodes with PIL on a thread pool or, with ``loader="native"``,
with the threaded libjpeg loader. The timing dicts' stage seconds are the
``.seconds`` of the spans ``serve.decode``, ``serve.extract``,
``serve.search`` and ``serve.rerank`` (``utils.tracing``).
"""

from __future__ import annotations

import json
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from email.parser import BytesParser
from email.policy import default as email_policy
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.images import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    load_test_image,
    load_test_images_native,
)
from ..device import resolve_device
from ..models.extract import extract_vectors_single, make_extract_fn
from ..ops.topk import _top_exact
from ..rerank.qe import qge1
from ..utils import tracing


def _diffusion_shortlist_scores(ids3, qvec, vecs_dev, off_ids, off_scores):
    """Diffusion online pass seeded from the index shortlist: dense (N,)
    scores from the ``ids3`` seeds' offline rows, weighted by each seed's
    similarity cubed. ``off_ids``/``off_scores`` are the whole device
    artifact (indexed by ``ids3``) or the seed rows already gathered from a
    host artifact. The seed rows are cast to the query's f32, as JAX's
    promotion of a bf16 gallery does; the f16 or f32 scores are summed in
    f32."""
    n = vecs_dev.shape[0]
    full = off_ids.shape[0] == n
    sims = vecs_dev[ids3].to(qvec.dtype) @ qvec                 # (s,) seed similarities
    w = sims.clamp(min=0.0) ** 3
    rows_i = off_ids[ids3] if full else off_ids                 # (s, T)
    rows_v = (off_scores[ids3] if full else off_scores).float() * w[:, None]
    dense = torch.zeros(n, dtype=torch.float32, device=vecs_dev.device)
    return dense.index_add_(0, rows_i.reshape(-1).long(), rows_v.reshape(-1))


def _diffusion_shortlist_scores_batch(ids3, qvecs, vecs_dev, off_ids, off_scores, k_out):
    """Batched diffusion online pass: ``ids3`` (B, s) seed ids per query, a
    (B, s, T) host gather or the whole device artifact; returns the top
    ``k_out`` (scores, ids) of each query's dense row."""
    n = vecs_dev.shape[0]
    B = ids3.shape[0]
    full = off_ids.shape[0] == n
    sims = torch.einsum("bsd,bd->bs", vecs_dev[ids3].to(qvecs.dtype), qvecs)
    w = sims.clamp(min=0.0) ** 3
    rows_i = off_ids[ids3] if full else off_ids                 # (B, s, T)
    rows_v = (off_scores[ids3] if full else off_scores).float() * w[:, :, None]
    dense = torch.zeros((B, n), dtype=torch.float32, device=vecs_dev.device)
    dense.scatter_add_(1, rows_i.reshape(B, -1).long(), rows_v.reshape(B, -1))
    return _top_exact(dense, k_out)


class SearchService:
    """Extraction + search + re-rank behind one object, on one device."""

    # batch-slot sizes: a batch is padded up to the smallest slot >= its size
    BATCH_SLOTS = (1, 2, 4, 8, 16, 32)

    def __init__(
        self,
        model,
        index,
        gallery_vecs: np.ndarray,
        gallery_paths: Sequence[str],
        K: int = 10,
        scales: Sequence[float] = (1.0,),
        image_size: int = 1024,
        rerank: "bool | str" = True,
        image_root: Optional[str] = None,
        diffusion_offline=None,
        loader: str = "pil",
        device="cuda",
    ):
        """``rerank``: ``"qge1"``/``True`` = one qge1 iteration;
        ``"diffusion"`` = random-walk re-rank seeded by the top 3 of the
        index shortlist against ``diffusion_offline`` (a
        ``rerank.DiffusionOffline`` on this device, or on the host, where
        only the seed rows are gathered); ``False``/``None`` = index order
        as-is. ``loader``: how ``prepare_batch`` decodes, ``"pil"`` (a
        thread pool) or ``"native"`` (the threaded libjpeg loader);
        ``query_image`` always decodes with PIL, as in JAX."""
        self.device = resolve_device(device)
        self.model = model
        self.index = index
        self.vecs = np.asarray(gallery_vecs, np.float32)
        self.paths = list(gallery_paths)
        self.image_root = image_root
        self.K = K
        self.scales = tuple(scales)
        self.image_size = image_size
        self.rerank = "qge1" if rerank is True else (rerank or None)
        if self.rerank not in (None, "qge1", "diffusion"):
            raise ValueError(f"unknown rerank mode: {rerank!r}")
        if loader not in ("pil", "native"):
            raise ValueError(f"unknown loader: {loader!r}")
        self.loader = loader
        self.diffusion_offline = diffusion_offline
        if self.rerank == "diffusion":
            if diffusion_offline is None:
                raise ValueError("rerank='diffusion' needs a diffusion_offline artifact")
            if (not diffusion_offline.on_host
                    and diffusion_offline.trunc_ids.device.type != self.device.type):
                raise ValueError(f"diffusion artifact is on {diffusion_offline.trunc_ids.device}, "
                                 f"service on {self.device}")
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, service on {self.device}")
        self._load_pool = ThreadPoolExecutor(max_workers=8)
        self._extract_fn = make_extract_fn(model.module, scales=self.scales)
        meta = getattr(model, "meta", None) or {}
        self._mean = torch.as_tensor(meta.get("mean", IMAGENET_MEAN), dtype=torch.float32,
                                     device=self.device)
        self._std = torch.as_tensor(meta.get("std", IMAGENET_STD), dtype=torch.float32,
                                    device=self.device)
        # one device copy of the gallery: share the index's when it holds the
        # same (L2-normalized) descriptors
        index_vecs = getattr(index, "vectors", None)
        if (torch.is_tensor(index_vecs) and tuple(index_vecs.shape) == self.vecs.shape
                and index_vecs.device.type == self.device.type):
            self._vecs_dev = index_vecs
        else:
            self._vecs_dev = torch.as_tensor(self.vecs, device=self.device)

    def close(self) -> None:
        self._load_pool.shutdown(wait=True)

    def _sync(self) -> None:
        """Wait for the device, so stage times measure the work, not its enqueue."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def resolve_image_path(self, img_id: int) -> str:
        p = self.paths[img_id]
        if self.image_root and not os.path.isabs(p):
            return os.path.join(self.image_root, p)
        return p

    def _rerank(self, idx: np.ndarray, qvecs: torch.Tensor) -> np.ndarray:
        """Re-rank the index shortlist ``idx`` (B, K) of queries ``qvecs``."""
        if self.rerank == "qge1":
            ranks = qge1(torch.as_tensor(idx, device=self.device), None, self._vecs_dev,
                         k=min(3, idx.shape[1]), out_k=min(self.K, self.vecs.shape[0]))
            return ranks.cpu().numpy()
        if self.rerank != "diffusion":
            return idx
        off = self.diffusion_offline
        seed_ids = idx[:, :min(3, idx.shape[1])]
        if off.on_host:       # gather only the seed rows, then upload them
            oi = torch.as_tensor(off.trunc_ids[seed_ids], device=self.device)
            os_ = torch.as_tensor(off.scores[seed_ids], device=self.device)
        else:
            oi, os_ = off.trunc_ids, off.scores
        seeds = torch.as_tensor(seed_ids, device=self.device)
        if qvecs.shape[0] == 1:
            dense = _diffusion_shortlist_scores(seeds[0], qvecs[0], self._vecs_dev,
                                                oi if not off.on_host else oi[0],
                                                os_ if not off.on_host else os_[0])
            top = _top_exact(dense[None], self.K)[1]
        else:
            top = _diffusion_shortlist_scores_batch(seeds, qvecs, self._vecs_dev, oi, os_,
                                                    self.K)[1]
        return top.cpu().numpy()

    def query_image(self, image_path: str) -> Tuple[List[dict], dict]:
        """Full serving path for one image; returns (results, timing)."""
        with tracing.span("serve.extract") as extract:
            qvec = extract_vectors_single(self.model, image_path, self.image_size,
                                          scales=self.scales)
        with tracing.span("serve.search") as search:
            _, idx = self.index.search(qvec[None, :], self.K)
            idx = idx.cpu().numpy()
        with tracing.span("serve.rerank") as rerank:
            final = self._rerank(idx, torch.as_tensor(qvec[None, :], device=self.device))[0]
        results = [
            {"rank": r, "path": self.paths[i], "id": int(i)}
            for r, i in enumerate(final[: self.K])
        ]
        timing = {"extract_s": extract.seconds, "search_s": search.seconds,
                  "rerank_s": rerank.seconds}
        return results, timing

    def query_batch(self, image_paths: Sequence[str]):
        """Batched serving path: one pass per stage for B queries, padded to
        a batch slot. Returns ``(results, timing)`` per path, in order; the
        results equal ``query_image`` of each path."""
        return self.execute_batch(self.prepare_batch(image_paths))

    def prepare_batch(self, image_paths: Sequence[str]):
        """Host half: decode (PIL on the thread pool, or the native
        loader's own threads) and pack raw uint8 images onto one square
        canvas (side = image_size rounded up to 32); pad slots replicate
        query 0 (never zeros: an all-false mask breaks masked pooling)."""
        B = len(image_paths)
        if B == 0:
            return None
        slot = next((s for s in self.BATCH_SLOTS if s >= B), B)
        with tracing.span("serve.decode") as decode:
            side = ((self.image_size + 31) // 32) * 32
            images = np.zeros((slot, side, side, 3), np.uint8)
            hw = np.zeros((slot, 2), np.int64)
            if self.loader == "native":
                arrays = load_test_images_native(image_paths, self.image_size, threads=8,
                                                 raw=True)
            else:
                arrays = list(self._load_pool.map(
                    lambda p: load_test_image(p, self.image_size, raw=True), image_paths
                ))
            for b, arr in enumerate(arrays):
                h, w = arr.shape[:2]
                images[b, :h, :w] = arr
                hw[b] = (h, w)
            for b in range(B, slot):
                images[b] = images[0]
                hw[b] = hw[0]
        return {"images": images, "hw": hw, "B": B, "slot": slot,
                "prepare_s": decode.seconds}

    def _extract_u8(self, u8: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
        """Normalize a raw uint8 canvas and build its validity mask on the
        device, then extract."""
        x = (u8.float() / 255.0 - self._mean) / self._std
        side_h, side_w = u8.shape[1], u8.shape[2]
        ih = torch.arange(side_h, device=u8.device)[None, :, None]
        iw = torch.arange(side_w, device=u8.device)[None, None, :]
        mask = (ih < hw[:, 0, None, None]) & (iw < hw[:, 1, None, None])
        return self._extract_fn(x, mask)

    def execute_batch(self, prepared):
        """Device half: extract -> search -> re-rank, every stage at the
        padded slot size; results are read for the first B rows."""
        if prepared is None:
            return []
        B, slot = prepared["B"], prepared["slot"]
        with tracing.span("serve.extract") as extract:
            qvecs = self._extract_u8(
                torch.from_numpy(prepared["images"]).to(self.device),
                torch.from_numpy(prepared["hw"]).to(self.device),
            )
            self._sync()
        with tracing.span("serve.search") as search:
            _, idx = self.index.search(qvecs, self.K)
            idx = idx.cpu().numpy()
        with tracing.span("serve.rerank") as rerank:
            final = self._rerank(idx, qvecs)
        timing = {
            "prepare_s": prepared["prepare_s"],
            "extract_s": extract.seconds,
            "search_s": search.seconds,
            "rerank_s": rerank.seconds,
            "batch": B,
            "slot": slot,
        }
        return [
            (
                [{"rank": r, "path": self.paths[i], "id": int(i)}
                 for r, i in enumerate(final[b][: self.K])],
                dict(timing),
            )
            for b in range(B)
        ]


_PAGE = """<!doctype html>
<html><head><title>Historical Image Search</title></head>
<body>
<h1>Historical Image Search</h1>
<form method="post" enctype="multipart/form-data">
  <input type="file" name="file" accept="image/*">
  <input type="submit" value="Search">
</form>
{results}
</body></html>"""


def _render_results_html(results, query_payload: Optional[bytes]) -> str:
    """Uploaded image (inline data URI) + top-K thumbnails from ``/image/<id>``."""
    import base64

    parts = []
    if query_payload:
        b64 = base64.b64encode(query_payload).decode()
        parts.append(
            '<h2>Query</h2><img src="data:image/jpeg;base64,'
            f'{b64}" height="160" alt="query">'
        )
    rows = "".join(
        f'<li>#{r["rank"]}: <a href="/image/{r["id"]}">'
        f'<img src="/image/{r["id"]}" height="120" '
        f'alt="{os.path.basename(r["path"])}"></a> '
        f'{os.path.basename(r["path"])}</li>'
        for r in results
    )
    parts.append(f"<h2>Results</h2><ol start=0>{rows}</ol>")
    return "".join(parts)


def _parse_upload(environ) -> Optional[bytes]:
    """Extract the uploaded file from a multipart POST (or raw image body)."""
    ctype = environ.get("CONTENT_TYPE", "")
    length = int(environ.get("CONTENT_LENGTH") or 0)
    body = environ["wsgi.input"].read(length)
    if ctype.startswith("multipart/form-data"):
        msg = BytesParser(policy=email_policy).parsebytes(
            b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body
        )
        for part in msg.iter_parts():
            if part.get_filename():
                return part.get_payload(decode=True)
        return None
    if ctype.startswith("image/") and body:
        return body
    return None


def make_wsgi_app(service: SearchService):
    """WSGI callable: GET / form, POST / query, GET /image/<id> thumbnails."""

    def app(environ, start_response):
        method = environ["REQUEST_METHOD"]
        path = environ.get("PATH_INFO", "/") or "/"
        if method == "GET" and path.startswith("/image/"):
            import mimetypes

            try:
                img_path = service.resolve_image_path(int(path[len("/image/"):]))
            except (ValueError, IndexError):
                start_response("404 Not Found", [("Content-Type", "text/plain")])
                return [b"no such image"]
            if not os.path.exists(img_path):
                start_response("404 Not Found", [("Content-Type", "text/plain")])
                return [b"image file missing"]
            ctype = mimetypes.guess_type(img_path)[0] or "application/octet-stream"
            with open(img_path, "rb") as f:
                data = f.read()
            start_response("200 OK", [("Content-Type", ctype)])
            return [data]

        if method == "GET":
            start_response("200 OK", [("Content-Type", "text/html")])
            return [_PAGE.format(results="").encode()]

        if method == "POST":
            payload = _parse_upload(environ)
            if not payload:
                start_response("400 Bad Request", [("Content-Type", "application/json")])
                return [b'{"error": "no image uploaded"}']
            with tempfile.NamedTemporaryFile(suffix=".jpg", delete=False) as f:
                f.write(payload)
                tmp = f.name
            try:
                results, timing = service.query_image(tmp)
            finally:
                os.unlink(tmp)
            if "application/json" in environ.get("HTTP_ACCEPT", ""):
                start_response("200 OK", [("Content-Type", "application/json")])
                return [json.dumps({"results": results, "timing": timing}).encode()]
            page = _PAGE.format(results=_render_results_html(results, payload))
            start_response("200 OK", [("Content-Type", "text/html")])
            return [page.encode()]

        start_response("405 Method Not Allowed", [("Content-Type", "text/plain")])
        return [b"method not allowed"]

    return app


def serve(service: SearchService, host: str = "0.0.0.0", port: int = 8080,
          threaded: bool = False):
    """Blocking dev server (``wsgiref``). ``threaded=True`` handles each
    request on its own thread, which ``serving.batching.CoalescingService``
    needs to see concurrent requests at all."""
    import socketserver
    from wsgiref.simple_server import WSGIServer, make_server

    cls = WSGIServer
    if threaded:
        class cls(socketserver.ThreadingMixIn, WSGIServer):  # noqa: N801
            daemon_threads = True

    httpd = make_server(host, port, make_wsgi_app(service), server_class=cls)
    print(f"serving on http://{host}:{port}")
    httpd.serve_forever()
