"""Online query service: extraction + HNSW search + qge1 behind a WSGI app.

Port of ``image_search_engine_for_historical_research_tpu/serving/app.py``
(:103-376, :379-513) in its ``qge1`` and no-rerank modes: load the network
and the gallery at startup, take an uploaded image on ``POST /``, extract its
descriptor, search the index, re-rank with one qge1 iteration and return the
top-K gallery paths (JSON for API clients, HTML for browsers). The batched
path uploads a raw uint8 canvas and normalizes it and builds the mask on the
device. ``rerank="diffusion"``, the native JPEG loader and request coalescing
(``serving/batching.py``) are not ported yet.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from email.parser import BytesParser
from email.policy import default as email_policy
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.images import IMAGENET_MEAN, IMAGENET_STD, load_test_image
from ..device import resolve_device
from ..models.extract import extract_vectors_single, make_extract_fn
from ..rerank.qe import qge1


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
        device="cuda",
    ):
        """``rerank``: ``"qge1"``/``True`` = one qge1 iteration;
        ``False``/``None`` = index order as-is."""
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
        if self.rerank == "diffusion":
            raise NotImplementedError("rerank='diffusion' is not ported yet (ROADMAP)")
        if self.rerank not in (None, "qge1"):
            raise ValueError(f"unknown rerank mode: {rerank!r}")
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, service on {self.device}")
        self._load_pool = ThreadPoolExecutor(max_workers=8)
        self._extract_fn = make_extract_fn(model.module, scales=self.scales)
        self._mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.as_tensor(IMAGENET_STD, device=self.device)
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

    def _rerank(self, idx: np.ndarray) -> np.ndarray:
        if self.rerank != "qge1":
            return idx
        ranks = qge1(torch.as_tensor(idx, device=self.device), None, self._vecs_dev,
                     k=min(3, idx.shape[1]), out_k=min(self.K, self.vecs.shape[0]))
        return ranks.cpu().numpy()

    def query_image(self, image_path: str) -> Tuple[List[dict], dict]:
        """Full serving path for one image; returns (results, timing)."""
        t0 = time.perf_counter()
        qvec = extract_vectors_single(self.model, image_path, self.image_size,
                                      scales=self.scales)
        t1 = time.perf_counter()
        _, idx = self.index.search(qvec[None, :], self.K)
        idx = idx.cpu().numpy()
        t2 = time.perf_counter()
        final = self._rerank(idx)[0]
        t3 = time.perf_counter()
        results = [
            {"rank": r, "path": self.paths[i], "id": int(i)}
            for r, i in enumerate(final[: self.K])
        ]
        timing = {"extract_s": t1 - t0, "search_s": t2 - t1, "rerank_s": t3 - t2}
        return results, timing

    def query_batch(self, image_paths: Sequence[str]):
        """Batched serving path: one pass per stage for B queries, padded to
        a batch slot. Returns ``(results, timing)`` per path, in order; the
        results equal ``query_image`` of each path."""
        return self.execute_batch(self.prepare_batch(image_paths))

    def prepare_batch(self, image_paths: Sequence[str]):
        """Host half: decode and pack raw uint8 images onto one square canvas
        (side = image_size rounded up to 32); pad slots replicate query 0
        (never zeros: an all-false mask breaks masked pooling)."""
        B = len(image_paths)
        if B == 0:
            return None
        slot = next((s for s in self.BATCH_SLOTS if s >= B), B)
        t0 = time.perf_counter()
        side = ((self.image_size + 31) // 32) * 32
        images = np.zeros((slot, side, side, 3), np.uint8)
        hw = np.zeros((slot, 2), np.int64)
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
                "prepare_s": time.perf_counter() - t0}

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
        t0 = time.perf_counter()
        qvecs = self._extract_u8(
            torch.from_numpy(prepared["images"]).to(self.device),
            torch.from_numpy(prepared["hw"]).to(self.device),
        )
        self._sync()
        t1 = time.perf_counter()
        _, idx = self.index.search(qvecs, self.K)
        idx = idx.cpu().numpy()
        t2 = time.perf_counter()
        final = self._rerank(idx)
        t3 = time.perf_counter()
        timing = {
            "prepare_s": prepared["prepare_s"],
            "extract_s": t1 - t0,
            "search_s": t2 - t1,
            "rerank_s": t3 - t2,
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


def serve(service: SearchService, host: str = "0.0.0.0", port: int = 8080):
    """Blocking single-threaded dev server (``wsgiref``)."""
    from wsgiref.simple_server import make_server

    httpd = make_server(host, port, make_wsgi_app(service))
    print(f"serving on http://{host}:{port}")
    httpd.serve_forever()
