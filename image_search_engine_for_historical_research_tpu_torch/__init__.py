"""PyTorch + CUDA port of the historical image-search engine.

The counterpart of ``image_search_engine_for_historical_research_tpu`` (the JAX
package, which stays the reference), written for one NVIDIA H100:

- ``ops``      -- normalization, pooling, exact scores, the HNSW upper-level
                  descent and the level-0 beam search (a CUDA kernel in
                  ``csrc/beam_search.cu`` with its plain PyTorch version).
- ``models``   -- ResNet101 + SOA (SOLAR) descriptor model, weight loading in
                  the SOLAR checkpoint layout, multi-scale extraction.
- ``index``    -- the artifact registry and the HNSW index.
- ``rerank``   -- qge1 query expansion.
- ``serving``  -- the online query service and its WSGI app.
- ``cli``      -- ``python -m image_search_engine_for_historical_research_tpu_torch.cli.online``.
- ``data``     -- image loading and the npz feature store.
- ``native``   -- build of the C++ HNSW graph construction and of the CUDA kernels.

Conventions are the JAX package's at every public function: NHWC images,
``(B, H, W)`` masks, row-major ``(N, D)`` descriptors, ``(Q, k)`` ranks and
larger-is-better scores. Entry points take a ``device`` argument that defaults
to ``"cuda"``; ``device="cpu"`` runs every kernel's plain PyTorch version.

The package imports ``torch``, ``numpy`` and the standard library only.
"""

__version__ = "0.1.0"
