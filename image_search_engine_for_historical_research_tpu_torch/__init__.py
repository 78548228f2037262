"""PyTorch + CUDA port of the historical image-search engine.

The counterpart of ``image_search_engine_for_historical_research_tpu`` (the JAX
package, which stays the reference), written for one NVIDIA H100:

- ``ops``      -- normalization, pooling, exact scores, the HNSW upper-level
                  descent and the level-0 beam search (a CUDA kernel in
                  ``csrc/beam_search.cu`` with its plain PyTorch version),
                  k-means, PQ, int8, hashing, whitening, tuple losses, soft PQ.
- ``models``   -- ResNet101 + SOA (SOLAR) descriptor model (with the training
                  knobs ``frozen_stages`` and ``remat``), weight loading in the
                  SOLAR checkpoint layout, multi-scale extraction.
- ``index``    -- the artifact registry and every index backend.
- ``rerank``   -- query expansion, diffusion, k-reciprocal.
- ``serving``  -- the online query service, its WSGI app, request coalescing.
- ``train``    -- tuple mining, the optimizer groups, the train step, ``Trainer``.
- ``cli``      -- ``offline``, ``online``, ``benchmark``, ``extract_1m``,
                  ``train`` and the evaluation CLIs.
- ``data``     -- image loading (PIL and the native JPEG loader), the npz
                  feature store (whole and sharded), synthetic datasets.
- ``native``   -- build of the C++ HNSW graph construction, of the JPEG loader
                  and of the CUDA kernels.
- ``utils``    -- timers, device traces, the metrics log.

Conventions are the JAX package's at every public function: NHWC images,
``(B, H, W)`` masks, row-major ``(N, D)`` descriptors, ``(Q, k)`` ranks and
larger-is-better scores. Entry points take a ``device`` argument that defaults
to ``"cuda"``; ``device="cpu"`` runs every kernel's plain PyTorch version.

The package imports ``torch``, ``numpy`` and the standard library only.
"""

__version__ = "0.1.0"
