"""Command-line entry points.

- ``offline``        -- extract a gallery, save its feature store, build its index.
- ``online``         -- the query service over WSGI (``--matching-method L2 | HNSW``,
  ``--coalesce``).
- ``benchmark``      -- the revisited Oxford/Paris mAP protocol (``--qge``: alphaQE
  + diffusion).
- ``test_reranking`` -- revisited mAP of each global re-ranking method.
- ``test_custom``    -- folder-label mAP on custom folders, ranks saved on request.
- ``retrieve``       -- ``benchmark`` or ``test_custom`` by ``--mode``.
"""
