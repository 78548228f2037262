"""Command-line entry points.

- ``offline``   -- extract a gallery, save its feature store, build its index.
- ``online``    -- the query service over WSGI (``--matching-method L2 | HNSW``).
- ``benchmark`` -- the revisited Oxford/Paris mAP protocol.
"""
