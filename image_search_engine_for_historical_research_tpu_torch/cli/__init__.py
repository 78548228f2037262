"""Command-line entry points.

- ``online`` -- the query service over WSGI (``--matching-method HNSW``).
"""
