"""Online serving: the query service and its WSGI app."""

from .app import SearchService, make_wsgi_app, serve

__all__ = ["SearchService", "make_wsgi_app", "serve"]
