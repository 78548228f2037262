"""Online serving: the query service, its WSGI app and request coalescing."""

from .app import SearchService, make_wsgi_app, serve
from .batching import CoalescingService

__all__ = ["SearchService", "CoalescingService", "make_wsgi_app", "serve"]
