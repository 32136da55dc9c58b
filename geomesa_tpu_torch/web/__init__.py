"""REST layer (geomesa-web analog): WSGI app over the port's
TpuDataStore, whose queries, tiles and mosaics run on the card."""

from .app import WebApp, serve

__all__ = ["WebApp", "serve"]
