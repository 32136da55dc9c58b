"""REST endpoints for the GeoJSON API.

The analog of the reference's GeoJsonServlet
(geomesa-geojson/geomesa-geojson-rest/.../servlet/GeoJsonServlet.scala),
as a WSGI app (mountable standalone or under
:class:`~geomesa_tpu_torch.web.WebApp` via ``geojson=``).

Routes::

    GET    /geojson/index                              list indices
    POST   /geojson/index/{name}?id=&dtg=&points=      create index
    DELETE /geojson/index/{name}                       delete index
    POST   /geojson/index/{name}/features              add (Feature/FC)
    PUT    /geojson/index/{name}/features              update by id-path
    GET    /geojson/index/{name}/features/{id}         get by id
    DELETE /geojson/index/{name}/features/{id}
    GET    /geojson/index/{name}/query?q={json}        query
"""

from __future__ import annotations

import json

from ..web.wsgi import HttpError, Router, read_json_body

__all__ = ["GeoJsonApp"]


class GeoJsonApp:
    def __init__(self, index=None):
        from .index import GeoJsonIndex
        self.index = index if index is not None else GeoJsonIndex()
        self._router = Router([
            (r"^/geojson/index$", self._list),
            (r"^/geojson/index/([^/]+)$", self._index),
            (r"^/geojson/index/([^/]+)/features$", self._features),
            (r"^/geojson/index/([^/]+)/features/([^/]+)$", self._feature),
            (r"^/geojson/index/([^/]+)/query$", self._query),
        ])

    def __call__(self, environ, start_response):
        return self._router.dispatch(environ, start_response)

    def _list(self, method, params, environ):
        if method != "GET":
            raise HttpError(405, method)
        return 200, self.index.index_names

    def _index(self, method, params, environ, name):
        if method == "POST":
            self.index.create_index(
                name, id_path=params.get("id"), dtg_path=params.get("dtg"),
                points=params.get("points", "false").lower() == "true")
            return 201, {"created": name}
        if method == "DELETE":
            self.index.delete_index(name)
            return 204, None
        raise HttpError(405, method)

    def _features(self, method, params, environ, name):
        if method == "POST":
            ids = self.index.add(name, read_json_body(environ))
            return 201, {"ids": ids}
        if method == "PUT":
            self.index.update(name, read_json_body(environ))
            return 200, {"updated": True}
        raise HttpError(405, method)

    def _feature(self, method, params, environ, name, fid):
        if method == "GET":
            got = self.index.get(name, fid)
            if not got:
                raise HttpError(404, f"no such feature: {fid!r}")
            return 200, got[0]
        if method == "DELETE":
            n = self.index.delete(name, fid)
            if not n:
                raise HttpError(404, f"no such feature: {fid!r}")
            return 204, None
        raise HttpError(405, method)

    def _query(self, method, params, environ, name):
        if method != "GET":
            raise HttpError(405, method)
        transform = (json.loads(params["transform"])
                     if "transform" in params else None)
        hits = self.index.query(name, params.get("q"), transform=transform)
        if transform:
            return 200, hits
        return 200, {"type": "FeatureCollection", "features": hits}
