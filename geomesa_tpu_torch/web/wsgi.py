"""Shared WSGI plumbing for the REST apps (web data/stats app, GeoJSON
servlet): status lines, regex-route dispatch, param/body parsing, and
the bounded-concurrency server wrapper; the port's copy of the JAX
package's ``web/wsgi.py``."""

from __future__ import annotations

import json
import re
import threading
import time
from urllib.parse import parse_qs, unquote

__all__ = ["HttpError", "STATUS", "read_json_body", "Router",
           "StreamingBody", "int_param", "float_param", "bool_param",
           "BoundedApp", "make_bounded_server"]

STATUS = {200: "200 OK", 201: "201 Created", 204: "204 No Content",
          400: "400 Bad Request", 404: "404 Not Found",
          405: "405 Method Not Allowed", 500: "500 Internal Server Error",
          503: "503 Service Unavailable", 504: "504 Gateway Timeout"}


class HttpError(Exception):
    def __init__(self, status: int, message: str, headers=None):
        super().__init__(message)
        self.status = status
        self.message = message
        #: extra response headers, e.g. Retry-After on a 503 shed
        self.headers = list(headers or ())


def read_json_body(environ) -> dict:
    try:
        n = int(environ.get("CONTENT_LENGTH") or 0)
        raw = environ["wsgi.input"].read(n) if n else b""
        if not raw:
            raise ValueError("empty request body")
        return json.loads(raw)
    except (ValueError, KeyError) as e:
        raise HttpError(400, f"bad request body: {e}")


def int_param(params: dict, name: str, default=None) -> int | None:
    if name not in params:
        return default
    try:
        return int(params[name])
    except ValueError:
        raise HttpError(400, f"bad {name!r} parameter: {params[name]!r}")


def float_param(params: dict, name: str, default=None) -> float | None:
    if name not in params:
        return default
    try:
        return float(params[name])
    except ValueError:
        raise HttpError(400, f"bad {name!r} parameter: {params[name]!r}")


def bool_param(params: dict, name: str, default: bool = False) -> bool:
    """Strict flag parsing: unrecognized values are a 400, not a
    silent false (a typoed ``?slow=ture`` must not quietly serve the
    wrong surface)."""
    if name not in params:
        return default
    v = str(params[name]).strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off", ""):
        return False
    raise HttpError(400, f"bad {name!r} parameter: {params[name]!r}")


class StreamingBody:
    """A chunked response body: the handler returns an ITERABLE of
    byte chunks and the dispatcher streams them to the WSGI server as
    they are produced (no Content-Length — the server closes or
    chunk-encodes), instead of buffering the whole payload.  The
    Arrow-IPC result stream (``/query?format=arrow``) emits record
    batches this way as the store materializes them."""

    def __init__(self, chunks):
        self.chunks = chunks

    def __iter__(self):
        for c in self.chunks:
            yield c if isinstance(c, bytes) else bytes(c)


def _resilience_error(e):
    """Map resilience signals to HTTP: Backpressure → 503 with
    Retry-After (the client should back off and retry), QueryTimeout →
    504 (the deadline the CLIENT set expired — retrying with the same
    budget will time out again unless load drops)."""
    from ..resilience import Backpressure, QueryTimeout
    if isinstance(e, Backpressure):
        return HttpError(
            503, str(e),
            headers=[("Retry-After",
                      str(max(1, int(round(e.retry_after_s)))))])
    if isinstance(e, QueryTimeout):
        return HttpError(504, str(e))
    return None


class Router:
    """Regex-route table with shared dispatch/error handling.

    Handlers receive ``(method, params, environ, *groups)`` and return
    ``(status, body, content_type)`` — body str/bytes/None/
    :class:`StreamingBody`, or any JSON-serializable object when
    content_type is omitted.
    """

    def __init__(self, routes):
        self.routes = [(re.compile(p), h) for p, h in routes]

    def dispatch(self, environ, start_response, on_metrics=None):
        path = environ.get("PATH_INFO", "/")
        method = environ.get("REQUEST_METHOD", "GET")
        # keep_blank_values: a blank ``?schema=`` must reach the
        # handler (strict-400 surface), not silently vanish as if the
        # parameter were never sent
        params = {k: v[0] for k, v in
                  parse_qs(environ.get("QUERY_STRING", ""),
                           keep_blank_values=True).items()}
        ctype = "application/json"
        headers: list = []
        try:
            for pattern, handler in self.routes:
                m = pattern.match(path)
                if m:
                    out = handler(method, params, environ,
                                  *[unquote(g) for g in m.groups()])
                    status, body = out[0], out[1]
                    if len(out) > 2:
                        ctype = out[2]
                    break
            else:
                raise HttpError(404, f"no such route: {path}")
        except HttpError as e:
            status, body, headers = e.status, {"error": e.message}, e.headers
        except (ValueError,) as e:
            status, body = 400, {"error": str(e)}
        except KeyError as e:
            status, body = 404, {"error": str(e)}
        except Exception as e:  # noqa: BLE001 — no internals in the response
            mapped = _resilience_error(e)
            if mapped is not None:
                status, body = mapped.status, {"error": mapped.message}
                headers = mapped.headers
            else:
                status, body = 500, {"error": f"{type(e).__name__}: {e}"}
        if isinstance(body, StreamingBody):
            # chunked path: the body generates as the store produces
            # it, so there is no Content-Length to announce, and the
            # request metrics must cover the WHOLE drain (most of a
            # streamed query's wall time is the stream), firing from
            # the generator's finally — including client disconnects
            # and mid-stream failures (counted separately: the 200
            # status line is already on the wire by then)
            start_response(STATUS.get(status, f"{status} Error"),
                           [("Content-Type", ctype)] + headers)

            def _stream():
                # drain time (the SLO web_drain stage): how long the
                # client + socket took to consume the body — wall time
                # the datastore root span cannot see
                t_drain = time.perf_counter()
                try:
                    yield from body
                except Exception:
                    if on_metrics is not None:
                        on_metrics(status, aborted=True, drain_ms=(
                            time.perf_counter() - t_drain) * 1e3)
                    raise
                else:
                    if on_metrics is not None:
                        on_metrics(status, drain_ms=(
                            time.perf_counter() - t_drain) * 1e3)

            return _stream()
        if on_metrics is not None:
            on_metrics(status)
        if not isinstance(body, (str, bytes, type(None))):
            body = json.dumps(body)
        payload = (body.encode() if isinstance(body, str)
                   else (body or b""))
        start_response(STATUS.get(status, f"{status} Error"), [
            ("Content-Type", ctype),
            ("Content-Length", str(len(payload)))] + headers)
        return [payload]


class BoundedApp:
    """WSGI middleware capping in-flight requests at ``max_concurrent``.

    The stock ``wsgiref`` threading server spawns one UNBOUNDED thread
    per connection — under a connection flood every request gets a
    thread, they all pile onto the store's locks, and the process dies
    by memory instead of shedding.  This wraps
    the app with a non-blocking semaphore: over the cap, the request is
    answered 503 + Retry-After immediately — no handler runs, no store
    lock is touched.  The slot is held until the RESPONSE BODY is fully
    drained (streaming bodies do their work during iteration), released
    exactly once via the closing wrapper's finally."""

    def __init__(self, app, max_concurrent: int = 32,
                 retry_after_s: int = 1):
        self.app = app
        self.max_concurrent = max(1, int(max_concurrent))
        self.retry_after_s = max(1, int(retry_after_s))
        self._sem = threading.Semaphore(self.max_concurrent)

    def __call__(self, environ, start_response):
        if not self._sem.acquire(blocking=False):
            from ..metrics import QUERY_SHED, registry as _metrics
            _metrics.counter(QUERY_SHED).inc()
            payload = json.dumps(
                {"error": "server saturated; retry later"}).encode()
            start_response(STATUS[503], [
                ("Content-Type", "application/json"),
                ("Content-Length", str(len(payload))),
                ("Retry-After", str(self.retry_after_s))])
            return [payload]
        try:
            body = self.app(environ, start_response)
        except BaseException:
            self._sem.release()
            raise
        return self._drain(body)

    def _drain(self, body):
        try:
            yield from body
        finally:
            close = getattr(body, "close", None)
            if close is not None:
                close()
            self._sem.release()


def make_bounded_server(host: str, port: int, app,
                        max_concurrent: int = 32):
    """A threading ``wsgiref`` server wrapping ``app`` in
    :class:`BoundedApp`: concurrent requests each get a thread (a
    long-lived Arrow stream must not block /metrics.prom), but past the
    cap new requests shed 503 instead of growing the thread pile."""
    from socketserver import ThreadingMixIn
    from wsgiref.simple_server import WSGIServer, make_server

    class _ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
        daemon_threads = True

    return make_server(host, port, BoundedApp(app, max_concurrent),
                       server_class=_ThreadingWSGIServer)
