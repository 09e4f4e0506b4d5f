"""The live ops plane: a stdlib ``http.server`` endpoint an operator
(or a scraper) can hit while the fleet serves.

Counterpart of ``hpx_tpu.svc.opsplane``.  One background daemon thread
runs a
``ThreadingHTTPServer`` (loopback by default) with five read-only
views:

``/varz``
    Prometheus text exposition of the whole counter registry, with
    content-type negotiation: an ``Accept: application/
    openmetrics-text`` scrape gets OpenMetrics 1.0 — tail-bucket
    exemplars on the ``_bucket`` rows and a ``# EOF`` terminator.
``/statusz``
    JSON: per-provider server/fleet/worker state (queue depths, live
    slots, autoscale state), the tuner flight snapshot, tier
    occupancy, and the heartbeat table (empty: the distributed
    runtime's localities are not ported yet).
``/tracez``
    The recent slowest completed spans sampled from the live trace
    ring (empty list when tracing is off).
``/flightz``
    The flight-bundle index (the same ``flight.bundle_index()`` the
    ``list`` CLI prints), and ``/flightz?fetch=<name>`` returns one
    bundle's JSON.
``/healthz``
    SLO burn state merged across live ``SloAlerts`` evaluators; HTTP
    503 while any alert is firing, so a load balancer can shed.

Wiring: ``ensure_opsplane()`` reads ``hpx.obs.port`` (``-1`` = off,
``0`` = ephemeral, ``>0`` = fixed) and starts the process-wide plane
once; ContinuousServer, DisaggRouter and FleetRouter register weakref
statusz providers on construction, so ONE router port exposes the
merged fleet view and a dead server silently drops out (the
cache/counters weakref discipline).  On a mesh only rank 0 starts the
plane.

Every view reads host state: a scrape runs on the plane's threads and
never synchronizes the device, so it cannot stall a decode step.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from . import tracing
from ..synchronization import Mutex

__all__ = [
    "OpsPlane",
    "start_opsplane",
    "ensure_opsplane",
    "active_opsplane",
    "stop_opsplane",
    "register_provider",
]


def _cfg():
    from ..core.config import runtime_config
    return runtime_config()


def _heartbeat_table() -> Dict[str, str]:
    """ALIVE/SUSPECT/DEAD per known locality: {} here, as the
    reference answers outside a distributed run (the distributed
    runtime and its heartbeats are not ported yet)."""
    return {}


class _Handler(BaseHTTPRequestHandler):
    # self.server is the _HTTPServer below, which carries the plane

    def log_message(self, fmt: str, *args: Any) -> None:
        pass                       # an ops scrape must not spam stderr

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, doc: Any, code: int = 200) -> None:
        body = json.dumps(doc, indent=1, default=repr).encode()
        self._send(code, body, "application/json; charset=utf-8")

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        try:
            url = urlparse(self.path)
            route = url.path.rstrip("/") or "/"
            plane = self.server.plane
            if route == "/varz":
                from . import metrics
                om, ctype = metrics.negotiate_exposition(
                    self.headers.get("Accept"))
                self._send(200, metrics.render_prometheus(
                    openmetrics=om).encode(), ctype)
            elif route == "/statusz":
                self._send_json(plane.statusz())
            elif route == "/tracez":
                self._send_json(plane.tracez())
            elif route == "/flightz":
                q = parse_qs(url.query)
                name = (q.get("fetch") or [None])[0]
                if name is None:
                    from . import flight
                    self._send_json({"bundles": flight.bundle_index()})
                else:
                    doc = plane.flight_fetch(name)
                    if doc is None:
                        self._send_json({"error": "no such bundle",
                                         "name": name}, code=404)
                    else:
                        self._send_json(doc)
            elif route == "/healthz":
                from . import slo_alerts
                doc = slo_alerts.health_state()
                self._send_json(
                    doc, code=503 if doc["status"] == "alerting"
                    else 200)
            elif route == "/":
                self._send_json({"endpoints": ["/varz", "/statusz",
                                               "/tracez", "/flightz",
                                               "/healthz"]})
            else:
                self._send_json({"error": "no such route",
                                 "path": route}, code=404)
        except BrokenPipeError:
            pass
        except Exception as e:  # a bad scrape must not kill the plane
            try:
                self._send_json({"error": repr(e)}, code=500)
            except Exception:
                pass


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    plane: "OpsPlane"


class OpsPlane:
    """One background HTTP endpoint; providers contribute /statusz
    sections.  Providers are named callables returning a JSON-safe
    dict (or None to skip); they are expected to close over weakrefs
    so the plane never pins a server."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._srv = _HTTPServer((host, port), _Handler)
        self._srv.plane = self
        self.host = host
        self.port = int(self._srv.server_address[1])
        self.url = f"http://{host}:{self.port}"
        self.started = time.time()
        self._providers: "Dict[str, Callable[[], Any]]" = {}
        self._lock = Mutex()
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="hpx-opsplane",
            daemon=True)
        self._thread.start()

    # -- providers ----------------------------------------------------

    def add_provider(self, name: str,
                     fn: Callable[[], Any]) -> None:
        with self._lock:
            self._providers[name] = fn

    def remove_provider(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    # -- views --------------------------------------------------------

    def statusz(self) -> Dict[str, Any]:
        from . import autotune
        from ..cache import tier as _tier
        with self._lock:
            providers = dict(self._providers)
        out: Dict[str, Any] = {
            "wall_time": time.time(),
            "pid": os.getpid(),
            "uptime_s": round(time.time() - self.started, 3),
            "tune": autotune.flight_snapshot(),
            "tier": _tier.flight_snapshot(),
            "heartbeats": _heartbeat_table(),
            "providers": {},
        }
        dead: List[str] = []
        for name in sorted(providers):
            try:
                doc = providers[name]()
            except Exception as e:
                doc = {"error": repr(e)}
            if doc is None:        # weakref target died: prune
                dead.append(name)
                continue
            out["providers"][name] = doc
        for name in dead:
            self.remove_provider(name)
        return out

    def tracez(self, limit: int = 32) -> Dict[str, Any]:
        tr = tracing.active_tracer()
        if tr is None:
            return {"tracing": False, "spans": []}
        from . import trace_export
        return {
            "tracing": True,
            "dropped": tr.dropped,
            "spans": trace_export.slow_spans(tr.snapshot(), tr.t0,
                                             limit=limit),
        }

    def flight_fetch(self, name: str) -> Optional[Dict[str, Any]]:
        """One bundle by basename — constrained to real bundle names
        inside the flight dir (no path traversal from a URL)."""
        from . import flight
        name = os.path.basename(name)
        if not (name.startswith("flight-") and name.endswith(".json")):
            return None
        path = os.path.join(flight.flight_dir(), name)
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # -- lifecycle ----------------------------------------------------

    def close(self) -> None:
        try:
            self._srv.shutdown()
            self._srv.server_close()
        finally:
            self._thread.join(timeout=2.0)


# process-wide singleton, the same discipline as tracing._active
_plane: Optional[OpsPlane] = None


def start_opsplane(host: Optional[str] = None,
                   port: Optional[int] = None) -> OpsPlane:
    """Start (or return) the process-wide plane.  Explicit arguments
    override the ``hpx.obs.host``/``hpx.obs.port`` knobs — tests pass
    ``port=0`` for an ephemeral OS-assigned port."""
    global _plane
    if _plane is not None:
        return _plane
    cfg = _cfg()
    if host is None:
        host = cfg.get("hpx.obs.host", "127.0.0.1") or "127.0.0.1"
    if port is None:
        port = max(0, cfg.get_int("hpx.obs.port", -1))
    _plane = OpsPlane(host, port)
    return _plane


def ensure_opsplane() -> Optional[OpsPlane]:
    """Config-gated start: None (and no socket, no thread) unless
    ``hpx.obs.port`` >= 0.  Servers call this from __init__; the
    is-None result is the zero-overhead gate."""
    if _plane is not None:
        return _plane
    if _cfg().get_int("hpx.obs.port", -1) < 0:
        return None
    return start_opsplane()


def active_opsplane() -> Optional[OpsPlane]:
    return _plane


def stop_opsplane() -> None:
    global _plane
    if _plane is not None:
        _plane.close()
        _plane = None


def register_provider(name: str, owner: Any,
                      fn: Callable[[Any], Any]) -> None:
    """Attach a weakref statusz provider for ``owner`` to the active
    plane (no-op when the plane is off).  ``fn(owner)`` builds the
    section; after ``owner`` dies the provider returns None once and
    is pruned."""
    plane = active_opsplane()
    if plane is None:
        return
    ref = weakref.ref(owner)

    def provider() -> Any:
        o = ref()
        if o is None:
            return None
        return fn(o)

    plane.add_provider(name, provider)
