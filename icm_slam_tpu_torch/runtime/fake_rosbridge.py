"""In-process rosbridge loopback: a TCP server speaking the rosbridge v2
JSON op protocol, and a roslibpy-compatible client shim (standard library
only).

A copy of ``icm_slam_tpu.runtime.fake_rosbridge``.  The reference's primary
operating mode is a live rosbridge websocket feed (ICM_SLAM.py:276-299);
roslibpy is not a dependency, so this module makes the transport path run
without network infrastructure or a roscore:

* ``FakeRosBridgeServer`` — a loopback TCP server implementing the
  rosbridge ops the runtime uses (subscribe / advertise / publish /
  advertise_service / call_service / service_response), newline-delimited
  JSON over a real socket: every message crosses a serialization and a
  thread boundary, like the reference's websocket (the framing differs —
  JSON lines instead of websocket frames — the op protocol is the same).
* ``client_module()`` — a module-like shim exposing the ``roslibpy``
  subset the runtime uses (``Ros``/``Topic``/``Service``/``Message``),
  implemented against the fake server.  Installing it as
  ``sys.modules["roslibpy"]`` lets ``RosBridgeSource`` (runtime/ingest.py)
  and ``publish_to_rosbridge`` (runtime/replay.py) run unchanged.

Callbacks run on the client's reader thread — the threading shape of
roslibpy's Twisted thread, so the FrameSynchronizer's locking is exercised
for real.
"""
from __future__ import annotations

import itertools
import json
import socket
import threading
import types
from typing import Dict, List, Optional, Tuple


class _Conn:
    """One JSON-lines connection (thread-safe writes)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rfile = sock.makefile("r", encoding="utf-8")
        self._wlock = threading.Lock()

    def send(self, obj: dict):
        data = (json.dumps(obj) + "\n").encode("utf-8")
        with self._wlock:
            self.sock.sendall(data)

    def close(self):
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class FakeRosBridgeServer:
    """Loopback rosbridge: routes publish fan-out and service calls."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._lock = threading.Lock()
        self._subs: Dict[str, List[_Conn]] = {}
        self._services: Dict[str, _Conn] = {}
        self._pending: Dict[Tuple[str, object], _Conn] = {}
        self._conns: List[_Conn] = []
        self._threads: List[threading.Thread] = []
        self._running = False
        self.stats = {"published": 0, "service_calls": 0, "connections": 0}

    def start(self) -> "FakeRosBridgeServer":
        self._running = True
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self):
        self._running = False
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            c.close()
        self._srv.close()

    # ------------------------------------------------------------------
    def _accept_loop(self):
        while self._running:
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return
            conn = _Conn(sock)
            with self._lock:
                self._conns.append(conn)
                self.stats["connections"] += 1
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: _Conn):
        for line in conn.rfile:
            if not line.strip():
                continue
            try:
                self._handle(conn, json.loads(line))
            except (OSError, ValueError):
                break
        self._forget(conn)

    def _forget(self, conn: _Conn):
        """Remove every registration of a disconnected peer."""
        with self._lock:
            if conn in self._conns:
                self._conns.remove(conn)
            for subs in self._subs.values():
                if conn in subs:
                    subs.remove(conn)
            for svc in [s for s, c in self._services.items() if c is conn]:
                del self._services[svc]
            for key in [k for k, c in self._pending.items() if c is conn]:
                del self._pending[key]

    def _safe_send(self, conn: _Conn, obj: dict) -> bool:
        """Send to a peer; a dead peer is dropped, NOT propagated — one
        closed subscriber must never tear down the sender's serve loop or
        starve the remaining fan-out targets."""
        try:
            conn.send(obj)
            return True
        except OSError:
            self._forget(conn)
            return False

    def _handle(self, conn: _Conn, m: dict):
        op = m.get("op")
        if op == "subscribe":
            with self._lock:
                self._subs.setdefault(m["topic"], []).append(conn)
        elif op == "advertise":
            pass                          # publishers need no registration
        elif op == "publish":
            with self._lock:
                self.stats["published"] += 1
                targets = list(self._subs.get(m["topic"], []))
            out = {"op": "publish", "topic": m["topic"], "msg": m["msg"]}
            for c in targets:
                self._safe_send(c, out)
        elif op == "advertise_service":
            with self._lock:
                self._services[m["service"]] = conn
        elif op == "call_service":
            with self._lock:
                self.stats["service_calls"] += 1
                provider = self._services.get(m["service"])
                if provider is not None:
                    self._pending[(m["service"], m.get("id"))] = conn
            if provider is not None and self._safe_send(provider, m):
                return
            # no provider, or a provider whose socket is dead (stale
            # registration): answer the caller instead of wedging it
            with self._lock:
                self._pending.pop((m["service"], m.get("id")), None)
            self._safe_send(conn, {
                "op": "service_response", "service": m["service"],
                "id": m.get("id"), "result": False,
                "values": {"message": "service not advertised"}})
        elif op == "service_response":
            with self._lock:
                caller = self._pending.pop((m["service"], m.get("id")), None)
            if caller is not None:
                self._safe_send(caller, m)


# ---------------------------------------------------------------------------
# roslibpy-compatible client shim
# ---------------------------------------------------------------------------

class Message(dict):
    pass


class ServiceRequest(dict):
    pass


class Ros:
    """roslibpy.Ros subset: run/terminate + op routing on a reader thread."""

    def __init__(self, host: str = "localhost", port: int = 9090):
        self._addr = (host, port)
        self._topic_handlers: Dict[str, List] = {}
        self._service_handlers: Dict[str, object] = {}
        self._responses: Dict[object, Tuple[threading.Event, list]] = {}
        self._ids = itertools.count(1)
        self._conn: Optional[_Conn] = None
        self.is_connected = False

    def run(self, timeout: float = 10.0):
        self._conn = _Conn(socket.create_connection(self._addr,
                                                    timeout=timeout))
        self._conn.sock.settimeout(None)
        threading.Thread(target=self._read_loop, daemon=True).start()
        self.is_connected = True

    def terminate(self):
        self.is_connected = False
        if self._conn is not None:
            self._conn.close()

    def _send(self, obj: dict):
        if self._conn is None:
            raise RuntimeError("Ros client not connected (call run() first)")
        self._conn.send(obj)

    def _read_loop(self):
        for line in self._conn.rfile:
            if not line.strip():
                continue
            m = json.loads(line)
            op = m.get("op")
            if op == "publish":
                for cb in list(self._topic_handlers.get(m["topic"], [])):
                    cb(m["msg"])
            elif op == "call_service":
                handler = self._service_handlers.get(m["service"])
                response: dict = {}
                ok = bool(handler(m.get("args") or {}, response)) \
                    if handler else False
                self._send({"op": "service_response",
                            "service": m["service"], "id": m.get("id"),
                            "values": response, "result": ok})
            elif op == "service_response":
                holder = self._responses.pop(m.get("id"), None)
                if holder is not None:
                    holder[1].append(m)
                    holder[0].set()


class Topic:
    def __init__(self, ros: Ros, name: str, message_type: str):
        self.ros = ros
        self.name = name
        self.message_type = message_type
        self._advertised = False

    def subscribe(self, callback):
        self.ros._topic_handlers.setdefault(self.name, []).append(callback)
        self.ros._send({"op": "subscribe", "topic": self.name,
                        "type": self.message_type})

    def publish(self, message):
        if not self._advertised:       # roslibpy advertises on first publish
            self.ros._send({"op": "advertise", "topic": self.name,
                            "type": self.message_type})
            self._advertised = True
        self.ros._send({"op": "publish", "topic": self.name,
                        "msg": dict(message)})

    def unsubscribe(self):
        self.ros._topic_handlers.pop(self.name, None)


class Service:
    def __init__(self, ros: Ros, name: str, service_type: str):
        self.ros = ros
        self.name = name
        self.service_type = service_type

    def advertise(self, handler):
        self.ros._service_handlers[self.name] = handler
        self.ros._send({"op": "advertise_service", "service": self.name,
                        "type": self.service_type})

    def call(self, request, timeout: float = 10.0) -> dict:
        rid = next(self.ros._ids)
        ev = threading.Event()
        holder: list = []
        self.ros._responses[rid] = (ev, holder)
        self.ros._send({"op": "call_service", "service": self.name,
                        "id": rid, "args": dict(request)})
        if not ev.wait(timeout):
            self.ros._responses.pop(rid, None)
            raise TimeoutError(f"service {self.name} did not respond")
        return holder[0].get("values", {})


def client_module() -> types.ModuleType:
    """A module-like object exposing the roslibpy subset the runtime uses.

    Install with ``sys.modules["roslibpy"] = client_module()`` (tests use
    monkeypatch) to run RosBridgeSource / publish_to_rosbridge against a
    FakeRosBridgeServer without the real dependency.
    """
    mod = types.ModuleType("roslibpy")
    mod.Ros = Ros
    mod.Topic = Topic
    mod.Service = Service
    mod.Message = Message
    mod.ServiceRequest = ServiceRequest
    return mod
