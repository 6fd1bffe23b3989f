"""Length-prefixed socket transport for the PCM mailbox vocabulary.

The actor runtime's unit of communication is a mailbox message; this
module gives those messages a byte representation and a pair of dedicated
IO threads per connection, so a multi-GB context transfer never blocks a
compute mailbox and a slow receiver never blocks a donor's serving loop.

Frame layout (little-endian)::

    u32 header_len | u64 payload_len | JSON header | payload bytes

The JSON header always carries ``kind`` (the frame vocabulary — TASK,
FETCH, INSTALL, DONATE_CHUNKS, STRIPE_CHUNK, HEARTBEAT, ...) plus
kind-specific metadata (tokens, stripe ids, chunk refs, dtypes/shapes).
The payload is opaque bytes: a pickle, a ``repro_torch.core.wire`` blob, or
one raw chunk of a striped transfer.

Each :class:`Connection` owns

* a **writer thread** draining an outbound queue. Queue items may be
  ready frames or *thunks* — callables evaluated on the writer thread —
  so expensive serialization (wire-encoding a snapshot, the host copy of
  a template) runs on the IO thread, never on the manager lock or a
  donor's serving thread. Idle writers emit HEARTBEAT frames.
* a **reader thread** decoding frames into an ``on_frame`` callback and
  time-stamping ``last_seen`` (heartbeats included).

Liveness: EOF or a socket error fires ``on_lost`` exactly once; the
:class:`Router`'s monitor thread additionally declares a peer lost when
nothing (not even a heartbeat) arrived for ``lost_after`` seconds. Both
paths funnel into the same callback — the manager wires it to the
existing preemption path, so a ``kill -9``'d node is handled exactly
like a reclaimed opportunistic GPU.

Port of ``repro.core.transport``: framework-free, a copy of its own (the
port imports nothing of the JAX package) that writes the same bytes for
the same ``(kind, meta, payload)``, so one frame vocabulary serves both
packages.
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Connection", "Listener", "Router", "TransportError",
           "read_frame", "write_frame"]

_HEADER = struct.Struct("<IQ")
# fail fast on garbage length prefixes instead of attempting a huge recv
_MAX_HEADER = 64 << 20
_MAX_PAYLOAD = 64 << 30

HEARTBEAT = "hb"


class TransportError(RuntimeError):
    """Connection-fatal framing or socket failure."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise TransportError("connection closed mid-frame")
        got += r
    return bytes(buf)


def read_frame(sock: socket.socket) -> Tuple[str, Dict, bytes]:
    """Blocking read of one frame -> (kind, meta, payload)."""
    hdr_len, pay_len = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if hdr_len > _MAX_HEADER or pay_len > _MAX_PAYLOAD:
        raise TransportError(
            f"frame too large (header {hdr_len}, payload {pay_len})")
    meta = json.loads(_recv_exact(sock, hdr_len).decode())
    payload = _recv_exact(sock, pay_len) if pay_len else b""
    kind = meta.pop("kind", "")
    return kind, meta, payload


def write_frame(sock: socket.socket, kind: str, meta: Dict,
                payload: bytes = b""):
    header = dict(meta or {})
    header["kind"] = kind
    hdr = json.dumps(header).encode()
    sock.sendall(_HEADER.pack(len(hdr), len(payload)))
    sock.sendall(hdr)
    if payload:
        sock.sendall(payload)


class Connection:
    """One bidirectional framed link with dedicated reader/writer threads.

    ``on_frame(conn, kind, meta, payload)`` runs on the reader thread for
    every non-heartbeat frame, in arrival order. ``on_lost(conn, reason)``
    fires at most once, from whichever thread detected the failure; a
    deliberate :meth:`close` never fires it.
    """

    def __init__(self, sock: socket.socket, name: str,
                 on_frame: Callable, on_lost: Optional[Callable] = None,
                 heartbeat: float = 1.0):
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass          # non-TCP socket (unix socketpair) — best effort
        self.sock = sock
        self.name = name
        self.heartbeat = float(heartbeat)
        self.last_seen = time.monotonic()
        self._on_frame = on_frame
        self._on_lost = on_lost
        self._out: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lost_fired = False
        self._closed = False
        self._lock = threading.Lock()
        self._writer = threading.Thread(
            target=self._write_loop, name=f"pcm-tx-{name}", daemon=True)
        self._reader = threading.Thread(
            target=self._read_loop, name=f"pcm-rx-{name}", daemon=True)

    def start(self):
        self._writer.start()
        self._reader.start()

    # ---------------------------------------------------------- sending ----
    def send(self, kind: str, meta: Dict, payload: bytes = b""):
        """Queue one ready frame (returns immediately)."""
        self._out.put((kind, meta, payload))

    def send_lazy(self, thunk: Callable[[], Optional[tuple]]):
        """Queue a frame-producing thunk. It runs on the WRITER thread —
        the seam that keeps wire-encoding (pickles, host copies,
        pack_tree sha256 work) off compute threads and off the manager
        lock. Returning None sends nothing; an exception drops the frame
        (logged) but keeps the connection up."""
        self._out.put(thunk)

    def _write_loop(self):
        while not self._closed:
            try:
                item = self._out.get(timeout=self.heartbeat)
            except queue.Empty:
                item = (HEARTBEAT, {}, b"")
            if item is None:          # close() sentinel
                return
            if callable(item):
                try:
                    item = item()
                except BaseException:
                    traceback.print_exc(file=sys.stderr)
                    continue
                if item is None:
                    continue
            try:
                write_frame(self.sock, item[0], item[1], item[2])
            except BaseException as exc:
                self._lost(f"send failed: {exc}")
                return

    # -------------------------------------------------------- receiving ----
    def _read_loop(self):
        while not self._closed:
            try:
                kind, meta, payload = read_frame(self.sock)
            except BaseException as exc:
                self._lost(f"recv failed: {exc}")
                return
            self.last_seen = time.monotonic()
            if kind == HEARTBEAT:
                continue
            try:
                self._on_frame(self, kind, meta, payload)
            except BaseException:
                # a handler bug must not take the link down with it
                traceback.print_exc(file=sys.stderr)

    # --------------------------------------------------------- lifecycle ---
    def _lost(self, reason: str):
        with self._lock:
            if self._lost_fired or self._closed:
                return
            self._lost_fired = True
        cb = self._on_lost
        if cb is not None:
            try:
                cb(self, reason)
            except BaseException:
                traceback.print_exc(file=sys.stderr)

    def declare_lost(self, reason: str):
        """Externally declare the peer dead (heartbeat timeout) — fires
        ``on_lost`` through the same once-only gate as an IO failure."""
        self._lost(reason)
        self.close()

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._out.put(None)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    @property
    def closed(self) -> bool:
        return self._closed

    def idle_for(self, now: Optional[float] = None) -> float:
        return (now if now is not None else time.monotonic()) \
            - self.last_seen


class Listener:
    """TCP accept loop. ``on_connect(sock, addr)`` runs on the accept
    thread for every inbound connection (the callee wraps it in a
    Connection once the HELLO arrives)."""

    def __init__(self, host: str, port: int, on_connect: Callable):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.address: Tuple[str, int] = self._sock.getsockname()[:2]
        self._on_connect = on_connect
        self._closed = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="pcm-listener", daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._closed:
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return                      # closed
            try:
                self._on_connect(sock, addr)
            except BaseException:
                traceback.print_exc(file=sys.stderr)
                try:
                    sock.close()
                except OSError:
                    pass

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class Router:
    """Worker address book: worker_id -> Connection, plus the liveness
    monitor that declares silent peers lost after ``lost_after`` seconds
    without any inbound frame (heartbeats count). Loss detection is thus
    two-layered: socket EOF fires instantly (a killed process), the
    monitor catches wedged-but-open links (network partition)."""

    def __init__(self, lost_after: float = 10.0):
        self.lost_after = float(lost_after)
        self._conns: Dict[str, Connection] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._monitor: Optional[threading.Thread] = None

    def register(self, worker_id: str, conn: Connection):
        with self._lock:
            self._conns[worker_id] = conn
            if self._monitor is None:
                self._monitor = threading.Thread(
                    target=self._monitor_loop, name="pcm-hb-monitor",
                    daemon=True)
                self._monitor.start()

    def unregister(self, worker_id: str) -> Optional[Connection]:
        with self._lock:
            return self._conns.pop(worker_id, None)

    def get(self, worker_id: str) -> Optional[Connection]:
        with self._lock:
            return self._conns.get(worker_id)

    def connections(self) -> List[Tuple[str, Connection]]:
        with self._lock:
            return list(self._conns.items())

    def _monitor_loop(self):
        # poll at a fraction of the deadline so detection latency stays a
        # small multiple of the configured timeout, not of the poll rate
        interval = max(0.05, self.lost_after / 4.0)
        while not self._closed:
            time.sleep(interval)
            now = time.monotonic()
            for wid, conn in self.connections():
                if not conn.closed and conn.idle_for(now) > self.lost_after:
                    conn.declare_lost(
                        f"no frames from {wid} for "
                        f"{conn.idle_for(now):.1f}s (declared lost)")

    def close(self):
        self._closed = True
        for _, conn in self.connections():
            conn.close()
        with self._lock:
            self._conns.clear()
