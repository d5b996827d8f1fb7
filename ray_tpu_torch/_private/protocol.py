# The port's copy of ray_tpu/_private/protocol.py
"""Framed RPC over unix-domain or TCP sockets.

Counterpart of the reference's gRPC layer (``src/ray/rpc/``).
The control plane and node managers are in-cluster trusted peers on the
same host or VPC, so the wire format is length-prefixed pickle frames —
simple, fast, and sufficient for the control plane.  The *tensor* plane
never touches this layer: CUDA tensors stay on their cards and move
between ranks through ``torch.distributed`` (NCCL on the card, gloo on
the CPU; ``util/collective.py``), host objects go through the shm object
store.

Addresses are strings of two forms (reference: ``src/ray/rpc/grpc_server.cc``
binds TCP; plasma's UDS stays for the local fast path):

- a filesystem path → AF_UNIX (same-host fast path)
- ``tcp://host:port`` → AF_INET (cross-host; port 0 = ephemeral, the
  canonical bound address is ``RpcServer.address``)

Frame: [u64 little-endian length][pickle payload]

Server: thread per connection; handlers may block (long-poll waits).
Client: one persistent connection per thread (so a blocking call only
blocks its own thread), with automatic reconnect.
"""

from __future__ import annotations

import os
import pickle
import select
import socket
import socketserver
import struct
import threading
import traceback
from typing import Any, Callable, Optional, Tuple

_LEN = struct.Struct("<Q")


def is_tcp_address(addr: str) -> bool:
    return addr.startswith("tcp://")


def parse_tcp_address(addr: str) -> Tuple[str, int]:
    hostport = addr[len("tcp://"):]
    host, _, port = hostport.rpartition(":")
    return host or "127.0.0.1", int(port)


def _client_socket(addr: str, timeout: Optional[float]) -> socket.socket:
    if is_tcp_address(addr):
        host, port = parse_tcp_address(addr)
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(timeout)
        sock.connect((host, port))
    else:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect(addr)
    sock.settimeout(None)
    return sock


class ConnectionClosed(ConnectionError):
    pass


class MaybeDelivered(ConnectionError):
    """A request was sent whole, then its connection closed before the
    reply: the server read it and may have acted on it."""


class Fenced(ConnectionError):
    """A server refused a request it can no longer answer for (an actor
    worker whose node manager is gone): the request was not taken."""


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n > 0:
        chunk = sock.recv(min(n, 4 * 1024 * 1024))
        if not chunk:
            raise ConnectionClosed("peer closed connection")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> bytes:
    (length,) = _LEN.unpack(recv_exact(sock, _LEN.size))
    return recv_exact(sock, length)


def send_msg(sock: socket.socket, msg: Any) -> None:
    send_frame(sock, pickle.dumps(msg, protocol=5))


def recv_msg(sock: socket.socket) -> Any:
    return pickle.loads(recv_frame(sock))


class RpcServer:
    """Threaded unix-socket server dispatching to a handler object.

    Any public method of ``handler`` is callable remotely.  A request is
    ``("call", method, args, kwargs)``; the reply ``("ok", result)`` or
    ``("err", exc)``.  Connections may also be *hijacked*: if the handler
    method name starts with ``stream_`` it receives the raw socket and owns
    the connection from then on (used for worker task channels).

    ``gate`` (optional): an object whose ``admit()`` is asked once a
    request has arrived and before it is read, and whose ``done()`` is
    called once its reply is sent.  An ``admit()`` of False closes the
    connection with the request unread, so the client sees a reset and
    knows the request was not taken (``RpcClient.call_once``).
    """

    def __init__(self, sock_path: str, handler: Any, name: str = "rpc",
                 gate: Any = None):
        self.sock_path = sock_path
        self.handler = handler
        self.name = name
        self.gate = gate
        if is_tcp_address(sock_path):
            host, port = parse_tcp_address(sock_path)
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            # canonical address after an ephemeral (port 0) bind
            self.address = f"tcp://{host}:{self._sock.getsockname()[1]}"
        else:
            os.makedirs(os.path.dirname(sock_path), exist_ok=True)
            if os.path.exists(sock_path):
                os.unlink(sock_path)
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.bind(sock_path)
            self.address = sock_path
        self._sock.listen(512)
        self._stopped = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"{name}-accept", daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name=f"{self.name}-conn", daemon=True)
            t.start()

    def _admit(self, conn: socket.socket) -> bool:
        """Wait for the next request (or the peer's close) and ask the
        gate whether to read it."""
        poller = select.poll()
        poller.register(conn, select.POLLIN)
        poller.poll()
        return self.gate.admit()

    def _serve_conn(self, conn: socket.socket):
        gate = self.gate
        try:
            while True:
                if gate is not None and not self._admit(conn):
                    return
                held = gate is not None
                try:
                    try:
                        req = recv_msg(conn)
                    except (ConnectionClosed, ConnectionResetError, OSError,
                            EOFError):
                        return
                    kind = req[0]
                    if kind != "call":
                        send_msg(conn, ("err",
                                        ValueError(f"bad frame {kind}")))
                        continue
                    _, method, args, kwargs = req
                    if method.startswith("stream_"):
                        # Connection handoff: handler owns the socket now.
                        if held:
                            gate.done()
                            held = False
                        fn = getattr(self.handler, method)
                        fn(conn, *args, **kwargs)
                        return
                    try:
                        fn = getattr(self.handler, method)
                        if method.startswith("_"):
                            raise AttributeError(method)
                        result = fn(*args, **kwargs)
                        reply = ("ok", result)
                    except BaseException as e:  # noqa: BLE001 - to caller
                        e._remote_tb = traceback.format_exc()  # type: ignore
                        reply = ("err", e)
                    try:
                        send_msg(conn, reply)
                    except (BrokenPipeError, OSError):
                        return
                finally:
                    if held:
                        gate.done()
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def shutdown(self):
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if not is_tcp_address(self.sock_path) \
                and os.path.exists(self.sock_path):
            try:
                os.unlink(self.sock_path)
            except OSError:
                pass


class RpcClient:
    """Thread-local persistent connections to an RpcServer."""

    def __init__(self, sock_path: str, connect_timeout: float = 10.0):
        self.sock_path = sock_path
        self.connect_timeout = connect_timeout
        self._local = threading.local()

    def _connect(self) -> socket.socket:
        return _client_socket(self.sock_path, self.connect_timeout)

    def _conn(self) -> socket.socket:
        sock = getattr(self._local, "sock", None)
        if sock is None:
            sock = self._connect()
            self._local.sock = sock
        return sock

    def call(self, method: str, *args, **kwargs) -> Any:
        for attempt in (0, 1):
            sock = self._conn()
            try:
                send_msg(sock, ("call", method, args, kwargs))
                status, payload = recv_msg(sock)
                break
            except (ConnectionClosed, ConnectionResetError, BrokenPipeError,
                    OSError):
                self._local.sock = None
                if attempt == 1:
                    raise
        if status == "ok":
            return payload
        raise payload

    def call_once(self, method: str, *args, **kwargs) -> Any:
        """:meth:`call` for a request that must not run twice: a stale
        cached connection is replaced only while the server has not read
        the request (the send failed, or the connection was reset with
        it unread), and a connection that closes once the server read it
        raises :class:`MaybeDelivered` instead of sending it again."""
        for attempt in (0, 1):
            sock = self._conn()
            try:
                send_msg(sock, ("call", method, args, kwargs))
            except (ConnectionClosed, ConnectionResetError, BrokenPipeError,
                    OSError):
                self._local.sock = None
                if attempt == 1:
                    raise
                continue
            try:
                status, payload = recv_msg(sock)
            except ConnectionResetError:
                # the server closed with the request unread in its queue
                # (AF_UNIX sets ECONNRESET on the peer of a socket closed
                # with unread data; TCP answers such a close with a
                # reset): it never took the request, so it may go again
                self._local.sock = None
                if attempt == 1:
                    raise
                continue
            except (ConnectionClosed, BrokenPipeError, OSError) as e:
                self._local.sock = None
                raise MaybeDelivered(
                    f"{method}: connection to {self.sock_path} closed after "
                    "the request was sent") from e
            break
        if status == "ok":
            return payload
        raise payload

    def __getattr__(self, name: str) -> Callable:
        if name.startswith("_"):
            raise AttributeError(name)
        def _proxy(*args, **kwargs):
            return self.call(name, *args, **kwargs)
        _proxy.__name__ = name
        return _proxy

    def hijack(self, method: str, *args, **kwargs) -> socket.socket:
        """Open a fresh connection and hand it to a ``stream_`` handler."""
        sock = self._connect()
        send_msg(sock, ("call", method, args, kwargs))
        return sock

    def close(self):
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
            self._local.sock = None
