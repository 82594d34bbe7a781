"""Pluggable byte transports for the async runtime.

Counterpart of `repro/fed/runtime/transport.py`: it moves opaque frames
and knows nothing of either package's arrays, so a port master and
reference workers (or the reverse) share one TCP federation.

A transport moves opaque encoded frames (`messages.encode` bytes)
between one master endpoint and N worker endpoints; the master/worker
loops never see sockets or queues, only this interface:

  master endpoint:  recv(timeout) -> bytes | None,  send(j, bytes)
  worker endpoint:  recv(timeout) -> bytes | None,  send(bytes)

`InProcTransport` pairs the endpoints over `queue.Queue`s — fully
deterministic when the master replays a fixed arrival order, which is
what the conformance tests run on.  `TcpTransport` carries the same
frames over sockets with a 4-byte length prefix and a HELLO handshake
that maps connections to worker ids — the real multi-process path
(`repro_torch.launch.serve fed --transport tcp`).

Failure surface: a broken worker connection is never swallowed — the
master-side reader thread enqueues a synthetic `messages.disconnect(j)`
frame so the master loop can distinguish "slow" (heartbeats still
flowing) from "gone" (DISCONNECT / deadline exceeded).  After the
initial handshake the TCP master keeps accepting connections: a worker
that re-HELLOs (with a bumped resume epoch) replaces its old socket and
the HELLO frame is surfaced to the master loop, which replays the
worker's last consumed local point.
"""
from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from typing import Dict, List, Optional

from repro_torch.fed.runtime import messages as msg_lib


class MasterEndpoint:
    """Master side of any transport: one inbound frame queue (workers
    are multiplexed) + per-worker outbound sends."""

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        raise NotImplementedError

    def send(self, worker: int, frame: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class WorkerEndpoint:
    """Worker side: recv from the master (None on timeout) + send."""

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        raise NotImplementedError

    def send(self, frame: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# in-process transport (threads + queues)
# ---------------------------------------------------------------------------

class _InProcMaster(MasterEndpoint):
    def __init__(self, hub: "InProcTransport"):
        self._hub = hub

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        try:
            return self._hub.to_master.get(timeout=timeout) \
                if timeout is not None else self._hub.to_master.get()
        except queue.Empty:
            return None

    def send(self, worker: int, frame: bytes) -> None:
        self._hub._ensure_queue(int(worker))
        self._hub.to_worker[worker].put(frame)


class _InProcWorker(WorkerEndpoint):
    def __init__(self, hub: "InProcTransport", worker: int):
        self._hub, self._worker = hub, worker

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        try:
            return self._hub.to_worker[self._worker].get(timeout=timeout) \
                if timeout is not None \
                else self._hub.to_worker[self._worker].get()
        except queue.Empty:
            return None

    def send(self, frame: bytes) -> None:
        self._hub.to_master.put(frame)

    def close(self) -> None:
        # mirror the TCP reader's hangup surfacing: a closing worker
        # session enqueues its own DISCONNECT so the master's shutdown
        # drain (and death detection) sees in-proc departures too
        self._hub.to_master.put(msg_lib.encode(
            msg_lib.disconnect(self._worker)))


class InProcTransport:
    """Queue-pair transport for same-process (threaded) runs.

    Frames still round-trip through `messages.encode`/`decode`, so every
    test on this transport exercises the real wire format.  A rejoining
    worker simply requests `worker_endpoint(j)` again — the queues
    persist across worker sessions, like a master-side mailbox.  The
    mailbox list grows on demand: an elastic late-joiner with an id
    beyond the launch population registers its queue by asking for its
    endpoint (and the master's reply send registers it too, whichever
    side arrives first)."""

    def __init__(self, n_workers: int):
        self.n_workers = int(n_workers)
        self.to_master: "queue.Queue[bytes]" = queue.Queue()
        self.to_worker: List["queue.Queue[bytes]"] = [
            queue.Queue() for _ in range(self.n_workers)]
        self._grow_lock = threading.Lock()

    def _ensure_queue(self, worker: int) -> None:
        if worker < len(self.to_worker):
            return
        with self._grow_lock:
            while len(self.to_worker) <= worker:
                self.to_worker.append(queue.Queue())

    def master_endpoint(self) -> MasterEndpoint:
        return _InProcMaster(self)

    def worker_endpoint(self, worker: int) -> WorkerEndpoint:
        self._ensure_queue(int(worker))
        return _InProcWorker(self, int(worker))


# ---------------------------------------------------------------------------
# TCP transport (length-prefixed frames)
# ---------------------------------------------------------------------------

def _send_frame(sock: socket.socket, frame: bytes) -> None:
    sock.sendall(struct.pack(">I", len(frame)) + frame)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    return _recv_exact(sock, n)


class _TcpMaster(MasterEndpoint):
    """Accepts `n_workers` connections, resolves each to a worker id via
    its HELLO frame, then multiplexes per-connection reader threads into
    one inbound queue.  After the initial handshake an accept thread
    keeps running so crashed workers can reconnect: a re-HELLO replaces
    the worker's socket and the HELLO frame is surfaced to the master
    loop (which owns the resume protocol)."""

    def __init__(self, host: str, port: int, n_workers: int,
                 max_workers: Optional[int] = None):
        self.n_workers = n_workers
        self.max_workers = (n_workers if max_workers is None
                            else max(int(max_workers), n_workers))
        self._server = socket.create_server((host, port))
        self.port = self._server.getsockname()[1]
        self._socks: Dict[int, socket.socket] = {}
        self._lock = threading.Lock()
        self._inbound: "queue.Queue[bytes]" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._closed = False

    def _handshake(self, conn: socket.socket):
        """Read + validate one opening frame; returns (worker id, raw
        frame).  HELLO ids must be inside the launch population; ADMIT
        ids (elastic late-joiners) must be inside [n_workers,
        max_workers).  The frame is NOT enqueued — callers decide.
        Every malformed-opening failure surfaces as `ConnectionError`
        so callers can close the probe socket and keep accepting."""
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        raw = _recv_frame(conn)
        try:
            m = msg_lib.decode(raw)
        except Exception as e:
            raise ConnectionError(
                f"undecodable handshake frame: {e}") from e
        if m.kind not in (msg_lib.HELLO, msg_lib.ADMIT):
            raise ConnectionError(
                f"expected hello/admit handshake, got {m.kind!r}")
        j = int(m.meta["worker"])
        if m.kind == msg_lib.HELLO and not 0 <= j < self.n_workers:
            raise ConnectionError(
                f"hello from out-of-range worker id {j} "
                f"(expected 0..{self.n_workers - 1})")
        if m.kind == msg_lib.ADMIT and \
                not self.n_workers <= j < self.max_workers:
            raise ConnectionError(
                f"admit from out-of-range worker id {j} "
                f"(expected {self.n_workers}..{self.max_workers - 1})")
        return j, raw

    def wait_for_workers(self, timeout: Optional[float] = None) -> None:
        """Block until every worker has completed the HELLO handshake.

        Rejects duplicate worker ids loudly (a duplicate id would
        silently adopt another worker's row assignment), and fails the
        launch with `TimeoutError` if the full population hasn't
        arrived within `timeout` seconds.  A MALFORMED opening (garbled
        frame, non-HELLO bytes, out-of-range id — e.g. a port-scanner
        probe) closes that socket and keeps accepting: a stray packet
        must not kill a healthy launch, and must not leak the accepted
        connection.  An eager ADMIT arriving during launch is installed
        and queued for the master's admission barrier; only ids inside
        the launch population count toward the handshake quorum.  On
        success, starts the reconnect accept loop."""
        deadline = None if timeout is None else time.monotonic() + timeout

        def _population():
            return {k for k in self._socks if k < self.n_workers}

        while len(_population()) < self.n_workers:
            if deadline is not None:
                self._server.settimeout(max(0.0,
                                            deadline - time.monotonic()))
            try:
                conn, _ = self._server.accept()
            except (socket.timeout, TimeoutError):
                raise TimeoutError(
                    f"timed out waiting for workers: "
                    f"{len(_population())}/{self.n_workers} connected "
                    f"(missing {sorted(set(range(self.n_workers)) - _population())})")
            try:
                conn.settimeout(10.0)
                j, raw = self._handshake(conn)
                conn.settimeout(None)
            except (ConnectionError, OSError, TimeoutError):
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            if j in self._socks:
                conn.close()
                raise ConnectionError(
                    f"duplicate hello for worker id {j}; its socket is "
                    f"already registered")
            self._install(j, conn)
            if j >= self.n_workers:
                # an elastic late-joiner beat the launch: surface its
                # ADMIT so the running master can process the admission
                self._inbound.put(raw)
        self._server.settimeout(None)
        self._start_accept_loop()

    def _install(self, j: int, conn: socket.socket) -> None:
        with self._lock:
            old = self._socks.get(j)
            self._socks[j] = conn
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        t = threading.Thread(target=self._reader, args=(conn, j),
                             daemon=True)
        t.start()
        # prune finished reader threads (replaced sessions) so a
        # long-lived elastic serve process doesn't retain one dead
        # Thread object per rejoin forever
        self._threads = [th for th in self._threads if th.is_alive()]
        self._threads.append(t)

    def _start_accept_loop(self) -> None:
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self) -> None:
        """Post-launch accepts: reconnecting workers re-HELLO (with a
        resume epoch); the replacement socket is installed and the HELLO
        surfaced to the master loop for the row-replay protocol."""
        while not self._closed:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return          # server socket closed
            if self._closed:
                conn.close()
                return
            try:
                conn.settimeout(10.0)
                j, raw_hello = self._handshake(conn)
                conn.settimeout(None)
            except (ConnectionError, OSError, TimeoutError):
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            self._install(j, conn)
            # surface the original HELLO (it carries the resume epoch)
            # so the master loop can run the rejoin/row-replay protocol
            self._inbound.put(raw_hello)

    def _reader(self, conn: socket.socket, worker: int) -> None:
        try:
            while True:
                self._inbound.put(_recv_frame(conn))
        except (ConnectionError, OSError):
            # surface the hangup instead of swallowing it — but only if
            # this connection is still the worker's registered socket
            # (a replaced socket dying must not kill the fresh session)
            with self._lock:
                current = self._socks.get(worker) is conn
            if current and not self._closed:
                self._inbound.put(msg_lib.encode(
                    msg_lib.disconnect(worker)))

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        try:
            return self._inbound.get(timeout=timeout) \
                if timeout is not None else self._inbound.get()
        except queue.Empty:
            return None

    def send(self, worker: int, frame: bytes) -> None:
        with self._lock:
            sock = self._socks.get(worker)
        if sock is None:
            raise ConnectionError(f"no connection for worker {worker}")
        try:
            _send_frame(sock, frame)
        except (OSError, ValueError) as e:
            raise ConnectionError(
                f"send to worker {worker} failed: {e}") from e

    def close(self) -> None:
        self._closed = True
        with self._lock:
            socks = list(self._socks.values())
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        # close() alone leaves a thread blocked in accept() listening:
        # a worker connecting after the run would be accepted and never
        # dismissed.  shutdown() wakes the accept loop first.
        try:
            self._server.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._server.close()


class _TcpWorker(WorkerEndpoint):
    def __init__(self, host: str, port: int, worker: int, epoch: int = 0,
                 admit: bool = False):
        self._sock = socket.create_connection((host, port))
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        opening = (msg_lib.admit(worker, epoch) if admit
                   else msg_lib.hello(worker, epoch))
        _send_frame(self._sock, msg_lib.encode(opening))

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        if timeout is None:
            self._sock.settimeout(None)
            return _recv_frame(self._sock)
        # Poll a single byte under the timeout, then block for the rest
        # of the frame: an idle timeout never desyncs the byte stream
        # (frames are small and sent whole, so the tail follows at once).
        self._sock.settimeout(timeout)
        try:
            first = self._sock.recv(1)
        except (socket.timeout, TimeoutError):
            return None
        if not first:
            raise ConnectionError("master closed the connection")
        self._sock.settimeout(None)
        (n,) = struct.unpack(">I", first + _recv_exact(self._sock, 3))
        return _recv_exact(self._sock, n)

    def send(self, frame: bytes) -> None:
        try:
            _send_frame(self._sock, frame)
        except (OSError, ValueError) as e:
            raise ConnectionError(f"send to master failed: {e}") from e

    def close(self) -> None:
        self._sock.close()


class TcpTransport:
    """Socket transport for real multi-process runs.

    Master side: ``TcpTransport(n_workers).master_endpoint()`` binds an
    ephemeral port (read it back from ``.port``) and blocks in
    `wait_for_workers` until all workers have completed the HELLO
    handshake (pass `timeout=` to fail a missing worker loudly).
    Worker side (separate process):
    ``TcpTransport.connect(host, port, worker, epoch)`` — reconnecting
    workers bump `epoch` so the master can replay their last consumed
    local point.
    """

    def __init__(self, n_workers: int, host: str = "127.0.0.1",
                 port: int = 0, max_workers: Optional[int] = None):
        self.n_workers = int(n_workers)
        self.max_workers = max_workers
        self.host, self.port = host, port
        self._master: Optional[_TcpMaster] = None

    def master_endpoint(self) -> _TcpMaster:
        if self._master is None:
            self._master = _TcpMaster(self.host, self.port,
                                      self.n_workers,
                                      max_workers=self.max_workers)
            self.port = self._master.port
        return self._master

    @staticmethod
    def connect(host: str, port: int, worker: int, epoch: int = 0,
                admit: bool = False) -> WorkerEndpoint:
        return _TcpWorker(host, port, worker, epoch, admit=admit)
