"""The parameter server: the ps-lite equivalent.

Counterpart of ``mxnet_tpu/kvstore_server.py`` (reference src/kvstore/
kvstore_dist_server.h, python/mxnet/kvstore_server.py). Weights live on
the servers, on the host; workers push gradients and pull weights over
sockets (:class:`PSClient`, used by ``kvstore.PSKVStore``).

- **Wire.** ``multiprocessing.connection`` under the port's own auth key.
  A message is a pickled control header, tensors replaced by
  ``(marker, dtype, shape)``, then one raw frame a tensor
  (:func:`send_msg` / :func:`recv_msg`): tensor bytes never pass through
  pickle and land straight in a fresh numpy buffer.
- **One dispatch thread.** A reader thread a connection queues requests;
  one thread handles them all, so the store needs no lock (the
  reference's single-thread executor loop).
- **Sync mode.** Pushes of a key merge one contribution a rank (latest
  wins: a recovering worker replaces its stale part); when every worker
  has contributed the updater runs once and every waiter gets its reply.
  **Async mode** applies each push at once.
- **Liveness.** ``hello`` registers a rank on its control connection;
  heartbeats keep it live; ``dead_nodes`` lists ranks whose control
  connection dropped or whose heartbeat is stale. A hello is answered
  "recovery" only for a rank whose earlier connection dropped; a worker
  that ends says ``goodbye`` (``PSKVStore.stop_server`` / ``close``), so a
  new store of a live job is "welcome", its mode and optimizer applied.
- **Sharding.** A key with more than :func:`bigarray_bound` elements is
  split into near-equal contiguous ranges, one a server.
- :class:`_NumpyUpdater` runs the port's optimizer on CPU tensors over
  the server's numpy weights (the update ops' plain versions).

A server bound to port 0 takes a free port and reports it:
``KVStoreServer.address`` once bound, and :func:`run` prints
``kvstore_server listening on host:port`` (and writes ``host:port`` to
``MXNET_TPU_PS_PORT_FILE`` when set), so a launcher never races for a
port. Connecting retries until ``MXNET_TPU_PS_CONNECT_TIMEOUT`` seconds
(60) pass: launchers start servers and workers together. The JAX
package's fault-injection hooks (``resilience``) are not ported.
"""
from __future__ import annotations

import os
import pickle
import queue
import socket
import sys
import threading
import time
import zlib
from multiprocessing.connection import Client, Listener
from typing import Any, Dict, Optional

import numpy as np

from . import telemetry
from .base import MXNetError
from .telemetry import context as _trace_context

_AUTH = b"mxnet_tpu_torch_ps"
_ND = "__ndarray_frame__"


def _trace_header() -> Optional[str]:
    """The caller's W3C traceparent, or None without a trace context."""
    ctx = _trace_context.current_context()
    return None if ctx is None else _trace_context.to_traceparent(ctx)


def _traced(req: tuple) -> tuple:
    """``("__traced__", traceparent, *req)`` under a trace context."""
    tp = _trace_header()
    return req if tp is None else ("__traced__", tp) + tuple(req)


def _no_delay(conn):
    """Turn Nagle's algorithm off on ``conn``'s socket: a message is
    several small writes (a header, then frames), which Nagle would hold
    back for the peer's delayed acknowledgement (tens of ms an RPC)."""
    try:
        s = socket.fromfd(conn.fileno(), socket.AF_INET, socket.SOCK_STREAM)
    except OSError:
        return conn
    try:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass  # not a TCP socket (a pipe in a test)
    finally:
        s.close()
    return conn


def send_msg(conn, *parts):
    """A pickled control header (arrays replaced by descriptors), then one
    raw frame an array."""
    head, tensors = [], []
    for p in parts:
        if isinstance(p, np.ndarray):
            t = np.ascontiguousarray(p).reshape(p.shape)  # 0-d stays 0-d
            head.append((_ND, str(t.dtype), t.shape))
            tensors.append(t)
        else:
            head.append(p)
    conn.send_bytes(pickle.dumps(tuple(head)))
    for t in tensors:
        # an empty array cannot be cast to bytes; recv_msg matches it
        conn.send_bytes(memoryview(t).cast("B") if t.size else b"")


def recv_msg(conn):
    """The inverse of :func:`send_msg`: array frames land in fresh numpy
    buffers."""
    head = pickle.loads(conn.recv_bytes())
    out = []
    for p in head:
        if isinstance(p, tuple) and len(p) == 3 and p[0] == _ND:
            buf = np.empty(p[2], dtype=np.dtype(p[1]))
            if buf.size:
                conn.recv_bytes_into(memoryview(buf).cast("B"))
            else:
                conn.recv_bytes()
            out.append(buf)
        else:
            out.append(p)
    return tuple(out)


def _uris():
    """The servers' addresses: ``MXNET_TPU_PS_URI`` is a comma-separated
    host:port list, one a server (or ``DMLC_PS_ROOT_URI`` with
    ``DMLC_PS_ROOT_PORT``)."""
    uri = os.environ.get("MXNET_TPU_PS_URI") or os.environ.get(
        "DMLC_PS_ROOT_URI")
    if uri is None:
        return None
    out = []
    for part in uri.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            host, port = part.rsplit(":", 1)
        else:
            host, port = part, os.environ.get("DMLC_PS_ROOT_PORT", "9091")
        out.append((host, int(port)))
    return out or None


def _uri():
    uris = _uris()
    return uris[server_id() % len(uris)] if uris else None


def server_id() -> int:
    """This server's index in the URI list."""
    return int(os.environ.get("MXNET_TPU_SERVER_ID",
                              os.environ.get("DMLC_SERVER_ID", "0")))


def bigarray_bound() -> int:
    """Keys with more elements are split across all servers (reference
    MXNET_KVSTORE_BIGARRAY_BOUND, kvstore_dist.h:276-314)."""
    return int(os.environ.get("MXNET_KVSTORE_BIGARRAY_BOUND", "1000000"))


def role() -> str:
    return os.environ.get("MXNET_TPU_ROLE",
                          os.environ.get("DMLC_ROLE", "worker"))


def num_workers() -> int:
    return int(os.environ.get("MXNET_TPU_NUM_WORKERS",
                              os.environ.get("DMLC_NUM_WORKER", "1")))


class KVStoreServer:
    """One server's state and run loop."""

    def __init__(self, address=None, n_workers: Optional[int] = None,
                 sync_mode: bool = True):
        self.address = tuple(address or _uri() or ("127.0.0.1", 9091))
        self.n_workers = n_workers or num_workers()
        self.sync_mode = sync_mode
        self.store: Dict[Any, np.ndarray] = {}
        self.updater = None
        # sync merges: rank-tagged parts (latest wins a rank) and untagged
        # ones counted by arrival
        self._merge_parts: Dict[Any, Dict[Any, np.ndarray]] = {}
        self._merge_anon: Dict[Any, np.ndarray] = {}
        self._merge_anon_count: Dict[Any, int] = {}
        self._waiting: Dict[Any, list] = {}  # key -> [(rank or None, conn)]
        self._barrier_conns: list = []
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._ready = threading.Event()
        # rank -> {conn, last_seen, dead_since}
        self._workers: Dict[int, Dict[str, Any]] = {}

    # --- requests (the one dispatch thread) -------------------------------
    def _apply(self, key, merged):
        if self.updater is not None:
            if key not in self.store:
                self.store[key] = np.zeros_like(merged)
            self.updater(key, merged, self.store[key])
        else:
            self.store[key] = np.array(merged, copy=True)

    @staticmethod
    def _reply_all(conns):
        # one dead worker's connection must not stop the live ones' replies
        for c in conns:
            try:
                send_msg(c, "ok")
            except (OSError, EOFError):
                pass

    def _push(self, conn, key, val, rank):
        if not self.sync_mode:
            self._apply(key, val)
            send_msg(conn, "ok")
            return
        waiting = self._waiting.setdefault(key, [])
        if rank is None:
            if key in self._merge_anon:
                self._merge_anon[key] += val
            else:
                self._merge_anon[key] = np.array(val, copy=True)
            self._merge_anon_count[key] = \
                self._merge_anon_count.get(key, 0) + 1
        else:
            parts = self._merge_parts.setdefault(key, {})
            if rank in parts:
                # the same rank again (a recovered worker re-pushing the
                # round it died in): replace, and drop the dead attempt's
                # reply slot
                waiting[:] = [(r, c) for r, c in waiting if r != rank]
            parts[rank] = np.array(val, copy=True)
        waiting.append((rank, conn))
        n_got = (len(self._merge_parts.get(key, {}))
                 + self._merge_anon_count.get(key, 0))
        if n_got == self.n_workers:
            merged = self._merge_anon.pop(key, None)
            for part in self._merge_parts.pop(key, {}).values():
                merged = part if merged is None else merged + part
            self._merge_anon_count[key] = 0
            self._apply(key, merged)
            self._reply_all(c for _, c in self._waiting.pop(key))

    def _handle(self, conn, req):
        op = req[0]
        if op == "__traced__":
            # ("__traced__", traceparent, *inner): the server's span is a
            # child of the worker's calling span
            tp, inner = req[1], req[2:]
            if telemetry.enabled("kvstore"):
                ctx = _trace_context.parse_traceparent(tp)
                if ctx is not None:
                    with telemetry.span("kvstore.%s" % (inner[0],),
                                        domain="kvstore", **ctx.stamps()):
                        return self._handle(conn, inner)
            return self._handle(conn, inner)
        if op == "init":
            key, val = req[1], req[2]
            if key not in self.store:  # the first init wins
                self.store[key] = np.array(val, copy=True)
            send_msg(conn, "ok")
        elif op == "push":
            self._push(conn, req[1], req[2], req[3] if len(req) > 3 else None)
        elif op == "pull":
            key = req[1]
            if key not in self.store:
                send_msg(conn, "err", "pull of uninitialized key %r" % (key,))
            else:
                send_msg(conn, "ok", self.store[key])
        elif op == "set_optimizer":
            self.updater = _NumpyUpdater(pickle.loads(req[1]))
            send_msg(conn, "ok")
        elif op == "set_sync":
            self.sync_mode = bool(req[1])
            send_msg(conn, "ok")
        elif op == "barrier":
            self._barrier_conns.append(conn)
            if len(self._barrier_conns) == self.n_workers:
                conns, self._barrier_conns = self._barrier_conns, []
                self._reply_all(conns)
        elif op == "hello":
            # "recovery" only for a rank whose earlier control connection
            # dropped; a rank that said goodbye, or is new, is "welcome"
            rank = int(req[1])
            w = self._workers.get(rank)
            is_recovery = w is not None and w["dead_since"] is not None
            self._workers[rank] = {"conn": conn, "last_seen": time.time(),
                                   "dead_since": None}
            send_msg(conn, "ok", "recovery" if is_recovery else "welcome")
        elif op == "goodbye":
            rank = int(req[1])
            w = self._workers.get(rank)
            if w is not None and w["conn"] is conn:
                del self._workers[rank]
            send_msg(conn, "ok")
        elif op == "heartbeat":
            w = self._workers.get(int(req[1]))
            if w is not None and w["conn"] is conn:
                w["last_seen"] = time.time()
                w["dead_since"] = None
            send_msg(conn, "ok")
        elif op == "dead_nodes":
            timeout = float(req[1])
            now = time.time()
            dead = sorted(r for r, w in self._workers.items()
                          if w["dead_since"] is not None
                          or now - w["last_seen"] > timeout)
            send_msg(conn, "ok", dead)
        elif op == "__disconnect__":
            # a reader saw EOF: a registered rank's control connection
            # means that rank died
            for w in self._workers.values():
                if w["conn"] is conn and w["dead_since"] is None:
                    w["dead_since"] = time.time()
        elif op == "stop":
            send_msg(conn, "ok")
            self._stop.set()
        else:
            send_msg(conn, "err", "unknown op %r" % (op,))

    # --- threads ----------------------------------------------------------
    def _reader(self, conn):
        try:
            while not self._stop.is_set():
                self._q.put((conn, recv_msg(conn)))
        except (EOFError, OSError):
            self._q.put((conn, ("__disconnect__",)))

    def _accept_loop(self, listener):
        while not self._stop.is_set():
            try:
                conn = listener.accept()
            except Exception:
                # a failed handshake (a port probe, a wrong key) must not
                # end the server
                if self._stop.is_set():
                    break
                time.sleep(0.05)
                continue
            _no_delay(conn)
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def run(self):
        """Serve until a worker sends stop (reference
        KVStoreDistServer::Run). ``address`` holds the bound port."""
        listener = Listener(self.address, authkey=_AUTH)
        self.address = listener.address
        self._ready.set()
        threading.Thread(target=self._accept_loop, args=(listener,),
                         daemon=True).start()
        while not self._stop.is_set():
            try:
                conn, req = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._handle(conn, req)
            except (EOFError, OSError):
                pass
        listener.close()
        telemetry.dump_ring()

    def start_background(self):
        """Serve from a daemon thread (tests, notebooks); returns once
        bound."""
        t = threading.Thread(target=self.run, daemon=True)
        t.start()
        if not self._ready.wait(timeout=10):
            raise MXNetError("kvstore server did not bind %s"
                             % (self.address,))
        return t


class _NumpyUpdater:
    """The port's optimizer over the server's numpy weights: each update
    runs on CPU tensors sharing the arrays' memory (the update ops' plain
    versions), in place."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def __call__(self, key, grad, weight):
        import torch

        from .ndarray import NDArray

        ikey = key if isinstance(key, int) else \
            zlib.crc32(str(key).encode())
        w = NDArray(torch.from_numpy(weight))
        g = NDArray(torch.from_numpy(np.ascontiguousarray(grad)))
        if key not in self.states:
            self.states[key] = self.optimizer.create_state(ikey, w)
        self.optimizer.update(ikey, w, g, self.states[key])


def _connect(address, what):
    """A client connection to ``address``, retried until it binds or
    ``MXNET_TPU_PS_CONNECT_TIMEOUT`` seconds pass."""
    deadline = time.time() + float(
        os.environ.get("MXNET_TPU_PS_CONNECT_TIMEOUT", "60"))
    delay = 0.05
    while True:
        try:
            return _no_delay(Client(tuple(address), authkey=_AUTH))
        except OSError as e:
            if time.time() >= deadline:
                raise MXNetError("%s %s: %s" % (what, address, e)) from e
            time.sleep(delay)
            delay = min(delay * 2, 1.0)


class PSClient:
    """A worker's connections to the server group (reference ps::KVWorker
    ZPush / ZPull and EncodeKey): a small key goes whole to one server
    (crc32 of its name, stable across processes), a key of more than
    :func:`bigarray_bound` elements in one range a server. A separate
    control connection to server 0 carries hello / heartbeat /
    dead_nodes / goodbye, so liveness answers while a sync push waits."""

    def __init__(self, addresses=None, rank=None):
        if (isinstance(addresses, tuple) and len(addresses) == 2
                and isinstance(addresses[0], str)):
            addresses = [addresses]
        self.rank = rank
        self.addresses = addresses or _uris()
        if not self.addresses:
            raise MXNetError(
                "no parameter server configured: set MXNET_TPU_PS_URI "
                "(comma-separated host:port list) or "
                "DMLC_PS_ROOT_URI / DMLC_PS_ROOT_PORT")
        self._conns = [None] * len(self.addresses)
        self._locks = [threading.Lock() for _ in self.addresses]
        self._ctrl = None
        self._ctrl_lock = threading.Lock()

    @property
    def n_servers(self) -> int:
        return len(self.addresses)

    def _ensure_conn(self, sid):
        if self._conns[sid] is None:
            self._conns[sid] = _connect(self.addresses[sid],
                                        "connect to ps server")
        return self._conns[sid]

    @staticmethod
    def _check(resp):
        if resp[0] != "ok":
            raise MXNetError("ps error: %s" % (resp[1],))
        return resp[1] if len(resp) > 1 else None

    def _rpc(self, sid, *req):
        with self._locks[sid]:
            conn = self._ensure_conn(sid)
            send_msg(conn, *_traced(req))
            resp = recv_msg(conn)
        return self._check(resp)

    def _sharded_rpc(self, reqs):
        """One request a server, pipelined: send all, then read all (the
        servers work at once). reqs: [(sid, request tuple)]."""
        sids = [sid for sid, _ in reqs]
        tp = _trace_header()
        for sid in sorted(sids):
            self._locks[sid].acquire()
        try:
            conns = {sid: self._ensure_conn(sid) for sid in sids}
            for sid, req in reqs:
                if tp is not None:
                    req = ("__traced__", tp) + tuple(req)
                send_msg(conns[sid], *req)
            resps = [recv_msg(conns[sid]) for sid, _ in reqs]
        finally:
            for sid in sorted(sids, reverse=True):
                self._locks[sid].release()
        return [self._check(r) for r in resps]

    def _server_of(self, key) -> int:
        k = key if isinstance(key, int) else zlib.crc32(str(key).encode())
        return k % self.n_servers

    def _plan(self, key, size):
        """None for a whole key, else [(server, lo, hi)] flat ranges
        covering [0, size)."""
        del key
        n = self.n_servers
        if n == 1 or size <= bigarray_bound():
            return None
        per, rem = divmod(size, n)
        plan, off = [], 0
        for i in range(n):
            ln = per + (1 if i < rem else 0)
            plan.append((i, off, off + ln))
            off += ln
        return plan

    def init(self, key, value: np.ndarray):
        v = np.ascontiguousarray(value)
        plan = self._plan(key, v.size)
        if plan is None:
            self._rpc(self._server_of(key), "init", key, v)
            return
        flat = v.reshape(-1)
        self._sharded_rpc([(sid, ("init", (key, "part", sid), flat[lo:hi]))
                           for sid, lo, hi in plan])

    def push(self, key, value: np.ndarray):
        v = np.ascontiguousarray(value)
        plan = self._plan(key, v.size)
        if plan is None:
            self._rpc(self._server_of(key), "push", key, v, self.rank)
            return
        flat = v.reshape(-1)
        self._sharded_rpc([(sid, ("push", (key, "part", sid), flat[lo:hi],
                                  self.rank))
                           for sid, lo, hi in plan])

    def pull(self, key, size=None) -> np.ndarray:
        """The key's value; flat for a sharded key (``size``, its element
        count, picks the push's plan)."""
        plan = None if size is None else self._plan(key, size)
        if plan is None:
            return self._rpc(self._server_of(key), "pull", key)
        parts = self._sharded_rpc([(sid, ("pull", (key, "part", sid)))
                                   for sid, lo, hi in plan])
        return np.concatenate([np.asarray(p).reshape(-1) for p in parts])

    def _ctrl_rpc(self, *req):
        with self._ctrl_lock:
            if self._ctrl is None:
                self._ctrl = _connect(self.addresses[0],
                                      "connect ps control channel")
            send_msg(self._ctrl, *req)
            resp = recv_msg(self._ctrl)
        return self._check(resp)

    def hello(self, rank: int) -> str:
        """Register this worker: "welcome", or "recovery" when this rank's
        earlier connection dropped."""
        return self._ctrl_rpc("hello", int(rank))

    def goodbye(self, rank: int):
        """Deregister this worker: a later hello of its rank is a fresh
        join, not a recovery."""
        self._ctrl_rpc("goodbye", int(rank))

    def heartbeat(self, rank: int):
        self._ctrl_rpc("heartbeat", int(rank))

    def dead_nodes(self, timeout_sec: float = 60):
        """Ranks whose control connection dropped or whose heartbeat is
        older than ``timeout_sec`` (reference GetDeadNodes)."""
        return list(self._ctrl_rpc("dead_nodes", float(timeout_sec)))

    def set_optimizer(self, optimizer):
        blob = pickle.dumps(optimizer)
        for sid in range(self.n_servers):
            self._rpc(sid, "set_optimizer", blob)

    def set_sync(self, sync: bool):
        for sid in range(self.n_servers):
            self._rpc(sid, "set_sync", sync)

    def barrier(self):
        """The workers' barrier, on server 0."""
        self._rpc(0, "barrier")

    def stop(self):
        for sid in range(self.n_servers):
            self._rpc(sid, "stop")

    def close(self):
        """Close every connection."""
        conns = self._conns + [self._ctrl]
        self._conns = [None] * len(self.addresses)
        self._ctrl = None
        for c in conns:
            if c is not None:
                try:
                    c.close()
                except OSError:
                    pass


def run():
    """A server process's entry: serve until stopped, after reporting the
    bound address (reference kvstore_server.py _init_kvstore_server_module)."""
    server = KVStoreServer()
    t = threading.Thread(target=server.run, daemon=True)
    t.start()
    server._ready.wait()
    host, port = server.address[:2]
    port_file = os.environ.get("MXNET_TPU_PS_PORT_FILE")
    if port_file:
        with open(port_file + ".tmp", "w") as f:
            f.write("%s:%d\n" % (host, port))
        os.replace(port_file + ".tmp", port_file)
    print("kvstore_server listening on %s:%d" % (host, port), flush=True)
    sys.stdout.flush()
    t.join()


def maybe_run_server_by_role():
    """Serve when this process's role is "server" (``MXNET_TPU_ROLE`` or
    ``DMLC_ROLE``), as the reference does at import; True if it did."""
    if role() == "server":
        run()
        return True
    return False
