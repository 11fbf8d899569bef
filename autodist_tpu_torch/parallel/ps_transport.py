"""Host transport of the async / bounded-stale parameter service (the port's
copy of ``autodist_tpu/parallel/ps_transport.py``): the chief's
:class:`~autodist_tpu_torch.parallel.staleness.ParameterService` and
:class:`~autodist_tpu_torch.parallel.staleness.StalenessController` behind a
small TCP protocol, so worker processes launched by the Coordinator pull
parameters and push gradients.

- :class:`PSServer` runs on the chief beside its ``AsyncPSRunner``: a thread
  a connection, so a blocked ``start_step`` (the token queue) stalls no one.
- :class:`RemotePSWorker` is a worker process's handle: ``step(batch)``
  takes the chief's gate, pulls the current parameters (version-conditional,
  and prefetched on a second connection under ``AUTODIST_PS_OVERLAP``),
  computes gradients on its own card and pushes them (compressed under
  ``AUTODIST_WIRE_DTYPE``, row-sparse under ``AUTODIST_SPARSE_PUSH``).

Messages are typed frames (:mod:`autodist_tpu_torch.parallel.wire`, the JAX
package's bytes): nothing on the socket is unpickled. Each goes behind an
8-byte big-endian header whose top byte is the frame version (0) and whose
low 56 bits are the payload length. Opcodes, request and reply shapes are
the JAX package's (``:811-905``), so a port worker talks to a JAX chief and
a JAX worker to a port chief. The telemetry planes ride them as in the JAX
package: ``trace`` (the server's span ring), ``push_trace`` (a worker's
ring, clock-offset stamped, deposited on the chief; automatic at close
under ``AUTODIST_TRACE_PULL``), ``record`` (a flight-recorder snapshot on
the chief), ``ping`` (the clock-offset probe), the registry and events in
the ``stats`` and ``status`` replies, and the ``ps.*`` client spans.

The bytes move through the native plane (``native/transport.cc``, built
with ``g++`` into the checkout's ``build/`` at first use, GIL released): a
message's scatter-gather parts (tensor payloads as borrowed views) leave in
``writev`` calls, and a message lands in the connection's recycled receive
buffer (:class:`_RecvBuffer`, reused only once nothing aliases it), where
the decoder's tensors alias it. ``AUTODIST_NATIVE_TRANSPORT=0`` takes the
Python path (``sendmsg``/``recv_into``); with it on, a native build that
fails raises. Sockets with a timeout always take the Python path.
"""

import ctypes
import logging
import math
import os
import socket
import socketserver
import struct
import sys
import threading
import time
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from autodist_tpu_torch import const, telemetry
from autodist_tpu_torch.parallel import recovery as _recovery
from autodist_tpu_torch.parallel import wire
from autodist_tpu_torch.testing import faults as _faults
from autodist_tpu_torch.testing.sanitizer import san_lock
from autodist_tpu_torch.utils.metrics import WireCounters

_log = logging.getLogger("autodist_tpu_torch")

_HDR = struct.Struct("!Q")
_FRAME_VERSION = 0
_FRAME_LEN_MAX = (1 << 56) - 1
_IOV_BATCH = 64

# ---------------------------------------------------------------- native plane
_TR_LIB = None
_TR_OFF = False
_TR_LOCK = threading.Lock()
# Payload bytes the native plane carried in this process (sent, received).
_NATIVE_BYTES = [0, 0]
_NATIVE_BYTES_LOCK = threading.Lock()


def native_enabled() -> bool:
    return const.env_flag(const.AUTODIST_NATIVE_TRANSPORT, True)


def _native_transport():
    """The native library, built at first use; None under
    ``AUTODIST_NATIVE_TRANSPORT=0``. With the flag on, a failed build raises."""
    global _TR_LIB, _TR_OFF
    if _TR_LIB is not None or _TR_OFF:
        return _TR_LIB
    with _TR_LOCK:
        if _TR_LIB is not None or _TR_OFF:
            return _TR_LIB
        if not native_enabled():
            _TR_OFF = True
            return None
        from autodist_tpu_torch.utils.native_build import build_native_lib
        src = os.path.join(os.path.dirname(__file__), "native", "transport.cc")
        lib = build_native_lib(src, "transport")
        if lib is None:
            raise RuntimeError(
                "the native PS transport (parallel/native/transport.cc) did not build; fix "
                "the toolchain (g++) or set AUTODIST_NATIVE_TRANSPORT=0 for the Python path")
        # tr_send, tr_recv and tr_free (the JAX library's single-buffer
        # calls) stay in the library; the port sends and receives through
        # tr_sendv and tr_recv_into.
        lib.tr_last_errno.restype = ctypes.c_int
        lib.tr_last_errno.argtypes = []
        lib.tr_sendv.restype = ctypes.c_int
        lib.tr_sendv.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                                 ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
        lib.tr_recv_into.restype = ctypes.c_int
        lib.tr_recv_into.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64]
        _TR_LIB = lib
        return _TR_LIB


def native_bytes() -> Tuple[int, int]:
    """``(sent, received)`` payload bytes the native plane carried so far."""
    with _NATIVE_BYTES_LOCK:
        return tuple(_NATIVE_BYTES)


def _count_native(i: int, n: int) -> None:
    with _NATIVE_BYTES_LOCK:
        _NATIVE_BYTES[i] += n


def _native_error(lib, what: str) -> ConnectionError:
    err = lib.tr_last_errno()
    if err == 0:
        return ConnectionError(f"PS transport {what}: connection closed by peer")
    return ConnectionError(f"PS transport {what} failed (errno {err}: {os.strerror(err)})")


def _lib_for(sock: socket.socket):
    """The native library for a plain blocking socket, else None (a timeout
    keeps Python's timeout semantics, which raw-fd syscalls would bypass)."""
    return _native_transport() if sock.gettimeout() is None else None


def _address(buf) -> Tuple[int, np.ndarray]:
    """``(address, keep-alive)`` of a bytes-like buffer, no copy."""
    arr = np.frombuffer(buf, np.uint8)
    return arr.ctypes.data, arr


def _send_msg(sock: socket.socket, obj, counters: Optional[WireCounters] = None) -> int:
    """Send one framed message; returns its payload bytes."""
    t0 = time.perf_counter()
    parts = wire.encode_parts(obj)
    enc_s = time.perf_counter() - t0
    n = _send_payload(sock, parts)
    if counters is not None:
        counters.add_sent(n, enc_s)
    return n


def _sendmsg_all(sock: socket.socket, buffers: List[Any]) -> None:
    queue = [memoryview(b).cast("B") for b in buffers if len(b)]
    while queue:
        sent = sock.sendmsg(queue[:_IOV_BATCH])
        while queue and sent >= len(queue[0]):
            sent -= len(queue[0])
            queue.pop(0)
        if sent and queue:
            queue[0] = queue[0][sent:]


def _send_payload(sock: socket.socket, payload: Union[bytes, bytearray, List[Any]]) -> int:
    """Send an encoded payload (one buffer or an ``encode_parts`` list) with
    its frame header."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        parts = [payload]
    else:
        parts = [p for p in payload if len(p)]
    total = sum(memoryview(p).nbytes for p in parts)
    if total > _FRAME_LEN_MAX:
        raise wire.WireError(f"message of {total} bytes exceeds the 56-bit frame length")
    if _faults.armed():
        delay = _faults.throttle_s(total)
        if delay > 0.0:
            time.sleep(delay)
    lib = _lib_for(sock)
    if lib is not None:
        keep = [_address(p) for p in parts]
        ptrs = (ctypes.c_void_p * max(1, len(keep)))(*[a for a, _ in keep])
        lens = (ctypes.c_uint64 * max(1, len(keep)))(*[k.nbytes for _, k in keep])
        while True:
            rc = lib.tr_sendv(sock.fileno(), ptrs, lens, len(keep))
            if rc == 0:
                _count_native(0, total)
                return total
            if rc != -2:   # -2: a signal before any byte moved; retry
                raise _native_error(lib, "send")
    header = _HDR.pack(total)
    if hasattr(sock, "sendmsg"):
        _sendmsg_all(sock, [header, *parts])
    else:
        sock.sendall(header)
        for p in parts:
            sock.sendall(p)
    return total


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    lib = _lib_for(sock)
    if lib is not None:
        if len(view):
            address, keep = _address(view)
            while True:
                rc = lib.tr_recv_into(sock.fileno(), address, len(view))
                if rc == 0:
                    break
                if rc != -2:
                    raise _native_error(lib, "recv")
            del keep
        return
    got, n = 0, len(view)
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise ConnectionError("PS transport connection closed")
        got += r


def _frame_len(header: bytes) -> int:
    """The payload length of an 8-byte header; ``WireError`` for an unknown
    frame version."""
    (word,) = _HDR.unpack(header)
    version = word >> 56
    if version != _FRAME_VERSION:
        raise wire.WireError(f"unsupported PS frame version {version} (header {header!r})")
    return word & _FRAME_LEN_MAX


_RECVBUF_TEL = None


def _recvbuf_counters():
    """The registry's (fresh, recycled) counters, None while telemetry is
    off (one enabled check a message)."""
    if not telemetry.enabled():
        return None
    global _RECVBUF_TEL
    if _RECVBUF_TEL is None:
        _RECVBUF_TEL = (telemetry.counter("ps.recvbuf.fresh"),
                        telemetry.counter("ps.recvbuf.recycled"))
    return _RECVBUF_TEL


class _RecvBuffer:
    """A connection's recycled receive buffer. ``take(n)`` reuses the buffer
    only when nothing else references it (``sys.getrefcount == 2``): tensors
    the decoder aliased into the previous message hold it, so a consumer that
    kept them gets a fresh buffer instead of an overwritten one. The two
    outcomes count as ``ps.recvbuf.fresh`` and ``ps.recvbuf.recycled``."""

    __slots__ = ("_buf", "fresh_allocs", "recycles")
    _MIN_BYTES = 1 << 16

    def __init__(self):
        self._buf: Optional[bytearray] = None
        self.fresh_allocs = 0
        self.recycles = 0

    def take(self, n: int) -> memoryview:
        tel = _recvbuf_counters()
        if self._buf is None or len(self._buf) < n or sys.getrefcount(self._buf) != 2:
            self._buf = bytearray(max(n, self._MIN_BYTES))
            self.fresh_allocs += 1
            if tel is not None:
                tel[0].inc()
        else:
            self.recycles += 1
            if tel is not None:
                tel[1].inc()
        return memoryview(self._buf)[:n]


def _recv_msg(sock: socket.socket, pool: Optional[_RecvBuffer] = None,
              counters: Optional[WireCounters] = None):
    """Receive one framed message; ``(obj, payload_bytes)``. With ``pool`` the
    payload lands in its buffer and tensors alias it; without, the decode
    copies."""
    header = bytearray(_HDR.size)
    _recv_exact_into(sock, memoryview(header))
    n = _frame_len(bytes(header))
    view = pool.take(n) if pool is not None else memoryview(bytearray(n))
    _recv_exact_into(sock, view)
    if _lib_for(sock) is not None:
        _count_native(1, n)
    t0 = time.perf_counter()
    obj = wire.decode(view, copy=pool is None)
    if counters is not None:
        counters.add_received(n, time.perf_counter() - t0)
    return obj, n


def _to_host(tree):
    """Every tensor of a dict/list/tuple tree on the host (one copy a CUDA
    tensor, none for a CPU one)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


class _WorkerStats:
    """Server-side accounting of one worker id: its connections' wire
    traffic and the stamp of its last completed exchange."""

    __slots__ = ("wire", "last_seen")

    def __init__(self):
        # A second view of the server's traffic: not mirrored into the registry.
        self.wire = WireCounters(mirror=False)
        self.last_seen = time.monotonic()


class _StragglerWatchdog:
    """Background stall/straggler monitor of a :class:`PSServer`: every
    ``interval`` seconds it flags a worker silent longer than
    ``STALL_INTERVALS`` intervals (stalled) or sitting at lag 0 for that many
    ticks while a peer is parked at the bound (the straggler), warns at most
    every ``WARN_EVERY_S`` a worker, and with ``evict_after``
    (``AUTODIST_EVICT_AFTER_S``) retires a worker stalled that long. Each
    tick books the ``ps.worker.last_seen_s.w<id>`` gauges; each flag the
    ``ps.straggler.flags`` counter, a ``ps.anomaly.<kind>`` event and an
    armed flight recorder's snapshot."""

    STALL_INTERVALS = 3.0
    WARN_EVERY_S = 60.0

    def __init__(self, server: "PSServer", interval: float):
        self._server = server
        self._interval = max(0.01, float(interval))
        self._stall_after = self.STALL_INTERVALS * self._interval
        self._evict_after = _recovery.evict_after_s()
        self._warn_every = self.WARN_EVERY_S
        self._last_warn: dict = {}
        self._straggler_ticks: dict = {}
        self._stop = threading.Event()
        self.flagged: set = set()
        self._thread = threading.Thread(target=self._run, daemon=True, name="ps-watchdog")
        self._thread.start()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=self._interval + 5.0)

    def _run(self):
        while not self._stop.wait(self._interval):
            try:
                self._sample()
            except Exception as e:  # noqa: BLE001 — monitoring must never stop serving
                _log.debug("PS watchdog sample failed: %s", e)

    def _sample(self):
        now = time.monotonic()
        server = self._server
        with server._worker_stats_lock:
            ages = {wid: now - ws.last_seen for wid, ws in server._worker_stats.items()}
        controller = getattr(server._runner, "controller", None)
        lags = controller.live_lags() if controller is not None else {}
        bound = controller.bound if controller is not None else math.inf
        if controller is not None:
            ages = {wid: age for wid, age in ages.items() if wid in lags}
        reg = telemetry.registry()
        for wid, age in ages.items():
            reg.gauge(f"ps.worker.last_seen_s.w{wid}").set(round(age, 3))
        flagged = {wid: ("stall", age) for wid, age in ages.items() if age > self._stall_after}
        straggling = set()
        if math.isfinite(bound) and len(lags) >= 2 and max(lags.values()) >= bound:
            straggling = {wid for wid, lag in lags.items() if lag == 0}
        self._straggler_ticks = {wid: self._straggler_ticks.get(wid, 0) + 1
                                 for wid in straggling}
        for wid in sorted(straggling, key=str):
            if self._straggler_ticks[wid] >= self.STALL_INTERVALS and wid not in flagged:
                flagged[wid] = ("straggler", ages.get(wid, 0.0))
        for wid, (kind, age) in sorted(flagged.items(), key=lambda kv: str(kv[0])):
            reg.counter("ps.straggler.flags").inc()
            reg.event(f"ps.anomaly.{kind}", worker=wid, last_seen_s=round(age, 3))
            from autodist_tpu_torch.telemetry import recorder as _recorder
            _recorder.maybe_record(f"ps.{kind}.w{wid}", server=server)
            if (kind == "stall" and self._evict_after is not None and age > self._evict_after
                    and controller is not None):
                _recovery.evict(controller, wid, kind="stall", age_s=age, server=server)
            if now - self._last_warn.get(wid, -math.inf) >= self._warn_every:
                self._last_warn[wid] = now
                if kind == "stall":
                    _log.warning("train: PS watchdog: worker %s looks STALLED — no completed "
                                 "exchange for %.1fs (threshold %.1fs)", wid, age,
                                 self._stall_after)
                else:
                    _log.warning("train: PS watchdog: worker %s is the STRAGGLER — peers are "
                                 "parked at the staleness bound (%s) waiting for it (last "
                                 "seen %.1fs ago)", wid, int(bound), age)
        self.flagged = set(flagged)


class PSServer:
    """Serve a chief ``AsyncPSRunner``'s service and controller to remote
    workers. ``host`` defaults to loopback; ``listen_sock`` adopts a socket
    the launcher bound before shipping its address. The protocol is typed
    but unauthenticated, like the reference's servers: binding wider than
    the cluster's trust domain is the caller's choice.
    ``watchdog`` overrides ``AUTODIST_WATCHDOG`` (its interval is
    ``AUTODIST_WATCHDOG_SEC``)."""

    def __init__(self, runner, host: str = "127.0.0.1", port: int = 0,
                 listen_sock: Optional[socket.socket] = None, watchdog: Optional[bool] = None):
        if runner.service is None:
            raise RuntimeError("Call runner.init(params) before serving")
        _native_transport()   # build (or refuse) before the first connection
        self._runner = runner
        self._t_started = time.monotonic()
        # Span rings the workers deposited (push_trace), by worker id: the
        # chief's half of telemetry.collect_cluster_trace.
        self._worker_traces: dict = {}
        self._trace_lock = san_lock()
        self.wire = WireCounters()
        self._worker_stats: dict = {}
        self._worker_stats_lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # The worker id this connection drives and the slot generation
                # it saw: a dead connection retires only that occupant.
                self.worker_id = None
                self.worker_gen = 0
                controller = outer._runner.controller
                pool = _RecvBuffer()
                try:
                    while True:
                        msg, nrecv = _recv_msg(self.request, pool=pool, counters=outer.wire)
                        reply = outer._dispatch(msg)
                        op = msg[0] if isinstance(msg, tuple) and msg else "<malformed>"
                        t0 = time.perf_counter()
                        try:
                            payload = wire.encode_parts(reply)
                        except wire.WireError as e:
                            _log.warning("PS transport: reply to %r is not wire-encodable "
                                         "(%s)", op, e)
                            payload = wire.encode_parts((
                                "error", "WireError",
                                f"server reply to {op!r} is not wire-encodable: {e}"))
                        enc_s = time.perf_counter() - t0
                        if op in ("start_step", "finish_step") and reply[0] == "ok":
                            if self.worker_id != msg[1]:
                                self.worker_id = msg[1]
                                self.worker_gen = reply[1]
                        elif op == "register" and reply[0] == "ok":
                            self.worker_id = reply[1]
                            self.worker_gen = reply[2]
                        nsent = _send_payload(self.request, payload)
                        outer.wire.add_sent(nsent, enc_s)
                        if self.worker_id is not None:
                            ws = outer._stats_for(self.worker_id)
                            ws.wire.add_received(nrecv)
                            ws.wire.add_sent(nsent)
                            ws.last_seen = time.monotonic()
                        # Drop the decoded tensors before the next receive, or
                        # they would pin the buffer and defeat recycling.
                        msg = reply = payload = None
                except wire.WireError as e:
                    _log.warning("PS transport: dropping connection with malformed payload "
                                 "(%s)", e)
                    if self.worker_id is not None:
                        controller.retire(self.worker_id, generation=self.worker_gen)
                except (ConnectionError, OSError):
                    if self.worker_id is not None:
                        _log.warning("PS worker %s disconnected; retiring it from the "
                                     "staleness gate", self.worker_id)
                        if controller.retire(self.worker_id, generation=self.worker_gen):
                            _recovery.log_eviction(self.worker_id, kind="disconnect")

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        if listen_sock is not None:
            self._server = Server(listen_sock.getsockname(), Handler, bind_and_activate=False)
            self._server.socket.close()
            self._server.socket = listen_sock
            self._server.server_activate()
        else:
            self._server = Server((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        if watchdog is None:
            watchdog = const.env_flag(const.AUTODIST_WATCHDOG, True)
        self._watchdog = _StragglerWatchdog(
            self, const.env_float(const.AUTODIST_WATCHDOG_SEC, 10.0)) if watchdog else None
        # AUTODIST_METRICS_PORT serves /metrics and /healthz from this
        # process; the metric history's wall-clock sampler is its only beat.
        from autodist_tpu_torch.telemetry import history as _history
        from autodist_tpu_torch.telemetry import openmetrics as _openmetrics
        _openmetrics.maybe_serve()
        _history.maybe_arm()
        _log.info("PSServer listening on %s:%d", *self._server.server_address[:2])

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address[:2]

    def _stats_for(self, worker_id) -> _WorkerStats:
        with self._worker_stats_lock:
            ws = self._worker_stats.get(worker_id)
            if ws is None:
                ws = self._worker_stats[worker_id] = _WorkerStats()
            return ws

    def stats_snapshot(self) -> dict:
        """The ``stats`` reply (``ps_transport.py:709-738``): the registry
        snapshot, the aggregate wire counters, uptime, the structured
        anomaly events, per-worker wire traffic, last-seen age and staleness
        histograms, and the shards' versions."""
        now = time.monotonic()
        with self._worker_stats_lock:
            ws_items = sorted(self._worker_stats.items())
        per_worker: dict = {wid: {"wire": ws.wire.snapshot(),
                                  "last_seen_s": round(now - ws.last_seen, 3)}
                            for wid, ws in ws_items}
        controller = getattr(self._runner, "controller", None)
        if controller is not None:
            for wid, snap in controller.staleness_snapshot().items():
                per_worker.setdefault(wid, {})["staleness"] = snap
        snap = {"registry": telemetry.snapshot(), "wire": self.wire.snapshot(),
                "uptime_s": round(now - self._t_started, 3),
                "anomalies": telemetry.events(), "per_worker": per_worker}
        shard_versions = getattr(getattr(self._runner, "service", None), "shard_versions", None)
        if shard_versions is not None:
            snap["shard_versions"] = list(shard_versions)
        return snap

    def status_snapshot(self) -> dict:
        """The ``status`` reply (``ps_transport.py:740-775``, what
        ``tools/adtop.py`` renders): the stats with their events under
        ``events``, ``kind``, the alert, recovery and memory sections, the
        gate's instantaneous lags and bound, and the service version."""
        from autodist_tpu_torch.telemetry import alerts as _alerts
        from autodist_tpu_torch.telemetry import memplane as _memplane
        snap = self.stats_snapshot()
        snap["kind"] = "ps"
        snap["events"] = snap.pop("anomalies", [])
        snap["alerts"] = _alerts.alerts_snapshot()
        snap["recovery"] = _recovery.recovery_snapshot()
        snap["memory"] = _memplane.memory_snapshot()
        controller = getattr(self._runner, "controller", None)
        if controller is not None:
            bound = controller.bound
            snap["staleness_bound"] = None if math.isinf(bound) else int(bound)
            for wid, lag in controller.live_lags().items():
                snap["per_worker"].setdefault(wid, {})["lag"] = int(lag)
        version = getattr(getattr(self._runner, "service", None), "version", None)
        if version is not None:
            snap["version"] = int(version)
        return snap

    def _store_worker_trace(self, worker_id, state):
        """The ``push_trace`` sink: keep a worker's ring (latest wins), its
        array columns copied out of the recycled receive buffer."""
        if not isinstance(state, dict) or "t0_ns" not in state:
            raise TypeError("push_trace payload is not a trace-state dict")
        state = {k: (np.array(v) if isinstance(v, np.ndarray)
                     else v.clone() if isinstance(v, torch.Tensor) else v)
                 for k, v in state.items()}
        with self._trace_lock:
            self._worker_traces[worker_id] = state

    def worker_traces(self) -> dict:
        """``{worker_id: trace-state}`` of every ring the workers pushed."""
        with self._trace_lock:
            return dict(self._worker_traces)

    def _dispatch(self, msg):
        if not isinstance(msg, tuple) or not msg or not isinstance(msg[0], str):
            return ("error", "PSClientError",
                    f"malformed protocol message: expected (op, ...) tuple, got "
                    f"{type(msg).__name__}")
        op = msg[0]
        r = self._runner
        try:
            if op == "start_step":
                _, worker_id, timeout = msg
                # None waits at most a day, so a vanished peer cannot park
                # this handler thread forever.
                gen = r.controller.start_step(worker_id,
                                              86400.0 if timeout is None else float(timeout))
                return ("ok", gen)
            if op == "read":
                params, ef_state, version = r.service.read()
                return ("ok", _to_host(params), _to_host(ef_state), version)
            if op == "read_if_newer":
                params, ef_state, version = r.service.read_if_newer(msg[1])
                if params is None:
                    return ("ok", None, None, version)
                return ("ok", _to_host(params), _to_host(ef_state), version)
            if op == "read_min":
                _, min_version, have_version, timeout = msg
                timeout = min(float(timeout), 600.0) if timeout else 0.0
                params, ef_state, version = r.service.read_min(min_version, have_version,
                                                               timeout)
                if params is None:
                    return ("ok", None, None, version)
                return ("ok", _to_host(params), _to_host(ef_state), version)
            if op == "apply":
                return ("ok", r.service.apply(msg[1]))
            if op == "apply_sparse":
                from autodist_tpu_torch.parallel.synchronization import densify_sparse_rows
                return ("ok", r.service.apply(densify_sparse_rows(msg[1])))
            if op == "wire_caps":
                return ("ok", {"quantized": True, "sparse_push": True})
            if op == "finish_step":
                return ("ok", r.controller.finish_step(msg[1]))
            if op == "register":
                worker, gen = r.add_worker(msg[1], with_generation=True)
                return ("ok", worker.worker_id, gen)
            if op == "version":
                return ("ok", r.service.version)
            if op == "stats":
                return ("ok", self.stats_snapshot())
            if op == "status":
                return ("ok", self.status_snapshot())
            if op == "record":
                # A manual flight-recorder snapshot, now (no debounce).
                from autodist_tpu_torch.telemetry import recorder as _recorder
                reason = str(msg[1]) if len(msg) > 1 and msg[1] else "manual"
                return ("ok", _recorder.get_or_create().record(reason, server=self))
            if op == "ping":
                return ("ok", msg[1], time.time_ns())
            if op == "trace":
                since = msg[1] if len(msg) > 1 else None
                return ("ok", telemetry.local_trace_state(since_ns=since))
            if op == "push_trace":
                self._store_worker_trace(msg[1], msg[2])
                return ("ok", True)
            return ("error", "PSClientError", f"unknown op {op!r}")
        except Exception as e:  # noqa: BLE001 — ship the failure to the worker, keep serving
            return ("error", type(e).__name__, str(e))

    def close(self):
        if self._watchdog is not None:
            self._watchdog.close()
            self._watchdog = None
        self._server.shutdown()
        self._server.server_close()
        if self.wire.msgs_received:
            now = time.monotonic()
            _log.info("PSServer closed: %s | up %.1fs", self.wire.format_line(),
                      now - self._t_started)
            controller = getattr(self._runner, "controller", None)
            stal = controller.staleness_histograms() if controller is not None else {}
            with self._worker_stats_lock:
                ws_items = dict(self._worker_stats)
            for wid in sorted(set(ws_items) | set(stal), key=str):
                parts = []
                ws = ws_items.get(wid)
                if ws is not None:
                    parts.append(ws.wire.format_line())
                    parts.append(f"last seen {now - ws.last_seen:.1f}s ago")
                hist = stal.get(wid)
                if hist is not None and hist.count:
                    parts.append(f"staleness {hist.format_compact()}")
                if parts:
                    _log.info("PSServer closed:   worker %s: %s", wid, " | ".join(parts))


class PSClientError(RuntimeError):
    """A server-side failure reported over the transport."""


# Opcodes whose replay after a transport failure cannot change server state a
# second time: the client may reconnect and retry them (AUTODIST_WIRE_RETRIES,
# jittered backoff). register is idempotent only with an explicit id. apply,
# apply_sparse and finish_step are not: their failure surfaces to the caller.
IDEMPOTENT_OPS = frozenset({
    "read", "read_if_newer", "read_min", "version", "stats", "status", "ping", "trace",
    "reqtrace", "push_trace", "register", "start_step", "wire_caps"})


def _retry_safe(msg) -> bool:
    op = msg[0] if isinstance(msg, tuple) and msg else None
    if op not in IDEMPOTENT_OPS:
        return False
    if op == "register" and (len(msg) < 2 or msg[1] is None):
        return False   # each replay would allocate another slot
    return True


class _PSClient:
    # Seconds the whole retry-until-up loop may take (the chief serves only
    # after its runner's init).
    CONNECT_TIMEOUT_S = 60.0

    def __init__(self, address, connect_timeout: Optional[float] = None):
        """``connect_timeout`` bounds the whole retry-until-up loop (default
        :attr:`CONNECT_TIMEOUT_S`); the serving router passes a short one, a
        replica that refuses connections being the failure it routes around."""
        if isinstance(address, str):
            host, _, port = address.rpartition(":")
            address = (host, int(port))
        self._address = address
        self._connect_timeout = (self.CONNECT_TIMEOUT_S if connect_timeout is None
                                 else float(connect_timeout))
        self._retries = max(0, const.env_int(const.AUTODIST_WIRE_RETRIES, 2))
        self._backoff_s = max(0.0, const.env_float(const.AUTODIST_WIRE_BACKOFF_S, 0.2))
        _native_transport()
        self._closed = False
        self._sock = self._connect(self._connect_timeout)
        self._lock = threading.Lock()
        self._pool = _RecvBuffer()
        self.wire = WireCounters()

    def _connect(self, budget: float) -> socket.socket:
        """Connect with jittered exponential backoff within ``budget``
        seconds (the chief serves only after its runner's init)."""
        deadline = time.monotonic() + budget
        attempt = 0
        while True:
            try:
                if _faults.armed() and _faults.should_fire("wire_refuse"):
                    raise ConnectionRefusedError("injected wire_refuse fault point")
                per_try = min(10.0, max(0.1, deadline - time.monotonic()))
                sock = socket.create_connection(self._address, timeout=per_try)
                sock.settimeout(None)   # replies wait as long as the gate says
                return sock
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(min(max(0.0, deadline - time.monotonic()),
                               _recovery.backoff_s(attempt, self._backoff_s or 0.2, cap_s=2.0)))
                attempt += 1

    @property
    def bytes_sent(self) -> int:
        return self.wire.bytes_sent

    @property
    def bytes_received(self) -> int:
        return self.wire.bytes_received

    def call_raw(self, msg: tuple, counters: WireCounters):
        """One exchange accounted into ``counters``, returned unchecked.
        Transient failures of idempotent opcodes reconnect and retry; a
        reply-wait timeout never retries (the reply may still come)."""
        op = msg[0] if isinstance(msg, tuple) and msg else None
        attempt = 0
        with self._lock:
            while True:
                try:
                    if _faults.armed() and _faults.should_fire("wire_reset", op=op):
                        try:
                            self._sock.shutdown(socket.SHUT_RDWR)
                        except OSError:
                            pass
                        self._sock.close()
                        raise ConnectionResetError("injected wire_reset fault point")
                    _send_msg(self._sock, msg, counters)
                    reply, _ = _recv_msg(self._sock, pool=self._pool, counters=counters)
                    return reply
                except (socket.timeout, TimeoutError):
                    raise
                except (ConnectionError, OSError) as e:
                    if self._closed or not _retry_safe(msg) or attempt >= self._retries:
                        raise
                    attempt += 1
                    delay = _recovery.backoff_s(attempt - 1, self._backoff_s, cap_s=5.0)
                    _log.warning("PS transport: %r failed (%s); reconnecting and retrying "
                                 "idempotent op in %.2fs (attempt %d/%d)", op, e, delay,
                                 attempt, self._retries)
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    time.sleep(delay)
                    self._sock = self._connect(self._connect_timeout)
                    self._pool = _RecvBuffer()

    def call(self, *msg):
        reply = self.call_raw(msg, self.wire)
        if reply[0] != "ok":
            kind, detail = reply[1], reply[2]
            if kind == "StalenessTimeout":
                from autodist_tpu_torch.parallel.staleness import StalenessTimeout
                raise StalenessTimeout(detail)
            if kind == "WorkerEvicted":
                from autodist_tpu_torch.parallel.staleness import WorkerEvicted
                raise WorkerEvicted(detail)
            raise PSClientError(f"{kind}: {detail}")
        return reply[1:]

    def close(self):
        # shutdown() first: closing an fd does not wake a thread blocked in
        # recv(2) (the prefetch thread may be parked there), which then fails
        # without a retry.
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class _Prefetch:
    """An in-flight overlapped parameter pull."""
    __slots__ = ("thread", "result", "error", "counters")

    def __init__(self):
        self.thread = None
        self.result = None
        self.error = None
        self.counters = WireCounters()


class RemotePSWorker:
    """A worker process's handle onto the chief's parameter service:
    :class:`~autodist_tpu_torch.parallel.staleness.AsyncWorker` with the
    service and gate calls crossing the transport, and the gradients
    computed on this process's card by the runner's gradient fn.

    Pulls are version-conditional: the last pull is kept (on the card) and
    ``read_if_newer`` skips the payload when the version has not moved. With
    ``overlap`` (default ``AUTODIST_PS_OVERLAP``, on) a second connection
    prefetches the next version with ``read_min`` while this step's push and
    gate round trips run; the prefetched tree is used only after
    ``read_if_newer`` confirms it is current, so every step sees what a
    serial client would. ``runner=None`` gives a protocol-only handle.

    ``clock_offset_ns`` (from :meth:`estimate_clock_offset`, None until
    then) is what to ADD to this process's wall clock to land on the
    chief's: the cluster trace plane rebases this worker's spans with it."""

    PREFETCH_TIMEOUT = 30.0
    CLOCK_PING_ROUNDS = 7

    def __init__(self, address, runner, worker_id: int, overlap: Optional[bool] = None,
                 wire_dtype: Optional[str] = None, compressor=None):
        self._client = _PSClient(address)
        self._runner = runner
        self.clock_offset_ns: Optional[int] = None
        self.clock_offset_err_ns: Optional[int] = None
        self.worker_id = worker_id
        self.steps_completed = 0
        self.last_version_read = -1
        self.last_pull_s = self.last_push_s = 0.0
        if overlap is None:
            overlap = const.env_flag(const.AUTODIST_PS_OVERLAP, True)
        self._pull_client = _PSClient(address) if overlap else None
        self._prefetch: Optional[_Prefetch] = None
        self._server_has_read_min = True
        spec = getattr(runner, "_model_spec", None)
        self._trainable = {spec.keys[n] for n in spec.trainable} if spec is not None else set()
        if compressor is None:
            if wire_dtype is None:
                wire_dtype = getattr(getattr(runner, "tuned_plan", None), "wire_dtype", "") \
                    or const.env_str(const.AUTODIST_WIRE_DTYPE)
            sparse_params = {}
            plan = getattr(runner, "plan", None)
            if const.env_flag(const.AUTODIST_SPARSE_PUSH, True) and plan is not None \
                    and spec is not None:
                sparse_params = {spec.keys[name]: p.index_leaf
                                 for name, p in plan.sparse_wire_params.items()}
            from autodist_tpu_torch.parallel.synchronization import WirePushCompressor
            compressor = WirePushCompressor(wire_dtype, sparse_params=sparse_params)
        self._compressor = compressor if compressor.active else None
        # Register up front: idempotent for a live slot, and re-admits a
        # retired one (a relaunched process reusing its id).
        self.register()
        if self._compressor is not None:
            self._probe_wire_caps()
        self._cached_pull = None

    @property
    def wire_bytes(self) -> Tuple[int, int]:
        """(sent, received) payload bytes, a prefetch's counted when consumed."""
        return self._client.bytes_sent, self._client.bytes_received

    @property
    def wire_counters(self) -> WireCounters:
        return self._client.wire

    def _probe_wire_caps(self):
        """Drop the compression regimes the server cannot decode."""
        try:
            caps = self._client.call("wire_caps")[0] or {}
        except PSClientError as e:
            if "unknown op" not in str(e):
                raise
            caps = {}
            _log.warning("PS worker %s: server has no wire_caps op; pushing exact "
                         "uncompressed gradients", self.worker_id)
        comp = self._compressor
        if not caps.get("quantized"):
            comp.wire_dtype = ""
        if not caps.get("sparse_push"):
            comp.sparse_params = {}
        if not comp.active:
            self._compressor = None

    def register(self) -> int:
        """(Re-)admit this worker to the chief's gate, seeded at the slowest
        live worker's count; returns the admitted id."""
        wid = self._client.call("register", self.worker_id)[0]
        self.worker_id = wid
        return wid

    def rejoin(self) -> int:
        """Recover from an eviction without a checkpoint: re-register and
        catch up on the chief's live params over ``read_min``."""
        self._prefetch = None
        self._cached_pull = None
        self.last_version_read = -1
        wid = self.register()
        with telemetry.span("ps.rejoin", worker=wid):
            try:
                params, ef_state, version = self._client.call("read_min", 0, -1,
                                                              self.PREFETCH_TIMEOUT)
            except PSClientError as e:
                if "unknown op" not in str(e):
                    raise
                params, ef_state, version = self._client.call("read")
        if params is not None:
            self._cached_pull = (self._materialize(params), ef_state)
            self.last_version_read = version
        _log.warning("PS worker %s rejoined the staleness gate and caught up to chief version "
                     "%s (checkpoint-free restart)", wid, version)
        return wid

    def _materialize(self, params):
        """Pulled host tensors to this worker's card, as fresh leaves (the
        trainable ones requiring grad): the receive buffer is free again."""
        device = self._runner.device if self._runner is not None else torch.device("cpu")
        return {k: t.to(device, copy=True).requires_grad_(k in self._trainable)
                for k, t in params.items()}

    def _start_prefetch(self):
        """Kick the next step's pull onto the second connection: ``read_min``
        of the version after the last one read parks until this worker's
        apply lands, then streams."""
        if self._pull_client is None or self._prefetch is not None:
            return
        pf = _Prefetch()
        have = self.last_version_read
        use_read_min = self._server_has_read_min
        client = self._pull_client

        def run():
            try:
                with telemetry.span("ps.prefetch", worker=self.worker_id):
                    run_pull()
            except BaseException as e:  # noqa: BLE001 — surfaced (or discarded) at join
                pf.error = e

        def run_pull():
            if use_read_min:
                reply = client.call_raw(("read_min", have + 1, have, self.PREFETCH_TIMEOUT),
                                        pf.counters)
                if reply[0] == "error" and len(reply) > 2 and "unknown op" in str(reply[2]):
                    self._server_has_read_min = False
                    reply = client.call_raw(("read_if_newer", have), pf.counters)
            else:
                reply = client.call_raw(("read_if_newer", have), pf.counters)
            if reply[0] == "ok" and reply[1] is not None:
                reply = (reply[0], self._materialize(reply[1])) + tuple(reply[2:])
            pf.result = reply

        pf.thread = threading.Thread(target=run, daemon=True, name="ps-pull-prefetch")
        pf.thread.start()
        self._prefetch = pf

    def _take_prefetch(self):
        """Join the in-flight pull: ``(params, ef_state, version)`` or None.
        A failed pull turns overlap off for this worker's life."""
        pf, self._prefetch = self._prefetch, None
        if pf is None:
            return None
        pf.thread.join(timeout=self.PREFETCH_TIMEOUT + 30.0)
        if pf.thread.is_alive() or pf.error is not None:
            _log.warning("PS overlap: background pull failed (%s); falling back to serial "
                         "pulls", pf.error or "join timeout")
            if self._pull_client is not None:
                try:
                    self._pull_client.close()
                except OSError:
                    pass
                self._pull_client = None
            return None
        self._client.wire.merge(pf.counters)
        if pf.result[0] != "ok":
            return None
        return pf.result[1:]

    def _pull(self):
        """The current ``(params, ef_state, version)``, the payload skipped
        when the version has not moved past the cached one."""
        pf = self._take_prefetch()
        if pf is not None:
            p_params, p_ef, p_version = pf
            if p_params is not None and p_version > self.last_version_read:
                self._cached_pull = (p_params, p_ef)
                self.last_version_read = p_version
        if self._cached_pull is None:
            params, ef_state, version = self._client.call("read")
            params = self._materialize(params)
        else:
            params, ef_state, version = self._client.call("read_if_newer",
                                                          self.last_version_read)
            if params is None:
                params, ef_state = self._cached_pull
            else:
                params = self._materialize(params)
        self._cached_pull = (params, ef_state)
        self.last_version_read = version
        return params, ef_state, version

    def step(self, batch, timeout: Optional[float] = None):
        from autodist_tpu_torch.parallel.staleness import WorkerEvicted, _device_scope
        r = self._runner
        if _faults.armed():
            _faults.maybe_hang(step=self.steps_completed, worker=self.worker_id)
            if _faults.should_fire("worker_crash", step=self.steps_completed,
                                   worker=self.worker_id):
                self._crash()
                raise _faults.WorkerCrashed(f"remote worker {self.worker_id} crashed by fault "
                                            f"injection at step {self.steps_completed}")
        try:
            with telemetry.span("ps.gate", worker=self.worker_id):
                self._client.call("start_step", self.worker_id, timeout)
        except WorkerEvicted:
            _log.warning("PS worker %s was evicted from the staleness gate; rejoining with "
                         "live-param catch-up", self.worker_id)
            self.rejoin()
            with telemetry.span("ps.gate", worker=self.worker_id):
                self._client.call("start_step", self.worker_id, timeout)
        t0 = time.perf_counter()
        with telemetry.span("ps.pull", worker=self.worker_id):
            params, _, _ = self._pull()
        t1 = time.perf_counter()
        with _device_scope(r.device):
            with telemetry.span("ps.shard"):
                sharded = r.shard_batch(batch)
            with telemetry.span("ps.grad"):
                grads, loss, aux = r.grad_fn(params, sharded, {})
                grads = _to_host(grads)
        self._start_prefetch()
        t2 = time.perf_counter()
        push_op = "apply"
        if self._compressor is not None:
            with telemetry.span("ps.compress", worker=self.worker_id):
                grads, has_sparse = self._compressor.compress(grads, batch=batch)
            if has_sparse:
                push_op = "apply_sparse"
        with telemetry.span("ps.push", worker=self.worker_id):
            self._client.call(push_op, grads)
            self._client.call("finish_step", self.worker_id)
        # Host seconds of this step's pull (to the card) and push (the
        # compression, the gradients' frames and the apply's acknowledgement).
        self.last_pull_s, self.last_push_s = t1 - t0, time.perf_counter() - t2
        self.steps_completed += 1
        if r.has_aux:
            return loss, aux
        return loss

    def stats(self) -> dict:
        """The chief's ``stats`` snapshot."""
        return self._client.call("stats")[0]

    def status(self) -> dict:
        """The chief's ``status`` snapshot."""
        return self._client.call("status")[0]

    def record(self, reason: str = "manual") -> Optional[str]:
        """A flight-recorder snapshot ON THE CHIEF (the ``record`` opcode, no
        debounce); returns the chief-side snapshot directory."""
        return self._client.call("record", reason)[0]

    def estimate_clock_offset(self, rounds: Optional[int] = None):
        """The chief-clock offset: ``rounds`` ``ping`` exchanges, each an NTP
        midpoint sample; the median offset and its RTT-bounded uncertainty
        are kept (``clock_offset_ns``, ``clock_offset_err_ns``) and
        returned (:func:`autodist_tpu_torch.telemetry.cluster.ntp_offset`)."""
        from autodist_tpu_torch.telemetry import cluster as _cluster
        samples = []
        for _ in range(rounds or self.CLOCK_PING_ROUNDS):
            t0 = time.time_ns()
            _, server_ns = self._client.call("ping", t0)
            samples.append((t0, server_ns, time.time_ns()))
        self.clock_offset_ns, self.clock_offset_err_ns = _cluster.ntp_offset(samples)
        return self.clock_offset_ns, self.clock_offset_err_ns

    def trace(self, since_ns: Optional[int] = None) -> dict:
        """The CHIEF's span ring (the ``trace`` opcode), a trace state for
        ``telemetry.merge_trace_states``."""
        return self._client.call("trace", since_ns)[0]

    def push_trace(self, since_ns: Optional[int] = None) -> int:
        """Deposit this process's span ring on the chief (``push_trace``),
        stamped with the clock offset (estimated once), for the chief's
        ``collect_cluster_trace``; returns the spans pushed. Automatic at
        :meth:`close` under ``AUTODIST_TRACE_PULL=1``."""
        if self.clock_offset_ns is None:
            self.estimate_clock_offset()
        from autodist_tpu_torch.telemetry import cluster as _cluster
        state = _cluster.local_trace_state(since_ns=since_ns, worker_id=self.worker_id,
                                           clock_offset_ns=self.clock_offset_ns)
        self._client.call("push_trace", self.worker_id, state)
        return len(state["name_idx"])

    @property
    def version(self) -> int:
        return self._client.call("version")[0]

    def _crash(self):
        """Abrupt teardown (the ``worker_crash`` fault point): the server sees
        the EOF a killed process gives and retires the slot."""
        pf, self._prefetch = self._prefetch, None
        if self._pull_client is not None:
            try:
                self._pull_client.close()
            except OSError:
                pass
            self._pull_client = None
        if pf is not None and pf.thread is not None:
            pf.thread.join(timeout=5.0)
        try:
            self._client.close()
        except OSError:
            pass

    def close(self):
        if const.ENV.AUTODIST_TRACE_PULL.val and telemetry.enabled():
            # The last act on the live connection: the chief keeps this
            # worker's lane after the process is gone.
            try:
                self.push_trace()
            except (ConnectionError, OSError, PSClientError) as e:
                _log.debug("trace push at close failed: %s", e)
        pf, self._prefetch = self._prefetch, None
        if self._pull_client is not None:
            self._pull_client.close()
            self._pull_client = None
        if pf is not None and pf.thread is not None:
            pf.thread.join(timeout=5.0)
        self._client.close()
