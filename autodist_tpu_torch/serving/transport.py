"""Serving transport: request/response opcodes on the zero-copy wire (the
port of ``autodist_tpu/serving/transport.py``; the frames are the JAX
package's, byte for byte, so a client of either package talks to a server of
the other).

The PS transport's plane is reused wholesale — typed codec
(``parallel/wire.py``: nothing on the socket is ever unpickled),
scatter-gather ``sendmsg`` sends, recycled ``recv_into`` buffers, 8-byte
version-validated framing — with a new opcode vocabulary for online
inference:

- ``generate`` — LM generation: ``(op, prompt int32[P], max_new_tokens,
  seed, timeout)`` -> ``("ok", tokens int32[T], timing)``. The handler
  thread enqueues into the continuous batcher and parks (bounded) on the
  request's completion event; the socket is idle while the batch cooks, so
  a slow generation never blocks other connections (thread-per-connection,
  the same property the PS gate relies on).
- ``infer`` — stateless model apply: ``(op, example-pytree, timeout)`` ->
  ``("ok", output-pytree, timing)``.
- ``stats`` — the serving SLO snapshot (telemetry registry + queue/batch
  state), remote observability without grepping the server's log.
- ``ping`` — health/liveness echo.

Every opcode the client sends has a server arm, as on the PS wire.
Malformed payloads (wrong types, oversize prompts, full queue) get an
``("error", kind, detail)`` reply — a hostile peer achieves data parsing and
its own rejection, nothing more.
"""

import socket
import socketserver
import threading
import time
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from autodist_tpu_torch import telemetry
from autodist_tpu_torch.telemetry import reqtrace as _reqtrace
from autodist_tpu_torch.parallel import wire
from autodist_tpu_torch.parallel.ps_transport import (_PSClient, _RecvBuffer,
                                                      _native_transport,
                                                      _recv_msg, _send_payload,
                                                      PSClientError)
from autodist_tpu_torch.serving.batcher import ServeBusy, ServeError
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.metrics import WireCounters
from autodist_tpu_torch.testing.sanitizer import san_lock

# Hard ceiling on one request's server-side completion wait: a vanished
# batcher must not park a handler thread forever (waits are bounded at the
# trust boundary too); a single generation this long is operationally dead.
MAX_WAIT_S = 600.0

# How often an idle server loop looks for shutdown(): close() and kill()
# wait up to this long (socketserver's default is half a second).
SHUTDOWN_POLL_S = 0.05

# Completed-reply dedup entries kept per server (see the ``generate`` arm):
# the router's replay window is one in-flight set, so a small bound holds.
DEDUP_KEEP = 512


def _wire_server(host: str, port: int, owner) -> socketserver.TCPServer:
    """The shared thread-per-connection wire loop behind both serving
    endpoints (:class:`InferenceServer` and the fleet ``RouterServer``):
    recv typed message -> ``owner._dispatch(msg, span)`` -> send typed
    reply. ``owner`` provides ``wire`` (counters), ``_dispatch`` and
    ``_conns`` (live handler sockets, so ``kill()`` can sever them)."""

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            pool = _RecvBuffer()
            owner._conns.add(self.request)
            try:
                while True:
                    msg, _ = _recv_msg(self.request, pool=pool,
                                       counters=owner.wire)
                    is_protocol = isinstance(msg, tuple) and bool(msg)
                    op = msg[0] if is_protocol else "<malformed>"
                    with telemetry.span("serve.request", op=str(op)) as sp:
                        # The dispatch stamps the request id it assigns
                        # onto this span (sp.set(rid=...)) so one id ties
                        # the transport span, the batcher's prefill/
                        # decode spans, and the reply timing together.
                        reply = owner._dispatch(msg, sp)
                    try:
                        payload = wire.encode_parts(reply)
                    except wire.WireError as e:
                        # OUR reply is unencodable (e.g. a model output
                        # pytree with an unregistered node) — a server
                        # limitation, not a hostile peer: report it.
                        logging.warning(
                            "serve transport: reply to %r is not "
                            "wire-encodable (%s)", op, e)
                        payload = wire.encode_parts((
                            "error", "WireError",
                            f"server reply to {op!r} is not "
                            f"wire-encodable: {e}"))
                    n = _send_payload(self.request, payload)
                    owner.wire.add_sent(n)
                    # Drop aliases into the recv buffer before the next
                    # recv so the pool can recycle it.
                    msg = reply = payload = None
            except wire.WireError as e:
                logging.warning("serve transport: dropping connection "
                                "with malformed payload (%s)", e)
            except (ConnectionError, OSError):
                pass  # client went away; its requests complete unobserved
            finally:
                owner._conns.discard(self.request)

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    return Server((host, port), Handler)


def host_tree(obj):
    """A decoded payload with its tensors as numpy copies: the port's codec
    decodes arrays to CPU torch tensors aliasing the receive buffer, and the
    batchers and clients take numpy arrays, as the JAX package's do."""
    if torch.is_tensor(obj):
        return obj.numpy().copy()
    if isinstance(obj, dict):
        return {k: host_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_tree(v) for v in obj)
    return obj


def _env_address() -> Tuple[str, int]:
    """The ``AUTODIST_SERVE_ADDR`` default: ``host:port`` when the flag is
    set, else loopback on an ephemeral port. Server bind and client target
    share it, so one exported flag points both ends at the same place."""
    from autodist_tpu_torch import const
    addr = str(const.ENV.AUTODIST_SERVE_ADDR.val)
    if not addr:
        return "127.0.0.1", 0
    host, sep, port = addr.rpartition(":")
    if not sep:
        return addr, 0
    return host, int(port)


class InferenceServer:
    """Serve a batcher (LM :class:`~autodist_tpu_torch.serving.batcher.Batcher` or
    :class:`~autodist_tpu_torch.serving.batcher.ApplyBatcher`) to remote clients.

    Same trust model as the PS transport: the wire is typed (no code
    execution on decode) but unauthenticated — binding wider than loopback /
    the cluster's trust domain is the caller's explicit choice (defaults:
    ``AUTODIST_SERVE_ADDR`` when set, else loopback on an ephemeral port)."""

    def __init__(self, batcher, host: Optional[str] = None,
                 port: Optional[int] = None):
        env_host, env_port = _env_address()
        host = env_host if host is None else host
        port = env_port if port is None else port
        self._batcher = batcher
        self._t_started = time.monotonic()
        self.wire = WireCounters()
        # Request-id dedup for the fleet router's replay path (the
        # ``generate`` op is NOT wire-retried — replay happens one level up,
        # made idempotent here): a completed rid's reply is cached, so a
        # router that re-sends an in-flight request after a replica death
        # can never double-generate on a replica that already finished it.
        self._dedup: "OrderedDict[str, tuple]" = OrderedDict()
        self._dedup_lock = san_lock()
        self._conns: set = set()
        _native_transport()   # build (or refuse) before the first connection
        self._server = _wire_server(host, port, self)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        args=(SHUTDOWN_POLL_S,), daemon=True)
        self._thread.start()
        # Scrape endpoint: AUTODIST_METRICS_PORT attaches /metrics+/healthz
        # to the serving process (process-global; no-op when the flag is off).
        from autodist_tpu_torch.telemetry import openmetrics as _openmetrics
        _openmetrics.maybe_serve()
        logging.info("InferenceServer (%s batcher, %s mode) listening on "
                     "%s:%d", batcher.kind, batcher.config.mode,
                     *self._server.server_address)

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address

    def stats_snapshot(self) -> dict:
        """Wire-encodable serving snapshot: the telemetry registry (the
        ``serve.*`` SLO families live there), queue/batch state, uptime,
        and the structured event ring (so anomaly records survive the
        serving process — the stats plane is their offline exit)."""
        return {"registry": telemetry.snapshot(),
                "wire": self.wire.snapshot(),
                "uptime_s": round(time.monotonic() - self._t_started, 3),
                "mode": self._batcher.config.mode,
                "kind": self._batcher.kind,
                "capacity": self._batcher._engine.capacity,
                "queue_depth": self._batcher.queue_depth(),
                "events": telemetry.events()}

    def status_snapshot(self) -> dict:
        """The live-ops view the ``status`` opcode ships (``tools/adtop.py``
        polls it): :meth:`stats_snapshot` plus the per-request IN-FLIGHT
        table (request id, slot, age, tokens decoded) and a ``kind``
        discriminator (``serve``) so one console renders PS and serving
        endpoints alike."""
        snap = self.stats_snapshot()
        snap["kind"] = "serve"
        snap["engine"] = self._batcher.kind
        snap["in_flight"] = self._batcher.in_flight_snapshot()
        # Alert plane: same section (and same empty-shell contract) as the
        # PS status — one console renders both endpoint kinds.
        from autodist_tpu_torch.telemetry import alerts as _alerts
        snap["alerts"] = _alerts.alerts_snapshot()
        # Recovery plane: same section as the PS status (a serving process
        # normally has no membership actions — the stable empty shell — but
        # a co-located trainer's records render identically either way).
        from autodist_tpu_torch.parallel import recovery as _recovery
        snap["recovery"] = _recovery.recovery_snapshot()
        # Memory plane: the serving census is the paged-KV pool claim plus
        # pressure — the ratio the admission holdback reflex reads.
        from autodist_tpu_torch.telemetry import memplane as _memplane
        snap["memory"] = _memplane.memory_snapshot()
        return snap

    def _wait(self, req, timeout) -> tuple:
        """Park this handler thread (bounded) until the batcher completes the
        request, then build the reply."""
        limit = self._batcher.config.request_timeout_s
        if timeout is not None:
            limit = min(float(timeout), limit)
        if not req.done.wait(timeout=min(limit, MAX_WAIT_S)):
            # Nobody will read this result: tell the batcher to drop the
            # request at its next scheduling round instead of decoding a
            # full generation into the void.
            req.abandon()
            return ("error", "ServeTimeout",
                    f"request {req.rid} did not complete within {limit:.1f}s")
        if req.error is not None:
            return ("error", "ServeError", req.error)
        if self._batcher.kind == "lm":
            return ("ok", np.asarray(req.tokens, np.int32), req.timing())
        return ("ok", req.output, req.timing())

    def _dispatch(self, msg, sp=None):
        # A peer can legally encode a bare dict/int/None; reject it as a
        # protocol error instead of raising outside the per-op try.
        if not isinstance(msg, tuple) or not msg \
                or not isinstance(msg[0], str):
            return ("error", "ServeError",
                    f"malformed protocol message: expected (op, ...) tuple, "
                    f"got {type(msg).__name__}")
        op = msg[0]
        try:
            if op == "generate":
                if self._batcher.kind != "lm":
                    raise ServeError("this server hosts a stateless apply "
                                     "batcher; use the 'infer' op")
                # Optional trailing elements: the router's replay-dedup
                # token, optionally extended into the full trace context
                # ``(rid, send_wall_ns, hop, offset_ns)`` when the request
                # plane is armed. Plain clients send the 5-tuple; arity
                # stays backward compatible either way.
                _, prompt, max_new, seed, timeout, *rest = msg
                rid_token = str(rest[0]) if rest else None
                wire_s = 0.0
                if len(rest) >= 4 and _reqtrace.enabled():
                    # Wire-vs-queue decomposition: the router stamped its
                    # send wall-ns and its estimate of OUR clock minus its
                    # own (ntp_offset over ping round-trips), so
                    # now - send - offset is time spent on the wire, not
                    # in our queue. Clamped: a noisy offset estimate must
                    # never produce negative wire time.
                    send_wall, hop, offset = (int(rest[1]), int(rest[2]),
                                              int(rest[3]))
                    wire_ns = max(0, time.time_ns() - send_wall - offset)
                    wire_s = wire_ns / 1e9
                    _reqtrace.mark(rid_token, "received", hop=hop,
                                   wire_ns=wire_ns)
                if rid_token is not None:
                    with self._dedup_lock:
                        cached = self._dedup.get(rid_token)
                    if cached is not None:
                        return cached
                req = self._batcher.submit(host_tree(prompt), max_new, seed=int(seed),
                                           rid_token=rid_token,
                                           wire_s=wire_s)
                if sp is not None:
                    # Both ids ride the span: the local rid joins the
                    # prefill/decode spans, the fleet-scope token joins
                    # the router's records and the reqtrace plane.
                    sp.set(rid=req.rid)
                    if rid_token is not None:
                        sp.set(rid_token=rid_token)
                reply = self._wait(req, timeout)
                if rid_token is not None and reply[0] == "ok":
                    with self._dedup_lock:
                        self._dedup[rid_token] = reply
                        while len(self._dedup) > DEDUP_KEEP:
                            self._dedup.popitem(last=False)
                return reply
            if op == "infer":
                if self._batcher.kind != "apply":
                    raise ServeError("this server hosts an LM batcher; use "
                                     "the 'generate' op")
                _, example, timeout = msg
                req = self._batcher.submit(host_tree(example))
                if sp is not None:
                    sp.set(rid=req.rid)
                return self._wait(req, timeout)
            if op == "stats":
                return ("ok", self.stats_snapshot())
            if op == "status":
                # Live-ops console plane (tools/adtop.py): stats plus the
                # in-flight request table.
                return ("ok", self.status_snapshot())
            if op == "trace":
                # Span-ring pull (same columnar blob as the PS wire's arm)
                # so tools/adtrace.py merges replica spans into the fleet
                # timeline without a PS transport up.
                since = msg[1] if len(msg) > 1 else None
                return ("ok", telemetry.local_trace_state(since_ns=since))
            if op == "reqtrace":
                # Request-lifecycle pull: this process's reqtrace ring as
                # a columnar blob (rebased + merged by telemetry.cluster).
                since = msg[1] if len(msg) > 1 else None
                return ("ok",
                        telemetry.local_reqtrace_state(since_ns=since))
            if op == "ping":
                return ("ok", msg[1] if len(msg) > 1 else None,
                        time.time_ns())
            return ("error", "ServeError", f"unknown op {op!r}")
        except Exception as e:  # ship the failure to the client, keep serving
            return ("error", type(e).__name__, str(e))

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._batcher.close()
        if self.wire.msgs_received:
            logging.info("InferenceServer closed: %s | up %.1fs",
                         self.wire.format_line(),
                         time.monotonic() - self._t_started)

    def kill(self):
        """Simulate abrupt process death (fault injection — the router's
        kill-a-replica path and ``testing/faults`` ``worker_crash``): stop
        accepting, SEVER every live connection mid-reply, stop the batcher.
        Clients observe connection resets — exactly what a killed replica
        process produces — and the router replays their in-flight requests
        on a surviving replica (rid dedup makes the replay idempotent)."""
        self._server.shutdown()
        self._server.server_close()
        for s in list(self._conns):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        # Drain-and-fail is harmless here: the severed sockets mean nobody
        # reads these replies; it just stops the scheduler thread.
        self._batcher.close()


class ServeClient:
    """A client handle onto an :class:`InferenceServer`.

    One in-flight request per client (the underlying connection pairs one
    request with one reply); concurrency = one client per thread, each its
    own connection — the loopback examples and ``chip_smoke.py`` do exactly
    that."""

    def __init__(self, address=None, connect_timeout: float = 60.0):
        if address is None:
            address = _env_address()   # the AUTODIST_SERVE_ADDR default
        self._client = _PSClient(address, connect_timeout=connect_timeout)

    @property
    def wire(self) -> WireCounters:
        return self._client.wire

    def generate(self, prompt, max_new_tokens: int, seed: int = 0,
                 timeout: Optional[float] = None):
        """``prompt`` (1-D int array-like) -> ``(tokens int32[T], timing)``
        where timing is the server's ``{queue,prefill,decode,total}_s``
        breakdown. Raises :class:`ServeBusy` on an overload rejection
        (retryable — the queue or page pool is full right now) and
        :class:`ServeError` on any other rejection."""
        prompt = np.ascontiguousarray(np.asarray(prompt, np.int32))
        try:
            tokens, timing = self._client.call(
                "generate", prompt, int(max_new_tokens), int(seed), timeout)
        except PSClientError as e:
            # The wire ships ("error", type-name, detail); re-type the
            # busy rejection so callers (the router's shed cascade) can
            # branch on it without string matching.
            if str(e).startswith("ServeBusy:"):
                raise ServeBusy(str(e)) from None
            raise ServeError(str(e)) from None
        return host_tree(tokens), timing

    def infer(self, example, timeout: Optional[float] = None):
        """One stateless-apply request: ``example`` (pytree of ndarrays,
        no batch dim) -> ``(output, timing)``."""
        try:
            output, timing = self._client.call("infer", example, timeout)
        except PSClientError as e:
            raise ServeError(str(e)) from None
        return host_tree(output), timing

    def stats(self) -> dict:
        return self._client.call("stats")[0]

    def status(self) -> dict:
        """The server's live-ops status (:meth:`InferenceServer.
        status_snapshot`): SLO registry + queue depth + in-flight request
        ids — what ``tools/adtop.py`` renders."""
        return self._client.call("status")[0]

    def ping(self) -> float:
        """Round-trip seconds to the server (health check)."""
        t0 = time.perf_counter()
        self._client.call("ping", time.time_ns())
        return time.perf_counter() - t0

    def close(self):
        self._client.close()
