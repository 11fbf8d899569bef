"""Fleet router: one front door over N ``InferenceServer`` replicas (the
port of ``autodist_tpu/serving/router.py``).

Composes three planes that already exist into fleet throughput: the serving
wire (``serving/transport.py``), the alert engine's ``serve_p99_burn``
burn-rate rule (``telemetry/alerts.py``), and the recovery machinery
(``parallel/recovery.py`` + the chief's respawn policy, promoted to
:class:`~autodist_tpu_torch.coordinator.RespawnPolicy`). Policy:

- LEAST-LOADED routing: requests go to the live replica with the fewest
  router-tracked in-flight requests (the queue-slot signals ``status``
  exposes ride along in ``last_status`` for consoles).
- SHED AT ADMISSION: a replica's ``ServeBusy`` (BoundedQueue ``try_put``
  reject, or a full page pool) cascades to the next replica; when every
  replica is busy the router replies with a typed ``ServeBusy`` instantly —
  tail latency is protected by refusing work, never by queueing it.
- ROUTE AROUND DEATH: a connection failure marks the replica down, books an
  eviction, and REPLAYS the in-flight request on a surviving replica with
  the SAME request-id token — the replica-side rid dedup
  (``transport.py``) makes the replay idempotent (the ``generate`` op is
  never wire-retried; replay happens here, made safe).
  A dead replica is respawned through the budgeted
  :class:`~autodist_tpu_torch.coordinator.RespawnPolicy`.
- AUTOSCALE OFF ALERTS: the supervisor polls each replica's ``status``; a
  replica whose ``serve_p99_burn`` alert is ACTIVE is drained (no new
  routes, in-flight completes) and a fresh replica is spawned on the same
  respawn budget; when the alert clears the drained replica rejoins.

``Router`` is the embeddable policy object (tests drive ``poll_once()``
deterministically); ``RouterServer`` puts it on the serving wire — plain
``ServeClient`` works unchanged against it, so a fleet is a config change,
not a client change.
"""

import itertools
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from autodist_tpu_torch import telemetry
from autodist_tpu_torch.telemetry import cluster as _cluster
from autodist_tpu_torch.telemetry import reqtrace as _reqtrace
from autodist_tpu_torch.coordinator import RespawnPolicy
from autodist_tpu_torch.parallel import recovery as _recovery
from autodist_tpu_torch.parallel.ps_transport import _PSClient, PSClientError
from autodist_tpu_torch.serving.batcher import ServeBusy, ServeError
from autodist_tpu_torch.serving.transport import SHUTDOWN_POLL_S, _wire_server, host_tree
from autodist_tpu_torch.testing import faults as _faults
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.metrics import WireCounters
from autodist_tpu_torch.testing.sanitizer import san_lock, san_event

# The burn-rate alert that triggers drain + scale-out (telemetry/alerts.py
# DEFAULT_RULES ships it over serve.latency_s.total).
DRAIN_ALERT = "serve_p99_burn"
# Bound on connection-failure replays for ONE request: every retry marks a
# replica down first, so more retries than replicas + respawn budget means
# the fleet is gone, not unlucky.
MAX_REPLAYS = 8


class Replica:
    """Router-side handle on one ``InferenceServer``: the owned server (or
    just an address for external replicas), a small idle-client pool, and
    the routing state (in-flight count, down/draining flags)."""

    def __init__(self, server=None, address: Optional[Tuple[str, int]] = None,
                 generation: int = 0):
        assert server is not None or address is not None
        self.server = server
        self.address = tuple(server.address if server is not None
                             else address)
        self.name = "%s:%d" % self.address
        self.generation = generation
        # Routing state below is written by request threads (in_flight) and
        # the supervisor (down/draining/last_status) while pickers and
        # snapshots read it — every access goes through _lock via the
        # accessors; name/generation/address are immutable after __init__.
        self.in_flight = 0
        self.down = False
        self.draining = False
        self.last_status: dict = {}
        self._lock = san_lock()
        self._idle: List[_PSClient] = []
        self._offset_ns: Optional[int] = None

    # ------------------------------------------------- routing-state access

    def routable(self) -> bool:
        with self._lock:
            return not self.down and not self.draining

    def load(self) -> int:
        with self._lock:
            return self.in_flight

    def is_down(self) -> bool:
        with self._lock:
            return self.down

    def mark_down(self) -> bool:
        """Set ``down``; True exactly once (the caller that books the
        eviction and respawns)."""
        with self._lock:
            if self.down:
                return False
            self.down = True
            return True

    def begin_drain(self) -> bool:
        """Set ``draining``; True exactly once per drain episode."""
        with self._lock:
            if self.draining:
                return False
            self.draining = True
            return True

    def end_drain(self) -> bool:
        """Clear ``draining``; True if this call cleared it."""
        with self._lock:
            if not self.draining:
                return False
            self.draining = False
            return True

    def note_status(self, st: dict):
        with self._lock:
            self.last_status = st

    def snapshot(self) -> dict:
        """One consistent read of the routing state (status-console row)."""
        with self._lock:
            st = self.last_status or {}
            return {"replica": self.name,
                    "generation": self.generation,
                    "in_flight": self.in_flight,
                    "down": self.down,
                    "draining": self.draining,
                    "queue_depth": st.get("queue_depth", 0),
                    "capacity": st.get("capacity", 0)}

    def clock_offset_ns(self) -> int:
        """Replica-minus-router wall-clock offset, NTP-estimated from three
        ``ping`` round-trips (:func:`telemetry.cluster.ntp_offset`) and cached for
        the replica's lifetime — the router stamps it into each forwarded
        trace token so the replica can subtract its OWN clock from the
        router's send stamp (wire-vs-queue decomposition). An unreachable
        replica estimates 0 (the route itself will fail and replay); the
        loopback test fleets share one clock, so 0 is also exact there."""
        with self._lock:
            if self._offset_ns is not None:
                return self._offset_ns
        samples = []
        try:
            for _ in range(3):
                t0 = time.time_ns()
                _, s_ns = self.call("ping", t0)
                samples.append((t0, int(s_ns), time.time_ns()))
            off, _err = _cluster.ntp_offset(samples)
        except Exception:
            off = 0
        with self._lock:
            if self._offset_ns is None:
                self._offset_ns = int(off)
            return self._offset_ns

    def call(self, op: str, *args):
        """One wire call on a pooled connection. A ``PSClientError`` is a
        SERVER-level reply over a healthy socket (the connection is
        recycled); transport-level failures discard the socket and
        propagate (the router's death signal)."""
        with self._lock:
            client = self._idle.pop() if self._idle else None
        if client is None:
            # Short connect budget: unlike a PS worker waiting out a chief
            # restart, a replica that refuses connections IS the failure
            # signal the router routes around — don't retry into it.
            client = _PSClient(self.address, connect_timeout=2.0)
        try:
            out = client.call(op, *args)
        except PSClientError:
            with self._lock:
                self._idle.append(client)
            raise
        except BaseException:
            try:
                client.close()
            except Exception:
                pass
            raise
        with self._lock:
            self._idle.append(client)
        return out

    def close(self):
        with self._lock:
            idle, self._idle = self._idle, []
        for client in idle:
            try:
                client.close()
            except Exception:
                pass
        if self.server is not None:
            self.server.close()


class Router:
    """The fleet policy object: spawn/track replicas, route, shed, replay,
    autoscale. ``replica_factory`` builds one fresh ``InferenceServer``
    (used for the initial fleet, dead-replica respawn, and alert-driven
    scale-out); pass ``addresses`` instead to front externally-managed
    replicas (no respawn possible — the supervisor only routes around
    them).

    ``start=False`` leaves the supervisor thread un-started; tests drive
    :meth:`poll_once` by hand for deterministic drain/respawn timing."""

    # Supervisor cadence + backoff (class attrs so tests tighten them,
    # mirroring Coordinator.RESPAWN_BACKOFF_S).
    POLL_S = 1.0
    RESPAWN_BACKOFF_S = 1.0
    RESPAWN_BACKOFF_CAP_S = 30.0

    def __init__(self, replica_factory: Optional[Callable] = None,
                 n_replicas: Optional[int] = None,
                 addresses: Optional[List[Tuple[str, int]]] = None,
                 max_replicas: Optional[int] = None,
                 start: bool = True):
        from autodist_tpu_torch import const
        if replica_factory is None and not addresses:
            raise ValueError("Router needs a replica_factory or addresses")
        n = n_replicas if n_replicas is not None \
            else int(const.ENV.AUTODIST_SERVE_REPLICAS.val)
        self._factory = replica_factory
        self._lock = san_lock()
        self._replicas: List[Replica] = []
        if addresses:
            self._replicas += [Replica(address=a) for a in addresses]
        if replica_factory is not None:
            self._replicas += [Replica(server=replica_factory())
                               for _ in range(max(0, n))]
        self.max_replicas = max_replicas if max_replicas is not None \
            else 2 * len(self._replicas)
        self._policy = RespawnPolicy(self.RESPAWN_BACKOFF_S,
                                     self.RESPAWN_BACKOFF_CAP_S)
        self._rseq = itertools.count()
        self._t_started = time.monotonic()
        reg = telemetry.registry()
        self._m_routed = reg.counter("serve.router.routed")
        self._m_shed = reg.counter("serve.router.shed")
        self._m_replayed = reg.counter("serve.router.replayed")
        self._stop = san_event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(target=self._supervise,
                                            daemon=True,
                                            name="serve-router-supervisor")
            self._thread.start()

    # --------------------------------------------------------------- routing

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas)

    def next_rid(self) -> str:
        """A fresh fleet-scope rid. ``RouterServer`` stamps one onto each
        request whose client sent no token, so every request through the
        front door is dedup-safe and traceable."""
        return f"router-{next(self._rseq)}"

    def _pick(self, tried: List[Replica]) -> Optional[Replica]:
        """Least-loaded live replica not yet tried for this request; ties
        break by fleet order (deterministic). Advisory: state may move
        between the locked reads and the route, and the shed/replay cascade
        absorbs that."""
        cands = [r for r in self.replicas()
                 if r not in tried and r.routable()]
        if not cands:
            return None
        return min(cands, key=lambda r: r.load())

    def generate(self, prompt, max_new_tokens: int, seed: int = 0,
                 timeout: Optional[float] = None,
                 rid: Optional[str] = None):
        """Route one generation. The shed cascade tries every live replica
        on ``ServeBusy`` before rejecting; a connection failure mid-request
        marks the replica down and REPLAYS on a survivor with the same rid
        token (idempotent via the replica-side dedup)."""
        prompt = np.ascontiguousarray(np.asarray(prompt, np.int32))
        seq = next(self._rseq)
        rid = rid if rid is not None else f"router-{seq}"
        _reqtrace.mark(rid, "received", hop=0)
        tried: List[Replica] = []
        replays = 0
        while True:
            rep = self._pick(tried)
            if rep is None:
                self._m_shed.inc()
                _reqtrace.mark(rid, "shed", reason="fleet_busy")
                raise ServeBusy("all replicas are at capacity or "
                                "unavailable; retry later")
            tried.append(rep)
            # Deterministic fault injection (testing/faults.py): a matching
            # worker_crash spec hard-kills this replica NOW — the severed
            # connections exercise the exact replay path a real process
            # death produces.
            if rep.server is not None and _faults.should_fire(
                    "worker_crash", step=seq, worker=rep.name):
                rep.server.kill()
            with rep._lock:
                rep.in_flight += 1
            # Trace context rides the wire only when the request plane is
            # armed: ``(rid, send_wall_ns, hop, offset_ns)`` trailing the
            # plain 5-tuple. hop counts replays, so a replayed request
            # renders as ONE trace with a visible failover; offset_ns is
            # this replica's clock minus ours, so the replica can split
            # wire time out of its queue time.
            if _reqtrace.enabled():
                send_wall = time.time_ns()
                _reqtrace.mark(rid, "sent", replica=rep.name, hop=replays,
                               send_wall_ns=send_wall)
                extra = (rid, send_wall, replays, rep.clock_offset_ns())
            else:
                extra = (rid,)
            try:
                tokens, timing = rep.call(
                    "generate", prompt, int(max_new_tokens), int(seed),
                    timeout, *extra)
            except PSClientError as e:
                if str(e).startswith("ServeBusy:"):
                    continue          # shed cascade: next replica
                # Any other server-shipped error is deterministic — the
                # reply to this client, not a reason to retry elsewhere.
                raise ServeError(str(e)) from None
            except (ConnectionError, OSError):
                # The replica died with this request in flight: route
                # around it and re-admit elsewhere (same rid = idempotent).
                self._on_replica_failure(rep)
                self._m_replayed.inc()
                replays += 1
                _reqtrace.mark(rid, "replayed", replica=rep.name,
                               hop=replays)
                if replays >= MAX_REPLAYS:
                    raise ServeError(
                        f"request {rid} lost {replays} replicas; fleet "
                        f"unavailable") from None
                tried = []   # busy replicas may have drained; retry them
                continue
            finally:
                with rep._lock:
                    rep.in_flight -= 1
            self._m_routed.inc()
            _reqtrace.mark(rid, "finished", replica=rep.name)
            return host_tree(tokens), timing

    # ------------------------------------------------- failure + autoscaling

    def _on_replica_failure(self, rep: Replica):
        """Mark ``rep`` down exactly once, book the eviction, respawn a
        replacement through the budgeted policy."""
        if not rep.mark_down():
            return
        logging.warning("router: replica %s is down; routing around it",
                        rep.name)
        _recovery.log_eviction(rep.name, kind="dead")
        self._respawn_replica(rep)

    def _respawn_replica(self, rep: Replica):
        if self._factory is None:
            return
        delay = self._policy.grant(rep.name)   # books recovery.log_respawn
        if delay is None:
            logging.error("router: respawn budget for %s is spent "
                          "(AUTODIST_RECOVER_MAX); replica stays down",
                          rep.name)
            return
        time.sleep(delay)                      # bounded: RESPAWN_BACKOFF_CAP_S
        try:
            new = Replica(server=self._factory(),
                          generation=rep.generation + 1)
            _recovery.log_rejoin(new.name, new.generation)
        except Exception as e:
            logging.error("router: respawn of %s failed (%s)", rep.name, e)
            return
        with self._lock:
            try:
                self._replicas[self._replicas.index(rep)] = new
            except ValueError:
                self._replicas.append(new)
        try:
            rep.close()
        except Exception:
            pass
        logging.info("router: replica %s respawned as %s (generation %d)",
                     rep.name, new.name, new.generation)

    def _scale_out(self, rep: Replica):
        """``serve_p99_burn`` fired on ``rep``: drain it (no new routes;
        in-flight completes) and spawn a fresh replica on the SAME respawn
        budget — fault recovery promoted to autoscaling."""
        if not rep.begin_drain():
            return
        logging.warning("router: replica %s draining (%s active)",
                        rep.name, DRAIN_ALERT)
        n_live = sum(not r.is_down() for r in self.replicas())
        if self._factory is None or n_live >= self.max_replicas:
            return
        delay = self._policy.grant(f"scaleout:{rep.name}")
        if delay is None:
            return
        time.sleep(delay)
        try:
            new = Replica(server=self._factory())
            _recovery.log_rejoin(new.name, new.generation)
        except Exception as e:
            logging.error("router: scale-out replica failed (%s)", e)
            return
        with self._lock:
            self._replicas.append(new)
        logging.info("router: scaled out to %s while %s drains",
                     new.name, rep.name)

    def poll_once(self):
        """One supervisor round: poll every replica's ``status``; a failed
        poll is a death (evict + respawn), an active ``serve_p99_burn``
        drains the replica + scales out, a cleared alert rejoins it."""
        for rep in self.replicas():
            if rep.is_down():
                continue
            try:
                st = rep.call("status")[0]
            except Exception:
                self._on_replica_failure(rep)
                continue
            rep.note_status(st)
            active = {a.get("rule")
                      for a in (st.get("alerts") or {}).get("active", [])}
            if DRAIN_ALERT in active:
                self._scale_out(rep)
            elif rep.end_drain():
                _recovery.log_rejoin(rep.name, rep.generation)
                logging.info("router: replica %s rejoined (alert cleared)",
                             rep.name)

    def _supervise(self):
        while not self._stop.wait(self.POLL_S):
            try:
                self.poll_once()
            except Exception as e:   # the supervisor must outlive one bad poll
                logging.warning("router supervisor: %s", e)

    # ---------------------------------------------------------------- status

    def fleet_snapshot(self) -> List[dict]:
        return [rep.snapshot() for rep in self.replicas()]

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        for rep in self.replicas():
            try:
                rep.close()
            except Exception:
                pass


class RouterServer:
    """The router on the serving wire: same opcode vocabulary as
    :class:`~autodist_tpu_torch.serving.transport.InferenceServer` (``generate``/
    ``stats``/``status``/``ping``), so a plain ``ServeClient`` fronts the
    whole fleet. Binds ``AUTODIST_ROUTER_ADDR`` when set, else loopback on
    an ephemeral port."""

    def __init__(self, router: Router, host: Optional[str] = None,
                 port: Optional[int] = None):
        from autodist_tpu_torch import const
        if host is None and port is None:
            addr = str(const.ENV.AUTODIST_ROUTER_ADDR.val)
            if addr:
                h, sep, p = addr.rpartition(":")
                host, port = (h, int(p)) if sep else (addr, 0)
        if host is None or port is None:
            env_host, env_port = ("127.0.0.1", 0)
            host = env_host if host is None else host
            port = env_port if port is None else port
        self._router = router
        self._t_started = time.monotonic()
        self.wire = WireCounters()
        self._conns: set = set()
        self._server = _wire_server(host, port, self)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        args=(SHUTDOWN_POLL_S,), daemon=True)
        self._thread.start()
        logging.info("RouterServer fronting %d replicas on %s:%d",
                     len(router.replicas()), *self._server.server_address)

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address

    def status_snapshot(self) -> dict:
        """Live-ops view (``kind="router"``): router counters + the
        per-replica fleet table + the shared alert/recovery sections, so
        adtop/adfleet render a router endpoint next to its replicas."""
        from autodist_tpu_torch.parallel import recovery as _rec
        from autodist_tpu_torch.telemetry import alerts as _alerts
        from autodist_tpu_torch.telemetry import memplane as _memplane
        return {"registry": telemetry.snapshot(),
                "wire": self.wire.snapshot(),
                "uptime_s": round(time.monotonic() - self._t_started, 3),
                "kind": "router",
                "replicas": self._router.fleet_snapshot(),
                "alerts": _alerts.alerts_snapshot(),
                "recovery": _rec.recovery_snapshot(),
                "memory": _memplane.memory_snapshot(),
                "events": telemetry.events()}

    def _dispatch(self, msg, sp=None):
        if not isinstance(msg, tuple) or not msg \
                or not isinstance(msg[0], str):
            return ("error", "ServeError",
                    f"malformed protocol message: expected (op, ...) tuple, "
                    f"got {type(msg).__name__}")
        op = msg[0]
        try:
            if op == "generate":
                # Same arity contract as the replica arm, trailing rid
                # included — a client-supplied dedup token is honored
                # end to end; absent one, the router mints the fleet-scope
                # rid HERE so the transport span carries it (span-ring and
                # reqtrace records join on this id).
                _, prompt, max_new, seed, timeout, *rest = msg
                rid = str(rest[0]) if rest else self._router.next_rid()
                if sp is not None:
                    sp.set(rid=rid)
                tokens, timing = self._router.generate(
                    prompt, int(max_new), seed=int(seed), timeout=timeout,
                    rid=rid)
                return ("ok", tokens, timing)
            if op == "stats":
                return ("ok", self.status_snapshot())
            if op == "status":
                return ("ok", self.status_snapshot())
            if op == "trace":
                # Span-ring pull: the router process's lane in the merged
                # fleet timeline (tools/adtrace.py).
                since = msg[1] if len(msg) > 1 else None
                return ("ok", telemetry.local_trace_state(since_ns=since))
            if op == "reqtrace":
                # Request-lifecycle pull: the router-side marks (received/
                # sent/replayed/shed/finished) for the fleet merge.
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
        self._router.close()
        if self.wire.msgs_received:
            logging.info("RouterServer closed: %s | up %.1fs",
                         self.wire.format_line(),
                         time.monotonic() - self._t_started)
