"""graftsan: the runtime half of the concurrency plane.

graftlint's static checks (GL001/GL002/GL005, whole-program since the
interprocedural lift) reason about lock orderings they can *prove* from
source; they cannot see orderings that only materialize through dynamic
dispatch, fault-injected paths, or the threads a test actually spawns. This
module closes that blind spot the standard sanitizer way: observe the real
execution, check it online, and export what was seen so the static model can
be cross-checked (``graftlint --crosscheck``).

Arming (``AUTODIST_SANITIZE``, comma-set — read once at import through the
typed ``const.ENV`` registry):

``locks``
    Every primitive built through the :func:`san_lock` / :func:`san_rlock` /
    :func:`san_condition` factories feeds a process-global lock-order graph
    keyed by creation site ``(relpath, assigned name, owning class)`` — the
    same identity GL002 derives statically, so the two graphs merge. Each
    thread keeps its acquisition stack; acquiring B while holding A adds the
    edge A→B *before* blocking on B, and an edge that closes a cycle raises
    :class:`SanViolation` immediately with BOTH full stacks (this thread's,
    and the recorded stack of the first thread that took the reverse order)
    — a dynamic ABBA aborts the test instead of deadlocking it. Recursive
    acquire of a non-reentrant lock (self-deadlock) is caught the same way.
``waits``
    GL005's runtime twin: ``Condition.wait()`` / ``Event.wait()`` without a
    timeout is a violation (the static check only sees literal call sites —
    this one sees every call, through any number of wrappers), as is
    entering any wait while holding a *different* sanitized lock (the
    lost-wakeup/convoy shape). ``Queue``-style waits are covered wherever
    the queue's internal Condition came from :func:`san_condition` (the
    input-plane ``BoundedQueue`` does).
``threads``
    A pytest fixture fence (:func:`thread_fence`, installed autouse in
    ``tests/conftest.py``): a test that leaks a live non-daemon thread past
    teardown fails with the leaked threads' names and current stacks — the
    leak class GL010 catches for closeables, extended to threads.

Disarmed (the default), the factories return **bare threading primitives**:
the hot-path cost of adoption is one module-global set check at *creation*
time and exactly zero per acquire/release. Product modules therefore adopt
the factories unconditionally.

Export: the observed edge set lands in
``.graftlint_cache/torch/observed_locks.jsonl`` (one JSON object per edge, plus a
``meta`` header line) at process exit when ``locks`` is armed, or on demand
via :func:`dump_observed`. ``python -m autodist_tpu_torch.tools.graftlint
--crosscheck`` merges these
edges into GL002's static graph: cycles the static analysis could not reach
become findings, and static edges never observed are reported as
unexercised (coverage for the lock model itself).

Import discipline: this module imports only the stdlib and ``const`` at
module level (it is imported by the lowest-level lock owners — telemetry,
data, parallel — so it must sit below all of them); telemetry metric
booking (``san.violations`` counter, ``san.locks_tracked`` gauge) is lazy
and best-effort. Internal state is guarded by a *bare* lock — the
sanitizer does not sanitize itself.
"""

import atexit
import contextlib
import json
import linecache
import os
import re
import sys
import threading
import time
import traceback

from autodist_tpu_torch import const

__all__ = [
    "SanViolation", "san_lock", "san_rlock", "san_condition", "san_event",
    "modes", "arm", "armed", "reset", "violations", "observed_edges",
    "dump_observed", "thread_fence", "OBSERVED_BASENAME",
]

# Repo root (…/autodist_tpu_torch/testing/sanitizer.py → three dirnames up): keys
# are repo-relative so they line up with graftlint's Module.relpath identity.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OBSERVED_BASENAME = "observed_locks.jsonl"

_ASSIGN_RE = re.compile(r"\s*([A-Za-z_][\w.]*)\s*(?::[^=]+)?=")


class SanViolation(AssertionError):
    """A concurrency-sanitizer finding: lock-order cycle, unbounded or
    lock-holding wait, or a leaked non-daemon thread. Subclasses
    AssertionError so an armed test run fails loudly under plain pytest."""


def _parse(spec) -> frozenset:
    return frozenset(m.strip() for m in str(spec or "").split(",") if m.strip())


_MODES = _parse(const.ENV.AUTODIST_SANITIZE.val)

# ---------------------------------------------------------------- state
# All bare primitives: the sanitizer's own state is not sanitized.
_STATE_LOCK = threading.Lock()
_EDGES = {}        # (outer_key, inner_key) -> {count, thread, outer_stack, inner_stack}
_ADJ = {}          # outer_key -> set(inner_key)
_KEYS = set()      # every site key ever registered
_VIOLATIONS = []   # [{kind, message}] — grows on every violation raised
_TLS = threading.local()


def _held():
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []   # entries: [obj_id, key, count, stack_str]
    return st


def modes() -> frozenset:
    """The armed mode set (empty when disarmed)."""
    return _MODES


def arm(spec) -> str:
    """Set the armed modes from a comma-spec (tests; production arms via the
    ``AUTODIST_SANITIZE`` env flag before import). Returns the previous spec
    so callers can restore it. Already-built primitives keep the armed-ness
    they were created with."""
    global _MODES
    prev = ",".join(sorted(_MODES))
    _MODES = _parse(spec)
    return prev


@contextlib.contextmanager
def armed(spec):
    """Context manager: arm ``spec`` for the body, then restore the previous
    modes and clear the sanitizer's graph/violation state."""
    prev = arm(spec)
    try:
        yield
    finally:
        arm(prev)
        reset()


def reset():
    """Drop the lock-order graph, key registry and violation log (test
    isolation). Primitives already built stay usable; their next acquire
    re-registers their edges."""
    with _STATE_LOCK:
        _EDGES.clear()
        _ADJ.clear()
        _KEYS.clear()
        del _VIOLATIONS[:]


def violations():
    """Snapshot of every violation raised so far in this process."""
    with _STATE_LOCK:
        return list(_VIOLATIONS)


# ------------------------------------------------------------- violations

@contextlib.contextmanager
def _bypass():
    """Mark this thread as inside the sanitizer's own plumbing: wrapped
    primitives it touches (telemetry instrument locks book metrics through
    san_lock too) pass straight through, untracked. Without this, booking
    `san.locks_tracked` while the creating thread holds the telemetry
    registry's own sanitized lock is a REAL recursive acquire — the
    sanitizer deadlocking itself trying to report on itself."""
    prev = getattr(_TLS, "bypass", False)
    _TLS.bypass = True
    try:
        yield
    finally:
        _TLS.bypass = prev


def _bypassed() -> bool:
    return getattr(_TLS, "bypass", False)


def _violate(kind: str, message: str):
    with _STATE_LOCK:
        _VIOLATIONS.append({"kind": kind, "message": message})
    try:  # metric booking is best-effort: telemetry must never mask the raise
        from autodist_tpu_torch.telemetry import metrics as _metrics
        with _bypass():
            _metrics.counter("san.violations").inc()
    except Exception:
        pass
    raise SanViolation(f"graftsan[{kind}]: {message}")


def _register_key(key):
    # No telemetry here: creation often happens under the creator's own
    # locks (a Registry building an instrument), and booking a gauge takes
    # sanitized locks of its own. The gauge is set at export time instead.
    with _STATE_LOCK:
        _KEYS.add(key)


def _site_key(explicit_name, depth=2):
    """Identity of the primitive being created: (repo-relative path of the
    creating module, assigned name parsed from the creation line, owning
    class when created inside a method). Matches the (relpath, name)
    identity GL002 gives the same lock statically; the class qualifier
    disambiguates same-named ``self._lock`` attrs within a module."""
    f = sys._getframe(depth)
    path = f.f_code.co_filename
    rel = os.path.basename(path)
    try:
        cand = os.path.relpath(path, _ROOT)
        if not cand.startswith(".."):
            rel = cand.replace(os.sep, "/")
    except ValueError:
        pass
    slf = f.f_locals.get("self")
    cls = type(slf).__name__ if slf is not None else ""
    name = explicit_name
    if not name:
        m = _ASSIGN_RE.match(linecache.getline(path, f.f_lineno) or "")
        name = m.group(1) if m else f"<{rel}:{f.f_lineno}>"
    key = (rel, name, cls)
    _register_key(key)
    return key


def _acq_stack():
    # Two internal frames (format_stack caller + wrapper method) trimmed.
    return "".join(traceback.format_stack(sys._getframe(2)))


def _find_path(src, dst):
    """DFS src→dst over the edge graph; returns the key path or None."""
    stack, seen = [(src, (src,))], {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _ADJ.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + (nxt,)))
    return None


def _key_str(key):
    rel, name, cls = key
    return f"{rel}:{cls + '.' if cls else ''}{name}"


def _note_acquire(obj_id, key, reentrant, stack, hard=True):
    """Pre-acquire bookkeeping: record edges from every held lock to this
    one, detect order cycles BEFORE blocking (a would-be deadlock raises
    instead of hanging), then push the held entry on success (the caller
    pushes after the real acquire). ``hard`` is False for try-acquires and
    timeout acquires — those cannot self-deadlock (they return), so only
    the order edges are recorded for them."""
    if _bypassed():
        return None
    st = _held()
    for ent in st:
        if ent[0] == obj_id:
            if not reentrant and hard:
                _violate(
                    "locks",
                    f"recursive acquire of non-reentrant lock "
                    f"{_key_str(key)} (self-deadlock)\n"
                    f"--- first acquired at ---\n{ent[3]}"
                    f"--- re-acquired at ---\n{stack}")
            ent[2] += 1
            return None
    cycle_msg = None
    with _STATE_LOCK:
        for ent in st:
            okey = ent[1]
            if okey == key:
                continue  # sibling from the same creation site (lock arrays)
            edge = _EDGES.get((okey, key))
            if edge is not None:
                edge["count"] += 1
                continue
            path = _find_path(key, okey) if "locks" in _MODES else None
            _EDGES[(okey, key)] = {
                "count": 1,
                "thread": threading.current_thread().name,
                "outer_stack": ent[3],
                "inner_stack": stack,
            }
            _ADJ.setdefault(okey, set()).add(key)
            if path is not None and cycle_msg is None:
                rev = _EDGES.get((path[0], path[1]))
                cycle_msg = (
                    f"lock-order cycle: acquiring {_key_str(key)} while "
                    f"holding {_key_str(okey)}, but the reverse order "
                    f"{' -> '.join(_key_str(k) for k in path)} was already "
                    f"observed"
                    + (f" on thread '{rev['thread']}'" if rev else "") + "\n"
                    f"--- this thread: {_key_str(okey)} acquired at ---\n"
                    f"{ent[3]}"
                    f"--- this thread: {_key_str(key)} being acquired at ---\n"
                    f"{stack}"
                    + (f"--- other thread: {_key_str(path[0])} held at ---\n"
                       f"{rev['outer_stack']}"
                       f"--- other thread: {_key_str(path[1])} acquired at "
                       f"---\n{rev['inner_stack']}" if rev else ""))
    if cycle_msg is not None:
        _violate("locks", cycle_msg)
    return [obj_id, key, 1, stack]


def _push_entry(entry):
    if entry is not None:
        _held().append(entry)


def _note_release(obj_id):
    if _bypassed():
        return
    st = _held()
    for i in range(len(st) - 1, -1, -1):
        if st[i][0] == obj_id:
            st[i][2] -= 1
            if st[i][2] <= 0:
                del st[i]
            return
    # Acquired before arming, or released by another thread: not an error.


def _pop_entry(obj_id):
    st = _held()
    for i in range(len(st) - 1, -1, -1):
        if st[i][0] == obj_id:
            return st.pop(i)
    return None


def _check_wait_holding(obj_id, what):
    if _bypassed():
        return
    for ent in _held():
        if ent[0] != obj_id:
            _violate(
                "waits",
                f"{what} entered while holding sanitized lock "
                f"{_key_str(ent[1])} (acquired at)\n{ent[3]}")


# -------------------------------------------------------------- wrappers

class _SanLockBase:
    """Shared acquire/release/context plumbing over a real primitive."""

    _reentrant = False

    def __init__(self, inner, key):
        self._inner = inner
        self.key = key

    def acquire(self, blocking=True, timeout=-1):
        entry = _note_acquire(id(self), self.key, self._reentrant,
                              _acq_stack(),
                              hard=blocking and (timeout is None
                                                 or timeout < 0))
        got = self._inner.acquire(blocking, timeout)
        if got:
            _push_entry(entry)
        elif entry is None:
            # a held lock's count was bumped optimistically (entry None =
            # already on the stack, or bypassed — release no-ops there);
            # a failed try/timeout acquire must undo it
            _note_release(id(self))
        return got

    def release(self):
        _note_release(id(self))
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __repr__(self):
        return f"<{type(self).__name__} {_key_str(self.key)} {self._inner!r}>"


class _SanLock(_SanLockBase):
    pass


class _SanRLock(_SanLockBase):
    _reentrant = True

    def locked(self):  # RLock has no locked() before 3.12; mirror _is_owned
        return self._inner._is_owned()


class _SanCondition(_SanLockBase):
    """Condition wrapper: the condition IS its lock for ordering purposes
    (acquiring the condition acquires the underlying mutex); ``wait``
    temporarily retires the held entry — the real wait releases the mutex —
    and the ``waits`` mode checks fire before blocking."""

    def __init__(self, inner, key):
        super().__init__(inner, key)

    def _pre_wait(self, timeout, what):
        if "waits" in _MODES:
            if timeout is None:
                _violate("waits",
                         f"{what} on {_key_str(self.key)} without a timeout "
                         f"(unbounded wait)\n{_acq_stack()}")
            _check_wait_holding(id(self), f"{what} on {_key_str(self.key)}")

    def wait(self, timeout=None):
        self._pre_wait(timeout, "Condition.wait")
        entry = _pop_entry(id(self))
        try:
            return self._inner.wait(timeout)
        finally:
            _push_entry(entry)

    def wait_for(self, predicate, timeout=None):
        self._pre_wait(timeout, "Condition.wait_for")
        entry = _pop_entry(id(self))
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            _push_entry(entry)

    def notify(self, n=1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()

    def locked(self):
        raise AttributeError("Condition has no locked()")


class _SanEvent:
    """Event wrapper: only the ``waits`` checks — events carry no mutual
    exclusion, so they never enter the lock-order graph."""

    def __init__(self, inner, key):
        self._inner = inner
        self.key = key

    def wait(self, timeout=None):
        if "waits" in _MODES:
            if timeout is None:
                _violate("waits",
                         f"Event.wait on {_key_str(self.key)} without a "
                         f"timeout (unbounded wait)\n{_acq_stack()}")
            _check_wait_holding(None, f"Event.wait on {_key_str(self.key)}")
        return self._inner.wait(timeout)

    def set(self):
        self._inner.set()

    def clear(self):
        self._inner.clear()

    def is_set(self):
        return self._inner.is_set()

    def __repr__(self):
        return f"<_SanEvent {_key_str(self.key)} {self._inner!r}>"


def _tracking() -> bool:
    return bool(_MODES & {"locks", "waits"})


# -------------------------------------------------------------- factories

def san_lock(name=None):
    """``threading.Lock()`` — wrapped for order/wait tracking when armed,
    the bare primitive otherwise."""
    if not _tracking():
        return threading.Lock()
    return _SanLock(threading.Lock(), _site_key(name))


def san_rlock(name=None):
    """``threading.RLock()`` with the same arming contract."""
    if not _tracking():
        return threading.RLock()
    return _SanRLock(threading.RLock(), _site_key(name))


def san_condition(lock=None, name=None):
    """``threading.Condition(lock)``. A sanitized lock argument is unwrapped
    for the real condition and lends the condition its identity (they are
    the same mutex)."""
    if not _tracking():
        if isinstance(lock, _SanLockBase):
            lock = lock._inner
        return threading.Condition(lock)
    if isinstance(lock, _SanLockBase):
        return _SanCondition(threading.Condition(lock._inner), lock.key)
    return _SanCondition(threading.Condition(lock), _site_key(name))


def san_event(name=None):
    """``threading.Event()``; wrapped only for the ``waits`` checks."""
    if "waits" not in _MODES:
        return threading.Event()
    return _SanEvent(threading.Event(), _site_key(name))


# ----------------------------------------------------------- thread fence

@contextlib.contextmanager
def thread_fence(grace_s=1.0):
    """Fail the body if it leaks a live NON-DAEMON thread: snapshot the
    thread set, run the body, allow a short grace for orderly teardown,
    then raise :class:`SanViolation` naming every survivor with its current
    stack. Installed autouse per-test by ``tests/conftest.py`` when the
    ``threads`` mode is armed."""
    before = {t.ident for t in threading.enumerate()}
    yield
    deadline = time.monotonic() + grace_s
    while True:
        leaked = [t for t in threading.enumerate()
                  if t.is_alive() and not t.daemon
                  and t.ident not in before
                  and t is not threading.current_thread()]
        if not leaked or time.monotonic() >= deadline:
            break
        time.sleep(0.02)
    if leaked:
        frames = sys._current_frames()
        lines = []
        for t in leaked:
            lines.append(f"  leaked non-daemon thread '{t.name}' "
                         f"(ident={t.ident}), currently at:")
            frame = frames.get(t.ident)
            lines.append("".join(traceback.format_stack(frame)) if frame
                         else "    <no frame: thread exiting>\n")
        _violate("threads",
                 "test leaked %d non-daemon thread(s) past teardown:\n%s"
                 % (len(leaked), "".join(lines)))


# ----------------------------------------------------------------- export

def observed_edges():
    """The lock-order edges observed so far, as JSON-ready records — the
    same shape :func:`dump_observed` writes and ``--crosscheck`` reads."""
    def as_obj(key):
        return {"path": key[0], "name": key[1], "cls": key[2]}
    with _STATE_LOCK:
        return [{"outer": as_obj(o), "inner": as_obj(i), "count": e["count"]}
                for (o, i), e in sorted(_EDGES.items())]


def dump_observed(path=None):
    """Append the observed edge set (plus a ``meta`` header line, so the
    artifact is non-empty even for an edge-free run) to
    ``<cwd>/.graftlint_cache/torch/observed_locks.jsonl`` (the port's
    graftlint's ``--observed`` default, apart from the JAX package's) or
    ``path``. Registered
    atexit when ``locks`` is armed; idempotent and safe to call directly."""
    if path is None:
        path = os.path.join(os.getcwd(), ".graftlint_cache", "torch", OBSERVED_BASENAME)
    edges = observed_edges()
    with _STATE_LOCK:
        meta = {"meta": {"modes": sorted(_MODES), "locks_tracked": len(_KEYS),
                         "edges": len(edges),
                         "violations": len(_VIOLATIONS)}}
    try:  # gauge booked at export time, never at creation time: creation
        # often runs under the creator's own (sanitized) locks
        from autodist_tpu_torch.telemetry import metrics as _metrics
        with _bypass():
            _metrics.gauge("san.locks_tracked").set(
                meta["meta"]["locks_tracked"])
    except Exception:
        pass
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(meta) + "\n")
            for rec in edges:
                fh.write(json.dumps(rec) + "\n")
    except OSError:
        return None  # read-only checkout: a lost artifact, not a crash
    return path


if "locks" in _MODES:  # production arming is env-driven and import-time
    atexit.register(dump_observed)
