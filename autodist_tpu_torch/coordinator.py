"""Coordinator: the chief re-executes the user's script on every host (the
port's copy of ``autodist_tpu/coordinator.py``).

- ``launch_clients()`` ships the serialized strategy to each worker host, then
  runs the user's own command there (``python`` and ``sys.argv``, or ``python
  -m module`` and the arguments for a script run as a module), in a new
  process (``subprocess``, never ``fork``: a forked child cannot use CUDA),
  with the role env set (``AUTODIST_WORKER=<ip>``,
  ``AUTODIST_STRATEGY_ID=<id>``, reference ``:66-90``) and the bootstrap env
  (coordinator address, process count and id) that a synchronous run's
  ``torch.distributed`` group joins on.
- A watchdog thread per remote process reacts to any nonzero worker exit per
  the ``AUTODIST_WORKER_FAILURE`` policy: ``halt`` fail-fasts the chief
  (``os._exit(1)``, the reference's only behavior, ``:98-110``); ``respawn``
  relaunches the worker with bounded exponential backoff — machine loss is
  routine at pod scale, and a relaunched async-PS worker re-registers the
  staleness gate and catches up on the chief's live params with no checkpoint
  (``parallel/recovery.py``). Respawns are budgeted per worker
  (``AUTODIST_RECOVER_MAX``); an exhausted budget escalates to ``halt``.
"""

import logging
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.cluster import Cluster, is_local_address
from autodist_tpu_torch.parallel import recovery as _recovery

_log = logging.getLogger("autodist_tpu_torch")


def relaunch_command(argv: Optional[List[str]] = None) -> List[str]:
    """The command that re-executes this program: ``python -m module args``
    when it runs as a module (so the package resolves as it did here), else
    ``python argv``."""
    main = sys.modules.get("__main__")
    spec = getattr(main, "__spec__", None)
    if argv is None and spec is not None and spec.name:
        return [sys.executable, "-m", spec.name] + sys.argv[1:]
    return [sys.executable] + list(sys.argv if argv is None else argv)


class RespawnPolicy:
    """Budgeted, jittered-exponential-backoff respawn ledger, the chief's
    worker-failure reaction (:meth:`Coordinator._respawn`): at most
    ``AUTODIST_RECOVER_MAX`` granted attempts per key, each booked via
    ``recovery.log_respawn`` with its backoff delay."""

    def __init__(self, base_s: float = 1.0, cap_s: float = 30.0):
        self.base_s = base_s
        self.cap_s = cap_s
        self.attempts: Dict[str, int] = {}

    def budget(self) -> int:
        return _recovery.recover_max()

    def grant(self, key: str) -> Optional[float]:
        """One respawn attempt for ``key``: the backoff delay (seconds) the
        caller should wait before relaunching, booked in the recovery
        plane; ``None`` when the budget is spent (the caller escalates to
        halt)."""
        n = self.attempts.get(key, 0)
        if n >= self.budget():
            return None
        self.attempts[key] = n + 1
        delay = _recovery.backoff_s(n, self.base_s, self.cap_s)
        _recovery.log_respawn(str(key), n + 1, delay)
        return delay


class Coordinator:
    # Respawn backoff: base doubles per attempt (jittered), capped. Class
    # attributes so tests (and future elastic policies) can tighten them.
    RESPAWN_BACKOFF_S = 1.0
    RESPAWN_BACKOFF_CAP_S = 30.0

    def __init__(self, strategy, cluster: Cluster,
                 argv: Optional[List[str]] = None):
        self._strategy = strategy
        self._cluster = cluster
        self._argv = argv
        self._procs = []
        self._watchdogs: List[threading.Thread] = []
        # Per-address relaunch spec (cmd + env + respawn attempt count) —
        # what the respawn policy re-executes when a worker dies.
        self._launch_specs: Dict[str, dict] = {}

    def launch_clients(self, extra_env: Optional[dict] = None):
        """Ship strategy + relaunch the user script on every non-chief host.

        ``extra_env``: additional env vars for the workers (e.g. the async PS
        transport address, ``AUTODIST_PS_ADDR``)."""
        strategy_path = self._strategy.serialize()
        spec = self._cluster.cluster_spec
        coordinator_addr = spec["coordinator"]
        n = self._cluster.num_processes

        for proc_info in spec["processes"]:
            address = proc_info["address"]
            if proc_info["process_id"] == 0:
                continue  # the chief is this process
            if not is_local_address(address):
                self._cluster.remote_copy(strategy_path, const.DEFAULT_SERIALIZATION_DIR,
                                          address)
            env = self.worker_env(address, proc_info["process_id"], coordinator_addr, n)
            if extra_env:
                env.update({k: str(v) for k, v in extra_env.items()})
            cmd = relaunch_command(self._argv)
            self._launch_specs[address] = {"cmd": cmd, "env": env,
                                           "respawns": 0}
            _log.info("Launching worker on %s (process %d/%d)",
                         address, proc_info["process_id"], n)
            proc = self._cluster.remote_exec(cmd, address, env=env)
            self._procs.append(proc)
            self._watch(proc, address)

    def worker_env(self, address: str, process_id: int, coordinator_addr: str,
                   num_processes: int) -> Dict[str, str]:
        """The role and bootstrap env of the worker process at ``address``
        (``autodist_tpu/coordinator.py:84-101``)."""
        env = {
            const.AUTODIST_WORKER: address,
            const.AUTODIST_STRATEGY_ID: self._strategy.id,
            const.AUTODIST_COORDINATOR_ADDR: coordinator_addr,
            const.AUTODIST_COORDINATOR_PORT: str(const.env_int(
                const.AUTODIST_COORDINATOR_PORT, const.DEFAULT_COORDINATOR_PORT)),
            const.AUTODIST_NUM_PROCESSES: str(num_processes),
            const.AUTODIST_PROCESS_ID: str(process_id),
            const.AUTODIST_MIN_LOG_LEVEL: const.env_str(const.AUTODIST_MIN_LOG_LEVEL, "INFO"),
        }
        if const.env_armed(const.AUTODIST_IS_TESTING):
            env[const.AUTODIST_IS_TESTING] = "1"
        # A script driven by SYS_RESOURCE_PATH / SYS_DATA_PATH resolves them
        # the same way when re-executed (reference coordinator.py:70-79).
        for var in (const.SYS_RESOURCE_PATH, const.SYS_DATA_PATH):
            if const.env_str(var):
                env[var] = const.env_str(var)
        return env

    def _on_worker_failure(self, address: str, code: int):
        """React to a nonzero worker exit per ``AUTODIST_WORKER_FAILURE``:

        - ``halt`` (default): kill the chief (reference coordinator.py:98-110).
        - ``respawn``: relaunch the worker's exact command/env after a
          bounded, jittered exponential backoff — an async-PS replacement
          re-registers the gate and pulls the chief's live params on its own
          (checkpoint-free restart). At most ``AUTODIST_RECOVER_MAX``
          respawns per worker; exhaustion (or a worker never launched by
          this coordinator) escalates to ``halt``.

        Overridable for tests and custom elastic policies; runs on the dead
        worker's daemon watchdog thread."""
        policy = const.env_str(const.AUTODIST_WORKER_FAILURE, "halt")
        if policy not in ("halt", "respawn"):
            _log.warning("AUTODIST_WORKER_FAILURE=%r is not a policy "
                            "(halt|respawn); treating as halt", policy)
            policy = "halt"
        if policy == "respawn":
            # A failed relaunch (fork failure, vanished interpreter, ssh
            # error) must ESCALATE to halt, not kill this daemon watchdog
            # thread silently — a dead worker with no respawn AND no halt
            # would park the surviving workers at the staleness bound
            # forever, strictly worse than the fail-fast it replaced.
            try:
                if self._respawn(address, code):
                    return
            except Exception as e:
                _log.error("Worker %s respawn failed (%s); escalating "
                              "to halt", address, e)
        _log.error("Worker %s exited with code %s; terminating chief",
                      address, code)
        os._exit(1)

    def _respawn(self, address: str, code: int) -> bool:
        """One respawn attempt for ``address`` via :class:`RespawnPolicy`;
        False when the budget is spent or the address is unknown (caller
        escalates to halt). The attempt ledger lives in the launch spec
        (``spec["respawns"]``) so it survives across failures."""
        spec = self._launch_specs.get(address)
        if spec is None:
            return False
        policy = RespawnPolicy(self.RESPAWN_BACKOFF_S,
                               self.RESPAWN_BACKOFF_CAP_S)
        policy.attempts[address] = spec["respawns"]
        delay = policy.grant(address)      # books recovery.log_respawn
        if delay is None:
            _log.error(
                "Worker %s exited with code %s and its respawn budget "
                "(%d, AUTODIST_RECOVER_MAX) is spent; escalating to "
                "halt", address, code, policy.budget())
            return False
        spec["respawns"] = policy.attempts[address]
        _log.warning(
            "Worker %s exited with code %s; respawning in %.1fs "
            "(attempt %d/%d)", address, code, delay, spec["respawns"],
            policy.budget())
        time.sleep(delay)   # bounded: RESPAWN_BACKOFF_CAP_S
        proc = self._cluster.remote_exec(spec["cmd"], address,
                                         env=spec["env"])
        self._procs.append(proc)
        self._watch(proc, address)
        return True

    def _watch(self, proc, address: str):
        def wait():
            code = proc.wait()
            if code != 0:
                self._on_worker_failure(address, code)

        thread = threading.Thread(target=wait, daemon=True)
        thread.start()
        self._watchdogs.append(thread)

    def join(self, timeout: Optional[float] = None):
        """Wait for all workers. With a timeout, returns False if any worker is
        still running when it expires (the caller decides whether to terminate)."""
        done = True
        for proc in self._procs:
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                done = False
        return done
