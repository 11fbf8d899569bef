"""Cluster management: process launch across hosts (the port's copy of
``autodist_tpu/cluster.py``). A multi-node run is one program a host: the
synchronous strategies join one ``torch.distributed`` group at the
coordinator's address, the async ones meet at the chief's parameter service.

- ``start()`` assigns the coordinator address (chief:port) and deterministic
  process ids from the sorted node list (every host derives the same
  mapping, reference ``cluster.py:70-82``), writing ``cluster_spec.json``.
- ``remote_exec`` / ``remote_copy`` keep the reference's
  control-plane surface (``cluster.py:271-374``), implemented over ``ssh``/``scp``
  subprocesses (the reference used paramiko + ``ssh -tt``).
- Local addresses take a fast path: plain subprocess, no ssh (reference treated the
  chief's own node the same way, ``cluster.py:193-196``).
"""

import functools
import json
import logging
import os
import shlex
import signal
import socket
import subprocess
from typing import Dict, List, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.resource_spec import ResourceSpec, SSHConfig

_log = logging.getLogger("autodist_tpu_torch")

_LOOPBACK_ADDRESSES = ("localhost", "127.0.0.1", "0.0.0.0", "::1")


@functools.lru_cache(maxsize=None)
def _own_addresses() -> frozenset:
    """Every address this host answers to: loopback names, hostname/FQDN and their
    resolutions, per-interface IPv4 addresses, and the primary outbound address.
    The stdlib equivalent of the reference's netifaces enumeration
    (utils/network.py:21-75), so a resource spec listing the chief's real IP takes
    the local fast path instead of SSHing to itself."""
    addrs = set(_LOOPBACK_ADDRESSES)
    hostname = socket.gethostname()
    addrs.add(hostname)
    for name in (hostname, socket.getfqdn()):
        addrs.add(name)
        try:
            for info in socket.getaddrinfo(name, None):
                addrs.add(info[4][0])
        except OSError:
            pass
    try:  # per-interface IPv4 addresses (Linux SIOCGIFADDR, like netifaces)
        import fcntl
        import struct
        for _, ifname in socket.if_nameindex():
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                try:
                    packed = fcntl.ioctl(s.fileno(), 0x8915,  # SIOCGIFADDR
                                         struct.pack("256s", ifname[:15].encode()))
                    addrs.add(socket.inet_ntoa(packed[20:24]))
                except OSError:
                    pass
    except (ImportError, OSError):
        pass
    try:  # primary outbound interface, no packet sent
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))
            addrs.add(s.getsockname()[0])
    except OSError:
        pass
    return frozenset(addrs)


def is_local_address(address: str) -> bool:
    """True for loopback addresses and this host's own names/IPs.

    The whole 127.0.0.0/8 (and ::1) counts: Linux binds the full block to
    ``lo``, and distinct loopback IPs are how a spec models several processes
    on one host (node addresses must be unique, like the reference's
    per-host cluster spec keys)."""
    if address in _LOOPBACK_ADDRESSES or address in _own_addresses():
        return True
    try:
        import ipaddress
        return ipaddress.ip_address(address).is_loopback
    except ValueError:
        return False


class Cluster:
    """Process/launch manager for one resource spec."""

    def __init__(self, resource_spec: ResourceSpec):
        self._spec = resource_spec
        self._processes: List[subprocess.Popen] = []
        self.cluster_spec = self._build_cluster_spec()

    def _build_cluster_spec(self) -> Dict:
        """Deterministic host ordering -> process ids (every host derives the same
        mapping independently, reference cluster.py:70-82)."""
        nodes = self._spec.sorted_nodes
        port = const.env_int(const.AUTODIST_COORDINATOR_PORT, const.DEFAULT_COORDINATOR_PORT)
        coordinator = f"{self._spec.chief_address}:{port}"
        return {
            "coordinator": coordinator,
            "processes": [
                {"address": n.address, "process_id": i,
                 "num_devices": len(n.accelerator_devices) or 1}
                for i, n in enumerate(nodes)
            ],
        }

    @property
    def num_processes(self) -> int:
        return len(self.cluster_spec["processes"])

    def process_id_of(self, address: str) -> int:
        for p in self.cluster_spec["processes"]:
            if p["address"] == address:
                return p["process_id"]
        raise KeyError(address)

    # ------------------------------------------------------------------ start
    def start(self):
        """Write cluster_spec.json under the working dir (reference wrote the same
        file for tf.Servers, cluster.py:192) and sanity-check remote reachability."""
        os.makedirs(const.DEFAULT_WORKING_DIR, exist_ok=True)
        path = os.path.join(const.DEFAULT_WORKING_DIR, "cluster_spec.json")
        with open(path, "w") as f:
            json.dump(self.cluster_spec, f, indent=1)
        _log.info("Cluster spec: %s", self.cluster_spec)

    def terminate(self):
        """Kill every launched process group (reference cluster.py:212-216)."""
        for proc in self._processes:
            if proc.poll() is None:
                try:
                    os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    proc.terminate()
        self._processes.clear()

    # ------------------------------------------------------------- remote ops
    def _ssh_config(self, address: str) -> Optional[SSHConfig]:
        return self._spec.ssh_config_for(address)

    def _ssh_command(self, address: str) -> List[str]:
        conf = self._ssh_config(address)
        cmd = ["ssh", "-tt", "-o", "StrictHostKeyChecking=no"]
        if conf:
            if conf.port != 22:
                cmd += ["-p", str(conf.port)]
            if conf.key_file:
                cmd += ["-i", conf.key_file]
            target = f"{conf.username}@{address}" if conf.username else address
        else:
            target = address
        return cmd + [target]

    def remote_exec(self, args: List[str], address: str,
                    env: Optional[Dict[str, str]] = None) -> subprocess.Popen:
        """Run a command on a node (reference cluster.py:316-345). Local addresses
        run directly in a new process group; remote go over ssh."""
        env_prefix = ""
        full_env = None
        if env:
            env_prefix = " ".join(f"{k}={shlex.quote(str(v))}" for k, v in env.items()) + " "
        if is_local_address(address):
            full_env = dict(os.environ)
            full_env.update({k: str(v) for k, v in (env or {}).items()})
            proc = subprocess.Popen(args, env=full_env, start_new_session=True)
        else:
            conf = self._ssh_config(address)
            # All env assignments (shared_envs + role env) must prefix the user
            # command itself — a prefix on the `source venv` statement would not
            # survive past the `;`.
            if conf and conf.shared_envs:
                env_prefix = " ".join(f"{k}={shlex.quote(str(v))}"
                                      for k, v in conf.shared_envs.items()) + " " + env_prefix
            inner = env_prefix + " ".join(shlex.quote(a) for a in args)
            if conf and conf.python_venv:
                inner = f"{conf.python_venv}; {inner}"
            cmd = self._ssh_command(address) + [f"bash -c {shlex.quote(inner)}"]
            if const.env_armed(const.AUTODIST_DEBUG_REMOTE):
                _log.info("remote_exec[%s]: %s", address, cmd)
            proc = subprocess.Popen(cmd, start_new_session=True)
        self._processes.append(proc)
        return proc

    def remote_copy(self, local_path: str, remote_dir: str, address: str):
        """Copy a local file to a node (reference cluster.py:360-374)."""
        if is_local_address(address):
            os.makedirs(remote_dir, exist_ok=True)
            dest = os.path.join(remote_dir, os.path.basename(local_path))
            if os.path.abspath(dest) != os.path.abspath(local_path):
                with open(local_path, "rb") as src, open(dest, "wb") as dst:
                    dst.write(src.read())
            return
        conf = self._ssh_config(address)
        cmd = ["scp", "-o", "StrictHostKeyChecking=no"]
        if conf:
            if conf.port != 22:
                cmd += ["-P", str(conf.port)]
            if conf.key_file:
                cmd += ["-i", conf.key_file]
            target = f"{conf.username}@{address}" if conf.username else address
        else:
            target = address
        subprocess.run(cmd + [local_path, f"{target}:{remote_dir}/"], check=True)
