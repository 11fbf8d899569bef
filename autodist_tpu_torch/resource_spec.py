"""Resource specification: the cluster description handed to AutoDist.

Counterpart of ``autodist_tpu/resource_spec.py:146-284``, with the same
schema: a ``nodes:`` list (address / chief / ``gpus: [indices]`` /
``tpus: <count>`` / cpus / ssh_config / network_bandwidth), an ``ssh:``
section of config groups and an optional ``mesh:`` section of axis sizes.
The spec comes as a dict (``resource_info=``), a YAML file path or inline
YAML text; PyYAML is imported only to parse the latter two.
"""

import copy
import enum
import os
from typing import Dict, List, Optional

from autodist_tpu_torch import const

DEFAULT_NETWORK_BANDWIDTH_GBPS = 1


class DeviceType(enum.Enum):
    CPU = 0
    GPU = 1
    TPU = 2


class DeviceSpec:
    """One physical device, addressable as ``host:TYPE:index``."""

    def __init__(self, host: str, device_type: DeviceType = DeviceType.CPU,
                 device_index: int = 0):
        self.host = host
        self.device_type = device_type
        self.device_index = device_index

    @property
    def name_string(self) -> str:
        if self.device_type is DeviceType.CPU:
            return self.host
        return f"{self.host}:{self.device_type.name}:{self.device_index}"

    def __repr__(self):
        return f"DeviceSpec({self.name_string})"


class SSHConfig:
    """One ssh group entry."""

    def __init__(self, name: str, conf: dict):
        self.name = name
        self.username = conf.get("username", "")
        self.port = int(conf.get("port", 22))
        self.python_venv = conf.get("python_venv", "")
        self.key_file = conf.get("key_file", "")
        self.shared_envs = dict(conf.get("shared_envs", {}))


class Node:
    """One host entry from the ``nodes:`` list."""

    def __init__(self, entry: dict):
        if "address" not in entry:
            raise ValueError("Every node needs an 'address'")
        self.address: str = str(entry["address"])
        self.chief: bool = bool(entry.get("chief", False))
        self.ssh_config_name: Optional[str] = entry.get("ssh_config")
        # Whether the spec stated a bandwidth (not the 1 GBE default): the
        # strategy search's lossy wire codecs are chosen only from a stated one.
        self.bandwidth_specified: bool = "network_bandwidth" in entry
        self.network_bandwidth: int = int(
            entry.get("network_bandwidth", DEFAULT_NETWORK_BANDWIDTH_GBPS))
        if self.network_bandwidth <= 0:
            raise ValueError(f"network_bandwidth must be positive on node {self.address}")
        self.tpu_indices: List[int] = list(range(int(entry.get("tpus", 0))))
        self.gpu_indices: List[int] = [int(i) for i in entry.get("gpus", [])]
        self.cpu_indices: List[int] = [int(i) for i in entry.get("cpus", [])] or [0]

    @property
    def accelerator_devices(self) -> List[DeviceSpec]:
        devs = [DeviceSpec(self.address, DeviceType.TPU, i) for i in self.tpu_indices]
        devs += [DeviceSpec(self.address, DeviceType.GPU, i) for i in self.gpu_indices]
        return devs

    @property
    def cpu_devices(self) -> List[DeviceSpec]:
        return [DeviceSpec(self.address, DeviceType.CPU, i) for i in self.cpu_indices]


class ResourceSpec:
    """Parsed resource spec.

    With no argument, a single-host spec of one device per rank of the
    world torchrun launched (the ranks are the spec's accelerators, as the
    JAX package declares its visible devices, on the card or on the host),
    else over the visible CUDA devices (or the host's CPU when there is
    none)."""

    def __init__(self, resource_file: Optional[str] = None, *,
                 resource_info: Optional[dict] = None):
        if resource_info is not None:
            info = copy.deepcopy(resource_info)
        elif resource_file is None:
            info = self._local_default_info()
        else:
            import yaml
            if os.path.exists(resource_file):
                with open(resource_file) as f:
                    info = yaml.safe_load(f) or {}
            else:
                info = yaml.safe_load(resource_file)
                if not isinstance(info, dict):
                    raise FileNotFoundError(f"No such resource spec file: {resource_file}")
        if not isinstance(info, dict):
            raise ValueError(f"Resource spec must be a mapping, got {type(info).__name__}")
        nodes_conf = info.get("nodes") or []
        if not nodes_conf:
            raise ValueError("Resource spec has no nodes")
        self.nodes: List[Node] = [Node(e) for e in nodes_conf]
        self.ssh_config_map: Dict[str, SSHConfig] = {
            name: SSHConfig(name, c) for name, c in (info.get("ssh") or {}).items()}
        self.mesh_config: Dict[str, int] = dict(info.get("mesh", {}) or {})
        self._validate_and_set_chief()

    @staticmethod
    def _local_default_info() -> dict:
        import torch
        import torch.distributed as dist
        if dist.is_initialized():
            n = dist.get_world_size()
        else:
            n = const.ENV.WORLD_SIZE.val or torch.cuda.device_count()
        node = {"address": "localhost", "chief": True}
        if n:
            node["gpus"] = list(range(n))
        return {"nodes": [node]}

    def _validate_and_set_chief(self):
        addresses = [n.address for n in self.nodes]
        if len(set(addresses)) != len(addresses):
            raise ValueError("Duplicate node addresses in resource spec")
        chiefs = [n for n in self.nodes if n.chief]
        if len(self.nodes) == 1 and not chiefs:
            self.nodes[0].chief = True
            chiefs = [self.nodes[0]]
        if len(chiefs) != 1:
            raise ValueError(f"Exactly one chief required, found {len(chiefs)}")
        self._chief = chiefs[0]
        for n in self.nodes:
            if n.ssh_config_name is not None and n.ssh_config_name not in self.ssh_config_map:
                raise ValueError(
                    f"Node {n.address} references unknown ssh_config "
                    f"{n.ssh_config_name!r}; defined groups: {sorted(self.ssh_config_map)}")

    @property
    def chief_address(self) -> str:
        return self._chief.address

    @property
    def node_addresses(self) -> List[str]:
        return [n.address for n in self.nodes]

    # Sorted so every host derives the same device order independently.
    @property
    def sorted_nodes(self) -> List[Node]:
        return sorted(self.nodes, key=lambda n: (not n.chief, n.address))

    @property
    def accelerator_devices(self) -> List[DeviceSpec]:
        return [d for node in self.sorted_nodes for d in node.accelerator_devices]

    @property
    def num_accelerators(self) -> int:
        return len(self.accelerator_devices)

    def ssh_config_for(self, address: str) -> Optional[SSHConfig]:
        """The ssh group of the node at ``address`` (None: plain ssh)."""
        for n in self.nodes:
            if n.address == address:
                if n.ssh_config_name is None:
                    return None
                return self.ssh_config_map[n.ssh_config_name]
        raise KeyError(address)

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    # Replica devices: all accelerators, plus the CPU of accelerator-less nodes.
    @property
    def replica_devices(self) -> List[DeviceSpec]:
        out: List[DeviceSpec] = []
        for node in self.sorted_nodes:
            accs = node.accelerator_devices
            out.extend(accs if accs else node.cpu_devices[:1])
        return out

    def __repr__(self):
        return (f"ResourceSpec(nodes={self.node_addresses}, chief={self.chief_address}, "
                f"accelerators={self.num_accelerators})")
