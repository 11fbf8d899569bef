"""Strategy wrapper, builder ABC and compiler (``autodist_tpu/strategy/base.py:28-235``).

The port's strategy is the dataclass schema of :mod:`autodist_tpu_torch.proto.strategy`.
The compiler prunes, resolves the mesh and resolves PS destinations to
``reduce:<k>`` coordinates. A strategy is serialized by id under the working
directory's ``strategies/`` (the chief-to-worker handshake: the coordinator
ships the id in ``AUTODIST_STRATEGY_ID``), as JSON of its ``to_dict`` (the
card has no protobuf).
"""

import abc
import copy
import datetime
import json
import os
from typing import Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.parallel.mesh import standard_mesh_shape
from autodist_tpu_torch.proto import strategy as strategy_pb
from autodist_tpu_torch.resource_spec import ResourceSpec


class Strategy:
    """A built distribution strategy: the message plus a timestamped id."""

    def __init__(self, proto: Optional[strategy_pb.Strategy] = None):
        self._proto = proto or strategy_pb.Strategy()
        if not self._proto.id:
            self._proto.id = datetime.datetime.now().strftime("%Y%m%dT%H%M%SM%f")

    @property
    def proto(self) -> strategy_pb.Strategy:
        return self._proto

    @property
    def id(self) -> str:
        return self._proto.id

    @property
    def node_config(self):
        return self._proto.node_config

    @property
    def mesh_config(self) -> strategy_pb.MeshConfig:
        return self._proto.mesh_config

    def mesh_axes(self) -> dict:
        mc = self._proto.mesh_config
        return {a.name: a.size for a in mc.axes} if mc is not None else {}

    def to_dict(self) -> dict:
        return self._proto.to_dict()

    # --- serialization by id (reference strategy/base.py:78-99) ---

    @staticmethod
    def _path_for(strategy_id: str) -> str:
        return os.path.join(const.DEFAULT_SERIALIZATION_DIR, strategy_id)

    def serialize(self, path: Optional[str] = None) -> str:
        """Write the strategy to ``path`` (default: its id under the working
        directory's ``strategies/``); returns the path."""
        path = path or self._path_for(self.id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._proto.path = path
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self._proto.to_dict(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def deserialize(cls, strategy_id: Optional[str] = None,
                    path: Optional[str] = None) -> "Strategy":
        if path is None:
            if not strategy_id:
                raise ValueError("Need a strategy id or path")
            path = cls._path_for(strategy_id)
        with open(path) as f:
            return cls(strategy_pb.Strategy.from_dict(json.load(f)))

    def copy(self) -> "Strategy":
        return Strategy(copy.deepcopy(self._proto))

    def __str__(self):
        return (f"Strategy(id={self.id}, nodes={len(self._proto.node_config)}, "
                f"mesh={self.mesh_axes()})")


# Default mesh for the PS family: every device is both a data replica and a
# parameter shard (the batch shards over data x reduce jointly).
PS_DEFAULT_AXES = {const.MESH_AXIS_REDUCE: -1, const.MESH_AXIS_DATA: 1}
# Default mesh for the AllReduce family: pure data parallelism.
AR_DEFAULT_AXES = {const.MESH_AXIS_DATA: -1}


def num_devices(resource_spec: ResourceSpec) -> int:
    """Device count a strategy targets: accelerators if the spec lists any,
    else one slot per replica device, floor 1."""
    return max(1, resource_spec.num_accelerators or len(resource_spec.replica_devices))


def _mesh_config(n_devices: int, axes: Optional[dict], replica_devices) -> strategy_pb.MeshConfig:
    shape = standard_mesh_shape(n_devices, axes)
    return strategy_pb.MeshConfig(
        axes=[strategy_pb.MeshAxis(name=a, size=s) for a, s in shape.items()],
        replica_devices=list(replica_devices))


class StrategyBuilder(abc.ABC):
    """Policy ABC: (ModelSpec, ResourceSpec) -> Strategy."""

    @abc.abstractmethod
    def build(self, model_spec: ModelSpec, resource_spec: ResourceSpec) -> Strategy:
        ...

    @staticmethod
    def _resolved_axes(resource_spec: ResourceSpec, default_axes: dict) -> dict:
        return dict(standard_mesh_shape(num_devices(resource_spec),
                                        resource_spec.mesh_config or default_axes))

    @staticmethod
    def _build_axis0_sharded(model_spec: ModelSpec, resource_spec: ResourceSpec,
                             mesh_axis: str, axis_size: int, param_filter,
                             ar_spec, ar_compressor, chunk_size: int) -> Strategy:
        """The skeleton of the single-axis builders (``ExpertParallel``,
        ``Pipeline``; ``autodist_tpu/strategy/base.py:119-150``): a
        parameter passing ``param_filter`` gets a dim-0 partitioner of
        ``axis_size`` shards on ``mesh_axis``, with ``axis_size``
        ``part_config`` children that carry AllReduce synchronizers; every
        other parameter gets an AllReduce node. The mesh is
        ``{mesh_axis: axis_size, data: -1}`` unless the resource spec sets one."""
        strategy = Strategy()
        for i, spec in enumerate(model_spec.trainable.values()):
            node = strategy_pb.NodeConfig(var_name=spec.name, sparse=spec.sparse)
            strategy.proto.node_config.append(node)

            def ar():
                return strategy_pb.AllReduceSynchronizer(
                    spec=ar_spec, compressor=ar_compressor, group=i // chunk_size)

            if param_filter(spec):
                node.partitioner = strategy_pb.PartitionConfig(
                    num_shards=[axis_size] + [1] * (len(spec.shape) - 1), mesh_axis=mesh_axis)
                node.part_config = [
                    strategy_pb.NodeConfig(var_name=f"{spec.name}/part_{k}",
                                           all_reduce_synchronizer=ar())
                    for k in range(axis_size)]
            else:
                node.all_reduce_synchronizer = ar()
        axes = {mesh_axis: axis_size, const.MESH_AXIS_DATA: -1}
        StrategyBuilder._fill_mesh_config(
            strategy, resource_spec, StrategyBuilder._resolved_axes(resource_spec, axes))
        return strategy

    @staticmethod
    def _fill_mesh_config(strategy: Strategy, resource_spec: ResourceSpec,
                          axes: Optional[dict] = None):
        """Record the mesh shape and replica devices in the graph-level config."""
        strategy.proto.mesh_config = _mesh_config(
            num_devices(resource_spec),
            axes if axes is not None else resource_spec.mesh_config,
            (d.name_string for d in resource_spec.replica_devices))


class StrategyCompiler:
    """Prune + resolve pass over a built strategy."""

    def __init__(self, model_spec: ModelSpec, resource_spec: ResourceSpec):
        self._model_spec = model_spec
        self._resource_spec = resource_spec

    def compile(self, strategy: Strategy) -> Strategy:
        out = strategy.copy()
        self._prune_nodes(out)
        self._resolve_mesh(out)
        self._resolve_destinations(out)
        return out

    def _prune_nodes(self, strategy: Strategy):
        """Drop configs for unknown or non-trainable parameters."""
        trainable = self._model_spec.trainable
        strategy.proto.node_config = [n for n in strategy.node_config
                                      if n.var_name in trainable]

    def _resolve_mesh(self, strategy: Strategy):
        """Fill/validate mesh axis sizes against the actual device count."""
        old = strategy.proto.mesh_config
        replicas = (old.replica_devices if old is not None and old.replica_devices
                    else [d.name_string for d in self._resource_spec.replica_devices])
        strategy.proto.mesh_config = _mesh_config(
            num_devices(self._resource_spec), strategy.mesh_axes() or None, replicas)

    def _resolve_destinations(self, strategy: Strategy):
        """PS reduction destinations as shard indices along the ``reduce``
        axis: a device string ``host:...`` becomes ``reduce:<k>`` (the host's
        place among the sorted nodes, modulo the axis size); empty and
        already-resolved destinations pass through."""
        hosts = [n.address for n in self._resource_spec.sorted_nodes]
        reduce_size = strategy.mesh_axes().get(const.MESH_AXIS_REDUCE, 1)
        for node in strategy.node_config:
            for cfg in [node] + list(node.part_config):
                ps = cfg.ps_synchronizer
                if ps is None or not ps.reduction_destination \
                        or ps.reduction_destination.startswith("reduce:"):
                    continue
                host = ps.reduction_destination.split(":")[0]
                idx = hosts.index(host) % reduce_size if host in hosts else 0
                ps.reduction_destination = f"reduce:{idx}"
