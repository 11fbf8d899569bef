"""Strategy wrapper, builder ABC and compiler (``autodist_tpu/strategy/base.py:28-235``).

The port's strategy is the dataclass schema of :mod:`autodist_tpu_torch.proto.strategy`.
Serialization by id (the chief-to-worker handshake) and PS destination
resolution belong to the multi-process and PS slices and are not ported yet.
"""

import abc
import copy
import datetime
from typing import Optional

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

    def copy(self) -> "Strategy":
        return Strategy(copy.deepcopy(self._proto))

    def __str__(self):
        return (f"Strategy(id={self.id}, nodes={len(self._proto.node_config)}, "
                f"mesh={self.mesh_axes()})")


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
