"""Strategy schema as plain dataclasses.

The messages, field names and enum values are those of
``autodist_tpu/proto/strategy.proto:16-124``; :meth:`Message.to_dict` renders
a message the way protobuf's ``MessageToDict(..., preserving_proto_field_name
=True)`` renders the JAX package's: fields at their proto3 default are left
out, a set sub-message is kept even when empty, enums appear by name. The
port needs no protobuf runtime.
"""

import dataclasses
import enum
from typing import List, Optional


class Message:
    def to_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if value is None:
                continue
            if isinstance(value, Message):
                out[f.name] = value.to_dict()
            elif isinstance(value, list):
                if value:
                    out[f.name] = [x.to_dict() if isinstance(x, Message) else x
                                   for x in value]
            elif value:  # proto3: zero, "" and False are not serialized
                out[f.name] = value.name if isinstance(value, enum.Enum) else value
        return out


@dataclasses.dataclass
class AllReduceSynchronizer(Message):
    """Gradient all-reduce over the data axes."""

    class Spec(enum.IntEnum):
        AUTO = 0
        ICI = 1
        DCN = 2

    class Compressor(enum.IntEnum):
        NONE = 0
        BF16 = 1
        BF16_EF = 2
        POWER_SGD = 3

    spec: Spec = Spec.AUTO
    compressor: Compressor = Compressor.NONE
    power_sgd_rank: int = 0
    group: int = 0


@dataclasses.dataclass
class PSSynchronizer(Message):
    reduction_destination: str = ""
    local_replication: bool = False
    sync: bool = False
    staleness: int = 0


@dataclasses.dataclass
class PartitionConfig(Message):
    num_shards: List[int] = dataclasses.field(default_factory=list)
    mesh_axis: str = ""


@dataclasses.dataclass
class NodeConfig(Message):
    """Per-parameter distribution choice. At most one of the two
    synchronizers is set (the proto's ``synchronizer`` oneof)."""

    var_name: str = ""
    ps_synchronizer: Optional[PSSynchronizer] = None
    all_reduce_synchronizer: Optional[AllReduceSynchronizer] = None
    partitioner: Optional[PartitionConfig] = None
    part_config: List["NodeConfig"] = dataclasses.field(default_factory=list)
    sparse: bool = False

    def which_synchronizer(self) -> Optional[str]:
        if self.ps_synchronizer is not None:
            return "ps_synchronizer"
        if self.all_reduce_synchronizer is not None:
            return "all_reduce_synchronizer"
        return None


@dataclasses.dataclass
class MeshAxis(Message):
    """``MeshConfig.Axis`` of the proto."""

    name: str = ""
    size: int = 0


@dataclasses.dataclass
class MeshConfig(Message):
    axes: List[MeshAxis] = dataclasses.field(default_factory=list)
    replica_devices: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Strategy(Message):
    id: str = ""
    path: str = ""
    node_config: List[NodeConfig] = dataclasses.field(default_factory=list)
    mesh_config: Optional[MeshConfig] = None
