"""Load-balanced PS strategy, ``AutoDist``'s default builder
(``autodist_tpu/strategy/ps_lb_strategy.py``): parameters go to the
least-loaded destination by byte size, largest first. Destinations are
coordinates along the ``reduce`` mesh axis."""

from typing import Callable

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec, ParamSpec
from autodist_tpu_torch.proto.strategy import NodeConfig
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import PS_DEFAULT_AXES, Strategy, StrategyBuilder
from autodist_tpu_torch.strategy.ps_strategy import ps_synchronizer


def byte_size_load_fn(spec: ParamSpec) -> int:
    """Load estimate for one parameter: its bytes (at least 1)."""
    return max(spec.byte_size, 1)


class PSLoadBalancing(StrategyBuilder):
    # The axis defaults this family records; Parallax overrides them.
    _default_axes = PS_DEFAULT_AXES

    def __init__(self, local_proxy_variable: bool = False, sync: bool = True,
                 staleness: int = 0, load_fn: Callable[[ParamSpec], int] = byte_size_load_fn):
        self._local_proxy_variable = local_proxy_variable
        self._sync = sync
        self._staleness = staleness
        self._load_fn = load_fn

    def _num_destinations(self, resource_spec: ResourceSpec) -> int:
        """PS shard count, from the axes :meth:`build` records in the mesh."""
        return self._resolved_axes(resource_spec, self._default_axes)[const.MESH_AXIS_REDUCE]

    def _ps(self, dest: int):
        return ps_synchronizer(dest, self._local_proxy_variable, self._sync, self._staleness)

    def build(self, model_spec: ModelSpec, resource_spec: ResourceSpec) -> Strategy:
        strategy = Strategy()
        loads = [0] * self._num_destinations(resource_spec)
        # Greedy: largest parameters first onto the least-loaded shard.
        for spec in sorted(model_spec.trainable.values(), key=lambda s: -self._load_fn(s)):
            dest = min(range(len(loads)), key=loads.__getitem__)
            loads[dest] += self._load_fn(spec)
            strategy.proto.node_config.append(NodeConfig(
                var_name=spec.name, sparse=spec.sparse, ps_synchronizer=self._ps(dest)))
        self._fill_mesh_config(strategy, resource_spec,
                               self._resolved_axes(resource_spec, self._default_axes))
        return strategy
