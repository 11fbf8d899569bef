"""PS strategy: every parameter synchronized parameter-server style
(``autodist_tpu/strategy/ps_strategy.py``). It compiles to weight-update
sharding: gradients reduce-scatter onto each parameter's shard along the
``reduce`` mesh axis, the optimizer updates the shard, and the parameters
all-gather back. One logical destination, ``reduce:0``, is recorded."""

from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.proto.strategy import NodeConfig, PSSynchronizer
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import PS_DEFAULT_AXES, Strategy, StrategyBuilder


def ps_synchronizer(dest: int, local_replication: bool, sync: bool,
                    staleness: int) -> PSSynchronizer:
    return PSSynchronizer(reduction_destination=f"reduce:{dest}",
                          local_replication=local_replication, sync=sync,
                          staleness=staleness)


class PS(StrategyBuilder):
    """All parameters to one PS destination."""

    def __init__(self, local_proxy_variable: bool = False, sync: bool = True,
                 staleness: int = 0):
        if staleness < 0:
            raise ValueError("staleness must be >= 0")
        self._local_proxy_variable = local_proxy_variable
        self._sync = sync
        self._staleness = staleness

    def build(self, model_spec: ModelSpec, resource_spec: ResourceSpec) -> Strategy:
        strategy = Strategy()
        for name, spec in model_spec.trainable.items():
            strategy.proto.node_config.append(NodeConfig(
                var_name=name, sparse=spec.sparse,
                ps_synchronizer=ps_synchronizer(0, self._local_proxy_variable,
                                                self._sync, self._staleness)))
        self._fill_mesh_config(strategy, resource_spec,
                               self._resolved_axes(resource_spec, PS_DEFAULT_AXES))
        return strategy
