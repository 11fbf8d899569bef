"""Parallax hybrid strategy (``autodist_tpu/strategy/parallax_strategy.py``):
sparse (gather-only) parameters go to load-balanced PS, dense ones to
gradient all-reduce with the codec knobs, on a data-primary mesh."""

from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.proto.strategy import AllReduceSynchronizer, NodeConfig
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.all_reduce_strategy import parse_ar_options
from autodist_tpu_torch.strategy.base import AR_DEFAULT_AXES, Strategy
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing


class Parallax(PSLoadBalancing):
    # Data parallelism stays primary; PS destinations count against it too.
    _default_axes = AR_DEFAULT_AXES

    def __init__(self, chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor", local_proxy_variable: bool = False,
                 sync: bool = True, staleness: int = 0):
        super().__init__(local_proxy_variable=local_proxy_variable, sync=sync,
                         staleness=staleness)
        self._chunk_size, self._spec, self._compressor = parse_ar_options(
            chunk_size, all_reduce_spec, compressor)

    def build(self, model_spec: ModelSpec, resource_spec: ResourceSpec) -> Strategy:
        strategy = Strategy()
        loads = [0] * self._num_destinations(resource_spec)
        dense_idx = 0
        for spec in model_spec.trainable.values():
            node = NodeConfig(var_name=spec.name, sparse=spec.sparse)
            if spec.sparse:
                dest = min(range(len(loads)), key=loads.__getitem__)
                loads[dest] += self._load_fn(spec)
                node.ps_synchronizer = self._ps(dest)
            else:
                node.all_reduce_synchronizer = AllReduceSynchronizer(
                    spec=self._spec, compressor=self._compressor,
                    group=dense_idx // self._chunk_size)
                dense_idx += 1
            strategy.proto.node_config.append(node)
        self._fill_mesh_config(strategy, resource_spec,
                               self._resolved_axes(resource_spec, self._default_axes))
        return strategy
