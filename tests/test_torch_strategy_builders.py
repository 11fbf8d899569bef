"""The port's strategy builders, compiler and sharding plan against the JAX
package's (pure Python, no spawn): for each builder and model, the built
strategy field by field (destinations, shard counts, part names, groups,
compressor, spec, the sparse flags, the mesh), the compiled plan's storage
and optimizer-state partition specs with and without ZeRO, the policies of
``tests/test_strategy_builders.py:30-125``, the divisor helpers, the
flagship loss's walked index leaves against JAX's detection, and what
raises instead of running."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from google.protobuf.json_format import MessageToDict

from autodist_tpu import strategy as jstrategy
from autodist_tpu.model_spec import ModelSpec as JModelSpec
from autodist_tpu.parallel.plan import ShardingPlan as JPlan
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import partition_utils as jpu
from autodist_tpu_torch import AutoDist
from autodist_tpu_torch import strategy as tstrategy
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.parallel.plan import ShardingPlan
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import partition_utils as tpu

SHAPES = {"emb": (12, 4), "w1": (7, 3), "w2": (4, 4), "b": (3,), "s": ()}
RESOURCES = {
    "8": {"nodes": [{"address": "localhost", "tpus": 8}]},
    "reduce4": {"nodes": [{"address": "localhost", "tpus": 8}],
                "mesh": {"reduce": 4, "data": 2}},
    "model2": {"nodes": [{"address": "localhost", "gpus": [0, 1, 2, 3]}],
               "mesh": {"model": 2, "reduce": 2, "data": -1}},
    "model4": {"nodes": [{"address": "localhost", "gpus": list(range(8))}],
               "mesh": {"model": 4, "data": -1}},
}
BUILDERS = {
    "PS": lambda s: s.PS(),
    "PS-async": lambda s: s.PS(sync=False, staleness=2, local_proxy_variable=True),
    "PSLoadBalancing": lambda s: s.PSLoadBalancing(),
    "PartitionedPS": lambda s: s.PartitionedPS(),
    "UnevenPartitionedPS": lambda s: s.UnevenPartitionedPS(),
    "PartitionedAR": lambda s: s.PartitionedAR(chunk_size=3, compressor="HorovodCompressor"),
    "RandomAxisPartitionAR": lambda s: s.RandomAxisPartitionAR(seed=7),
    "Parallax": lambda s: s.Parallax(chunk_size=2, compressor="HorovodCompressorEF",
                                     all_reduce_spec="DCN"),
    "AllReduce": lambda s: s.AllReduce(chunk_size=2, compressor="PowerSGDCompressor",
                                       power_sgd_rank=3),
}


def _models(sparse: bool):
    names = ["emb"] if sparse else []
    jspec = JModelSpec({k: jnp.zeros(s) for k, s in SHAPES.items()}, sparse_names=names)
    tspec = ModelSpec({k: torch.zeros(s) for k, s in SHAPES.items()}, sparse_names=names)
    return jspec, tspec


def _both(builder: str, resources: str, sparse: bool):
    """``(JAX strategy dict, port strategy dict, JAX compiled, port
    compiled, JAX spec, port spec)`` for one builder, resource spec and
    model."""
    jspec, tspec = _models(sparse)
    jres = JResourceSpec(resource_info=RESOURCES[resources])
    tres = ResourceSpec(resource_info=RESOURCES[resources])
    jbuilt = BUILDERS[builder](jstrategy).build(jspec, jres)
    tbuilt = BUILDERS[builder](tstrategy).build(tspec, tres)
    want = MessageToDict(jbuilt.proto, preserving_proto_field_name=True)
    got = tbuilt.to_dict()
    want.pop("id"), got.pop("id")    # build timestamps
    jcompiled = jstrategy.StrategyCompiler(jspec, jres).compile(jbuilt)
    tcompiled = tstrategy.StrategyCompiler(tspec, tres).compile(tbuilt)
    return want, got, jcompiled, tcompiled, jspec, tspec


CASES = [(b, r, sparse) for b in BUILDERS for r in ("8", "reduce4", "model2")
         for sparse in (False, True)]


@pytest.mark.parametrize("builder,resources,sparse", CASES)
def test_builder_matches_jax_field_by_field(builder, resources, sparse):
    want, got, jcompiled, tcompiled, _, _ = _both(builder, resources, sparse)
    assert got == want
    want = MessageToDict(jcompiled.proto, preserving_proto_field_name=True)
    got = tcompiled.to_dict()
    want.pop("id"), got.pop("id")
    assert got == want


PLAN_CASES = [(b, r) for b in ("PS", "PSLoadBalancing", "PartitionedPS",
                               "UnevenPartitionedPS", "PartitionedAR",
                               "RandomAxisPartitionAR", "Parallax", "AllReduce")
              for r in ("reduce4", "model2", "model4")]


@pytest.mark.parametrize("builder,resources", PLAN_CASES)
def test_plan_matches_jax(builder, resources):
    """Each parameter's storage and optimizer-state specs, padding,
    synchronizer and codec knobs, with and without ZeRO."""
    _, _, jcompiled, tcompiled, jspec, tspec = _both(builder, resources, sparse=True)
    jplan, tplan = JPlan.from_strategy(jcompiled, jspec), ShardingPlan.from_strategy(
        tcompiled, tspec)
    assert dict(tplan.mesh_axes) == dict(jplan.mesh_axes)
    logical = {n: np.arange(1, 1 + int(np.prod(s)), dtype=np.float32).reshape(s)
               for n, s in SHAPES.items()}
    jpadded = {n: np.asarray(v) for n, v in jplan.pad_params(logical).items()}
    tpadded = tplan.pad_params({n: torch.tensor(v) for n, v in logical.items()})
    for name, value in jpadded.items():
        np.testing.assert_array_equal(tpadded[name].numpy(), value, err_msg=name)
        np.testing.assert_array_equal(tplan.unpad_params(tpadded)[name].numpy(),
                                      logical[name], err_msg=name)
    for zero in (False, True):
        if zero:
            jplan, tplan = jplan.with_zero_update(), tplan.with_zero_update()
        for name, jp in jplan.params.items():
            tp = tplan.params[name]
            assert (tp.pspec, tp.opt_pspec) == (tuple(jp.pspec), tuple(jp.opt_pspec)), name
            for field in ("sync", "compressor", "power_sgd_rank", "group", "spec", "sparse",
                          "staleness", "synchronous", "partition_axis", "num_shards",
                          "partition_mesh_axis", "padded_dim", "logical_dim", "shape"):
                assert getattr(tp, field) == getattr(jp, field), (name, field)
        for prop in ("dp_size", "has_compression", "is_async", "all_params_replicated",
                     "has_padding"):
            assert getattr(tplan, prop) == getattr(jplan, prop), prop
        assert sorted(tplan.sparse_wire_params) == sorted(jplan.sparse_wire_params)


def test_ps_all_vars_single_destination():
    _, _, _, s, _, _ = _both("PS", "8", False)
    assert len(s.node_config) == 5
    for n in s.node_config:
        assert n.which_synchronizer() == "ps_synchronizer"
        assert n.ps_synchronizer.reduction_destination == "reduce:0"
        assert n.ps_synchronizer.sync
    assert s.mesh_axes()["reduce"] == 8


def test_ps_lb_greedy_balance():
    _, _, _, s, _, model = _both("PSLoadBalancing", "reduce4", False)
    dests = {n.var_name: n.ps_synchronizer.reduction_destination for n in s.node_config}
    assert len(set(dests.values())) == 4
    loads = {}
    for name, d in dests.items():
        loads[d] = loads.get(d, 0) + tstrategy.byte_size_load_fn(model[name])
    assert max(loads.values()) == tstrategy.byte_size_load_fn(model["emb"])


@pytest.mark.parametrize("builder,emb,w1", [("PartitionedPS", [2, 1], [7, 1]),
                                             ("UnevenPartitionedPS", [5, 1], [2, 1])])
def test_partitioned_ps_shard_counts(builder, emb, w1):
    _, _, _, s, _, _ = _both(builder, "reduce4", False)
    nodes = {n.var_name: n for n in s.node_config}
    assert nodes["emb"].partitioner.num_shards == emb
    assert len(nodes["emb"].part_config) == emb[0]
    assert nodes["emb"].part_config[0].var_name == "emb/part_0"
    assert nodes["w1"].partitioner.num_shards == w1
    assert nodes["s"].partitioner is None


def test_partitioned_ar_running_group_counter():
    _, _, _, s, _, _ = _both("PartitionedAR", "8", False)
    shards = []
    for n in s.node_config:
        if n.partitioner is not None:
            shards.extend(p.all_reduce_synchronizer.group for p in n.part_config)
        else:
            shards.append(n.all_reduce_synchronizer.group)
    assert shards == sorted(shards)
    assert shards[0] == 0 and shards[-1] == (len(shards) - 1) // 3


def test_random_axis_deterministic_and_sparse_axis0():
    _, s1 = _models(sparse=True)
    res = ResourceSpec(resource_info=RESOURCES["8"])
    a = tstrategy.RandomAxisPartitionAR(seed=7).build(s1, res)
    b = tstrategy.RandomAxisPartitionAR(seed=7).build(s1, res)
    assert a.proto.node_config == b.proto.node_config
    nodes = {n.var_name: n for n in a.node_config}
    ns = nodes["emb"].partitioner.num_shards
    assert ns[0] > 1 and all(x == 1 for x in ns[1:])


def test_parallax_routes_sparse_to_ps():
    _, _, _, s, _, _ = _both("Parallax", "8", True)
    nodes = {n.var_name: n for n in s.node_config}
    assert nodes["emb"].which_synchronizer() == "ps_synchronizer"
    assert nodes["w1"].which_synchronizer() == "all_reduce_synchronizer"
    assert nodes["emb"].sparse


def test_all_reduce_rejects_bad_args():
    for kwargs in (dict(chunk_size=0), dict(compressor="zip"), dict(all_reduce_spec="banana")):
        with pytest.raises(ValueError):
            tstrategy.AllReduce(**kwargs)
    with pytest.raises(ValueError):
        tstrategy.PS(staleness=-1)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 9, 12, 49, 97, 360])
@pytest.mark.parametrize("cap", [None, 5])
def test_divisor_helpers(n, cap):
    assert tpu.smallest_divisor_at_least_2(n, cap) == jpu.smallest_divisor_at_least_2(n, cap)
    assert tpu.smallest_non_divisor_at_least_2(n, cap) == \
        jpu.smallest_non_divisor_at_least_2(n, cap)
    assert tpu.make_num_shards(3, 1, n) == jpu.make_num_shards(3, 1, n)


def test_default_builder_is_ps_load_balancing():
    ad = AutoDist(resource_info=RESOURCES["reduce4"], device="cpu")
    assert type(ad._strategy_builder) is tstrategy.PSLoadBalancing
    _, spec = _models(sparse=False)
    assert ad.build_strategy(spec).mesh_axes()["reduce"] == 4


def test_flagship_index_leaves_equal_jax_detection():
    """The walk of the flagship loss finds the gather-only params JAX
    detects and, as JAX finds for its sliced token gather, no index leaf
    (so no wire)."""
    import jax
    from autodist_tpu.models import transformer_lm as jlm
    from autodist_tpu_torch import from_jax_params
    from autodist_tpu_torch.models import transformer_lm as tlm
    small = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_len=32)
    for tied in (False, True):
        jcfg = jlm.TransformerLMConfig(**small, tied_output=tied, dtype=jnp.float32)
        _, params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        batch = jlm.synthetic_batch(jcfg, 2, 8)
        jspec = JModelSpec.from_loss_fn(jlm.make_loss_fn(jlm.TransformerLM(jcfg)), params,
                                        batch)
        tcfg = tlm.TransformerLMConfig(**small, tied_output=tied, dtype=torch.float32)
        tspec = ModelSpec.from_loss_fn(tlm.make_loss_fn(tlm.TransformerLM(tcfg)),
                                       from_jax_params(jax.device_get(params)), batch)
        assert {n: (p.sparse, p.index_leaf) for n, p in tspec.params.items()} == \
            {n: (p.sparse, p.index_leaf) for n, p in jspec.params.items()}
    spec = ModelSpec({"e": torch.zeros(4, 2)}, sparse_names=["e"], index_leaves={"e": "ids"})
    assert spec["e"].index_leaf == "ids"


def test_unported_parts_raise_naming_their_roadmap_item():
    """Async PS is ported: its plans run the async runner, and nothing falls
    back to AllReduce. ``ExpertParallel`` and ``Pipeline`` are ported: they
    build, and refuse what the JAX builders refuse. The autotuner is ported:
    ``"autotune"`` is accepted, and any other name refused."""
    from autodist_tpu_torch.parallel.staleness import AsyncPSRunner
    _, spec = _models(sparse=False)
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    for builder, bound in ((tstrategy.PS(sync=False), 0),
                           (tstrategy.PSLoadBalancing(staleness=1), 1)):
        ad = AutoDist(resource_info={"nodes": [{"address": "localhost", "gpus": [0]}]},
                      strategy_builder=builder, device="cpu")
        runner = ad.create_distributed_session(lambda p, b: p["s"], params,
                                               lambda p: torch.optim.SGD(p, lr=0.1))
        assert isinstance(runner, AsyncPSRunner) and runner.staleness == bound
    for builder in (tstrategy.ExpertParallel(num_experts=2), tstrategy.Pipeline(n_stages=2)):
        built = builder.build(spec, ResourceSpec(resource_info=RESOURCES["8"]))
        assert [n.var_name for n in built.node_config] == spec.names
    with pytest.raises(ValueError, match="num_experts must be >= 2"):
        tstrategy.ExpertParallel(num_experts=1)
    with pytest.raises(ValueError, match="n_stages must be >= 2"):
        tstrategy.Pipeline(n_stages=1)
    tuned = AutoDist(strategy_builder="autotune", device="cpu")
    assert tuned._autotune and tuned._tuned_plan is None
    with pytest.raises(ValueError):
        AutoDist(strategy_builder="fastest", device="cpu")
    np.testing.assert_equal(spec.names, ["b", "emb", "s", "w1", "w2"])
