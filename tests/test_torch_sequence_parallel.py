"""The port's sequence-parallel training path (SequenceParallel,
autodist_tpu_torch.parallel.sequence, the ring model) against the JAX
package's, with one set of weights fed to both through ``from_jax_params``.

JAX runs the sequence-parallel loss inside ``shard_map`` on the 8-device CPU
mesh ({seq: 2, data: 4}) and is imported inside the test functions only.
The port runs it over 2 gloo ranks, all multi-rank cases in one spawn:
each child runs this file as a script (``_worker``), imports torch and the
port only, joins the group through the port's own bootstrap, and writes
what it computed for the parent to compare; rank 0 also runs the
long-context entry point with ``--seq_axis 2``.

Everything is f32. Tolerances: the loss rtol 1e-5 and its gradients rtol
2e-4 / atol 2e-5 (tests/test_sequence_parallel.py:40-63: the same math in
two summation orders); after 2 Adam steps the losses rtol 1e-4 and the
params atol 1e-5, as tests/test_torch_autodist.py holds the AllReduce path
(Adam's normalised update amplifies the order where a gradient is near 0).
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

from autodist_tpu_torch import AutoDist, SequenceParallel, from_jax_params
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.models import transformer_lm as tlm
from autodist_tpu_torch.parallel import multihost, sequence, synchronization
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runner import step_function
from autodist_tpu_torch.utils import device as device_util
from test_torch_ring_attention import join_gloo_group, ranks_running

SMALL = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32)
BATCH, SEQ, RANKS, STEPS = 4, 32, 2, 2
ONE_GPU = {"nodes": [{"address": "localhost", "gpus": [0]}]}
TWO_GPUS = {"nodes": [{"address": "localhost", "gpus": [0, 1]}]}
LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
HEADS = ("logits", "fused")


def _config(module, dtype, head, attention_impl="ring"):
    return module.TransformerLMConfig(**SMALL, dtype=dtype, tied_output=False,
                                      fused_head=head == "fused",
                                      attention_impl=attention_impl)


def _tokens(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, SMALL["vocab_size"], size=(BATCH, SEQ + 1)).astype(np.int32)


def _adam(p):
    return torch.optim.Adam(p, lr=1e-3, eps=1e-8)


# ------------------------------------------------------------------ the ranks

def _worker(workdir: pathlib.Path):
    import torch.distributed as dist
    join_gloo_group()
    rank = dist.get_rank()
    params = {k: torch.tensor(v) for k, v in np.load(workdir / "params.npz").items()}
    batch = {"tokens": torch.tensor(np.load(workdir / "tokens.npz")["tokens"])}
    results = {}
    for head in HEADS:
        model = tlm.TransformerLM(_config(tlm, torch.float32, head))
        ad = AutoDist(resource_info=TWO_GPUS, strategy_builder=SequenceParallel(RANKS),
                      device="cpu")
        runner = sequence.create_sequence_parallel_session(ad, model, params, _adam)
        grad_fn = synchronization.make_grad_fn(
            runner.plan, ModelSpec(params), runner.mesh,
            sequence.make_sequence_parallel_loss_fn(model, dist.group.WORLD))
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        grads, loss, _ = grad_fn(leaves, batch)
        results[f"{head}-loss"] = loss.numpy()
        results.update({f"{head}-grad-{k}": g.numpy() for k, g in grads.items()})
        # Adam steps through the session, as a user drives it.
        step = step_function(runner, params)
        results[f"{head}-losses"] = np.array([float(step(batch)) for _ in range(STEPS)])
        results.update({f"{head}-param-{k}": v.detach().numpy()
                        for k, v in step.get_state().params.items()})
    # The world (2 ranks) must be the mesh's device count (1).
    one = AutoDist(resource_info=ONE_GPU, strategy_builder=SequenceParallel(1), device="cpu")
    model = tlm.TransformerLM(_config(tlm, torch.float32, "fused"))
    try:
        sequence.create_sequence_parallel_session(one, model, params, _adam)
        results["world-check"] = np.array("no error")
    except RuntimeError as e:
        results["world-check"] = np.array(str(e))
    np.savez(workdir / f"sp_rank{rank}.npz", **results)

    from autodist_tpu_torch.examples import long_context_lm
    long_context_lm.main(["--device", "cpu", "--seq_axis", "2", "--seq_len", "32",
                          "--batch_size", "2", "--d_model", "32", "--n_layers", "1",
                          "--vocab", "64", "--steps", "1"])
    dist.destroy_process_group()


@functools.cache
def _jax_params():
    import jax
    from autodist_tpu.models import transformer_lm as jlm
    cfg = _config(jlm, np.float32, "logits")
    return jax.device_get(jlm.init_params(cfg, jax.random.PRNGKey(5))[1])


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """The 2-rank run, started at once; calling it waits for the ranks and
    returns ``({key: array} of rank 0, {key: array} of rank 1, [rank 0's
    output, rank 1's output])``."""
    workdir = tmp_path_factory.mktemp("sp")
    flat = {k: v.numpy() for k, v in from_jax_params(_jax_params()).items()}
    np.savez(workdir / "params.npz", **flat)
    np.savez(workdir / "tokens.npz", tokens=_tokens())
    with ranks_running(pathlib.Path(__file__), RANKS, "sp", workdir) as wait:

        @functools.cache
        def results():
            logs = wait()
            ranks = [dict(np.load(workdir / f"sp_rank{r}.npz")) for r in range(RANKS)]
            return ranks[0], ranks[1], logs

        yield results


def _jax_mesh():
    from autodist_tpu.parallel.mesh import build_mesh
    return build_mesh(axes={"seq": RANKS, "data": 8 // RANKS})


@pytest.mark.parametrize("head", HEADS)
def test_two_rank_loss_and_grads_match_jax(sp_runs, head):
    """The loss and the synchronized gradients on each of 2 ranks against
    JAX ``make_sequence_parallel_loss_fn`` on the mesh, logits and fused
    head; both ranks hold the same numbers."""
    import jax
    import jax.numpy as jnp
    from autodist_tpu.models import transformer_lm as jlm
    from autodist_tpu.parallel.sequence import make_sequence_parallel_loss_fn

    jmodel = jlm.TransformerLM(_config(jlm, jnp.float32, head))
    mesh = _jax_mesh()
    loss_fn = make_sequence_parallel_loss_fn(jmodel, mesh)
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            _jax_params(), {"tokens": jnp.asarray(_tokens())})
    want = from_jax_params(jax.device_get(grads))
    for got in sp_runs()[:2]:
        np.testing.assert_allclose(got[f"{head}-loss"], float(loss), **LOSS)
        for key, g in want.items():
            np.testing.assert_allclose(got[f"{head}-grad-{key}"], g.numpy(), err_msg=key,
                                       **GRAD)


@pytest.mark.parametrize("head", HEADS)
def test_two_rank_adam_steps_track_jax_session(sp_runs, head):
    """``create_sequence_parallel_session`` on both sides, 2 Adam(1e-3) steps."""
    import jax
    import jax.numpy as jnp
    import optax
    from autodist_tpu import AutoDist as JAutoDist
    from autodist_tpu.models import transformer_lm as jlm
    from autodist_tpu.parallel.sequence import create_sequence_parallel_session
    from autodist_tpu.strategy import SequenceParallel as JSequenceParallel

    jmodel = jlm.TransformerLM(_config(jlm, jnp.float32, head))
    runner = create_sequence_parallel_session(
        JAutoDist(strategy_builder=JSequenceParallel(seq_axis_size=RANKS)), jmodel,
        _jax_params(), optax.adam(1e-3))
    state = runner.init(_jax_params())
    losses = []
    for _ in range(STEPS):
        state, loss = runner.run(state, {"tokens": _tokens()})
        losses.append(float(loss))
    want = from_jax_params(jax.device_get(runner.logical_params(state)))
    for got in sp_runs()[:2]:
        np.testing.assert_allclose(got[f"{head}-losses"], losses, rtol=1e-4)
        for key, p in want.items():
            np.testing.assert_allclose(got[f"{head}-param-{key}"], p.numpy(), atol=1e-5,
                                       rtol=0, err_msg=key)


def test_two_rank_example_and_world_check(sp_runs):
    """``long_context_lm --seq_axis 2`` over the 2 ranks prints its result
    line on rank 0 only; a mesh of one device under a 2-rank world raises."""
    rank0, rank1, logs = sp_runs()
    assert "long-context seq=32 bs=2 attention=ring remat=True" in logs[0]
    assert "'seq': 2" in logs[0] and "mfu not measured" in logs[0]
    assert "long-context" not in logs[1]
    for ranks in (rank0, rank1):
        assert "1 devices but 2 processes" in str(ranks["world-check"])


# ------------------------------------------------------------ one process

def test_one_rank_session_equals_the_flash_model():
    """``SequenceParallel(seq_axis_size=1)`` on one device, the path the
    card runs: a ring of one with no group, whose loss is the flash
    model's, and whose session trains."""
    params = from_jax_params(_jax_params())
    batch = {"tokens": torch.tensor(_tokens())}
    ring = tlm.TransformerLM(_config(tlm, torch.float32, "fused"))
    flash = tlm.TransformerLM(_config(tlm, torch.float32, "fused", attention_impl="flash"))
    ad = AutoDist(resource_info=ONE_GPU, strategy_builder=SequenceParallel(1), device="cpu")
    runner = sequence.create_sequence_parallel_session(ad, ring, params, _adam)
    assert runner.plan.seq_size == 1 and runner.plan.dp_size == 1
    want = float(tlm.make_loss_fn(flash)(params, batch))
    assert float(sequence.make_sequence_parallel_loss_fn(ring)(params, batch)) == \
        pytest.approx(want, rel=1e-6)
    step = step_function(runner, params)
    losses = [float(step(batch)) for _ in range(3)]
    assert losses[0] == pytest.approx(want, rel=1e-6) and losses[-1] < losses[0]


def test_seq_axis_without_a_process_group_raises():
    """A mesh that asks for 2 seq ranks never carries on alone."""
    params = from_jax_params(_jax_params())
    model = tlm.TransformerLM(_config(tlm, torch.float32, "fused"))
    ad = AutoDist(resource_info=TWO_GPUS, strategy_builder=SequenceParallel(2), device="cpu")
    with pytest.raises(RuntimeError, match="seq axis has 2 ranks but the seq group has 1"):
        sequence.create_sequence_parallel_session(ad, model, params, _adam)
    four = {"nodes": [{"address": "localhost", "gpus": [0, 1, 2, 3]}]}
    ad = AutoDist(resource_info=four, strategy_builder=SequenceParallel(2), device="cpu")
    with pytest.raises(RuntimeError, match="data axes have 2 ranks but the data group has 1"):
        sequence.create_sequence_parallel_session(ad, model, params, _adam)


def test_loss_errors_match_jax(monkeypatch):
    """The indivisible-sequence and beyond-max_len errors, checked on the
    global sequence before any shard runs, with the JAX package's words."""
    from autodist_tpu.models import transformer_lm as jlm
    from autodist_tpu.parallel.sequence import make_sequence_parallel_loss_fn

    jloss = make_sequence_parallel_loss_fn(jlm.TransformerLM(_config(jlm, np.float32, "logits")),
                                           _jax_mesh())
    # A stand-in ring of 2: both errors are raised before any send.
    monkeypatch.setattr(sequence, "ring_size_and_rank", lambda group: (2, 0))
    tloss = sequence.make_sequence_parallel_loss_fn(
        tlm.TransformerLM(_config(tlm, torch.float32, "logits")), group=None)
    for length, match in ((SEQ - 1, "not divisible by the seq axis"),
                          (SEQ + 2, "exceeds the model's max_len")):
        tokens = np.zeros((BATCH, length + 1), np.int32)
        with pytest.raises(ValueError, match=match) as want:
            jloss(_jax_params(), {"tokens": tokens})
        with pytest.raises(ValueError) as got:
            tloss(from_jax_params(_jax_params()), {"tokens": torch.tensor(tokens)})
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seq_axis_size", [2, -1, 1])
def test_strategy_matches_jax(seq_axis_size):
    from google.protobuf.json_format import MessageToDict

    from autodist_tpu.model_spec import ModelSpec as JModelSpec
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    from autodist_tpu.strategy import SequenceParallel as JSequenceParallel

    four = {"nodes": [{"address": "localhost", "gpus": [0, 1, 2, 3]}]}
    want = MessageToDict(JSequenceParallel(seq_axis_size, chunk_size=5).build(
        JModelSpec(_jax_params()), JResourceSpec(resource_info=four)).proto,
        preserving_proto_field_name=True)
    got = SequenceParallel(seq_axis_size, chunk_size=5).build(
        ModelSpec(from_jax_params(_jax_params())), ResourceSpec(resource_info=four)).to_dict()
    want.pop("id"), got.pop("id")    # build timestamps
    assert got == want


@pytest.mark.parametrize("kwargs,n_gpus", [
    (dict(seq_axis_size=0), 4), (dict(seq_axis_size=-2), 4),
    (dict(compressor="bf16"), 4), (dict(chunk_size=0), 4),
    (dict(all_reduce_spec="nope"), 4), (dict(seq_axis_size=3), 4)])
def test_strategy_errors_match_jax(kwargs, n_gpus):
    from autodist_tpu.model_spec import ModelSpec as JModelSpec
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    from autodist_tpu.strategy import SequenceParallel as JSequenceParallel

    info = {"nodes": [{"address": "localhost", "gpus": list(range(n_gpus))}]}
    with pytest.raises(ValueError) as want:
        JSequenceParallel(**kwargs).build(JModelSpec(_jax_params()),
                                          JResourceSpec(resource_info=info))
    with pytest.raises(ValueError) as got:
        SequenceParallel(**kwargs).build(ModelSpec(from_jax_params(_jax_params())),
                                         ResourceSpec(resource_info=info))
    assert str(got.value) == str(want.value)


def test_device_and_process_group_from_torchrun_env(monkeypatch):
    """One process per card: the default device is cuda:$LOCAL_RANK; a world
    of one joins no group; an incomplete environment raises."""
    for name in ("LOCAL_RANK", "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="device cuda:0 was asked for"):
        device_util.resolve_device()
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(RuntimeError, match="device cuda:3 was asked for"):
        device_util.resolve_device()
    assert device_util.resolve_device("cpu") == torch.device("cpu")
    assert not multihost.maybe_initialize_multihost(torch.device("cpu"))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        multihost.maybe_initialize_multihost(torch.device("cpu"))
    assert not torch.distributed.is_initialized()


if __name__ == "__main__":
    if sys.argv[1] == "sp":
        _worker(pathlib.Path(sys.argv[2]))
