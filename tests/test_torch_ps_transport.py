"""The port's PS transport against the JAX package's, on loopback in one
process: a port client (``RemotePSWorker``) against a JAX ``PSServer`` and a
JAX client against the port's ``PSServer``, over the native plane and the
Python one; the telemetry opcodes; and a port worker stepping over the
transport against the in-process one."""

import numpy as np
import pytest
import torch

from autodist_tpu.parallel import ps_transport as jax_transport
from autodist_tpu.parallel import staleness as jax_staleness
from autodist_tpu.parallel import synchronization as jax_sync
from autodist_tpu.runner import TrainState as JaxTrainState
from autodist_tpu_torch import AutoDist
from autodist_tpu_torch.parallel import ps_transport as transport
from autodist_tpu_torch.parallel import staleness
from autodist_tpu_torch.parallel import synchronization as sync
from autodist_tpu_torch.runner import TrainState
from autodist_tpu_torch.strategy import PS

LR = 0.1
W0 = np.arange(32, dtype=np.float32).reshape(8, 4) / 10
B0 = np.ones(4, np.float32)
G = np.linspace(-1.0, 1.0, 32, dtype=np.float32).reshape(8, 4)
ROWS = np.array([1, 6], np.int64)


class _JaxStub:
    """A JAX chief runner with a plain SGD apply (as bench.py's stub)."""

    def __init__(self):
        state = JaxTrainState(step=np.zeros((), np.int32), params={"b": B0, "w": W0},
                              opt_state=(), ef_state=())
        self.service = jax_staleness.ParameterService(state, lambda s, g: JaxTrainState(
            step=s.step + 1, params={k: v - np.float32(LR) * g[k] if k in g else v
                                     for k, v in s.params.items()},
            opt_state=(), ef_state=()))
        self.controller = jax_staleness.StalenessController(1, staleness=1)

    def add_worker(self, worker_id=None, with_generation=False):
        wid, gen = self.controller.register_with_generation(worker_id)
        handle = type("H", (), {"worker_id": wid})()
        return (handle, gen) if with_generation else handle


class _PortStub(_JaxStub):
    """The same on the port's service and controller."""

    def __init__(self):
        state = TrainState(step=0, params={"b": torch.from_numpy(B0.copy()),
                                           "w": torch.from_numpy(W0.copy())}, optimizer=None)
        self.service = staleness.ParameterService(state, lambda s, g: TrainState(
            step=s.step + 1, params={k: v - LR * g[k] if k in g else v
                                     for k, v in s.params.items()}, optimizer=None))
        self.controller = staleness.StalenessController(1, staleness=1)


def _script(call, grads, sparse):
    """The protocol's opcodes in order; what each replied, host arrays."""
    host = lambda t: None if t is None else {k: np.asarray(v) for k, v in t.items()}  # noqa: E731
    out = [call("register", 0)[0], call("wire_caps")[0]]
    params, _, version = call("read")
    out.append((host(params), version))
    out.append(call("read_if_newer", version))
    out.append(call("start_step", 0, None))
    out.append(call("apply", grads))
    out.append(call("finish_step", 0))
    params, _, version = call("read_if_newer", 0)
    out.append((host(params), version))
    out.append(call("apply_sparse", sparse))
    params, _, version = call("read_min", 2, -1, 5.0)
    out.append((host(params), version))
    out.append(call("version"))
    stats = call("stats")[0]
    out.append(sorted(k for k in stats if k in ("wire", "uptime_s", "per_worker")))
    return out


def _assert_same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-7)
    else:
        assert got == want


@pytest.mark.parametrize("native", [True, False])
def test_port_and_jax_endpoints_serve_each_other(native, monkeypatch):
    """Port client -> JAX server and JAX client -> port server run the same
    opcodes (register, read, read_if_newer, read_min, apply, apply_sparse,
    wire_caps, version, stats, the gate): the replies, versions and
    parameters agree (SGD in f32 on both sides, rtol 1e-6), and match the
    plain update."""
    monkeypatch.setenv("AUTODIST_NATIVE_TRANSPORT", "1" if native else "0")
    monkeypatch.setattr(transport, "_TR_LIB", None)
    monkeypatch.setattr(transport, "_TR_OFF", False)
    runs = []
    jax_server = jax_transport.PSServer(_JaxStub(), watchdog=False)
    client = transport.RemotePSWorker("%s:%d" % jax_server.address, runner=None, worker_id=0,
                                      overlap=False, compressor=sync.WirePushCompressor(""))
    try:
        runs.append(_script(client._client.call, {"w": torch.from_numpy(G)},
                            {"w": sync.SparseRows(torch.from_numpy(ROWS),
                                                  torch.from_numpy(G[ROWS]), (8, 4))}))
    finally:
        client.close()
        jax_server.close()
    port_server = transport.PSServer(_PortStub(), watchdog=False)
    jclient = jax_transport._PSClient("%s:%d" % port_server.address)
    try:
        jclient.call("register", 0)   # as RemotePSWorker does up front
        runs.append(_script(jclient.call, {"w": G},
                            {"w": jax_sync.SparseRows(ROWS, G[ROWS], (8, 4))}))
    finally:
        jclient.close()
        port_server.close()
    assert (transport.native_bytes()[0] > 0) or not native
    _assert_same(runs[0], runs[1])
    w2 = W0 - np.float32(LR) * G
    w2[ROWS] -= np.float32(LR) * G[ROWS]
    _assert_same(runs[0][-3][0], {"b": B0, "w": w2})
    assert [r[1] for r in (runs[0][2], runs[0][7], runs[0][9])] == [0, 1, 2]


def test_telemetry_opcodes_get_the_unknown_op_frame_naming_their_item():
    server = transport.PSServer(_PortStub(), watchdog=False)
    jclient = jax_transport._PSClient("%s:%d" % server.address)
    client = transport._PSClient("%s:%d" % server.address)
    try:
        for op in ("trace", "push_trace", "reqtrace", "record"):
            reply = jclient.call_raw((op,), jclient.wire)
            assert reply[:2] == ("error", "PSClientError")
            assert "unknown op" in reply[2] and "Queue 1 item 7" in reply[2]
            with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
                client.call(op)
        assert jclient.call("ping", 5)[0] == 5
    finally:
        client.close()
        jclient.close()
        server.close()


def _loss(p, b):
    return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()


def _batch(i):
    r = np.random.RandomState(i)
    x = r.randn(16, 8).astype(np.float32)
    return {"x": x, "y": x.sum(1, keepdims=True).astype(np.float32)}


def _runner(address=None, workers=1):
    ad = AutoDist(resource_info={"nodes": [{"address": "localhost", "gpus": [0]}]},
                  strategy_builder=PS(sync=False), device="cpu")
    runner = ad.create_distributed_session(
        _loss, {"w": torch.zeros(8, 1), "b": torch.zeros(1)},
        lambda p: torch.optim.Adam(p, lr=0.1), num_workers=workers)
    runner._ps_address = address
    return runner


@pytest.mark.parametrize("overlap,wire_dtype", [(True, ""), (False, ""), (True, "bf16")])
def test_remote_worker_over_the_transport_equals_the_in_process_one(overlap, wire_dtype):
    """A port worker stepping over the transport (f32, with and without the
    prefetch overlap) gives the in-process worker's parameters bit for bit;
    a bf16 push (quantized frames) stays within rtol 1e-2 of them."""
    params = {"w": torch.linspace(-1, 1, 8).reshape(8, 1), "b": torch.zeros(1)}
    chief = _runner("127.0.0.1:0", workers=2)
    chief.init(params)
    worker = _runner()
    worker.init(params)
    remote = transport.RemotePSWorker("%s:%d" % chief._ps_server.address, worker, worker_id=1,
                                      overlap=overlap, wire_dtype=wire_dtype)
    remote._compressor and setattr(remote._compressor, "min_bytes", 0)
    reference = _runner()
    state = reference.init(params)
    try:
        for i in range(3):
            remote.step(_batch(i))
            state, _ = reference.run(state, _batch(i))
        assert chief.service.updates_applied == 3
        assert bool(wire_dtype) == (remote._compressor is not None
                                    and remote._compressor.bytes_out > 0)
        got = chief.service.state.params
        for k in params:
            if wire_dtype:
                torch.testing.assert_close(got[k], state.params[k], rtol=1e-2, atol=1e-3)
            else:
                assert torch.equal(got[k], state.params[k])
    finally:
        remote.close()
        chief.close()
