"""The port's wire codec against the JAX package's
(``autodist_tpu/parallel/wire.py``): frames byte for byte, each side
decoding the other's, quantize, the push compressor, and the receive pool's
aliasing rule. Everything here is exact (no tolerance): the codec moves
bytes."""

import socket

import ml_dtypes
import numpy as np
import pytest
import torch

from autodist_tpu.parallel import ps_transport as jax_transport
from autodist_tpu.parallel import synchronization as jax_sync
from autodist_tpu.parallel import wire as jax_wire
from autodist_tpu_torch.parallel import ps_transport as transport
from autodist_tpu_torch.parallel import synchronization as sync
from autodist_tpu_torch.parallel import wire

_RNG = np.random.default_rng(0)
_F32 = _RNG.standard_normal((3, 5)).astype(np.float32)


def _arrays():
    return {
        "f32": _F32,
        "f16": _RNG.standard_normal((4, 3)).astype(np.float16),
        "bf16": _RNG.standard_normal((2, 3, 2)).astype(ml_dtypes.bfloat16),
        "i32": np.arange(7, dtype=np.int32) - 3,
        "i64": np.array([[1 << 40, -5]], np.int64),
        "u8": np.arange(2000, dtype=np.uint8),          # borrowed by encode_parts
        "bool": np.array([True, False, True]),
        "scalar": np.array(2.5, np.float32),             # 0-d
        "empty": np.zeros((0, 4), np.float32),
    }


CASES = {
    "scalars": {"n": None, "t": True, "f": False, "i": -7, "big": 1 << 70, "x": 2.5,
                "s": "héllo", "b": b"\x00\x01"},
    "containers": [1, (2, [3, {"k": "v"}]), {7: None}, ()],
    "arrays": _arrays(),
    "nested": ("ok", {"params": _arrays(), "version": 3}, [_F32, (_F32[0],)]),
}


def _to_torch(x):
    """The numpy/ml_dtypes tree as torch tensors (what the port sends)."""
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_torch(v) for v in x)
    if isinstance(x, np.ndarray):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(x.copy())
    return x


def _assert_same(got, want):
    """A port-decoded tree (tensors) equals a numpy tree, dtype and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, torch.Tensor)
        assert wire.dtype_name(got.dtype) == str(want.dtype)
        assert tuple(got.shape) == want.shape
        assert wire._raw(got.contiguous()).tobytes() == want.tobytes()
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_frames_match_the_jax_codec_both_ways(case):
    """``encode`` and ``encode_parts`` give the JAX package's bytes; each
    side decodes the other's frames to equal values (copying and aliasing)."""
    obj = CASES[case]
    theirs = jax_wire.encode(obj)
    ours = wire.encode(_to_torch(obj))
    assert ours == theirs
    assert b"".join(bytes(p) for p in wire.encode_parts(_to_torch(obj))) == theirs
    for copy in (True, False):
        _assert_same(wire.decode(bytearray(theirs), copy=copy), obj)
    back = jax_wire.decode(ours)
    assert jax_wire.encode(back) == theirs


def test_encode_parts_borrows_large_tensors():
    """A large CPU tensor rides as a view of its own memory, no copy."""
    t = torch.arange(4096, dtype=torch.float32)
    parts = wire.encode_parts(("apply", {"g": t}))
    borrowed = [p for p in parts if isinstance(p, memoryview)]
    assert len(borrowed) == 1
    assert np.frombuffer(borrowed[0], np.uint8).ctypes.data == t.data_ptr()


@pytest.mark.parametrize("wire_dtype,shape,scale", [
    ("int8", (16, 32), 3.0), ("int8", (5, 4), 1.0), ("int8", (7,), 2.0),
    ("int8", (0, 8), 1.0), ("fp16", (8, 8), 1.0), ("fp16", (4, 4), 1e5),
    ("bf16", (8, 16), 1.0)])
def test_quantize_matches_jax(wire_dtype, shape, scale):
    """Per-row and per-tensor int8, fp16 with and without overflow, bf16 and
    an empty tensor: the same frame bytes, and the same dequantized values
    when each side decodes the other's."""
    x = (_RNG.standard_normal(shape) * scale).astype(np.float32)
    if wire_dtype == "int8" and len(shape) == 2 and shape[0]:
        x[1] = 0.0   # an all-zero row stores scale 0
    theirs = jax_wire.encode(jax_wire.quantize(x, wire_dtype))
    ours = wire.encode(wire.quantize(torch.from_numpy(x), wire_dtype))
    assert ours == theirs
    np.testing.assert_array_equal(wire.decode(theirs).numpy(), jax_wire.decode(ours))
    np.testing.assert_array_equal(
        wire.dequantize(wire.quantize(torch.from_numpy(x), wire_dtype)).numpy(),
        jax_wire.dequantize(jax_wire.quantize(x, wire_dtype)))


def test_sparse_rows_and_push_compressor_match_jax():
    """``SparseRows`` under the JAX key, the compressor's output frames
    (sparse, int8 with error feedback over two pushes, bypass) and
    ``densify_sparse_rows`` equal the JAX package's."""
    table = _RNG.standard_normal((64, 8)).astype(np.float32)
    dense = _RNG.standard_normal((32, 64)).astype(np.float32)
    bias = _RNG.standard_normal((8,)).astype(np.float32)
    batch = {"ids": np.array([[3, 7, 3], [-1, 63, 7]], np.int32)}
    kw = dict(min_bytes=0, sparse_params={"table": "ids"})
    theirs_c = jax_sync.WirePushCompressor("int8", **kw)
    ours_c = sync.WirePushCompressor("int8", **kw)
    for scale in (1.0, 0.5):
        # Keys in sorted order: jax's tree_map rebuilds a dict sorted.
        grads = {"bias": bias, "dense": dense * scale, "table": table * scale}
        theirs, t_sparse = theirs_c.compress(grads, batch=batch)
        ours, o_sparse = ours_c.compress(_to_torch(grads), batch=batch)
        assert t_sparse and o_sparse
        assert wire.encode(ours) == jax_wire.encode(theirs)
        assert (ours_c.bytes_in, ours_c.bytes_out, ours_c.bytes_saved) == \
            (theirs_c.bytes_in, theirs_c.bytes_out, theirs_c.bytes_saved)
    decoded = wire.decode(jax_wire.encode(theirs))
    assert isinstance(decoded["table"], sync.SparseRows)
    np.testing.assert_array_equal(sync.densify_sparse_rows(decoded)["table"].numpy(),
                                  jax_sync.densify_sparse_rows(theirs)["table"])


def test_malformed_frames_raise_wire_error():
    good = wire.encode({"a": torch.ones(3)})
    for bad in (good[:-1], good + b"x", b"Z", b"a\x00\x00\x00\x05nope!",
                b"o" + jax_wire.encode("no.such:Class")[1:] + b"\x00\x00\x00\x00"):
        with pytest.raises(wire.WireError):
            wire.decode(bad)


def test_decoded_tensor_held_across_the_next_receive_stays_unchanged():
    """A tensor decoded (aliasing) from one message and kept survives the
    next message into the same pool: the pool sees the alias and takes a
    fresh buffer; once the tensor is dropped, the buffer is recycled."""
    a, b = socket.socketpair()
    try:
        pool = transport._RecvBuffer()
        transport._send_payload(a, wire.encode_parts(("apply", {"g": torch.full((512,), 1.0)})))
        first, _ = transport._recv_msg(b, pool=pool)
        held = first[1]["g"]
        transport._send_payload(a, wire.encode_parts(("apply", {"g": torch.full((512,), 2.0)})))
        second, _ = transport._recv_msg(b, pool=pool)
        assert torch.equal(held, torch.full((512,), 1.0))
        assert torch.equal(second[1]["g"], torch.full((512,), 2.0))
        assert pool.fresh_allocs == 2 and pool.recycles == 0
        del first, held, second
        transport._send_payload(a, wire.encode_parts(("version",)))
        transport._recv_msg(b, pool=pool)
        assert pool.recycles == 1
        # The JAX package's pool applies the same rule to its numpy aliases.
        jpool = jax_transport._RecvBuffer()
        jax_transport._send_payload(a, jax_wire.encode_parts(("x", np.ones(512, np.float32))))
        kept, _ = jax_transport._recv_msg(b, pool=jpool)
        jax_transport._send_payload(a, jax_wire.encode_parts(("x", np.zeros(512, np.float32))))
        jax_transport._recv_msg(b, pool=jpool)
        assert jpool.fresh_allocs == 2 and float(kept[1].sum()) == 512.0
    finally:
        a.close()
        b.close()
