"""Typed binary wire codec for the PS transport (the port's copy of
``autodist_tpu/parallel/wire.py``), byte-compatible with the JAX package's:
a torch worker and a JAX chief read each other's frames.

The vocabulary is the protocol's and nothing more, so decoding executes
nothing:

- ``None``/bool/int/float/str/bytes, tuple/list/dict;
- tensors (tag ``a``): dtype name, shape, raw C-order bytes. The encoder
  takes CPU torch tensors (viewed, never copied), CUDA tensors (copied to
  the host once) and numpy arrays and scalars; bf16 rides under the name
  ``bfloat16`` as its raw 16-bit words, which is what the JAX package's
  ``ml_dtypes`` frames hold, so no ``ml_dtypes`` is needed on either side
  of the port. The decoder returns CPU torch tensors;
- quantized tensors (tag ``q``, :class:`QuantizedArray`): original dtype,
  payload dtype, shape, a float32 scale section (one scale, or one a row)
  and the low-precision payload. Decode dequantizes to a fresh dense tensor
  of the original dtype;
- registered dataclasses (tag ``o``), built only through the registry, under
  the same keys as the JAX package's.

:func:`encode` returns one ``bytes``; :func:`encode_parts` returns a
scatter-gather list of buffers whose concatenation is the same bytes, with
large tensor payloads as borrowed views of the tensors' own memory.
``decode(buf, copy=False)`` aliases tensor payloads into ``buf``
(``torch.frombuffer``): each tensor holds a reference to the buffer, which
is what the transport's receive pool (``ps_transport._RecvBuffer``) counts
before it reuses a buffer.
"""

import dataclasses
import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["encode", "encode_parts", "decode", "register_wire_dataclass",
           "WireError", "QuantizedArray", "quantize", "dequantize", "WIRE_DTYPES"]


class WireError(ValueError):
    """Malformed or out-of-vocabulary wire data."""


_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
_u32 = struct.Struct("!I")
_u64 = struct.Struct("!Q")
_i64 = struct.Struct("!q")
_f64 = struct.Struct("!d")

_REGISTRY: Dict[str, Tuple[type, Tuple[str, ...]]] = {}
_CLS_KEY: Dict[type, str] = {}


def register_wire_dataclass(cls: type, key: str = None) -> type:
    """Allow dataclass ``cls`` across the wire under ``key`` (default
    ``module:qualname``; the port passes the JAX package's key where the
    two must agree). Both endpoints must register it."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls!r} is not a dataclass")
    key = key or f"{cls.__module__}:{cls.__qualname__}"
    _REGISTRY[key] = (cls, tuple(f.name for f in dataclasses.fields(cls)))
    _CLS_KEY[cls] = key
    return cls


# ---------------------------------------------------------------------- dtypes

# Wire dtype names (numpy's, as the JAX package writes them) <-> torch dtypes.
_TORCH_BY_NAME = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_NAME_BY_TORCH = {v: k for k, v in _TORCH_BY_NAME.items()}
for _name, _dtype in (("uint16", "uint16"), ("uint32", "uint32"), ("uint64", "uint64"),
                      ("float8_e4m3fn", "float8_e4m3fn"), ("float8_e5m2", "float8_e5m2")):
    if hasattr(torch, _dtype):
        _TORCH_BY_NAME[_name] = getattr(torch, _dtype)
        _NAME_BY_TORCH[getattr(torch, _dtype)] = _name


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire dtype name; ``WireError`` for an unknown one."""
    dtype = _TORCH_BY_NAME.get(name)
    if dtype is None:
        raise WireError(f"unknown array dtype {name!r}")
    return dtype


def dtype_name(dtype: torch.dtype) -> str:
    name = _NAME_BY_TORCH.get(dtype)
    if name is None:
        raise WireError(f"torch dtype {dtype} has no wire name")
    return name


def _host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host, dense and C-contiguous: a CUDA tensor is copied
    once; a contiguous CPU tensor is returned as it is."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.to("cpu")
    if t.is_conj():
        t = t.resolve_conj()
    return t.contiguous()


def _raw(t: torch.Tensor) -> np.ndarray:
    """A contiguous host tensor's bytes as a flat numpy ``uint8`` view (no copy)."""
    if t.numel() == 0:
        return np.zeros(0, np.uint8)
    return t.reshape(-1).view(torch.uint8).numpy()


# ------------------------------------------------------------------- quantized

WIRE_DTYPES = ("fp16", "bf16", "int8")
_QDTYPE = {"fp16": torch.float16, "bf16": torch.bfloat16, "int8": torch.int8}


class QuantizedArray:
    """A tensor carried in low precision on the wire (tag ``q``): ``qdata``
    the payload in the original shape, ``scale`` a float32 vector of
    dequantization multipliers (1, or one a row), ``dtype`` the original
    dtype the decoder restores. Built by :func:`quantize`."""

    __slots__ = ("qdata", "scale", "dtype")

    def __init__(self, qdata, scale, dtype):
        self.qdata = _host(torch.as_tensor(qdata))
        self.scale = _host(torch.as_tensor(scale, dtype=torch.float32).reshape(-1))
        self.dtype = dtype if isinstance(dtype, torch.dtype) else torch_dtype(str(dtype))
        rows = self.qdata.shape[0] if self.qdata.dim() else 1
        if self.scale.numel() not in (1, rows):
            raise WireError(f"quantized array: {self.scale.numel()} scales for {rows} rows "
                            f"(want 1 or {rows})")

    @property
    def shape(self):
        return tuple(self.qdata.shape)

    @property
    def wire_nbytes(self) -> int:
        """Payload bytes this frame ships (scales and quantized data)."""
        return (self.qdata.numel() * self.qdata.element_size()
                + self.scale.numel() * self.scale.element_size())


def quantize(arr, wire_dtype: str) -> QuantizedArray:
    """Quantize a float tensor for the wire, as the JAX package does: int8
    symmetric with the dequant multiplier ``amax / 127`` per row (axis 0)
    for 2-D+ tensors whose rows span >= 8 elements, per tensor otherwise
    (an all-zero row stores scale 0); fp16 with a per-tensor scale of 1
    unless the tensor overflows float16 (then ``amax / 65504``); bf16 a pure
    cast. Rounding is to nearest even everywhere, as numpy's."""
    t = _host(torch.as_tensor(arr))
    if not t.is_floating_point():
        raise WireError(f"cannot quantize non-float dtype {t.dtype}")
    x = t.to(torch.float32)
    if wire_dtype == "int8":
        if x.numel() == 0:
            rows = x.shape[0] if x.dim() else 1
            return QuantizedArray(torch.zeros(x.shape, dtype=torch.int8),
                                  torch.zeros(max(1, rows)), t.dtype)
        if x.dim() >= 2 and x.numel() // x.shape[0] >= 8:
            amax = x.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True)
        else:
            amax = x.abs().max().reshape((1,) * x.dim())
        scale = (amax / 127.0).to(torch.float32)
        safe = torch.where(scale > 0.0, scale, torch.ones((), dtype=torch.float32))
        q = torch.clamp(torch.round(x / safe), -127.0, 127.0).to(torch.int8)
        return QuantizedArray(q, scale.reshape(-1), t.dtype)
    if wire_dtype not in _QDTYPE:
        raise ValueError(f"unknown wire dtype {wire_dtype!r}; valid: {', '.join(WIRE_DTYPES)}")
    amax = float(x.abs().max()) if x.numel() else 0.0
    scale = 1.0
    if wire_dtype == "fp16" and amax > 65504.0:
        scale = amax / 65504.0
    q = x / torch.tensor(scale, dtype=torch.float32) if scale != 1.0 else x
    return QuantizedArray(q.to(_QDTYPE[wire_dtype]), torch.tensor([scale], dtype=torch.float32),
                          t.dtype)


def _dequantize_raw(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A fresh dense tensor of ``dtype`` (never aliasing ``q``'s buffer)."""
    x = q.to(torch.float32, copy=True)
    scale = scale.to(torch.float32).reshape(-1)
    if scale.numel() == 1:
        if float(scale[0]) != 1.0:
            x *= scale[0]
    else:
        x *= scale.reshape((-1,) + (1,) * max(0, x.dim() - 1))
    return x.to(dtype).contiguous()


def dequantize(qa: QuantizedArray) -> torch.Tensor:
    """The dense tensor a :func:`quantize` frame stands for: what a peer's
    ``decode`` hands its apply path."""
    return _dequantize_raw(qa.qdata, qa.scale, qa.dtype)


# ---------------------------------------------------------------------- encode

# Tensors at or above this many bytes ride as borrowed buffers in
# encode_parts; smaller ones are inlined into the header segment.
_BORROW_MIN_BYTES = 1024


class _PartSink:
    """bytearray-like accumulator that splits out borrowed buffers."""

    __slots__ = ("parts", "tail")

    def __init__(self):
        self.parts: List[Any] = []
        self.tail = bytearray()

    def __iadd__(self, data):
        self.tail += data
        return self

    def borrow(self, view):
        if self.tail:
            self.parts.append(self.tail)
            self.tail = bytearray()
        self.parts.append(view)

    def finish(self) -> List[Any]:
        if self.tail:
            self.parts.append(self.tail)
            self.tail = bytearray()
        return self.parts


def _enc_str(out, s: str):
    b = s.encode("utf-8")
    out += _u32.pack(len(b))
    out += b


def _enc_payload(out, raw: np.ndarray):
    """A flat uint8 payload: length, then the bytes (borrowed when large)."""
    out += _u64.pack(raw.nbytes)
    if type(out) is _PartSink and raw.nbytes >= _BORROW_MIN_BYTES:
        out.borrow(memoryview(raw))
    else:
        out += raw.tobytes()


def _enc_tensor(out, t: torch.Tensor):
    t = _host(t)
    out += b"a"
    _enc_str(out, dtype_name(t.dtype))
    out += bytes([t.dim()])
    for d in t.shape:
        out += _u64.pack(d)
    _enc_payload(out, _raw(t))


def _enc_ndarray(out, arr: np.ndarray):
    if arr.dtype.hasobject:
        raise WireError("object-dtype arrays are not wire-encodable")
    out += b"a"
    _enc_str(out, str(arr.dtype))
    out += bytes([arr.ndim])
    for d in arr.shape:
        out += _u64.pack(d)
    _enc_payload(out, np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _enc(out, obj: Any):
    if obj is None:
        out += b"N"
    elif obj is True:
        out += b"T"
    elif obj is False:
        out += b"F"
    elif type(obj) is int:
        if _I64_MIN <= obj <= _I64_MAX:
            out += b"i"
            out += _i64.pack(obj)
        else:
            out += b"I"
            _enc_str(out, str(obj))
    elif type(obj) is float:
        out += b"f"
        out += _f64.pack(obj)
    elif type(obj) is str:
        out += b"s"
        _enc_str(out, obj)
    elif type(obj) is bytes:
        out += b"b"
        out += _u64.pack(len(obj))
        out += obj
    elif isinstance(obj, torch.Tensor):
        _enc_tensor(out, obj)
    elif type(obj) is QuantizedArray:
        q = obj.qdata
        out += b"q"
        _enc_str(out, dtype_name(obj.dtype))
        _enc_str(out, dtype_name(q.dtype))
        out += bytes([q.dim()])
        for d in q.shape:
            out += _u64.pack(d)
        out += _u32.pack(obj.scale.numel())
        out += obj.scale.numpy().tobytes()
        _enc_payload(out, _raw(q))
    elif isinstance(obj, (np.ndarray, np.generic)):
        _enc_ndarray(out, np.asarray(obj))
    elif type(obj) is tuple:
        out += b"t"
        out += _u32.pack(len(obj))
        for item in obj:
            _enc(out, item)
    elif type(obj) is list:
        out += b"l"
        out += _u32.pack(len(obj))
        for item in obj:
            _enc(out, item)
    elif type(obj) is dict:
        out += b"d"
        out += _u32.pack(len(obj))
        for k, v in obj.items():
            _enc(out, k)
            _enc(out, v)
    elif type(obj) in _CLS_KEY:
        key = _CLS_KEY[type(obj)]
        out += b"o"
        _enc_str(out, key)
        fields = _REGISTRY[key][1]
        out += _u32.pack(len(fields))
        for name in fields:
            _enc_str(out, name)
            _enc(out, getattr(obj, name))
    else:
        raise WireError(f"type {type(obj).__name__} is not wire-encodable; send tensors, "
                        f"numpy arrays or a registered dataclass")


def encode(obj: Any) -> bytes:
    """Serialize a protocol message to bytes."""
    out = bytearray()
    _enc(out, obj)
    return bytes(out)


def encode_parts(obj: Any) -> List[Any]:
    """Serialize a protocol message as a scatter-gather buffer list:
    ``b"".join(encode_parts(obj)) == encode(obj)``. Large tensor payloads are
    borrowed views of the tensors' host memory: do not change the tensors
    until the parts have been sent."""
    sink = _PartSink()
    _enc(sink, obj)
    return sink.finish()


# ---------------------------------------------------------------------- decode

class _Reader:
    __slots__ = ("buf", "pos", "copy")

    def __init__(self, buf, copy: bool = True):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0
        self.copy = copy

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise WireError("truncated wire message")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def u32(self) -> int:
        return _u32.unpack(self.take(4))[0]

    def u64(self) -> int:
        return _u64.unpack(self.take(8))[0]

    def str_(self) -> str:
        return str(self.take(self.u32()), "utf-8")


def _tensor_from(view: memoryview, dtype: torch.dtype, shape, copy: bool) -> torch.Tensor:
    if len(view) == 0:
        return torch.empty(shape, dtype=dtype)
    if copy or view.readonly:
        t = torch.frombuffer(bytearray(view), dtype=dtype)
    else:
        # Aliases the receive buffer: the tensor holds the view, the view its
        # buffer, so the pool sees the buffer in use while the tensor lives.
        t = torch.frombuffer(view, dtype=dtype)
    return t.reshape(shape)


def _dec(r: _Reader) -> Any:
    tag = bytes(r.take(1))
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"i":
        return _i64.unpack(r.take(8))[0]
    if tag == b"I":
        return int(r.str_())
    if tag == b"f":
        return _f64.unpack(r.take(8))[0]
    if tag == b"s":
        return r.str_()
    if tag == b"b":
        return bytes(r.take(r.u64()))
    if tag == b"a":
        dtype = torch_dtype(r.str_())
        ndim = bytes(r.take(1))[0]
        shape = tuple(r.u64() for _ in range(ndim))
        nbytes = r.u64()
        want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if nbytes != want:
            raise WireError(f"array payload {nbytes}B != shape/dtype {want}B")
        return _tensor_from(r.take(nbytes), dtype, shape, r.copy)
    if tag == b"q":
        dtype = torch_dtype(r.str_())
        qdtype = torch_dtype(r.str_())
        ndim = bytes(r.take(1))[0]
        shape = tuple(r.u64() for _ in range(ndim))
        nscales = r.u32()
        rows = shape[0] if ndim else 1
        if nscales not in (1, rows):
            raise WireError(f"quantized frame: {nscales} scales for {rows} row(s) "
                            f"(want 1 or {rows})")
        scale = torch.frombuffer(bytearray(r.take(4 * nscales)), dtype=torch.float32) \
            if nscales else torch.zeros(0)
        nbytes = r.u64()
        want = int(np.prod(shape, dtype=np.int64)) * qdtype.itemsize
        if nbytes != want:
            raise WireError(f"quantized payload {nbytes}B != shape/dtype {want}B")
        q = _tensor_from(r.take(nbytes), qdtype, shape, copy=False)
        return _dequantize_raw(q, scale, dtype)
    if tag == b"t":
        return tuple(_dec(r) for _ in range(r.u32()))
    if tag == b"l":
        return [_dec(r) for _ in range(r.u32())]
    if tag == b"d":
        n = r.u32()
        out = {}
        for _ in range(n):
            k = _dec(r)
            out[k] = _dec(r)
        return out
    if tag == b"o":
        key = r.str_()
        entry = _REGISTRY.get(key)
        if entry is None:
            raise WireError(f"unregistered wire dataclass {key!r}")
        cls, known = entry
        fields = {}
        for _ in range(r.u32()):
            name = r.str_()
            value = _dec(r)
            if name not in known:
                raise WireError(f"{key}: unexpected field {name!r}")
            fields[name] = value
        return cls(**fields)
    raise WireError(f"unknown wire tag {tag!r}")


def decode(buf, copy: bool = True) -> Any:
    """Deserialize one message. ``copy=True`` copies tensor data out of
    ``buf``; ``copy=False`` returns tensors aliasing ``buf``, which keeps it
    alive and which a recycling receive pool will not overwrite while any
    such tensor lives. Every malformed input raises :class:`WireError`."""
    r = _Reader(buf, copy=copy)
    try:
        obj = _dec(r)
    except WireError:
        raise
    except Exception as e:
        raise WireError(f"malformed wire message: {type(e).__name__}: {e}") from e
    if r.pos != len(r.buf):
        raise WireError(f"{len(r.buf) - r.pos} trailing bytes after message")
    return obj
