"""Gradient synchronization (``autodist_tpu/parallel/synchronization.py``).

Every rank runs the loss on its own rows (one process per device) and
differentiates it; the gradient function then combines the ranks'
gradients. Two lowerings, as in the JAX package (``make_grad_fn``,
``:165-363``):

- **Implicit** (no codec, no sparse wire, no honoured DCN request): one
  all-reduce of a flat buffer over the data and seq ranks, averaged over
  the data ranks and summed over the seq ranks (the transpose of the
  sequence-parallel loss's ``psum``). Gradients whose update is sharded (PS
  along ``reduce``, ZeRO along all data axes) take a ``reduce_scatter`` over
  those axes instead, so each rank receives only its shard: the first half
  of the sharded update whose all-gather the runner does.
- **Explicit** (a codec somewhere, a sparse parameter with a known index
  leaf, or ``spec=DCN`` on a mesh with both data axes): each gradient is
  averaged over the data ranks on its own wire: cast to bf16 (``BF16``),
  with a per-rank error-feedback residual (``BF16_EF``: x = g + e, send
  bf16(x), e' = x - f32(bf16(x))), as PowerSGD factors (``POWER_SGD``:
  M = g + e, P = mean(M Q), P^ = QR(P), Q' = mean(M^T P^), e' = M - P^ Q'^T,
  only the thin factors on the wire), or for a sparse parameter as the
  all-gathered (indices, rows) of the touched rows, summed by
  ``index_add_``. ``spec=DCN`` reduces in two phases, ``reduce`` first, then
  ``data``. Gradients that share a codec, tier and dtype go in one buffer.
  It needs replicated parameters: a codec on a partitioned one raises, and
  the sparse wire then stays off, as in the JAX package.

What that asks of a loss under data parallelism:

- a plain mean over the same number of rows on every rank is exact: the
  average of the ranks' means is the global mean;
- a loss normalised by a count that depends on the data (a masked token
  mean) must reduce the count over the data ranks with :func:`global_mean`,
  whose value is the global mean and whose gradient is scaled so that the
  average over the data ranks is the global mean's gradient.

The reported loss is averaged over the same ranks, so it is the global one.
"""

import dataclasses
import logging
import zlib
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.parallel.layout import StateLayout
from autodist_tpu_torch.parallel.mesh import (DeviceMesh, current_mesh, single_device_mesh,
                                              step_mesh)
from autodist_tpu_torch.parallel.plan import (COMP_BF16, COMP_BF16_EF, COMP_NONE,
                                              COMP_POWER_SGD, DP_AXES, ShardingPlan)
from autodist_tpu_torch.parallel.wire import register_wire_dataclass
from autodist_tpu_torch.proto.strategy import AllReduceSynchronizer

_log = logging.getLogger("autodist_tpu_torch")

SYNC_AXES = DP_AXES + (const.MESH_AXIS_SEQ,)
SPEC_DCN = AllReduceSynchronizer.Spec.DCN

def current_group(axes: Sequence[str] = DP_AXES) -> Optional["dist.ProcessGroup"]:
    """The process group along ``axes`` of the running step's mesh (None
    outside a step, or for a group of one rank)."""
    mesh = current_mesh()
    return mesh.group(axes) if mesh is not None else None


def global_mean(total: torch.Tensor, count: torch.Tensor, axes: Sequence[str] = DP_AXES,
                group: Optional["dist.ProcessGroup"] = None) -> torch.Tensor:
    """``sum(total) / max(sum(count), 1)`` over the ranks of the running
    step's mesh along ``axes`` (``total`` of any shape, summed element by
    element; ``count`` a scalar); outside a step, over ``group`` (None: this
    rank alone). The value is that global mean on every rank; the gradient
    is this rank's share of it times the number of data ranks, which the
    runner's average over the data ranks turns back into the global mean's
    gradient."""
    mesh = current_mesh()
    dp = 1
    if mesh is not None:
        group, dp = mesh.group(axes), mesh.axes_size(DP_AXES)
    sums = torch.cat([total.detach().reshape(-1), count.detach().to(total.dtype).reshape(1)])
    if group is not None:
        dist.all_reduce(sums, group=group)
    denom = torch.clamp(sums[-1], min=1.0)
    local = total * dp / denom
    return local + (sums[:-1].view_as(total) / denom - local).detach()


def _detached(tree):
    """The aux tree with every tensor detached: holding the graph would keep
    each micro-batch's activations alive through the whole step."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def _group_size(mesh: Optional[DeviceMesh], axes) -> int:
    group = mesh.group(axes) if mesh is not None else None
    return 1 if group is None else dist.get_world_size(group)


# ----------------------------------------------------------------- compressors

def compress(x: torch.Tensor, kind) -> torch.Tensor:
    """The wire form of a gradient: bf16 for the cast codecs."""
    if kind in (COMP_BF16, COMP_BF16_EF):
        return x.to(torch.bfloat16)
    return x


def decompress(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype)


def _powersgd_applies(shape) -> bool:
    # Only matrix-shaped (rank >= 2) tensors are factorized.
    return len(shape) >= 2


def _powersgd_rank(shape, rank: int) -> int:
    m, n = shape[0], int(np.prod(shape[1:]))
    return max(1, min(rank, m, n))


def _threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block cipher (20 rounds), as ``jax.random``'s
    default generator computes it."""
    ks = [np.uint32(k0), np.uint32(k1), np.uint32(k0 ^ k1 ^ 0x1BD11BDA)]
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in rotations[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def jax_normal(seed: int, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)`` on the
    host: the key's two words, Threefry over a 64-bit counter per element
    (hi and lo words, the partitionable layout), the two output words
    xor-ed, 23 mantissa bits to a uniform on (-1, 1), and
    ``sqrt(2) * erfinv`` (taken in f64 here, in f32 by XLA: the values agree
    to about 1e-7 relative)."""
    n = int(np.prod(shape))
    count = np.arange(n, dtype=np.uint64)
    b0, b1 = _threefry2x32((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF,
                           (count >> np.uint64(32)).astype(np.uint32),
                           (count & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    unit = bits.view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(1.0))
    u = np.maximum(lo, unit * (np.float32(1.0) - lo) + lo)
    z = torch.erfinv(torch.from_numpy(u.astype(np.float64))) * np.sqrt(2.0)
    return z.to(torch.float32).reshape(tuple(shape))


def powersgd_q0(name: str, shape, rank: int) -> torch.Tensor:
    """PowerSGD's warm start, the JAX package's: the orthonormal factor of a
    normal draw seeded by the parameter name's CRC32
    (``autodist_tpu/parallel/synchronization.py:441-448``), on the host."""
    r = _powersgd_rank(shape, rank)
    draw = jax_normal(zlib.crc32(name.encode()), (int(np.prod(shape[1:])), r))
    return torch.linalg.qr(draw)[0]


def init_compressor_state(plan: ShardingPlan, model_spec: ModelSpec,
                          device: torch.device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{state-dict key: {"error": residual, "q": factor}}`` for the
    parameters whose codec keeps state: this rank's own error-feedback
    residual (``BF16_EF`` and matrix ``POWER_SGD``) and PowerSGD's Q, the
    same on every rank."""
    state = {}
    for name, p in plan.params.items():
        meta = model_spec[name]
        if p.compressor == COMP_BF16_EF or (p.compressor == COMP_POWER_SGD
                                            and _powersgd_applies(p.shape)):
            entry = {"error": torch.zeros(p.shape, dtype=meta.dtype, device=device)}
            if p.compressor == COMP_POWER_SGD:
                entry["q"] = powersgd_q0(name, p.shape, p.power_sgd_rank).to(device)
            state[model_spec.keys[name]] = entry
    return state


# -------------------------------------------------------------- grad functions

def make_grad_fn(sharding_plan: ShardingPlan, model_spec: ModelSpec,
                 mesh: Optional[DeviceMesh], loss_fn: Callable,
                 has_aux: bool = False, layout: Optional[StateLayout] = None) -> Callable:
    """``grad_fn(params, batch, ef_state=None) -> (grads, loss, aux)``:
    ``params`` maps state-dict keys to the logical tensors the loss reads
    (leaves that require grad), ``grads`` maps the trainable keys to what
    their optimizer parameter needs (the synchronized gradient of the
    storage, or of the update shard where the update is sharded), ``loss``
    is the detached global loss and ``aux`` the loss function's auxiliary
    output (``()`` without ``has_aux``) on this rank's rows. ``ef_state``
    (:func:`init_compressor_state`) is updated in place.
    ``grad_fn.local(params, batch)`` is the same without synchronization
    (logical gradients) and ``grad_fn.sync(grads, loss, ef_state, batch)``
    the synchronization alone, so that gradient accumulation reduces once a
    step; the explicit lowering (``grad_fn.explicit``) syncs every
    micro-batch, as the JAX package's does. ``mesh`` is the mesh of joined
    ranks (None when no group of the plan's size is up, which raises for a
    plan of more than one rank)."""
    dp, seq = sharding_plan.dp_size, sharding_plan.seq_size
    for axes, size, what in ((DP_AXES, dp, "data axes have"),
                             ((const.MESH_AXIS_SEQ,), seq, "seq axis has")):
        joined = _group_size(mesh, axes)
        if joined != size:
            group = "data group" if axes == DP_AXES else "seq group"
            raise RuntimeError(f"the mesh's {what} {size} ranks but the {group} has "
                               f"{joined}: join the process group first (torchrun)")
    if layout is None:
        layout = StateLayout(sharding_plan, model_spec, mesh or single_device_mesh())
    keys = [model_spec.keys[n] for n in model_spec.trainable]
    plans = {model_spec.keys[n]: sharding_plan.params[n] for n in model_spec.trainable}
    sparse_wire = {model_spec.keys[n]: p for n, p in
                   sharding_plan.sparse_wire_params.items()} if dp > 1 else {}
    hierarchical_ok = mesh is not None and all(mesh.shape.get(a, 1) > 1 for a in DP_AXES)
    requested_dcn = any(p.spec == SPEC_DCN for p in plans.values())
    honor_dcn = (requested_dcn and dp > 1 and hierarchical_ok
                 and sharding_plan.all_params_replicated)
    if requested_dcn and dp > 1 and not honor_dcn:
        _log.warning("spec=DCN (hierarchical two-phase reduce) cannot be honoured here "
                     "(%s); gradients use a single-phase reduce",
                     "the mesh lacks a populated inner data axis" if not hierarchical_ok
                     else "partitioned parameters use the implicit lowering")
    explicit = sharding_plan.has_compression or bool(sparse_wire) or honor_dcn
    if explicit and not sharding_plan.all_params_replicated:
        if sharding_plan.has_compression:
            raise NotImplementedError(
                "Gradient compression requires replicated parameters (AllReduce-family "
                "strategies); partitioned parameters with a compressor are not supported "
                "in one strategy")
        _log.info("Sparse all-gather wire disabled: the model has partitioned parameters")
        explicit = False
    if explicit and seq > 1:
        raise NotImplementedError("the explicit gradient lowering (codecs, the sparse "
                                  "wire, DCN) does not run under sequence parallelism")

    sync_group = mesh.group(SYNC_AXES) if mesh is not None else None
    sync_ranks = _group_size(mesh, SYNC_AXES)
    dp_group = mesh.group(DP_AXES) if mesh is not None else None

    def local(params: Mapping[str, torch.Tensor], batch) -> tuple:
        with step_mesh(mesh):
            out = loss_fn(params, batch)
        loss, aux = out if has_aux else (out, ())
        # An unused parameter gets a zero gradient, as under jax.grad.
        grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                    allow_unused=True, materialize_grads=True)
        return dict(zip(keys, grads)), loss.detach(), _detached(aux)

    def implicit_sync(grads: Dict[str, torch.Tensor], loss: torch.Tensor,
                      ef_state=None, batch=None) -> tuple:
        grads = {k: layout.grad_to_storage(k, g) for k, g in grads.items()}
        by_axes: Dict[tuple, list] = {}
        for k in grads:
            pl = layout.by_key[k]
            if pl.sharded_update:
                by_axes.setdefault(pl.update_axes, []).append(k)
        out = {}
        for axes, members in by_axes.items():
            rest = mesh.group(tuple(a for a in SYNC_AXES if a not in axes))
            shards = layout.reduce_scatter(members, grads, rest)
            out.update({k: s.div_(dp) for k, s in shards.items()})
        dense = [k for k in grads if k not in out]
        if sync_group is None:
            return grads, loss
        parts = [grads[k] for k in dense]
        flat = torch.cat([g.reshape(-1) for g in parts]
                         + [loss.reshape(1).to(parts[0].dtype if parts else loss.dtype)])
        dist.all_reduce(flat, group=sync_group)
        pieces = flat.split([g.numel() for g in parts] + [1])
        out.update({k: p.view(g.shape).to(g.dtype) / dp
                    for k, g, p in zip(dense, parts, pieces)})
        return {k: out[k] for k in grads}, (pieces[-1][0] / sync_ranks).to(loss.dtype)

    def pmean(x: torch.Tensor, spec) -> torch.Tensor:
        """Mean over the data ranks, in two phases (``reduce``, then
        ``data``) for an honoured DCN request."""
        if spec == SPEC_DCN and honor_dcn:
            for axis in (const.MESH_AXIS_REDUCE, const.MESH_AXIS_DATA):
                dist.all_reduce(x, group=mesh.group((axis,)))
                x.div_(mesh.shape[axis])
            return x
        if dp_group is not None:
            dist.all_reduce(x, group=dp_group)
            x.div_(dp)
        return x

    def powersgd(key: str, g: torch.Tensor, state: Dict[str, torch.Tensor], spec):
        shape = g.shape
        mat = (g + state["error"]).reshape(shape[0], -1).to(torch.float32)
        p_hat = torch.linalg.qr(pmean(mat @ state["q"], spec))[0]
        q_new = pmean(mat.T @ p_hat, spec)
        approx = p_hat @ q_new.T
        # In place: a captured run_many graph holds the residual's address.
        state["error"].copy_((mat - approx).reshape(shape))
        state["q"].copy_(q_new)
        return approx.reshape(shape).to(g.dtype)

    def sparse_allgather(g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Ship (indices, touched rows) and rebuild the dense mean: each
        duplicate index carries 1/k of its row, so the scatter-sum of the
        gathered contributions is exactly the sum of the ranks' gradients."""
        vocab = g.shape[0]
        flat = idx.reshape(-1).to(device=g.device, dtype=torch.int64)
        flat = torch.where(flat < 0, flat + vocab, flat)
        valid = (flat >= 0) & (flat < vocab)
        safe = torch.where(valid, flat, torch.zeros_like(flat))
        counts = torch.zeros(vocab, dtype=torch.float32, device=g.device).index_add_(
            0, safe, valid.to(torch.float32))
        inv = torch.where(valid, 1.0 / torch.clamp(counts[safe], min=1.0),
                          torch.zeros((), device=g.device))
        contrib = g[safe] * inv.to(g.dtype).reshape((-1,) + (1,) * (g.dim() - 1))
        all_idx = safe.new_empty((dp * safe.numel(),))
        all_contrib = contrib.new_empty((dp * contrib.shape[0],) + tuple(contrib.shape[1:]))
        dist.all_gather_into_tensor(all_idx, safe, group=dp_group)
        dist.all_gather_into_tensor(all_contrib, contrib.contiguous(), group=dp_group)
        return torch.zeros_like(g).index_add_(0, all_idx, all_contrib) / dp

    def explicit_sync(grads: Dict[str, torch.Tensor], loss: torch.Tensor,
                      ef_state=None, batch=None) -> tuple:
        ef_state = {} if ef_state is None else ef_state
        out, buckets = {}, {}
        for k, g in grads.items():
            p = plans[k]
            if k in sparse_wire:
                idx = _batch_leaf_by_name(batch, p.index_leaf)
                if idx is not None:
                    out[k] = sparse_allgather(g, idx)
                    continue
            if p.compressor == COMP_POWER_SGD and _powersgd_applies(g.shape):
                if k not in ef_state:
                    raise TypeError(f"POWER_SGD parameter {p.name!r} has no compressor "
                                    f"state; init_compressor_state was bypassed")
                out[k] = powersgd(k, g, ef_state[k], p.spec)
                continue
            kind = p.compressor if p.compressor in (COMP_BF16, COMP_BF16_EF) else COMP_NONE
            if kind == COMP_BF16_EF and k not in ef_state:
                raise TypeError(f"BF16_EF parameter {p.name!r} has no compressor state; "
                                f"init_compressor_state was bypassed")
            buckets.setdefault((kind, p.spec, g.dtype), []).append(k)
        for (kind, spec, dtype), members in buckets.items():
            xs = [grads[k] + ef_state[k]["error"] if kind == COMP_BF16_EF else grads[k]
                  for k in members]
            wire = compress(torch.cat([x.reshape(-1) for x in xs]), kind)
            synced = decompress(pmean(wire, spec), dtype)
            for k, x, part in zip(members, xs, synced.split([x.numel() for x in xs])):
                out[k] = part.view(x.shape)
                if kind == COMP_BF16_EF:
                    ef_state[k]["error"].copy_(x - decompress(compress(x, kind), x.dtype))
        loss = pmean(loss.detach().clone(), None)
        return {k: layout.to_update(k, out[k]) for k in grads}, loss

    sync = explicit_sync if explicit else implicit_sync

    def grad_fn(params: Mapping[str, torch.Tensor], batch, ef_state=None) -> tuple:
        grads, loss, aux = local(params, batch)
        grads, loss = sync(grads, loss, ef_state, batch)
        return grads, loss, aux

    grad_fn.local = local
    grad_fn.sync = sync
    grad_fn.explicit = explicit
    return grad_fn


def _batch_leaf_by_name(batch, leaf_name: str):
    """The batch leaf (a tensor or an array) whose '/'-joined path is
    ``leaf_name`` (None if none)."""
    def walk(tree, path):
        if isinstance(tree, Mapping):
            for k, v in tree.items():
                yield from walk(v, path + (str(k),))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from walk(v, path + (str(i),))
        else:
            yield "/".join(path), tree

    for name, leaf in walk(batch, ()):
        if name == leaf_name and isinstance(leaf, (torch.Tensor, np.ndarray)):
            return leaf
    return None


# --------------------------------------------------------- wire-push compression
# The async PS plane's push codecs (``autodist_tpu/parallel/synchronization.py:
# 491-654``): a transport concern only, the server's decode dequantizes and
# ``apply_sparse`` densifies, so its apply path sees a dense tree.

@dataclasses.dataclass
class SparseRows:
    """Row-sparse gradient wire frame: ``indices`` [k] the unique touched
    rows, ``rows`` [k, ...] the gradient at them, ``shape`` the dense shape
    the server scatter-applies into."""

    indices: Any
    rows: Any
    shape: Any


# The JAX package's key, so the two codecs exchange these frames.
register_wire_dataclass(SparseRows, "autodist_tpu.parallel.synchronization:SparseRows")


def densify_sparse_rows(tree):
    """Every :class:`SparseRows` leaf of a dict/list/tuple tree back to its
    dense gradient (zeros off the touched rows, scatter-added, so duplicate
    indices sum)."""
    if isinstance(tree, SparseRows):
        rows = torch.as_tensor(tree.rows)
        dense = torch.zeros(tuple(int(d) for d in tree.shape), dtype=rows.dtype)
        if rows.numel():
            dense.index_add_(0, torch.as_tensor(tree.indices).reshape(-1).to(torch.int64),
                             rows)
        return dense
    if isinstance(tree, dict):
        return {k: densify_sparse_rows(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(densify_sparse_rows(v) for v in tree)
    return tree


class WirePushCompressor:
    """Host-side gradient compressor of the remote PS push
    (``autodist_tpu/parallel/synchronization.py:530-654``). Per gradient:

    - **sparse push** (exact): a parameter the plan marks row-sparse ships
      as :class:`SparseRows`, only the rows the batch's index leaf touched;
    - **quantized push** (lossy, with error feedback): a float gradient of
      ``ndim >= 2`` and at least ``min_bytes`` ships as a ``wire.quantize``
      frame; the residual ``x - dequantize(quantize(x))`` is kept per
      parameter and added before the next quantize (``error_feedback=False``
      is the divergent negative control);
    - **bypass** (exact): everything else.

    Gradients are ``{state-dict key: host tensor}``; ``sparse_params`` maps
    a key to its batch index leaf. ``bytes_in``, ``bytes_out``,
    ``bytes_saved`` and ``quantize_s`` accumulate."""

    def __init__(self, wire_dtype: str = "", *, min_bytes: Optional[int] = None,
                 error_feedback: bool = True, sparse_params: Optional[dict] = None):
        from autodist_tpu_torch.parallel import wire as wire_lib
        wire_dtype = str(wire_dtype or "").lower()
        if wire_dtype in ("off", "none", "0"):
            wire_dtype = ""
        if wire_dtype and wire_dtype not in wire_lib.WIRE_DTYPES:
            raise ValueError(f"unknown wire dtype {wire_dtype!r}; valid: "
                             f"off, {', '.join(wire_lib.WIRE_DTYPES)}")
        self.wire_dtype = wire_dtype
        self.min_bytes = const.env_int(const.AUTODIST_COMPRESS_MIN_BYTES, 65536) \
            if min_bytes is None else int(min_bytes)
        self.error_feedback = bool(error_feedback)
        self.sparse_params = dict(sparse_params or {})
        self._residuals: Dict[str, torch.Tensor] = {}
        self.bytes_in = 0
        self.bytes_out = 0
        self.bytes_saved = 0
        self.quantize_s = 0.0

    @property
    def active(self) -> bool:
        return bool(self.wire_dtype) or bool(self.sparse_params)

    def _sparse_leaf(self, key: str, g: torch.Tensor, batch) -> Optional[SparseRows]:
        idx = _batch_leaf_by_name(batch, self.sparse_params[key]) if batch is not None else None
        if idx is None:
            return None
        vocab = g.shape[0]
        flat = torch.as_tensor(idx).reshape(-1).to(device="cpu", dtype=torch.int64)
        flat = torch.where(flat < 0, flat + vocab, flat)
        uniq = torch.unique(flat[(flat >= 0) & (flat < vocab)], sorted=True)
        return SparseRows(indices=uniq, rows=g[uniq].contiguous(),
                          shape=tuple(int(d) for d in g.shape))

    def compress(self, grads: Dict[str, torch.Tensor], batch=None):
        """``(wire_tree, has_sparse)``: the tree to push, leaves replaced by
        :class:`SparseRows` or ``wire.QuantizedArray`` where the regime
        applies, and whether any went sparse (the worker then pushes with
        the ``apply_sparse`` opcode)."""
        import time as _time

        from autodist_tpu_torch.parallel import wire as wire_lib
        t0 = _time.perf_counter()
        saved = 0
        has_sparse = False
        out = {}
        for key, g in grads.items():
            g = torch.as_tensor(g)
            nbytes = g.numel() * g.element_size()
            if key in self.sparse_params and g.dim() >= 2:
                sp = self._sparse_leaf(key, g, batch)
                if sp is not None:
                    has_sparse = True
                    out_b = (sp.rows.numel() * sp.rows.element_size()
                             + sp.indices.numel() * sp.indices.element_size())
                    self.bytes_in += nbytes
                    self.bytes_out += out_b
                    saved += max(0, nbytes - out_b)
                    out[key] = sp
                    continue
            if (self.wire_dtype and g.is_floating_point() and g.dim() >= 2
                    and nbytes >= self.min_bytes):
                x = g
                prev = self._residuals.get(key)
                if prev is not None:
                    x = g + prev
                qa = wire_lib.quantize(x, self.wire_dtype)
                if self.error_feedback:
                    self._residuals[key] = x - wire_lib.dequantize(qa)
                self.bytes_in += nbytes
                self.bytes_out += qa.wire_nbytes
                saved += max(0, nbytes - qa.wire_nbytes)
                out[key] = qa
                continue
            out[key] = g
        self.bytes_saved += saved
        self.quantize_s += _time.perf_counter() - t0
        return out, has_sparse
