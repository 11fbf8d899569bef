"""Pipeline parallelism over the mesh ``pipe`` axis: the GPipe, 1F1B and
interleaved-1F1B schedules (counterpart of ``autodist_tpu/parallel/pipeline.py``).

Stage parameters carry a leading stage dimension; each pipe rank holds its
own rows of it (the ``Pipeline`` strategy's ``[L/S, ...]`` storage) and runs
its stage on a stream of micro-batches, handing activations to the next
stage with one hop a tick (:func:`~autodist_tpu_torch.parallel.ring_attention.shift`,
``batch_isend_irecv``), as the JAX package's ``shard_map`` over ``pipe``
hands them on with ``lax.ppermute``. The schedules are the JAX package's,
slot for slot:

- **GPipe** (:func:`pipelined`): ``M + S - 1`` forward ticks, then the same
  ticks in reverse for the backward. The backward is an explicit reverse
  schedule inside one ``autograd.Function``: each slot's forward graph is
  kept (the residuals autodiff through the JAX scan keeps) and run
  backward in its reverse tick, so every rank makes the same hops whatever
  slots it skips. The last stage's outputs are broadcast to every pipe rank
  (the head and loss run replicated); on the way back only the last rank's
  gradient of them enters the schedule, once, and the input's gradient,
  which only rank 0 computes, is broadcast back to every pipe rank.
- **1F1B** (:func:`pipelined_value_and_grad`): each tick runs one forward
  and one backward slot per stage (the backward recomputes the stage from
  its saved input), the tail (head + loss) at the last stage inside the
  schedule; ``f(...) -> (loss, stage_grads, tail_grads, x_grads)``.
- **Interleaved 1F1B** (:func:`interleaved_value_and_grad`): ``v`` chunks a
  rank, chunk ``c`` of ``V = S v`` on rank ``c mod S``, in the closed-form
  slot order of ``autodist_tpu/parallel/pipeline.py:167-205``. Plain 1F1B is
  this schedule at ``v = 1``, where the hops have no ring wrap (the wrap's
  payload would be dead traffic).

An invalid slot (fill and drain) is skipped with a Python ``if`` where JAX
computes and masks it; the hop still runs, with zeros, so every rank makes
the same sends. **One-process replay**: on a mesh whose ``pipe`` axis is
virtual (:func:`~autodist_tpu_torch.parallel.mesh.replay_mesh`) the same
tick bodies run all ``S`` ranks in this process, each hop a rotation of
their values, with the whole stage stack as ``stage_params``. The mesh
comes from the argument or the current mesh (``with mesh:``; the runner
steps under its own); outside any mesh the wrappers raise, as in JAX.
"""

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.parallel.mesh import DeviceMesh, current_mesh, is_fake
from autodist_tpu_torch.parallel.ring_attention import shift

PyTree = object


# ------------------------------------------------------------------ trees

def _flatten(tree, path=()):
    """``[(path, leaf)]`` of a nested dict (or a lone tensor)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flatten(v, path + (k,))]
    return [(path, tree)]


def _unflatten(like, leaves: Sequence):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return next(it)

    return build(like)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _leaves(tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in _flatten(tree)]


# ----------------------------------------------------------------- ranks

class PipeRanks:
    """The pipe ranks this process runs: its own rank of a pipe group of
    ``size``, or all of them (the one-process replay, ``group`` None)."""

    def __init__(self, size: int, ranks: Sequence[int],
                 group: Optional["dist.ProcessGroup"] = None):
        self.size, self.ranks, self.group = size, list(ranks), group

    def hop(self, values: Dict[int, torch.Tensor], backward: bool = False,
            wrap: bool = True) -> Dict[int, torch.Tensor]:
        """Each rank's value moved one stage on (to rank + 1, or rank - 1
        with ``backward``); without ``wrap`` the end rank's value goes
        nowhere and the first rank receives zeros."""
        step = -1 if backward else 1
        if len(self.ranks) > 1 or self.group is None:
            out = {}
            for r in self.ranks:
                src = r - step
                if wrap or 0 <= src < self.size:
                    out[r] = values[src % self.size]
                else:
                    out[r] = torch.zeros_like(values[r])
            return out
        (r, value), = values.items()
        if is_fake(value):        # the cost probe's trace: no group runs there
            return {r: torch.zeros_like(value)}
        return {r: shift([value], self.group, backward=backward, wrap=wrap)[0]}

    def from_rank(self, src: int, values: Dict[int, torch.Tensor]) -> torch.Tensor:
        """Pipe rank ``src``'s value, on this process (a broadcast over the
        group; this rank's entry of ``values`` is the buffer where it is not
        ``src``)."""
        if len(self.ranks) > 1 or self.group is None:
            return values[src]
        (r, value), = values.items()
        if not is_fake(value):
            value = value.contiguous()
            dist.broadcast(value, src=dist.get_global_rank(self.group, src), group=self.group)
        return value


def _ambient_mesh() -> DeviceMesh:
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError(
            "pipelined() needs a mesh: pass one explicitly or call inside a "
            "`with mesh:` block (DistributedRunner.run steps under one)")
    return mesh


def _pipe_ranks(fn_name: str, mesh: Optional[DeviceMesh], axis: str, n_stages: int,
                stage_params, stage_rows: Optional[int] = None) -> PipeRanks:
    """Mesh resolution and the stage-size checks of the schedule wrappers
    (``autodist_tpu/parallel/pipeline.py:420-449``). Without the size check a
    mismatched mesh would run only the stage groups the pipe axis covers:
    finite loss, most layers skipped. ``stage_rows`` (interleaved: S v) is
    the stack's rows when they differ from the stage count; each rank holds
    its ``stage_rows / S`` of them, the replay all of them."""
    m = mesh if mesh is not None else _ambient_mesh()
    mesh_stages = m.shape.get(axis, 1)
    if mesh_stages != n_stages:
        raise ValueError(
            f"{fn_name}(n_stages={n_stages}) needs mesh axis {axis!r} of that "
            f"size, but the mesh has {axis}={mesh_stages}; size the mesh with "
            f"the Pipeline strategy or a matching resource-spec mesh")
    rows = n_stages if stage_rows is None else stage_rows
    replay = axis in m.virtual or n_stages == 1
    if not replay:
        rows //= n_stages
    for path, leaf in _flatten(stage_params):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape or shape[0] != rows:
            raise ValueError(f"{fn_name}: stage_params leaves need leading dim {rows}, "
                             f"got {shape} at {''.join(f'[{k!r}]' for k in path)}")
    if replay:
        return PipeRanks(n_stages, range(n_stages))
    return PipeRanks(n_stages, [m.coords[axis]], m.group((axis,)))


def _rows(tree, start: int, stop: int):
    return _tree_map(lambda leaf: leaf[start:stop], tree)


def _detached(tree):
    return _tree_map(lambda leaf: leaf.detach().requires_grad_(), tree)


class _GatherRows(torch.autograd.Function):
    """Every pipe rank's rows of a stack, in rank order; the backward sums
    each row's gradient over the ranks and returns this rank's rows (the
    transpose of the gather)."""

    @staticmethod
    def forward(ctx, local, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = local.new_empty((n * local.shape[0],) + tuple(local.shape[1:]))
        dist.all_gather_into_tensor(out, local.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


def gather_stages(tree: PyTree, axis: str = const.MESH_AXIS_PIPE,
                  mesh: Optional[DeviceMesh] = None):
    """``(whole, rank)``: every ``axis`` rank's rows of the leaves of
    ``tree`` (this rank's rows of a stage stack) joined in rank order,
    differentiably, and this rank's place on ``axis``; on a virtual axis or
    one of a single rank, ``tree`` itself (it is whole) and None."""
    m = mesh if mesh is not None else _ambient_mesh()
    if m.shape.get(axis, 1) == 1 or axis in m.virtual:
        return tree, None
    group = m.group((axis,))
    return _tree_map(lambda leaf: _GatherRows.apply(leaf, group), tree), m.coords[axis]


# ------------------------------------------------------------------ GPipe

class _GPipe(torch.autograd.Function):
    """The GPipe schedule with its backward as the reverse schedule."""

    @staticmethod
    def forward(ctx, run, x_mb, *leaves):
        ctx.run = run
        outputs, ctx.slots, ctx.blocks = run.forward(x_mb, leaves, keep_graphs=True)
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        gx, g_leaves = ctx.run.backward(ctx.slots, ctx.blocks, g_out)
        del ctx.slots, ctx.blocks
        return (None, gx, *g_leaves)


class _GPipeRun:
    def __init__(self, stage_fn: Callable, stage_params, ranks: PipeRanks):
        self.stage_fn, self.stage_params, self.pipe = stage_fn, stage_params, ranks

    def forward(self, x_mb, leaves, keep_graphs: bool):
        """The forward ticks: ``(outputs on every pipe rank, slots, blocks)``;
        with ``keep_graphs`` each slot's graph is kept for the backward."""
        pipe, s = self.pipe, self.pipe.size
        n_mb = x_mb.shape[0]
        params = _unflatten(self.stage_params, leaves)
        zero = torch.zeros_like(x_mb[0])
        blocks = {r: _rows(params, i, i + 1) for i, r in enumerate(pipe.ranks)}
        if keep_graphs:
            blocks = {r: _detached(b) for r, b in blocks.items()}
        slots, outputs = {}, [zero] * n_mb
        state = {r: zero for r in pipe.ranks}
        n_ticks = n_mb + s - 1
        with torch.set_grad_enabled(keep_graphs):
            for t in range(n_ticks):
                sent = {}
                for r in pipe.ranks:
                    k = t - r
                    if not 0 <= k < n_mb:
                        sent[r] = zero
                        continue
                    x = (x_mb[k] if r == 0 else state[r]).detach().requires_grad_(keep_graphs)
                    y = self.stage_fn(blocks[r], x)
                    if keep_graphs:
                        slots[r, k] = (x, y)
                    sent[r] = y.detach()
                    if r == s - 1:
                        outputs[k] = sent[r]
                if t < n_ticks - 1:
                    state = pipe.hop(sent, wrap=False)
        last = {r: torch.stack(outputs) if r == s - 1 else torch.empty_like(x_mb)
                for r in pipe.ranks}
        # The last stage's results on every pipe rank: the head and the loss
        # downstream run replicated.
        return pipe.from_rank(s - 1, last), slots, blocks

    def backward(self, slots, blocks, g_out):
        pipe, s = self.pipe, self.pipe.size
        n_mb = g_out.shape[0]
        zero = torch.zeros_like(g_out[0])
        grads = {r: [torch.zeros_like(leaf) for leaf in _leaves(blocks[r])] for r in pipe.ranks}
        gx = {r: torch.zeros_like(g_out) for r in pipe.ranks}
        g_recv = {r: zero for r in pipe.ranks}
        n_ticks = n_mb + s - 1
        for t in reversed(range(n_ticks)):
            sent = {}
            for r in pipe.ranks:
                k = t - r
                if not 0 <= k < n_mb:
                    sent[r] = zero
                    continue
                x, y = slots.pop((r, k))
                # Only the last rank's gradient of the broadcast outputs
                # enters: every rank holds the same one.
                g_y = g_out[k] if r == s - 1 else g_recv[r]
                *d_block, d_x = torch.autograd.grad(y, _leaves(blocks[r]) + [x], g_y,
                                                    allow_unused=True, materialize_grads=True)
                for acc, g in zip(grads[r], d_block):
                    acc.add_(g)
                sent[r] = d_x
                if r == 0:
                    gx[r][k] = d_x
            if t > 0:
                g_recv = pipe.hop(sent, backward=True, wrap=False)
        g_leaves = [torch.cat(parts) for parts in zip(*(grads[r] for r in pipe.ranks))]
        # The input's gradient, which rank 0 computed, on every pipe rank.
        return pipe.from_rank(0, gx), g_leaves


def pipeline_apply(stage_fn: Callable, stage_params: PyTree, x_mb: torch.Tensor,
                   ranks: PipeRanks) -> torch.Tensor:
    """The GPipe schedule over ``ranks``. ``stage_fn(stage_params, x) -> y``
    applies one stage to one micro-batch (its params with a leading stage
    dim of 1; ``y`` like ``x``). ``stage_params``: the ranks' rows of the
    stack; ``x_mb``: ``[num_microbatches, mb_batch, ...]`` entering stage 0,
    the same on every pipe rank (only rank 0 reads it). Returns the last
    stage's outputs on every pipe rank, differentiable in ``x_mb`` and
    ``stage_params``."""
    if ranks.size == 1:
        return torch.stack([stage_fn(stage_params, x) for x in x_mb])
    run = _GPipeRun(stage_fn, stage_params, ranks)
    leaves = _leaves(stage_params)
    if not torch.is_grad_enabled() or not any(t.requires_grad for t in [x_mb] + leaves):
        return run.forward(x_mb, leaves, keep_graphs=False)[0]   # no backward: no graph
    return _GPipe.apply(run, x_mb, *leaves)


def pipelined(stage_fn: Callable, n_stages: int, axis: str = const.MESH_AXIS_PIPE,
              mesh: Optional[DeviceMesh] = None) -> Callable:
    """``f(stage_params, x_mb) -> y_mb``: :func:`pipeline_apply` over the
    ``axis`` ranks of ``mesh`` (default: the current mesh). On real ranks
    ``stage_params`` leaves hold this rank's stage (leading dim 1); in the
    replay, the whole stack (leading dim ``n_stages``)."""

    def f(stage_params, x_mb):
        ranks = _pipe_ranks("pipelined", mesh, axis, n_stages, stage_params)
        return pipeline_apply(stage_fn, stage_params, x_mb, ranks)

    return f


# ------------------------------------------------------------------- 1F1B

def _value_and_grad(fn: Callable, *args):
    """``(value, grads)`` of ``fn(*args)`` in each of ``args`` (trees)."""
    with torch.enable_grad():
        leaves = [_detached(a) for a in args]
        value = fn(*leaves)
        flat = [leaf for tree in leaves for leaf in _leaves(tree)]
        grads = torch.autograd.grad(value, flat, allow_unused=True, materialize_grads=True)
    out, pos = [], 0
    for tree in leaves:
        n = len(_leaves(tree))
        out.append(_unflatten(tree, grads[pos:pos + n]))
        pos += n
    return value.detach(), out


def onef_oneb_apply(stage_fn: Callable, tail_fn: Callable, stage_params: PyTree,
                    tail_params: PyTree, x_mb: torch.Tensor, targets_mb: PyTree,
                    ranks: PipeRanks):
    """The 1F1B schedule over ``ranks``: ``(mean_loss, stage_grads,
    tail_grads, x_grads)``. ``tail_fn(tail_params, y, target) -> scalar`` is
    the head and loss of one micro-batch, run at the last stage inside the
    schedule; ``x_grads`` is ``[M, ...]``, d loss / d ``x_mb``. Stage r runs
    the forward of micro-batch ``t - r`` and the backward of ``t - (2S - 2 -
    r)`` at tick t; a micro-batch's input is held from its forward to its
    backward, at most ``2(S - 1 - r) + 1`` of them."""
    if ranks.size == 1:
        n_mb = x_mb.shape[0]
        loss, gs, gt, gx = 0.0, None, None, []
        for k in range(n_mb):
            tgt = _tree_map(lambda leaf: leaf[k], targets_mb)
            value, (dgs, dgt, dgx) = _value_and_grad(
                lambda sp, tp, x: tail_fn(tp, stage_fn(sp, x), tgt),
                stage_params, tail_params, x_mb[k])
            gs = dgs if gs is None else _tree_map(torch.add, gs, dgs)
            gt = dgt if gt is None else _tree_map(torch.add, gt, dgt)
            gx.append(dgx)
            loss = loss + value
        scale = 1.0 / n_mb
        return (loss * scale, _tree_map(lambda g: g * scale, gs),
                _tree_map(lambda g: g * scale, gt), torch.stack(gx) * scale)
    # Exactly the interleaved schedule with one chunk a rank.
    return interleaved_onef_oneb_apply(stage_fn, tail_fn, stage_params, tail_params,
                                       x_mb, targets_mb, 1, ranks)


def interleaved_onef_oneb_apply(stage_fn: Callable, tail_fn: Callable,
                                stage_params: PyTree, tail_params: PyTree,
                                x_mb: torch.Tensor, targets_mb: PyTree,
                                n_chunks: int, ranks: PipeRanks):
    """The interleaved-1F1B schedule over ``ranks``: ``stage_params`` holds
    each rank's ``v`` chunks in the device-major layout (row ``i v + j`` of
    the i-th rank held here is virtual stage ``j S + r``;
    :func:`interleave_chunk_layout` converts from virtual order). Returns
    ``(mean_loss, stage_grads, tail_grads, x_grads)``, ``stage_grads`` in
    the same layout. Per tick a rank runs one chunk forward and one chunk
    backward; the slot arithmetic and the backward's ``delay(r)`` are the
    JAX package's, so every hop lands one tick before its consumer."""
    s, v = ranks.size, n_chunks
    n_mb = x_mb.shape[0]
    if v > 1 and n_mb % s:
        # A ragged final group would process some (mb, chunk) pairs twice
        # and skip others: finite, plausible, wrong gradients.
        raise ValueError(
            f"interleaved 1F1B needs num_microbatches divisible by n_stages "
            f"({n_mb} % {s} != 0); pad the microbatch count")
    sv = s * v
    total_slots = n_mb * v
    ring_size = 2 * (s - 1) + 2 * (v - 1) * s + 1
    # The ring wraps (forward S-1 -> 0, backward 0 -> S-1) carry a
    # micro-batch into its next chunk group; at v = 1 there are none.
    wrap = v > 1

    def delay(r):
        return 2 * (s - 1) + (v - 1) * s - r

    def decompose_f(idx):
        g, rem = divmod(idx, sv)
        return g * s + rem % s, rem // s                    # (mb, chunk)

    def decompose_b(idx):
        g, rem = divmod(idx, sv)
        return g * s + rem % s, v - 1 - rem // s

    zero = torch.zeros_like(x_mb[0])
    chunks = {r: [_rows(stage_params, i * v + j, i * v + j + 1) for j in range(v)]
              for i, r in enumerate(ranks.ranks)}
    gs = {r: [_tree_map(torch.zeros_like, c) for c in chunks[r]] for r in ranks.ranks}
    gt = _tree_map(torch.zeros_like, tail_params)
    gx = {r: torch.zeros_like(x_mb) for r in ranks.ranks}
    loss = {r: torch.zeros((), dtype=torch.float32, device=x_mb.device) for r in ranks.ranks}
    ring = {r: [None] * ring_size for r in ranks.ranks}
    a_recv = g_recv = {r: zero for r in ranks.ranks}
    n_ticks = total_slots + 2 * (s - 1) + (v - 1) * s
    for t in range(n_ticks):
        a_sent, g_sent = {}, {}
        for r in ranks.ranks:
            # ---- F slot
            a_sent[r] = g_sent[r] = zero
            f_idx = t - r
            if 0 <= f_idx < total_slots:
                m_f, j_f = decompose_f(f_idx)
                x_in = x_mb[m_f] if j_f * s + r == 0 else a_recv[r]
                with torch.no_grad():
                    a_sent[r] = stage_fn(chunks[r][j_f], x_in)
                ring[r][f_idx % ring_size] = x_in
            # ---- B slot
            b_idx = t - delay(r)
            if 0 <= b_idx < total_slots:
                m_b, j_b = decompose_b(b_idx)
                c_b = j_b * s + r
                # The saved input went into the ring under its forward slot.
                f_of_b = (m_b // s) * sv + j_b * s + m_b % s
                x_saved = ring[r][f_of_b % ring_size]
                if c_b == sv - 1:      # the loss-owning stage runs the tail
                    tgt = _tree_map(lambda leaf: leaf[m_b], targets_mb)
                    value, (d_stage, d_x, d_tail) = _value_and_grad(
                        lambda p, x, tp: tail_fn(tp, stage_fn(p, x), tgt),
                        chunks[r][j_b], x_saved, tail_params)
                    loss[r] += value
                    gt = _tree_map(torch.add, gt, d_tail)
                else:
                    with torch.enable_grad():
                        p, x = _detached(chunks[r][j_b]), x_saved.detach().requires_grad_()
                        *d_leaves, d_x = torch.autograd.grad(
                            stage_fn(p, x), _leaves(p) + [x], g_recv[r],
                            allow_unused=True, materialize_grads=True)
                    d_stage = _unflatten(p, d_leaves)
                gs[r][j_b] = _tree_map(torch.add, gs[r][j_b], d_stage)
                if c_b == 0:
                    gx[r][m_b] = d_x
                g_sent[r] = d_x
        if t < n_ticks - 1:
            a_recv = ranks.hop(a_sent, wrap=wrap)
            g_recv = ranks.hop(g_sent, backward=True, wrap=wrap)

    scale = 1.0 / n_mb
    last = s - 1                 # virtual stage V-1 lives on rank S-1
    out_loss = ranks.from_rank(last, loss) * scale
    flat_gt = _leaves(gt)
    tails = {r: torch.cat([g.reshape(-1) for g in flat_gt]) for r in ranks.ranks}
    flat_tail = ranks.from_rank(last, tails) * scale
    sizes = [g.numel() for g in flat_gt]
    gt = _unflatten(gt, [piece.view_as(g) for piece, g in zip(flat_tail.split(sizes), flat_gt)])
    grads = [torch.cat(parts) * scale for parts in zip(*(
        _leaves(chunk) for r in ranks.ranks for chunk in gs[r]))]
    return out_loss, _unflatten(stage_params, grads), gt, ranks.from_rank(0, gx) * scale


def pipelined_value_and_grad(stage_fn: Callable, tail_fn: Callable, n_stages: int,
                             axis: str = const.MESH_AXIS_PIPE,
                             mesh: Optional[DeviceMesh] = None) -> Callable:
    """``f(stage_params, tail_params, x_mb, targets_mb) -> (mean_loss,
    stage_grads, tail_grads, x_grads)``: :func:`onef_oneb_apply` over the
    ``axis`` ranks of ``mesh`` (default: the current mesh). ``stage_params``
    as :func:`pipelined` takes them; ``tail_params`` replicated."""

    def f(stage_params, tail_params, x_mb, targets_mb):
        ranks = _pipe_ranks("pipelined_value_and_grad", mesh, axis, n_stages, stage_params)
        return onef_oneb_apply(stage_fn, tail_fn, stage_params, tail_params, x_mb,
                               targets_mb, ranks)

    return f


def interleaved_value_and_grad(stage_fn: Callable, tail_fn: Callable, n_stages: int,
                               n_chunks: int, axis: str = const.MESH_AXIS_PIPE,
                               mesh: Optional[DeviceMesh] = None) -> Callable:
    """:func:`pipelined_value_and_grad` on the interleaved schedule:
    ``stage_params`` leaves carry ``V = n_stages * n_chunks`` rows in the
    device-major layout (each rank its ``n_chunks``); grads come back in the
    same layout. ``n_chunks=1`` is exactly plain 1F1B."""

    def f(stage_params, tail_params, x_mb, targets_mb):
        ranks = _pipe_ranks("interleaved_value_and_grad", mesh, axis, n_stages,
                            stage_params, stage_rows=n_stages * n_chunks)
        return interleaved_onef_oneb_apply(stage_fn, tail_fn, stage_params, tail_params,
                                           x_mb, targets_mb, n_chunks, ranks)

    return f


# ----------------------------------------------------------------- layout

def chunk_perm(n_stages: int, n_chunks: int, inverse: bool = False) -> List[int]:
    """The device-major <-> virtual row permutation: ``perm[row]`` is the
    source row. Forward: device-major row ``r v + j`` reads virtual row
    ``j S + r``; inverse: virtual row ``j S + r`` reads device-major row
    ``r v + j``."""
    v, s = n_chunks, n_stages
    if inverse:
        return [(row % s) * v + row // s for row in range(s * v)]
    return [(row % v) * s + row // v for row in range(s * v)]


def interleave_chunk_layout(tree: PyTree, n_stages: int, n_chunks: int,
                            inverse: bool = False) -> PyTree:
    """Leading-dim-``V`` leaves permuted between virtual-stage order (chunk
    ``c`` at row ``c``) and the device-major order the interleaved schedule
    shards (row ``r v + j`` = virtual stage ``j S + r``); ``inverse`` goes
    back. Apply once at init, not inside the step."""
    idx = torch.tensor(chunk_perm(n_stages, n_chunks, inverse=inverse))
    return _tree_map(lambda leaf: leaf[idx.to(leaf.device)], tree)
