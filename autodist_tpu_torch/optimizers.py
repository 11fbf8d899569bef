"""Optimizers whose arithmetic is an optax optimizer's, for the port to hand
out where the JAX package hands out the optax one.

:class:`Adafactor` computes ``optax.adafactor(learning_rate)`` at its
defaults (``optax/_src/alias.py`` ``adafactor``: ``factorized.
scale_by_factored_rms``, ``clipping.clip_by_block_rms(1.0)``,
``transform.scale_by_learning_rate``, ``transform.scale_by_param_block_rms``
and ``scale(-1)``), the optimizer ``strategy.choose_optimizer`` picks when
Adam's moments do not fit (``autodist_tpu/strategy/auto_strategy.py:171``).
``torch.optim.Adafactor`` is another algorithm: it factors the last two dims
of every tensor of two or more dims, where optax factors a tensor's two
largest dims only when the smaller of them is at least 128 and keeps a full
second moment otherwise (NCF's ``[users, 64]`` tables, 64-channel
convolutions).

Its state per parameter is optax's ``FactoredState``, under optax's names
and in optax's shapes: ``count`` (one int32 tensor on the device, shared by
every parameter's state), ``v_row``, ``v_col`` and ``v``, where a factored
parameter keeps ``(1,)`` placeholders in ``v`` and an unfactored one in
``v_row`` and ``v_col``. So the checkpoint maps it one to one onto
``optax.adafactor``'s leaves.

It is capturable into a CUDA graph as it is: the count lives on the device,
no statistic is read on the host, and every state tensor is updated in
place, so ``run_many`` captures it and ``plan_costs`` steps it on meta
tensors.

Sharded updates. Under ``zero=`` or PS reduce sharding the runner hands
the optimizer a chunk of a parameter (its update shard, cut along one dim),
and optax's statistics are whole-tensor ones: the row and column means of
the squared gradient, the mean of the factored row statistic, the update's
block RMS for the clip, and the parameter's RMS for the scale. The runner
declares each chunk (:meth:`Adafactor.shard`); the optimizer then reduces
each statistic that spans the cut dim over the chunk's group: each rank
sums only the chunk's rows inside the parameter's logical size (so the pad
rows of padded storage count in no mean) and divides by the logical size,
and the step all-reduces these partial means. A step runs every
parameter's update in three rounds (the squared gradient's row and column
means and the parameter's mean square; the row statistic's mean; the
update's mean square), and the partial means of a round go out together,
one all-reduce a group: three a step, whatever the number of parameters. The factored dims and the state's shapes
follow the parameter's logical shape, so each rank keeps its chunk of a
statistic that keeps the cut dim, and the whole of one that reduces it.
The result is the unsharded update up to the order of the sums. The pad
rows' state is kept at 0 after each step, as their gradient, moments and
values are under the other optimizers, so a checkpoint (which holds the
logical rows) restores it bit for bit.
"""

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# optax.adafactor's defaults.
MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
EPSILON = 1e-30
CLIPPING_THRESHOLD = 1.0
MIN_PARAM_SCALE = 1e-3
STATE_FIELDS = ("v_row", "v_col", "v")


def factored_dims(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """optax's rule (``factorized._factored_dims``): ``(d1, d0)``, the
    second-largest and the largest dim, when the second-largest is at least
    MIN_DIM_SIZE_TO_FACTOR; else None (a full second moment)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def removed_dim(field: str, shape: Sequence[int]):
    """Which dim of a parameter of logical ``shape`` optax's ``field``
    drops: d0 for ``v_row``, d1 for ``v_col``, None for ``v`` of an
    unfactored parameter (its own shape), and "placeholder" for a ``(1,)``
    placeholder."""
    dims = factored_dims(shape)
    if (dims is None) != (field == "v"):
        return "placeholder"
    if dims is None:
        return None
    return dims[1] if field == "v_row" else dims[0]


def drop_dim(x: Tuple, dim: Optional[int]) -> Tuple:
    """``x`` (a shape, pspec or ranges) without its entry ``dim`` (all of
    it when ``dim`` is None)."""
    return x if dim is None else x[:dim] + x[dim + 1:]


def state_shapes(shape: Sequence[int], logical: Optional[Sequence[int]] = None
                 ) -> Dict[str, Tuple[int, ...]]:
    """``{field: shape}`` of optax's ``v_row``, ``v_col`` and ``v`` for a
    parameter of ``shape``, or for a chunk of that shape of a parameter of
    ``logical`` shape, whose factoring decides (placeholders ``(1,)``)."""
    shape = tuple(int(d) for d in shape)
    out = {}
    for field in STATE_FIELDS:
        drop = removed_dim(field, shape if logical is None else logical)
        out[field] = (1,) if drop == "placeholder" else drop_dim(shape, drop)
    return out


@dataclasses.dataclass(frozen=True)
class Shard:
    """The optimizer's tensor as a chunk of its parameter: rows
    ``[start, start + local)`` along ``dim`` of the padded parameter, whose
    logical shape is ``shape``; ``group`` holds the other chunks. Deep copies
    share it (a process group does not copy)."""

    shape: Tuple[int, ...]
    dim: int
    start: int
    group: Any

    def valid(self, local: int) -> int:
        """How many of the chunk's ``local`` rows lie inside the parameter."""
        return max(0, min(local, self.shape[self.dim] - self.start))

    def __deepcopy__(self, memo):
        return self


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr)``: a factored estimate of the squared
    gradient's mean (power decay ``1 - (t + 1)^-0.8``, epsilon 1e-30),
    the update clipped to block RMS 1, scaled by ``lr`` and by the
    parameter's RMS (at least 1e-3); no momentum, no weight decay."""

    def __init__(self, params, lr: float = 1e-3):
        super().__init__(params, dict(lr=lr))
        self._shards: Dict[torch.Tensor, Shard] = {}

    def shard(self, param: torch.Tensor, shard: Shard) -> None:
        """Declare ``param`` (one of this optimizer's tensors) a chunk of a
        larger parameter: its statistics are then reduced over the chunk's
        group (the runner calls this for every sharded update)."""
        self._shards[param] = shard

    def logical_shape(self, param: torch.Tensor) -> Tuple[int, ...]:
        shard = self._shards.get(param)
        return shard.shape if shard is not None else tuple(param.shape)

    def _count(self, device) -> torch.Tensor:
        for st in self.state.values():
            if "count" in st:
                return st["count"]
        return torch.zeros((), dtype=torch.int32, device=device)

    def _init_state(self, p: torch.Tensor, count: torch.Tensor) -> dict:
        st = self.state[p]
        if not st:
            st["count"] = count
            for field, shape in state_shapes(p.shape, self.logical_shape(p)).items():
                st[field] = torch.zeros(shape, dtype=p.dtype, device=p.device)
        return st

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        # torch casts every state tensor but ``step`` to its parameter's
        # dtype: the count comes back as optax's int32, one tensor shared again.
        count = None
        for st in self.state.values():
            if "count" in st:
                if count is None:
                    count = st["count"].to(torch.int32)
                st["count"] = count

    # -------------------------------------------------------------------- step
    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        count = None
        updates = []
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            if count is None:
                count = self._count(params[0].device)
            # optax's decay_rate_fn at the step before the increment.
            decay = 1.0 - (count + 1).to(torch.float32).pow(-DECAY_RATE)
            updates += [self._update(p, self._init_state(p, count), group["lr"], decay,
                                     1.0 - decay) for p in params]
        # Every parameter's update runs in the same rounds; the partial sums
        # a round needs whole are all-reduced together, one call a group.
        while updates:
            sums, running = [], []
            for update in updates:
                try:
                    sums += next(update)
                    running.append(update)
                except StopIteration:
                    pass
            self._all_reduce(sums)
            updates = running
        if count is not None:
            count.add_(1)
        return loss

    @staticmethod
    def _all_reduce(sums) -> None:
        """Sum each ``(tensor, group)`` over its group, in place: the
        tensors of one group flattened into one all-reduce."""
        by_group = {}
        for t, group in sums:
            by_group.setdefault(id(group), (group, []))[1].append(t)
        for group, ts in by_group.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, group=group)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))

    @staticmethod
    def _mean(x: torch.Tensor, dim: Optional[int], cut: Optional[int], shard: Optional[Shard],
              n: int, sums: list, keepdim: bool = False) -> torch.Tensor:
        """The mean of ``x`` over its dim ``dim`` (every dim when None) as
        the whole parameter's: when the reduction spans ``cut`` (the dim of
        ``x`` that holds the shard's cut, or None), the chunk's rows inside
        the parameter are summed and divided by the logical count ``n``, and
        the result, appended to ``sums``, is whole only once the caller
        has all-reduced it over the shard's group."""
        spans = shard is not None and cut is not None and dim in (None, cut)
        if not spans:
            return x.mean() if dim is None else x.mean(dim, keepdim=keepdim)
        x = x.narrow(cut, 0, shard.valid(x.shape[cut]))
        s = (x.sum() if dim is None else x.sum(dim, keepdim=keepdim)) / n
        if shard.group is not None:
            sums.append((s, shard.group))
        return s

    @staticmethod
    def _clear_pad(t: torch.Tensor, cut: Optional[int], shard: Optional[Shard]) -> None:
        """Zero the rows of state tensor ``t`` past the parameter's logical
        size along ``cut`` (its dim that holds the shard's cut, if any)."""
        if shard is None or cut is None:
            return
        valid = shard.valid(t.shape[cut])
        if valid < t.shape[cut]:
            t.narrow(cut, valid, t.shape[cut] - valid).zero_()

    def _update(self, p, st, lr, decay, keep):
        """``p``'s update in three rounds: each yields the list of partial
        means (``(tensor, group)``) that ``step`` must all-reduce before the
        next round reads them; the last writes ``p``."""
        shard = self._shards.get(p)
        logical = self.logical_shape(p)
        cut = shard.dim if shard is not None else None
        numel = int(np.prod(logical))
        f32 = torch.float32
        g = p.grad.to(f32)
        grad_sqr = g * g + EPSILON
        dims = factored_dims(logical)
        # Round 1: the squared gradient's row and column means, and the
        # parameter's mean square (scale_by_param_block_rms reads p before
        # the update).
        sums = []
        pf = p.to(f32)
        p_ms = self._mean(pf * pf, None, cut, shard, numel, sums)
        if dims is not None:
            d1, d0 = dims
            row = self._mean(grad_sqr, d0, cut, shard, logical[d0], sums)
            col = self._mean(grad_sqr, d1, cut, shard, logical[d1], sums)
        yield sums
        # Round 2: the second moment, and the factored row statistic's mean.
        sums = []
        if dims is not None:
            v_row, v_col = st["v_row"], st["v_col"]
            v_row.copy_(v_row.to(f32) * decay + row * keep)
            v_col.copy_(v_col.to(f32) * decay + col * keep)
            # v_row lacks d0: its dim reduced_d1 is d1, and it holds the
            # shard's cut unless the cut is d0 (then v_row is whole here).
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_cut = None if cut in (None, d0) else (cut - 1 if cut > d0 else cut)
            row_col_mean = self._mean(v_row.to(f32), reduced_d1, row_cut, shard, logical[d1],
                                      sums, keepdim=True)
        else:
            v = st["v"]
            v.copy_(v.to(f32) * decay + grad_sqr * keep)
            update = g * v.to(f32).pow(-0.5)
            self._clear_pad(v, cut, shard)
        yield sums
        # Round 3: the update, and its mean square for clip_by_block_rms.
        sums = []
        if dims is not None:
            row_factor = (v_row.to(f32) / row_col_mean).pow(-0.5)
            col_factor = v_col.to(f32).pow(-0.5)
            update = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            self._clear_pad(v_row, row_cut, shard)
            self._clear_pad(v_col, None if cut in (None, d1) else (cut - 1 if cut > d1 else cut),
                            shard)
        u_ms = self._mean(update * update, None, cut, shard, numel, sums)
        yield sums
        update = update / torch.clamp_min(u_ms.sqrt() / CLIPPING_THRESHOLD, 1.0)
        update = update * lr
        # scale_by_param_block_rms: the parameter's RMS, at least min_scale.
        update = update * torch.clamp_min(p_ms.sqrt(), MIN_PARAM_SCALE)
        p.sub_(update.to(p.dtype))
