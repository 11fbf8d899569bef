"""Saver: checkpoints under the JAX package's names and in its formats
(the port's copy of ``autodist_tpu/checkpoint/saver.py``), so a run saved
by either package restores in the other.

- Names. Parameters are the JAX tree's ``/``-joined paths
  (``block_0/attn/query/kernel``, the state dict's ``block_0.attn.query.kernel``);
  the optimizer's state takes the names the JAX ``Saver`` gives its optax
  counterpart's (its state flattened, ``autodist_tpu/checkpoint/saver.py:250``):
  Adam and AdamW (no amsgrad) are ``optax.adam``/``optax.adamw``,
  ``__opt__/0/count``, ``__opt__/0/mu/<name>`` and ``__opt__/0/nu/<name>``
  (torch's ``step``, ``exp_avg`` and ``exp_avg_sq``); the port's
  :class:`~autodist_tpu_torch.optimizers.Adafactor` is ``optax.adafactor``,
  ``__opt__/0/count``, ``__opt__/0/v_row/<name>``, ``__opt__/0/v_col/<name>``
  and ``__opt__/0/v/<name>`` in optax's shapes (placeholders ``(1,)``);
  ``torch.optim.SGD`` with momentum (no Nesterov, no dampening, no weight
  decay) is ``optax.sgd(lr, momentum)``, ``__opt__/0/trace/<name>`` (torch's
  ``momentum_buffer``), and without momentum ``optax.sgd(lr)``, which has
  no state leaf. The step is ``__step__``.
- Write: the single-file v1 format, ``<prefix>-<step>.npz`` with its
  ``.json`` manifest, and the sharded v2 format, each rank's
  ``<prefix>-<step>.shardNNNNN-of-NNNNN.npz`` of the chunks it owns (the
  lowest rank holding a chunk writes it) and rank 0's manifest of index
  ranges over the logical shapes, published after every rank's file landed
  (two barriers: no rank returns before the manifest exists). bfloat16 is
  stored as the JAX package stores it: a 2-byte void (``V2``) array in v1,
  with ``"bfloat16"`` in the manifest, and uint16 in v2. Tensors are
  written at their logical shapes (padded storage is cut back), so either
  package restores either format onto any layout. The directory's
  ``checkpoint`` state file (``{"latest", "all"}``, merged per name);
  ``max_to_keep`` rotation; async double-buffered writes joined by
  :meth:`Saver.wait`.
- ``sharded=None`` writes v2 when some tensor is sharded across ranks (a
  model-axis shard, a PS or ZeRO optimizer shard), else v1 from rank 0;
  ``sharded=False`` gathers every shard and rank 0 writes v1 at the full
  logical shapes (the JAX package's gather-on-save).
- Read: either format, assembled into whole tensors and placed as the
  reading runner's layout says; a v1 ``V2`` array reads back as bfloat16
  with the same bits.
- Codec state: PowerSGD's Q is saved as ``__ef__/<name>/q`` and restored
  when the shapes match; error-feedback residuals are per-rank transients
  and are not saved, as in the JAX package.
"""

import glob
import json
import logging
import os
import re
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import optimizers
from autodist_tpu_torch.model_spec import _path_name
from autodist_tpu_torch.parallel.layout import StateLayout, spec_owner, spec_ranges
from autodist_tpu_torch.runner import TrainState

_log = logging.getLogger("autodist_tpu_torch")

_OPT_PREFIX = "__opt__/"
_EF_PREFIX = "__ef__/"
_STEP_KEY = "__step__"
_STATE_FILE = "checkpoint"  # the directory's latest-pointer, like TF's
_COUNT = "0/count"
# Per optimizer kind: {torch state field: optax leaf prefix}, and whether
# the state has optax's count.
_FIELDS = {"adam": ({"exp_avg": "0/mu/", "exp_avg_sq": "0/nu/"}, True),
           "adafactor": ({f: f"0/{f}/" for f in optimizers.STATE_FIELDS}, True),
           "sgd_momentum": ({"momentum_buffer": "0/trace/"}, False),
           "sgd": ({}, False)}
MAPPED = ("torch.optim.Adam and torch.optim.AdamW with amsgrad=False (optax.adam, "
          "optax.adamw), autodist_tpu_torch.optimizers.Adafactor (optax.adafactor), "
          "torch.optim.SGD with dampening=0, nesterov=False, weight_decay=0 and "
          "maximize=False (optax.sgd, with or without momentum)")

def _is_sharded_manifest(path: str) -> bool:
    try:
        with open(path) as f:
            return json.load(f).get("format") == "sharded"
    except (ValueError, OSError):
        return False


def _scan_checkpoints(base: str):
    """``[(step, prefix)]`` of every checkpoint of ``base`` on disk (a
    ``<base>-<step>.npz`` or a sharded ``<base>-<step>.json``), by step."""
    found = {}
    for path in glob.glob(glob.escape(base) + "-*.npz"):
        m = re.fullmatch(re.escape(base) + r"-(\d+)\.npz", path)
        if m:
            found[int(m.group(1))] = path[:-len(".npz")]
    for path in glob.glob(glob.escape(base) + "-*.json"):
        m = re.fullmatch(re.escape(base) + r"-(\d+)\.json", path)
        if m and int(m.group(1)) not in found and _is_sharded_manifest(path):
            found[int(m.group(1))] = path[:-len(".json")]
    return sorted(found.items())


def checkpoint_exists(prefix: str) -> bool:
    """True when ``prefix`` names a complete checkpoint (either format)."""
    return os.path.exists(prefix + ".npz") or _is_sharded_manifest(prefix + ".json")


def _read_recorded(save_path: str):
    """The state file's path, its recorded rotation list, and the pattern of
    this name's prefixes."""
    state_path = os.path.join(os.path.dirname(save_path) or ".", _STATE_FILE)
    recorded = []
    if os.path.exists(state_path):
        try:
            with open(state_path) as f:
                recorded = json.load(f).get("all") or []
        except (ValueError, OSError):
            recorded = []
    return state_path, recorded, re.compile(re.escape(save_path) + r"-\d+")


def _decode(data: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a tensor of its recorded dtype (bfloat16 is stored
    as uint16)."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(data).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(data.astype(np.dtype(dtype), copy=False)))


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as the v1 file holds it: a bfloat16 tensor as a 2-byte void
    array, what numpy writes for the JAX package's bfloat16 leaves."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.dtype("V2")).copy()
    return t.numpy().copy()


def _v1_dtype(data: np.ndarray) -> str:
    """The manifest's dtype of a v1 array: "bfloat16" for a 2-byte void one."""
    return "bfloat16" if data.dtype == np.dtype("V2") else str(data.dtype)


def _from_v1(data: np.ndarray) -> torch.Tensor:
    """A v1 array as a tensor: a 2-byte void array (the JAX package's and
    this package's bfloat16) as bfloat16, bit for bit."""
    if data.dtype == np.dtype("V2"):
        return _decode(data.view(np.uint16), "bfloat16")
    return torch.from_numpy(data)


def _encode(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor as an npz-safe array and its dtype's name (bfloat16 is
    stored as uint16, as the JAX package stores it)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
    data = t.numpy().copy()
    return data, str(data.dtype)


def _kind(optimizer: torch.optim.Optimizer) -> str:
    """Which optax optimizer's names ``optimizer``'s state maps onto (a key
    of ``_FIELDS``); any other optimizer raises."""
    groups = optimizer.param_groups
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)) and not any(
            g.get("amsgrad") for g in groups):
        return "adam"
    if isinstance(optimizer, optimizers.Adafactor):
        return "adafactor"
    if type(optimizer) is torch.optim.SGD and all(
            g["dampening"] == 0 and not g["nesterov"] and g["weight_decay"] == 0
            and not g.get("maximize") for g in groups):
        momentum = {g["momentum"] != 0 for g in groups}
        if len(momentum) == 1:
            return "sgd_momentum" if momentum.pop() else "sgd"
    raise NotImplementedError(
        f"the state of {type(optimizer).__name__} (with these settings) has no mapping onto "
        f"the JAX package's checkpoint names; mapped: {MAPPED}")


def _zero_pad(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` zero-padded at the end of each dim to ``shape``."""
    if tuple(t.shape) == tuple(shape):
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, d) for d in t.shape)] = t
    return out


def _factored_entry(state: TrainState, key: str, field: str, param: torch.Tensor):
    """``(drop, pspec, global shape, logical shape)`` of Adafactor's
    ``field`` for parameter ``key``: ``drop`` the parameter's dim it lacks
    (None: the parameter's own shape; "placeholder": optax's ``(1,)``), and
    its layout the parameter's optimizer layout without that dim."""
    logical = tuple(state.layout.by_key[key].plan.shape) if state.layout is not None \
        else tuple(param.shape)
    drop = optimizers.removed_dim(field, logical)
    if drop == "placeholder":
        return drop, (), (1,), (1,)
    if state.layout is None:
        shape = optimizers.drop_dim(tuple(param.shape), drop)
        return drop, (), shape, shape
    p = state.layout.by_key[key].plan
    pspec = tuple(p.opt_pspec) + (None,) * (len(p.storage_shape) - len(p.opt_pspec))
    pspec, glob, logi = (optimizers.drop_dim(x, drop)
                         for x in (pspec, tuple(p.storage_shape), tuple(p.shape)))
    if not any(e is not None for e in pspec):
        pspec = ()
    return drop, pspec, glob, logi


def _state_tensors(state: TrainState):
    """``[(name, local tensor, pspec, global shape, logical shape)]`` of a
    TrainState under the JAX names, each as this rank holds it: the
    parameters, the optimizer's state (its mapping's fields and count), and
    PowerSGD's Q."""
    kind = _kind(state.optimizer)
    fields, has_count = _FIELDS[kind]

    def entry(name, key, t, opt=False):
        if state.layout is None:
            return name, t, (), tuple(t.shape), tuple(t.shape)
        p = state.layout.by_key[key].plan
        return name, t, p.opt_pspec if opt else p.pspec, p.storage_shape, p.shape

    out = [entry(_path_name(key), key, t) for key, t in state.params.items()]
    opt_params = state.opt_params or state.params
    key_of = {id(t): k for k, t in opt_params.items()}
    counts = set()
    for group in state.optimizer.param_groups:
        for param in group["params"]:
            key = key_of[id(param)]
            st = state.optimizer.state.get(param, {})
            step = st.get("count", st.get("step"))
            counts.add(int(step) if step is not None else 0)
            for field, prefix in fields.items():
                name = _OPT_PREFIX + prefix + _path_name(key)
                value = st.get(field)
                if kind != "adafactor":
                    if value is None:
                        value = torch.zeros_like(param, dtype=torch.float32)
                    out.append(entry(name, key, value, opt=True))
                    continue
                _, pspec, glob, logi = _factored_entry(state, key, field, param)
                if value is None:   # not stepped yet: optax's zeros, in this rank's shape
                    shape = optimizers.state_shapes(
                        param.shape, state.optimizer.logical_shape(param))[field]
                    value = torch.zeros(shape, dtype=param.dtype, device=param.device)
                out.append((name, value, pspec, glob, logi))
    if len(counts) > 1:
        raise ValueError(f"the optimizer's parameters have stepped {sorted(counts)} times; "
                         f"optax keeps one count")
    if has_count:
        count = torch.tensor(counts.pop() if counts else 0, dtype=torch.int32)
        out.append((_OPT_PREFIX + _COUNT, count, (), (), ()))
    out += [(f"{_EF_PREFIX}{_path_name(key)}/q", e["q"], (), tuple(e["q"].shape),
             tuple(e["q"].shape)) for key, e in state.ef_state.items() if "q" in e]
    return out


def _gathered(layout: Optional[StateLayout], tensors, keep: bool) -> Dict[str, np.ndarray]:
    """``{name: host array}`` at the full logical shapes, each sharded tensor
    all-gathered first (a collective: every rank calls it); only a rank with
    ``keep`` copies to the host."""
    host = {}
    for name, t, pspec, _, logical in tensors:
        if pspec:
            full = layout.gather(t.detach(), pspec)
            t = full[tuple(slice(0, d) for d in logical)]
        if keep:
            host[name] = _host(t)
    return host


def _factored_chunk(state: TrainState, key: str, field: str, param: torch.Tensor,
                    value: torch.Tensor) -> torch.Tensor:
    """This rank's chunk of Adafactor's logical-shape ``field`` of ``key``:
    zero-padded to the padded parameter's shape without the dim the field
    lacks, then cut to the optimizer tensor's ranges there."""
    drop, _, glob, _ = _factored_entry(state, key, field, param)
    if drop == "placeholder" or state.layout is None:
        return value
    ranges = optimizers.drop_dim(state.layout.update_chunk(key)[0], drop)
    value = _zero_pad(value, glob)
    return value[tuple(slice(a, b) for a, b in ranges)]


def _load_optimizer(state: TrainState, opt_flat: Mapping[str, torch.Tensor]):
    """The checkpoint's optimizer state into ``state.optimizer`` through
    ``load_state_dict`` (which casts each field to its parameter's dtype and
    device), each field cut to this rank's share of it."""
    optimizer = state.optimizer
    kind = _kind(optimizer)
    fields, has_count = _FIELDS[kind]
    if not fields:
        return
    count = None
    if has_count:
        count = torch.tensor(int(opt_flat[_COUNT]), dtype=torch.int32) if kind == "adafactor" \
            else torch.tensor(float(opt_flat[_COUNT]))
    layout = state.layout
    opt_params = state.opt_params or state.params
    key_of = {id(t): k for k, t in opt_params.items()}
    entries, index = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            key = key_of[id(p)]
            name = _path_name(key)
            # torch's Adam steps each parameter's own counter in place;
            # Adafactor's one count is shared (load_state_dict shares it again).
            entry = {} if count is None else \
                {"count": count} if kind == "adafactor" else {"step": count.clone()}
            for field, prefix in fields.items():
                if prefix + name not in opt_flat:
                    raise KeyError(f"Checkpoint missing optimizer state {_OPT_PREFIX}{prefix}{name}")
                value = opt_flat[prefix + name]
                if kind == "adafactor":
                    value = _factored_chunk(state, key, field, p, value)
                elif layout is not None:
                    value = layout.to_update(key, layout.to_storage(key, value))
                entry[field] = value.clone(memory_format=torch.contiguous_format)
            entries[index] = entry
            index += 1
    optimizer.load_state_dict({"state": entries,
                               "param_groups": optimizer.state_dict()["param_groups"]})


def _mesh_coords(layout: StateLayout, rank: int) -> Dict[str, int]:
    shape = layout.mesh.shape
    return {a: int(c) for a, c in zip(shape, np.unravel_index(rank, tuple(shape.values())))}


def _sharded_entries(layout: Optional[StateLayout], tensors, rank: int, world: int):
    """The v2 manifest's tensors and this rank's ``{key: array}`` of the
    chunks it owns. Every chunk is clipped to the logical shape (padded
    storage is cut back; a chunk wholly in the pad is not written) and
    written once, by the lowest rank holding it."""
    manifest, own = {}, {}
    for name, t, pspec, shape, logical in tensors:
        chunks = {}
        for r in range(world) if pspec else (0,):
            coords = _mesh_coords(layout, r) if pspec else None
            if pspec and not spec_owner(pspec, layout.mesh, coords):
                continue
            ranges = spec_ranges(pspec, shape, layout.mesh, coords) if pspec else \
                tuple((0, d) for d in shape)
            clipped = tuple((a, min(b, d)) for (a, b), d in zip(ranges, logical))
            if not any(a >= b for a, b in clipped):
                chunks.setdefault(clipped, r)
        dtype = _encode(t.detach().reshape(-1)[:0])[1]
        shards = []
        for j, (index, owner) in enumerate(sorted(chunks.items())):
            key = f"{name}#{j}"
            shards.append({"key": key, "file": owner, "index": [list(x) for x in index]})
            if owner == rank:
                own[key] = _encode(t.detach()[tuple(slice(0, b - a) for a, b in index)])[0]
        manifest[name] = {"shape": [int(d) for d in logical], "dtype": dtype,
                          "shards": shards}
    return manifest, own


class Saver:
    """Save and restore train state or bare params under the JAX names."""

    def __init__(self, max_to_keep: int = 5):
        self._max_to_keep = max_to_keep
        self._kept: List[str] = []
        self._rotation_loaded = False
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None
        self._barrier_pending = False
        self._publish = None

    # ------------------------------------------------------------------- save
    def save(self, state_or_params, save_path: str, global_step: Optional[int] = None,
             sharded: Optional[bool] = None, async_write: bool = False) -> str:
        """Write ``<save_path>-<step>`` from a :class:`TrainState` (params,
        Adam state, PowerSGD's Q and step) or a bare ``{state-dict key:
        tensor}`` dict of logical tensors (step 0; a runner's
        ``logical_params`` gives them); returns the prefix. ``global_step`` overrides the
        step for both the file name and the stored step. ``sharded``: True
        writes v2, False gathers and writes v1, None writes v2 when some
        tensor is sharded across ranks. With several ranks this is
        collective: every rank calls it and every rank returns (or, with
        ``async_write``, leaves :meth:`wait`) once the checkpoint is
        complete on disk. ``async_write`` copies to the host now and writes
        on a background thread; a new save first joins the previous one."""
        self.wait()
        rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() \
            else (0, 1)
        is_state = isinstance(state_or_params, TrainState)
        layout = state_or_params.layout if is_state else None
        step = int(state_or_params.step) if is_state else 0
        if global_step is not None:
            step = global_step
        prefix = f"{save_path}-{step}"
        if is_state:
            tensors = _state_tensors(state_or_params)
        else:
            tensors = [(_path_name(k), t, (), tuple(t.shape), tuple(t.shape))
                       for k, t in state_or_params.items()]
        if sharded is None:
            sharded = layout is not None and layout.plan.has_sharded_state and world > 1
        if rank == 0:
            os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        if sharded:
            if world > 1:
                dist.barrier()   # the directory exists before any rank writes
            manifest, own = _sharded_entries(layout, tensors, rank, world)
            base = os.path.basename(prefix)
            writers = sorted({sh["file"] for t in manifest.values() for sh in t["shards"]})
            manifest = {"format": "sharded", "step": step, "process_count": world,
                        "files": {str(r): f"{base}.shard{r:05d}-of-{world:05d}.npz"
                                  for r in writers},
                        "tensors": manifest}
            self._publish = (manifest, save_path, prefix, step, rank, world)
            if rank in writers:
                self._run_write(async_write, self._write_shard_file, own, manifest, prefix,
                                rank)
            if not async_write:
                self.wait()
            return prefix
        host = _gathered(layout, tensors, keep=rank == 0)
        if rank == 0:
            host[_STEP_KEY] = np.asarray(step)
            self._run_write(async_write, self._write_single_file, host, save_path, prefix,
                            step)
        if world > 1:
            self._barrier_pending = True
            if not async_write:
                self.wait()
        return prefix

    def wait(self):
        """Join an in-flight async write (re-raising its failure) and, after
        a multi-rank save, meet the other ranks: at a barrier after a v1
        write; after a v2 write, at a barrier once every rank's shard file
        is down, then (rank 0 having published the manifest) at a second."""
        t = self._pending
        if t is not None:
            t.join()
            self._pending = None
        err, self._pending_error = self._pending_error, None
        if err is not None:
            self._publish = None
            raise RuntimeError("async checkpoint write failed") from err
        if self._barrier_pending:
            self._barrier_pending = False
            dist.barrier()
        if self._publish is not None:
            manifest, save_path, prefix, step, rank, world = self._publish
            self._publish = None
            if world > 1:
                dist.barrier()
            if rank == 0:
                self._write_manifest(manifest, save_path, prefix, step)
            if world > 1:
                dist.barrier()

    def _write_shard_file(self, own: Dict[str, np.ndarray], manifest: dict, prefix: str,
                          rank: int):
        path = os.path.join(os.path.dirname(prefix) or ".", manifest["files"][str(rank)])
        with open(path + ".tmp", "wb") as f:
            np.savez(f, **own)
        os.replace(path + ".tmp", path)

    def _write_manifest(self, manifest: dict, save_path: str, prefix: str, step: int):
        tmp = prefix + ".json.tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, prefix + ".json")
        self._load_rotation_state(save_path)
        self._rotate(prefix)
        self._update_state_file(save_path, prefix)
        _log.info("Saved sharded checkpoint %s (step %d, %d tensors, %d writer ranks)",
                  prefix, step, len(manifest["tensors"]), len(manifest["files"]))

    def _run_write(self, async_write: bool, fn, *args):
        if not async_write:
            fn(*args)
            return

        def run():
            try:
                fn(*args)
            except BaseException as e:  # noqa: BLE001 - surfaced by the next wait()
                self._pending_error = e
                _log.error("async checkpoint write failed: %s", e)

        self._pending = threading.Thread(target=run, daemon=True, name="autodist-ckpt-write")
        self._pending.start()

    def _write_single_file(self, host: Dict[str, np.ndarray], save_path: str, prefix: str,
                           step: int):
        tmp = prefix + ".npz.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **host)
        os.replace(tmp, prefix + ".npz")  # atomic publish
        manifest = {"step": step,
                    "params": {k: {"shape": list(v.shape), "dtype": _v1_dtype(v)}
                               for k, v in host.items() if not k.startswith("__")}}
        tmp = prefix + ".json.tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, prefix + ".json")
        self._load_rotation_state(save_path)
        self._rotate(prefix)
        self._update_state_file(save_path, prefix)
        _log.info("Saved checkpoint %s (step %d, %d tensors)", prefix, step, len(host))

    def _load_rotation_state(self, save_path: str):
        """Adopt this name's checkpoints already on disk (those the state
        file records for it, when it records any), so a restarted run keeps
        rotating them."""
        if self._rotation_loaded:
            return
        self._rotation_loaded = True
        on_disk = [prefix for _, prefix in _scan_checkpoints(save_path)]
        _, recorded, name_pat = _read_recorded(save_path)
        ours = {p for p in recorded if name_pat.fullmatch(p)}
        if ours:
            on_disk = [p for p in on_disk if p in ours]
        for prefix in on_disk:
            if prefix not in self._kept:
                self._kept.append(prefix)

    def _update_state_file(self, save_path: str, prefix: str):
        """Rewrite the shared state file, replacing only this name's entries."""
        state_path, recorded, name_pat = _read_recorded(save_path)
        others = [p for p in recorded if not name_pat.fullmatch(p) and p not in self._kept]
        with open(state_path, "w") as f:
            json.dump({"latest": prefix, "all": others + list(self._kept)}, f)

    def _rotate(self, prefix: str):
        if prefix in self._kept:
            self._kept.remove(prefix)
        self._kept.append(prefix)
        while len(self._kept) > self._max_to_keep:
            victim = self._kept.pop(0)
            doomed = {victim + ".npz", victim + ".json"}
            doomed.update(glob.glob(glob.escape(victim) + ".shard*-of-*.npz"))
            for path in doomed:
                try:
                    os.remove(path)
                except OSError:
                    pass

    # ---------------------------------------------------------------- restore
    @staticmethod
    def latest_checkpoint(directory: str, name: Optional[str] = None) -> Optional[str]:
        """The newest checkpoint prefix in ``directory``; with ``name``, the
        newest saved as ``<name>-<step>``."""
        state_path = os.path.join(directory, _STATE_FILE)
        latest = None
        if os.path.exists(state_path):
            with open(state_path) as f:
                latest = json.load(f).get("latest")
        if name is None:
            return latest
        if latest and re.fullmatch(re.escape(name) + r"-\d+", os.path.basename(latest)) \
                and checkpoint_exists(latest):
            return latest
        found = _scan_checkpoints(os.path.join(directory, name))
        return found[-1][1] if found else None

    @staticmethod
    def _load_flat(prefix: str) -> Tuple[Dict[str, torch.Tensor], int]:
        """``({name: tensor}, step)`` from either format."""
        if os.path.exists(prefix + ".npz"):
            with np.load(prefix + ".npz") as z:
                flat = {k: _from_v1(z[k]) for k in z.files}
            step = int(flat.pop(_STEP_KEY, torch.tensor(0)))
            return flat, step
        try:
            with open(prefix + ".json") as f:
                manifest = json.load(f)
        except OSError:
            raise FileNotFoundError(f"No checkpoint at {prefix!r} (neither {prefix}.npz nor "
                                    f"a sharded manifest {prefix}.json exists)") from None
        if manifest.get("format") != "sharded":
            raise FileNotFoundError(f"{prefix}.json is not a sharded-checkpoint manifest and "
                                    f"{prefix}.npz does not exist")
        dirname = os.path.dirname(prefix) or "."
        files: Dict[str, Any] = {}
        flat = {}
        try:
            for name, t in manifest["tensors"].items():
                storage = np.uint16 if t["dtype"] == "bfloat16" else np.dtype(t["dtype"])
                out = np.empty([int(d) for d in t["shape"]], storage)
                for sh in t["shards"]:
                    fname = manifest["files"][str(sh["file"])]
                    if fname not in files:
                        files[fname] = np.load(os.path.join(dirname, fname))
                    data = files[fname][sh["key"]]
                    if out.ndim == 0:
                        out[()] = data.reshape(())
                    else:
                        out[tuple(slice(a, b) for a, b in sh["index"])] = data
                flat[name] = _decode(out, t["dtype"])
        finally:
            for z in files.values():
                z.close()
        return flat, int(manifest["step"])

    def restore_params(self, prefix: str) -> Dict[str, torch.Tensor]:
        """The parameters as a flat ``{state-dict key: tensor}`` dict."""
        flat, _ = self._load_flat(prefix)
        return {k.replace("/", "."): v for k, v in flat.items() if not k.startswith("__")}

    def restore(self, prefix: str, runner=None):
        """With ``runner``: a :class:`TrainState` on the runner's device
        (params, optimizer state, PowerSGD's Q and step), each rank holding
        its own shards of them as the runner's layout says. Without: the
        params, as :meth:`restore_params` gives them."""
        if runner is None:
            return self.restore_params(prefix)
        flat, step = self._load_flat(prefix)
        params = {k: v for k, v in flat.items() if not k.startswith("__")}
        spec = runner._model_spec
        missing = [n for n in spec.names if n not in params]
        if missing:
            raise KeyError(f"Checkpoint missing parameter {missing[0]!r}")
        state = runner.init({spec.keys[n]: params[n] for n in spec.names})
        opt_flat = {k[len(_OPT_PREFIX):]: v for k, v in flat.items()
                    if k.startswith(_OPT_PREFIX)}
        if opt_flat:
            _load_optimizer(state, opt_flat)
        for key, entry in state.ef_state.items():
            q = flat.get(f"{_EF_PREFIX}{_path_name(key)}/q")
            if q is not None and "q" in entry and tuple(q.shape) == tuple(entry["q"].shape):
                entry["q"] = q.to(device=entry["q"].device, dtype=entry["q"].dtype)
        state.step = step
        return state
