"""Saver: checkpoints under the JAX package's names and in its formats
(the port's copy of ``autodist_tpu/checkpoint/saver.py``), so a run saved
by either package restores in the other.

- Names. Parameters are the JAX tree's ``/``-joined paths
  (``block_0/attn/query/kernel``, the state dict's ``block_0.attn.query.kernel``);
  Adam's state is ``__opt__/0/count``, ``__opt__/0/mu/<name>`` and
  ``__opt__/0/nu/<name>``, the names ``optax.adam`` and ``optax.adamw`` give
  it (torch's ``step``, ``exp_avg`` and ``exp_avg_sq``); the step is
  ``__step__``.
- Write: the single-file v1 format, ``<prefix>-<step>.npz`` with its
  ``.json`` manifest, and the directory's ``checkpoint`` state file
  (``{"latest", "all"}``, merged per name); ``max_to_keep`` rotation;
  async double-buffered writes joined by :meth:`Saver.wait`.
- Read: v1 and the sharded v2 format (per-process ``.shardNNNNN-of-NNNNN.npz``
  files and a manifest of index slices), assembled into whole tensors.

The only plan ported keeps every tensor replicated, so with several ranks
rank 0 writes v1 and the others wait at a barrier; writing v2 belongs with
the partitioned plans and raises until then.
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

from autodist_tpu_torch.model_spec import _path_name
from autodist_tpu_torch.runner import TrainState

_log = logging.getLogger("autodist_tpu_torch")

_OPT_PREFIX = "__opt__/"
_STEP_KEY = "__step__"
_STATE_FILE = "checkpoint"  # the directory's latest-pointer, like TF's
_COUNT = "0/count"
_MOMENTS = {"exp_avg": "0/mu/", "exp_avg_sq": "0/nu/"}
# torch optimizers whose state maps onto an optax one's names.
MAPPED_OPTIMIZERS = (torch.optim.Adam, torch.optim.AdamW)

V2_ROADMAP = ("writing the sharded (v2) checkpoint format is not ported yet; it comes "
              "with the partitioned plans (ROADMAP.md, Queue 1: the v2 sharded write)")


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
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        raise NotImplementedError("bfloat16 tensors have no numpy dtype to write in v1")
    return t.numpy().copy()


def _require_mapped(optimizer: torch.optim.Optimizer):
    if not isinstance(optimizer, MAPPED_OPTIMIZERS) or any(
            g.get("amsgrad") for g in optimizer.param_groups):
        raise NotImplementedError(
            f"the state of {type(optimizer).__name__} has no mapping onto the JAX "
            f"package's checkpoint names; mapped: torch.optim.Adam and "
            f"torch.optim.AdamW with amsgrad=False (optax.adam, optax.adamw)")


def _flatten_state(state: TrainState) -> Dict[str, np.ndarray]:
    """``{name: host array}`` of a TrainState under the JAX names."""
    _require_mapped(state.optimizer)
    flat = {_path_name(k): _host(v) for k, v in state.params.items()}
    key_of = {id(t): k for k, t in state.params.items()}
    counts = set()
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            name = _path_name(key_of[id(p)])
            st = state.optimizer.state.get(p, {})
            counts.add(int(st["step"]) if "step" in st else 0)
            for field, prefix in _MOMENTS.items():
                value = st.get(field)
                flat[_OPT_PREFIX + prefix + name] = (
                    _host(value) if value is not None else np.zeros(tuple(p.shape), np.float32))
    if len(counts) > 1:
        raise ValueError(f"the optimizer's parameters have stepped {sorted(counts)} times; "
                         f"optax keeps one count")
    flat[_OPT_PREFIX + _COUNT] = np.asarray(counts.pop() if counts else 0, np.int32)
    return flat


def _load_optimizer(state: TrainState, opt_flat: Mapping[str, torch.Tensor]):
    """The checkpoint's Adam state into ``state.optimizer`` through
    ``load_state_dict`` (which casts the moments to each parameter's dtype
    and device)."""
    optimizer = state.optimizer
    _require_mapped(optimizer)
    count = float(opt_flat[_COUNT])
    key_of = {id(t): k for k, t in state.params.items()}
    entries, index = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = _path_name(key_of[id(p)])
            entry = {"step": torch.tensor(count)}
            for field, prefix in _MOMENTS.items():
                if prefix + name not in opt_flat:
                    raise KeyError(f"Checkpoint missing optimizer state {_OPT_PREFIX}{prefix}{name}")
                entry[field] = opt_flat[prefix + name]
            entries[index] = entry
            index += 1
    optimizer.load_state_dict({"state": entries,
                               "param_groups": optimizer.state_dict()["param_groups"]})


class Saver:
    """Save and restore train state or bare params under the JAX names."""

    def __init__(self, max_to_keep: int = 5):
        self._max_to_keep = max_to_keep
        self._kept: List[str] = []
        self._rotation_loaded = False
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None
        self._barrier_pending = False

    # ------------------------------------------------------------------- save
    def save(self, state_or_params, save_path: str, global_step: Optional[int] = None,
             sharded: Optional[bool] = None, async_write: bool = False) -> str:
        """Write ``<save_path>-<step>`` (v1) from a :class:`TrainState`
        (params, Adam state and step) or a bare ``{state-dict key: tensor}``
        dict (step 0); returns the prefix. ``global_step`` overrides the
        step for both the file name and the stored step. With several ranks
        this is collective: every rank calls it, rank 0 writes, and every
        rank returns (or, with ``async_write``, leaves :meth:`wait`) once the
        files are down. ``async_write`` copies to the host now and writes
        on a background thread; a new save first joins the previous one."""
        self.wait()
        if sharded:
            raise NotImplementedError(V2_ROADMAP)
        rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() \
            else (0, 1)
        step = int(state_or_params.step) if isinstance(state_or_params, TrainState) else 0
        if global_step is not None:
            step = global_step
        prefix = f"{save_path}-{step}"
        if rank == 0:
            if isinstance(state_or_params, TrainState):
                host = _flatten_state(state_or_params)
            else:
                host = {_path_name(k): _host(v) for k, v in state_or_params.items()}
            host[_STEP_KEY] = np.asarray(step)
            os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
            self._run_write(async_write, self._write_single_file, host, save_path, prefix,
                            step)
        if world > 1:
            self._barrier_pending = True
            if not async_write:
                self.wait()
        return prefix

    def wait(self):
        """Join an in-flight async write (re-raising its failure) and, after
        a multi-rank save, meet the other ranks at the barrier."""
        t = self._pending
        if t is not None:
            t.join()
            self._pending = None
        if self._barrier_pending:
            self._barrier_pending = False
            dist.barrier()
        err, self._pending_error = self._pending_error, None
        if err is not None:
            raise RuntimeError("async checkpoint write failed") from err

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
                    "params": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
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
                flat = {k: torch.from_numpy(z[k]) for k in z.files}
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
        (params, optimizer state and step). Without: the params, as
        :meth:`restore_params` gives them."""
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
        state.step = step
        return state
