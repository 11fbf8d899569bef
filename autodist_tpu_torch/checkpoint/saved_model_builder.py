"""The serving artifact (the port of
``autodist_tpu/checkpoint/saved_model_builder.py``).

A directory with:

- ``params.npz`` — the full parameters under their original names, written
  by the port's :class:`~autodist_tpu_torch.checkpoint.saver.Saver` (v1,
  which takes f32 tensors: the flagship keeps its params in f32);
- ``model_config.json`` — user-provided model metadata (enough to rebuild
  the apply function);
- ``apply.export`` — the EXECUTABLE serving graph: ``apply_fn`` traced by
  ``torch.export`` and written with ``torch.export.save``.
  :meth:`SavedModelBuilder.load_serving_fn` loads and runs it with no model
  code imported. Where JAX lowers one artifact for the current backend plus
  ``cpu``, an exported program holds the device of its example arguments
  (their constants and device-side ``arange`` calls are baked in): the
  loader serves on that device and raises, naming it, when another is
  asked for; it never moves the graph to the CPU behind the caller's back.
  ``apply.device`` names that device;
- ``apply.hlo`` — the same graph printed (the exported program's FX code),
  for inspection (JAX writes StableHLO text under this name).
"""

import json
import os
from typing import Any, Callable, Optional

import torch

from autodist_tpu_torch.checkpoint.saver import Saver
from autodist_tpu_torch.utils import logging

EXPORT_FILES = ("apply.export", "apply.hlo", "apply.device")


class _Traced(torch.nn.Module):
    """``apply_fn`` as the module ``torch.export`` traces."""

    def __init__(self, apply_fn: Callable):
        super().__init__()
        self.apply_fn = apply_fn

    def forward(self, params, *args):
        return self.apply_fn(params, *args)


def _device_of(params, args) -> torch.device:
    for t in list(args) + list(params.values()):
        if torch.is_tensor(t):
            return t.device
    return torch.device("cpu")


class SavedModelBuilder:
    def __init__(self, export_dir: str):
        self._export_dir = export_dir
        os.makedirs(export_dir, exist_ok=True)

    def save(self, params: Any, model_config: Optional[dict] = None,
             apply_fn: Optional[Callable] = None, example_args: tuple = (),
             polymorphic_batch: bool = False) -> str:
        """Write the serving artifact.

        ``apply_fn(params, *example_args)`` is traced once (``torch.export``,
        non-strict) and written as an executable graph for the device of the
        example arguments. ``polymorphic_batch=True`` makes the leading
        dimension of every tensor argument of rank >= 1 one symbolic
        ``torch.export.Dim`` (scalars stay concrete), so the served function
        takes any batch size; otherwise the example shapes are baked in.
        """
        saver = Saver(max_to_keep=1)
        saver.save(params, os.path.join(self._export_dir, "params"), global_step=0)
        # Rename to the stable serving name (no step suffix) and drop the
        # Saver's latest-pointer state file, which would point at the
        # renamed-away prefix.
        for suffix in (".npz", ".json"):
            src = os.path.join(self._export_dir, "params-0" + suffix)
            dst = os.path.join(self._export_dir, "params" + suffix)
            if os.path.exists(src):
                os.replace(src, dst)
        state_file = os.path.join(self._export_dir, "checkpoint")
        if os.path.exists(state_file):
            os.remove(state_file)

        with open(os.path.join(self._export_dir, "model_config.json"), "w") as f:
            json.dump(model_config or {}, f, indent=1, sort_keys=True)

        if apply_fn is not None:
            args = tuple(example_args)
            dynamic = None
            if polymorphic_batch:
                batch = torch.export.Dim("b")
                dynamic = {"params": {k: None for k in params},
                           "args": tuple({0: batch} if torch.is_tensor(a) and a.dim() >= 1
                                         else None for a in args)}
            exported = torch.export.export(_Traced(apply_fn), (dict(params), *args),
                                           dynamic_shapes=dynamic, strict=False)
            # The program keeps its example inputs (the params among them) to
            # write them beside the graph; params.npz already holds them.
            exported.example_inputs = None
            with open(os.path.join(self._export_dir, "apply.export"), "wb") as f:
                torch.export.save(exported, f)
            with open(os.path.join(self._export_dir, "apply.hlo"), "w") as f:
                f.write(exported.graph_module.code)
            with open(os.path.join(self._export_dir, "apply.device"), "w") as f:
                f.write(_device_of(params, args).type)
        else:
            # A re-save without apply_fn must not leave a previous export's
            # graph behind: apply.export is EXECUTABLE, and serving a stale
            # graph against new params is silent wrong output.
            for name in EXPORT_FILES:
                stale = os.path.join(self._export_dir, name)
                if os.path.exists(stale):
                    os.remove(stale)

        logging.info("Exported serving artifact to %s", self._export_dir)
        return self._export_dir

    @staticmethod
    def load_params(export_dir: str, device=None):
        """The artifact's params, on ``device`` (default: where they load,
        the CPU)."""
        params = Saver().restore_params(os.path.join(export_dir, "params"))
        return params if device is None else {k: v.to(device) for k, v in params.items()}

    @staticmethod
    def export_device(export_dir: str) -> str:
        """The device type the artifact's graph was exported for."""
        with open(os.path.join(export_dir, "apply.device")) as f:
            return f.read().strip()

    @staticmethod
    def load_serving_fn(export_dir: str, device=None) -> Callable:
        """Load ``apply.export`` into a callable ``fn(params, *args)``.

        Pure artifact execution: nothing here imports or rebuilds model code.
        ``device`` (default: the artifact's) must be the device the graph was
        exported for; another raises ``ValueError`` naming it.
        """
        held = SavedModelBuilder.export_device(export_dir)
        if device is not None and torch.device(device).type != held:
            raise ValueError(f"the serving artifact in {export_dir} was exported for {held!r}; "
                             f"it cannot serve on {torch.device(device)}")
        if held == "cuda" and not torch.cuda.is_available():
            raise ValueError(f"the serving artifact in {export_dir} was exported for 'cuda', "
                             f"and this process has no CUDA device")
        with open(os.path.join(export_dir, "apply.export"), "rb") as f:
            program = torch.export.load(f).module()

        def serve(params, *args):
            with torch.no_grad():
                return program(params, *args)
        return serve
