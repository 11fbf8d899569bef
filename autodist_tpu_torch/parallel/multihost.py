"""Multi-process bootstrap: join the ``torch.distributed`` process group from
torchrun's environment (counterpart of ``autodist_tpu/parallel/multihost.py:18``,
which joins ``jax.distributed`` from the coordinator's).

torchrun sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
(and ``LOCAL_RANK``, which :func:`autodist_tpu_torch.utils.device.resolve_device`
reads); this module reads the first four and gives them to
``init_process_group`` explicitly. One process per card: NCCL on the card,
gloo on the host. ``AutoDist`` joins for any mesh of more than one rank
(data, seq or both); :func:`autodist_tpu_torch.parallel.mesh.build_mesh`
then makes the groups along its axes.
"""

import datetime
import os

import torch
import torch.distributed as dist

# How long joining the group, and any collective after it, may wait for the
# other ranks before failing (torch's own default is 10 minutes for NCCL).
DEFAULT_TIMEOUT_S = 300.0


def maybe_initialize_multihost(device: torch.device,
                               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the default process group when torchrun's environment asks for
    more than one process; returns whether a group of more than one rank is
    up. At world size 1 no group is made. Raises when the environment is
    incomplete or names a group that disagrees with one already joined."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"the process group has {dist.get_world_size()} ranks, "
                               f"WORLD_SIZE says {world}")
        return world > 1
    if world <= 1:
        return False
    missing = [n for n in ("RANK", "MASTER_ADDR", "MASTER_PORT") if n not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE={world} but {missing} are not set: launch with "
                           f"torchrun, or set RANK, MASTER_ADDR and MASTER_PORT")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    kwargs = {"device_id": device} if device.type == "cuda" else {}
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=int(os.environ["RANK"]),
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return True
