"""Multi-process bootstrap: join the ``torch.distributed`` process group
(counterpart of ``autodist_tpu/parallel/multihost.py:18-50``, which joins
``jax.distributed``) from one of two environments:

- torchrun's: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
  (and ``LOCAL_RANK``, which :func:`autodist_tpu_torch.utils.device.resolve_device`
  reads);
- the coordinator's, for a multi-node resource spec
  (:mod:`autodist_tpu_torch.coordinator`): ``AUTODIST_COORDINATOR_ADDR``
  (``host:port``), ``AUTODIST_NUM_PROCESSES`` and ``AUTODIST_PROCESS_ID`` on a
  worker process; the chief derives them from its cluster spec.

Both set at once raise. Either is given to ``init_process_group``
explicitly. One process per card: NCCL on the card, gloo on the host.
``AutoDist`` joins for any synchronous mesh of more than one rank (data, seq
or both); :func:`autodist_tpu_torch.parallel.mesh.build_mesh` then makes the
groups along its axes. Async PS runs join no group.
"""

import datetime
import os
from typing import Optional, Tuple

from autodist_tpu_torch import const

import torch
import torch.distributed as dist

# How long joining the group, and any collective after it, may wait for the
# other ranks before failing (torch's own default is 10 minutes for NCCL).
DEFAULT_TIMEOUT_S = 300.0


def _coordinator_env(cluster) -> Optional[Tuple[str, int, int]]:
    """``(host:port, world, rank)`` from the coordinator's env, or from the
    chief's cluster spec; None when neither names more than one process."""
    address = const.env_str(const.AUTODIST_COORDINATOR_ADDR)
    world = const.env_int(const.AUTODIST_NUM_PROCESSES, 1)
    rank = const.env_int(const.AUTODIST_PROCESS_ID, 0)
    if not address and cluster is not None and cluster.num_processes > 1:
        address, world, rank = cluster.cluster_spec["coordinator"], cluster.num_processes, 0
    if not address or world <= 1:
        return None
    return address, world, rank


def maybe_initialize_multihost(device: torch.device, cluster=None,
                               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the default process group when torchrun's environment, or the
    coordinator's (``cluster``: the chief's :class:`~autodist_tpu_torch.cluster.Cluster`),
    asks for more than one process; returns whether a group of more than one
    rank is up. At world size 1 no group is made. Raises when the two
    environments are both set, when torchrun's is incomplete, or when it
    names a group that disagrees with one already joined."""
    coordinated = _coordinator_env(cluster)
    torchrun = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if coordinated is not None and torchrun:
        raise RuntimeError("both torchrun's environment (WORLD_SIZE) and the coordinator's "
                           "(AUTODIST_COORDINATOR_ADDR, AUTODIST_NUM_PROCESSES) name a process "
                           "group: launch a multi-node resource spec without torchrun")
    if coordinated is not None:
        address, world, rank = coordinated
        init = f"tcp://{address}"
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"the process group has {dist.get_world_size()} ranks, "
                               f"the environment says {world}")
        return world > 1
    if world <= 1:
        return False
    if coordinated is None:
        missing = [n for n in ("RANK", "MASTER_ADDR", "MASTER_PORT") if n not in os.environ]
        if missing:
            raise RuntimeError(f"WORLD_SIZE={world} but {missing} are not set: launch with "
                               f"torchrun, or set RANK, MASTER_ADDR and MASTER_PORT")
        init = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        rank = int(os.environ["RANK"])
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {"device_id": device} if device.type == "cuda" else {}
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return True
