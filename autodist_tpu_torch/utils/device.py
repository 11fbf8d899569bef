"""Where the port runs: on the card unless the caller asks for the CPU."""

from typing import Optional, Union

import torch

from autodist_tpu_torch import const


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` is this process's card: ``cuda:$LOCAL_RANK`` when torchrun's
    environment names it (one process per card), else ``cuda:0``. Raises
    ``RuntimeError`` when a CUDA device is asked for and there is none. Pass
    ``"cpu"`` to run on the host."""
    if device is None:
        device = torch.device("cuda", const.ENV.LOCAL_RANK.val)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for (the default) but CUDA "
                           f"is not available; pass device='cpu' to run on the host")
    return device
