"""Where the port runs: on the card unless the caller asks for the CPU."""

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` is ``cuda:0``; raises ``RuntimeError`` when that is asked for
    and there is no CUDA device. Pass ``"cpu"`` to run on the host."""
    device = torch.device("cuda:0" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for (the default) but CUDA "
                           f"is not available; pass device='cpu' to run on the host")
    return device
