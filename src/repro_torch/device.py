"""Device choice shared by the port's entry points.

The port runs on a CUDA card of compute capability 9.0 or above (Hopper)
unless the caller asks for ``device="cpu"`` explicitly; with no card and no
such request it raises instead of running on the CPU in silence.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

MIN_CAPABILITY = (9, 0)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card; ``"cpu"`` runs the kernels' plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on an H100 by default; "
                               "pass device='cpu' to run the plain versions on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        check_capability(dev)
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {dev}")
    return dev


def check_capability(dev: torch.device) -> None:
    cap = torch.cuda.get_device_capability(dev)
    if cap < MIN_CAPABILITY:
        raise RuntimeError(f"{torch.cuda.get_device_name(dev)} has compute capability "
                           f"{cap}; the port's kernels are built for sm_90a and need "
                           f"{MIN_CAPABILITY} or above")
