"""The port's device rule.

Entry points run on the card unless the caller asks for the CPU: with
no ``device`` they take ``cuda``, and they raise when no GPU is present
instead of carrying on quietly on the CPU. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def device_type(device: DeviceLike = None) -> str:
    """The rule for ``device`` without a CUDA context in this process
    (an entry point that places actors on the card): ``"cuda"`` for
    ``None`` or a CUDA device, raising when no GPU is present, else
    ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" to run the plain PyTorch "
            "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device; a CUDA device without a
    GPU raises. ``"cpu"`` is honoured as given. A CUDA device comes back
    with its index, so that devices compare equal."""
    dev = torch.device("cuda" if device is None else device)
    device_type(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_of(tensors) -> Optional[torch.device]:
    """The device of the first tensor in a nested dict/list, or None."""
    if isinstance(tensors, torch.Tensor):
        return tensors.device
    items = tensors.values() if isinstance(tensors, dict) else tensors
    for item in items:
        dev = device_of(item)
        if dev is not None:
            return dev
    return None
