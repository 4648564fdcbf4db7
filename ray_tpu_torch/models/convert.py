"""Carry a JAX parameter tree over to the port.

The port keeps the reference's tree (nested dicts, stacked layers,
``[in, out]`` projections), so conversion is leaf by leaf with no
reshaping. bf16 has no numpy dtype of its own: its bits go through
``uint16`` and are reinterpreted as ``torch.bfloat16``, exactly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device


def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    shape = a.shape  # ascontiguousarray makes a 0-d array 1-d
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # JAX hands out read-only views
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.reshape(shape).to(device)


def params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """A JAX parameter tree (JAX or numpy arrays, int8 stacks and 0-d
    leaves such as a LoRA adapter's ``scale`` or CLIP's ``logit_scale``
    included; dicts, and lists such as the MLP's layers) -> the same
    tree of tensors, of the same shapes, on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, dev) for v in tree]
    return _leaf(tree, dev)
