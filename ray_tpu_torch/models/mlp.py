"""Small MLP classifier in PyTorch: a port of ray_tpu/models/mlp.py (the
MNIST-class model of the trainer tests).

The parameter tree is the reference's, ``{"layers": [{"w": [in, out],
"b": [out]}, ...]}``, so ``params_from_jax`` carries a JAX tree over
as it is. No kernel runs here: the products are ``torch.matmul``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: tuple = (128, 128)
    out_dim: int = 10
    dtype: torch.dtype = torch.float32


def mlp_init(seed: int, config: MLPConfig, device: DeviceLike = None):
    """Random parameters from a seed (a ``torch.Generator`` on
    ``device``): each w N(0, 1/in), each b zero. The bits differ from
    ``jax.random``'s."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dims = [config.in_dim, *config.hidden, config.out_dim]
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        layers.append({
            "w": (torch.randn((d_in, d_out), generator=gen, device=dev)
                  * d_in ** -0.5).to(config.dtype),
            "b": torch.zeros((d_out,), dtype=config.dtype, device=dev),
        })
    return {"layers": layers}


def mlp_forward(params, x):
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        x = x @ layer["w"] + layer["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def mlp_loss(params, x, y):
    logp = torch.log_softmax(mlp_forward(params, x), dim=-1)
    return -logp.gather(-1, y[:, None].long()).mean()
