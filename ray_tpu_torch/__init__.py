"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's compute path.

A package beside ``ray_tpu`` that imports torch, numpy and the standard
library, never JAX and nothing of ``ray_tpu``. Plain tensor code is
PyTorch; each Pallas kernel of the reference on a ported path is a
CUDA C++ kernel written by hand for Hopper (``ops/csrc``), built with
``nvcc`` at its first launch.

Entry points (``llama_init``, ``ContinuousBatchingEngine``,
``LLMServer``, ``PPOConfig.build_algo``, ``Anakin``) run on the GPU
unless the caller passes ``device="cpu"``, and raise when no GPU is
present. Importing the package initialises no
CUDA context and needs no compiler. Submodules load on first attribute
access.
"""

from __future__ import annotations

import importlib

__all__ = ["llm", "models", "ops", "parallel", "rl", "serve", "util"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
