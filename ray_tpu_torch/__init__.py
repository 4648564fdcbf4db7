"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's compute path.

A package beside ``ray_tpu`` that imports torch, numpy and the standard
library, never JAX and nothing of ``ray_tpu``. Plain tensor code is
PyTorch; each Pallas kernel of the reference on a ported path is a
CUDA C++ kernel written by hand for Hopper (``ops/csrc``), built with
``nvcc`` at its first launch.

Entry points (``llama_init``, ``ContinuousBatchingEngine``,
``LLMServer``, ``PPOConfig.build_algo``, ``Anakin``, ``TorchTrainer``)
run on the GPU unless the caller passes ``device="cpu"`` (the trainer:
``ScalingConfig(use_gpu=False)``), and raise when no GPU is present.

The runtime's single-host core (tasks, actors, objects, placement
groups, the GCS KV; ``core/``) is a copy of the reference's, with GPUs
as the ``"GPU"`` resource: ``ray_tpu_torch.init()``, ``remote``,
``get``, ``put``, ``wait``, ``kill`` and ``shutdown`` are the
reference's API. Its workers are processes of ``python -m
ray_tpu_torch.core.worker``.
On it run the compiled DAG (``dag/``), the MPMD pipeline trainer
(``train/pipeline/``: stage actors training 1F1B or GPipe over DAG
channels) and device objects (``experimental/device_objects.py``).

Importing the package initialises no CUDA context, starts no process
and needs no compiler. Submodules and the API load on first attribute
access.
"""

from __future__ import annotations

import importlib

_SUBMODULES = ("accelerators", "api", "autoscaler", "core", "dag", "data",
               "devtools", "exceptions", "experimental", "llm", "models",
               "native", "ops", "parallel", "rl", "runtime_env", "serve",
               "train", "util")
# The runtime's API (ray_tpu/__init__.py's exports), from api.py.
_API = ("available_resources", "cancel", "cluster_resources",
        "flight_journal", "get", "get_actor", "get_runtime_context",
        "init", "is_initialized", "kill", "nodes", "put", "remote",
        "shutdown", "wait")

__all__ = [*_SUBMODULES, *_API, "ObjectRef", "ObjectRefGenerator",
           "RuntimeEnv"]


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _API:
        return getattr(importlib.import_module(f"{__name__}.api"), name)
    if name == "ObjectRef":
        from ray_tpu_torch.core.object_ref import ObjectRef
        return ObjectRef
    if name == "ObjectRefGenerator":
        from ray_tpu_torch.core.generator import ObjectRefGenerator
        return ObjectRefGenerator
    if name == "RuntimeEnv":
        from ray_tpu_torch.runtime_env import RuntimeEnv
        return RuntimeEnv
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
