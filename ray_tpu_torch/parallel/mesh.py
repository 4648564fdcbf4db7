"""Device meshes for SPMD parallelism: a port of ray_tpu/parallel/mesh.py.

The reference lays devices out on a named ``jax.sharding.Mesh`` and lets
GSPMD insert the collectives. The port lays processes (one per device)
out on a ``torch.distributed.device_mesh.DeviceMesh`` with the same axis
names in the same order, and takes from it only one process group per
axis; the model code keeps each rank's local shard as a plain tensor and
issues the collectives itself (parallel/_sharded.py).

Axis conventions (as in the reference):
  data   — data parallelism (batch split; gradient sum)
  fsdp   — fully-sharded data parallelism (params sharded, gathered per
           layer; the batch is split over it too)
  model  — tensor parallelism (attention heads / MLP hidden split)
  seq    — sequence parallelism (ring attention, Ulysses)
  pipe   — pipeline stages
  expert — MoE expert parallelism
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch.distributed as dist

from ray_tpu_torch._device import DeviceLike, resolve_device

AXIS_ORDER = ("pipe", "data", "fsdp", "seq", "expert", "model")


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Axes of size 1 are kept."""
    data: int = 1
    fsdp: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1

    def axes(self) -> Dict[str, int]:
        return {
            "pipe": self.pipe, "data": self.data, "fsdp": self.fsdp,
            "seq": self.seq, "expert": self.expert, "model": self.model,
        }

    @property
    def size(self) -> int:
        return math.prod(self.axes().values())

    @staticmethod
    def for_devices(n: int, *, model: int = 1, seq: int = 1,
                    pipe: int = 1, expert: int = 1,
                    fsdp: Optional[int] = None) -> "MeshSpec":
        """Fill the data/fsdp axes with whatever devices remain."""
        rest = n // (model * seq * pipe * expert)
        if rest * model * seq * pipe * expert != n:
            raise ValueError(
                f"{n} devices not divisible by model*seq*pipe*expert="
                f"{model * seq * pipe * expert}")
        if fsdp is None:
            return MeshSpec(data=rest, model=model, seq=seq, pipe=pipe,
                            expert=expert)
        if rest % fsdp:
            raise ValueError(f"residual {rest} not divisible by fsdp={fsdp}")
        return MeshSpec(data=rest // fsdp, fsdp=fsdp, model=model, seq=seq,
                        pipe=pipe, expert=expert)


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def make_mesh(spec: MeshSpec, device: DeviceLike = None):
    """A ``DeviceMesh`` over ``AXIS_ORDER`` with ``spec``'s sizes, on
    ``cuda`` unless ``device`` is ``"cpu"`` (without a GPU it raises).
    Rank r sits at the row-major coordinates of r, as the reference
    reshapes ``devices[:n]``, so the innermost axes (``model``, then
    ``expert`` and ``seq``) join consecutive ranks. The default process
    group must hold exactly ``spec.size`` processes; for a one-process
    mesh without one, a world-1 group is made on an in-memory store (no
    port is bound). Each axis's group comes from ``mesh.get_group(name)``
    and is made once, here."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        if spec.size != 1:
            raise ValueError(
                f"mesh needs {spec.size} devices, have 1 (no process group: "
                "call initialize_distributed first)")
        dist.init_process_group(
            _backend(dev.type), store=dist.HashStore(), rank=0,
            world_size=1, device_id=dev if dev.type == "cuda" else None)
    world = dist.get_world_size()
    if world < spec.size:
        raise ValueError(f"mesh needs {spec.size} devices, have {world}")
    if world > spec.size:
        raise ValueError(f"mesh of {spec.size} devices in a process group "
                         f"of {world}: every process must be on the mesh")
    axes = spec.axes()
    return init_device_mesh(dev.type, tuple(axes[n] for n in AXIS_ORDER),
                            mesh_dim_names=AXIS_ORDER)


def single_device_mesh(device: DeviceLike = None):
    """A trivial mesh for one device."""
    return make_mesh(MeshSpec(), device)


def mesh_axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(name, 1)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: DeviceLike = None) -> None:
    """Join ``num_processes`` processes into the default process group
    at ``coordinator_address`` ("host:port", process 0 listens there):
    NCCL on the card (``device``, by default the current CUDA device),
    gloo when ``device`` is ``"cpu"``. A no-op for one process or when a
    group is already initialised, as the reference's
    ``jax.distributed.initialize`` wrapper is."""
    if num_processes in (None, 0, 1) or dist.is_initialized():
        return
    dev = resolve_device(device)
    dist.init_process_group(
        _backend(dev.type), init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        device_id=dev if dev.type == "cuda" else None)
