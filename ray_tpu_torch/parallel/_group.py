"""The process group that sequence and pipeline parallelism run over.

The reference names a mesh axis; the port takes a ``torch.distributed``
group. ``None`` is the default group when one is initialised, else a
single process (world 1), where nothing is exchanged.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _backend_for(group, device_type: str) -> Optional[str]:
    """The backend that carries ``device_type``'s tensors in ``group``
    ("gloo", or "cpu:gloo,cuda:nccl" split by device)."""
    backend = str(dist.get_backend(group))
    if ":" not in backend:
        return backend
    by_device = dict(part.split(":") for part in backend.split(","))
    return by_device.get(device_type)


def resolve(group, device: torch.device) -> Tuple[object, int, int]:
    """``(group, rank, size)`` for tensors on ``device``; ``(None, 0, 1)``
    when ``group`` is None and no default group exists. A gloo group
    handed CUDA tensors raises: gloo would carry them through the host."""
    if group is None:
        if not dist.is_available() or not dist.is_initialized():
            return None, 0, 1
        group = dist.group.WORLD
    backend = _backend_for(group, device.type)
    if device.type == "cuda" and backend == "gloo":
        raise ValueError("the process group's backend is gloo, which takes "
                         "CUDA tensors only through the host; use an nccl "
                         "group for tensors on the card")
    return group, dist.get_rank(group), dist.get_world_size(group)


def global_rank(group, rank: int) -> int:
    """The default group's rank of ``group``'s rank ``rank`` (P2P ops
    take the former)."""
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


class Exchange:
    """Sends and receives posted together by ``dist.batch_isend_irecv``;
    :meth:`wait` returns the received tensors."""

    def __init__(self, sends: Sequence[Tuple[torch.Tensor, int]],
                 recvs: Sequence[Tuple[torch.Tensor, int]], group):
        """``sends`` / ``recvs``: (tensor, group rank of the peer). Every
        rank must post its matching ops in the same order."""
        self.received = [t for t, _ in recvs]
        self._sent = [t.contiguous() for t, _ in sends]  # alive till wait
        ops = [dist.P2POp(dist.isend, t, global_rank(group, peer), group)
               for t, (_, peer) in zip(self._sent, sends)]
        ops += [dist.P2POp(dist.irecv, t, global_rank(group, peer), group)
                for t, peer in recvs]
        self._requests = dist.batch_isend_irecv(ops) if ops else []

    def wait(self):
        for request in self._requests:
            request.wait()
        return self.received


def shift(tensors: Sequence[torch.Tensor], group, rank: int,
          size: int) -> Exchange:
    """Send ``tensors`` to rank + 1 and receive as many from rank - 1
    (around the ring), into fresh contiguous buffers."""
    nxt, prv = (rank + 1) % size, (rank - 1) % size
    return Exchange([(t, nxt) for t in tensors],
                    [(torch.empty(t.shape, dtype=t.dtype, device=t.device),
                      prv) for t in tensors], group)

