"""The collectives that GSPMD inserts for the reference, issued by hand.

The port keeps each rank's local shard of a parameter as a plain tensor
(``sharding.shard_pytree``). The model code calls :func:`use` on a leaf
just before its layer needs it, and the pieces here do what XLA does for
a sharded ``jit``:

- **Gather on use (ZeRO-3).** :func:`use` all-gathers a leaf over the
  mesh axes its spec shards it on, so the whole weight lives only while
  its layer runs (and again in that layer's recompute under remat). The
  backward reduce-scatters the gradient over an axis the tokens are
  split on (``data``, ``fsdp``, ``seq``: each rank holds a part of the
  sum) and takes this rank's slice over one they are not (``model``,
  ``expert``: every rank computes the same full gradient).
- **The gradient sum.** The backward of :func:`use` also sums the
  gradient over the token axes that the leaf is replicated over; without
  it a rank's gradient would hold its own tokens' share only.
- **Megatron's pair** on the ``model`` axis: :func:`copy_to` (identity
  forward, all-reduce backward) in front of a column-parallel product,
  and :func:`reduce_from` (all-reduce forward, identity backward) after
  a row-parallel one.
- **The token mean.** :func:`global_value` raises a rank's share of a
  sum to the sum over the token axes, with the other ranks' shares as a
  constant: every rank returns the global loss and backpropagates its
  own share.

Every collective runs over one mesh axis; a sum over several axes is a
sum over each in turn. An axis of size 1 is skipped, so a world-1 mesh
runs the unsharded computation op for op. Every rank issues the same
collectives in the same order: the forward is the same program on every
rank, and so is the graph that autograd walks backwards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel import _group
from ray_tpu_torch.parallel.mesh import AXIS_ORDER
from ray_tpu_torch.parallel.sharding import P, spec_axes

# The axes the tokens are split over: the batch on data and fsdp (data
# major), the sequence on seq. Every other axis holds a replica of each
# token.
BATCH_AXES = ("data", "fsdp")
TOKEN_AXES = BATCH_AXES + ("seq",)

_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its process group, its size
    and this rank's coordinate on it."""
    name: str
    group: object
    size: int
    rank: int


class Layout:
    """The axes of a mesh (or of one sequence group), with the groups
    the ``DeviceMesh`` made once; building it makes no group."""

    def __init__(self, axes: Dict[str, Axis]):
        self.axes = axes

    @classmethod
    def from_mesh(cls, mesh, device: torch.device) -> "Layout":
        axes = {}
        for name, coord in zip(mesh.mesh_dim_names, mesh.get_coordinate()):
            group, _rank, size = _group.resolve(mesh.get_group(name), device)
            axes[name] = Axis(name, group, size, coord)
        return cls(axes)

    @classmethod
    def from_group(cls, group, device: torch.device) -> "Layout":
        """A sequence group alone (ring and Ulysses attention without a
        mesh): ``group`` None is the default group, or world 1."""
        group, rank, size = _group.resolve(group, device)
        return cls({"seq": Axis("seq", group, size, rank)})

    def size(self, name: str) -> int:
        axis = self.axes.get(name)
        return 1 if axis is None else axis.size

    def split(self, name: str) -> Optional[Axis]:
        """The axis when it has more than one rank, else None."""
        axis = self.axes.get(name)
        return axis if axis is not None and axis.size > 1 else None

    def token_axes(self) -> Tuple[Axis, ...]:
        return tuple(a for a in map(self.split, TOKEN_AXES) if a)

    def batch_axes(self) -> Tuple[Axis, ...]:
        return tuple(a for a in map(self.split, BATCH_AXES) if a)

    def check(self) -> None:
        for name in self.axes:
            if name not in AXIS_ORDER:
                raise ValueError(f"unknown mesh axis {name!r}")
        if self.size("pipe") > 1:
            raise ValueError("a pipe axis of more than one rank: stage the "
                             "model with parallel.pipeline instead")


# ---------------------------------------------------------------------------
# collectives on one axis (not differentiable)
# ---------------------------------------------------------------------------

def all_gather(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((axis.size * x.shape[0], *x.shape[1:]))
    _all_gather(out, x, group=axis.group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """This rank's chunk along ``dim`` of ``x`` summed over the ranks."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // axis.size, *x.shape[1:]))
    _reduce_scatter(out, x, group=axis.group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """A copy of ``x`` summed over each axis in turn."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    for axis in axes:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis.group)
    return out


def _chunk(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    return x.chunk(axis.size, dim=dim)[axis.rank]


# ---------------------------------------------------------------------------
# differentiable pieces
# ---------------------------------------------------------------------------

# One gather step: (dim, axis, whether the tokens are split over it)
Gather = Tuple[int, Axis, bool]


class _Use(torch.autograd.Function):
    """Forward: the shard gathered along each step's dim over its axis,
    in order. Backward: the steps undone in reverse (reduce-scatter over
    a token axis, this rank's chunk over another), then the sum over
    ``sums``."""

    @staticmethod
    def forward(ctx, shard, gathers: Sequence[Gather],
                sums: Sequence[Axis]):
        ctx.gathers, ctx.sums = gathers, sums
        out = shard.view_as(shard)
        for dim, axis, _tokens in gathers:
            out = all_gather(out, dim, axis)
        return out

    @staticmethod
    def backward(ctx, grad):
        for dim, axis, tokens in reversed(ctx.gathers):
            grad = (reduce_scatter(grad, dim, axis) if tokens
                    else _chunk(grad, dim, axis).contiguous())
        if ctx.sums:
            grad = all_reduce(grad, ctx.sums)
        return grad, None, None


def use(leaf: torch.Tensor, spec: P, layout: Optional[Layout],
        local: Sequence[str] = ()) -> torch.Tensor:
    """The tensor a layer computes with from this rank's shard ``leaf``
    of a parameter with partition ``spec``: gathered over every axis of
    the spec but those in ``local`` (which the layer uses sharded), and,
    in the backward, the gradient summed over the token axes it is
    replicated over (see the module docstring). ``leaf`` itself when
    there is nothing to gather or sum."""
    if layout is None:
        return leaf
    gathers = []
    named = set()
    for dim, entry in enumerate(spec):
        names = spec_axes(entry)
        named.update(names)
        for name in reversed(names):  # the minor axis first
            axis = layout.split(name)
            if axis is not None and name not in local:
                gathers.append((dim, axis, name in TOKEN_AXES))
    sums = tuple(a for a in layout.token_axes() if a.name not in named)
    if not gathers and not sums:
        return leaf
    return _Use.apply(leaf, tuple(gathers), sums)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, (ctx.axis,)), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Axis):
        return all_reduce(x, (axis,))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Megatron's f: ``x`` (the same on every rank of ``axis``) into a
    region where each rank computes its part; the backward sums the
    parts' gradients. ``x`` itself when ``axis`` is None."""
    return x if axis is None else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Megatron's g: the ranks' partial sums ``x`` summed over ``axis``;
    the backward passes the (full, replicated) gradient through."""
    return x if axis is None else _ReduceFrom.apply(x, axis)


def global_value(share: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """``share`` raised to its sum over ``axes`` with the other ranks'
    shares as a constant: the value is the global one, the gradient this
    rank's share's."""
    if not axes:
        return share
    return share + (all_reduce(share, axes) - share).detach()
