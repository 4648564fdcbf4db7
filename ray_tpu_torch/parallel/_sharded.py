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
  own share (:func:`global_mean`).
- **The gathered batch.** :func:`gather_rows` all-gathers a tensor over
  the batch axes for a loss that needs every row (CLIP's [B, B]
  logits); its backward takes this rank's rows, since every rank
  computes the same global loss from the gathered tensor.

:class:`Plan` holds what a family's forward needs from a mesh: the
layout, every leaf's spec and the leaves its layers use sharded
(Megatron's column/row pairs on ``model``, which each family names).

Every collective runs over one mesh axis; a sum over several axes is a
sum over each in turn. An axis of size 1 is skipped, so a world-1 mesh
runs the unsharded computation op for op. Every rank issues the same
collectives in the same order: the forward is the same program on every
rank, and so is the graph that autograd walks backwards.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel import _group
from ray_tpu_torch.parallel.mesh import AXIS_ORDER
from ray_tpu_torch.parallel.sharding import P, ShardingRules, spec_axes

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


def global_mean(x: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """The mean of ``x`` over the rows of every rank of ``axes`` (each
    rank holding as many): ``x.mean()`` without axes, else this rank's
    share of the global mean raised to the global mean itself
    (:func:`global_value`)."""
    if not axes:
        return x.mean()
    n = x.numel() * math.prod(a.size for a in axes)
    return global_value(x.sum() / n, axes)


def local_rows(x: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """This rank's rows (dim 0) of a batch split over the batch
    ``axes`` (data major, as :func:`gather_rows` joins them)."""
    for axis in axes:
        x = _chunk(x, 0, axis)
    return x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes: Sequence[Axis]):
        ctx.axes = axes
        for axis in reversed(axes):  # the minor axis first
            x = all_gather(x, 0, axis)
        return x

    @staticmethod
    def backward(ctx, grad):
        return local_rows(grad, ctx.axes).contiguous(), None


def gather_rows(x: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """Every rank's rows of ``x`` (dim 0) over the batch ``axes``,
    data major. The backward takes this rank's rows of the gradient (a
    slice, not a reduce-scatter): every rank computes the same global
    loss from the gathered tensor, so each holds the whole gradient.
    ``x`` itself without axes."""
    return _GatherRows.apply(x, tuple(axes)) if axes else x


# ---------------------------------------------------------------------------
# a forward's plan on a mesh
# ---------------------------------------------------------------------------

REPLICATED = ShardingRules(rules=[(r".*", P())])

# A Megatron pair: (column-parallel leaves, row-parallel leaves) of a layer
Pair = Tuple[Tuple[str, ...], Tuple[str, ...]]


def _layer_ndims(layers) -> Dict[str, int]:
    """The dimensions of one layer's leaves, of a stacked (dict of
    [L, ...]) or unstacked (list of dicts) layer tree."""
    if isinstance(layers, (list, tuple)):
        return {name: t.ndim for name, t in layers[0].items()}
    return {name: t.ndim - 1 for name, t in layers.items()}


def leaf_specs(params: Dict[str, Any], rules: ShardingRules,
               prefix: str = "") -> Dict[str, P]:
    """The spec of each top-level leaf of ``params`` and (without its
    layer axis) of each layer leaf, by the paths of the stacked tree
    (``<prefix>layers/<name>``), which the rules are written for."""
    specs = {}
    for name, t in params.items():
        if name == "layers":
            continue
        if isinstance(t, torch.Tensor):
            specs[name] = rules.spec_for(prefix + name, t.ndim)
    for name, ndim in _layer_ndims(params.get("layers", {})).items():
        path = f"{prefix}layers/{name}"
        spec = rules.spec_for(path, ndim + 1)
        if spec and spec[0] is not None:
            raise ValueError(f"{path}: {spec} splits the layer axis")
        if name in specs:
            raise ValueError(f"{path}: a top-level leaf has its name")
        specs[name] = P(*spec[1:])
    return specs


class Plan:
    """How one forward uses its parameters: on a mesh, the layout, every
    leaf's spec (:func:`leaf_specs`) and the leaves the layers use
    sharded (``local``: name -> axes); without one, every leaf as it
    is."""

    def __init__(self, layout: Optional[Layout] = None,
                 specs: Optional[Dict[str, P]] = None):
        self.layout, self.specs = layout, specs
        self.local: Dict[str, tuple] = {}

    @classmethod
    def for_mesh(cls, mesh, rules: Optional[ShardingRules],
                 params: Dict[str, Any], device: torch.device,
                 prefix: str = "", **kw) -> "Plan":
        """The plan of ``params`` (this rank's shards) under ``rules``
        (None: every leaf replicated) on ``mesh``."""
        layout = Layout.from_mesh(mesh, device)
        layout.check()
        return cls(layout, leaf_specs(params, rules or REPLICATED, prefix),
                   **kw)

    def on(self, name: str, dim: int, axis: str) -> bool:
        spec = self.specs.get(name, P())
        return len(spec) > dim and spec[dim] == axis

    def pair_on(self, pair: Pair, axis: str) -> bool:
        column, row = pair
        return (all(self.on(n, 1, axis) for n in column)
                and all(self.on(n, 0, axis) for n in row))

    def split_pair(self, pair: Pair, axis: str = "model") -> Optional[Axis]:
        """``axis`` when it has more than one rank and ``pair``'s specs
        split the column leaves' outputs and the row leaves' inputs over
        it: the layers then use those leaves sharded on it (Megatron's
        pair). None otherwise, and the leaves are gathered on use."""
        split = None if self.specs is None else self.layout.split(axis)
        if split is None or not self.pair_on(pair, axis):
            return None
        self.local.update(dict.fromkeys(sum(pair, ()), (axis,)))
        return split

    def leaf(self, params: Dict[str, Any], name: str):
        if self.specs is None:
            return params[name]
        return use(params[name], self.specs[name], self.layout)

    def layer(self, layer_params: Dict[str, Any]) -> Dict[str, Any]:
        if self.specs is None:
            return layer_params
        return {name: use(t, self.specs[name], self.layout,
                          self.local.get(name, ()))
                for name, t in layer_params.items()}

    def token_axes(self) -> Tuple[Axis, ...]:
        return () if self.layout is None else self.layout.token_axes()

    def batch_axes(self) -> Tuple[Axis, ...]:
        return () if self.layout is None else self.layout.batch_axes()
