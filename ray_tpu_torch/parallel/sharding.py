"""Sharding rules: how parameter trees map onto the mesh (a port of
ray_tpu/parallel/sharding.py).

Rules map parameter-path regexes to partition specs, first match wins,
as in the reference. Where the reference hands the specs to pjit and
lets GSPMD place the shards and insert the collectives, the port cuts
each rank's local shard out of the whole tensor (:func:`shard_pytree`)
and the model code gathers a shard where a layer uses it and sums the
gradients itself (parallel/_sharded.py).

A spec (:class:`P`) has one entry per dimension: None (replicated), an
axis name, or a tuple of axis names (the dimension split over the
product of their sizes, the first axis major, as ``NamedSharding``
splits it). Shorter specs leave the trailing dimensions replicated.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch

from ray_tpu_torch.parallel.mesh import AXIS_ORDER


class P(tuple):
    """A partition spec: ``P("fsdp", None)``, ``P(None, ("fsdp",
    "model"))``; ``P()`` replicates every dimension. A tuple of its
    entries (the port does not import ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# A rule: (path regex, P) or (path regex, P, ndim), the latter matching
# only leaves of that many dimensions. First match wins.
Rule = Tuple


@dataclass
class ShardingRules:
    rules: List[Rule] = field(default_factory=list)
    default: P = P()

    def spec_for(self, path: str, ndim: int) -> P:
        for rule in self.rules:
            if len(rule) == 3:
                pattern, spec, want_ndim = rule
                if want_ndim != ndim:
                    continue  # ndim-constrained rule for another shape
            else:
                pattern, spec = rule
            if re.search(pattern, path):
                if len(spec) > ndim:
                    # Drop trailing axes that don't exist on this param.
                    spec = P(*spec[:ndim])
                return spec
        return self.default


def _flatten_with_path(tree: Any, prefix: Tuple[str, ...] = ()):
    """(keys, leaf) in ``jax.tree_util``'s order: dict keys sorted,
    lists and tuples by index."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten_with_path(tree[key], prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _flatten_with_path(item, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def _tree_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf, the keys joined by "/" as the
    reference joins JAX keypaths."""
    return [("/".join(keys), leaf) for keys, leaf in _flatten_with_path(tree)]


def _map_with_path(fn, tree: Any, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, join(i))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def _ndim(leaf) -> int:
    return getattr(leaf, "ndim", 0)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_coords(mesh) -> Dict[str, int]:
    """Axis name -> this rank's coordinate on a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _check_axes(spec: P, axis_sizes: Mapping[str, int]) -> None:
    seen = set()
    for entry in spec:
        for name in spec_axes(entry):
            if name not in axis_sizes:
                raise ValueError(f"{spec}: no mesh axis {name!r} "
                                 f"(mesh axes {tuple(axis_sizes)})")
            if name in seen:
                raise ValueError(f"{spec}: axis {name!r} used twice")
            seen.add(name)


def infer_sharding(tree: Any, mesh, rules: ShardingRules):
    """Map every leaf to its spec via the first matching rule -> a tree
    of :class:`P` of ``tree``'s structure."""
    sizes = mesh_shape(mesh)

    def spec_of(path, leaf):
        spec = rules.spec_for(path, _ndim(leaf))
        _check_axes(spec, sizes)
        return spec
    return _map_with_path(spec_of, tree)


def shard_slices(shape: Sequence[int], spec: P,
                 axis_sizes: Mapping[str, int],
                 coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The slice of a tensor of ``shape`` that the device at mesh
    coordinates ``coords`` holds under ``spec``: a pure function of its
    arguments. A dimension over a tuple of axes splits over their
    product, the first axis major. A dimension that its axes do not
    divide raises, as ``jax.device_put`` does."""
    _check_axes(spec, axis_sizes)
    if len(spec) > len(shape):
        raise ValueError(f"{spec} has more entries than {tuple(shape)} "
                         "has dimensions")
    out = []
    for dim, size in enumerate(shape):
        names = spec_axes(spec[dim]) if dim < len(spec) else ()
        parts = math.prod(axis_sizes[n] for n in names)
        if size % parts:
            raise ValueError(
                f"dimension {dim} of shape {tuple(shape)} is sharded over "
                f"{names} ({parts} parts) under {spec}, which does not "
                f"divide {size}")
        index = 0
        for n in names:
            index = index * axis_sizes[n] + coords[n]
        chunk = size // parts
        out.append(slice(index * chunk, (index + 1) * chunk))
    return tuple(out)


def local_shard(x, spec: P, axis_sizes: Mapping[str, int],
                coords: Mapping[str, int]):
    """The device's shard of ``x`` (a tensor or numpy array); ``x``
    itself when the spec splits nothing, else a contiguous copy (a new
    leaf), so the whole tensor can be freed."""
    slices = shard_slices(tuple(x.shape), spec, axis_sizes, coords)
    if all(s.stop - s.start == n for s, n in zip(slices, x.shape)):
        return x
    part = x[slices]
    if isinstance(part, torch.Tensor):
        return part.detach().clone(memory_format=torch.contiguous_format)
    return part.copy()


def local_shards(tree: Any, rules: ShardingRules,
                 axis_sizes: Mapping[str, int], coords: Mapping[str, int]):
    """:func:`local_shard` of every leaf of ``tree`` under ``rules``, for
    the device at ``coords`` on a mesh of ``axis_sizes`` (every axis of
    ``AXIS_ORDER`` missing from them is of size 1)."""
    sizes = {n: 1 for n in AXIS_ORDER}
    sizes.update(axis_sizes)
    at = {n: 0 for n in sizes}
    at.update(coords)
    return _map_with_path(
        lambda path, leaf: local_shard(
            leaf, rules.spec_for(path, _ndim(leaf)), sizes, at), tree)


def shard_pytree(tree: Any, mesh, rules: ShardingRules):
    """This rank's local shard of every leaf of ``tree`` (the whole
    tree, the same on every rank) under ``rules`` on ``mesh``. Shard a
    Llama tree with its layers stacked, as the rules' paths expect, and
    unstack the shards (``unstack_layers``) for training."""
    return local_shards(tree, rules, mesh_shape(mesh), mesh_coords(mesh))


@dataclass
class ShardingConfig:
    """High-level parallelism mode, lowered to rules.

    Modes:
      ddp   — replicate params, shard batch on ``data``
      fsdp  — shard params' largest dim on ``fsdp``, batch on data+fsdp
      tp    — tensor-parallel transformer rules on ``model``
      fsdp_tp — 2D: fsdp × model
    """
    mode: str = "ddp"
    # extra user rules consulted before the mode's built-ins
    extra_rules: List[Rule] = field(default_factory=list)

    def batch_spec(self) -> P:
        if self.mode == "ddp":
            return P(("data",))
        return P(("data", "fsdp"))

    def rules(self) -> ShardingRules:
        built_in: List[Rule]
        if self.mode == "ddp":
            built_in = []          # replicate everything
        elif self.mode == "fsdp":
            built_in = [
                (r"(embedding|lm_head)", P("fsdp", None)),
                (r"(wq|wk|wv|q_proj|k_proj|v_proj|gate|up|w1|w3)",
                 P("fsdp", None)),
                (r"(wo|o_proj|down|w2)", P(None, "fsdp")),
                (r".*", P()),
            ]
        elif self.mode == "tp":
            built_in = _TP_RULES
        elif self.mode == "fsdp_tp":
            built_in = [
                (r"(embedding|lm_head)", P("fsdp", "model")),
                (r"(wq|wk|wv|q_proj|k_proj|v_proj)", P("fsdp", "model")),
                (r"(wo|o_proj)", P("model", "fsdp")),
                (r"(gate|up|w1|w3)", P("fsdp", "model")),
                (r"(down|w2)", P("model", "fsdp")),
                (r".*", P()),
            ]
        else:
            raise ValueError(f"unknown sharding mode: {self.mode}")
        return ShardingRules(rules=list(self.extra_rules) + built_in)


# Megatron-style tensor parallelism: column-parallel in-projections,
# row-parallel out-projections.
_TP_RULES: List[Rule] = [
    (r"(embedding|lm_head)", P(None, "model")),
    (r"(wq|wk|wv|q_proj|k_proj|v_proj)", P(None, "model")),
    (r"(wo|o_proj)", P("model", None)),
    (r"(gate|up|w1|w3)", P(None, "model")),
    (r"(down|w2)", P("model", None)),
    (r".*", P()),
]
