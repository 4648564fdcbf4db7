"""Gradient sync for data-parallel training (port of
ray_tpu/train/collective.py): the host-side all-reduce of a gradient
tree, and the two optimizers the reference's train loop toggles between
with one flag.

- :func:`allreduce_gradients` and :class:`DDPOptimizer`: each leaf's
  gradient all-reduced (a mean) over the group by the ring of
  ``parallel/collective.py``, optionally int8/fp8 on the wire with a
  residual per leaf (error feedback); every rank then takes the full
  optimizer step.
- :class:`Zero1Optimizer`: the flat f32 gradient vector reduce-scattered
  (each rank receives the exact mean of its ``_chunk_bounds`` chunk),
  the optimizer stepped on that chunk alone, then the parameter chunks
  all-gathered; the optimizer state of a rank is 1/world of the model's
  (ZeRO-1, "Automatic Cross-Replica Sharding of Weight Update").

Where the reference takes an optax transform, these take a torch
optimizer factory: a callable from a list of tensors to a
``torch.optim.Optimizer`` (``functools.partial(torch.optim.Adam, lr=lr,
eps=1e-8)`` is ``optax.adam(lr)``). ``step(params, grads) -> params``
works on a tree of dicts and lists of tensors, flattened in
``jax.tree_util``'s order (dict keys sorted); the tensors it returns are
the optimizer's own, and a call that is handed them back copies nothing.
The reference reads the group, ``zero1`` and ``grad_compression`` off
its TrainContext, which comes with the runtime (ROADMAP.md Queue 1 item
9); here they are arguments, and a group of None is the default group
(or world 1).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from ray_tpu_torch.parallel import _group, collective
from ray_tpu_torch.util import flight_recorder as _flight

OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]

CONTEXT = ("the run's TrainContext (its group, zero1 and grad_compression "
           "flags) comes with the runtime, ROADMAP.md Queue 1 item 9")


def barrier() -> None:
    raise NotImplementedError(f"barrier(): {CONTEXT}")


def broadcast_from_rank_zero(data: Any) -> Any:
    raise NotImplementedError(f"broadcast_from_rank_zero(): {CONTEXT}")


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples in
    ``jax.tree_util``'s order: dict keys sorted, sequences by index."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _leaves(item)]
    return [tree]


def _rebuild(tree, leaves: List[torch.Tensor]):
    """``tree``'s structure with ``leaves`` in :func:`_leaves`' order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(item) for item in node)
        return next(it)
    return build(tree)


def allreduce_gradients(grads, op: str = "mean",
                        compression: Optional[str] = None, *, group=None):
    """Every leaf of ``grads`` all-reduced over ``group`` (ring; ``op``
    mean by default) -> the same tree. ``compression`` "int8" / "fp8"
    quantizes every hop and keeps a residual per leaf (``grad/<i>``), so
    repeated rounds converge instead of carrying a quantization bias."""
    leaves = _leaves(grads)
    t0 = _flight.clock_ns() if _flight.RECORDER is not None else 0
    reduced = [collective.allreduce(
        leaf, op, group, compression,
        ef_key=f"grad/{i}" if compression else None)
        for i, leaf in enumerate(leaves)]
    rec = _flight.RECORDER
    if rec is not None:
        rec.record("collective", "allreduce_gradients", t0,
                   _flight.clock_ns() - t0,
                   {"leaves": len(leaves),
                    "compression": compression or "none"})
    return _rebuild(grads, reduced)


def _state_bytes(optimizer: torch.optim.Optimizer) -> int:
    return sum(v.numel() * v.element_size()
               for state in optimizer.state.values()
               for v in state.values() if isinstance(v, torch.Tensor))


def _take(own: List[torch.Tensor], given: List[torch.Tensor]) -> None:
    """Copy the parameters handed to ``step`` into the optimizer's own
    tensors (nothing when they are those tensors)."""
    if len(given) != len(own):
        raise ValueError(f"{len(given)} parameter leaves; the optimizer "
                         f"was built for {len(own)}")
    with torch.no_grad():
        for mine, g in zip(own, given):
            if g is not mine:
                mine.copy_(g)


class DDPOptimizer:
    """Replicated (plain DDP) optimizer step: each gradient leaf
    all-reduced to its mean over the group, then every rank runs the
    full optimizer step, each leaf in its own dtype. The same
    ``step(params, grads)`` surface as :class:`Zero1Optimizer`."""

    def __init__(self, optimizer: OptimizerFactory, params, *,
                 grad_compression: Optional[str] = None, group=None):
        self.grad_compression = grad_compression
        self.group = group
        self._params = [t.detach().clone() for t in _leaves(params)]
        self.optimizer = optimizer(self._params)

    def optimizer_state_bytes(self) -> int:
        return _state_bytes(self.optimizer)

    def step(self, params, grads):
        _take(self._params, _leaves(params))
        reduced = [collective.allreduce(
            g, "mean", self.group, self.grad_compression,
            ef_key=f"ddp/{i}" if self.grad_compression else None)
            for i, g in enumerate(_leaves(grads))]
        for p, g in zip(self._params, reduced):
            p.grad = g.to(p.dtype)
        self.optimizer.step()
        return _rebuild(params, self._params)


def _flat_f32(leaves: List[torch.Tensor]) -> torch.Tensor:
    if not leaves:
        return torch.zeros(0, dtype=torch.float32)
    return torch.cat([t.detach().reshape(-1).float() for t in leaves])


class Zero1Optimizer:
    """ZeRO-1 cross-replica sharded weight update. Each step: the flat
    f32 gradient vector reduce-scattered to its mean (this rank gets the
    exact mean of its ``_chunk_bounds`` chunk; quantizable, with error
    feedback under ``zero1/grads``), the optimizer stepped on that chunk
    of the flat parameters only, then the chunks all-gathered and cast
    back to each leaf's dtype. The optimizer's state exists for this
    rank's chunk alone, 1/world of DDP's. The update must be elementwise
    over the flat vector (Adam, AdamW, SGD)."""

    def __init__(self, optimizer: OptimizerFactory, params, *,
                 grad_compression: Optional[str] = None, group=None):
        self.grad_compression = grad_compression
        self.group = group
        leaves = _leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")
        _g, self.rank, self.world = _group.resolve(group, device)
        self.size = sum(t.numel() for t in leaves)
        bounds = collective._chunk_bounds(self.size, self.world)
        self._lo, self._hi = bounds[self.rank], bounds[self.rank + 1]
        self._shard = _flat_f32(leaves)[self._lo:self._hi].clone()
        self.optimizer = optimizer([self._shard])

    def optimizer_state_bytes(self) -> int:
        return _state_bytes(self.optimizer)

    def step(self, params, grads):
        gvec = _flat_f32(_leaves(grads))
        grad_shard, off = collective.reduce_scatter_flat(
            gvec, "mean", self.group, self.grad_compression,
            ef_key="zero1/grads" if self.grad_compression else None)
        if off != self._lo or off + grad_shard.numel() != self._hi:
            raise ValueError(
                "gradient tree size changed under Zero1Optimizer (shard "
                f"[{off}, {off + grad_shard.numel()}) vs optimizer state "
                f"for [{self._lo}, {self._hi}))")
        leaves = _leaves(params)
        with torch.no_grad():
            self._shard.copy_(_flat_f32(leaves)[self._lo:self._hi])
        self._shard.grad = grad_shard
        self.optimizer.step()
        full = collective.allgather_flat(self._shard, self.group,
                                         total=self.size)
        out, off = [], 0
        for t in leaves:
            out.append(full[off:off + t.numel()].reshape(t.shape)
                       .to(t.dtype))
            off += t.numel()
        return _rebuild(params, out)


def make_optimizer(optimizer: OptimizerFactory, params, *,
                   zero1: Optional[bool] = None,
                   grad_compression: Optional[str] = None, group=None):
    """The gradient-sync wrapper the run's flags ask for:
    :class:`Zero1Optimizer` with ``zero1``, else :class:`DDPOptimizer`.
    The reference reads the flags off its TrainContext; here ``zero1``
    must be given."""
    if zero1 is None:
        raise NotImplementedError(
            f"make_optimizer without zero1=: {CONTEXT}; pass zero1= (and "
            "group=, grad_compression=)")
    cls = Zero1Optimizer if zero1 else DDPOptimizer
    return cls(optimizer, params, grad_compression=grad_compression,
               group=group)


__all__ = ["DDPOptimizer", "Zero1Optimizer", "allreduce_gradients",
           "barrier", "broadcast_from_rank_zero", "make_optimizer"]
