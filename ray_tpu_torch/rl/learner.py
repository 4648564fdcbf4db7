"""Learner / LearnerGroup: the gradient side of the RL stack (port of
ray_tpu/rl/learner.py; reference: rllib/core/learner/learner.py:112 and
learner_group.py:101).

A ``Learner`` holds an ``ActorCritic`` and a ``torch.optim.Adam(lr,
eps=1e-5)`` on its device, behind the reference's optax global-norm
clip (``clip_by_global_norm_``). ``Learner(mesh=)`` trains data-parallel
over a 1-D mesh or a process group on ``data``, as the reference's
learner over a mesh does under GSPMD: each rank takes its rows of the
batch, the loss and the metrics are the global batch's, and the
gradients are summed over ``data`` before the clip and Adam, so every
rank takes the same step. Under a mesh a subclass's loss must be a mean
over the rows, with any batch statistic taken over the global batch
(``self.batch_axes``; PPO's advantage normalisation).

``LearnerGroup(num_learners=N > 1)`` starts N learner actors on the
port's runtime (the reference's cross-actor DDP, learner.py:173-284).
They join a gloo ``torch.distributed`` group through the runtime's KV
(``rendezvous_address``), and each update makes one exchange: a rank
computes the gradients of the loss on its own shard of the batch (its
batch statistics are the shard's, as in the reference), packs them into
one flat f32 vector on the host, all-reduces it, divides by the world
size, then takes the clip and the Adam step. The vector crosses the
host, so several ranks may share one card.
"""

from __future__ import annotations

import copy
import logging
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch._device import DeviceLike, device_type, resolve_device
from ray_tpu_torch.parallel import _group
from ray_tpu_torch.parallel._sharded import (
    Axis, Layout, all_reduce, global_value, local_rows)
from ray_tpu_torch.rl.rl_module import (
    ActorCritic, RLModuleSpec, load_params, params_to_tree)


def compute_gae(rewards, values, dones, bootstrap_value, *,
                gamma: float = 0.99, lambda_: float = 0.95):
    """Generalized advantage estimation over time-major [T, N] columns.

    Auto-reset envs: ``dones[t]`` marks that the transition at t ended
    an episode, so the bootstrap chain is cut there. Returns
    (advantages [T, N], value_targets [T, N]). The reference scans over
    T in reverse (learner.py:28-52); the port loops, one fused
    multiply-add per step after the deltas are formed for all T at once.
    """
    nonterminal = 1.0 - dones.to(torch.float32)
    next_values = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = rewards + gamma * next_values * nonterminal - values
    decay = gamma * lambda_ * nonterminal
    adv = torch.zeros_like(bootstrap_value)
    out = []
    for t in reversed(range(rewards.shape[0])):
        adv = torch.addcmul(deltas[t], decay[t], adv)
        out.append(adv)
    advantages = torch.stack(out[::-1])
    return advantages, advantages + values


def batch_to_device(batch, device) -> Dict[str, torch.Tensor]:
    """Host columns as tensors on ``device``; f64 columns become f32,
    as JAX (without x64) takes them."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        out[k] = t.float() if t.dtype == torch.float64 else t
    return out


def mean_metrics(all_metrics: List[Dict[str, Any]]) -> Dict[str, float]:
    """Average a list of per-update metric dicts (0-d f32 tensors on one
    device, with one transfer to the host; or host floats, as learner
    actors return them)."""
    keys = list(all_metrics[0])
    if not isinstance(all_metrics[0][keys[0]], torch.Tensor):
        return {k: float(np.mean([float(m[k]) for m in all_metrics]))
                for k in keys}
    rows = torch.stack([torch.stack([m[k] for k in keys])
                        for m in all_metrics])
    means = rows.cpu().double().numpy().mean(axis=0)
    return {k: float(v) for k, v in zip(keys, means)}


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float):
    """optax's ``clip_by_global_norm(max_norm)``, in place: scale every
    gradient by ``max_norm / g_norm`` where the global norm ``g_norm``
    is at least ``max_norm``, and leave them as they are below it (no
    epsilon, unlike ``torch.nn.utils.clip_grad_norm_``). No host sync."""
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(g_norm < max_norm, 1.0, max_norm / g_norm)
    torch._foreach_mul_(grads, scale)
    return g_norm


def host_allreduce_mean_(params: List[torch.Tensor], group) -> None:
    """The reference's host-collective DDP exchange (learner.py:126-146):
    every gradient packed into one flat f32 vector on the host, summed
    over ``group`` in one all-reduce, divided by its size, and written
    back into ``p.grad`` on its device."""
    flat = torch.cat([p.grad.reshape(-1).float() for p in params]).cpu()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


def apply_gradients(loss: torch.Tensor, module: ActorCritic,
                    optimizer: torch.optim.Optimizer,
                    grad_clip: Optional[float], axes=(),
                    host_group=None) -> None:
    """One step of the reference's ``optax.chain(clip_by_global_norm,
    adam)``: backward, the gradients summed over ``axes`` (the data
    axis of a sharded learner) or averaged over ``host_group`` through
    the host (a learner actor's group), the global-norm clip, then Adam.

    ``torch.optim.Adam`` and ``optax.adam`` take the same step: bias-
    corrected moments, eps added outside the square root
    (``tests/test_torch_rl_units.py`` holds the two to each other)."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for axis in axes:
        for p in module.parameters():
            dist.all_reduce(p.grad, op=dist.ReduceOp.SUM, group=axis.group)
    if host_group is not None:
        host_allreduce_mean_(list(module.parameters()), host_group)
    if grad_clip:
        clip_by_global_norm_([p.grad for p in module.parameters()],
                             grad_clip)
    optimizer.step()


def optax_adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: bias-corrected moments, eps 1e-8 added
    outside the square root. Fused: one kernel steps every parameter
    (on the CPU too), where the loop version launches about ten ops per
    parameter."""
    return torch.optim.Adam(params, lr=lr, eps=1e-8, fused=True)


def data_axis(mesh, device: torch.device) -> Optional[Axis]:
    """The ``data`` axis of a learner's ``mesh``: a ``DeviceMesh`` whose
    other axes are all of size 1, or a process group. None when it has
    one rank."""
    if hasattr(mesh, "mesh_dim_names"):
        layout = Layout.from_mesh(mesh, device)
        others = [a.name for a in layout.axes.values()
                  if a.name != "data" and a.size > 1]
        if others or "data" not in layout.axes:
            raise ValueError(f"a learner's mesh splits data only, not "
                             f"{others or tuple(layout.axes)}")
        return layout.split("data")
    if not isinstance(mesh, dist.ProcessGroup):
        raise ValueError(f"a learner's mesh is a DeviceMesh or a process "
                         f"group, not {type(mesh).__name__}")
    group, rank, size = _group.resolve(mesh, device)
    return Axis("data", group, size, rank) if size > 1 else None


class Learner:
    """Holds the module + optimizer; subclasses define ``loss``."""

    def __init__(self, module_spec: RLModuleSpec, *, lr: float = 3e-4,
                 seed: int = 0, grad_clip: Optional[float] = None,
                 mesh=None, collective_group=None,
                 device: DeviceLike = None):
        self.spec = module_spec
        self.device = resolve_device(device)
        if mesh is not None and collective_group is not None:
            raise ValueError("a learner trains over a mesh or in a "
                             "learner group, not both")
        axis = None if mesh is None else data_axis(mesh, self.device)
        self.batch_axes: Tuple[Axis, ...] = () if axis is None else (axis,)
        # a learner actor's gloo group: one host exchange per update,
        # this rank's loss over its own shard (not a global batch)
        self.collective_group = collective_group
        self.grad_clip = grad_clip
        self.module = module_spec.init(seed, self.device)
        self.optimizer = torch.optim.Adam(self.module.parameters(), lr=lr,
                                          eps=1e-5)

    # -- subclass hook --------------------------------------------------
    def loss(self, module: ActorCritic,
             batch: Dict[str, torch.Tensor]) -> Tuple[Any, Dict[str, Any]]:
        """(loss scalar, metrics dict of 0-d tensors)."""
        raise NotImplementedError

    # -- update ---------------------------------------------------------
    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        """A host batch (numpy columns) as tensors on the device."""
        return batch_to_device(batch, self.device)

    def update(self, batch) -> Dict[str, Any]:
        """One step on ``batch``: under a mesh, the global batch (the
        same on every rank), of which this rank takes its rows."""
        batch = self.to_device(batch)
        axes = self.batch_axes
        if axes:
            n = axes[0].size
            rows = sorted({v.shape[0] for v in batch.values()})
            if len(rows) != 1 or rows[0] % n:
                raise ValueError(f"a batch of {rows} rows over a data axis "
                                 f"of {n}: the axis must divide the rows")
            batch = {k: local_rows(v, axes) for k, v in batch.items()}
        loss, metrics = self.loss(self.module, batch)
        if axes:
            # this rank's share of the global mean, raised to it
            loss = global_value(loss / axes[0].size, axes)
        apply_gradients(loss, self.module, self.optimizer, self.grad_clip,
                        axes, host_group=self.collective_group)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = loss.detach()
        if axes:
            keys = [k for k in metrics if k != "total_loss"]
            means = all_reduce(torch.stack([metrics[k] for k in keys]),
                               axes) / axes[0].size
            metrics.update(zip(keys, means.unbind()))
        return metrics

    def get_weights(self):
        """The reference's parameter tree (numpy, ``w`` as [in, out])."""
        return params_to_tree(self.module)

    def set_weights(self, params) -> None:
        load_params(self.module, params)

    def get_state(self) -> Dict[str, Any]:
        return copy.deepcopy({"params": self.module.state_dict(),
                              "opt_state": self.optimizer.state_dict()})

    def set_state(self, state: Dict[str, Any]) -> None:
        self.module.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])


def _host_state(tree):
    """A state dict with every tensor on the host (a learner actor's
    state crosses to a driver that may hold no CUDA context)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _host_state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_state(v) for v in tree)
    return tree


class _LearnerActor:
    """One rank of a learner group: a ``Learner`` in its own process
    (reference: learner.py:173-204). The constructors of all ranks run
    at once: rank 0 publishes a loopback address in the runtime's KV and
    every rank joins the gloo group there."""

    def __init__(self, learner_cls_blob: bytes, kwargs_blob: bytes,
                 rank: int, world_size: int, group_key: str, device: str):
        from ray_tpu_torch.core import serialization
        from ray_tpu_torch.train.trainer import rendezvous_address
        learner_cls = serialization.loads(learner_cls_blob)
        kwargs = serialization.loads(kwargs_blob)
        if device == "cuda":
            # the runtime names this worker's card in
            # CUDA_VISIBLE_DEVICES, so it is cuda:0 here
            torch.cuda.set_device(0)
        address = rendezvous_address(group_key, rank)
        dist.init_process_group("gloo", init_method=f"tcp://{address}",
                                world_size=world_size, rank=rank)
        self.learner = learner_cls(collective_group=dist.group.WORLD,
                                   device=device, **kwargs)

    def update(self, batch) -> Dict[str, float]:
        metrics = self.learner.update(batch)
        values = torch.stack([metrics[k].float() for k in metrics]).cpu()
        return dict(zip(metrics, values.double().tolist()))

    def get_weights(self):
        return self.learner.get_weights()

    def get_state(self):
        return _host_state(self.learner.get_state())

    def set_state(self, state) -> None:
        self.learner.set_state(state)

    def ping(self) -> bool:
        return True


class LearnerGroup:
    """One local learner, or ``num_learners`` learner actors whose
    gradients are averaged through the host (reference:
    learner_group.py:101). With actors, ``device`` is each rank's: on
    ``cuda`` every actor asks the runtime for a share of the cards
    (``num_gpus``), so that several ranks may share one card."""

    def __init__(self, learner_cls: Callable[..., Learner], *,
                 num_learners: int = 0, **learner_kwargs):
        self.num_learners = num_learners
        self._actors = None
        if num_learners <= 1:
            self._local = learner_cls(**learner_kwargs)
            return
        import ray_tpu_torch
        from ray_tpu_torch.core import serialization
        self._local = None
        if learner_kwargs.get("mesh") is not None:
            raise ValueError("learner actors average their shards' "
                             "gradients through the host; a mesh is a "
                             "single learner's")
        device = device_type(learner_kwargs.pop("device", None))
        options: Dict[str, Any] = {}
        if device == "cuda":
            gpus = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            if gpus <= 0:
                raise RuntimeError("learner actors on cuda need the "
                                   "runtime's GPU resource")
            options["num_gpus"] = min(1.0, gpus / num_learners)
        actor_cls = ray_tpu_torch.remote(_LearnerActor)
        if options:
            actor_cls = actor_cls.options(**options)
        group_key = f"rl/learners/{uuid.uuid4().hex}"
        # blobs: serialization.dumps ships the driver's own modules (a
        # learner subclass in a script) by value
        cls_blob = serialization.dumps(learner_cls)
        kwargs_blob = serialization.dumps(learner_kwargs)
        self._actors = [
            actor_cls.remote(cls_blob, kwargs_blob, rank, num_learners,
                             group_key, device)
            for rank in range(num_learners)]
        ray_tpu_torch.get([a.ping.remote() for a in self._actors])

    def shutdown(self) -> None:
        """Kill the learner actors (leaked ones would hold their CPUs
        and card shares forever)."""
        if self._actors:
            import ray_tpu_torch
            for actor in self._actors:
                try:
                    ray_tpu_torch.kill(actor)
                except Exception:  # noqa: BLE001 — actor already dead
                    logging.getLogger(__name__).debug(
                        "learner kill failed", exc_info=True)
            self._actors = None

    def update(self, batch) -> Dict[str, Any]:
        if self._local is not None:
            return self._local.update(batch)
        import ray_tpu_torch
        n = len(self._actors)
        size = len(next(iter(batch.values())))
        # every actor gets >= 1 row (an empty shard would NaN the loss
        # and the all-reduce would poison every rank): wrap around when
        # the batch is smaller than the group
        idx = np.arange(max(size, n)) % size
        chunks = np.array_split(idx, n)
        refs = [actor.update.remote(
                    {k: np.asarray(v)[chunk] for k, v in batch.items()})
                for actor, chunk in zip(self._actors, chunks)]
        return mean_metrics(ray_tpu_torch.get(refs))

    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        import ray_tpu_torch
        return ray_tpu_torch.get(self._actors[0].get_weights.remote())

    def get_state(self):
        if self._local is not None:
            return self._local.get_state()
        import ray_tpu_torch
        return ray_tpu_torch.get(self._actors[0].get_state.remote())

    def set_state(self, state):
        if self._local is not None:
            self._local.set_state(state)
            return
        import ray_tpu_torch
        ray_tpu_torch.get([a.set_state.remote(state) for a in self._actors])

    @property
    def local_learner(self) -> Optional[Learner]:
        return self._local
