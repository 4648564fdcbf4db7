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
(``self.batch_axes``; PPO's advantage normalisation). ``LearnerGroup``
runs one local learner: several learner actors (the reference's
gradient allreduce across them) come with the trainer, ROADMAP.md
Queue 1 item 4.3, and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch._device import DeviceLike, resolve_device
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
    device) with one transfer to the host."""
    keys = list(all_metrics[0])
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


def apply_gradients(loss: torch.Tensor, module: ActorCritic,
                    optimizer: torch.optim.Optimizer,
                    grad_clip: Optional[float], axes=()) -> None:
    """One step of the reference's ``optax.chain(clip_by_global_norm,
    adam)``: backward, the gradients summed over ``axes`` (the data
    axis of a sharded learner), the global-norm clip, then Adam.

    ``torch.optim.Adam`` and ``optax.adam`` take the same step: bias-
    corrected moments, eps added outside the square root
    (``tests/test_torch_rl_units.py`` holds the two to each other)."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for axis in axes:
        for p in module.parameters():
            dist.all_reduce(p.grad, op=dist.ReduceOp.SUM, group=axis.group)
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
                 mesh=None, device: DeviceLike = None):
        self.spec = module_spec
        self.device = resolve_device(device)
        axis = None if mesh is None else data_axis(mesh, self.device)
        self.batch_axes: Tuple[Axis, ...] = () if axis is None else (axis,)
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
                        axes)
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


class LearnerGroup:
    """One local learner (reference: learner_group.py:101)."""

    def __init__(self, learner_cls: Callable[..., Learner], *,
                 num_learners: int = 0, **learner_kwargs):
        if num_learners > 1:
            raise NotImplementedError(
                f"num_learners={num_learners}: several learner actors and "
                "their gradient allreduce come with the trainer, ROADMAP.md "
                "Queue 1 item 4.3, on the runtime of item 9; one learner "
                "trains data-parallel through Learner(mesh=...)")
        self._local = learner_cls(**learner_kwargs)

    def update(self, batch) -> Dict[str, Any]:
        return self._local.update(batch)

    def get_weights(self):
        return self._local.get_weights()

    def get_state(self):
        return self._local.get_state()

    def set_state(self, state):
        self._local.set_state(state)

    @property
    def local_learner(self) -> Learner:
        return self._local
