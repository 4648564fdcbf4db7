"""Sebulba's batched policy-inference server on the port's Serve (port
of ray_tpu/rl/podracer/inference.py).

The policy forward is a serve deployment whose ``infer`` method sits
behind ``@serve.batch``: env-runner actors submit their per-step
observation blocks through ``DeploymentHandle``s, the batcher
accumulates them across actors up to ``MAX_BATCH_SIZE`` or
``BATCH_WAIT_S``, and one forward runs on the replica's card. Admission
control (``max_ongoing_requests`` / ``max_queued_requests``) bounds the
actors: an overloaded server sheds with a typed, retryable
``BackpressureError`` instead of queueing without bound. Actions are
drawn from the replica's own ``torch.Generator``, seeded ``seed + 1``.

Weight refresh is version-tagged and mid-flight: the learner calls
:func:`broadcast_weights` with an int8 block-quantized payload (the
EQuARX transport of ``parallel/collective.py``, about 4x smaller than
f32), every replica dequantizes into a fresh module and swaps
``(module, version)`` with one rebind: in-flight batches finish on the
old weights, the next batch reads the new pair. Replies carry the
serving version. Leaves are taken in ``jax.tree_util``'s order (dict
keys sorted, lists in order), so the port's payload of a tree equals
the reference's.
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch import serve
from ray_tpu_torch._device import device_type
from ray_tpu_torch.parallel.collective import (
    _dequantize_chunk, _quantize_chunk)
from ray_tpu_torch.util import flight_recorder

logger = logging.getLogger(__name__)

# Continuous-batching window: 32 requests is plenty of width for
# vector-obs policies while keeping the accumulate window (5 ms) well
# under a host env step; fixed at decoration time by @serve.batch.
MAX_BATCH_SIZE = 32
BATCH_WAIT_S = 0.005


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(template: Any, leaves) -> Any:
    if isinstance(template, dict):
        out = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _host_f32(leaf) -> Tuple[np.ndarray, str]:
    """A leaf (tensor or array) -> (f32 numpy copy, its dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        return (leaf.detach().float().cpu().numpy(),
                str(leaf.dtype).removeprefix("torch."))
    arr = np.asarray(leaf)
    return arr.astype(np.float32), str(arr.dtype)


def quantize_params(params) -> List[Tuple[tuple, str, tuple]]:
    """Flatten a params tree into ``(shape, dtype, q8-payload)`` per
    leaf — the wire format of a weight push (~4x smaller than f32)."""
    out = []
    for leaf in _leaves(params):
        arr, dtype = _host_f32(leaf)
        out.append((arr.shape, dtype, _quantize_chunk(arr, "int8")))
    return out


def dequantize_params(template, payload: List[Tuple[tuple, str, tuple]]):
    """Rebuild a params tree of tensors from the wire format, using the
    receiver's own ``template`` tree for structure; each leaf takes the
    payload's dtype and its template leaf's device."""
    leaves = _leaves(template)
    if len(leaves) != len(payload):
        raise ValueError(
            f"weight push has {len(payload)} leaves, receiver expects "
            f"{len(leaves)} — module specs out of sync")
    new_leaves = [
        torch.from_numpy(_dequantize_chunk(q).reshape(shape)).to(
            dtype=getattr(torch, dtype),
            device=getattr(like, "device", "cpu"))
        for like, (shape, dtype, q) in zip(leaves, payload)]
    return _rebuild(template, iter(new_leaves))


class _PolicyInference:
    """Batched actor-critic forward with live weight refresh."""

    def __init__(self, spec_blob: bytes, seed: int = 0,
                 device: str = "cuda"):
        from ray_tpu_torch.core import serialization
        from ray_tpu_torch.rl.rl_module import params_to_tree
        if device == "cuda":
            # the runtime names this replica's card in
            # CUDA_VISIBLE_DEVICES, so it is cuda:0 here
            torch.cuda.set_device(0)
        self.spec = serialization.loads(spec_blob)
        self.device = torch.device("cuda", 0) if device == "cuda" \
            else torch.device("cpu")
        module = self.spec.init(seed, self.device)
        # the tree layout a push rebuilds (numpy leaves, host side)
        self._template = params_to_tree(module)
        # (module, version): one rebind per weight push; readers unpack
        # a consistent pair, writers never block the forward
        self._weights: Tuple[Any, int] = (module, 0)
        # only the single batcher thread draws from it: no race
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed + 1)

    # -- learner-facing -------------------------------------------------
    def set_weights(self, version: int, payload) -> int:
        from ray_tpu_torch.rl.rl_module import load_params
        module, _ = self._weights
        fresh = copy.deepcopy(module)
        load_params(fresh, dequantize_params(self._template, payload))
        self._weights = (fresh, int(version))
        return int(version)

    def get_version(self) -> int:
        return self._weights[1]

    # -- actor-facing ---------------------------------------------------
    @serve.batch(max_batch_size=MAX_BATCH_SIZE,
                 batch_wait_timeout_s=BATCH_WAIT_S)
    def infer(self, obs_list: List[np.ndarray]) -> List[Dict[str, Any]]:
        """Each request is one actor's [n_envs, obs_dim] observation
        block; the realized batch concatenates across actors."""
        from ray_tpu_torch.rl.env_runner import draw_action_noise
        module, version = self._weights
        sizes = [np.asarray(o).shape[0] for o in obs_list]
        obs = np.concatenate([np.asarray(o, np.float32) for o in obs_list],
                             axis=0)
        t0 = flight_recorder.clock_ns()
        with torch.no_grad():
            dist, value = module(torch.as_tensor(obs, device=self.device))
            action = dist.sample_from_noise(draw_action_noise(
                self.spec, 1, len(obs), self._generator, self.device)[0])
            # logp and value cross to the host in one copy
            logp_value = torch.stack([dist.log_prob(action), value],
                                     dim=1).cpu().numpy()
        actions = action.cpu().numpy()
        rec = flight_recorder.RECORDER
        if rec is not None:
            rec.record("rl", "infer_batch", t0,
                       flight_recorder.clock_ns() - t0,
                       {"requests": len(obs_list), "rows": int(len(obs)),
                        "version": version})
        replies = []
        lo = 0
        for n in sizes:
            replies.append({"actions": actions[lo:lo + n],
                            "logp": logp_value[lo:lo + n, 0],
                            "values": logp_value[lo:lo + n, 1],
                            "version": version,
                            "batch_rows": int(len(obs))})
            lo += n
        return replies

    def __call__(self, obs) -> Dict[str, Any]:
        return self.infer(obs)


PolicyInference = serve.deployment(
    _PolicyInference, name="PolicyInference", max_ongoing_requests=64,
    max_queued_requests=256, ray_actor_options={"num_cpus": 0})


def build_inference_app(spec, *, seed: int = 0, num_replicas: int = 1,
                        max_ongoing_requests: int = 64,
                        max_queued_requests: int = 256,
                        name: str = "policy", device=None,
                        num_gpus: Optional[float] = None):
    """Bind the inference deployment for ``serve.run``. On ``cuda``
    (the default) each replica asks for ``num_gpus`` of a card, by
    default the cluster's GPUs shared among the replicas (at most one
    each)."""
    import ray_tpu_torch
    from ray_tpu_torch.core import serialization
    dev = device_type(device)
    options: Dict[str, Any] = {"num_cpus": 0}
    if dev == "cuda":
        if num_gpus is None:
            gpus = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            if gpus <= 0:
                raise RuntimeError("inference replicas on cuda need the "
                                   "runtime's GPU resource")
            num_gpus = min(1.0, gpus / num_replicas)
        options["num_gpus"] = num_gpus
    dep = PolicyInference.options(
        name=name, num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
        max_queued_requests=max_queued_requests,
        ray_actor_options=options)
    return dep.bind(serialization.dumps(spec), seed, dev)


def broadcast_weights(deployment_name: str, version: int,
                      payload) -> int:
    """Push (version, int8 payload) to every replica of the inference
    deployment: the router would pick one, and a refresh must reach them
    all. Goes through the replicas' control-plane entry point
    (``handle_control_request``), which skips the max_ongoing admission
    gate: the data-plane path returns a ``Rejected`` sentinel on a
    saturated replica that only the router retries, so a push through
    it would silently do nothing exactly when the system is loaded.
    Every reply is checked against the pushed version; returns the
    number of replicas that confirmed it (failures are logged, not
    raised: the next push retries them)."""
    import ray_tpu_torch
    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    _version, replicas = ray_tpu_torch.get(
        controller.get_replicas.remote(deployment_name))
    blob = serialization.dumps(((int(version), payload), {}))
    refs = [(rid, handle.handle_control_request.remote("set_weights", blob))
            for rid, handle in replicas]
    updated = 0
    failed = []
    for rid, ref in refs:
        try:
            confirmed = ray_tpu_torch.get(ref)
        except Exception:  # noqa: BLE001 — logged; the next push retries
            logger.warning("weight push v%d failed on replica %s",
                           version, rid, exc_info=True)
            failed.append(rid)
            continue
        if confirmed == int(version):
            updated += 1
        else:
            logger.warning("weight push v%d: replica %s confirmed %r",
                           version, rid, confirmed)
            failed.append(rid)
    if failed:
        logger.warning("weight push v%d reached %d/%d replicas "
                       "(failed: %s)", version, updated, len(refs), failed)
    return updated
