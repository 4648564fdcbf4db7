"""Sebulba: decoupled actor–learner RL, Podracer architecture B (port of
ray_tpu/rl/podracer/sebulba.py).

Where Anakin fuses everything into one device program, Sebulba splits
the system across the port's runtime and lets every part run at its own
rate:

- **env-runner actors** step arbitrary Python envs on host CPUs and get
  actions from the batched inference server (``inference.py``) through
  ``DeploymentHandle``s; Serve's admission control bounds how hard they
  can push;
- finished trajectory fragments go into the object store
  (``ray_tpu_torch.put``) and only ``(meta, [ref])`` lands in the
  bounded replay actor: zero-copy for the data, drop-oldest for
  backpressure;
- a **learner actor** drains the replay queue, runs PPO updates on its
  device, and every ``weight_push_interval`` updates broadcasts a
  version-tagged int8 payload to every inference replica
  (:func:`~ray_tpu_torch.rl.podracer.inference.broadcast_weights`).
  Actors pick the new policy up between fragments without stopping.

Staleness is measured: every fragment carries the policy version that
produced it; the learner drops fragments whose version lag exceeds
``max_staleness`` and exports the observed lag as the
``ray_tpu_rl_weight_version_lag_steps`` gauge. The ``rl`` spans
(``rollout``, ``infer_batch``, ``replay_wait``, ``learn_step``,
``weight_push``) go to the port's flight recorder when the runtime
records.

Placement: env actors take ``num_cpus=0`` and compute on the CPU; on
``cuda`` (the default) the learner actor and the inference replicas
share the cards, each asking for an equal share (at most one card), so
the GPU actors never outnumber the shares.

The driver (:class:`Sebulba`) is a thin pump: it keeps one
``sample_fragment`` call in flight per actor via ``wait`` and an
immediate resubmit, survives actor death (the learner never notices),
and aggregates the run summary. It never touches trajectory data.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import exceptions, serve
from ray_tpu_torch._device import device_type
from ray_tpu_torch.util import flight_recorder

logger = logging.getLogger(__name__)

REPLAY_ACTOR_NAME = "sebulba:replay"


@dataclass
class SebulbaConfig:
    # env: registry name resolved via rl.env.make_env, or a zero-arg
    # creator callable (shipped to the actors by value when it lives in
    # a script or a test file)
    env: str = "CartPole-v1"
    env_creator: Optional[Callable[[], Any]] = None
    num_actors: int = 2
    num_envs_per_actor: int = 4
    rollout_len: int = 16
    hidden: Tuple[int, ...] = (32, 32)
    # PPO
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    vf_clip_param: float = 10.0
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: Optional[float] = 0.5
    # learner consumption
    fragments_per_step: int = 2
    max_staleness: int = 8          # drop fragments lagging > this many versions
    weight_push_interval: int = 1   # broadcast every N learner updates
    replay_capacity: int = 32
    # inference serving
    num_replicas: int = 1
    max_ongoing_requests: int = 64
    max_queued_requests: int = 256
    infer_timeout_s: float = 30.0
    app_name: str = "sebulba"
    deployment_name: str = "policy"
    seed: int = 0


# ---------------------------------------------------------------------------
# env-runner actor
# ---------------------------------------------------------------------------

class _SebulbaActorImpl:
    """Host-side env runner: python envs, actions via the inference
    handle, fragments via the object store. One ``sample_fragment``
    call is one [T, N] trajectory fragment."""

    def __init__(self, blob: bytes):
        from ray_tpu_torch.core import serialization
        kwargs = serialization.loads(blob)
        self.actor_id: int = kwargs["actor_id"]
        self.rollout_len: int = kwargs["rollout_len"]
        self.infer_timeout_s: float = kwargs["infer_timeout_s"]
        creator = kwargs["env_creator"]
        n = kwargs["num_envs"]
        seed = kwargs["seed"]
        self.envs = [creator() for _ in range(n)]
        self.handle: serve.DeploymentHandle = kwargs["handle"]
        self._replay = ray_tpu_torch.get_actor(kwargs["replay_name"])
        self._obs = np.stack([env.reset(seed=seed + i)[0]
                              for i, env in enumerate(self.envs)])
        self._ep_return = np.zeros(n)
        self._completed: List[float] = []

    def _infer(self, obs: np.ndarray) -> Dict[str, Any]:
        """One batched-inference round trip with bounded backpressure
        retries: admission control shedding is a signal to ease off,
        not an error."""
        deadline = time.monotonic() + self.infer_timeout_s
        while True:
            try:
                return self.handle.infer.remote(obs).result(
                    timeout_s=self.infer_timeout_s)
            except serve.BackpressureError as e:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(min(max(e.retry_after_s, 0.005), 0.25))

    def sample_fragment(self) -> Dict[str, Any]:
        from ray_tpu_torch.rl.sample_batch import (
            ACTIONS, DONES, FINAL_OBS, LOGP, OBS, REWARDS, TRUNCATEDS,
            VF_PREDS)
        T, N = self.rollout_len, len(self.envs)
        t0 = flight_recorder.clock_ns()
        cols: Dict[str, list] = {k: [] for k in
                                 (OBS, ACTIONS, LOGP, VF_PREDS, REWARDS,
                                  DONES, TRUNCATEDS, FINAL_OBS)}
        versions: List[int] = []
        batch_rows: List[int] = []
        for _ in range(T):
            reply = self._infer(self._obs)
            versions.append(int(reply["version"]))
            batch_rows.append(int(reply["batch_rows"]))
            action = np.asarray(reply["actions"])
            cols[OBS].append(self._obs.copy())
            cols[ACTIONS].append(action)
            cols[LOGP].append(np.asarray(reply["logp"]))
            cols[VF_PREDS].append(np.asarray(reply["values"]))
            rewards = np.zeros(N, dtype=np.float32)
            dones = np.zeros(N, dtype=bool)
            truncateds = np.zeros(N, dtype=bool)
            final_obs = np.zeros_like(self._obs)
            next_obs = np.zeros_like(self._obs)
            for i, env in enumerate(self.envs):
                obs, rew, term, trunc, _ = env.step(action[i])
                rewards[i] = rew
                final_obs[i] = obs
                self._ep_return[i] += rew
                if term or trunc:
                    dones[i] = True
                    truncateds[i] = trunc and not term
                    self._completed.append(float(self._ep_return[i]))
                    self._ep_return[i] = 0.0
                    obs, _ = env.reset()
                next_obs[i] = obs
            self._obs = next_obs
            cols[REWARDS].append(rewards)
            cols[DONES].append(dones)
            cols[TRUNCATEDS].append(truncateds)
            cols[FINAL_OBS].append(final_obs)
        # bootstrap values for the post-fragment obs come from the same
        # server (one more batched forward)
        boot = self._infer(self._obs)
        versions.append(int(boot["version"]))
        fragment = {k: np.stack(v) for k, v in cols.items()}
        fragment["bootstrap_value"] = np.asarray(boot["values"])
        fragment["version"] = max(versions)
        # Fragment liveness is a borrow chain, not a producer-side
        # cache: the awaited push deserializes the nested ref inside the
        # replay actor, which registers a borrowed reference that pins
        # the object while queued; the pop_many reply then pins it via
        # task-return containment until the learner's own borrow takes
        # over. The local `ref` only needs to outlive this push.
        ref = ray_tpu_torch.put(fragment)
        meta = {"actor_id": self.actor_id, "env_steps": T * N,
                "version": fragment["version"]}
        dropped = ray_tpu_torch.get(self._replay.push.remote((meta, [ref])))
        rec = flight_recorder.RECORDER
        if rec is not None:
            rec.record("rl", "rollout", t0,
                       flight_recorder.clock_ns() - t0,
                       {"arch": "sebulba", "actor_id": self.actor_id,
                        "env_steps": T * N,
                        "version": fragment["version"]})
        episode_returns, self._completed = self._completed, []
        return {"actor_id": self.actor_id, "env_steps": T * N,
                "versions_observed": versions,
                "episode_returns": episode_returns,
                "batch_rows": batch_rows, "dropped": bool(dropped)}

    def ping(self) -> bool:
        return True

    def die(self) -> None:
        """Hard-exit the worker process (actor-death test hook)."""
        import os
        os._exit(1)


# ---------------------------------------------------------------------------
# learner actor
# ---------------------------------------------------------------------------

class _SebulbaLearnerImpl:
    """Drains the replay queue, runs PPO updates on its device,
    broadcasts quantized version-tagged weights to the inference
    replicas."""

    def __init__(self, blob: bytes):
        from ray_tpu_torch.core import serialization
        from ray_tpu_torch.rl.algorithms.ppo import PPOLearner
        kwargs = serialization.loads(blob)
        cfg: SebulbaConfig = kwargs["config"]
        device = kwargs["device"]
        if device == "cuda":
            # the runtime names this worker's card in
            # CUDA_VISIBLE_DEVICES, so it is cuda:0 here
            torch.cuda.set_device(0)
        self.cfg = cfg
        self.learner = PPOLearner(
            kwargs["spec"], clip_param=cfg.clip_param,
            vf_clip_param=cfg.vf_clip_param,
            vf_loss_coeff=cfg.vf_loss_coeff,
            entropy_coeff=cfg.entropy_coeff, lr=cfg.lr,
            grad_clip=cfg.grad_clip, seed=cfg.seed, device=device)
        self._warm_up()
        self._replay = ray_tpu_torch.get_actor(kwargs["replay_name"])
        self.version = 0
        self.stale_dropped = 0
        self.weight_pushes = 0
        self.push_failures = 0  # pushes that missed >=1 replica
        self.last_push_ms = 0.0
        self.env_steps = 0

    def _warm_up(self) -> None:
        """One loss forward and backward on two rows of zeros, and no
        step: a card's first launches (cuBLAS handles, the first
        kernels: seconds) happen while the actor is constructed, not in
        the first update while the actors, already sampling, fill the
        replay queue with fragments that will be stale when read."""
        from ray_tpu_torch.rl.learner import batch_to_device
        spec = self.learner.spec
        act_shape = (2,) + tuple(spec.action_space.shape or ())
        batch = {
            "obs": np.zeros((2,) + tuple(spec.obs_space.shape), np.float32),
            "actions": np.zeros(act_shape, np.float32 if spec.is_continuous
                                else np.int64),
            "action_logp": np.zeros(2, np.float32),
            "vf_preds": np.zeros(2, np.float32),
            "advantages": np.zeros(2, np.float32),
            "value_targets": np.zeros(2, np.float32),
        }
        loss, _ = self.learner.loss(self.learner.module,
                                    batch_to_device(batch,
                                                    self.learner.device))
        loss.backward()
        self.learner.optimizer.zero_grad(set_to_none=True)
        if self.learner.device.type == "cuda":
            torch.cuda.synchronize()

    def _wait_fragments(self, want: int, timeout_s: float) -> List[Any]:
        """Poll the replay queue (recording the wait as
        ``rl.replay_wait``) until ``want`` fragments arrive or the
        timeout passes: a slow start must not deadlock the step."""
        t0 = flight_recorder.clock_ns()
        deadline = time.monotonic() + timeout_s
        items: List[Any] = []
        while len(items) < want:
            got = ray_tpu_torch.get(
                self._replay.pop_many.remote(want - len(items)))
            items.extend(got)
            if items and time.monotonic() >= deadline:
                break
            if not got:
                if time.monotonic() >= deadline:
                    break
                time.sleep(0.005)
        rec = flight_recorder.RECORDER
        if rec is not None:
            rec.record("rl", "replay_wait", t0,
                       flight_recorder.clock_ns() - t0,
                       {"fragments": len(items)})
        return items

    def _postprocess(self, fragment: Dict[str, Any]) -> Dict[str, Any]:
        """GAE over one [T, N] fragment -> flat [T*N] training columns
        (the truncation bootstrap of PPO._postprocess), on the
        learner's device; the columns come back to the host."""
        from ray_tpu_torch.rl.learner import compute_gae
        from ray_tpu_torch.rl.sample_batch import (
            ACTIONS, ADVANTAGES, DONES, FINAL_OBS, LOGP, OBS, REWARDS,
            TRUNCATEDS, VALUE_TARGETS, VF_PREDS)
        cfg = self.cfg
        device = self.learner.device

        def col(key):
            return torch.as_tensor(np.asarray(fragment[key]), device=device)

        final_obs = col(FINAL_OBS).float()
        with torch.no_grad():
            v_final = self.learner.module.compute_values(
                final_obs.reshape((-1,) + final_obs.shape[2:])
            ).reshape(fragment[REWARDS].shape)
            rewards = (col(REWARDS) + cfg.gamma * v_final
                       * col(TRUNCATEDS).float())
            adv, targets = compute_gae(
                rewards, col(VF_PREDS), col(DONES), col("bootstrap_value"),
                gamma=cfg.gamma, lambda_=cfg.lambda_)
        flat = {k: fragment[k].reshape((-1,) + fragment[k].shape[2:])
                for k in (OBS, ACTIONS, LOGP, VF_PREDS)}
        flat[ADVANTAGES] = adv.reshape(-1).cpu().numpy()
        flat[VALUE_TARGETS] = targets.reshape(-1).cpu().numpy()
        return flat

    def _push_weights(self) -> None:
        from ray_tpu_torch.rl.podracer.inference import (
            broadcast_weights, quantize_params)
        t0 = flight_recorder.clock_ns()
        payload = quantize_params(self.learner.get_weights())
        updated = broadcast_weights(
            self.cfg.deployment_name, self.version, payload)
        dur = flight_recorder.clock_ns() - t0
        self.weight_pushes += 1
        if updated < self.cfg.num_replicas:
            self.push_failures += 1
        self.last_push_ms = dur / 1e6
        rec = flight_recorder.RECORDER
        if rec is not None:
            rec.record("rl", "weight_push", t0, dur,
                       {"version": self.version, "replicas_updated": updated})

    def learn_steps(self, num_steps: int, *,
                    step_timeout_s: float = 30.0) -> Dict[str, Any]:
        """Run ``num_steps`` PPO updates off the replay queue; returns
        the run summary (losses, staleness, push stats)."""
        from ray_tpu_torch.util import metrics as metrics_mod
        cfg = self.cfg
        history: List[Dict[str, float]] = []
        lags: List[int] = []
        learn_ms: List[float] = []
        for _ in range(num_steps):
            items = self._wait_fragments(cfg.fragments_per_step,
                                         step_timeout_s)
            fresh: List[Dict[str, Any]] = []
            step_lags: List[int] = []
            for meta, refs in items:
                lag = self.version - int(meta["version"])
                if lag > cfg.max_staleness:
                    self.stale_dropped += 1
                    continue
                step_lags.append(lag)
                fresh.append(ray_tpu_torch.get(refs[0]))
            if not fresh:
                continue
            t0 = flight_recorder.clock_ns()
            flats = [self._postprocess(f) for f in fresh]
            batch = {k: np.concatenate([f[k] for f in flats])
                     for k in flats[0]}
            m = self.learner.update(batch)
            m = {k: float(v) for k, v in zip(
                m, torch.stack([v.float() for v in m.values()]).tolist())}
            self.version += 1
            step_steps = sum(int(np.prod(f["rewards"].shape))
                             for f in fresh)
            self.env_steps += step_steps
            dur = flight_recorder.clock_ns() - t0
            learn_ms.append(dur / 1e6)
            rec = flight_recorder.RECORDER
            if rec is not None:
                rec.record("rl", "learn_step", t0, dur,
                           {"arch": "sebulba", "version": self.version,
                            "env_steps": step_steps})
            if self.version % cfg.weight_push_interval == 0:
                self._push_weights()
            lags.extend(step_lags)
            depth = ray_tpu_torch.get(self._replay.depth.remote())
            max_lag = max(step_lags) if step_lags else 0
            # one RPC per learner step: every rl metric rides together
            metrics_mod.record_batch([
                ("counter", "ray_tpu_rl_env_steps_total",
                 {"arch": "sebulba"}, float(step_steps), None),
                ("histogram", "ray_tpu_rl_inference_batch_size",
                 {"arch": "sebulba"}, float(batch["obs"].shape[0]), None),
                ("gauge", "ray_tpu_rl_weight_version_lag_steps",
                 {"arch": "sebulba"}, float(max_lag), None),
                ("gauge", "ray_tpu_rl_replay_queue_depth",
                 {"arch": "sebulba"}, float(depth), None),
            ])
            history.append(m)
        return {
            "history": history,
            "num_updates": self.version,
            "env_steps": self.env_steps,
            "stale_dropped": self.stale_dropped,
            "weight_pushes": self.weight_pushes,
            "push_failures": self.push_failures,
            "last_push_ms": self.last_push_ms,
            "learn_step_ms": learn_ms,
            "version_lag_max": max(lags) if lags else 0,
            "version_lag_mean": float(np.mean(lags)) if lags else 0.0,
        }

    def get_version(self) -> int:
        return self.version

    def ping(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

class Sebulba:
    """Wire up and pump the whole architecture: inference app, replay
    actor, env-runner actors, learner actor. ``device`` is the learner's
    and the replicas' (``None``: the card); env actors compute on the
    CPU."""

    def __init__(self, config: SebulbaConfig, device=None):
        from ray_tpu_torch.core import serialization
        from ray_tpu_torch.rl.env import make_env
        from ray_tpu_torch.rl.podracer.inference import build_inference_app
        from ray_tpu_torch.rl.podracer.replay import create_replay_actor
        from ray_tpu_torch.rl.rl_module import RLModuleSpec

        if not ray_tpu_torch.is_initialized():
            raise RuntimeError("Sebulba needs ray_tpu_torch.init() first")
        self.config = config
        self.device = device_type(device)
        gpu_share = None
        if self.device == "cuda":
            gpus = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            if gpus <= 0:
                raise RuntimeError("Sebulba on cuda needs the runtime's "
                                   "GPU resource")
            # the learner and every replica: equal shares, so the GPU
            # actors never outnumber what the cards hold
            gpu_share = min(1.0, gpus / (config.num_replicas + 1))
        creator = config.env_creator or (lambda: make_env(config.env))
        probe = creator()
        self.spec = RLModuleSpec(probe.observation_space,
                                 probe.action_space, config.hidden)

        # Every actor process starts at once (each imports torch, some
        # seconds apiece): the replay actor's name resolves from its
        # submission and a DeploymentHandle is only names, so nothing
        # waits for anything before serve.run returns.
        self._replay_name = f"{REPLAY_ACTOR_NAME}:{config.app_name}"
        self.replay = create_replay_actor(config.replay_capacity,
                                          name=self._replay_name,
                                          wait=False)
        self.handle = serve.get_deployment_handle(config.deployment_name,
                                                  config.app_name)
        # num_cpus=0 across the constellation: env actors block on
        # inference round trips and the learner on the replay queue, so
        # strict CPU accounting would deadlock small (even 1-CPU) nodes
        actor_cls = ray_tpu_torch.remote(_SebulbaActorImpl).options(
            num_cpus=0)
        self.actors = []
        for i in range(config.num_actors):
            blob = serialization.dumps({
                "actor_id": i,
                "env_creator": creator,
                "num_envs": config.num_envs_per_actor,
                "rollout_len": config.rollout_len,
                "seed": config.seed + 1000 * (i + 1),
                "handle": self.handle,
                "replay_name": self._replay_name,
                "infer_timeout_s": config.infer_timeout_s,
            })
            self.actors.append(actor_cls.remote(blob))
        learner_opts: Dict[str, Any] = {"num_cpus": 0}
        if gpu_share is not None:
            learner_opts["num_gpus"] = gpu_share
        learner_cls = ray_tpu_torch.remote(_SebulbaLearnerImpl).options(
            **learner_opts)
        self.learner = learner_cls.remote(serialization.dumps({
            "config": config,
            "spec": self.spec,
            "replay_name": self._replay_name,
            "device": self.device,
        }))
        serve.run(
            build_inference_app(
                self.spec, seed=config.seed,
                num_replicas=config.num_replicas,
                max_ongoing_requests=config.max_ongoing_requests,
                max_queued_requests=config.max_queued_requests,
                name=config.deployment_name, device=self.device,
                num_gpus=gpu_share),
            name=config.app_name, route_prefix=None)
        ray_tpu_torch.get([h.ping.remote() for h in
                           (self.replay, *self.actors, self.learner)])
        self.actor_deaths = 0

    def train(self, learner_steps: int, *,
              step_timeout_s: float = 30.0) -> Dict[str, Any]:
        """Pump actors (one in-flight fragment each, immediate resubmit:
        sampling never pauses) while the learner runs ``learner_steps``
        updates; returns the merged summary."""
        learn_ref = self.learner.learn_steps.remote(
            learner_steps, step_timeout_s=step_timeout_s)
        pending: Dict[Any, Any] = {
            a.sample_fragment.remote(): a for a in self.actors}
        metas: List[Dict[str, Any]] = []
        versions_by_actor: Dict[int, List[int]] = {}
        episode_returns: List[float] = []
        batch_rows: List[int] = []
        t_start = time.perf_counter()
        learn_done = False
        while pending and not learn_done:
            ready, _ = ray_tpu_torch.wait(
                list(pending) + [learn_ref], num_returns=1)
            for ref in ready:
                if ref == learn_ref:
                    learn_done = True
                    continue
                actor = pending.pop(ref)
                try:
                    meta = ray_tpu_torch.get(ref)
                except (exceptions.ActorError,
                        exceptions.WorkerCrashedError):
                    # actor died mid-rollout: drop it, everyone else
                    # (learner included) keeps going
                    self.actor_deaths += 1
                    self.actors = [a for a in self.actors if a is not actor]
                    continue
                metas.append(meta)
                versions_by_actor.setdefault(
                    meta["actor_id"], []).extend(meta["versions_observed"])
                episode_returns.extend(meta["episode_returns"])
                batch_rows.extend(meta["batch_rows"])
                # resubmit at once: the pump never leaves an actor idle
                pending[actor.sample_fragment.remote()] = actor
        wall = max(time.perf_counter() - t_start, 1e-9)
        learn_summary = ray_tpu_torch.get(learn_ref)
        # drain in-flight fragments so shutdown doesn't race the replay
        if pending:
            ray_tpu_torch.wait(list(pending), num_returns=len(pending),
                               timeout=step_timeout_s)
        env_steps = sum(m["env_steps"] for m in metas)
        return {
            "learner": learn_summary,
            "env_steps_sampled": env_steps,
            "env_steps_per_sec": env_steps / wall,
            "fragments": len(metas),
            "episode_returns": episode_returns,
            "versions_by_actor": versions_by_actor,
            "mean_batch_rows": float(np.mean(batch_rows))
            if batch_rows else 0.0,
            "actor_deaths": self.actor_deaths,
            "replay": ray_tpu_torch.get(self.replay.stats.remote()),
        }

    def shutdown(self) -> None:
        for h in (*self.actors, self.learner, self.replay):
            try:
                ray_tpu_torch.kill(h)
            except Exception:  # noqa: BLE001 — already gone
                logger.debug("kill during shutdown failed", exc_info=True)
        try:
            serve.delete(self.config.app_name)
        except Exception:  # noqa: BLE001 — the controller is gone
            logger.debug("serve.delete(%s) during shutdown failed",
                         self.config.app_name, exc_info=True)
