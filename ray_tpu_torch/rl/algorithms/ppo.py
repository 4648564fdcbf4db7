"""PPO (port of ray_tpu/rl/algorithms/ppo.py; reference:
rllib/algorithms/ppo/ppo.py — config defaults in PPOConfig.__init__,
surrogate loss in ppo_torch_learner.py compute_loss_for_module).

Two sampling paths, selected automatically:
- A ``TensorEnv`` registered for the env (e.g. "CartPole-v1"): the
  rollout runs on the device (``TensorEnvRunner``); the columns cross to
  the host for episode bookkeeping and for the minibatch shuffle, as in
  the reference, and the minibatches go back to the learner's device.
- Otherwise (no tensor env, or env-to-module connectors configured):
  one local ``SingleAgentEnvRunner`` samples Python envs through its
  connector pipeline.

With ``config.multi_agent(...)`` one local ``MultiAgentEnvRunner`` (or
``TurnBasedEnvRunner`` for an env with ``turn_based = True``) samples
the envs, and each module trains its own ``PPOLearner``. Remote env
runners are ROADMAP.md Queue 1 item 9, several learner actors item 4.3;
one ``PPOLearner(mesh=...)`` trains data-parallel (rl/learner.py).
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.parallel._sharded import all_reduce
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env_runner import SingleAgentEnvRunner, TensorEnvRunner
from ray_tpu_torch.rl.learner import (
    Learner, LearnerGroup, compute_gae, mean_metrics)
from ray_tpu_torch.rl.multi_agent import (
    MultiAgentEnvRunner, TurnBasedEnvRunner, infer_module_specs)
from ray_tpu_torch.rl.sample_batch import (
    ACTIONS, ADVANTAGES, DONES, FINAL_OBS, LOGP, OBS, REWARDS,
    TRUNCATEDS, VALUE_TARGETS, VF_PREDS, SampleBatch, concat_samples)


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.num_epochs = 4
        self.minibatch_size = 256
        self.grad_clip = 0.5


def normalize_advantages(adv: torch.Tensor, axes=()) -> torch.Tensor:
    """(adv - mean) / (population std + 1e-8), as ``jnp.std`` computes
    it; with ``axes`` (a sharded learner's data axis) the mean and the
    std are the global batch's, of which ``adv`` is this rank's rows, as
    GSPMD computes them for the reference's learner over a mesh."""
    if not axes:
        return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    n = adv.numel() * math.prod(a.size for a in axes)
    mean = all_reduce(adv.sum(), axes) / n
    var = all_reduce(((adv - mean) ** 2).sum(), axes) / n
    return (adv - mean) / (torch.sqrt(var) + 1e-8)


def ppo_loss(module, batch, *, clip_param: float, vf_clip_param: float,
             vf_loss_coeff: float, entropy_coeff: float, axes=()):
    """The clipped surrogate, the clipped value loss and the entropy
    bonus (ppo.py:52-81; Anakin's fused step shares it). Returns
    ``(total, metrics, logp)``. The advantages are normalised with the
    population std, as ``jnp.std`` computes it, over the global batch
    when ``axes`` split it (:func:`normalize_advantages`)."""
    dist, values = module(batch[OBS])
    logp = dist.log_prob(batch[ACTIONS])
    ratio = torch.exp(logp - batch[LOGP])
    adv = normalize_advantages(batch[ADVANTAGES], axes)
    surrogate = torch.minimum(
        adv * ratio, adv * torch.clamp(ratio, 1 - clip_param, 1 + clip_param))
    policy_loss = -surrogate.mean()

    vf_err = (values - batch[VALUE_TARGETS]) ** 2
    vf_clipped = batch[VF_PREDS] + torch.clamp(
        values - batch[VF_PREDS], -vf_clip_param, vf_clip_param)
    vf_err_clipped = (vf_clipped - batch[VALUE_TARGETS]) ** 2
    vf_loss = 0.5 * torch.maximum(vf_err, vf_err_clipped).mean()

    entropy = dist.entropy().mean()
    total = (policy_loss + vf_loss_coeff * vf_loss
             - entropy_coeff * entropy)
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                   "entropy": entropy}, logp


class PPOLearner(Learner):
    def __init__(self, module_spec, *, clip_param=0.2, vf_clip_param=10.0,
                 vf_loss_coeff=0.5, entropy_coeff=0.01, **kwargs):
        self.clip_param = clip_param
        self.vf_clip_param = vf_clip_param
        self.vf_loss_coeff = vf_loss_coeff
        self.entropy_coeff = entropy_coeff
        super().__init__(module_spec, **kwargs)

    def loss(self, module, batch):
        total, metrics, logp = ppo_loss(
            module, batch, clip_param=self.clip_param,
            vf_clip_param=self.vf_clip_param,
            vf_loss_coeff=self.vf_loss_coeff,
            entropy_coeff=self.entropy_coeff, axes=self.batch_axes)
        metrics["mean_kl"] = (batch[LOGP] - logp).mean()
        return total, metrics


class PPO(Algorithm):
    supports_multi_agent = True

    def setup(self, config: PPOConfig) -> None:
        self._eval_runner = None
        if config.is_multi_agent:
            self._setup_multi_agent(config)
            return
        self.ma_runner = None
        self.spec = config.module_spec()
        self.learner_group = LearnerGroup(
            PPOLearner, num_learners=config.num_learners,
            module_spec=self.spec, lr=config.lr,
            grad_clip=config.grad_clip, seed=config.seed,
            clip_param=config.clip_param,
            vf_clip_param=config.vf_clip_param,
            vf_loss_coeff=config.vf_loss_coeff,
            entropy_coeff=config.entropy_coeff, device=self.device)
        self._rng = np.random.default_rng(config.seed)
        tensor_env = config.make_tensor_env()
        if tensor_env is not None and not config.connector_factories:
            self.tensor_runner = TensorEnvRunner(
                tensor_env, self.spec,
                num_envs=config.num_envs_per_env_runner,
                rollout_len=config.rollout_fragment_length,
                seed=config.seed, device=self.device)
            self.runners = None
            return
        self.tensor_runner = None
        self.runners = [SingleAgentEnvRunner(
            env_creator=(config.env_creator
                         or (lambda cfg=config: cfg.make_python_env())),
            module_spec=self.spec,
            num_envs=config.num_envs_per_env_runner,
            rollout_len=config.rollout_fragment_length,
            seed=config.seed, connectors=config.build_connectors(),
            device=self.device)]

    # -- multi-agent (reference: multi_rl_module.py:40 module dict +
    #    per-policy learners; policy_mapping_fn routes agent streams) ---
    def _setup_multi_agent(self, config: PPOConfig) -> None:
        if config.num_learners > 1 or config.connector_factories:
            # (num_env_runners already raised in Algorithm.__init__)
            raise NotImplementedError(
                "multi-agent PPO runs one local env runner and per-module "
                "local learners; several learners are ROADMAP.md Queue 1 "
                "item 4.3, and env_to_module connectors on the multi-agent "
                "runner wait for the remote runners of item 9")
        env = config.make_multi_agent_env()
        try:
            self.ma_specs = infer_module_specs(
                env, config.policy_mapping_fn, config.policies,
                hidden=config.hidden)
        finally:
            env.close()
        self._rng = np.random.default_rng(config.seed)
        self.tensor_runner = None
        self.runners = None
        # One PPOLearner per module (shared mapping = self-play when
        # several agents feed one module; independent learners when the
        # mapping splits them).
        self.ma_learners = {
            mid: PPOLearner(
                spec, lr=config.lr, grad_clip=config.grad_clip,
                seed=config.seed + j, clip_param=config.clip_param,
                vf_clip_param=config.vf_clip_param,
                vf_loss_coeff=config.vf_loss_coeff,
                entropy_coeff=config.entropy_coeff, device=self.device)
            for j, (mid, spec) in enumerate(sorted(self.ma_specs.items()))}
        self._to_train = (set(config.policies_to_train)
                          if config.policies_to_train is not None
                          else set(self.ma_specs))
        unknown = self._to_train - set(self.ma_specs)
        if unknown:
            raise ValueError(f"policies_to_train has unknown ids {unknown}")
        # Envs declaring turn_based=True (acting set varies per step)
        # get the stream-assembling runner; parallel envs keep the
        # dense one.
        runner_cls = (TurnBasedEnvRunner
                      if getattr(env, "turn_based", False)
                      else MultiAgentEnvRunner)
        self.ma_runner = self._ma_runner(runner_cls, config.seed,
                                         config.num_envs_per_env_runner)

    def _ma_runner(self, runner_cls, seed: int, num_envs: int,
                   explore: bool = True):
        cfg = self.config
        return runner_cls(cfg.make_multi_agent_env, self.ma_specs,
                          cfg.policy_mapping_fn, num_envs=num_envs,
                          rollout_len=cfg.rollout_fragment_length,
                          seed=seed, explore=explore, device=self.device)

    def _ma_weights(self) -> Dict[str, Any]:
        return {mid: lrn.get_weights()
                for mid, lrn in self.ma_learners.items()}

    def _training_step_multi(self) -> Dict[str, Any]:
        cfg = self.config
        self.ma_runner.set_weights(self._ma_weights())
        batches = self.ma_runner.sample()
        metrics: Dict[str, Any] = {}
        runner_metrics = self.ma_runner.pop_metrics()
        self.record_episodes(runner_metrics["episode_returns"],
                             runner_metrics["episode_lens"])
        for mid, vals in runner_metrics["module_returns"].items():
            if vals:
                metrics[f"policy_reward_mean/{mid}"] = float(np.mean(vals))
        # env steps (not agent steps), once — matching the reference's
        # num_env_steps_sampled accounting
        self._env_steps_lifetime += self.ma_runner.env_steps_last_sample
        for mid, cols in batches.items():
            if mid not in self._to_train:
                continue  # frozen: skip GAE/value forward entirely
            learner = self.ma_learners[mid]
            batch = self._postprocess(cols, learner.module)
            for key, value in self._sgd_epochs(batch, learner).items():
                metrics[f"{mid}/{key}"] = value
        return metrics

    # -- evaluation-runner split (reference: algorithm.py:1407) ---------
    def evaluate(self) -> Dict[str, Any]:
        """Sample `evaluation_duration` episodes on a dedicated runner
        with exploration OFF; metrics stay separate from training."""
        cfg = self.config
        if self._eval_runner is None:
            if cfg.is_multi_agent:
                self._eval_runner = self._ma_runner(
                    type(self.ma_runner), cfg.seed + 10_000,
                    cfg.evaluation_num_envs, explore=False)
            else:
                self._eval_runner = SingleAgentEnvRunner(
                    env_creator=(cfg.env_creator
                                 or (lambda c=cfg: c.make_python_env())),
                    module_spec=self.spec,
                    num_envs=cfg.evaluation_num_envs,
                    rollout_len=cfg.rollout_fragment_length,
                    seed=cfg.seed + 10_000, explore=False,
                    connectors=cfg.build_connectors(), device=self.device)
        if cfg.is_multi_agent:
            self._eval_runner.set_weights(self._ma_weights())
        else:
            self._eval_runner.set_weights(self.learner_group.get_weights())
        # Stateful connectors (ObsNormalizer): evaluation must see the
        # statistics the policy was trained under, not a fresh
        # pipeline's identity transform. A copy: the reference hands
        # over the training runner's arrays, which evaluation's own
        # updates would then move.
        if self.runners is not None:
            self._eval_runner.set_connector_state(
                copy.deepcopy(self.runners[0].get_connector_state()))
        # Episodes begun under previous weights must not leak into this
        # measurement: restart every env.
        self._eval_runner.reset_envs()
        returns: List[float] = []
        lens: List[int] = []
        by_module: Dict[str, List[float]] = {}
        sampled = 0
        while len(returns) < cfg.evaluation_duration:
            self._eval_runner.sample()
            m = self._eval_runner.pop_metrics()
            returns.extend(m["episode_returns"])
            lens.extend(m["episode_lens"])
            for mid, vals in m.get("module_returns", {}).items():
                by_module.setdefault(mid, []).extend(vals)
            sampled += 1
            if sampled > 100:  # env never finishes an episode: bail
                break
        out = {
            "episode_return_mean": (float(np.mean(returns)) if returns
                                    else float("nan")),
            "episode_len_mean": (float(np.mean(lens)) if lens
                                 else float("nan")),
            "episodes_this_eval": len(returns),
        }
        for mid, vals in by_module.items():
            if vals:
                out[f"policy_reward_mean/{mid}"] = float(np.mean(vals))
        return out

    # ------------------------------------------------------------------
    def training_step(self) -> Dict[str, Any]:
        if self.ma_runner is not None:
            return self._training_step_multi()
        if self.tensor_runner is not None:
            return self._training_step_tensor()
        return self._training_step_python()

    def _postprocess(self, cols, module) -> SampleBatch:
        """[T, N] columns (host numpy or device tensors) -> flat [T*N]
        host batch with GAE columns.

        Truncated episodes (time limits) must not be treated as true
        terminations: the value of the real next obs is folded into the
        reward at the boundary (reference:
        rllib/evaluation/postprocessing.py — bootstrap at truncation),
        then GAE cuts the trace at every episode end.
        """
        def col(key):
            return torch.as_tensor(cols[key], device=self.device)

        with torch.no_grad():
            v_final = module.compute_values(col(FINAL_OBS).float())
            rewards = (col(REWARDS) + self.config.gamma * v_final
                       * col(TRUNCATEDS).float())
            adv, targets = compute_gae(
                rewards, col(VF_PREDS), col(DONES), col("bootstrap_value"),
                gamma=self.config.gamma, lambda_=self.config.lambda_)
        flat = {}
        for key in (OBS, ACTIONS, LOGP, VF_PREDS, REWARDS, DONES):
            arr = _host(cols[key])
            flat[key] = arr.reshape((-1,) + arr.shape[2:])
        flat[ADVANTAGES] = _host(adv).reshape(-1)
        flat[VALUE_TARGETS] = _host(targets).reshape(-1)
        return SampleBatch(flat)

    def _sgd_epochs(self, batch: SampleBatch, learner) -> Dict[str, Any]:
        """``num_epochs`` shuffled passes of minibatch updates through
        ``learner`` (a ``LearnerGroup`` or one module's ``Learner``)."""
        cfg = self.config
        mb = min(cfg.minibatch_size, len(batch))
        all_metrics: List[Dict] = []
        for _ in range(cfg.num_epochs):
            for minibatch in batch.minibatches(mb, self._rng):
                all_metrics.append(learner.update(minibatch))
        return mean_metrics(all_metrics)

    def _training_step_tensor(self) -> Dict[str, Any]:
        learner = self.learner_group.local_learner
        cols = self.tensor_runner.sample_device(learner.module)
        self._env_steps_lifetime += (self.tensor_runner.rollout_len
                                     * self.tensor_runner.num_envs)
        self.record_episodes(self.tensor_runner.pop_metrics()
                             ["episode_returns"])
        batch = self._postprocess(cols, learner.module)
        return self._sgd_epochs(batch, self.learner_group)

    def _training_step_python(self) -> Dict[str, Any]:
        learner = self.learner_group.local_learner
        weights = learner.get_weights()
        batches = []
        for runner in self.runners:
            runner.set_weights(weights)
            cols = runner.sample()
            batches.append(self._postprocess(cols, learner.module))
            self.record_episodes(runner.pop_metrics()["episode_returns"])
        batch = concat_samples(batches)
        self._env_steps_lifetime += len(batch)
        return self._sgd_epochs(batch, self.learner_group)

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        if self.ma_runner is not None:
            state["ma_learners"] = {mid: lrn.get_state()
                                    for mid, lrn in self.ma_learners.items()}
        else:
            state["learner"] = self.learner_group.get_state()
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        if self.ma_runner is not None:
            for mid, lrn_state in state["ma_learners"].items():
                self.ma_learners[mid].set_state(lrn_state)
        else:
            self.learner_group.set_state(state["learner"])


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


PPOConfig.algo_class = PPO
