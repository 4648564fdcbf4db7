"""APPO — asynchronous PPO (port of ray_tpu/rl/algorithms/appo.py;
reference: rllib/algorithms/appo/).

PPO's clipped surrogate applied asynchronously: env-runner actors on the
port's runtime sample continuously and the learner consumes whichever
fragment arrives next, so slow runners never stall the update loop (the
IMPALA architecture with PPO's loss). Staleness is bounded by the ratio
clip: the surrogate is computed against the behaviour policy's
log-probs recorded at sample time, so a fragment collected a few weight
versions ago contributes a clipped, conservative update.

Weights go to each runner fire-and-forget once per step; a runner's
next fragment uses whatever version it last received. A runner that
fails twice is killed and made anew from its construction arguments;
after 3 x runners failures in one step the loop gives up. Connector
deltas ride the sample payloads.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

from ray_tpu_torch.rl.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rl.sample_batch import concat_samples

logger = logging.getLogger(__name__)


class APPOConfig(PPOConfig):
    def __init__(self):
        super().__init__()
        # APPO defaults: single pass per fragment (stale data does not
        # reward many epochs), more runners than PPO
        self.num_epochs = 1
        self.num_env_runners = 2
        # max fragments consumed per training_step() call
        self.max_fragments_per_step = 4


class APPO(PPO):
    # the asynchronous runner loop has no multi-agent support
    supports_multi_agent = False

    def setup(self, config: APPOConfig) -> None:
        if config.num_env_runners < 1:
            raise ValueError("APPO requires num_env_runners >= 1 "
                             "(asynchronous sampling needs actors)")
        super().setup(config)
        assert self._remote, "APPO runner group must be remote actors"
        # ref -> runner index, for resubmission on completion
        self._inflight: Dict[Any, int] = {}
        self._runner_failures: Dict[int, int] = {}

    def _launch(self, idx: int) -> None:
        ref = self.runners[idx].sample.remote()
        self._inflight[ref] = idx

    # -- fragment hooks (IMPALA overrides both: V-trace consumes the
    #    fragments time-major, without GAE or shuffled SGD epochs) -----
    def _prepare_fragment(self, cols, module):
        return self._postprocess(cols, module)

    def _train_fragments(self, batches) -> Dict[str, Any]:
        batch = concat_samples(batches)
        self._env_steps_lifetime += len(batch)
        return self._sgd_epochs(batch, self.learner_group)

    def _recreate_runner(self, idx: int, count: int, exc) -> None:
        """Kill runner ``idx`` (an application error leaves its process
        alive, and a leaked one would pin its CPU) and start it anew
        from its construction arguments."""
        import ray_tpu_torch
        logger.warning("APPO: recreating env runner %d after %d failures "
                       "(%r)", idx, count, exc)
        try:
            ray_tpu_torch.kill(self.runners[idx])
        except Exception:  # noqa: BLE001 — already dead
            logger.debug("runner kill failed", exc_info=True)
        self.runners[idx] = self._runner_actor_cls.remote(
            self._runner_blobs[idx])
        self._runner_failures[idx] = 0

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch

        cfg = self.config
        weights = self.learner_group.get_weights()
        module = self._weights_module(weights)
        if not self._inflight:
            for idx, runner in enumerate(self.runners):
                runner.set_weights.remote(weights)  # fire-and-forget
                self._launch(idx)

        batches = []
        deltas = []
        consumed = 0
        failures = 0
        pushed = set()  # weights are fixed within a step: push once
        metrics: Dict[str, Any] = {}
        while consumed < cfg.max_fragments_per_step:
            if failures > 3 * max(1, len(self.runners)):
                raise RuntimeError(
                    "APPO: every env runner is failing repeatedly; "
                    "giving up this step (check runner logs)")
            ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                          num_returns=1, timeout=60.0)
            if not ready:
                break  # stall: surface it via the metrics below
            ref = ready[0]
            idx = self._inflight.pop(ref)
            payload = None
            try:
                payload = ray_tpu_torch.get(ref)
                self._runner_failures[idx] = 0
            except Exception as exc:  # noqa: BLE001 — a failing runner
                # must not silently leave the rotation nor busy-spin: a
                # dead actor fails new tasks at once
                failures += 1
                count = self._runner_failures.get(idx, 0) + 1
                self._runner_failures[idx] = count
                if count >= 2:
                    self._recreate_runner(idx, count, exc)
                    # the fresh actor has construction-time weights
                    pushed.discard(idx)
            # resume sampling at once; weights go once per runner a step
            if idx not in pushed:
                self.runners[idx].set_weights.remote(weights)
                pushed.add(idx)
            self._launch(idx)
            if payload is None:
                continue
            # driver-side processing stays outside the runner-failure
            # handler: a postprocess bug surfaces as itself, not as a
            # "runner failure" that kills healthy actors
            cols, runner_metrics, delta = payload
            self.record_episodes(runner_metrics["episode_returns"],
                                 runner_metrics["episode_lens"])
            batches.append(self._prepare_fragment(cols, module))
            deltas.append(delta)
            consumed += 1
        if batches:
            metrics = self._train_fragments(batches)
        # deltas arrived with the sample payloads (no extra round trip:
        # a gather here would barrier on in-flight samples)
        self._merge_connector_deltas(deltas)
        metrics["fragments_consumed"] = consumed
        metrics["fragments_in_flight"] = len(self._inflight)
        return metrics

    def stop(self) -> None:
        self._inflight.clear()
        super().stop()


APPOConfig.algo_class = APPO
