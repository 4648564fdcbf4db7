"""Replica autoscaling policies for the serve controller
(port of ray_tpu/autoscaler/policy.py).

Reference: python/ray/serve/autoscaling_policy.py (the pluggable
policy seam) + serve/_private/autoscaling_state.py. Two policies ship:

- ``TargetOngoingRequestsPolicy`` — the reference default: desired =
  ceil(total_ongoing / target_ongoing_requests), rate-limited by the
  controller's upscale/downscale delays.
- ``SLOPolicy`` — scales on the driver-side router's admission stats
  (queue depth beyond replica capacity, windowed p99 latency) pushed
  to the controller via ``report_slo_stats``. Hysteresis is built in:
  a breach must be SUSTAINED for upscale_delay_s before replicas are
  added, and the deployment must sit comfortably below threshold
  (half of it) for downscale_delay_s before one is removed — so a
  bursty workload neither flaps up on a single spike nor flaps down
  during a lull between bursts.

The policy object is stateful (it tracks breach/calm streaks) and
lives on the controller's per-deployment state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ReplicaMetrics:
    """One reconcile tick's view of a deployment's load."""
    running_replicas: int = 0
    # summed avg ongoing requests over replicas (replica probes)
    total_ongoing: float = 0.0
    # router-reported admission stats (may be stale or absent)
    queue_depth: float = 0.0
    p99_latency_s: float = 0.0
    ewma_queue_wait_s: float = 0.0
    stats_age_s: float = field(default=math.inf)


class AutoscalingPolicy:
    """desired_replicas() is called once per reconcile tick with fresh
    metrics; it returns the new TARGET replica count. Policies with
    ``owns_hysteresis`` apply their own damping and the controller
    adopts the returned target directly; otherwise the controller's
    upscale/downscale delay rate-limiting applies on top."""

    owns_hysteresis = False

    def desired_replicas(self, metrics: ReplicaMetrics, cfg,
                         current_target: int, now: float) -> int:
        raise NotImplementedError


class TargetOngoingRequestsPolicy(AutoscalingPolicy):
    """desired = ceil(total_ongoing / target_ongoing_requests),
    clamped to [min_replicas, max_replicas]."""

    def desired_replicas(self, metrics: ReplicaMetrics, cfg,
                         current_target: int, now: float) -> int:
        desired = int(math.ceil(
            metrics.total_ongoing
            / max(cfg.target_ongoing_requests, 1e-9))) or cfg.min_replicas
        return max(cfg.min_replicas, min(cfg.max_replicas, desired))


class SLOPolicy(AutoscalingPolicy):
    """Scale on sustained queue-depth / p99 SLO breach.

    Upscale: queue_depth > target_queue_depth (or windowed p99 >
    p99_latency_slo_s when enabled) continuously for upscale_delay_s.
    The step is proportional to how far past target the queue sits, so
    a 10x overload converges in a couple of ticks instead of one
    replica at a time. Downscale: BOTH signals at most half their
    thresholds (or stats stale — an idle router stops reporting)
    continuously for downscale_delay_s, one replica at a time.
    """

    owns_hysteresis = True

    def __init__(self):
        self._breach_since: Optional[float] = None
        self._calm_since: Optional[float] = None

    def _is_breach(self, m: ReplicaMetrics, cfg) -> bool:
        if m.stats_age_s > cfg.slo_stats_staleness_s:
            return False  # stale stats never justify adding replicas
        if m.queue_depth > cfg.target_queue_depth:
            return True
        return (cfg.p99_latency_slo_s > 0.0
                and m.p99_latency_s > cfg.p99_latency_slo_s)

    def _is_calm(self, m: ReplicaMetrics, cfg) -> bool:
        if m.stats_age_s > cfg.slo_stats_staleness_s:
            return True  # no recent traffic at all
        if m.queue_depth > 0.5 * cfg.target_queue_depth:
            return False
        return (cfg.p99_latency_slo_s <= 0.0
                or m.p99_latency_s <= 0.5 * cfg.p99_latency_slo_s)

    def desired_replicas(self, metrics: ReplicaMetrics, cfg,
                         current_target: int, now: float) -> int:
        if self._is_breach(metrics, cfg):
            self._calm_since = None
            if self._breach_since is None:
                self._breach_since = now
            if now - self._breach_since >= cfg.upscale_delay_s:
                # re-arm: the NEXT step needs its own sustained window
                self._breach_since = now
                overshoot = (metrics.queue_depth
                             / max(cfg.target_queue_depth, 1e-9))
                step = max(1, int(math.ceil(overshoot)) - 1)
                return min(cfg.max_replicas, current_target + step)
            return max(cfg.min_replicas,
                       min(cfg.max_replicas, current_target))
        self._breach_since = None
        if self._is_calm(metrics, cfg):
            if self._calm_since is None:
                self._calm_since = now
            if (current_target > cfg.min_replicas
                    and now - self._calm_since >= cfg.downscale_delay_s):
                self._calm_since = now
                return current_target - 1
        else:
            self._calm_since = None
        return max(cfg.min_replicas,
                   min(cfg.max_replicas, current_target))


def make_policy(name: str) -> AutoscalingPolicy:
    if name == "slo":
        return SLOPolicy()
    if name == "ongoing":
        return TargetOngoingRequestsPolicy()
    raise ValueError(
        f"unknown autoscaling policy {name!r}; expected 'ongoing' or "
        "'slo'")
