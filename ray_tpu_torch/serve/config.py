"""Serve configuration objects
(port of ray_tpu/serve/config.py).

Capability parity with the reference's serve config (reference:
python/ray/serve/config.py AutoscalingConfig/HTTPOptions;
serve/_private/config.py DeploymentConfig/ReplicaConfig).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    """reference: python/ray/serve/config.py AutoscalingConfig +
    serve/autoscaling_policy.py target-ongoing-requests policy."""
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 2.0
    # smoothed over this window of replica metric reports
    look_back_period_s: float = 2.0
    # "ongoing" (target-ongoing-requests, the reference default) or
    # "slo" (scale on router-reported queue depth + windowed p99
    # latency; see ray_tpu_torch/autoscaler/policy.py)
    policy: str = "ongoing"
    # -- slo policy knobs --
    # sustained queue depth above this target is an SLO breach
    target_queue_depth: float = 4.0
    # sustained windowed p99 above this is a breach; <= 0 disables the
    # latency term (queue depth alone drives scaling)
    p99_latency_slo_s: float = 0.0
    # router stats older than this are ignored (idle routers stop
    # reporting; stale breach data must not pin the fleet scaled-up)
    slo_stats_staleness_s: float = 3.0


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 100
    autoscaling_config: Optional[AutoscalingConfig] = None
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    user_config: Optional[Dict[str, Any]] = None
    health_check_period_s: float = 1.0
    graceful_shutdown_timeout_s: float = 5.0
    # routing policy: "pow2" (default) or "prefix_aware" (LLM
    # prompt-prefix cache affinity; reference:
    # llm/_internal/serve/routing_policies/prefix_aware/)
    request_router: str = "pow2"
    # -- admission control (ray_tpu_torch/serve/admission.py) --
    # requests allowed to wait beyond replica capacity
    # (live_replicas * max_ongoing_requests) before new arrivals shed
    # with 503/BackpressureError; < 0 disables the cap (legacy
    # unbounded-queue behavior). 0 sheds the moment every replica slot
    # is full; 1 lets exactly one request wait.
    max_queued_requests: int = -1
    # shed when the EWMA of observed queue wait exceeds this many
    # seconds, even under the hard cap; <= 0 disables
    shed_queue_wait_s: float = 0.0


@dataclass
class HTTPOptions:
    host: str = "127.0.0.1"
    port: int = 8000
