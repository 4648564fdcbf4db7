"""Autoscaling of the port: the serve controller's replica policies
(``policy.py``, a copy of ray_tpu/autoscaler/policy.py). The reference's
cluster autoscaler (node providers, the demand scheduler) belongs to the
runtime's multi-node rest, ROADMAP.md Queue 1 item 6."""

from ray_tpu_torch.autoscaler.policy import (
    AutoscalingPolicy, ReplicaMetrics, SLOPolicy,
    TargetOngoingRequestsPolicy, make_policy)

__all__ = ["AutoscalingPolicy", "ReplicaMetrics", "SLOPolicy",
           "TargetOngoingRequestsPolicy", "make_policy"]
