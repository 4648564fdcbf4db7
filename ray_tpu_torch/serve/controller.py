"""Serve controller: declarative target-state reconciliation
(port of ray_tpu/serve/controller.py).

Capability parity with the reference's control plane (reference:
python/ray/serve/_private/controller.py:102 ServeController actor;
deployment_state.py:1713,2957 DeploymentState(Manager) reconciler;
autoscaling_state.py + serve/autoscaling_policy.py target-ongoing-
requests autoscaling; long_poll.py:228 LongPollHost config push).

Runs as an actor with a background reconcile thread; routers learn of
replica-set changes through versioned polls (the long-poll equivalent).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core import events
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "SERVE_CONTROLLER"


class _DeploymentState:
    def __init__(self, name: str, app_name: str, callable_blob: bytes,
                 init_args_blob: bytes, config: DeploymentConfig,
                 route_prefix: Optional[str]):
        self.name = name
        self.app_name = app_name
        self.callable_blob = callable_blob
        self.init_args_blob = init_args_blob
        self.config = config
        self.route_prefix = route_prefix
        self.replicas: Dict[str, Any] = {}  # replica_id -> actor handle
        self.target = (config.autoscaling_config.min_replicas
                       if config.autoscaling_config
                       else config.num_replicas)
        self.next_replica_no = 0
        self.last_scale_up = 0.0
        self.last_scale_down = 0.0
        self.status = "UPDATING"
        # stateful autoscaling policy instance (ray_tpu_torch/autoscaler/
        # policy.py), created lazily per the config's policy name
        self.policy = None
        self.policy_name = None
        # latest router-pushed admission stats: (recv_monotonic, dict)
        self.slo_stats = None


class ServeController:
    """The singleton controller actor (named CONTROLLER_NAME)."""

    def __init__(self, reconcile_interval_s: float = 0.2):
        self._deployments: Dict[str, _DeploymentState] = {}
        self._lock = threading.RLock()
        self._version = 0
        self._version_cv = threading.Condition(self._lock)
        self._stop_event = threading.Event()
        self._interval = reconcile_interval_s
        self._thread = threading.Thread(target=self._reconcile_loop,
                                        daemon=True)
        self._thread.start()

    # -- API (called by serve.run / handles / proxy) --

    def deploy_application(self, app_name: str,
                           deployments: List[dict]) -> None:
        """deployments: [{name, callable_blob, init_args_blob, config,
        route_prefix}] — full target state for the app (reference:
        application_state.py apply_deployment_args)."""
        with self._lock:
            keep = set()
            for d in deployments:
                name = d["name"]
                keep.add(name)
                existing = self._deployments.get(name)
                if existing is not None:
                    existing.callable_blob = d["callable_blob"]
                    existing.init_args_blob = d["init_args_blob"]
                    old_config = existing.config
                    existing.config = d["config"]
                    existing.route_prefix = d.get("route_prefix")
                    if not existing.config.autoscaling_config:
                        existing.target = d["config"].num_replicas
                    if (d["config"].user_config is not None
                            and d["config"].user_config
                            != old_config.user_config):
                        for h in existing.replicas.values():
                            # fire-and-forget reconfigure broadcast; the
                            # completed result is reclaimed after grace
                            h.reconfigure.remote(d["config"].user_config)
                    existing.status = "UPDATING"
                else:
                    self._deployments[name] = _DeploymentState(
                        name, app_name, d["callable_blob"],
                        d["init_args_blob"], d["config"],
                        d.get("route_prefix"))
            # drop deployments of this app that were removed
            for name, st in list(self._deployments.items()):
                if st.app_name == app_name and name not in keep:
                    self._remove_deployment_locked(name)

    def delete_application(self, app_name: str) -> None:
        with self._lock:
            for name, st in list(self._deployments.items()):
                if st.app_name == app_name:
                    self._remove_deployment_locked(name)

    def _remove_deployment_locked(self, name: str) -> None:
        # caller holds self._lock (the _locked suffix is the contract)
        st = self._deployments.pop(name)
        for rid, h in st.replicas.items():
            events.emit("REPLICA_STOPPED",
                        message=f"{name}/{rid} deployment removed")
            try:
                ray_tpu_torch.kill(h)
            except Exception:
                logger.exception("kill failed for a replica of %r "
                                 "during deployment removal", name)
        self._bump_locked()

    def get_replicas(self, deployment_name: str) -> tuple:
        """(version, [(replica_id, handle), ...]) for routers."""
        with self._lock:
            st = self._deployments.get(deployment_name)
            if st is None:
                return self._version, []
            return self._version, list(st.replicas.items())

    def poll_replicas(self, deployment_name: str, known_version: int,
                      timeout_s: float = 2.0) -> tuple:
        """Long-poll: return when the replica set changes past
        known_version or timeout (reference: long_poll.py:228)."""
        deadline = time.monotonic() + timeout_s
        with self._version_cv:
            while (self._version <= known_version
                   and not self._stop_event.is_set()
                   and time.monotonic() < deadline):
                self._version_cv.wait(timeout=max(
                    0.0, deadline - time.monotonic()))
        return self.get_replicas(deployment_name)

    def get_status(self) -> Dict[str, dict]:
        with self._lock:
            return {
                name: {
                    "app": st.app_name,
                    "status": st.status,
                    "target_replicas": st.target,
                    "running_replicas": len(st.replicas),
                    "route_prefix": st.route_prefix,
                }
                for name, st in self._deployments.items()
            }

    def get_router_policy(self, deployment_name: str) -> str:
        """Routing policy for driver-side router construction
        ("pow2" | "prefix_aware")."""
        with self._lock:
            st = self._deployments.get(deployment_name)
            return (st.config.request_router if st is not None
                    else "pow2")

    def get_admission_config(self, deployment_name: str) -> dict:
        """Admission-control knobs for the driver-side
        AdmissionController (fetched on router refresh, so capacity
        tracks the live replica count)."""
        with self._lock:
            st = self._deployments.get(deployment_name)
            if st is None:
                return {"max_queued_requests": -1,
                        "max_ongoing_requests": 100,
                        "shed_queue_wait_s": 0.0,
                        "num_replicas": 0}
            return {
                "max_queued_requests": st.config.max_queued_requests,
                "max_ongoing_requests": st.config.max_ongoing_requests,
                "shed_queue_wait_s": st.config.shed_queue_wait_s,
                "num_replicas": len(st.replicas),
            }

    def report_slo_stats(self, deployment_name: str,
                         stats: Dict[str, float]) -> None:
        """Routers push their admission snapshot (queue depth, windowed
        p99, EWMA queue wait) here; the SLO autoscaling policy consumes
        it on the next reconcile tick. The registry metrics these come
        from live in the DRIVER process — the controller actor cannot
        read them, so the router pushes."""
        with self._lock:
            st = self._deployments.get(deployment_name)
            if st is not None:
                st.slo_stats = (time.monotonic(), dict(stats))

    def get_request_totals(self) -> Dict[str, float]:
        """deployment -> lifetime request count summed over replicas
        (feeds per-deployment QPS charts; reference:
        dashboard/modules/metrics serve panels).

        All replica probes are submitted up front and bounded by ONE
        wait (no serial per-replica timeouts on the scrape path). A
        deployment whose replicas ALL failed to answer is omitted —
        publishing 0 for a nonzero lifetime counter would make the
        series non-monotonic and chart a phantom QPS spike when it
        recovers."""
        import ray_tpu_torch
        with self._lock:
            handles = {name: list(st.replicas.values())
                       for name, st in self._deployments.items()}
        probes = [(name, h.get_metrics.remote(2.0))
                  for name, replicas in handles.items()
                  for h in replicas]
        if not probes:
            return {name: 0.0 for name in handles}
        ready, _ = ray_tpu_torch.wait([ref for _, ref in probes],
                                num_returns=len(probes), timeout=5)
        ready_set = set(r.id for r in ready)
        out: Dict[str, float] = {}
        answered: Dict[str, int] = {}
        for name, ref in probes:
            if ref.id not in ready_set:
                continue
            try:
                total = float(ray_tpu_torch.get(ref, timeout=1)["total"])
            except Exception:  # noqa: BLE001 — replica died mid-probe
                continue
            out[name] = out.get(name, 0.0) + total
            answered[name] = answered.get(name, 0) + 1
        for name, replicas in handles.items():
            if not replicas:
                out.setdefault(name, 0.0)  # zero replicas: honest zero
            elif not answered.get(name):
                out.pop(name, None)  # nobody answered: omit, not 0
        return out

    def list_routes(self) -> Dict[str, str]:
        """route_prefix -> ingress deployment name (for the proxy)."""
        with self._lock:
            return {st.route_prefix: name
                    for name, st in self._deployments.items()
                    if st.route_prefix}

    def shutdown(self) -> None:
        with self._lock:
            for name in list(self._deployments):
                self._remove_deployment_locked(name)
            self._stop_event.set()
            self._version_cv.notify_all()

    def ping(self) -> str:
        return "pong"

    # -- reconcile --

    def _bump_locked(self) -> None:
        # caller holds self._lock (the _locked suffix is the contract)
        self._version += 1
        self._version_cv.notify_all()

    def _reconcile_loop(self) -> None:
        # Event.wait instead of time.sleep: shutdown() wakes the loop
        # immediately instead of waiting out the reconcile interval
        while not self._stop_event.is_set():
            try:
                self._reconcile_once()
            except Exception:
                logger.exception("reconcile pass failed")
            self._stop_event.wait(self._interval)

    def _reconcile_once(self) -> None:
        with self._lock:
            states = list(self._deployments.values())
        for st in states:
            self._autoscale(st)
            self._health_check(st)
            self._scale_to_target(st)

    def _autoscale(self, st: _DeploymentState) -> None:
        from ray_tpu_torch.autoscaler.policy import ReplicaMetrics, make_policy
        cfg: Optional[AutoscalingConfig] = st.config.autoscaling_config
        if cfg is None or not st.replicas:
            return
        policy_name = getattr(cfg, "policy", "ongoing") or "ongoing"
        if st.policy is None or st.policy_name != policy_name:
            st.policy = make_policy(policy_name)
            st.policy_name = policy_name
        metrics = ReplicaMetrics(running_replicas=len(st.replicas))
        if not st.policy.owns_hysteresis:
            # replica probes feed the target-ongoing-requests policy;
            # the SLO policy runs off router-pushed stats alone and
            # skips this per-tick probe fan-out
            totals = []
            for rid, h in list(st.replicas.items()):
                try:
                    m = ray_tpu_torch.get(
                        h.get_metrics.remote(cfg.look_back_period_s),
                        timeout=1.0)
                    totals.append(m["avg_ongoing"])
                except Exception:
                    pass  # replica unreachable: health check owns that
            if not totals:
                return
            metrics.total_ongoing = sum(totals)
        now = time.monotonic()
        with self._lock:
            if st.slo_stats is not None:
                t_recv, stats = st.slo_stats
                metrics.stats_age_s = now - t_recv
                metrics.queue_depth = float(
                    stats.get("queue_depth", 0.0))
                metrics.p99_latency_s = float(
                    stats.get("p99_latency_s", 0.0))
                metrics.ewma_queue_wait_s = float(
                    stats.get("ewma_queue_wait_s", 0.0))
        desired = st.policy.desired_replicas(metrics, cfg, st.target, now)
        desired = max(cfg.min_replicas, min(cfg.max_replicas, desired))
        with self._lock:
            if st.policy.owns_hysteresis:
                # the policy already damped flapping (sustained-breach /
                # sustained-calm windows); adopt its verdict directly
                if desired > st.target:
                    st.last_scale_up = now
                elif desired < st.target:
                    st.last_scale_down = now
                st.target = desired
            elif desired > st.target:
                if now - st.last_scale_up >= cfg.upscale_delay_s:
                    st.target = desired
                    st.last_scale_up = now
            elif desired < st.target:
                if now - st.last_scale_down >= cfg.downscale_delay_s:
                    st.target = desired
                    st.last_scale_down = now

    def _health_check(self, st: _DeploymentState) -> None:
        dead = []
        for rid, h in list(st.replicas.items()):
            try:
                ray_tpu_torch.get(h.check_health.remote(), timeout=5.0)
            except Exception:
                dead.append(rid)
        if dead:
            with self._lock:
                for rid in dead:
                    h = st.replicas.pop(rid, None)
                    if h is not None:
                        events.emit("REPLICA_STOPPED", "WARNING",
                                    message=f"{st.name}/{rid} failed "
                                    "health check")
                        try:
                            ray_tpu_torch.kill(h)
                        except Exception:
                            logger.exception(
                                "kill failed for dead replica %s", rid)
                self._bump_locked()

    def _scale_to_target(self, st: _DeploymentState) -> None:
        from ray_tpu_torch.serve.replica import Replica
        with self._lock:
            delta = st.target - len(st.replicas)
        if delta > 0:
            ReplicaActor = ray_tpu_torch.remote(Replica)
            new = {}
            for _ in range(delta):
                with self._lock:
                    rid = f"{st.name}#{st.next_replica_no}"
                    st.next_replica_no += 1
                opts = dict(st.config.ray_actor_options)
                opts.setdefault("max_concurrency",
                                max(4, min(st.config.max_ongoing_requests,
                                           32)))
                handle = ReplicaActor.options(**opts).remote(
                    st.name, rid, st.callable_blob, st.init_args_blob,
                    st.config.max_ongoing_requests,
                    st.config.user_config)
                new[rid] = handle
            # wait for constructors so routers never see half-born replicas
            for rid, h in list(new.items()):  # failures pop from `new`
                try:
                    ray_tpu_torch.get(h.check_health.remote(), timeout=60.0)
                    events.emit("REPLICA_STARTED",
                                message=f"{st.name}/{rid}")
                except Exception:
                    logger.exception(
                        "replica %s failed construction health check; "
                        "discarding it", rid)
                    try:
                        ray_tpu_torch.kill(h)
                    except Exception:
                        pass  # best-effort: it never became healthy
                    new.pop(rid, None)
            with self._lock:
                st.replicas.update(new)
                st.status = ("HEALTHY" if len(st.replicas) >= st.target
                             else "UPDATING")
                self._bump_locked()
        elif delta < 0:
            with self._lock:
                victims = list(st.replicas)[delta:]
                doomed = [st.replicas.pop(rid) for rid in victims]
                st.status = "HEALTHY"
                self._bump_locked()
            for rid in victims:
                events.emit("REPLICA_STOPPED",
                            message=f"{st.name}/{rid} downscaled")
            for h in doomed:
                try:
                    # fire-and-forget pre-kill drain nudge; the replica
                    # dies right after, so nobody can hold the result
                    h.prepare_for_shutdown.remote()
                    ray_tpu_torch.kill(h)
                except Exception:
                    logger.exception("downscale shutdown failed for a "
                                     "replica of %r", st.name)
        else:
            with self._lock:
                if st.status != "HEALTHY" and len(st.replicas) >= st.target:
                    st.status = "HEALTHY"
