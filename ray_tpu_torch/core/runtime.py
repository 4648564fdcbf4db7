"""Driver/head runtime: submission, scheduling loop, ownership, actors.

Capability parity with the reference's core-worker driver role plus the
GCS-side managers (reference: src/ray/core_worker/core_worker.h:170
SubmitTask/Get/Put/Wait; gcs_actor_manager.h:93 actor lifecycle +
restarts; task retry in task_manager.h:175). The head process is the
single owner and scheduler authority: workers reach it over their node
socket, nodes are in-process objects (multi-node simulated clusters run
many Nodes in this one process — reference: python/ray/cluster_utils.py).

Port of ray_tpu/core/runtime.py: the single-host core. Remote nodes
(the head's TCP listener, node daemons, node-to-node object transfer)
and the collective and sampling sanitizers are not copied; the GCS
methods that reach them raise ``NotImplementedError`` naming ROADMAP
item 9.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core import events as events_mod
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import get_config, reset_config
from ray_tpu_torch.core.gcs import ActorRecord, Gcs, JobRecord, NodeRecord
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.node import Node
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.object_store import MemoryStore
from ray_tpu_torch.core.scheduler import ClusterScheduler
from ray_tpu_torch.core import task_phase as _task_phase
from ray_tpu_torch.core.task_manager import ObjectLocation, ReferenceCounter, TaskManager
from ray_tpu_torch.core.task_spec import TaskSpec
from ray_tpu_torch.devtools import refsan
from ray_tpu_torch.util.metrics import Counter
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    TaskCancelledError,
    WorkerCrashedError,
)

logger = logging.getLogger(__name__)

_runtime_lock = threading.Lock()
_runtime = None

_SPILL_MISS = object()  # sentinel: spilled payload not readable here

# The reference keeps this counter in core/object_transfer.py, which the
# single-host copy leaves out; the inline and shm-copy paths count here.
TRANSFER_BYTES = Counter(
    "ray_tpu_object_transfer_bytes_total",
    "Object bytes moved through the object plane", tag_keys=("transport",))


def get_runtime():
    if _runtime is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _runtime


def get_runtime_or_none():
    return _runtime


def set_runtime(rt) -> None:
    global _runtime
    with _runtime_lock:
        _runtime = rt


class StreamState:
    """Owner-side record of a streaming task's yields (reference:
    task_manager.h streaming-generator return bookkeeping)."""

    def __init__(self):
        self.cond = threading.Condition()
        self.items: List[ObjectID] = []
        self.done = False
        self.error: Optional[Exception] = None
        # (index, fire(status, payload)) waiters from worker STREAM_NEXT
        self.waiters: List[Tuple[int, Callable]] = []
        # consumer dropped its generator; late items are reclaimed and
        # the state is popped at stream completion
        self.abandoned = False


class ActorInfo:
    def __init__(self, creation_spec: TaskSpec):
        self.creation_spec = creation_spec
        self.node_id: Optional[NodeID] = None
        self.worker_id: Optional[WorkerID] = None
        self.buffered: deque = deque()
        self.lock = threading.Lock()
        # True only after creation completed AND the buffer was flushed —
        # direct dispatch before that would overtake buffered tasks.
        self.ready_for_dispatch = False
        # Node whose resources the creation task acquired; released exactly
        # once per incarnation at actor death.
        self.resources_node: Optional[NodeID] = None


class DriverRuntime:
    is_driver = True

    def __init__(self, resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 object_store_memory: Optional[int] = None,
                 system_config: Optional[dict] = None,
                 namespace: str = ""):
        reset_config(system_config)
        cfg = get_config()
        store = None
        if cfg.gcs_persistence_path:
            from ray_tpu_torch.core.gcs_store import FileStoreClient
            store = FileStoreClient(cfg.gcs_persistence_path)
        self.gcs = Gcs(store=store)
        # Fresh flight-recorder collector per session; enables the
        # driver's own journal (and the env flags workers inherit)
        # when cfg.flight_recorder_enabled.
        from ray_tpu_torch.util import flight_recorder
        flight_recorder.init_driver()
        # Same idea for the lifetime sanitizer: fresh collector per
        # session, ledger enabled iff RAY_TPU_REFSAN is exported.
        refsan.init_driver()
        _task_phase.reset()
        self.scheduler = ClusterScheduler(self.gcs)
        self.task_manager = TaskManager()
        self.reference_counter = ReferenceCounter()
        self.reference_counter.set_deleter(self._maybe_delete_object)
        self.reference_counter.refsan_role = "owner"
        # Hostile-store mode collapses the borrow grace window so
        # deferred reclaims fire at the earliest legal moment — tier-1
        # uses it (with refsan) to force grace-violation races instead of
        # waiting for them.
        self._ref_grace_s = 0.05 if cfg.refsan_hostile_eviction else 2.0
        # objects pinned because they are contained in a stored value
        # (task return / put): container oid -> contained oids
        self._contained_refs: Dict[ObjectID, List[ObjectID]] = {}
        self._contained_lock = threading.Lock()
        # streaming-task yields (reference: _raylet.pyx:299)
        self._streams: Dict[TaskID, StreamState] = {}
        self._streams_lock = threading.Lock()
        # pubsub push routes per worker, removed at death
        self._worker_subs: Dict[tuple, list] = {}
        self._worker_subs_lock = threading.Lock()
        # Lineage: specs of completed stateless tasks, kept (bounded
        # LRU) so lost objects can be reconstructed by re-execution
        # (reference: task_manager.h:175 lineage + max_lineage_bytes;
        # object_recovery_manager.h:41). Actor/streaming tasks are
        # excluded — reconstruction is wrong for stateful work
        # (SURVEY §7).
        from collections import OrderedDict
        self._lineage: "OrderedDict[TaskID, TaskSpec]" = OrderedDict()
        self._lineage_by_object: Dict[ObjectID, TaskID] = {}
        self._lineage_lock = threading.Lock()
        self._reconstructing: set = set()
        # Recovery attribution (core/events.py): death-triggered work
        # carries the death event's seq so incident timelines chain.
        # _cause_by_task: resubmitted task -> (retry_event_seq,
        # death_ts); its next lease grant closes the reschedule phase.
        # _last_death_seq seeds reconstruction chains (lineage recovery
        # has no per-object death attribution); _reconstruct_events
        # tracks open RECONSTRUCT_START spans per requested object.
        self._event_chain_lock = threading.Lock()
        self._cause_by_task: Dict[TaskID, tuple] = {}
        self._last_death_seq: Optional[int] = None
        self._reconstruct_events: Dict[ObjectID, tuple] = {}
        # single expiry thread for deferred ref drops (no Timer churn)
        self._expiry_items: List[tuple] = []
        self._expiry_cv = threading.Condition()
        self._expiry_thread = threading.Thread(
            target=self._expiry_loop, name="ref-expiry", daemon=True)
        self._expiry_thread.start()
        # periodic state snapshot for the out-of-process CLI
        # (reference: the dashboard state aggregator; here a JSON file)
        self._state_dump_thread = threading.Thread(
            target=self._state_dump_loop, name="state-dump", daemon=True)
        self._state_dump_thread.start()
        self.memory_store = MemoryStore()
        self.namespace = namespace
        self.job_id = JobID.from_random()
        self.gcs.register_job(JobRecord(self.job_id))
        self.nodes: Dict[NodeID, Node] = {}
        self.actors: Dict[ActorID, ActorInfo] = {}
        self._put_counter = 0
        self._put_lock = threading.Lock()
        self._driver_task_id = TaskID.from_random()
        self._stopped = threading.Event()
        # Scheduling queue
        self._sched_cond = threading.Condition()
        self._schedulable: deque = deque()
        self._infeasible: List[TaskSpec] = []
        # task ids dispatched by burst grant (lease reuse): they hold
        # no scheduler resources; release paths consume the marker
        self._overcommitted: set = set()
        # snapshot of the scheduling backlog, refreshed each loop pass;
        # read by the autoscaler's demand export (reference:
        # gcs_autoscaler_state_manager.h pending-demand reporting)
        self._backlog_view: List[TaskSpec] = []
        # Placement groups waiting for capacity: creation is queued,
        # not fail-fast — the autoscaler reads these as gang demand and
        # new-node registration retries them (reference:
        # gcs_placement_group_scheduler.h:281 pending queue + 2PC).
        self._pending_pgs: List = []
        self._pg_lock = threading.Lock()
        # Fast-dispatch lease cache: resource-shape -> last node that
        # granted it (reference: owner-side lease caching per resource
        # shape, normal_task_submitter.cc:499). try_acquire on the
        # cached node skips the full pick_node scan on the hot path;
        # a failed acquire falls back and refreshes the entry.
        self._dispatch_cache: Dict[tuple, NodeID] = {}
        self._sched_thread = threading.Thread(
            target=self._scheduling_loop, name="scheduler", daemon=True)
        # objects replicated beyond their primary location by copies
        # between in-process node arenas: oid -> set of NodeIDs holding
        # a sealed copy
        self._replica_lock = threading.Lock()
        self._object_replicas: Dict[ObjectID, set] = {}
        self.head_node_id = self.add_node(
            resources if resources is not None else None, labels,
            object_store_memory)
        # Journal-replayed actors come back ORPHANED, awaiting a node
        # daemon's re-report. A single host has no daemon to report
        # them, so they are reaped at once (name released, journal
        # entry dropped, get_actor then fails cleanly).
        for aid, rec in list(self.gcs.actors.items()):
            if rec.state == "ORPHANED":
                self.gcs.update_actor_state(
                    aid, "DEAD", death_cause="node never re-registered "
                    "after the head restart")
        self._sched_thread.start()

    # --- cluster membership --------------------------------------------
    def add_node(self, resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 object_store_memory: Optional[int] = None) -> NodeID:
        import multiprocessing
        if resources is None:
            resources = {}
        resources = dict(resources)
        resources.setdefault("CPU", float(multiprocessing.cpu_count()))
        labels = dict(labels or {})
        # GPU hosts self-describe their GPU count (reference: the
        # accelerator manager hook in node registration).
        from ray_tpu_torch.accelerators.gpu import GpuAcceleratorManager
        GpuAcceleratorManager.augment_node(resources, labels)
        node_id = NodeID.from_random()
        node = Node(self, node_id, resources, labels,
                    object_store_memory=object_store_memory)
        self.nodes[node_id] = node
        self.scheduler.add_node(node_id, resources, labels)
        self.gcs.register_node(NodeRecord(
            node_id=node_id, address=node.socket_path,
            resources_total=resources, labels=dict(labels or {}),
            node_manager=node))
        # New capacity: gang reservations first (a queued PG may claim
        # this node whole), then re-check infeasible + queued work.
        self.retry_pending_placement_groups()
        with self._sched_cond:
            self._schedulable.extend(self._infeasible)
            self._infeasible.clear()
            self._sched_cond.notify_all()
        return node_id

    def _emit_task_retry(self, spec: TaskSpec,
                         cause_seq: Optional[int]) -> None:
        """Chain a death-triggered resubmit into its incident: the
        TASK_RETRY event hangs off the death event, and the next lease
        grant for this task id closes the reschedule phase (see
        _emit_lease_grant). Runs on node reader / monitor threads."""
        seq = self.gcs.add_cluster_event(
            "TASK_RETRY", "WARNING", task_id=spec.task_id,
            message=spec.name or str(spec.function_id),
            caused_by=cause_seq)
        if seq is not None:
            with self._event_chain_lock:
                self._cause_by_task[spec.task_id] = (seq, time.time())

    def _emit_lease_grant(self, spec: TaskSpec, node_id: NodeID) -> None:
        """Cluster-event mirror of the SCHEDULED task event. Routine
        grants are DEBUG-severity noise; a grant rescheduling a
        death-triggered retry chains to its TASK_RETRY event and
        observes the incident's reschedule latency (*_local: reachable
        from node reader threads / the IO loop via reap paths)."""
        with self._event_chain_lock:
            cause = self._cause_by_task.pop(spec.task_id, None)
        if cause is None:
            self.gcs.add_cluster_event(
                "LEASE_GRANTED", "DEBUG", node_id=node_id,
                task_id=spec.task_id, message=spec.name or "")
            return
        retry_seq, death_ts = cause
        reschedule_s = max(0.0, time.time() - death_ts)
        self.gcs.add_cluster_event(
            "LEASE_GRANTED", node_id=node_id, task_id=spec.task_id,
            message=spec.name or "", caused_by=retry_seq,
            data={"reschedule_s": round(reschedule_s, 6)})
        events_mod.RECOVERY_SECONDS.observe_local(
            reschedule_s, tags={"phase": "reschedule"})

    def add_object_replica(self, oid: ObjectID, node_id: NodeID) -> None:
        with self._replica_lock:
            self._object_replicas.setdefault(oid, set()).add(node_id)

    def object_holders(self, oid: ObjectID) -> List[NodeID]:
        """Nodes holding a sealed copy (primary first, then replicas)."""
        holders: List[NodeID] = []
        loc = self.task_manager.get_location(oid)
        if loc is not None and loc.kind == "shm" and loc.node_id is not None:
            holders.append(loc.node_id)
        with self._replica_lock:
            for nid in self._object_replicas.get(oid, ()):
                if nid not in holders:
                    holders.append(nid)
        return [nid for nid in holders if nid in self.nodes]

    def remove_node(self, node_id: NodeID) -> None:
        """Simulate node failure (chaos testing). In-flight work is
        retried or failed exactly as if each worker crashed
        (reference: node death notifications, node_manager.proto)."""
        node = self.nodes.pop(node_id, None)
        if node is None:
            return
        self.scheduler.remove_node(node_id)
        death_seq = self.gcs.mark_node_dead(node_id)
        if death_seq is not None:
            self._last_death_seq = death_seq
        from ray_tpu_torch.core.node import ACTOR as ACTOR_STATE
        with node._lock:
            casualties = [
                (w, list(w.running.values()),
                 w.actor_id if w.state == ACTOR_STATE else None)
                for w in node._workers.values()
            ]
            queued = [s for q in node._dispatch_queue.values() for s in q]
        node.stop()
        for worker, running, actor_id in casualties:
            if running or actor_id is not None:
                # chain each worker's exit event to the node death
                worker._exit_cause_seq = death_seq
                self.on_worker_crashed(node, worker, running, actor_id)
        # Tasks queued but never started are rescheduled without consuming
        # a retry (the lease was never granted).
        for spec in queued:
            if not self._consume_overcommit(spec.task_id):
                self.scheduler.release(node_id,
                                       self._spec_resources(spec),
                                       token=spec.task_id)
            self._enqueue(spec)
        self._handle_pg_node_death(node_id, death_seq)

    # --- streaming generators -------------------------------------------
    # reference: _raylet.pyx:299 ObjectRefGenerator owner-side protocol.
    def _stream(self, task_id: TaskID) -> StreamState:
        with self._streams_lock:
            state = self._streams.get(task_id)
            if state is None:
                state = self._streams[task_id] = StreamState()
            return state

    def on_stream_item(self, node, msg: dict) -> None:
        """A worker yielded one item of a streaming task."""
        oid = ObjectID(msg["object_id"])
        self._pin_contained(oid, msg.get("contained", ()))
        if msg["item_kind"] == "inline":
            self.memory_store.put(oid, ("packed", bytes(msg["data"])))
            self.task_manager.set_location_and_ready(
                oid, ObjectLocation("memory"))
        else:
            self.task_manager.set_location_and_ready(
                oid, ObjectLocation("shm", node.node_id))
        state = self._stream(TaskID(msg["task_id"]))
        with state.cond:
            abandoned = state.abandoned
            state.items.append(oid)
            fired = [w for w in state.waiters if w[0] < len(state.items)]
            state.waiters = [w for w in state.waiters
                             if w[0] >= len(state.items)]
            state.cond.notify_all()
        if abandoned:
            # nobody will consume this item; reclaim after grace
            self.reference_counter.delete_if_unreferenced(
                oid, defer=(self._ref_grace_s, self._schedule_expiry))
            return
        for index, fire in fired:
            fire("item", state.items[index].binary())

    def _finish_stream(self, task_id: TaskID,
                       error: Optional[Exception]) -> None:
        with self._streams_lock:
            state = self._streams.get(task_id)
        if state is None:
            return
        with state.cond:
            state.done = True
            state.error = error
            waiters = state.waiters
            state.waiters = []
            abandoned = state.abandoned
            state.cond.notify_all()
        if abandoned:
            with self._streams_lock:
                self._streams.pop(task_id, None)
        for index, fire in waiters:
            if index < len(state.items):
                fire("item", state.items[index].binary())
            elif error is not None:
                fire("error", serialization.dumps(error))
            else:
                fire("done", None)

    def stream_next(self, task_id: TaskID, index: int,
                    timeout: Optional[float]):
        """Blocking owner-side wait for stream item ``index``.
        Returns ("item", ObjectID) | ("done", None) | ("error", exc)."""
        state = self._stream(task_id)
        deadline = None if timeout is None else time.monotonic() + timeout
        with state.cond:
            while True:
                if index < len(state.items):
                    return "item", state.items[index]
                if state.done:
                    if state.error is not None:
                        return "error", state.error
                    return "done", None
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(
                        f"stream item {index} of task {task_id} timed out")
                state.cond.wait(remaining if remaining is not None else 0.5)

    def handle_stream_next(self, worker, msg: dict) -> None:
        """STREAM_NEXT from a worker: reply when the item exists
        (asynchronously if it doesn't yet)."""
        task_id = TaskID(msg["task_id"])
        index = msg["index"]
        req_id = msg.get("req_id")

        def fire(status: str, payload) -> None:
            out = {"kind": "STREAM_REPLY", "req_id": req_id,
                   "status": status}
            if status == "item":
                out["object_id"] = payload
            elif status == "error":
                out["error"] = payload
            worker.send(out)

        state = self._stream(task_id)
        with state.cond:
            if index < len(state.items):
                item = state.items[index].binary()
            elif state.done:
                if state.error is not None:
                    fire("error", serialization.dumps(state.error))
                else:
                    fire("done", None)
                # A worker consumer reached the end; its (handed-off)
                # generator never calls release_stream, so reclaim the
                # state here after a grace window.
                self._schedule_expiry(
                    self._ref_grace_s,
                    lambda: self._pop_finished_stream(task_id))
                return
            else:
                state.waiters.append((index, fire))
                return
        fire("item", item)

    def _pop_finished_stream(self, task_id: TaskID) -> None:
        with self._streams_lock:
            state = self._streams.get(task_id)
            if state is not None and state.done:
                self._streams.pop(task_id, None)

    def release_stream(self, task_id: TaskID, from_index: int) -> None:
        """The consumer dropped its generator: reclaim unconsumed items
        and the StreamState (immediately if the stream finished, else at
        stream completion via the abandoned flag)."""
        with self._streams_lock:
            state = self._streams.get(task_id)
        if state is None:
            return
        with state.cond:
            tail = state.items[from_index:]
            finished = state.done
            state.abandoned = True
        for oid in tail:
            self.reference_counter.delete_if_unreferenced(
                oid, defer=(self._ref_grace_s, self._schedule_expiry))
        if finished:
            with self._streams_lock:
                self._streams.pop(task_id, None)

    # --- lineage reconstruction -----------------------------------------
    def _record_lineage(self, spec: TaskSpec) -> None:
        if (spec.actor_id is not None or spec.is_actor_creation
                or spec.num_returns == -1):
            return
        cfg = get_config()
        if cfg.lineage_max_entries <= 0:
            return
        with self._lineage_lock:
            self._lineage[spec.task_id] = spec
            self._lineage.move_to_end(spec.task_id)
            for oid in spec.return_ids():
                self._lineage_by_object[oid] = spec.task_id
            while len(self._lineage) > cfg.lineage_max_entries:
                old_id, old_spec = self._lineage.popitem(last=False)
                for oid in old_spec.return_ids():
                    if self._lineage_by_object.get(oid) == old_id:
                        del self._lineage_by_object[oid]

    def _lineage_knows(self, oid: ObjectID) -> bool:
        with self._lineage_lock:
            task_id = self._lineage_by_object.get(oid)
            return task_id is not None and task_id in self._lineage

    def _reconstruct_after_infra_failure(self, oid: ObjectID,
                                         err: Exception) -> bool:
        """An object failed due to infrastructure loss (worker/node
        death, not user code): if lineage knows the producer, clear the
        error and re-execute — a reconstruction racing a dying node must
        not poison the object permanently."""
        if not isinstance(err, (WorkerCrashedError, ObjectLostError)):
            return False
        if not self._lineage_knows(oid):
            return False
        self.task_manager.mark_object_unready(oid)
        return self.try_reconstruct(oid)

    def _object_available(self, oid: ObjectID) -> bool:
        if self.memory_store.contains(oid):
            return True
        if self.object_holders(oid):
            return True
        loc = self.task_manager.get_location(oid)
        return loc is not None and loc.kind == "spilled"

    def try_reconstruct(self, oid: ObjectID) -> bool:
        """Re-execute the lost object's producing task (and transitively
        any lost dependencies). Returns True if reconstruction is in
        flight — the caller should wait on readiness again (reference:
        ObjectRecoveryManager::RecoverObject)."""
        with self._lineage_lock:
            if oid in self._reconstructing:
                return True
            task_id = self._lineage_by_object.get(oid)
            root = self._lineage.get(task_id) if task_id else None
            if root is None:
                return False
            # Claim under the same lock as the membership check so a
            # concurrent getter can't resubmit the same producer twice.
            self._reconstructing.add(oid)
        start_seq = self.gcs.add_cluster_event(
            "RECONSTRUCT_START", "WARNING",
            message=f"object {oid.hex()[:12]} lost; re-executing lineage",
            caused_by=self._last_death_seq, data={"oid": oid.hex()})
        if start_seq is not None:
            with self._event_chain_lock:
                self._reconstruct_events[oid] = (start_seq, time.time())
        # Collect the transitive set of lost producers.
        to_resubmit: List[TaskSpec] = []
        stack = [root]
        seen = {root.task_id}
        while stack:
            spec = stack.pop()
            to_resubmit.append(spec)
            for dep in spec.dependencies():
                if self._object_available(dep):
                    continue
                with self._lineage_lock:
                    dep_task = self._lineage_by_object.get(dep)
                    dep_spec = (self._lineage.get(dep_task)
                                if dep_task else None)
                if dep_spec is None:
                    self._reconstruction_done(oid)  # drop the claim
                    return False  # an input is unreconstructible
                if dep_spec.task_id not in seen:
                    seen.add(dep_spec.task_id)
                    stack.append(dep_spec)
        # Mark every output unready first so dep-waiting across the
        # resubmitted set blocks correctly, then resubmit.
        with self._lineage_lock:
            for spec in to_resubmit:
                for out in spec.return_ids():
                    self._reconstructing.add(out)
        for spec in to_resubmit:
            for out in spec.return_ids():
                self.task_manager.mark_object_unready(out)
        for spec in to_resubmit:
            self.task_manager.add_pending(spec)
            self._record_event(spec, "RECONSTRUCTING")
            self._resubmit(spec)
        return True

    def _reconstruction_done(self, oid: ObjectID) -> None:
        with self._lineage_lock:
            self._reconstructing.discard(oid)
        with self._event_chain_lock:
            start = self._reconstruct_events.pop(oid, None)
        if start is None:
            return  # not a tracked span (transitive output / no events)
        start_seq, t0 = start
        reconstruct_s = max(0.0, time.time() - t0)
        self.gcs.add_cluster_event(
            "RECONSTRUCT_DONE",
            message=f"object {oid.hex()[:12]} reconstruction finished",
            caused_by=start_seq,
            data={"reconstruct_s": round(reconstruct_s, 6),
                  "oid": oid.hex()})
        events_mod.RECONSTRUCTIONS.inc_local()
        events_mod.RECOVERY_SECONDS.observe_local(
            reconstruct_s, tags={"phase": "reconstruct"})

    # --- submission ----------------------------------------------------
    def submit_spec(self, spec: TaskSpec) -> None:
        if spec.is_actor_creation and spec.actor_id not in self.actors:
            # Actor created from inside a worker: register here (the head
            # owns actor lifecycle, reference: gcs_actor_manager.h:93).
            self.create_actor(spec)
            return
        self.task_manager.add_pending(spec)
        if spec.actor_id is not None and not spec.is_actor_creation:
            self._record_event(spec, "PENDING")
            self._route_actor_task(spec)
            return
        deps = [d for d in spec.dependencies()
                if not self.task_manager.is_ready(d)]
        if not deps:
            # Direct dispatch on the submitting thread when capacity is
            # free (reference: owner-to-worker direct push with cached
            # leases, normal_task_submitter.cc:499 — the scheduler
            # thread only handles contention/backlog). Two thread hops
            # fewer per task on the hot path. The PENDING event is
            # elided on this path (SCHEDULED subsumes it — reference
            # samples task events too, task_event_buffer.h:297).
            if self._try_fast_dispatch(spec):
                return
            self._record_event(spec, "PENDING")
            self._enqueue(spec)
            return
        self._record_event(spec, "PENDING")
        remaining = [len(deps)]
        lock = threading.Lock()

        def on_dep_ready():
            with lock:
                remaining[0] -= 1
                if remaining[0] != 0:
                    return
            self._enqueue(spec)

        for dep in deps:
            self.task_manager.on_ready(dep, on_dep_ready)

    def _try_fast_dispatch(self, spec: TaskSpec) -> bool:
        if self._schedulable or self._backlog_view:
            return False  # don't jump ahead of parked work
        strategy = spec.strategy
        cache_key = None
        node_id = None
        if strategy.kind == "DEFAULT" and not strategy.labels:
            cache_key = tuple(sorted(spec.resources.items()))
            cached = self._dispatch_cache.get(cache_key)
            if cached is not None and self.scheduler.try_acquire(
                    cached, spec.resources, token=spec.task_id):
                node_id = cached
        if node_id is None:
            try:
                node_id = self.scheduler.pick_node(
                    spec, preferred=self.head_node_id)
            except ValueError:
                return False  # infeasible: let the slow path park it
            if node_id is None or not self.scheduler.try_acquire(
                    node_id, self._spec_resources(spec),
                    token=spec.task_id):
                if cache_key is not None:
                    # scheduler-thread-only state; see __init__ comment
                    self._dispatch_cache.pop(  # graftlint: disable=GL001
                        cache_key, None)
                return False
            if cache_key is not None:
                # scheduler-thread-only state; see __init__ comment
                self._dispatch_cache[cache_key] = node_id  # graftlint: disable=GL001
        node = self.nodes.get(node_id)
        if node is None:
            self.scheduler.release(node_id, self._spec_resources(spec),
                                   token=spec.task_id)
            return False
        if spec.is_actor_creation:
            info = self.actors.get(spec.actor_id)
            if info is not None:
                info.resources_node = node_id
        if _task_phase._TRACKED:
            _task_phase.mark(spec.task_id, "scheduler-queue")
        self.task_manager.mark_dispatched(spec.task_id, node_id)
        self._record_event(spec, "SCHEDULED", node_id=node_id)
        self._emit_lease_grant(spec, node_id)
        node.dispatch(spec)
        return True

    def _enqueue(self, spec: TaskSpec) -> None:
        with self._sched_cond:
            was_empty = not self._schedulable
            self._schedulable.append(spec)
            if was_empty:
                # The scheduler drains the whole list per pass; notifying
                # on every append would wake it once per task.
                self._sched_cond.notify_all()

    def _scheduling_loop(self) -> None:
        backlog: deque = deque()
        self._backlog_blocked = False
        while not self._stopped.is_set():
            # Task completions free resources without a node-join event:
            # give queued gangs a shot each pass (no-op when none wait).
            self.retry_pending_placement_groups()
            with self._sched_cond:
                while not self._schedulable and not backlog and not self._stopped.is_set():
                    self._sched_cond.wait(timeout=0.2)
                    if self._pending_pgs:
                        break  # idle pass: retry pending gangs above
                if self._stopped.is_set():
                    return
                work = list(self._schedulable)
                self._schedulable.clear()
            backlog.extend(work)
            made_progress = False
            # Per-pass memo: once a resource signature fails to place,
            # every identical request this pass fails too (availability
            # only shrinks within a pass) — without this, a deep
            # backlog pays O(backlog) pick_node scans per completion
            # and throughput collapses with queue depth (reference:
            # owner-side lease caching per resource shape, SURVEY §3.2).
            blocked_sigs: set = set()
            for _ in range(len(backlog)):
                if not backlog:
                    break  # burst grants drained ahead of this count
                spec = backlog.popleft()
                task = self.task_manager.get_pending(spec.task_id)
                if task is None:
                    continue  # cancelled/failed meanwhile
                strategy = spec.strategy
                sig = (strategy.kind,
                       strategy.node_id,
                       strategy.soft,  # soft affinity falls through to
                       # the general policy — distinct placement from hard
                       tuple(sorted(strategy.labels.items())),
                       strategy.placement_group_id,
                       strategy.bundle_index,
                       tuple(sorted(spec.resources.items())))
                if sig in blocked_sigs:
                    backlog.append(spec)
                    continue
                try:
                    node_id = self.scheduler.pick_node(
                        spec, preferred=self.head_node_id)
                except ValueError:
                    with self._sched_cond:  # add_node drains this list
                        self._infeasible.append(spec)
                    continue
                if node_id is None or not self.scheduler.try_acquire(
                        node_id, self._spec_resources(spec),
                        token=spec.task_id):
                    blocked_sigs.add(sig)
                    backlog.append(spec)
                    continue
                if spec.is_actor_creation:
                    info = self.actors.get(spec.actor_id)
                    if info is not None:
                        info.resources_node = node_id
                node = self.nodes.get(node_id)
                if node is None:
                    # Node died between pick and dispatch (remote-node
                    # heartbeat monitor removes nodes concurrently).
                    backlog.append(spec)
                    continue
                if _task_phase._TRACKED:
                    _task_phase.mark(spec.task_id, "scheduler-queue")
                self.task_manager.mark_dispatched(spec.task_id, node_id)
                self._record_event(spec, "SCHEDULED", node_id=node_id)
                self._emit_lease_grant(spec, node_id)
                node.dispatch(spec)
                made_progress = True
                # Burst grant (reference: owner-side lease reuse,
                # SURVEY §3.2): ride this acquisition with follow-up
                # same-shape plain-CPU specs from the queue head —
                # the node's worker cap enforces REAL concurrency, so
                # per-task scheduler round trips stop being the
                # throughput ceiling for homogeneous task floods.
                if (strategy.kind == "DEFAULT"
                        and not spec.is_actor_creation
                        and spec.resources == {"CPU": 1.0}):
                    # Head-of-line guard: a deep burst onto a saturated
                    # node only hurts when ANOTHER node has free CPU
                    # (long tasks would pin here while it idles). With
                    # nowhere else to run, burst deep — queued is
                    # queued, and node-side pipelining is the win.
                    budget = get_config().scheduler_burst_grant
                    free_here = self.scheduler.available(node_id).get(
                        "CPU", 0.0)
                    if free_here < 1.0:
                        for other_id, res in (
                                self.scheduler.snapshot().items()):
                            if (other_id != node_id
                                    and res.available.get("CPU", 0.0)
                                    >= 1.0):
                                budget = min(budget, 4)
                                break
                    while budget > 0 and backlog:
                        follower = backlog[0]
                        fs = follower.strategy
                        if (follower.is_actor_creation
                                or fs.kind != "DEFAULT"
                                or follower.resources != {"CPU": 1.0}):
                            break
                        backlog.popleft()
                        if self.task_manager.get_pending(
                                follower.task_id) is None:
                            continue  # cancelled while queued
                        if self.nodes.get(node_id) is not node:
                            # node removed mid-burst: a dispatch onto
                            # the stale object would strand the spec
                            # (the death harvest already ran)
                            backlog.appendleft(follower)
                            break
                        self._overcommitted.add(  # graftlint: disable=GL001
                            follower.task_id)  # GIL-atomic; see _consume_overcommit
                        if _task_phase._TRACKED:
                            _task_phase.mark(follower.task_id,
                                             "scheduler-queue")
                        self.task_manager.mark_dispatched(
                            follower.task_id, node_id)
                        self._record_event(follower, "SCHEDULED",
                                           node_id=node_id)
                        self._emit_lease_grant(follower, node_id)
                        node.dispatch(follower)
                        budget -= 1
            self._backlog_view = list(backlog)
            from ray_tpu_torch.core.scheduler import (INFEASIBLE_TASKS,
                                                QUEUE_DEPTH)
            QUEUE_DEPTH.set(float(len(backlog)))
            INFEASIBLE_TASKS.set(float(len(self._infeasible)))
            if backlog and not made_progress:
                # All blocked on capacity; wait for a release/completion
                # (completions only notify while this flag is up, so the
                # hot path pays no wakeup per task when nothing waits).
                with self._sched_cond:
                    self._backlog_blocked = True
                    self._sched_cond.wait(timeout=0.05)
                    self._backlog_blocked = False

    def resource_demand(self) -> List[Dict[str, float]]:
        """Unmet resource requests: backlog (feasible but waiting on
        capacity) + infeasible tasks. The autoscaler's input (reference:
        gcs_autoscaler_state_manager.h:41 demand export)."""
        with self._sched_cond:
            infeasible = list(self._infeasible)
        specs = self._backlog_view + infeasible
        return [dict(self._spec_resources(s)) for s in specs
                if s.resources]

    # --- pending placement groups --------------------------------------
    # All PENDING<->CREATED<->REMOVED transitions happen under
    # self._pg_lock (lock order: _pg_lock before scheduler lock), so a
    # concurrent retry can never reserve a record another thread is
    # removing (reference: GcsPlacementGroupManager serializes these on
    # the GCS main loop).

    def queue_pending_placement_group(self, record) -> None:
        """Park an unplaceable PG until capacity appears (reference:
        gcs_placement_group_scheduler.h:281 pending queue)."""
        with self._pg_lock:
            record.state = "PENDING"
            self._pending_pgs.append(record)

    def retry_pending_placement_groups(self) -> None:
        """Attempt reservation of every queued PG; called when capacity
        changes (node joins, PG removed, scheduler pass with pending
        gangs). Success flips the GCS record to CREATED, which unblocks
        PlacementGroup.ready() waiters."""
        from ray_tpu_torch.exceptions import PlacementGroupUnschedulableError
        if not self._pending_pgs:  # unlocked peek: usually empty
            return
        with self._pg_lock:
            remaining = []
            progressed = False
            for record in self._pending_pgs:
                if record.state != "PENDING":
                    continue
                try:
                    self.scheduler.reserve_placement_group(record)
                    progressed = True
                except PlacementGroupUnschedulableError:
                    remaining.append(record)
            self._pending_pgs = remaining
        if progressed:
            # Fresh pg-scoped resources may unpark gang tasks that went
            # infeasible while the group was re-pending (node death
            # stripped its custom resources from every ledger).
            with self._sched_cond:
                self._schedulable.extend(self._infeasible)
                self._infeasible.clear()
                self._sched_cond.notify_all()

    def remove_placement_group_record(self, record) -> None:
        """Release or cancel a PG in any state (idempotent)."""
        released = False
        with self._pg_lock:
            if record.state == "CREATED":
                self.scheduler.return_placement_group(record)
                released = True
            elif record.state == "PENDING":
                if record in self._pending_pgs:
                    self._pending_pgs.remove(record)
                record.state = "REMOVED"
        if released:
            # Freed capacity may satisfy a queued gang.
            self.retry_pending_placement_groups()

    def _handle_pg_node_death(self, node_id: NodeID,
                              death_seq: Optional[int] = None) -> None:
        """A gang lost a member node: release its reservation exactly
        once and re-queue it for placement (reference:
        GcsPlacementGroupManager::OnNodeDead rescheduling). _pg_lock
        orders it against
        user removes; the CREATED check plus return_placement_group's
        REMOVED guard make a racing remove release the bundles exactly
        once. Survivor bundles are credited back here — the dead node's
        ledger is already gone (scheduler.remove_node), so its bundle
        release is a no-op rather than a double credit."""
        hit = []
        with self._pg_lock:
            for record in self.gcs.list_placement_groups():
                if record.state != "CREATED":
                    continue
                if not any(b.node_id == node_id for b in record.bundles):
                    continue
                self.scheduler.return_placement_group(record)
                record.state = "PENDING"
                if record not in self._pending_pgs:
                    self._pending_pgs.append(record)
                hit.append(record)
        for record in hit:
            self.gcs.add_cluster_event(
                "PG_RESCHEDULED", "WARNING", node_id=node_id,
                caused_by=death_seq,
                message=f"placement group {record.pg_id.hex()[:8]} lost "
                        f"a member node; gang re-queued for placement",
                data={"pg_id": record.pg_id.hex(),
                      "strategy": record.strategy})
        if hit:
            self.retry_pending_placement_groups()

    def pending_pg_demand(self) -> List:
        """[(strategy, [bundle resource dicts])] for queued PGs — the
        autoscaler's gang-demand input (reference:
        autoscaler.proto GangResourceRequest)."""
        with self._pg_lock:
            return [(r.strategy, [dict(b.resources) for b in r.bundles])
                    for r in self._pending_pgs]

    def _spec_resources(self, spec: TaskSpec) -> Dict[str, float]:
        from ray_tpu_torch.core.scheduler import _pg_resources
        if (spec.strategy.kind == "PLACEMENT_GROUP"
                and spec.strategy.placement_group_id is not None):
            return _pg_resources(spec.resources,
                                 spec.strategy.placement_group_id,
                                 spec.strategy.bundle_index)
        return spec.resources

    # --- actor routing -------------------------------------------------
    def create_actor(self, spec: TaskSpec, name: Optional[str] = None) -> None:
        record = ActorRecord(
            actor_id=spec.actor_id, name=name or spec.actor_name,
            namespace=self.namespace,
            state="PENDING", spec=spec, max_restarts=spec.max_restarts)
        try:
            self.gcs.register_actor(record)
        except ValueError as e:
            if name is not None:
                raise  # driver call sites expect the synchronous raise
            # Duplicate name arriving via a client/worker SUBMIT (no
            # reply channel): fail the creation task typed — the
            # caller's handle then errors on use instead of the head
            # reader swallowing a traceback.
            self.task_manager.add_pending(spec)
            self._fail_task(spec, e)
            return
        self.actors[spec.actor_id] = ActorInfo(spec)
        self.submit_spec(spec)

    def _fail_task(self, spec: TaskSpec, err: Exception) -> None:
        self.task_manager.fail(spec.task_id, err)
        for oid in spec.return_ids():
            # a failed reconstruction must drop its claims or later
            # try_reconstruct calls would no-op forever
            self._reconstruction_done(oid)
        if spec.num_returns == -1:
            self._finish_stream(spec.task_id, err)

    def _route_actor_task(self, spec: TaskSpec) -> None:
        info = self.actors.get(spec.actor_id)
        record = self.gcs.get_actor(spec.actor_id)
        if info is None or record is None:
            self._fail_task(spec,
                            ActorDiedError(spec.actor_id, "unknown actor"))
            return
        with info.lock:
            if record.state == "DEAD":
                from ray_tpu_torch.devtools import recovery
                self._fail_task(
                    spec,
                    ActorDiedError(
                        spec.actor_id,
                        f"actor is dead: {record.death_cause}"
                        + recovery.incident_tail_text(
                            record.death_event_seq)))
                return
            if not info.ready_for_dispatch or info.worker_id is None:
                info.buffered.append(spec)
                return
            node = self.nodes.get(info.node_id)
        ok = node is not None and node.dispatch_to_actor(info.worker_id, spec)
        if not ok:
            with info.lock:
                info.buffered.append(spec)

    def _flush_actor_buffer(self, actor_id: ActorID) -> None:
        """Drain buffered tasks in order, then open direct dispatch.
        New submissions keep landing in the buffer until the flush
        completes, preserving submission order."""
        info = self.actors.get(actor_id)
        if info is None:
            return
        while True:
            with info.lock:
                if not info.buffered:
                    info.ready_for_dispatch = True
                    return
                spec = info.buffered.popleft()
                node = self.nodes.get(info.node_id)
                worker_id = info.worker_id
            ok = (node is not None and worker_id is not None
                  and node.dispatch_to_actor(worker_id, spec))
            if not ok:
                with info.lock:
                    info.buffered.appendleft(spec)
                return  # actor died mid-flush; death path re-handles

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        info = self.actors.get(actor_id)
        record = self.gcs.get_actor(actor_id)
        if info is None or record is None:
            return
        if no_restart:
            self.gcs.update_actor_state(actor_id, "DEAD",
                                        death_cause="killed via kill()")
        node = self.nodes.get(info.node_id)
        if node is not None and info.worker_id is not None:
            node.kill_worker(info.worker_id)

    # --- completion callbacks (called from node reader threads) ---------
    def on_task_done(self, node: Node, worker, spec: TaskSpec, msg: dict) -> None:
        pending = self.task_manager.get_pending(spec.task_id)
        submitted_at = pending.submitted_at if pending is not None else None
        error_blob = msg.get("error")
        if error_blob is not None:
            err = serialization.loads(error_blob)
            if spec.retry_exceptions and spec.num_returns != -1:
                retry = self.task_manager.consume_retry(spec.task_id)
                if retry is not None:
                    self._release_task_resources(spec, node.node_id)
                    self._resubmit(retry)
                    return
            if spec.is_actor_creation:
                self.gcs.update_actor_state(spec.actor_id, "DEAD",
                                            death_cause=str(err))
                info = self.actors.get(spec.actor_id)
                if info is not None:
                    self._release_actor_resources(info)
                self._fail_actor_buffer(spec.actor_id, err)
            self._record_execution_events(spec, node, worker, msg,
                                          "FAILED",
                                          error=msg.get("error_str"),
                                          submitted_at=submitted_at)
            self._fail_task(spec, err)
            self._release_task_resources(spec, node.node_id)
            if _task_phase._TRACKED:
                _task_phase.finish(spec.task_id, msg.get("t_start"),
                                   msg.get("t_end"))
            self._signal_scheduler()
            return
        for result in msg.get("results", ()):
            oid_bytes, kind, data = result[:3]
            contained = result[3] if len(result) > 3 else ()
            oid = ObjectID(oid_bytes)
            if self._reconstructing:  # unlocked peek: usually empty
                self._reconstruction_done(oid)
            self._pin_contained(oid, contained)
            if kind == "inline":
                TRANSFER_BYTES.inc(float(len(data)),
                                   tags={"transport": "inline"})
                self.memory_store.put(oid, ("packed", bytes(data)))
                self.task_manager.set_location_and_ready(
                    oid, ObjectLocation("memory"))
            else:
                self.task_manager.set_location_and_ready(
                    oid, ObjectLocation("shm", node.node_id))
            # fire-and-forget caller may have dropped the result ref
            # already; reclaim after the borrow grace window (checked
            # under the counter lock — races with REF_ADD are safe).
            # Reclaiming the container also unpins its contained refs.
            self.reference_counter.delete_if_unreferenced(
                oid, defer=(self._ref_grace_s, self._schedule_expiry))
        if spec.is_actor_creation:
            info = self.actors.get(spec.actor_id)
            record = self.gcs.get_actor(spec.actor_id)
            if record is not None and record.state == "DEAD":
                # kill() raced the construction: honor the kill instead of
                # reviving (reference: GCS actor manager kill-on-pending).
                node.kill_worker(worker.worker_id)
                if info is not None:
                    self._release_actor_resources(info)
                    self._fail_actor_buffer(
                        spec.actor_id,
                        ActorDiedError(spec.actor_id, "actor killed"))
            elif info is not None:
                with info.lock:
                    info.node_id = node.node_id
                    info.worker_id = worker.worker_id
                self.gcs.update_actor_state(spec.actor_id, "ALIVE",
                                            node_id=node.node_id)
                self._flush_actor_buffer(spec.actor_id)
            self.task_manager.complete(spec.task_id)
            # Creation resources stay held for the actor's lifetime.
        else:
            self.task_manager.complete(spec.task_id)
            if spec.num_returns == -1:
                self._finish_stream(spec.task_id, None)
            self._record_lineage(spec)
            self._release_task_resources(spec, node.node_id)
        self._record_execution_events(spec, node, worker, msg, "FINISHED",
                                      submitted_at=submitted_at)
        if _task_phase._TRACKED:
            _task_phase.finish(spec.task_id, msg.get("t_start"),
                               msg.get("t_end"))
        self._signal_scheduler()

    def _consume_overcommit(self, task_id: TaskID) -> bool:
        """True if this spec was burst-granted (holds NO scheduler
        resources); consumes the marker so each release path sees it
        exactly once. set.remove is atomic under the GIL."""
        try:
            # GIL-atomic (per docstring); a lock here would nest inside
            # every release path's existing locks for no added safety
            self._overcommitted.remove(task_id)  # graftlint: disable=GL001
            return True
        except KeyError:
            return False

    def _release_task_resources(self, spec: TaskSpec, node_id: NodeID) -> None:
        if spec.actor_id is not None:
            # Method tasks hold no scheduler resources; creation resources
            # are owned by the actor lifecycle (_release_actor_resources).
            return
        if self._consume_overcommit(spec.task_id):
            return
        self.scheduler.release(node_id, self._spec_resources(spec),
                               token=spec.task_id)

    def _signal_scheduler(self) -> None:
        # cheap unlocked read: only completions that may unblock a
        # capacity-starved backlog pay the lock+notify+context switch
        if not getattr(self, "_backlog_blocked", True):
            return
        with self._sched_cond:
            self._sched_cond.notify_all()

    def _resubmit(self, spec: TaskSpec) -> None:
        if spec.actor_id is not None and not spec.is_actor_creation:
            self._route_actor_task(spec)
        else:
            deps = [d for d in spec.dependencies()
                    if not self.task_manager.is_ready(d)]
            if deps:
                remaining = [len(deps)]
                lock = threading.Lock()

                def on_dep_ready():
                    with lock:
                        remaining[0] -= 1
                        if remaining[0]:
                            return
                    self._enqueue(spec)

                for dep in deps:
                    self.task_manager.on_ready(dep, on_dep_ready)
            else:
                self._enqueue(spec)

    def on_worker_crashed(self, node: Node, worker, running: List[TaskSpec],
                          actor_id: Optional[ActorID]) -> None:
        cfg = get_config()
        self._drop_worker_subscriptions(node.node_id,
                                        worker.worker_id.binary())
        # node.py's death observer emits WORKER_EXIT and stashes the seq
        # on the handle; paths that bypass it (remove_node kills after
        # stop()) emit here so the incident always has a root event.
        exit_seq = getattr(worker, "_exit_event_seq", None)
        if exit_seq is None:
            cause = getattr(worker, "_exit_cause_seq", None)
            if cause is None:
                # Remote/virtual worker kills: the stub is minted per
                # message, so chaos stashes its CHAOS_INJECTED seq on
                # the head-side node keyed by worker id (one-shot).
                causes = getattr(node, "_chaos_worker_causes", None)
                if causes:
                    cause = causes.pop(worker.worker_id, None)
            exit_seq = self.gcs.add_cluster_event(
                "WORKER_EXIT", "ERROR", node_id=node.node_id,
                worker_id=worker.worker_id,
                caused_by=cause,
                message="worker killed with its node")
        if exit_seq is not None and (running or actor_id is not None):
            # idle reclaims carry a seq too but seed no recovery chain
            self._last_death_seq = exit_seq
        for spec in running:
            if (not spec.is_actor_creation and spec.actor_id is None
                    and not self._consume_overcommit(spec.task_id)):
                self.scheduler.release(node.node_id,
                                       self._spec_resources(spec),
                                       token=spec.task_id)
            # Streaming tasks never retry: already-consumed yields would
            # replay (reference keeps generator retries behind a flag for
            # the same reason).
            retry = (None if spec.num_returns == -1
                     else self.task_manager.consume_retry(spec.task_id))
            if retry is not None and not spec.is_actor_creation:
                self._emit_task_retry(retry, exit_seq)
                self._resubmit(retry)
            elif spec.is_actor_creation:
                pass  # handled by actor restart below
            else:
                msg = (f"worker {worker.worker_id.hex()[:8]} died while "
                       f"running {spec.name or spec.function_id}")
                # post-mortem: the collector still holds the dead
                # process's last-flushed journal
                from ray_tpu_torch.util import flight_recorder
                msg += flight_recorder.store_tail_text(
                    f"worker:{worker.worker_id.hex()[:12]}")
                err: Exception = WorkerCrashedError(msg)
                if spec.actor_id is not None:
                    err = ActorUnavailableError(spec.actor_id, str(err))
                self._record_event(spec, "FAILED", node_id=node.node_id,
                                  error=str(err))
                self._fail_task(spec, err)
        if actor_id is not None or any(s.is_actor_creation for s in running):
            aid = actor_id or next(
                s.actor_id for s in running if s.is_actor_creation)
            self._handle_actor_death(aid, node, cause_seq=exit_seq)
        self._signal_scheduler()

    def _release_actor_resources(self, info: ActorInfo) -> None:
        """Release the creation-task resources exactly once per incarnation
        (covers kill(), crash during __init__, and death while ALIVE)."""
        node_id = info.resources_node
        if node_id is None:
            return
        info.resources_node = None
        self.scheduler.release(node_id,
                               self._spec_resources(info.creation_spec),
                               token=info.creation_spec.task_id)

    def _handle_actor_death(self, actor_id: ActorID, node: Node,
                            cause_seq: Optional[int] = None) -> None:
        record = self.gcs.get_actor(actor_id)
        info = self.actors.get(actor_id)
        if record is None or info is None:
            return
        with info.lock:  # captured before the restart path clears it
            dead_worker = info.worker_id
        self._release_actor_resources(info)
        if record.state == "DEAD":
            self._fail_actor_buffer(actor_id,
                                    ActorDiedError(actor_id, "actor killed"))
            return
        can_restart = (record.max_restarts == -1
                       or record.num_restarts < record.max_restarts)
        if can_restart:
            record.num_restarts += 1
            with info.lock:
                info.node_id = None
                info.worker_id = None
                info.ready_for_dispatch = False
            new_spec = TaskSpec(
                task_id=TaskID.from_random(),
                function_id=info.creation_spec.function_id,
                args=info.creation_spec.args,
                kwargs=info.creation_spec.kwargs,
                num_returns=1,
                resources=info.creation_spec.resources,
                strategy=info.creation_spec.strategy,
                max_retries=0,
                name=info.creation_spec.name,
                actor_id=actor_id,
                is_actor_creation=True,
                max_restarts=info.creation_spec.max_restarts,
                max_concurrency=info.creation_spec.max_concurrency,
                # keep the restarted actor on the original creation
                # trace (GL007): restarts are hops in the same request
                trace_id=info.creation_spec.trace_id,
                parent_span_id=info.creation_spec.parent_span_id,
            )
            info.creation_spec = new_spec
            self.gcs.update_actor_state(actor_id, "RESTARTING",
                                        cause_seq=cause_seq)
            self.task_manager.add_pending(new_spec)
            self._enqueue(new_spec)
        else:
            death_seq = self.gcs.update_actor_state(
                actor_id, "DEAD", death_cause="worker died",
                cause_seq=cause_seq)
            msg = "actor worker died"
            if dead_worker is not None:
                # post-mortem: the collector still holds the dead
                # process's last-flushed journal — name what it was
                # doing in its final moments
                from ray_tpu_torch.util import flight_recorder
                msg += flight_recorder.store_tail_text(
                    f"worker:{dead_worker.hex()[:12]}")
            # ... and the incident timeline the death belongs to, in
            # the same attach-the-tail mold
            from ray_tpu_torch.devtools import recovery
            msg += recovery.incident_tail_text(death_seq)
            self._fail_actor_buffer(
                actor_id, ActorDiedError(actor_id, msg))

    def _fail_actor_buffer(self, actor_id: ActorID, err: Exception) -> None:
        info = self.actors.get(actor_id)
        if info is None:
            return
        with info.lock:
            buffered = list(info.buffered)
            info.buffered.clear()
        for spec in buffered:
            self._fail_task(spec, err)

    # --- object plane ---------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        with serialization.collect_contained_refs() as contained:
            data, buffers = serialization.serialize(value)
        ref = self.put_serialized(data, buffers)
        self._pin_contained(ref.id, contained)
        return ref

    def put_serialized(self, data: bytes, buffers) -> ObjectRef:
        """Store already-serialized parts (single serialize pass)."""
        oid = ObjectID.from_random()
        cfg = get_config()
        if not buffers and len(data) < cfg.max_inline_object_size:
            packed = serialization.pack_parts(data, buffers)
            self.memory_store.put(oid, ("packed", packed))
            location = ObjectLocation("memory")
        else:
            head = self.nodes[self.head_node_id]
            sizes = [b.nbytes for b in buffers]
            from ray_tpu_torch.exceptions import ObjectStoreFullError
            try:
                head.store.put_parts(oid, data, buffers, sizes)
            except ObjectStoreFullError:
                # spill referenced objects to disk, then retry
                self.spill_on_node(
                    head, serialization.packed_size(data, sizes))
                head.store.put_parts(oid, data, buffers, sizes)
            location = ObjectLocation("shm", self.head_node_id)
        self.task_manager.set_location_and_ready(oid, location)
        return ObjectRef(oid)

    def store_packed_object(self, oid: ObjectID, packed: bytes,
                            contained=()) -> None:
        """Store an already-packed payload under a given id (client-mode
        puts: the client ships packed bytes, the head owns the object).
        Small payloads go to the memory store; large ones into the head
        arena via a raw create/seal write."""
        cfg = get_config()
        if len(packed) < cfg.max_inline_object_size:
            self.memory_store.put(oid, ("packed", packed))
            location = ObjectLocation("memory")
        else:
            head = self.nodes[self.head_node_id]
            from ray_tpu_torch.exceptions import ObjectStoreFullError
            try:
                buf = head.store.create(oid, len(packed))
            except ObjectStoreFullError:
                self.spill_on_node(head, len(packed))
                buf = head.store.create(oid, len(packed))
            try:
                buf[:] = packed
            finally:
                del buf
            head.store.seal(oid)
            location = ObjectLocation("shm", self.head_node_id)
        if contained:
            self._pin_contained(oid, contained)
        self.task_manager.set_location_and_ready(oid, location)

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for ref in refs:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            out.append(self._get_one(ref.id, remaining))
        return out[0] if single else out

    def _get_one(self, oid: ObjectID, timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        for attempt in range(3):
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            if not self.task_manager.wait_ready(oid, remaining):
                raise GetTimeoutError(f"get() timed out waiting for {oid}")
            err = self.task_manager.get_error(oid)
            if err is not None:
                if (attempt < 2
                        and self._reconstruct_after_infra_failure(oid, err)):
                    continue
                raise err
            found, stored = self.memory_store.get(oid, timeout_s=0)
            if found:
                kind, payload = stored
                return (serialization.unpack(payload)
                        if kind == "packed" else payload)
            loc = self.task_manager.get_location(oid)
            if loc is not None and loc.kind == "spilled":
                value = self._read_spilled(oid, loc)
                if value is not _SPILL_MISS:
                    return value
            holders = self.object_holders(oid)
            # Prefer a copy in an in-process store (zero-copy read).
            for nid in holders:
                node = self.nodes.get(nid)
                if node is None:
                    continue
                found, value = node.store.get_value(oid, timeout_s=5.0)
                if found:
                    return value
            # Every copy is gone: lineage reconstruction re-executes the
            # producer, then we wait for readiness again.
            if not self.try_reconstruct(oid):
                break
        raise ObjectLostError(oid)

    def _read_spilled(self, oid: ObjectID, loc: ObjectLocation):
        """Read a spilled payload: every node is in-process, so its
        spill file is on this host."""
        if loc.path and os.path.exists(loc.path):
            with open(loc.path, "rb") as f:
                return serialization.unpack(f.read())
        return _SPILL_MISS

    def wait(self, refs: List[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True):
        if num_returns > len(refs):
            raise ValueError(
                f"num_returns ({num_returns}) exceeds the number of refs "
                f"({len(refs)})")
        event = threading.Event()
        for ref in refs:
            self.task_manager.on_ready(ref.id, event.set)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ready = [r for r in refs if self.task_manager.is_ready(r.id)]
            if len(ready) >= num_returns:
                break
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                break
            event.clear()
            event.wait(remaining if remaining is not None else 0.2)
        done = ready[:num_returns]
        done_set = {r.id for r in done}
        rest = [r for r in refs if r.id not in done_set]
        return done, rest

    def _pin_contained(self, container: ObjectID, contained) -> None:
        """Objects referenced inside a stored value stay alive as long as
        the container does (reference: reference_counter.h nested-ref
        tracking). `contained` is a list of ObjectID binaries."""
        if not contained:
            return
        oids = [b if isinstance(b, ObjectID) else ObjectID(b)
                for b in contained]
        led = refsan.LEDGER
        for oid in oids:
            if led is not None:
                led.record(refsan.KIND_PIN_CONTAINED, oid.hex(),
                           {"container": container.hex()})
            self.reference_counter.add_local_reference(oid)
        with self._contained_lock:
            self._contained_refs.setdefault(container, []).extend(oids)

    def _maybe_delete_object(self, oid: ObjectID) -> None:
        """Called when the local reference count drops to zero
        (reference: reference_counter.h — delete at refcount 0)."""
        stopped = getattr(self, "_stopped", None)
        if stopped is not None and stopped.is_set():
            return  # shutdown: shm arenas may already be unmapped
        if not self.task_manager.is_ready(oid):
            return  # producing task still running; keep bookkeeping
        led = refsan.LEDGER
        if led is not None:
            # Point of no return for this oid: any owner-side borrow
            # registration sequenced after this event is a grace
            # violation.
            led.record(refsan.KIND_DELETED, oid.hex())
        self.memory_store.delete(oid)
        loc = self.task_manager.get_location(oid)
        targets = set()
        if loc is not None and loc.node_id is not None:
            targets.add(loc.node_id)
        with self._replica_lock:
            targets.update(self._object_replicas.pop(oid, ()))
        for nid in targets:
            node = self.nodes.get(nid)
            if node is not None:
                node.store.delete(oid)
        if loc is not None and loc.kind == "spilled" and loc.path:
            try:
                os.unlink(loc.path)
            except OSError:
                pass  # remote file: the daemon's DELETE_OBJECT removes it
        self.task_manager.forget_object(oid)
        with self._contained_lock:
            nested = self._contained_refs.pop(oid, None)
        if nested:
            for inner in nested:  # may recurse through nested containers
                self.reference_counter.remove_local_reference(inner)

    def _expiry_loop(self) -> None:
        import heapq
        # bootstrap spin: _stopped is created later in __init__, so
        # there is no Event to wait on yet
        while getattr(self, "_stopped", None) is None:  # graftlint: disable=GL003
            time.sleep(0.05)  # started early in __init__
        while not self._stopped.is_set():
            with self._expiry_cv:
                while not self._expiry_items:
                    self._expiry_cv.wait(0.5)
                    if self._stopped.is_set():
                        return
                deadline, _, fn = self._expiry_items[0]
                now = time.monotonic()
                if deadline > now:
                    self._expiry_cv.wait(min(deadline - now, 0.5))
                    continue
                heapq.heappop(self._expiry_items)
            try:
                fn()
            except Exception:
                logger.exception("expiry callback failed")

    def _state_dump_loop(self) -> None:
        import json
        import tempfile
        pointer = os.path.join(tempfile.gettempdir(),
                               "ray_tpu_torch_last_session.json")
        # bootstrap spin: this thread starts early in __init__,
        # before _stopped exists
        while getattr(self, "_stopped", None) is None:  # graftlint: disable=GL003
            time.sleep(0.05)
        while not self._stopped.wait(2.0):
            try:
                from ray_tpu_torch.util import state as state_mod
                head = self.nodes.get(self.head_node_id)
                if head is None:
                    continue
                path = os.path.join(head.session_dir, "state.json")
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(state_mod.state_snapshot(), f)
                os.replace(tmp, path)
                pointer_tmp = f"{pointer}.{os.getpid()}.tmp"
                with open(pointer_tmp, "w") as f:
                    json.dump({"state_path": path,
                               "session_dir": head.session_dir,
                               "pid": os.getpid()}, f)
                os.replace(pointer_tmp, pointer)
            except Exception:  # graftlint: disable=GL004
                pass  # state dump is best-effort observability

    def _schedule_expiry(self, delay: float, fn) -> None:
        import heapq
        with self._expiry_cv:
            heapq.heappush(
                self._expiry_items,
                (time.monotonic() + delay, id(fn), fn))
            # No notify: the expiry thread polls at >=2 Hz and every
            # deadline is >=grace seconds out, so a wakeup per scheduled
            # item would only thrash the GIL on the task hot path.

    def deferred_remove_reference(self, oid: ObjectID) -> None:
        """Remove a worker-reported borrow; a zero count only fires the
        deleter after a grace window (and only if still zero), masking
        the gap between a worker dropping a returned ref and the caller
        registering its borrow. Containment pinning (task returns / puts
        that embed refs) covers the durable cases; the grace window only
        guards transient hand-offs."""
        self.reference_counter.remove_local_reference(
            oid, defer=(self._ref_grace_s, self._schedule_expiry))

    # --- object spilling --------------------------------------------------
    # reference: raylet LocalObjectManager spilling under memory pressure
    # (local_object_manager.h:43) + external_storage.py file layout.
    @staticmethod
    def _spill_dir_for(node) -> str:
        base = node.session_dir
        if not base:
            import tempfile
            base = tempfile.gettempdir()
        path = os.path.join(base, "spill")
        os.makedirs(path, exist_ok=True)
        return path

    def handle_spill_request(self, node, worker, msg: dict) -> None:
        """A worker's create() hit a full arena: free space by spilling
        referenced sealed objects to disk, then let it retry."""
        needed = int(msg.get("bytes", 0)) or 1
        freed = self.spill_on_node(node, needed)
        worker.send({"kind": "SPILL_REPLY", "req_id": msg.get("req_id"),
                     "freed": freed})

    def spill_on_node(self, node, needed: int) -> int:
        """Spill ready shm objects from an in-process node's arena to
        disk until `needed` bytes are freed. Returns bytes freed."""
        if not get_config().object_spill_enabled:
            return 0
        from ray_tpu_torch.core.object_store import spill_objects
        candidates = [
            oid for oid in self.task_manager.objects_on_node(node.node_id)
            if (loc := self.task_manager.get_location(oid)) is not None
            and loc.kind == "shm" and self.task_manager.is_ready(oid)
        ]
        results = spill_objects(node.store, self._spill_dir_for(node),
                                candidates, needed)
        for oid, path, _size in results:
            self.task_manager.set_location(
                oid, ObjectLocation("spilled", node.node_id, path))
        freed = sum(size for _, _, size in results)
        if results:
            self.gcs.add_cluster_event(
                "OBJECT_SPILLED", "WARNING", node_id=node.node_id,
                message=f"{len(results)} objects spilled under arena "
                        "pressure",
                data={"bytes": freed, "count": len(results)})
        return freed

    # --- worker message handlers ----------------------------------------
    def on_worker_put(self, node: Node, msg: dict) -> None:
        oid = ObjectID(msg["object_id"])
        self._pin_contained(oid, msg.get("contained", ()))
        self.task_manager.set_location_and_ready(
            oid, ObjectLocation("shm", node.node_id))

    def handle_get_object(self, node: Node, worker, msg: dict) -> None:
        oid = ObjectID(msg["object_id"])
        req_id = msg.get("req_id")
        attempts = [0]

        def reply():
            out = {"kind": "OBJECT_VALUE", "req_id": req_id}
            err = self.task_manager.get_error(oid)
            if err is not None:
                if (attempts[0] < 2
                        and self._reconstruct_after_infra_failure(oid, err)):
                    attempts[0] += 1
                    self.task_manager.on_ready(oid, reply)
                    return
                out.update(status="error", error=serialization.dumps(err))
                worker.send(out)
                return
            found, stored = self.memory_store.get(oid, timeout_s=0)
            if found:
                kind, payload = stored
                out.update(status="inline", data=payload)
                worker.send(out)
                return
            loc = self.task_manager.get_location(oid)
            if loc is not None and loc.kind == "spilled":
                # Every node is in-process, so the file is readable on
                # the requester's host.
                if loc.path:
                    out.update(status="spilled_local", path=loc.path)
                    worker.send(out)
                    return
                threading.Thread(
                    target=self._replicate_and_reply,
                    args=(oid, node, worker, out), daemon=True).start()
                return
            if loc is not None and loc.kind == "shm":
                holders = self.object_holders(oid)
                if not holders:
                    # every copy died with its node: reconstruct via
                    # lineage, then re-arm this reply on readiness
                    if attempts[0] < 2 and self.try_reconstruct(oid):
                        attempts[0] += 1
                        self.task_manager.on_ready(oid, reply)
                        return
                    out.update(status="error", error=serialization.dumps(
                        ObjectLostError(oid)))
                    worker.send(out)
                    return
                if node.node_id in holders:
                    out.update(status="shm_local")
                    worker.send(out)
                    return
                # In-process requester: replicate into its store off the
                # callback thread, then report it local.
                threading.Thread(
                    target=self._replicate_and_reply,
                    args=(oid, node, worker, out), daemon=True).start()
                return
            out.update(status="error",
                       error=serialization.dumps(ObjectLostError(oid)))
            worker.send(out)

        self.task_manager.on_ready(oid, reply)

    def _replicate_and_reply(self, oid: ObjectID, dst_node: Node,
                             worker, out: dict) -> None:
        if self._replicate_to_node(oid, dst_node):
            self.add_object_replica(oid, dst_node.node_id)
            out.update(status="shm_local")
        else:
            out.update(status="error",
                       error=serialization.dumps(ObjectLostError(oid)))
        worker.send(out)

    def _replicate_to_node(self, oid: ObjectID, dst_node: Node) -> bool:
        """Copy a sealed object into ``dst_node``'s store from any holder
        (a direct memcpy between in-process arenas)."""
        if dst_node.store.contains(oid):
            return True
        loc = self.task_manager.get_location(oid)
        if loc is not None and loc.kind == "spilled":
            return False  # local files are served via spilled_local
        for nid in self.object_holders(oid):
            src = self.nodes.get(nid)
            if src is None or nid == dst_node.node_id:
                continue
            buf = src.store.get_buffer(oid, timeout_s=2.0)
            if buf is None:
                continue
            try:
                try:
                    dest = dst_node.store.create(oid, len(buf))
                except FileExistsError:
                    probe = dst_node.store.get_buffer(oid, timeout_s=10.0)
                    if probe is None:
                        continue
                    del probe
                    dst_node.store.release(oid)
                    return True
                try:
                    dest[:] = buf
                finally:
                    del dest
                dst_node.store.seal(oid)
                TRANSFER_BYTES.inc(float(len(buf)),
                                   tags={"transport": "shm_copy"})
                return True
            finally:
                del buf
                src.store.release(oid)
        return False

    def handle_check_ready(self, worker, msg: dict) -> None:
        ready = [b for b in msg["object_ids"]
                 if self.task_manager.is_ready(ObjectID(b))]
        worker.send({"kind": "READY_REPLY", "req_id": msg.get("req_id"),
                     "ready": ready})

    def subscribe_channel(self, channel: str, callback) -> None:
        """Driver-side pubsub subscription (workers reach the same
        publisher through SUBSCRIBE messages; reference: publisher.h:245
        long-poll push — here a direct push over the worker socket)."""
        self.gcs.pubsub.subscribe(channel, callback)

    def publish_channel(self, channel: str, message: Any) -> None:
        self.gcs.pubsub.publish(channel, message)

    def handle_subscribe(self, node, worker, msg: dict) -> None:
        """A worker subscribed to a pubsub channel: push every publish
        to its socket. Routes are tracked per worker so death cleanup
        removes them (a remote worker's stub send can't observe its
        death — the daemon connection stays alive)."""
        channel = msg["channel"]

        def push(payload):
            ok = worker.send({"kind": "PUBSUB_MSG", "channel": channel,
                              "data": serialization.dumps(payload)})
            if not ok:
                self.gcs.pubsub.unsubscribe(channel, push)

        key = (node.node_id, worker.worker_id.binary())
        with self._worker_subs_lock:
            self._worker_subs.setdefault(key, []).append((channel, push))
        self.gcs.pubsub.subscribe(channel, push)

    def _drop_worker_subscriptions(self, node_id: NodeID,
                                   worker_id_bytes: Optional[bytes] = None
                                   ) -> None:
        """Unsubscribe a dead worker's (or a dead node's every worker's)
        pubsub push routes."""
        with self._worker_subs_lock:
            if worker_id_bytes is not None:
                doomed = {(node_id, worker_id_bytes):
                          self._worker_subs.pop(
                              (node_id, worker_id_bytes), [])}
            else:
                doomed = {k: self._worker_subs.pop(k)
                          for k in [k for k in self._worker_subs
                                    if k[0] == node_id]}
        for subs in doomed.values():
            for channel, push in subs:
                self.gcs.pubsub.unsubscribe(channel, push)

    def handle_gcs_request(self, worker, msg: dict) -> None:
        method = msg["method"]
        args = serialization.loads(msg["args"])
        out = {"kind": "GCS_REPLY", "req_id": msg.get("req_id"), "error": None}
        if method == "kv_wait":
            # Async on the head side: this runs on a node's single IO
            # thread, which must never block — the reply is sent by the
            # KV waiter callback when the key lands (or by the timer).
            key, namespace, timeout = args
            import threading as _threading
            claim_lock = _threading.Lock()
            claimed = [False]
            timer_box: list = []

            def _reply(value) -> None:
                # atomic claim: the put callback and the timeout timer
                # race — exactly one may send the reply (a lost put
                # must not be overwritten by the timer's None)
                with claim_lock:
                    if claimed[0]:
                        return
                    claimed[0] = True
                if timer_box:
                    timer_box[0].cancel()
                out["result"] = serialization.dumps(value)
                worker.send(out)

            existing = self.gcs.kv.add_waiter(key, namespace, _reply)
            if existing is not None:
                _reply(existing)
                return

            def _expire() -> None:
                self.gcs.kv.remove_waiter(key, namespace, _reply)
                _reply(None)

            timer = _threading.Timer(timeout, _expire)
            timer.daemon = True
            timer_box.append(timer)
            timer.start()
            return
        try:
            result = self._gcs_dispatch(method, args)
            out["result"] = serialization.dumps(result)
        except Exception as e:  # noqa: BLE001
            out["error"] = serialization.dumps(e)
            out["result"] = None
        worker.send(out)

    def _gcs_dispatch(self, method: str, args: tuple) -> Any:
        gcs = self.gcs
        if method == "get_function":
            return gcs.get_function(args[0])
        if method == "put_function":
            gcs.put_function(args[0], args[1])
            return True
        if method == "node_labels":
            rec = gcs.nodes.get(NodeID(args[0]))
            return dict(rec.labels) if rec else {}
        if method == "kv_put":
            if args[2] == "actor_handles":
                # A named-actor handle may only be installed by the
                # registration that actually OWNS the name: a client
                # whose duplicate-name create_actor failed would
                # otherwise overwrite the live actor's handle with one
                # pointing at a never-registered actor id (the client
                # sends kv_put after SUBMIT on the same ordered
                # connection, so the record exists here by now).
                handle = serialization.loads(args[1])
                name = args[0].decode()
                rec = gcs.get_named_actor(name, self.namespace)
                if rec is None or rec.actor_id != handle._actor_id:
                    return False
            gcs.kv.put(args[0], args[1], namespace=args[2])
            return True
        if method == "kv_get":
            return gcs.kv.get(args[0], namespace=args[1])
        if method == "kv_del":
            return gcs.kv.delete(args[0], namespace=args[1])
        if method == "kv_keys":
            return gcs.kv.keys(args[0], namespace=args[1])
        if method == "kv_exists":
            return gcs.kv.exists(args[0], namespace=args[1])
        if method == "kv_wait":
            # driver-direct path (worker requests take the async branch
            # in handle_gcs_request): blocking is fine on a user thread
            return gcs.kv.wait(args[0], namespace=args[1], timeout=args[2])
        if method == "actor_state":
            rec = gcs.get_actor(ActorID(args[0]))
            return rec.state if rec else None
        if method == "get_named_actor_handle":
            return gcs.kv.get(args[0].encode(), namespace="actor_handles")
        if method == "cluster_resources":
            return self.cluster_resources()
        if method == "available_resources":
            return self.available_resources()
        if method == "list_nodes":
            return [{
                "NodeID": rec.node_id.hex(),
                "Alive": rec.alive,
                "Resources": dict(rec.resources_total),
                "Labels": dict(rec.labels),
            } for rec in gcs.alive_nodes()]
        if method == "publish":
            self.gcs.pubsub.publish(args[0], serialization.loads(args[1]))
            return True
        if method == "metrics_apply":
            from ray_tpu_torch.util.metrics import _registry
            kind, name, tag_items, value, boundaries = args
            _registry.apply(kind, name, tuple(tag_items), value,
                            boundaries)
            return True
        if method == "metrics_apply_batch":
            from ray_tpu_torch.util.metrics import _registry
            _registry.apply_batch(args[0])
            return True
        if method == "trace_add_span":
            self.gcs.add_trace_span(args[0])
            return True
        if method == "flight_sync":
            # clock ping-pong: the worker brackets this call with its
            # own clock reads and derives its offset into our domain
            from ray_tpu_torch.util import flight_recorder
            return flight_recorder.clock_ns()
        if method == "flight_push":
            # journal increment from a worker flusher; brief/lock-only
            # (this may run on the head's IO-loop thread)
            from ray_tpu_torch.util import flight_recorder
            flight_recorder.store_push(args[0], args[1], args[2])
            return True
        if method == "refsan_push":
            # lifetime-ledger increment from a worker's refsan flusher;
            # same brevity contract as flight_push
            refsan.store_push(args[0], args[1])
            return True
        if method in ("collsan_push", "profile_push"):
            raise NotImplementedError(
                "the collective and sampling sanitizers are not "
                "ported: ROADMAP item 9")
        if method == "add_cluster_event":
            # lifecycle event from a worker process (serve controller /
            # replicas route here via events.emit); brief/lock-only
            (kind, severity, node_id, worker_id, actor_id, task_id,
             message, caused_by, data) = args
            return gcs.add_cluster_event(
                kind, severity, node_id=node_id, worker_id=worker_id,
                actor_id=actor_id, task_id=task_id, message=message,
                caused_by=caused_by, data=data)
        if method == "list_cluster_events":
            return [e.to_dict() for e in gcs.list_cluster_events(*args)]
        raise ValueError(f"unknown GCS method {method}")

    # --- misc api --------------------------------------------------------
    def gcs_call(self, method: str, *args) -> Any:
        return self._gcs_dispatch(method, args)

    def cancel(self, object_id: ObjectID, force: bool = False) -> None:
        """Cancel the producing task: tasks not yet dispatched (queued,
        dep-waiting, or in the scheduler's backlog) fail with
        TaskCancelledError immediately — the scheduling loop drops specs
        whose pending entry is gone. Running tasks are only interrupted
        with force=True (worker kill), matching the reference's
        semantics for non-async tasks."""
        task_id = self.task_manager.producing_task(object_id)
        if task_id is None:
            return
        task = self.task_manager.get_pending(task_id)
        if task is None:
            return  # already finished/failed
        if task.node_id is None and task.spec.actor_id is None:
            # Plain task not dispatched anywhere yet; fail it and let the
            # queues drop it when they encounter the dead pending entry.
            # Actor tasks are excluded: they are routed to the actor
            # without mark_dispatched, so node_id is None even while the
            # method runs — cancelling them here would fail the ref while
            # the method still executes (only force=True interrupts).
            self.task_manager.fail(task_id, TaskCancelledError(task_id))
            self._signal_scheduler()
            return
        if task.spec.actor_id is None and task.node_id is not None:
            # Dispatched to a node but possibly still in its dispatch
            # queue (burst-granted followers park there): a queued spec
            # cancels immediately, keeping the documented queued-task
            # semantics (reference: cancellation of leased-not-started
            # tasks).
            node = self.nodes.get(task.node_id)
            if node is not None:
                spec = node.cancel_queued(task_id)
                if spec is not None:
                    self._release_task_resources(spec, task.node_id)
                    self._record_event(spec, "FAILED",
                                       node_id=task.node_id,
                                       error="cancelled")
                    self.task_manager.fail(
                        task_id, TaskCancelledError(task_id))
                    self._signal_scheduler()
                    return
        if force:
            node_id = task.node_id
            if node_id is None and task.spec.actor_id is not None:
                info = self.actors.get(task.spec.actor_id)
                node_id = info.node_id if info else None
            node = self.nodes.get(node_id)
            if node is None:
                return
            with node._lock:
                for w in node._workers.values():
                    if task_id in w.running:
                        node.kill_worker(w.worker_id)
                        break

    def cluster_resources(self) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        for view in self.scheduler.snapshot().values():
            for k, v in view.total.items():
                totals[k] = totals.get(k, 0.0) + v
        return totals

    def available_resources(self) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        for view in self.scheduler.snapshot().values():
            for k, v in view.available.items():
                totals[k] = totals.get(k, 0.0) + v
        return totals

    def next_task_id(self) -> TaskID:
        return TaskID.from_random()

    def put_function(self, function_id: str, blob: bytes) -> None:
        self.gcs.put_function(function_id, blob)

    def get_function(self, function_id: str):
        blob = self.gcs.get_function(function_id)
        return serialization.loads(blob) if blob else None

    def as_future(self, ref: ObjectRef):
        from concurrent.futures import Future
        fut: Future = Future()

        def run():
            try:
                fut.set_result(self.get(ref))
            except Exception as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True).start()
        return fut

    def _record_event(self, spec: TaskSpec, state: str,
                      node_id: Optional[NodeID] = None,
                      error: Optional[str] = None,
                      worker_id=None, timestamp: Optional[float] = None,
                      duration: Optional[float] = None,
                      name: Optional[str] = None) -> None:
        if not get_config().task_events_enabled:
            return
        # Tuple layout (see Gcs.add_task_event): no dataclass
        # construction on the hot path.
        self.gcs.add_task_event((
            spec.task_id, name or spec.name or spec.function_id, state,
            time.time() if timestamp is None else timestamp,
            node_id, worker_id, error, duration, spec.parent_task_id,
            spec.trace_id))

    def _record_execution_events(self, spec: TaskSpec, node: Node,
                                 worker, msg: dict, state: str,
                                 error: Optional[str] = None,
                                 submitted_at: Optional[float] = None
                                 ) -> None:
        """Record worker-timed RUNNING + user PROFILE spans + the final
        state for one executed task (timestamps come from the worker so
        the timeline reflects true execution windows, reference:
        task_event_buffer.h:297 + profile_event.cc). All events for the
        task are appended under one GCS lock acquisition. Also feeds the
        built-in task latency histograms (queue / run / end-to-end)."""
        t_start, t_end = msg.get("t_start"), msg.get("t_end")
        if t_start is not None and t_end is not None:
            from ray_tpu_torch.core.task_manager import (
                TASK_E2E_SECONDS, TASK_QUEUE_SECONDS, TASK_RUN_SECONDS)
            TASK_RUN_SECONDS.observe(max(0.0, t_end - t_start))
            if submitted_at is not None:
                TASK_QUEUE_SECONDS.observe(
                    max(0.0, t_start - submitted_at))
                TASK_E2E_SECONDS.observe(max(0.0, t_end - submitted_at))
        if not get_config().task_events_enabled:
            return
        worker_id = worker.worker_id if worker is not None else None
        name = spec.name or spec.function_id
        node_id = node.node_id
        parent = spec.parent_task_id
        trace_id = spec.trace_id
        events = []
        if t_start is not None:
            events.append((spec.task_id, name, "RUNNING", t_start,
                           node_id, worker_id, None,
                           (t_end - t_start) if t_end else None, parent,
                           trace_id))
        for span in msg.get("profile", ()):
            span_name, s0, s1 = span
            events.append((spec.task_id, span_name, "PROFILE", s0,
                           node_id, worker_id, None, s1 - s0, parent,
                           trace_id))
        events.append((spec.task_id, name, state,
                       time.time() if t_end is None else t_end,
                       node_id, worker_id, error, None, parent, trace_id))
        self.gcs.add_task_events(events)

    def shutdown(self) -> None:
        # Fold the lifetime ledger while worker journals and live-view
        # state are still current (stores close below); findings are
        # kept for post-shutdown refsan.report() calls.
        refsan.on_shutdown()
        _task_phase.reset()
        self._stopped.set()
        for hook in getattr(self, "_shutdown_hooks", ()):
            try:
                hook()
            except Exception:  # graftlint: disable=GL004
                pass  # teardown is best-effort; runtime is going away
        self._signal_scheduler()
        for node in list(self.nodes.values()):
            node.stop()
        self.nodes.clear()
        if self.gcs.store is not None:
            self.gcs.store.close()
        # the recorder, its flusher and the RTPU_FLIGHT_* variables
        # init_driver set go back to how the session found them
        from ray_tpu_torch.util import flight_recorder
        flight_recorder.shutdown_driver()
        set_runtime(None)
