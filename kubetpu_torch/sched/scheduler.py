"""The batched scheduler loop — reduced fork of ``kubetpu/sched/scheduler.py``.

The slices of the port so far: the serial cycle of one or more profiles
on the greedy or the batched engine, in direct mode, with synchronous
binding. What it keeps of the reference, line for line where the logic is
host logic: the informer handlers for nodes, pods, namespaces and services,
``schedule_batch`` → ``_schedule_batch_serial`` → ``_profile_cycle`` →
``_launch_cycle`` / ``_finish_cycle``, ``_handle_unschedulable``, the engine
seam and ``run_until_idle``.

The device calls of the reference's cycle become torch calls: the encoded
batch is uploaded to the scheduler's ``device`` in one copy, the engine
launches its kernels on a CUDA device (``greedy_scan``, or the
``batched_round`` rounds; the plain PyTorch loops on the CPU), and
``jax.device_get`` of the assignments becomes ``.cpu()``. Each cycle leaves
a ``CycleTiming`` record (snapshot, encode, upload, kernel, bind, and the
batched engine's rounds), each region timed with ``time.perf_counter`` and
closed by a synchronize of the cycle's stream on a CUDA device.

Not in these slices (each raises when asked for): the pipelined cycle, the
device mesh, the encode cache, the flight recorder, preemption, extenders,
gangs, DRA, volumes, the sentinel, the packing engine and the metrics
registry.

Reference semantics kept: the reference pops ONE pod per cycle
(``ScheduleOne``); here a BATCH is popped and assigned by the greedy engine,
whose sequential assume semantics inside the batch preserve binding parity
with the per-pod loop. Failure handling mirrors ``handleSchedulingFailure``:
unschedulable pods go back to the queue with their rejector plugins
recorded (driving the queueing hints); bind errors forget the assumed pod
and requeue as error-status.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from .. import names as N
from ..api import types as t
from ..assign.batched import batched_assign_device
from ..assign.greedy import greedy_assign_device
from ..framework import config as C
from ..framework import runtime as rt
from ..queue import PriorityQueue, QueuedPodInfo
from ..queue.events import (
    ActionType,
    ClusterEvent,
    EventResource,
    default_queueing_hints,
)
from ..state.snapshot import Cache, Snapshot


@dataclass
class CycleTiming:
    """Wall seconds of one profile cycle's regions (``time.perf_counter``;
    on a CUDA device each device region ends in a stream synchronize)."""

    cycle: int
    pods: int
    snapshot_s: float
    encode_s: float
    upload_s: float
    kernel_s: float
    bind_s: float = 0.0
    upload_bytes: int = 0
    rounds: int = 0                  # batched engine: rounds of the cycle


@dataclass
class SchedulerMetrics:
    """Plain counters of the cycle (the reference's registry and device
    metrics are not ported) plus the per-cycle timing records."""

    schedule_attempts: int = 0
    scheduled: int = 0
    unschedulable: int = 0
    errors: int = 0
    bind_errors: int = 0
    cycles: int = 0
    cycle_timings: list = field(default_factory=list)


@dataclass
class _LaunchedCycle:
    """A launched profile cycle: the device result and its host context."""

    profile: C.Profile
    batch_infos: list
    batch: "rt.EncodedBatch"
    assignments: Any
    timing: CycleTiming
    t_dev: float                     # perf_counter when the engine launched


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is ROADMAP {item}, not yet ported")


class Scheduler:
    """See module docstring. Single-owner object: informer callbacks and the
    scheduling loop run on the owner's thread."""

    def __init__(
        self,
        client: Any,
        profile: C.Profile | None = None,
        cfg: C.SchedulerConfiguration | None = None,
        max_batch: int = 1024,
        clock: Callable[[], float] = time.monotonic,
        engine: str = "greedy",
        device="cuda",
        pipeline: bool = False,
        mesh=None,
        encode_cache: bool = False,
        flight_recorder: bool = False,
        dispatcher_workers: int = 0,
    ) -> None:
        """``device``: where the cycle's device work runs — ``"cuda"``
        (default: the hand-written kernels) or ``"cpu"`` (the plain
        PyTorch versions). The other arguments name features of later
        slices; anything but their default raises NotImplementedError."""
        if engine == "packing":
            raise _not_ported("engine 'packing'", "Queue A item 11 (kernel B14)")
        if engine not in ("greedy", "batched"):
            raise ValueError(f"unknown engine {engine!r}")
        if pipeline:
            raise _not_ported("the pipelined cycle", "Queue A item 5 (kernel B5)")
        if mesh not in (None, "off"):
            raise _not_ported("the device mesh", "Queue A item 12 (kernel B15)")
        if encode_cache:
            raise _not_ported("the encode cache", "Queue A item 5")
        if flight_recorder:
            raise _not_ported("the flight recorder", "Queue A item 9 (kernel B10)")
        if dispatcher_workers:
            raise _not_ported("asynchronous binding", "Queue A item 13")
        self.client = client
        self.device = torch.device(device)
        self.cfg = cfg or C.SchedulerConfiguration()
        if self.cfg.extenders:
            raise _not_ported("extenders", "Queue A item 9 (kernel B10)")
        self.profile = profile or self.cfg.profile()
        # the profile Map (profile.go:46): pods select by spec.schedulerName.
        # A single explicit ``profile`` also answers for the default name so
        # plain pods keep scheduling under it (test/one-profile usage).
        if profile is not None:
            self.profiles: dict[str, C.Profile] = {profile.name: profile}
            self.profiles.setdefault("default-scheduler", profile)
        else:
            self.profiles = {p.name: p for p in self.cfg.profiles}
        self._assign_device = (
            greedy_assign_device if engine == "greedy" else self._batched_assign
        )
        self.engine = engine
        self._rounds = 0
        self.cache = Cache(clock=clock)
        self.clock = clock
        self.max_batch = max_batch
        filters = sorted({
            n for prof in self.profiles.values() for n in prof.filters.names()
        })
        self.queue = PriorityQueue(
            hints=default_queueing_hints(filters),
            pre_enqueue=[self._scheduling_gates],
            clock=clock,
            initial_backoff_seconds=self.cfg.pod_initial_backoff_seconds,
            max_backoff_seconds=self.cfg.pod_max_backoff_seconds,
        )
        self.metrics = SchedulerMetrics()
        self._snapshot = Snapshot()
        # previous cycle's NodeTensors — encode_snapshot refreshes only the
        # rows whose generation moved (O(Δ) per-cycle host encode)
        self._prev_nt = None
        self._last_flush = 0.0

    def warmup(self) -> None:
        """Build the kernels before the measured phase (on a CUDA device;
        a no-op on the CPU). The reference compiles its XLA programs here."""
        if self.device.type == "cuda":
            from .. import kernels

            kernels.build()

    def _batched_assign(self, b: rt.DeviceBatch, params: rt.ScoreParams):
        """The batched engine, keeping the cycle's round count."""
        rounds: list = []
        out = batched_assign_device(b, params, rounds_out=rounds)
        self._rounds = rounds[0]
        return out

    def _sync(self) -> None:
        """Wait for the cycle's stream (the reference's block_until_ready)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # ------------------------------------------------------ event handlers
    # The informer seam (eventhandlers.go:455): assigned pods maintain the
    # cache; unscheduled pods maintain the queue; every event also feeds the
    # queueing hints so parked pods wake up.

    def _profile_for(self, pod: t.Pod) -> C.Profile | None:
        """frameworkForPod (schedule_one.go:532): None = not our pod."""
        return self.profiles.get(pod.scheduler_name)

    @staticmethod
    def _scheduling_gates(pod: t.Pod) -> str | None:
        """SchedulingGates PreEnqueue (plugins/schedulinggates): any
        non-empty spec.schedulingGates holds the pod out of the queue."""
        return N.SCHEDULING_GATES if pod.scheduling_gates else None

    def on_node_add(self, node: t.Node) -> None:
        self.cache.add_node(node)
        self.queue.on_event(
            ClusterEvent(EventResource.NODE, ActionType.ADD), None, node
        )

    def on_namespace_add(self, ns: t.Namespace) -> None:
        """nsLister feed — namespace labels drive affinity-term
        namespaceSelectors (AffinityTerm.Matches nsLabels)."""
        self.cache.add_namespace(ns)

    on_namespace_update = on_namespace_add

    def on_namespace_delete(self, ns: t.Namespace) -> None:
        self.cache.remove_namespace(ns.name)

    def on_service_add(self, svc: t.Service) -> None:
        """Service selectors feed the DEFAULT PodTopologySpread constraints
        (component-helpers DefaultSelector)."""
        self.cache.add_service(svc)

    def on_service_delete(self, svc: t.Service) -> None:
        self.cache.remove_service(svc.key)

    def on_pod_add(self, pod: t.Pod) -> None:
        if not pod.node_name and self._profile_for(pod) is None:
            # a pod naming an unknown profile is another scheduler's
            # responsibility (the reference's informer filters it out)
            return
        if pod.scheduling_group:
            raise _not_ported("the gang lane", "Queue A item 10 (kernels B11-B13)")
        if pod.node_name:
            self.cache.add_pod(pod)
            self.queue.on_event(
                ClusterEvent(EventResource.ASSIGNED_POD, ActionType.ADD),
                None, pod,
            )
        else:
            self.queue.add(pod)

    def on_pod_update(self, old: t.Pod | None, new: t.Pod) -> None:
        if not new.node_name and self._profile_for(new) is None:
            return
        if new.node_name:
            if old is not None and old.node_name:
                self.cache.update_pod(old, new)
                from ..queue.events import pod_update_event

                ev = pod_update_event(old, new)
                if ev.action:
                    self.queue.on_event(
                        ClusterEvent(EventResource.ASSIGNED_POD, ev.action),
                        old, new,
                    )
            else:
                # pending → assigned transition (bind confirmation, possibly
                # by another actor): drop any unscheduled queue incarnation
                # and fire AssignedPod/Add
                self.cache.add_pod(new)
                self.queue.delete(new)
                self.queue.on_event(
                    ClusterEvent(EventResource.ASSIGNED_POD, ActionType.ADD),
                    None, new,
                )
        else:
            self.queue.update(old, new)

    def on_pod_delete(self, pod: t.Pod) -> None:
        # has_pod covers BOUND pods too: a Delete event may carry a stale
        # object with node_name unset (cache.go:583 RemovePod's contract)
        if pod.node_name or self.cache.has_pod(pod.uid):
            self.cache.remove_pod(pod)
            self.queue.delete(pod)
            self.queue.on_event(
                ClusterEvent(EventResource.ASSIGNED_POD, ActionType.DELETE),
                pod, None,
            )
        else:
            self.queue.delete(pod)

    # --------------------------------------------------------- batch cycle

    def schedule_batch(self, max_batch: int | None = None) -> dict[str, int]:
        """One scheduling cycle over up to ``max_batch`` pods. Returns result
        counts. The serial cycle: pop batch → snapshot → encode → upload →
        device assign → assume + bind → requeue failures. A mixed-profile
        batch runs one sub-cycle per profile."""
        self._flush_timers()
        limit = max_batch or self.max_batch
        batch_infos = self._pop_cycle(limit)
        if not batch_infos:
            return {"scheduled": 0, "unschedulable": 0}
        return self._schedule_batch_serial(batch_infos)

    def _requeue_error(self, infos: list[QueuedPodInfo]) -> None:
        """handleSchedulingFailure for a whole batch: a cycle-level failure
        must never strand popped pods in the queue's in-flight set — requeue
        them as error status, then let the bug surface."""
        self.metrics.errors += len(infos)
        for info in infos:
            self.queue.add_unschedulable(info, error=True)

    def _pop_cycle(self, limit: int) -> list[QueuedPodInfo]:
        batch_infos = self.queue.pop_batch(limit)
        self.metrics.cycles += 1
        return batch_infos

    def _schedule_batch_serial(
        self, batch_infos: list[QueuedPodInfo]
    ) -> dict[str, int]:
        # partition by profile, preserving queue order within each group
        by_profile: dict[str, list[QueuedPodInfo]] = {}
        for info in batch_infos:
            by_profile.setdefault(info.pod.scheduler_name, []).append(info)
        scheduled = unschedulable = 0
        groups = list(by_profile.items())
        for g_i, (pname, infos) in enumerate(groups):
            try:
                res = self._profile_cycle(self.profiles[pname], infos)
            except Exception:
                # an earlier profile's failure must not strand the LATER
                # profiles' popped pods in the in-flight set
                for _, rest in groups[g_i + 1:]:
                    self._requeue_error(rest)
                raise
            scheduled += res["scheduled"]
            unschedulable += res["unschedulable"]
        return {"scheduled": scheduled, "unschedulable": unschedulable}

    def _profile_cycle(
        self, profile: C.Profile, batch_infos: list[QueuedPodInfo]
    ) -> dict[str, int]:
        """Serial cycle: launch + sync back-to-back (the reference's fully
        serialized scheduling cycle)."""
        return self._finish_cycle(
            self._launch_cycle(profile, batch_infos, self.metrics.cycles)
        )

    def _launch_cycle(
        self,
        profile: C.Profile,
        batch_infos: list[QueuedPodInfo],
        cycle_id: int,
    ) -> _LaunchedCycle:
        """Snapshot → encode → upload → launch the assign engine."""
        try:
            t_snap = time.perf_counter()
            self._snapshot = self.cache.update_snapshot(self._snapshot)
            pods = [info.pod for info in batch_infos]
            t_enc = time.perf_counter()
            sb = rt.encode_batch_static(
                self._snapshot, pods, profile, prev_nt=self._prev_nt,
                track_changes=False,
            )
            t_up = time.perf_counter()
            batch = rt.finalize_batch(sb, self.device)
            self._sync()
            t_dev = time.perf_counter()
            self._prev_nt = batch.node_tensors
            params = rt.score_params(profile, batch.resource_names)
            assignments, _ = self._assign_device(batch.device, params)
            timing = CycleTiming(
                cycle=cycle_id, pods=len(batch_infos),
                snapshot_s=t_enc - t_snap, encode_s=t_up - t_enc,
                upload_s=t_dev - t_up, kernel_s=0.0,
                upload_bytes=batch.upload_bytes,
                rounds=self._rounds if self.engine == "batched" else 0,
            )
            return _LaunchedCycle(
                profile=profile, batch_infos=batch_infos, batch=batch,
                assignments=assignments, timing=timing, t_dev=t_dev,
            )
        except Exception:
            self._requeue_error(batch_infos)
            raise

    def _finish_cycle(self, launched: _LaunchedCycle) -> dict[str, int]:
        """Sync the device result and run the host half of the cycle:
        assume + bind, failure handling."""
        batch_infos = launched.batch_infos
        batch = launched.batch
        timing = launched.timing
        try:
            self._sync()
            timing.kernel_s = time.perf_counter() - launched.t_dev
            idx = launched.assignments.cpu().numpy()
        except Exception:
            self._requeue_error(batch_infos)
            raise
        t_bind = time.perf_counter()
        scheduled = 0
        failed: list[QueuedPodInfo] = []
        for k, info in enumerate(batch_infos):
            j = int(idx[k])
            self.metrics.schedule_attempts += 1
            if 0 <= j < len(batch.node_names):
                if self._assume_and_bind(info, batch.node_names[j]):
                    scheduled += 1
            else:
                failed.append(info)
        timing.bind_s = time.perf_counter() - t_bind
        self.metrics.cycle_timings.append(timing)
        self.metrics.scheduled += scheduled
        self.metrics.unschedulable += len(failed)
        for info in failed:
            self._handle_unschedulable(info, launched.profile)
        return {"scheduled": scheduled, "unschedulable": len(failed)}

    def _assume_and_bind(self, info: QueuedPodInfo, node_name: str) -> bool:
        """assumeAndReserve + a synchronous binding cycle (schedule_one.go:307
        assumeAndReserve, :391 bindingCycle), as the reference runs with
        ``dispatcher_workers=0``. Returns False when the bind failed (the
        assume was forgotten and the pod requeued as error status)."""
        assumed = info.pod.with_node(node_name)
        self.cache.assume_pod(assumed)
        info.cycle_id = self.metrics.cycles
        try:
            self.client.bind(info.pod, node_name)
        except Exception:
            # bind failed: roll back the assume and retry as error status
            # (handleSchedulingFailure, schedule_one.go:1190 analog)
            self.metrics.bind_errors += 1
            self.metrics.errors += 1
            self.cache.forget_pod(assumed)
            self.queue.add_unschedulable(info, error=True)
            return False
        self.cache.finish_binding(assumed.uid)
        self.queue.done(info.key)
        return True

    def _handle_unschedulable(
        self, info: QueuedPodInfo, profile: C.Profile | None = None
    ) -> None:
        """No feasible node: requeue with rejector plugins for the queueing
        hints (no PostFilter in this slice: preemption is ROADMAP Queue A
        item 8).

        Rejector attribution is conservative: every enabled Filter plugin is
        recorded (the reference records the plugins that actually rejected
        per node, schedule_one.go FitError) — over-eager wake-ups are safe;
        the leftover flush bounds staleness either way."""
        profile = profile or self._profile_for(info.pod) or self.profile
        where = self.queue.add_unschedulable(info, profile.filters.names())
        if where not in ("deleted", "already-queued"):
            # only patch status for pods that still exist and we own
            self.client.patch_status(info.pod, "Unschedulable")

    # ------------------------------------------------------------- running

    def _flush_timers(self) -> None:
        """The reference's flush goroutines (scheduling_queue.go:442: backoff
        every 1 s, unschedulable leftover every 30 s) folded into the loop."""
        now = self.clock()
        if now - self._last_flush >= 30.0:
            self.queue.flush_unschedulable_leftover()
            self.cache.cleanup_expired()
            self._last_flush = now
        self.queue.flush_backoff_completed()

    def run_until_idle(self, max_cycles: int = 10000) -> int:
        """Drive cycles until no pod is ready (harness/test mode). Returns
        total scheduled."""
        total = 0
        for _ in range(max_cycles):
            res = self.schedule_batch()
            total += res["scheduled"]
            if res["scheduled"] == 0 and res["unschedulable"] == 0:
                break
        return total
