"""The batched scheduler loop — reduced fork of ``kubetpu/sched/scheduler.py``.

The slices of the port so far: the reference's default cycle — the encode
cache, the device-resident node block and, on request, the two-stage
pipelined cycle — for one or more profiles on the greedy, the batched or
the packing engine, in direct mode, with synchronous binding through the
lifecycle runner (``framework.lifecycle``: Reserve, Permit with waiting
pods, PreBind, bind, PostBind, and Unreserve on any failure; the default
registry's VolumeBinding and DynamicResources plugins), the volume and DRA
informers with the DynamicResources PreEnqueue gate, the
DefaultPreemption PostFilter with the nominator's reservations
(``enable_preemption``), the
scheduler-extender webhooks (``cfg.extenders``: the batch's Filter and
Prioritize calls, a binder extender's bind, the ProcessPreemption hook) and
the flight recorder (``flight_recorder``, on by default as in the
reference: a decision record per pod with its cycle-start breakdown). What
it keeps of the reference, line for line where the logic is host logic:
the informer handlers for nodes, pods, namespaces, services, PDBs, PVs,
PVCs, storage classes, resource claims, resource slices and device classes
(with the encode cache's hooks), ``schedule_batch`` → ``_schedule_batch_serial`` /
``_schedule_batch_pipelined`` → ``_launch_cycle`` / ``_finish_cycle``,
``_pre_encode`` (None for a batch with volumes or claims),
``_refresh_host_state``, ``_complete_inflight`` with its replay (also when
the nomination set, the volume listers or the DRA index moved under the
in-flight cycle), ``_begin_binding`` / ``_reject_assumed`` /
``_drain_waiting_pods``,
``_handle_unschedulable`` with its PostFilter branch, the nomination spent
at assume and dropped at pod delete, ``_apply_extenders``, the recorder's
calls (delivery, drop, cycle, requeue, preemption, bind), the engine seam
and ``run_until_idle``; and the gang lane (``sched.podgroup``): the
``feature_gates``, the ``topology`` mode, the pod-group informers, the gang
routing of pod events and bind failures, and the group cycles that run
when the per-pod lane is drained and nothing is in flight.

The device calls of the reference's cycle become torch calls: the pod
leaves are uploaded to the scheduler's ``device`` in one copy, the node
block lives there (``runtime.ResidentNodeState``: after the first cycle
only the dirty rows are shipped, through the ``scatter_rows`` kernel), the
engine launches its kernels on a CUDA device (``greedy_scan``, the
``batched_round`` rounds, or the packing solve's ``packing_round`` rounds;
the plain PyTorch loops on the CPU), and
``jax.device_get`` of the assignments becomes ``.cpu()``.

The reference overlaps its pipeline's stages through JAX async dispatch.
Here the engine launches without a synchronize, a CUDA event is recorded
after the launch, and the next call encodes the next batch's stage 1 on the
host (no CUDA call) before ``_complete_inflight`` waits on that event.
Every launch is on the device's current stream, so a cycle's resident-block
scatter never overtakes the previous cycle's kernels. The batched engine
and the packing engine read two flags on the host every round, so their
launch returns only when their rounds are done: with them the pipeline is
correct but does not overlap.

Each cycle leaves a ``CycleTiming`` record: snapshot, stage 1
(``pre_encode_s``), stage 2 (``finalize_s``), the extender calls, upload,
kernel (the CUDA events' elapsed time on a CUDA device), the host's wait
for the device, the recorder's ``note_cycle``, bind, the upload's byte
counts, the batched engine's rounds, and the packing engine's solver
iterations, objective and nodes used (fetched with the assignments in one
device→host copy, and handed to the recorder's ``note_cycle``).

The recorder's explain is launched in ``_finish_cycle`` after the
assignments are fetched, on the current stream, before the next cycle's
scatter can write the resident block: stage 1 stays free of CUDA calls.

``mesh`` shards the node axis over a ``parallel.mesh.NodeMesh`` (or
``"auto"`` / ``"on"``, resolved on the scheduler's device type): the
resident block lives sharded and takes routed deltas, each cycle's batch
is a ``ShardedBatch``, the greedy, batched and packing engines (the
packing duals sharded with the node rows) and the preemption dry run
reduce across the shards, and the recorder skips its breakdown
("skipped: mesh"), as the reference's does. A pods x nodes grid
(``parallel.mesh.make_mesh_2d``) also cuts each batch's pods into pod
rows on the three engines; the dry run then runs over the node columns
of the preempting pod's pod row. The gang lane's group cycles run
unsharded under any mesh, as the reference's do: each group batch is
encoded whole on the mesh's first device (no sharded resident block, no
encode cache, no mesh padding) and the unsharded engines, placement
search and gang dry run take it.

Not in these slices (each raises when asked for): the
sentinel, the asynchronous API dispatcher and the metrics registry (so the
recorder's staged latency vectors are recorded but observed into no
histogram, the lifecycle runner times no plugin, the gang lane's admission
latencies and victims land on ``SchedulerMetrics``, and the packing
solve's objective, nodes used and iterations on ``CycleTiming``, not on
prometheus gauges). The binding cycle runs inline, as the reference's does
with ``dispatcher_workers=0``, and its outcome (bound, or forgotten,
unreserved and requeued) is applied at once rather than at the next
cycle's drain of bind completions; PreBind's API writes go to the client
(``update_claim_status``, ``bind_pvc``) when it has them.

Reference semantics kept: the reference pops ONE pod per cycle
(``ScheduleOne``); here a BATCH is popped and assigned by the greedy engine,
whose sequential assume semantics inside the batch preserve binding parity
with the per-pod loop. Failure handling mirrors ``handleSchedulingFailure``:
unschedulable pods go back to the queue with their rejector plugins
recorded (driving the queueing hints); bind errors forget the assumed pod
and requeue as error-status. A pipelined cycle whose cluster state moved
under it is replayed against fresh state, so its bindings equal the serial
loop's pod for pod.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from .. import names as N
from ..api import types as t
from ..assign.batched import batched_assign_device
from ..assign.greedy import greedy_assign_device
from ..assign.packing import PackingEngine
from ..framework import config as C
from ..framework import lifecycle as lc
from ..framework import runtime as rt
from ..framework.featuregate import FeatureGate
from ..framework.validation import must_validate
from ..parallel.mesh import ShardedBatch
from ..queue import PriorityQueue, QueuedPodInfo
from ..queue.events import (
    ActionType,
    ClusterEvent,
    EventResource,
    default_queueing_hints,
    node_update_event,
)
from ..queue.nominator import Nominator
from ..queue.priority_queue import pod_key
from ..state.encode_cache import EncodeCache
from ..state.encoder import encode_snapshot
from ..state.snapshot import Cache, Snapshot
from .extender import HTTPExtender, run_extenders
from .flightrecorder import FlightRecorder
from .podgroup import PodGroupManager, schedule_pod_groups


@dataclass
class CycleTiming:
    """Wall seconds of one profile cycle's regions (``time.perf_counter``)
    and its upload's bytes. ``pre_encode_s`` is the host encode's stage 1
    (``encode_batch_static``; in the pipelined cycle it ran while the
    previous cycle's kernels did), ``finalize_s`` its stage 2
    (``refresh_static`` and ``finalize_batch`` without the copies: the
    affinity and spread encodes, the in-use ports), ``upload_s`` the
    host→device copies and the resident block's scatter, ``kernel_s`` the
    engine (between two CUDA events on a CUDA device), ``wait_s`` how long
    the host blocked for the engine's result. Two sub-spans time the node
    tensors' host encode (``encode_snapshot``): ``nodes_s`` stage 1's own,
    ``refresh_s`` the pipelined cycle's staleness refreshes — the
    ``_refresh_host_state`` in its stage 1 and the one that completes the
    previous cycle, and ``refresh_static`` in its stage 2 (0 in the serial
    cycle). ``postfilter_s`` is the failed pods' handling after bind: the
    PostFilter (the preemption evaluator's build and its ``preempt``
    calls) and their requeue. ``extenders_s`` is the extender webhooks'
    calls and their verdicts' upload (0 without extenders), ``recorder_s``
    the flight recorder's ``note_cycle`` (the explain's launch and the
    previous cycle's fetch; 0 with the recorder off)."""

    cycle: int
    pods: int
    snapshot_s: float
    pre_encode_s: float
    finalize_s: float
    upload_s: float
    kernel_s: float = 0.0
    wait_s: float = 0.0
    bind_s: float = 0.0
    nodes_s: float = 0.0
    refresh_s: float = 0.0
    postfilter_s: float = 0.0
    extenders_s: float = 0.0
    recorder_s: float = 0.0
    upload_bytes: int = 0            # every host→device byte of the cycle
    node_upload_bytes: int = 0       # of which the node block's delta
    resident_bytes: int = 0          # the resident node block's size
    rounds: int = 0                  # batched engine: rounds of the cycle
    pipelined: bool = False
    # the mesh the cycle ran on (() without one), each shard's share of the
    # node upload, and the mesh's cross-shard argmax probe (seconds)
    mesh_shape: tuple = ()
    shard_upload_bytes: list | None = None
    collective_wall_s: float | None = None
    # packing engine: the solve's iterations, objective and nodes used
    # (None on the other engines)
    solver_iters: int | None = None
    objective_value: float | None = None
    nodes_used: int | None = None

    @property
    def encode_s(self) -> float:
        """The whole host encode: stage 1 plus stage 2."""
        return self.pre_encode_s + self.finalize_s


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
    preemption_attempts: int = 0
    preemption_victims: int = 0
    # the gang lane: (engine, quorum→admitted seconds) of each group's
    # first admission (the reference's gang_admission_duration histogram),
    # and one podgroup.GroupCycleTiming a group cycle
    gang_admission: list = field(default_factory=list)
    group_cycles: list = field(default_factory=list)
    # pipelined cycles whose device result was discarded and recomputed
    # because cluster state changed under them (node update / foreign pod
    # event between launch and completion) — replay preserves exact serial
    # parity
    pipeline_replays: int = 0
    cycle_timings: list = field(default_factory=list)

    def note_preemption_attempt(self) -> None:
        self.preemption_attempts += 1

    def note_preemption_victims(self, n: int) -> None:
        self.preemption_victims += n


@dataclass
class _InflightCycle:
    """A launched-but-uncompleted scheduling cycle: the engine's work is
    queued on the device; the host holds everything needed to complete,
    apply and — if cluster state changed underneath — replay it."""

    profile: C.Profile
    batch_infos: list
    batch: "rt.EncodedBatch"
    # the batch the engine ran: ``batch.device`` with the extender verdicts
    # attached (``batch.device`` itself without extenders)
    device_batch: "rt.DeviceBatch"
    params: "rt.ScoreParams"
    assignments: Any                 # device tensor, fetched at completion
    final_state: tuple               # the engine's seven state slots
    cycle_id: int
    timing: CycleTiming
    nominator_version: int           # the nomination set the encode saw
    ns_gen: int                      # snapshot generations at launch
    vol_gen: int
    dra_gen: tuple                   # (DRA generation, claims version)
    # CUDA events around the engine's launch (None on the CPU, where the
    # engine ran synchronously inside the launch)
    started: Any = None
    done: Any = None
    # packing engine: the solve's (objective, nodes_used) device scalars
    # and its iterations, taken at launch (None on the other engines)
    solve: tuple | None = None


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
        encode_cache: bool = True,
        flight_recorder: bool = True,
        dispatcher_workers: int = 0,
        feature_gates=None,
        topology: str = "off",
        registry: "lc.Registry | None" = None,
    ) -> None:
        """``device``: where the cycle's device work runs — ``"cuda"``
        (default: the hand-written kernels) or ``"cpu"`` (the plain
        PyTorch versions). ``pipeline``: run the two-stage pipelined cycle
        (see the module docstring); assignments are pod-for-pod identical
        to the serial loop's. ``encode_cache``: event-time incremental pod
        encoding (``state.encode_cache.EncodeCache``) — static rows are
        template-keyed, built when the informer delivers the pod, and
        gathered at cycle time; cached encodes are bit-identical to fresh
        ones, so ``False`` is a debugging escape hatch. The node block is
        always device-resident. ``flight_recorder``: the scheduling flight
        recorder (``sched.flightrecorder``): a bounded ring of per-pod
        decision records with the cycle-start breakdown (the explain
        kernels, one launch per cycle); ``False`` is the overhead escape
        hatch and leaves decisions unchanged. ``cfg.extenders``: the
        scheduler-extender webhooks (``sched.extender``).
        ``feature_gates``: a FeatureGate or {name: bool} overrides
        (pkg/features defaults apply; unknown names fail loudly): with
        GenericWorkload and GangScheduling on, pods naming a
        ``scheduling_group`` take the gang lane, and with
        TopologyAwareWorkloadScheduling a group's topology constraint
        runs the placement search. ``topology``: ``"on"``, ``"off"`` or
        ``"auto"`` — active (not ``"off"``, and some node carries a
        slice or rack label) it attaches the dense coordinate block to
        every encoded batch: gang placement scores slice alignment, and
        preemption can evict one whole low-priority gang to admit an
        aligned one. ``registry``: the lifecycle plugin registry the
        profiles' ``lifecycle`` names resolve in (the in-tree
        VolumeBinding and DynamicResources by default); each profile is
        validated (``framework.validation.must_validate``) when its runner
        is built. The other arguments name features of later slices;
        anything but their default raises NotImplementedError."""
        if engine not in ("greedy", "batched", "packing"):
            raise ValueError(f"unknown engine {engine!r}")
        if dispatcher_workers:
            raise _not_ported("asynchronous binding", "Queue A item 13")
        if topology not in ("on", "off", "auto"):
            raise ValueError(f"unknown topology mode {topology!r}")
        if feature_gates is None or isinstance(feature_gates, dict):
            feature_gates = FeatureGate(feature_gates)
        self.feature_gates = feature_gates
        self.topology = topology
        self.client = client
        self.device = torch.device(device)
        self.cfg = cfg or C.SchedulerConfiguration()
        self.profile = profile or self.cfg.profile()
        # the profile Map (profile.go:46): pods select by spec.schedulerName.
        # A single explicit ``profile`` also answers for the default name so
        # plain pods keep scheduling under it (test/one-profile usage).
        if profile is not None:
            self.profiles: dict[str, C.Profile] = {profile.name: profile}
            self.profiles.setdefault("default-scheduler", profile)
        else:
            self.profiles = {p.name: p for p in self.cfg.profiles}
        # --- the mesh (parallel.mesh) -------------------------------------
        from ..parallel.mesh import measure_collective_wall, node_pad_multiple, resolve_mesh

        self.mesh = resolve_mesh(mesh, self.device)
        self.mesh_shape: tuple = self.mesh.shape if self.mesh is not None else ()
        # the padded node capacity is a multiple of the node shard count
        self._pad_multiple = 1 if self.mesh is None else node_pad_multiple(self.mesh)
        # the mesh's cross-shard argmax probe, once (kernel K4 on CUDA)
        self._collective_wall_s: float | None = (
            None if self.mesh is None else measure_collective_wall(self.mesh)
        )
        # the packing engine is stateful: it carries the warm-start dual
        # block and the objective-weight tensor across cycles, and keeps
        # the last solve's diagnostics
        self._packing = (PackingEngine(device=self.device, mesh=self.mesh)
                         if engine == "packing" else None)
        if self._packing is not None:
            self._assign_device = self._packing
        else:
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
        # the DRA PreEnqueue gate only applies when some profile runs the
        # plugin — otherwise the gating rejector would have no registered
        # queueing hints and a gated pod could never wake
        self._dra_enabled = N.DYNAMIC_RESOURCES in filters
        self.queue = PriorityQueue(
            hints=default_queueing_hints(filters),
            pre_enqueue=[self._scheduling_gates, self._dra_pre_enqueue],
            clock=clock,
            initial_backoff_seconds=self.cfg.pod_initial_backoff_seconds,
            max_backoff_seconds=self.cfg.pod_max_backoff_seconds,
        )
        self.metrics = SchedulerMetrics()
        # event-time incremental pod encoding (state.encode_cache): static
        # rows pre-built at informer delivery, template-shared across pods
        # and cycles; None = rebuild-per-batch (the escape hatch)
        self.encode_cache = EncodeCache() if encode_cache else None
        # per-profile (filter-set, score-set) frozensets for the per-event
        # pre-encode hook
        self._prof_sets: dict[int, tuple] = {}
        self._snapshot = Snapshot()
        # previous cycle's NodeTensors — encode_snapshot refreshes only the
        # rows whose generation moved (O(Δ) per-cycle host encode)
        self._prev_nt = None
        self.pipeline = bool(pipeline)
        # the device-resident node block serves the serial loop too: every
        # cycle completes before the next encode's dirty-row scatter writes
        # into it, so steady-state host→device node traffic is O(Δ·R) in
        # both modes
        self._resident = rt.ResidentNodeState(self.device, mesh=self.mesh)
        self._inflight: _InflightCycle | None = None
        # sticky: any host-state refresh between launch and completion that
        # found the cluster materially changed flips this; completion
        # replays
        self._inflight_stale = False
        # seconds of staleness refreshes since the last launch (the next
        # launch's CycleTiming.refresh_s)
        self._refresh_s = 0.0
        self._last_flush = 0.0
        # the DefaultPreemption PostFilter, set by enable_preemption
        self._post_filter: Any = None
        self.pdbs: dict[str, t.PodDisruptionBudget] = {}  # "ns/name" -> PDB
        # per-cycle context the PostFilter consumes: (batch, params,
        # final_state, key->batch-index). None outside a cycle.
        self._cycle_ctx: tuple | None = None
        # preemptor key -> victim uids awaiting their informer delete; while
        # any victim is still in the cache the pod is not eligible to
        # preempt again (PodEligibleToPreemptOthers' terminating-victims
        # check, default_preemption.go:364)
        self._preempting: dict[str, set[str]] = {}
        # nominated pods' reservations, fed into the fit and port filters
        # so lower-priority pods can't steal the room the victims freed
        self.nominator = Nominator()
        # scheduling flight recorder (see the flight_recorder docstring
        # above); None = off
        self.flight_recorder: "FlightRecorder | None" = (
            FlightRecorder() if flight_recorder else None
        )
        self.podgroups = PodGroupManager(
            clock,
            initial_backoff=self.cfg.pod_initial_backoff_seconds,
            max_backoff=self.cfg.pod_max_backoff_seconds,
        )
        self.extenders = [HTTPExtender(c) for c in self.cfg.extenders]
        self._extender_pool = None
        if self.extenders:
            # one long-lived worker pool for the per-cycle extender fan-out
            # (per-cycle executor construction was hot-path thread churn)
            self._extender_pool = ThreadPoolExecutor(
                max_workers=max(1, self.cfg.parallelism)
            )
        self.registry = registry if registry is not None else lc.default_registry()
        # loud config validation (apis/config/validation analog): a
        # malformed profile must never reach the hot loop
        self._lifecycles: dict[str, lc.LifecycleRunner] = {}
        built: dict[int, lc.LifecycleRunner] = {}
        for pname, prof in self.profiles.items():
            if id(prof) not in built:
                must_validate(prof, self.registry)
                built[id(prof)] = self.registry.build(
                    prof.lifecycle.names(), prof
                )
            self._lifecycles[pname] = built[id(prof)]
        # the default profile's runner (single-profile back-compat surface)
        self.lifecycle = self._lifecycles.get(
            "default-scheduler",
            next(iter(self._lifecycles.values())),
        )
        # permitted-with-Wait pods parked before binding (waitingPodsMap)
        self.waiting_pods: dict[str, lc.WaitingPod] = {}

    def enable_preemption(self) -> None:
        """Wire the DefaultPreemption PostFilter
        (plugins/defaultpreemption/default_preemption.go:136)."""
        from .preemption import DefaultPreemptionPostFilter

        self._post_filter = DefaultPreemptionPostFilter()

    # ------------------------------------------------------- PDB informers
    def on_pdb_add(self, pdb: t.PodDisruptionBudget) -> None:
        self.pdbs[f"{pdb.namespace}/{pdb.name}"] = pdb

    on_pdb_update = on_pdb_add

    def on_pdb_delete(self, pdb: t.PodDisruptionBudget) -> None:
        self.pdbs.pop(f"{pdb.namespace}/{pdb.name}", None)

    def warmup(self) -> None:
        """Build the kernels before the measured phase (on a CUDA device;
        a no-op on the CPU): the engines', and the recorder's explain
        kernels with them. The reference compiles its XLA programs, the
        explain program included, here."""
        if self.device.type == "cuda":
            from .. import kernels

            kernels.build()

    def _batched_assign(self, b: rt.DeviceBatch, params: rt.ScoreParams):
        """The batched engine, keeping the cycle's round count."""
        rounds: list = []
        out = batched_assign_device(b, params, rounds_out=rounds)
        self._rounds = rounds[0]
        return out

    # ------------------------------------------------------ event handlers
    # The informer seam (eventhandlers.go:455): assigned pods maintain the
    # cache; unscheduled pods maintain the queue; every event also feeds the
    # queueing hints so parked pods wake up.

    def _profile_for(self, pod: t.Pod) -> C.Profile | None:
        """frameworkForPod (schedule_one.go:532): None = not our pod."""
        return self.profiles.get(pod.scheduler_name)

    def _lifecycle_for(self, pod: t.Pod) -> lc.LifecycleRunner:
        return self._lifecycles.get(pod.scheduler_name, self.lifecycle)

    def _gang_member(self, pod: t.Pod) -> bool:
        """Is this pod routed through the gang lane? One predicate for
        EVERY routing decision (add/update/reject/bind-failure) — a pod
        must never be gang-routed on one path and queue-routed on another."""
        return bool(pod.scheduling_group) and self.feature_gates.enabled(
            "GangScheduling"
        )

    @staticmethod
    def _scheduling_gates(pod: t.Pod) -> str | None:
        """SchedulingGates PreEnqueue (plugins/schedulinggates): any
        non-empty spec.schedulingGates holds the pod out of the queue."""
        return N.SCHEDULING_GATES if pod.scheduling_gates else None

    def _dra_pre_enqueue(self, pod: t.Pod) -> str | None:
        """DynamicResources PreEnqueue (dynamicresources.go:270): every
        referenced ResourceClaim must exist before the pod may enter the
        active queue (template instances are created by the resourceclaim
        controller); a claim Add event re-runs this gate."""
        if not pod.resource_claims or not self._dra_enabled:
            return None
        claims = self.cache.dra.claims
        for rc in pod.resource_claims:
            if not rc.claim_name or f"{pod.namespace}/{rc.claim_name}" not in claims:
                return N.DYNAMIC_RESOURCES
        return None

    def on_node_add(self, node: t.Node) -> None:
        known = self.cache.has_node(node.name)
        self.cache.add_node(node)
        if self.encode_cache is not None:
            if known:
                # resync-duplicate Add REPLACES the node object (labels /
                # taints may differ at an interior index): full-epoch seam
                self.encode_cache.invalidate_nodes()
            else:
                # SCOPED invalidation: a genuine add appends to the node
                # axis, so the cache extends its rows with the new node's
                # columns at the next sync instead of flushing every
                # node-dependent store
                self.encode_cache.invalidate_nodes(added=node)
        self.queue.on_event(
            ClusterEvent(EventResource.NODE, ActionType.ADD), None, node
        )
        self.podgroups.wake_all()   # new capacity may fit a parked gang

    def on_node_update(self, old: t.Node | None, new: t.Node) -> None:
        self.cache.update_node(new)
        if self.encode_cache is not None:
            self.encode_cache.invalidate_nodes()
        ev = node_update_event(old, new)
        if ev.action:
            self.queue.on_event(ev, old, new)

    def on_node_delete(self, node: t.Node) -> None:
        self.cache.remove_node(node.name)
        if self.encode_cache is not None:
            # SCOPED invalidation: a drain-wave delete compacts cached rows
            # down to the surviving nodes' columns at the next sync instead
            # of flushing every node-dependent store
            self.encode_cache.invalidate_nodes(removed=node)
        self.queue.on_event(
            ClusterEvent(EventResource.NODE, ActionType.DELETE), node, None
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
        if pod.node_name:
            self.cache.add_pod(pod)
            if self._gang_member(pod):
                # a pre-bound member counts toward the gang quorum
                # (gangscheduling.go:82 AssignedPod/Add hint)
                self.podgroups.mark_scheduled(pod, pod.node_name)
            self.queue.on_event(
                ClusterEvent(EventResource.ASSIGNED_POD, ActionType.ADD),
                None, pod,
            )
        elif self._gang_member(pod):
            # gang member: held by the manager until quorum (the
            # GangScheduling PreEnqueue, gangscheduling.go:130). With the
            # gate off, group members schedule individually (the plugin is
            # simply not registered in the reference).
            self.podgroups.add_pod(QueuedPodInfo(pod=pod, timestamp=self.clock()))
        else:
            fr = self.flight_recorder
            t_deliver = time.perf_counter() if fr is not None else 0.0
            self.queue.add(pod)
            self._pre_encode_pod(pod)
            if fr is not None:
                # the informer stage: delivery wall incl. the event-time
                # pre-encode (the e2e base in direct mode)
                fr.note_delivery(
                    pod, t_deliver, time.perf_counter() - t_deliver
                )

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
                if self._gang_member(new):
                    self.podgroups.mark_scheduled(new, new.node_name)
                self.queue.on_event(
                    ClusterEvent(EventResource.ASSIGNED_POD, ActionType.ADD),
                    None, new,
                )
        elif self._gang_member(new):
            # unbound gang member: refresh the manager's copy — routing it
            # into the per-pod queue would bypass quorum gating and let the
            # pod double-schedule against its own group lane
            self.podgroups.update_pod(new)
        else:
            fr = self.flight_recorder
            t_deliver = time.perf_counter() if fr is not None else 0.0
            self.queue.update(old, new)
            # a mutated pod hashes to NEW signature keys — pre-build its
            # rows now; the per-uid signature memo is identity-checked, so
            # the old object's entries can never answer for the new one
            self._pre_encode_pod(new)
            if fr is not None:
                # a pod FIRST seen through an update still opens a flight;
                # for a known pod this only accrues informer-handling wall
                fr.note_delivery(
                    new, t_deliver, time.perf_counter() - t_deliver
                )

    def on_pod_delete(self, pod: t.Pod) -> None:
        if self.flight_recorder is not None:
            self.flight_recorder.drop(pod_key(pod))
        self.nominator.remove(pod.uid)
        if self.encode_cache is not None:
            self.encode_cache.drop_pod(pod.uid)
        # a preemptor deleted while awaiting victim deletes must not leave a
        # stale pending-victims record for a later same-ns/name pod
        self._preempting.pop(pod_key(pod), None)
        if pod.scheduling_group:
            self.podgroups.remove_pod(pod)
        wp = self.waiting_pods.pop(pod_key(pod), None)
        if wp is not None:
            # a deleted waiting pod unreserves; its assume drops below
            self._lifecycle_for(wp.pod).run_unreserve(self, wp.pod, wp.node_name)
        # has_pod covers BOUND pods too: a Delete event may carry a stale
        # object with node_name unset (cache.go:583 RemovePod's contract)
        if pod.node_name or self.cache.has_pod(pod.uid):
            self.cache.remove_pod(pod)
            self.queue.delete(pod)
            self.queue.on_event(
                ClusterEvent(EventResource.ASSIGNED_POD, ActionType.DELETE),
                pod, None,
            )
            self.podgroups.wake_all()   # freed capacity may fit a gang
        else:
            self.queue.delete(pod)

    # ---------------------------------------------------- PodGroup informers
    def on_pod_group_add(self, group: t.PodGroup) -> None:
        """scheduling/v1alpha3 PodGroup informer (gangscheduling.go:109:
        a PodGroup add can complete a waiting gang's quorum)."""
        self.podgroups.add_group(group)
        self.queue.on_event(
            ClusterEvent(EventResource.WORKLOAD, ActionType.ADD), None, group
        )

    on_pod_group_update = on_pod_group_add

    def on_pod_group_delete(self, group: t.PodGroup) -> None:
        self.podgroups.remove_group(group)

    # ------------------------------------------------------ volume informers
    def on_pv_add(self, pv: t.PersistentVolume) -> None:
        self.cache.add_pv(pv)
        self.queue.on_event(
            ClusterEvent(EventResource.PERSISTENT_VOLUME, ActionType.ADD),
            None, pv,
        )

    def on_pv_update(self, old, new: t.PersistentVolume) -> None:
        self.cache.update_pv(new)
        self.queue.on_event(
            ClusterEvent(EventResource.PERSISTENT_VOLUME, ActionType.UPDATE),
            old, new,
        )

    def on_pv_delete(self, pv: t.PersistentVolume) -> None:
        self.cache.remove_pv(pv.name)

    def on_pvc_add(self, pvc: t.PersistentVolumeClaim) -> None:
        self.cache.add_pvc(pvc)
        self.queue.on_event(
            ClusterEvent(EventResource.PERSISTENT_VOLUME_CLAIM, ActionType.ADD),
            None, pvc,
        )

    def on_pvc_update(self, old, new: t.PersistentVolumeClaim) -> None:
        self.cache.update_pvc(new)
        self.queue.on_event(
            ClusterEvent(EventResource.PERSISTENT_VOLUME_CLAIM, ActionType.UPDATE),
            old, new,
        )

    def on_pvc_delete(self, pvc: t.PersistentVolumeClaim) -> None:
        self.cache.remove_pvc(pvc.key)

    def on_storage_class_add(self, sc: t.StorageClass) -> None:
        self.cache.add_storage_class(sc)
        self.queue.on_event(
            ClusterEvent(EventResource.STORAGE_CLASS, ActionType.ADD),
            None, sc,
        )

    def on_storage_class_update(self, old, new: t.StorageClass) -> None:
        self.cache.update_storage_class(new)
        self.queue.on_event(
            ClusterEvent(EventResource.STORAGE_CLASS, ActionType.ADD),
            old, new,
        )

    def on_storage_class_delete(self, sc: t.StorageClass) -> None:
        self.cache.remove_storage_class(sc.name)

    # ------------------------------------------------------- DRA informers
    def on_resource_claim_add(self, claim: t.ResourceClaim) -> None:
        self.cache.dra.add_claim(claim)
        self.queue.on_event(
            ClusterEvent(EventResource.RESOURCE_CLAIM, ActionType.ADD),
            None, claim,
        )

    def on_resource_claim_update(self, old, new: t.ResourceClaim) -> None:
        self.cache.dra.add_claim(new)
        self.queue.on_event(
            ClusterEvent(EventResource.RESOURCE_CLAIM, ActionType.UPDATE),
            old, new,
        )

    def on_resource_claim_delete(self, claim: t.ResourceClaim) -> None:
        self.cache.dra.remove_claim(claim.key)
        self.queue.on_event(
            ClusterEvent(EventResource.RESOURCE_CLAIM, ActionType.DELETE),
            claim, None,
        )

    def on_resource_slice_add(self, sl: t.ResourceSlice) -> None:
        self.cache.dra.add_slice(sl)
        self.queue.on_event(
            ClusterEvent(EventResource.RESOURCE_SLICE, ActionType.ADD),
            None, sl,
        )

    def on_resource_slice_update(self, old, new: t.ResourceSlice) -> None:
        self.cache.dra.add_slice(new)
        self.queue.on_event(
            ClusterEvent(EventResource.RESOURCE_SLICE, ActionType.UPDATE),
            old, new,
        )

    def on_resource_slice_delete(self, sl: t.ResourceSlice) -> None:
        self.cache.dra.remove_slice(sl.name)

    def on_device_class_add(self, dc: t.DeviceClass) -> None:
        self.cache.dra.add_class(dc)
        self.queue.on_event(
            ClusterEvent(EventResource.DEVICE_CLASS, ActionType.ADD),
            None, dc,
        )

    def on_device_class_update(self, old, new: t.DeviceClass) -> None:
        self.cache.dra.add_class(new)
        self.queue.on_event(
            ClusterEvent(EventResource.DEVICE_CLASS, ActionType.UPDATE),
            old, new,
        )

    def on_device_class_delete(self, dc: t.DeviceClass) -> None:
        self.cache.dra.remove_class(dc.name)

    def _pre_encode_pod(self, pod: t.Pod) -> None:
        """Event-time tensorization (the informer half of the encode
        cache): build the pod's static rows while the delivery is being
        handled — OFF the scheduling cycle's critical path — so cycle-time
        ``encode_batch_static`` gathers instead of rebuilding. No-op when
        the cache is off, no cycle has established node tensors yet, or a
        node event invalidated them (the next cycle re-adopts)."""
        cache = self.encode_cache
        if cache is None or self._prev_nt is None:
            return
        prof = self._profile_for(pod)
        if prof is None:
            return
        sets = self._prof_sets.get(id(prof))
        if sets is None:
            sets = (
                frozenset(prof.filters.names()),
                frozenset(prof.scores.names()),
            )
            self._prof_sets[id(prof)] = sets
        try:
            cache.precompute_pod(self._prev_nt, pod, sets[0], sets[1])
        except Exception:
            # pre-encoding is an optimization; the cycle-time encode is the
            # correctness path and surfaces real bugs loudly
            pass

    # --------------------------------------------------------- batch cycle

    def schedule_batch(self, max_batch: int | None = None) -> dict[str, int]:
        """One scheduling cycle over up to ``max_batch`` pods. Returns result
        counts. The serial cycle: pop batch → snapshot → encode → upload →
        device assign → assume + bind → requeue failures. A mixed-profile
        batch runs one sub-cycle per profile.

        Pipeline mode returns the counts of the cycle that COMPLETED during
        this call (usually the batch launched by the previous call): pop
        the next batch → host-encode its stage 1 while the in-flight
        cycle's kernels run → complete and apply the in-flight cycle →
        stage 2 of the next batch → launch. The trailing call (pop empty,
        one cycle still in flight) drains the pipeline."""
        self._flush_timers()
        limit = max_batch or self.max_batch
        batch_infos = self._pop_cycle(limit)
        if not batch_infos:
            if self._inflight is not None:
                # pipeline drain: the queue emptied with one cycle on the
                # wing — complete it and report its results
                return self._complete_inflight()
            # group lane: ready gangs run when the per-pod lane is drained
            # (the reference interleaves group entities through the same
            # queue; the batch loop gives per-pod work priority per cycle)
            res = schedule_pod_groups(self, budget=limit)
            self.metrics.unschedulable += res["unschedulable"]
            return res
        if self.pipeline:
            return self._schedule_batch_pipelined(batch_infos, limit)
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

    def _schedule_batch_pipelined(
        self, batch_infos: list[QueuedPodInfo], limit: int
    ) -> dict[str, int]:
        """Advance the two-stage pipeline by one cycle (see schedule_batch).
        A mixed-profile pop falls back to the serial path for that call
        (after draining the pipeline) — profile partitions are rare and not
        worth a multi-way pipeline."""
        if self._inflight is None:
            # cold start: launch this batch, then pull the NEXT batch
            # forward so the pipeline is primed before this call returns —
            # the pulled batch falls through to the steady-state advance
            by_profile: dict[str, list[QueuedPodInfo]] = {}
            for info in batch_infos:
                by_profile.setdefault(info.pod.scheduler_name, []).append(info)
            if len(by_profile) > 1:
                return self._schedule_batch_serial(batch_infos)
            pname, infos = next(iter(by_profile.items()))
            self._inflight = self._launch_cycle(
                self.profiles[pname], infos, self.metrics.cycles
            )
            batch_infos = self._pop_cycle(limit)
            if not batch_infos:
                return self._complete_inflight()
        # steady-state advance: one cycle in flight, ``batch_infos`` next.
        by_profile = {}
        for info in batch_infos:
            by_profile.setdefault(info.pod.scheduler_name, []).append(info)
        if len(by_profile) > 1:
            res0 = self._complete_guarding(batch_infos)
            res = self._schedule_batch_serial(batch_infos)
            return {
                "scheduled": res0["scheduled"] + res["scheduled"],
                "unschedulable": res0["unschedulable"] + res["unschedulable"],
            }
        pname, infos = next(iter(by_profile.items()))
        profile = self.profiles[pname]
        cycle_id = self.metrics.cycles
        try:
            # stage 1 of this batch while the in-flight cycle runs on the
            # device, then complete it, then stage 2 + launch this one
            t_pre = time.perf_counter()
            static = self._pre_encode(profile, infos)
            pre_encode_s = time.perf_counter() - t_pre
            res = self._complete_inflight()
        except Exception:
            # a failure completing the PREVIOUS cycle must not strand the
            # freshly popped batch in the queue's in-flight set
            self._requeue_error(infos)
            raise
        # if this launch raises, its batch is requeued inside _launch_cycle
        # and the exception propagates — the completed cycle's counts (res)
        # are then unreportable, but its binds were already applied
        self._inflight = self._launch_cycle(
            profile, infos, cycle_id, static=static, pipelined=True,
            pre_encode_s=pre_encode_s,
        )
        return res

    def _complete_guarding(
        self, pending: list[QueuedPodInfo]
    ) -> dict[str, int]:
        """_complete_inflight, requeueing ``pending`` (a popped-but-not-yet-
        launched batch) as error status if the completion raises."""
        try:
            return self._complete_inflight()
        except Exception:
            self._requeue_error(pending)
            raise

    def _pre_encode(
        self, profile: C.Profile, batch_infos: list[QueuedPodInfo]
    ) -> "rt.StaticBatch | None":
        """Pipeline stage 1 for the NEXT batch, overlapping the in-flight
        cycle's kernels: refresh host state (which also diffs any informer
        deltas against the in-flight encode — see _refresh_host_state) and
        build the assume-independent half of the encode. Host work only:
        no CUDA call, so nothing here waits for the device. Returns None
        when the batch's encode is assume-coupled (volumes / DRA claims /
        nominations in play) or stage 1 failed — the launch then
        re-encodes from scratch."""
        self._refresh_host_state()
        pods = [info.pod for info in batch_infos]
        if self.nominator.entries() or any(
            p.volumes or p.resource_claims for p in pods
        ):
            return None
        try:
            sb = rt.encode_batch_static(
                self._snapshot, pods, profile, prev_nt=self._prev_nt,
                cache=self.encode_cache, topology=self.topology,
                pad_multiple=self._pad_multiple,
            )
        except Exception:
            # stage 1 is an optimization: any failure falls back to the
            # launch-time full encode (which surfaces real bugs loudly)
            return None
        self._prev_nt = sb.nt
        if sb.assume_coupled:
            return None
        return sb

    def _refresh_host_state(self) -> None:
        """Refresh snapshot + host node tensors and flag the in-flight cycle
        stale when the cluster MATERIALLY changed since its launch: a
        re-encoded row whose values differ (foreign pod add/delete), a
        pod-set content change (label/hostPort mutation feeding affinity/
        spread/port tensors without moving the rows), a replaced node
        object (labels/taints/images may differ), or a node set/order
        change (tensor rebuild). Bind confirmations of our own assumed
        pods re-encode to identical rows/content and do NOT flag."""
        self._snapshot = self.cache.update_snapshot(self._snapshot)
        nt = self._prev_nt
        if nt is None:
            return
        t0 = time.perf_counter()
        new_nt = encode_snapshot(
            self._snapshot, resource_names=nt.resource_names, pods=(),
            pad_nodes=nt.alloc.shape[0], prev=nt,
        )
        self._refresh_s += time.perf_counter() - t0
        if (
            new_nt is not nt
            or new_nt.last_values_changed
            or new_nt.last_nodes_replaced
            or new_nt.last_pods_mutated
        ):
            self._inflight_stale = True
        self._prev_nt = new_nt

    def _complete_inflight(self) -> dict[str, int]:
        """Complete the in-flight cycle and apply its results — or, when
        host state moved under it, discard the device result and replay the
        batch serially against fresh state (exactly what the serial loop
        would have computed), preserving pod-for-pod parity."""
        inflight = self._inflight
        self._inflight = None
        assert inflight is not None
        try:
            self._refresh_host_state()
        except Exception:
            # the in-flight batch must not be stranded by a refresh failure
            self._requeue_error(inflight.batch_infos)
            raise
        dra = self.cache.dra
        stale = (
            self._inflight_stale
            or self.nominator.version != inflight.nominator_version
            or self._snapshot.namespaces_generation != inflight.ns_gen
            or self._snapshot.volumes_generation != inflight.vol_gen
            or (dra.generation, dra.claims_version) != inflight.dra_gen
        )
        if stale:
            self.metrics.pipeline_replays += 1
            # the replay's refresh writes into the resident block: let the
            # stale cycle's kernels finish first (one stream orders them
            # anyway; the wait makes the rule explicit)
            if inflight.done is not None:
                inflight.done.synchronize()
            replay = self._launch_cycle(
                inflight.profile, inflight.batch_infos, inflight.cycle_id
            )
            return self._finish_cycle(replay)
        return self._finish_cycle(inflight)

    def _profile_cycle(
        self, profile: C.Profile, batch_infos: list[QueuedPodInfo]
    ) -> dict[str, int]:
        """Serial cycle: launch + complete back-to-back (the reference's
        fully serialized scheduling cycle)."""
        return self._finish_cycle(
            self._launch_cycle(profile, batch_infos, self.metrics.cycles)
        )

    def _launch_cycle(
        self,
        profile: C.Profile,
        batch_infos: list[QueuedPodInfo],
        cycle_id: int,
        static: "rt.StaticBatch | None" = None,
        pipelined: bool = False,
        pre_encode_s: float = 0.0,
    ) -> _InflightCycle:
        """Snapshot → encode (or finalize a pre-encoded StaticBatch, whose
        stage 1 took ``pre_encode_s``) → launch the assign engine. Does NOT
        wait for the device: on a CUDA device the engine's kernels are
        queued and a CUDA event marks their end; ``_finish_cycle``
        waits on it."""
        try:
            t_snap = time.perf_counter()
            self._snapshot = self.cache.update_snapshot(self._snapshot)
            pods = [info.pod for info in batch_infos]
            t_enc = time.perf_counter()
            batch = None
            if static is not None:
                batch = self._finalize_static(static)
                nodes_s = static.nodes_s
            if batch is None:
                nominated = self.nominator.entries()
                sb = rt.encode_batch_static(
                    self._snapshot, pods, profile, nominated=nominated,
                    prev_nt=self._prev_nt, cache=self.encode_cache,
                    track_changes=self.pipeline, topology=self.topology,
                    pad_multiple=self._pad_multiple,
                )
                t_fin = time.perf_counter()
                pre_encode_s, nodes_s = t_fin - t_enc, sb.nodes_s
                batch = rt.finalize_batch(
                    sb, self._snapshot, nominated=nominated,
                    resident=self._resident, device=self.device,
                )
            else:
                t_fin = t_enc
            stage2_s = time.perf_counter() - t_fin
            self._prev_nt = batch.node_tensors
            t_ext = time.perf_counter()
            device_batch, ext_bytes = self._apply_extenders(batch, pods)
            extenders_s = time.perf_counter() - t_ext
            params = rt.score_params(profile, batch.resource_names)
            started = done = None
            if self.device.type == "cuda":
                started = torch.cuda.Event(enable_timing=True)
                done = torch.cuda.Event(enable_timing=True)
                started.record()
            t_dev = time.perf_counter()
            assignments, final_state = self._assign_device(device_batch, params)
            if done is not None:
                done.record()
            solve = None
            if self._packing is not None:
                eng = self._packing
                solve = (eng.last_objective, eng.last_nodes_used, eng.last_iters)
            timing = CycleTiming(
                cycle=cycle_id, pods=len(batch_infos),
                snapshot_s=t_enc - t_snap, pre_encode_s=pre_encode_s,
                finalize_s=stage2_s - batch.upload_s, upload_s=batch.upload_s,
                # on the CPU the engine ran synchronously just now
                kernel_s=time.perf_counter() - t_dev if done is None else 0.0,
                nodes_s=nodes_s, refresh_s=self._refresh_s,
                extenders_s=extenders_s,
                upload_bytes=batch.upload_bytes + ext_bytes,
                node_upload_bytes=batch.node_upload_bytes,
                resident_bytes=batch.resident_bytes,
                rounds=self._rounds if self.engine == "batched" else 0,
                pipelined=pipelined,
                mesh_shape=self.mesh_shape,
                shard_upload_bytes=(
                    list(self._resident.last_upload_bytes_per_shard)
                    if self.mesh is not None else None
                ),
                collective_wall_s=self._collective_wall_s,
            )
            # everything the launched work saw is now folded in; any LATER
            # host-state refresh that finds changes flips this
            self._inflight_stale = False
            self._refresh_s = 0.0
            return _InflightCycle(
                profile=profile, batch_infos=batch_infos, batch=batch,
                device_batch=device_batch, params=params,
                assignments=assignments,
                final_state=final_state, cycle_id=cycle_id, timing=timing,
                nominator_version=self.nominator.version,
                ns_gen=self._snapshot.namespaces_generation,
                vol_gen=self._snapshot.volumes_generation,
                dra_gen=(self.cache.dra.generation, self.cache.dra.claims_version),
                started=started, done=done, solve=solve,
            )
        except Exception:
            self._requeue_error(batch_infos)
            raise

    def _finalize_static(
        self, static: "rt.StaticBatch"
    ) -> "rt.EncodedBatch | None":
        """Pipeline stage 2: patch a pre-encoded StaticBatch against the
        post-assume cluster state. None = unusable (fall back to a full
        encode)."""
        if self.nominator.entries():
            # nominations appeared after stage 1: the port vocabulary /
            # folded charges may not cover them — re-encode
            return None
        t0 = time.perf_counter()
        fresh = rt.refresh_static(static, self._snapshot)
        self._refresh_s += time.perf_counter() - t0
        if not fresh:
            return None
        try:
            return rt.finalize_batch(
                static, self._snapshot, resident=self._resident,
                device=self.device,
            )
        except rt.StaleStaticEncode:
            return None

    def _finish_cycle(self, inflight: _InflightCycle) -> dict[str, int]:
        """Wait for the device result and run the host half of the cycle:
        assume + bind, failure handling."""
        batch_infos = inflight.batch_infos
        batch = inflight.batch
        timing = inflight.timing
        try:
            t_wait = time.perf_counter()
            if inflight.done is not None:
                inflight.done.synchronize()
                timing.kernel_s = inflight.started.elapsed_time(inflight.done) / 1e3
            if inflight.solve is None:
                idx = inflight.assignments.cpu().numpy()
            else:
                idx = self._fetch_solve(inflight)
            timing.wait_s = time.perf_counter() - t_wait
            if self.flight_recorder is not None:
                # one decision record per pod, with the cycle-start
                # score/filter breakdown; an explain error propagates (the
                # recorder's module docstring)
                t_rec = time.perf_counter()
                self.flight_recorder.note_cycle(
                    batch=batch,
                    device_batch=inflight.device_batch,
                    params=inflight.params,
                    batch_infos=batch_infos,
                    idx=idx,
                    cycle_id=inflight.cycle_id,
                    profile=inflight.profile.name,
                    encode_s=timing.encode_s,
                    kernel_s=timing.kernel_s,
                    engine=self.engine,
                    objective_value=timing.objective_value,
                    solver_iters=timing.solver_iters,
                    assignments=inflight.assignments,
                    # the sharded batch is not re-evaluated for diagnostics
                    breakdown=self.mesh is None,
                    skipped_reason=None if self.mesh is None else "mesh",
                )
                timing.recorder_s = time.perf_counter() - t_rec
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
                # a Reserve/Permit rejection already requeued the pod
            else:
                failed.append(info)
        timing.bind_s = time.perf_counter() - t_bind
        self.metrics.cycle_timings.append(timing)
        self.metrics.scheduled += scheduled
        self.metrics.unschedulable += len(failed)
        self._cycle_ctx = (
            batch, inflight.params, inflight.final_state,
            {info.key: k for k, info in enumerate(batch_infos)},
        )
        t_post = time.perf_counter()
        try:
            for info in failed:
                self._handle_unschedulable(info, inflight.profile)
        finally:
            # drop the cycle's batch (device tensors + host snapshot
            # encoding) so it doesn't pin memory across cycles
            self._cycle_ctx = None
            if self._post_filter is not None:
                self._post_filter.reset()
            timing.postfilter_s = time.perf_counter() - t_post
        return {"scheduled": scheduled, "unschedulable": len(failed)}

    @staticmethod
    def _fetch_solve(inflight: _InflightCycle):
        """The packing cycle's assignments, with its objective and nodes
        used, in one device→host copy; the three diagnostics go on the
        cycle's ``CycleTiming``. A fault in the solve propagates."""
        objective, nodes_used, iters = inflight.solve
        packed = torch.cat([
            inflight.assignments.to(torch.int32),
            nodes_used.reshape(1).to(torch.int32),
            objective.reshape(1).view(torch.int32),
        ]).cpu()
        timing = inflight.timing
        timing.solver_iters = int(iters)
        timing.nodes_used = int(packed[-2])
        timing.objective_value = float(packed[-1:].view(torch.float32)[0])
        return packed[:-2].numpy()

    def _assume_and_bind(self, info: QueuedPodInfo, node_name: str) -> bool:
        """assumeAndReserve + Permit + the binding cycle (schedule_one.go:307
        assumeAndReserve, :211 RunPermitPlugins, :391 bindingCycle), run
        inline as the reference runs it with ``dispatcher_workers=0``.
        Returns False when a Reserve/Permit plugin rejected the pod (it was
        forgotten and requeued). A pod parked by Permit, or whose bind was
        attempted, counts as scheduled whatever the bind's outcome, as in
        the reference, which learns that outcome after the cycle."""
        assumed = info.pod.with_node(node_name)
        self.cache.assume_pod(assumed)
        info.cycle_id = self.metrics.cycles
        # a scheduled pod's nomination (if any) is spent
        self.nominator.remove(info.pod.uid)
        self._preempting.pop(info.key, None)
        return self._begin_binding(info, assumed)

    def _begin_binding(self, info: QueuedPodInfo, assumed: t.Pod) -> bool:
        """Reserve → Permit → bind (or park as a waiting pod). Shared by
        the per-pod batch and the pod-group lane. Returns False when a
        Reserve/Permit plugin rejected the pod (it was forgotten and
        requeued); a bind that was attempted returns True whatever its
        outcome, as the reference's dispatch does."""
        node_name = assumed.node_name
        lifecycle = self._lifecycle_for(info.pod)
        if not (lifecycle and lifecycle.engages(info.pod)):
            # no plugin does anything for this pod: skip every point
            self._bind(info, assumed, None)
            return True
        st = lifecycle.run_reserve(self, info.pod, node_name)
        if not st.ok:
            lifecycle.run_unreserve(self, info.pod, node_name)
            self._reject_assumed(info, assumed, st)
            return False
        st, pending, deadline = lifecycle.run_permit(
            self, info.pod, node_name, self.clock()
        )
        if st.code == lc.WAIT:
            self.waiting_pods[info.key] = lc.WaitingPod(
                pod=info.pod, node_name=node_name, info=info,
                pending=pending, deadline=deadline,
            )
            return True
        if not st.ok:
            lifecycle.run_unreserve(self, info.pod, node_name)
            self._reject_assumed(info, assumed, st)
            return False
        self._bind(info, assumed, lifecycle)
        return True

    def _bind(
        self, info: QueuedPodInfo, assumed: t.Pod,
        lifecycle: "lc.LifecycleRunner | None",
    ) -> None:
        """The binding cycle: PreBind → bind → PostBind (the reference's
        BindCall.execute), then its completion (``_drain_bind_completions``):
        on success the assume is confirmed; a PreBind failure or a bind
        error forgets the assume, runs Unreserve and requeues the pod as
        error status (handleSchedulingFailure, schedule_one.go:1190).
        ``lifecycle`` is None for a pod that no plugin engages."""
        node_name = assumed.node_name
        # an interested binder extender owns the bind API call
        # (schedule_one.go:1142 bind → extendersBinding)
        bind_fn = self.client.bind
        for e in self.extenders:
            if e.is_binder() and e.is_interested(info.pod):
                bind_fn = e.bind
                break
        fr = self.flight_recorder
        t_dispatch = time.perf_counter()
        try:
            if lifecycle is not None:
                st = lifecycle.run_pre_bind(self, info.pod, node_name)
                if not st.ok:
                    raise RuntimeError(
                        f"PreBind {st.plugin}: {st.reason or st.code}"
                    )
            bind_fn(info.pod, node_name)
            if lifecycle is not None:
                lifecycle.run_post_bind(self, info.pod, node_name)
        except Exception as err:
            if fr is not None:
                fr.note_bind(info, err, t_dispatch, t_dispatch,
                             time.perf_counter())
            self.metrics.bind_errors += 1
            self.metrics.errors += 1
            self.cache.forget_pod(assumed)
            # binding-cycle failure runs Unreserve (schedule_one.go:391
            # bindingCycle's deferred unreserve-on-failure)
            if lifecycle is not None:
                lifecycle.run_unreserve(self, info.pod, node_name)
            if self._gang_member(info.pod):
                # gang member: hand back to the group manager (it never
                # lived in the per-pod queue)
                self.podgroups.unmark_scheduled(info.pod)
                self.podgroups.requeue_member(info)
                return
            where = self.queue.add_unschedulable(info, error=True)
            if fr is not None:
                fr.note_requeue(info.key, where, error=True)
            return
        if fr is not None:
            fr.note_bind(info, None, t_dispatch, t_dispatch, time.perf_counter())
        self.cache.finish_binding(assumed.uid)
        self.queue.done(info.key)

    def _reject_assumed(self, info: QueuedPodInfo, assumed: t.Pod, st) -> None:
        """A Reserve/Permit rejection (or permit timeout): forget the assume
        and requeue — handleSchedulingFailure for the binding-path statuses."""
        self.cache.forget_pod(assumed)
        self.metrics.unschedulable += 1
        if self._gang_member(info.pod):
            self.podgroups.unmark_scheduled(info.pod)
            self.podgroups.requeue_member(info)
        else:
            where = self.queue.add_unschedulable(
                info, [st.plugin] if st.plugin else ()
            )
            if self.flight_recorder is not None:
                self.flight_recorder.note_requeue(
                    info.key, where, [st.plugin] if st.plugin else (),
                )

    # ---------------------------------------------------------- waiting pods
    def get_waiting_pod(self, key: str):
        """fwk.Handle.GetWaitingPod — Permit plugins allow/reject through
        the returned WaitingPod; verdicts take effect next cycle."""
        return self.waiting_pods.get(key)

    def iterate_waiting_pods(self):
        return list(self.waiting_pods.values())

    def _drain_waiting_pods(self) -> None:
        """Move decided waiting pods onward; time out the overdue (the
        reference rejects on permit timeout, frameworkImpl.WaitOnPermit)."""
        now = self.clock()
        for key in list(self.waiting_pods):
            wp = self.waiting_pods[key]
            if wp.rejected is None and wp.pending and now >= wp.deadline:
                wp.rejected = lc.Status(
                    lc.UNSCHEDULABLE, "permit wait timed out",
                    next(iter(sorted(wp.pending))),
                )
            if not wp.decided:
                continue
            del self.waiting_pods[key]
            assumed = wp.pod.with_node(wp.node_name)
            lifecycle = self._lifecycle_for(wp.pod)
            if wp.rejected is not None:
                lifecycle.run_unreserve(self, wp.pod, wp.node_name)
                self._reject_assumed(wp.info, assumed, wp.rejected)
            else:
                self._bind(wp.info, assumed, lifecycle)

    def _handle_unschedulable(
        self, info: QueuedPodInfo, profile: C.Profile | None = None
    ) -> None:
        """No feasible node. Run PostFilter (preemption) if wired, then
        requeue with rejector plugins for the queueing hints.

        Rejector attribution is conservative: every enabled Filter plugin is
        recorded (the reference records the plugins that actually rejected
        per node, schedule_one.go FitError) — over-eager wake-ups are safe;
        the leftover flush bounds staleness either way."""
        profile = profile or self._profile_for(info.pod) or self.profile
        fr = self.flight_recorder
        if self._post_filter is not None:
            nominated = self._post_filter(self, info)
            if nominated is not None:
                # preemption nominated a node: victims' deletes will fire
                # hints; pod waits in backoff for the room to open
                info.nominated_node_name = nominated
                where = self.queue.add_unschedulable(
                    info, profile.filters.names()
                )
                if fr is not None:
                    fr.note_requeue(
                        info.key, where, profile.filters.names(),
                        nominated=nominated,
                    )
                    fr.note_preemption(
                        info.key, nominated,
                        self._preempting.get(info.key, ()),
                    )
                return
        where = self.queue.add_unschedulable(info, profile.filters.names())
        if fr is not None:
            fr.note_requeue(info.key, where, profile.filters.names())
        if where not in ("deleted", "already-queued"):
            # only patch status for pods that still exist and we own
            self.client.patch_status(info.pod, "Unschedulable")

    def _encode_group(
        self, profile: C.Profile, pods: list
    ) -> "tuple[rt.EncodedBatch, rt.DeviceBatch, rt.ScoreParams]":
        """The gang lane's encode of one group cycle's pods, on the per-pod
        cycle's terms (the resident node block, the encode cache, the
        nominations, the topology mode), with the extender verdicts
        attached. Under a mesh the group batch is unsharded, on the mesh's
        first device, as the reference's group cycles encode it
        (``kubetpu/sched/podgroup.py:409``): the node block shipped whole,
        no encode cache, the node capacity padded without the mesh's
        multiple; the rows it dirties stay pending for the sharded
        resident block, which diffs against what it last shipped. Returns
        ``(batch, device_batch, params)``."""
        where = (dict(resident=self._resident, cache=self.encode_cache,
                      track_changes=self.pipeline, device=self.device)
                 if self.mesh is None else dict(device=self.mesh.devices[0]))
        batch = rt.encode_batch(
            self._snapshot, pods, profile,
            nominated=self.nominator.entries(), prev_nt=self._prev_nt,
            topology=self.topology, **where,
        )
        self._prev_nt = batch.node_tensors
        params = rt.score_params(profile, batch.resource_names)
        device_batch, _ = self._apply_extenders(batch, pods)
        return batch, device_batch, params

    def _apply_extenders(
        self, batch: "rt.EncodedBatch", pods: list
    ) -> "tuple[rt.DeviceBatch, int]":
        """Run the configured extender webhooks for the batch and attach
        their (P, N) mask/score to the device batch (findNodesThatPass
        Extenders + extender Prioritize — sched/extender.py), shipped in one
        host→device copy of their own. Returns the device batch and the
        bytes shipped (0 without extenders)."""
        device_batch = batch.device
        if not self.extenders:
            return device_batch, 0
        ext_mask, ext_score = run_extenders(
            self.extenders, pods, batch.node_names,
            batch.num_nodes,
            pad_pods=device_batch.requests.shape[0],
            pad_nodes=batch.node_tensors.alloc.shape[0],
            parallelism=self.cfg.parallelism,
            executor=self._extender_pool,
        )
        if ext_mask is None:
            return device_batch, 0
        if isinstance(device_batch, ShardedBatch):
            ext = {k: torch.from_numpy(v) for k, v in
                   dict(extender_mask=ext_mask, extender_score=ext_score).items()}
            return (
                device_batch.replace_pod_node(**ext),
                int(ext_mask.nbytes + ext_score.nbytes),
            )
        leaves = rt.upload_packed(
            dict(extender_mask=ext_mask, extender_score=ext_score), device_batch.device
        )
        return (
            dataclasses.replace(device_batch, **leaves),
            int(ext_mask.nbytes + ext_score.nbytes),
        )

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
        if self.waiting_pods:
            self._drain_waiting_pods()

    def run_until_idle(self, max_cycles: int = 10000) -> int:
        """Drive cycles until no pod is ready (harness/test mode). Returns
        total scheduled."""
        total = 0
        for _ in range(max_cycles):
            res = self.schedule_batch()
            total += res["scheduled"]
            if res["scheduled"] == 0 and res["unschedulable"] == 0:
                break
        if self._inflight is not None:
            # a batch whose pods all Reserve-rejected reports zeros while a
            # cycle is still on the wing — drain it before declaring idle
            total += self._complete_inflight()["scheduled"]
        return total

    def close(self) -> None:
        """Complete a cycle still in flight and stop the extender pool."""
        if self._inflight is not None:
            self._complete_inflight()
        if self._extender_pool is not None:
            self._extender_pool.shutdown(wait=False)
