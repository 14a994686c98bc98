"""scheduler_perf runner — drive the port's scheduler loop through an op list.

Reduced fork of ``kubetpu/perf/runner.py``: the direct mode only (no HTTP
apiserver, no federation), for the ops of the slice's workloads, churn,
the gang ops and the volume and DRA ops included. The op lists drive the
port's ``Scheduler`` through its informer seam, as the reference's direct
mode drives kubetpu's, with preemption enabled as there. The client keeps
the claim-status writes DynamicResources' PreBind sends it
(``update_claim_status``; the reference's direct-mode client has none, so
its PreBind writes nothing there), and the measured phase's warmup builds
the kernels only: the reference's warmup pods (and, on the DRA case, their
claims, which it adds to the index) have no counterpart.

Throughput definition: measured-phase scheduled pods / measured-phase wall
seconds — the average the reference's threshold selector asserts on
(scheduler_perf.go:352-359 "SchedulingThroughput / Average").
"""

from __future__ import annotations

import collections
import gc
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from ..api import types as t
from ..api.wrappers import make_pod, make_pod_group
from ..framework import config as C
from ..sched.scheduler import Scheduler
from . import workloads as W


@dataclass
class WorkloadResult:
    case_name: str
    workload_name: str
    threshold: float | None
    device: str                       # where the device work ran
    measure_pods: int
    scheduled: int                    # measured pods bound in the window
    duration_s: float
    throughput: float                 # pods/s, the SchedulingThroughput avg
    attempts: int
    cycles: int
    bound_total: int = 0              # every pod bound over the run
    # mean wall ms per measured cycle of each region (Scheduler.CycleTiming)
    cycle_ms: dict = field(default_factory=dict)
    upload_bytes_per_cycle: float = 0.0
    # of which the node block's delta, and the resident block's size
    node_upload_bytes_per_cycle: float = 0.0
    resident_bytes: int = 0
    engine: str = "greedy"
    # batched engine: mean rounds per measured cycle (0 on greedy)
    rounds_per_cycle: float = 0.0
    pipeline: bool = False
    # measured-phase pipelined cycles replayed for parity
    pipeline_replays: int = 0
    # measured-phase encode-cache hit rate over filter, score and request
    # rows (None with the cache off or no lookup)
    encode_cache_hit_rate: float | None = None
    # seconds the garbage collector ran inside the measured phase, and its
    # full (generation 2) collections there
    gc_s: float = 0.0
    gc_full_collections: int = 0
    # measured-phase PostFilter runs, their victims, and the runs that
    # nominated a node
    preemption_attempts: int = 0
    preemption_victims: int = 0
    preemptions: int = 0
    # measured-phase dry runs (PreemptionEvaluator.preempt calls past the
    # policy gate) and their mean ms a call: upload, potential mask, dry
    # run, fetch
    preempt_calls: int = 0
    preempt_ms: dict = field(default_factory=dict)
    # measured-phase group cycles of the gang lane (Scheduler.metrics.
    # group_cycles), their mean hypotheses (placements) a cycle and mean ms
    # a cycle: encode, device call, whole cycle
    group_cycles: int = 0
    hypotheses_per_cycle: float = 0.0
    group_cycle_ms: dict = field(default_factory=dict)
    # the packing frontier (``_packing_stats``): distinct nodes carrying the
    # measured pods at the end, the bound share of the measured pods with
    # priority > 0, the mean solver iterations a measured cycle (packing
    # engine only), and the packing weights behind the run
    nodes_used_at_steady_state: int | None = None
    priority_slo_hit_rate: float | None = None
    solver_iters_per_cycle: float | None = None
    packing_weights: dict | None = None
    # the node-axis mesh the run was sharded over (``_mesh_stats``): its
    # shard count, shape (() without one) and cross-shard argmax probe
    n_devices: int = 1
    mesh_shape: tuple = ()
    collective_wall_s: float | None = None

    def to_json(self) -> dict:
        out = {
            "case": self.case_name, "workload": self.workload_name,
            "device": self.device, "measure_pods": self.measure_pods,
            "scheduled": self.scheduled, "bound_total": self.bound_total,
            "duration_s": self.duration_s, "pods_per_s": self.throughput,
            "threshold": self.threshold, "attempts": self.attempts,
            "cycles": self.cycles, "cycle_ms": self.cycle_ms,
            "upload_bytes_per_cycle": self.upload_bytes_per_cycle,
            "node_upload_bytes_per_cycle": self.node_upload_bytes_per_cycle,
            "resident_bytes": self.resident_bytes,
            "engine": self.engine, "rounds_per_cycle": self.rounds_per_cycle,
            "pipeline": self.pipeline,
            "pipeline_replays": self.pipeline_replays,
            "encode_cache_hit_rate": self.encode_cache_hit_rate,
            "gc_s": self.gc_s, "gc_full_collections": self.gc_full_collections,
            "preemption_attempts": self.preemption_attempts,
            "preemption_victims": self.preemption_victims,
            "preemptions": self.preemptions,
            "preempt_calls": self.preempt_calls, "preempt_ms": self.preempt_ms,
            "group_cycles": self.group_cycles,
            "hypotheses_per_cycle": self.hypotheses_per_cycle,
            "group_cycle_ms": self.group_cycle_ms,
        }
        if self.nodes_used_at_steady_state is not None:
            out["nodes_used_at_steady_state"] = self.nodes_used_at_steady_state
        if self.priority_slo_hit_rate is not None:
            out["priority_slo_hit_rate"] = round(self.priority_slo_hit_rate, 4)
        if self.solver_iters_per_cycle is not None:
            out["solver_iters_per_cycle"] = round(self.solver_iters_per_cycle, 2)
        if self.packing_weights is not None:
            out["packing_weights"] = self.packing_weights
        if self.mesh_shape:
            out["n_devices"] = self.n_devices
            out["mesh_shape"] = list(self.mesh_shape)
            if self.collective_wall_s is not None:
                out["collective_wall_s"] = self.collective_wall_s
        return out


def _mesh_stats(sched: Scheduler) -> dict:
    """The run's mesh context (the reference's ``_mesh_stats``): shard
    count, shape and the cross-shard argmax probe's seconds."""
    n = 1
    for d in sched.mesh_shape:
        n *= d
    return dict(n_devices=n, mesh_shape=sched.mesh_shape,
                collective_wall_s=sched._collective_wall_s)


class _GcClock:
    """While entered: the seconds the garbage collector runs and its full
    (generation 2) collections, through ``gc.callbacks``."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self.full = 0
        self._t0: float | None = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self.full += info["generation"] == 2
            self._t0 = None

    def __enter__(self) -> "_GcClock":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)


class _Client:
    """API-server stand-in: binds and victim deletes land here and feed the
    informer handlers back on the loop thread via a pending queue (the
    watch-event delivery the reference gets from the apiserver). It also
    keeps every delete (with its reason), nomination, claim-status write
    and PVC bind it was sent."""

    def __init__(self) -> None:
        self.sched: Scheduler | None = None
        self.bound: list[tuple[str, str]] = []
        self._events: collections.deque = collections.deque()
        # bind-time counts per namespace: the throughput collector's view
        # (scheduler_perf measures SchedulingThroughput at bind, scoped to
        # the measured op's pods — churn/preemption traffic must not count)
        self.bound_by_ns: collections.Counter = collections.Counter()
        self.deleted: list[tuple[t.Pod, str]] = []
        self.nominated: list[tuple[t.Pod, str]] = []
        # DynamicResources PreBind's claim-status writes (the claim with its
        # allocation and reservedFor entry) and VolumeBinding PreBind's
        # PVC binds, in order
        self.claim_status: list[t.ResourceClaim] = []
        self.pvc_binds: list[tuple[str, str]] = []

    def bind(self, pod: t.Pod, node_name: str) -> None:
        self.bound.append((pod.name, node_name))
        self.bound_by_ns[pod.namespace] += 1
        self._events.append(("update", pod, pod.with_node(node_name)))

    def delete_pod(self, pod: t.Pod, reason: str = "") -> None:
        self.deleted.append((pod, reason))
        self._events.append(("delete", pod, None))

    def patch_status(self, pod: t.Pod, reason: str, message: str = "") -> None:
        pass

    def nominate(self, pod: t.Pod, node_name: str) -> None:
        self.nominated.append((pod, node_name))

    def update_claim_status(self, claim: t.ResourceClaim) -> None:
        self.claim_status.append(claim)

    def bind_pvc(self, pvc: t.PersistentVolumeClaim, pv_name: str) -> None:
        self.pvc_binds.append((pvc.key, pv_name))

    def deliver(self) -> None:
        """Drain informer events on the loop thread."""
        while self._events:
            kind, a, b = self._events.popleft()
            if kind == "update":
                self.sched.on_pod_update(a, b)
            else:
                self.sched.on_pod_delete(a)


@dataclass
class _Churn:
    op: W.ChurnOp
    namespace: str
    next_at: float = 0.0
    seq: int = 0
    live: list = field(default_factory=list)   # recreate-mode pool

    def maybe_fire(self, sched: Scheduler, now: float) -> None:
        while now >= self.next_at:
            self.next_at = (self.next_at or now) + self.op.interval_ms / 1000.0
            if self.op.mode == "recreate" and self.op.number and (
                len(self.live) >= self.op.number
            ):
                victim = self.live.pop(0)
                sched.on_pod_delete(victim)
            pod = self.op.template(f"churn-{self.seq}", self.namespace)
            self.seq += 1
            sched.on_pod_add(pod)
            if self.op.mode == "recreate":
                self.live.append(pod)


def _preemption_counts(sched, client) -> dict:
    """PostFilter attempts, victims, nominations, dry runs and the dry
    runs' span seconds (``PreemptionEvaluator.spans``) so far."""
    pf = sched._post_filter
    return {
        "attempts": sched.metrics.preemption_attempts,
        "victims": sched.metrics.preemption_victims,
        "nominations": len(client.nominated), "calls": pf.calls, **pf.spans,
    }


def _packing_stats(sched, timings: list, bound, created) -> dict:
    """The packing frontier, engine-agnostic (copy of the reference's
    ``_packing_stats``):

    - ``nodes_used_at_steady_state``: distinct nodes carrying the measured
      pods (name prefix ``measure-``) at the end of the run;
    - ``priority_slo_hit_rate``: among measured pods created with priority
      > 0, the fraction that bound (None without priority tiers);
    - ``solver_iters_per_cycle``: mean packing-solver iterations over the
      measured cycles (``CycleTiming.solver_iters``; None on the greedy and
      batched engines, which never set it);
    - ``packing_weights``: the weights behind the run.

    ``bound`` is an iterable of (pod_name, node_name); ``created`` of the
    created Pods."""
    bound = list(bound)
    measured_nodes = {node for name, node in bound if name.startswith("measure-")}
    out: dict = dict(
        nodes_used_at_steady_state=len(measured_nodes) if measured_nodes else None,
        priority_slo_hit_rate=None,
        solver_iters_per_cycle=None,
        packing_weights=None,
    )
    bound_names = {name for name, _ in bound}
    high = [p for p in created if p.priority > 0 and p.name.startswith("measure-")]
    if high:
        out["priority_slo_hit_rate"] = (
            sum(1 for p in high if p.name in bound_names) / len(high))
    iters = [c.solver_iters for c in timings if c.solver_iters is not None]
    if iters:
        out["solver_iters_per_cycle"] = sum(iters) / len(iters)
    if sched._packing is not None:
        out["packing_weights"] = sched._packing.weights.to_json()
    return out


def _cycle_ms(timings: list) -> dict:
    if not timings:
        return {}
    n = len(timings)
    return {
        region: 1e3 * sum(getattr(c, region + "_s") for c in timings) / n
        for region in ("snapshot", "pre_encode", "finalize", "encode",
                       "nodes", "refresh", "upload", "kernel", "wait", "bind",
                       "postfilter", "extenders", "recorder")
    }


def _group_cycle_ms(timings: list) -> dict:
    if not timings:
        return {}
    n = len(timings)
    return {
        region: 1e3 * sum(getattr(c, region + "_s") for c in timings) / n
        for region in ("encode", "device", "total")
    }


_CACHE_KINDS = ("filter", "score", "request")


def _cache_counts(sched) -> tuple[int, int]:
    """(hits, misses) of the scheduler's encode cache over its row kinds."""
    ec = sched.encode_cache
    if ec is None:
        return 0, 0
    return (sum(ec.hits[k] for k in _CACHE_KINDS),
            sum(ec.misses[k] for k in _CACHE_KINDS))


def run_workload(
    case: W.TestCase | str,
    workload: W.Workload | str,
    device="cuda",
    max_batch: int = 1024,
    engine: str = "greedy",
    profile: C.Profile | None = None,
    timeout_s: float = 1800.0,
    stall_s: float = 15.0,
    on_scheduler: Callable[[Scheduler], None] | None = None,
    pipeline: bool = False,
    encode_cache: bool = True,
    flight_recorder: bool = True,
    extenders=(),
    feature_gates: dict | None = None,
    topology: str = "off",
    slices: int = 0,
    mesh=None,
) -> WorkloadResult:
    """Execute one (test case, workload) pair in direct mode on ``device``
    with the ``engine`` (``"greedy"``, ``"batched"`` or ``"packing"``) and
    return the measurement. ``pipeline`` runs the two-stage pipelined cycle
    (``Scheduler(pipeline=True)``); ``encode_cache`` toggles the encode
    cache (on by default, as in the reference), ``flight_recorder`` the
    scheduling flight recorder (on by default, as in the reference's
    runner); ``extenders`` (``ExtenderConfig``s) configures the
    scheduler-extender webhooks. ``feature_gates`` ({name: bool}) go over
    the case's own (the reference's config enables them per case);
    ``topology`` is the Scheduler's topology mode; ``slices`` > 0 labels
    the default node template's fleet with that many TPU slices (and a
    rack per four) under the shared label grammar
    (``workloads.trace_topology_labels``); ``mesh`` shards the node axis
    (``Scheduler(mesh=...)``: None / "off", "auto", "on" or a
    ``parallel.mesh.NodeMesh``), with assignments equal to the unsharded
    run's. Preemption is enabled, as the reference's runner does; churn
    ops fire between cycles.
    ``stall_s`` is how long zero progress must persist before a phase gives
    up. The kernels are built before the measured phase starts (``Scheduler.warmup``). ``on_scheduler`` is
    called once with the run's Scheduler before any op runs, so a caller
    can inspect it during and after the run."""
    if isinstance(case, str):
        case = W.TEST_CASES[case]
    if isinstance(workload, str):
        workload = next(w for w in case.workloads if w.name == workload)
    params = dict(workload.params)

    gates = dict(case.feature_gates)
    gates.update(feature_gates or {})
    client = _Client()
    sched = Scheduler(
        client, profile=profile or C.Profile(), max_batch=max_batch,
        engine=engine, device=device, pipeline=pipeline,
        encode_cache=encode_cache, flight_recorder=flight_recorder,
        cfg=C.SchedulerConfiguration(extenders=tuple(extenders)),
        feature_gates=gates, topology=topology, mesh=mesh,
    )
    client.sched = sched
    sched.enable_preemption()
    if on_scheduler is not None:
        on_scheduler(sched)

    churns: list[_Churn] = []
    measured = 0
    duration = 0.0
    attempts0 = cycles0 = timings0 = replays0 = groups0 = 0
    cache0 = (0, 0)
    preempt0 = None
    op_ns_counter = 0
    created: list[t.Pod] = []
    created_nodes: list[str] = []
    gc_clock = _GcClock()

    def begin_measured() -> None:
        """Build the kernels, then take the measured phase's baselines."""
        nonlocal attempts0, cycles0, timings0, replays0, groups0, cache0, preempt0
        sched.warmup()
        attempts0 = sched.metrics.schedule_attempts
        cycles0 = sched.metrics.cycles
        timings0 = len(sched.metrics.cycle_timings)
        groups0 = len(sched.metrics.group_cycles)
        replays0 = sched.metrics.pipeline_replays
        # the init phase's misses (first sight of every template) must
        # not dilute the steady-state hit rate
        cache0 = _cache_counts(sched)
        preempt0 = _preemption_counts(sched, client)

    def settle(target: int, namespaces: tuple[str, ...] = ()) -> tuple[int, float]:
        """Run cycles until ``target`` pods of the op's ``namespaces`` are
        BOUND (or stall). Churn fires between cycles; its pods bind in
        their own namespaces and never count toward the op's target.
        Returns (bound, wall seconds)."""

        def bound_now() -> int:
            return sum(client.bound_by_ns[ns] for ns in namespaces)

        start = bound_now()
        done = 0
        t0 = time.perf_counter()
        deadline = t0 + timeout_s
        last_progress = t0
        while done < target:
            now = time.perf_counter()
            if now > deadline:
                break
            for ch in churns:
                ch.maybe_fire(sched, now)
            res = sched.schedule_batch()
            client.deliver()
            before = done
            done = bound_now() - start
            if done == before and res["scheduled"] == 0:
                # pods may simply be in backoff (max 10 s by default): only
                # a sustained quiet period is a real stall
                if now - last_progress > stall_s:
                    break
                time.sleep(0.005)
            else:
                last_progress = now
        return done, time.perf_counter() - t0

    for op_i, op in enumerate(case.ops):
        if isinstance(op, W.CreateNodesOp):
            n = op.count or params[op.count_param]
            for i in range(n):
                node = (
                    op.template(i, op.zones) if op.template is not None
                    else W.node_default(i, op.zones, slices)
                )
                created_nodes.append(node.name)
                sched.on_node_add(node)
        elif isinstance(op, W.CreateNamespacesOp):
            # namespace objects carry labels for affinity namespaceSelectors
            n = params[op.count_param] if op.count_param else op.count
            for i in range(n):
                sched.on_namespace_add(t.Namespace(
                    name=f"{op.prefix}-{i}", labels=op.labels,
                ))
        elif isinstance(op, W.CreateServiceOp):
            sched.on_service_add(t.Service(
                name=op.name, namespace=op.namespace, selector=op.selector,
            ))
        elif isinstance(op, W.CreatePodsOp):
            count = params[op.count_param]
            template = op.template or case.default_pod_template
            ns = op.namespace or f"namespace-{op_ns_counter}"
            op_ns_counter += 1
            prefix = f"{'measure' if op.collect_metrics else 'init'}-{op_i}"
            if op.collect_metrics:
                begin_measured()
            for j in range(count):
                pod = template(f"{prefix}-{ns}-{j}", ns)
                created.append(pod)
                sched.on_pod_add(pod)
            if op.skip_wait:
                continue
            if op.collect_metrics:
                with gc_clock:
                    done, secs = settle(count, (ns,))
            else:
                done, secs = settle(count, (ns,))
            if op.collect_metrics:
                measured += done
                duration += secs
        elif isinstance(op, W.CreatePodGroupsOp):
            for g in range(params[op.count_param]):
                sched.on_pod_group_add(make_pod_group(
                    f"{op.prefix}-{g}", namespace=f"{op.prefix}-0",
                    min_count=params[op.min_count_param],
                ))
        elif isinstance(op, W.CreateGangPodsOp):
            per = params[op.multiplier_param]
            count = params[op.count_param] * per
            if op.collect_metrics:
                begin_measured()
            for j in range(count):
                sched.on_pod_add(make_pod(
                    f"gangpod-{j}", namespace=op.namespace,
                    cpu_milli=100, memory=100 * 1024**2,
                    scheduling_group=f"{op.prefix}-{j // per}",
                    creation_index=j,
                ))
            if op.collect_metrics:
                with gc_clock:
                    done, secs = settle(count, (op.namespace,))
                measured += done
                duration += secs
            else:
                settle(count, (op.namespace,))
        elif isinstance(op, W.CreatePodsWithPVsOp):
            count = params[op.count_param]
            ns = op.namespace or f"pv-{op_i}"
            if op.collect_metrics:
                begin_measured()
            for j in range(count):
                pv_name = f"{ns}-pv-{j}"
                sched.on_pv_add(t.PersistentVolume(
                    name=pv_name, driver=op.driver,
                    access_modes=("ReadOnlyMany",), capacity=1024**3,
                    claim_ref=f"{ns}/{ns}-claim-{j}",
                ))
                sched.on_pvc_add(t.PersistentVolumeClaim(
                    name=f"{ns}-claim-{j}", namespace=ns,
                    volume_name=pv_name, access_modes=("ReadOnlyMany",),
                    request=1024**3,
                ))
                pod = make_pod(
                    f"pvpod-{op_i}-{j}", namespace=ns, cpu_milli=100,
                    memory=500 * 1024**2, creation_index=j,
                    pvcs=(f"{ns}-claim-{j}",),
                )
                created.append(pod)
                sched.on_pod_add(pod)
            if op.collect_metrics:
                with gc_clock:
                    done, secs = settle(count, (ns,))
                measured += done
                duration += secs
            else:
                settle(count, (ns,))
        elif isinstance(op, W.CreateResourceDriverOp):
            sched.on_device_class_add(t.DeviceClass(
                name=op.class_name,
                selectors=(t.CELSelector(f'device.driver == "{op.driver}"'),),
            ))
            per_node = params[op.max_claims_param]
            for node_name in created_nodes:
                if not node_name.startswith(op.node_prefix):
                    continue
                sched.on_resource_slice_add(t.ResourceSlice(
                    name=f"slice-{node_name}", driver=op.driver,
                    pool=node_name, node_name=node_name,
                    devices=tuple(
                        t.Device(name=f"device-{d}") for d in range(per_node)
                    ),
                ))
        elif isinstance(op, W.CreateClaimPodsOp):
            count = params[op.count_param]
            ns = op.namespace
            if op.collect_metrics:
                begin_measured()
            for j in range(count):
                name = f"drapod-{op_i}-{j}"
                sched.on_resource_claim_add(t.ResourceClaim(
                    name=f"{name}-claim", namespace=ns,
                    uid=f"{ns}/{name}-claim",
                    requests=(t.DeviceRequest(
                        name="req-0", device_class_name=op.class_name,
                    ),),
                ))
                pod = make_pod(name, namespace=ns, claims=(f"{name}-claim",))
                created.append(pod)
                sched.on_pod_add(pod)
            if op.collect_metrics:
                with gc_clock:
                    done, secs = settle(count, (ns,))
                measured += done
                duration += secs
            else:
                settle(count, (ns,))
        elif isinstance(op, W.ChurnOp):
            churns.append(_Churn(op=op, namespace=f"churn-{len(churns)}"))
        else:
            raise TypeError(f"op {op!r} is not in the port's slices yet")

    client.deliver()
    timings = sched.metrics.cycle_timings[timings0:]
    groups = sched.metrics.group_cycles[groups0:]
    pre = {k: v - (preempt0 or {}).get(k, 0)
           for k, v in _preemption_counts(sched, client).items()}
    hits, misses = (a - b for a, b in zip(_cache_counts(sched), cache0))
    result = WorkloadResult(
        case_name=case.name,
        workload_name=workload.name,
        threshold=workload.threshold,
        device=(
            torch.cuda.get_device_name(sched.device)
            if sched.device.type == "cuda" else str(sched.device)
        ),
        measure_pods=sum(
            params[op.count_param] * (
                params[op.multiplier_param]
                if isinstance(op, W.CreateGangPodsOp) else 1
            )
            for op in case.ops
            if isinstance(op, (W.CreatePodsOp, W.CreateGangPodsOp,
                               W.CreatePodsWithPVsOp, W.CreateClaimPodsOp))
            and op.collect_metrics
        ),
        scheduled=measured,
        bound_total=len(client.bound),
        duration_s=duration,
        throughput=measured / duration if duration > 0 else 0.0,
        attempts=sched.metrics.schedule_attempts - attempts0,
        cycles=sched.metrics.cycles - cycles0,
        cycle_ms=_cycle_ms(timings),
        upload_bytes_per_cycle=(
            sum(c.upload_bytes for c in timings) / len(timings) if timings else 0.0
        ),
        node_upload_bytes_per_cycle=(
            sum(c.node_upload_bytes for c in timings) / len(timings)
            if timings else 0.0
        ),
        resident_bytes=max((c.resident_bytes for c in timings), default=0),
        engine=engine,
        rounds_per_cycle=(
            sum(c.rounds for c in timings) / len(timings) if timings else 0.0
        ),
        pipeline=pipeline,
        pipeline_replays=sched.metrics.pipeline_replays - replays0,
        encode_cache_hit_rate=hits / (hits + misses) if hits + misses else None,
        gc_s=gc_clock.seconds,
        gc_full_collections=gc_clock.full,
        preemption_attempts=pre["attempts"],
        preemption_victims=pre["victims"],
        preemptions=pre["nominations"],
        preempt_calls=pre["calls"],
        preempt_ms={
            k: 1e3 * pre[k] / pre["calls"] for k in sched._post_filter.spans
        } if pre["calls"] else {},
        group_cycles=len(groups),
        hypotheses_per_cycle=(
            sum(g.hypotheses for g in groups) / len(groups) if groups else 0.0
        ),
        group_cycle_ms=_group_cycle_ms(groups),
        **_packing_stats(sched, timings, client.bound, created),
        **_mesh_stats(sched),
    )
    return result
