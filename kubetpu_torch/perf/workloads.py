"""scheduler_perf workload definitions — op lists + object templates.

Port copy of ``kubetpu/perf/workloads.py``, trimmed to the slices ported
so far: the ``SchedulingBasic`` test case (misc/performance-config.yaml:20
in the reference), the ``SchedulingPodAffinity`` test case
(affinity/performance-config.yaml:96) and the three topology-spreading cases
(``TopologySpreading``, ``PreferredTopologySpreading`` and
``DefaultTopologySpreading``, topology_spreading/performance-config.yaml)
and the ``PreemptionAsync`` test case (misc/performance-config.yaml:186),
the ``GangScheduling`` test case
(podgroup/gangscheduling/performance-config.yaml:7, with its two feature
gates), the reference's own ``BinPacking`` case (the packing engine's
workload), and the volume and DRA cases ``SchedulingInTreePVs``,
``SchedulingCSIPVs`` (volumes/performance-config.yaml:55, :142) and
``SchedulingWithResourceClaimTemplate`` (dra/performance-config.yaml:58,
with its feature gate), each with its direct-mode workloads, the
templates they use (``node_default`` with the shared rack/TPU-slice label
grammar ``trace_topology_labels``, ``node_with_dra``, ``pod_default``,
``pod_with_pod_affinity``, ``pod_with_topology_spreading``,
``pod_with_preferred_topology_spreading``, ``pod_with_label``,
``pod_low_priority``, ``pod_high_priority_3cpu``, ``pod_binpack``, and
``pod_high_priority_large_cpu``, ``ChurnOp``'s default) and the ten ops
they use. Everything kept is verbatim apart from the trim.

Mirrors the reference harness's shape
(test/integration/scheduler_perf/scheduler_perf.go:756
RunBenchmarkPerfScheduling; ops in operations.go; per-topic
performance-config.yaml files): a *test case* is an op-list template plus
named *workloads* binding the ``$param`` counts and the SchedulingThroughput
threshold asserted by CI.

The measured metric is the reference's SchedulingThroughput: scheduled pods
per second over the collect-metrics phase (scheduler_perf.go:352-359
selects ``SchedulingThroughput / Average``; util.go:468 throughputCollector).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping

from ..api import types as t
from ..api.wrappers import make_node, make_pod, pod_affinity_term, spread_constraint
from ..state.topology import RACK_KEY, SLICE_KEY

ZONE_KEY = "topology.kubernetes.io/zone"
HOSTNAME_KEY = "kubernetes.io/hostname"

# ---------------------------------------------------------------------------
# object templates (templates/*.yaml analogs)
# ---------------------------------------------------------------------------


def trace_topology_labels(name: str, slices: int) -> dict[str, str]:
    """The ONE rack/TPU-slice label grammar every node generator shares
    (initial fleet, autoscaler wave nodes, tests): a stable crc32 of the
    node name picks the slice — builtin hash() is salted per process,
    which would break the trace determinism contract — and racks group
    four slices each. ``slices <= 0`` means an unlabeled fleet (the
    ``--topology auto`` parity case)."""
    if slices <= 0:
        return {}
    import zlib

    s = zlib.crc32(name.encode()) % slices
    return {SLICE_KEY: f"slice-{s:03d}", RACK_KEY: f"rack-{s // 4:02d}"}


def node_default(
    i: int, zones: tuple[str, ...] = (), slices: int = 0
) -> t.Node:
    """templates/node-default.yaml: 4 cpu / 32Gi / 110 pods, plus the
    labelNodePrepareStrategy zone label (round-robin over ``zones``), the
    kubelet-maintained hostname label, and — when ``slices`` — the shared
    rack/TPU-slice grammar (trace_topology_labels)."""
    name = f"scheduler-perf-{i}"
    labels = {HOSTNAME_KEY: name}
    if zones:
        labels[ZONE_KEY] = zones[i % len(zones)]
    labels.update(trace_topology_labels(name, slices))
    return make_node(
        name, cpu_milli=4000, memory=32 * 1024**3, pods=110, labels=labels
    )


_POD_REQ = dict(cpu_milli=100, memory=500 * 1024**2)  # 100m / 500Mi


def pod_default(name: str, namespace: str) -> t.Pod:
    """templates/pod-default.yaml."""
    return make_pod(name, namespace=namespace, **_POD_REQ)


def pod_with_pod_affinity(name: str, namespace: str) -> t.Pod:
    """templates/pod-with-pod-affinity.yaml: color=blue, required zone
    affinity to color=blue across sched-0/sched-1."""
    term = pod_affinity_term(
        ZONE_KEY, match_labels={"color": "blue"},
        namespaces=("sched-1", "sched-0"),
    )
    return make_pod(
        name, namespace=namespace, labels={"color": "blue"},
        affinity=t.Affinity(pod_affinity=t.PodAffinity(required=(term,))),
        **_POD_REQ,
    )


def pod_with_topology_spreading(name: str, namespace: str) -> t.Pod:
    """templates/pod-with-topology-spreading.yaml: maxSkew 5 / zone /
    DoNotSchedule over color=blue."""
    return make_pod(
        name, namespace=namespace, labels={"color": "blue"},
        spread=(spread_constraint(
            5, ZONE_KEY,
            when=t.UnsatisfiableConstraintAction.DO_NOT_SCHEDULE,
            match_labels={"color": "blue"},
        ),),
        **_POD_REQ,
    )


def pod_with_preferred_topology_spreading(name: str, namespace: str) -> t.Pod:
    return make_pod(
        name, namespace=namespace, labels={"color": "blue"},
        spread=(spread_constraint(
            5, ZONE_KEY,
            when=t.UnsatisfiableConstraintAction.SCHEDULE_ANYWAY,
            match_labels={"color": "blue"},
        ),),
        **_POD_REQ,
    )


def pod_with_label(name: str, namespace: str) -> t.Pod:
    """templates/pod-with-label.yaml: a labeled pod with no constraints of
    its own — exercises the profile's DEFAULT spread constraints path."""
    return make_pod(
        name, namespace=namespace, labels={"foo": "bar"}, **_POD_REQ,
    )


def pod_high_priority_large_cpu(name: str, namespace: str) -> t.Pod:
    """templates/pod-high-priority-large-cpu.yaml: priority 10, 9 cpu."""
    return make_pod(
        name, namespace=namespace, priority=10,
        cpu_milli=9000, memory=500 * 1024**2,
    )


def pod_low_priority(name: str, namespace: str) -> t.Pod:
    """templates/pod-low-priority.yaml: 900m/500Mi, priority 0 — four of
    them fill 3.6 of a node's 4 cpu (the PreemptionAsync setup)."""
    return make_pod(
        name, namespace=namespace, cpu_milli=900, memory=500 * 1024**2,
    )


#: the bin-pack workload's deterministic 10-slot size/priority cycle,
#: keyed by the pod's trailing ``-{j}`` index: one 2-cpu latency pod
#: (priority 10), two 1-cpu services (priority 5), three 500m and four
#: 100m batch fillers (priority 0). One full cycle requests 5.9 cpu —
#: ~1.5 of a 4-cpu node when packed tight, but a spreading scorer smears
#: it over many part-empty nodes.
_BINPACK_SLOTS: tuple[tuple[int, int], ...] = (
    (2000, 10),
    (1000, 5), (1000, 5),
    (500, 0), (500, 0), (500, 0),
    (100, 0), (100, 0), (100, 0), (100, 0),
)


def pod_binpack(name: str, namespace: str) -> t.Pod:
    """The skewed-size + priority-tier bin-pack template: the pod's shape
    is a pure function of its trailing index, so the workload is identical
    across engines and runs — any nodes-used delta is the engine's doing,
    not the draw's."""
    try:
        j = int(name.rsplit("-", 1)[-1])
    except ValueError:
        j = 0
    cpu, priority = _BINPACK_SLOTS[j % len(_BINPACK_SLOTS)]
    return make_pod(
        name, namespace=namespace, priority=priority,
        cpu_milli=cpu, memory=500 * 1024**2,
    )


def pod_high_priority_3cpu(name: str, namespace: str) -> t.Pod:
    """templates/pod-high-priority.yaml: priority 10, 3 cpu — must preempt
    3 of 4 low-priority pods to fit."""
    return make_pod(
        name, namespace=namespace, priority=10,
        cpu_milli=3000, memory=500 * 1024**2,
    )


# ---------------------------------------------------------------------------
# op list (operations.go analogs)
# ---------------------------------------------------------------------------

PodTemplate = Callable[[str, str], t.Pod]


@dataclass(frozen=True)
class CreateNodesOp:
    """operations.go:205 createNodesOp (+ labelNodePrepareStrategy).
    ``count`` > 0 overrides ``count_param`` (the YAML ``count:`` form);
    ``template`` overrides the default node factory (nodeTemplatePath)."""

    count_param: str = "initNodes"
    zones: tuple[str, ...] = ()
    count: int = 0
    template: Callable[[int, tuple[str, ...]], t.Node] | None = None


@dataclass(frozen=True)
class CreateNamespacesOp:
    """operations.go createNamespacesOp. ``labels`` models
    namespaceTemplatePath (templates/namespace-with-labels.yaml);
    ``count_param`` overrides ``count`` when set."""

    prefix: str = "sched"
    count: int = 2
    count_param: str = ""
    labels: tuple[tuple[str, str], ...] = ()


@dataclass(frozen=True)
class CreateServiceOp:
    """createAny with a Service template (templates/service.yaml:
    selector foo=bar) — feeds the DefaultSelector for default spread."""

    namespace: str = "service-ns"
    name: str = "service"
    selector: tuple[tuple[str, str], ...] = (("foo", "bar"),)


@dataclass(frozen=True)
class CreatePodsOp:
    """operations.go:295 createPodsOp. ``skip_wait`` = the YAML
    skipWaitToCompletion (gated pods never schedule; don't settle)."""

    count_param: str = "initPods"
    template: PodTemplate | None = None     # None → case default
    collect_metrics: bool = False
    namespace: str | None = None            # None → unique per-op namespace
    skip_wait: bool = False


@dataclass(frozen=True)
class CreatePodGroupsOp:
    """operations.go createAny with a PodGroup template
    (podgroup/gangscheduling/performance-config.yaml:18 + its
    templates/podgroup.yaml: gangs gang-0..gang-(n-1), each with
    minCount = podsPerGroup)."""

    count_param: str = "initPodGroups"
    min_count_param: str = "podsPerGroup"
    prefix: str = "gang"


@dataclass(frozen=True)
class CreateGangPodsOp:
    """createPods with countMultiplierParam (performance-config.yaml:28 +
    templates/gang-pod.yaml): pod i references gang-(i // podsPerGroup);
    100m cpu / 100Mi, like the reference template."""

    count_param: str = "initPodGroups"
    multiplier_param: str = "podsPerGroup"
    prefix: str = "gang"
    collect_metrics: bool = True
    namespace: str = "gang-0"


@dataclass(frozen=True)
class CreatePodsWithPVsOp:
    """createPods with persistentVolumeTemplatePath /
    persistentVolumeClaimTemplatePath (volumes/performance-config.yaml:55
    SchedulingInTreePVs, :142 SchedulingCSIPVs): each pod gets its own
    bound PV+PVC pair (templates/pv-aws.yaml + templates/pvc.yaml —
    ReadOnlyMany, 1Gi, bind-completed)."""

    count_param: str = "measurePods"
    collect_metrics: bool = False
    driver: str = ""                        # CSI driver name ("" = in-tree)
    namespace: str | None = None


def node_with_dra(i: int, zones: tuple[str, ...] = ()) -> t.Node:
    """templates/node-with-dra-test-driver.yaml: a default node named to
    match the driver op's ``nodes: scheduler-perf-dra-*`` selector."""
    name = f"scheduler-perf-dra-{i}"
    return make_node(
        name, cpu_milli=4000, memory=32 * 1024**3, pods=110,
        labels={HOSTNAME_KEY: name},
    )


@dataclass(frozen=True)
class CreateResourceDriverOp:
    """operations.go createResourceDriverOp (dra/performance-config.yaml
    ``createResourceDriver``): publish the DRA driver's DeviceClass plus one
    ResourceSlice with ``maxClaimsPerNodeParam`` devices per node matching
    ``node_prefix`` (the reference's ``nodes: scheduler-perf-dra-*``
    selector; test driver shape: templates/deviceclass.yaml + per-node
    slices)."""

    driver: str = "test-driver.cdi.k8s.io"
    class_name: str = "test-class"
    max_claims_param: str = "maxClaimsPerNode"
    node_prefix: str = "scheduler-perf-dra-"


@dataclass(frozen=True)
class CreateClaimPodsOp:
    """createPods with a ResourceClaimTemplate
    (dra/performance-config.yaml SchedulingWithResourceClaimTemplate:
    templates/resourceclaimtemplate.yaml + pod-with-claim-template.yaml):
    each pod gets its OWN ResourceClaim instance — one request, one device
    of ``class_name`` — exactly what the resourceclaim controller stamps
    from the template."""

    count_param: str = "measurePods"
    class_name: str = "test-class"
    collect_metrics: bool = False
    namespace: str = "dra-test"


@dataclass(frozen=True)
class ChurnOp:
    """operations.go:518 churnOp — create (or recreate) interfering objects
    at an interval while the measured phase runs."""

    mode: str = "create"                    # create | recreate
    template: PodTemplate = pod_high_priority_large_cpu
    interval_ms: int = 500
    number: int = 0                         # recreate pool size (0 = unbounded)


@dataclass(frozen=True)
class Workload:
    name: str
    params: Mapping[str, int]
    threshold: float | None = None          # SchedulingThroughput floor
    labels: tuple[str, ...] = ()
    threshold_note: str = ""


@dataclass(frozen=True)
class TestCase:
    name: str
    ops: tuple
    workloads: tuple[Workload, ...]
    default_pod_template: PodTemplate = pod_default
    source: str = ""                        # reference config citation
    # featureGates the reference's config enables for this case
    feature_gates: tuple[tuple[str, bool], ...] = ()


TEST_CASES: dict[str, TestCase] = {}


def _case(tc: TestCase) -> TestCase:
    TEST_CASES[tc.name] = tc
    return tc


_case(TestCase(
    name="SchedulingBasic",
    source="misc/performance-config.yaml:20",
    ops=(
        CreateNodesOp("initNodes"),
        CreatePodsOp("initPods"),
        CreatePodsOp("measurePods", collect_metrics=True),
    ),
    workloads=(
        Workload("500Nodes", {"initNodes": 500, "initPods": 500, "measurePods": 1000},
                 threshold=680, threshold_note=(
                     "5k floor kept verbatim: per-pod cost of the linear "
                     "workload is ~flat in node count (the reference "
                     "subsamples via numFeasibleNodesToFind), so its 500-"
                     "node throughput is >= the 5k floor")),
        Workload("5000Nodes_10000Pods",
                 {"initNodes": 5000, "initPods": 1000, "measurePods": 10000},
                 threshold=680, labels=("performance",)),
    ),
))

_case(TestCase(
    name="SchedulingPodAffinity",
    source="affinity/performance-config.yaml:96 (threshold 70 — the hardest quadratic workload)",
    default_pod_template=pod_with_pod_affinity,
    ops=(
        CreateNodesOp("initNodes", zones=("zone1",)),
        CreateNamespacesOp("sched", 2),
        CreatePodsOp("initPods", namespace="sched-0"),
        CreatePodsOp("measurePods", collect_metrics=True, namespace="sched-1"),
    ),
    workloads=(
        Workload("500Nodes", {"initNodes": 500, "initPods": 500, "measurePods": 1000},
                 threshold=700, threshold_note=(
                     "70 pods/s 5k floor x10: the quadratic PreScore cost "
                     "scales ~linearly with node count, so at 1/10 the "
                     "nodes the reference would run ~10x its floor — the "
                     "scaled floor keeps vs_baseline conservative")),
        Workload("5000Nodes_5000Pods",
                 {"initNodes": 5000, "initPods": 5000, "measurePods": 5000},
                 threshold=70, labels=("performance",)),
    ),
))

_case(TestCase(
    name="TopologySpreading",
    source="topology_spreading/performance-config.yaml:19",
    ops=(
        CreateNodesOp("initNodes", zones=("moon-1", "moon-2", "moon-3")),
        CreatePodsOp("initPods", template=pod_default),
        CreatePodsOp("measurePods", template=pod_with_topology_spreading,
                     collect_metrics=True),
    ),
    workloads=(
        Workload("500Nodes", {"initNodes": 500, "initPods": 1000, "measurePods": 1000},
                 threshold=4600, threshold_note=(
                     "460 pods/s 5k floor x10: segment-sum PreScore cost "
                     "scales ~linearly with node count (see "
                     "SchedulingPodAffinity scaling note)")),
        Workload("5000Nodes_5000Pods",
                 {"initNodes": 5000, "initPods": 5000, "measurePods": 5000},
                 threshold=460, labels=("performance",)),
    ),
))

_case(TestCase(
    name="PreferredTopologySpreading",
    source="topology_spreading/performance-config.yaml:64",
    ops=(
        CreateNodesOp("initNodes", zones=("moon-1", "moon-2", "moon-3")),
        CreatePodsOp("initPods", template=pod_default),
        CreatePodsOp("measurePods",
                     template=pod_with_preferred_topology_spreading,
                     collect_metrics=True),
    ),
    workloads=(
        Workload("500Nodes", {"initNodes": 500, "initPods": 1000, "measurePods": 1000}),
        Workload("5000Nodes_5000Pods",
                 {"initNodes": 5000, "initPods": 5000, "measurePods": 5000},
                 threshold=340, labels=("performance",)),
    ),
))

_case(TestCase(
    name="DefaultTopologySpreading",
    source="topology_spreading/performance-config.yaml:104 (threshold 160 at 50k; "
           "a service's selector drives the DEFAULT spread constraints)",
    default_pod_template=pod_with_label,
    ops=(
        CreateNodesOp("initNodes", zones=("moon-1", "moon-2", "moon-3")),
        CreateServiceOp(namespace="service-ns"),
        CreatePodsOp("initPods", template=pod_default),
        CreatePodsOp("measurePods", collect_metrics=True,
                     namespace="service-ns"),
    ),
    workloads=(
        Workload("500Nodes", {"initNodes": 500, "initPods": 1000, "measurePods": 1000}),
        Workload("5000Nodes_50000Pods",
                 {"initNodes": 5000, "initPods": 5000, "measurePods": 50000},
                 threshold=160, labels=("performance",)),
    ),
))

_case(TestCase(
    name="PreemptionAsync",
    source="misc/performance-config.yaml:186 (threshold 570)",
    ops=(
        CreateNodesOp("initNodes"),
        CreatePodsOp("initPods", template=pod_low_priority),
        ChurnOp(mode="create", template=pod_high_priority_3cpu,
                interval_ms=200),
        CreatePodsOp("measurePods", template=pod_default,
                     collect_metrics=True),
    ),
    workloads=(
        Workload("5Nodes", {"initNodes": 5, "initPods": 20, "measurePods": 5}),
        Workload("500Nodes",
                 {"initNodes": 500, "initPods": 2000, "measurePods": 500}),
        Workload("5000Nodes",
                 {"initNodes": 5000, "initPods": 20000, "measurePods": 5000},
                 threshold=570, labels=("performance",)),
    ),
))

_case(TestCase(
    name="GangScheduling",
    source="podgroup/gangscheduling/performance-config.yaml:7 (no thresholds yet — new suite)",
    feature_gates=(("GenericWorkload", True), ("GangScheduling", True)),
    ops=(
        CreateNodesOp("initNodes"),
        CreateNamespacesOp("gang", 1),
        CreatePodGroupsOp("initPodGroups", "podsPerGroup"),
        CreateGangPodsOp("initPodGroups", "podsPerGroup",
                         collect_metrics=True),
    ),
    workloads=(
        Workload("10Nodes_3Gangs",
                 {"initNodes": 10, "initPodGroups": 3, "podsPerGroup": 3}),
        Workload("100Nodes_10Gangs",
                 {"initNodes": 100, "initPodGroups": 10, "podsPerGroup": 3}),
        Workload("5000Nodes_1000Gangs_3000Pods",
                 {"initNodes": 5000, "initPodGroups": 1000, "podsPerGroup": 3},
                 labels=("performance",)),
        Workload("5000Nodes_3Gangs_3000Pods_1000PerGroup",
                 {"initNodes": 5000, "initPodGroups": 3, "podsPerGroup": 1000},
                 labels=("performance",)),
    ),
))

_case(TestCase(
    name="BinPacking",
    source="kubetpu's utilization-vs-throughput frontier workload (no "
           "reference config — skewed sizes + priority tiers built for "
           "the three-engine packing comparison)",
    default_pod_template=pod_binpack,
    ops=(
        CreateNodesOp("initNodes"),
        CreatePodsOp("initPods"),
        CreatePodsOp("measurePods", collect_metrics=True),
    ),
    workloads=(
        # no pods/s threshold: the workload's verdict is the frontier —
        # nodes_used_at_steady_state and priority_slo_hit_rate against the
        # greedy engine, not a reference throughput floor
        Workload("200Nodes",
                 {"initNodes": 200, "initPods": 50, "measurePods": 300}),
        Workload("1000Nodes_3000Pods",
                 {"initNodes": 1000, "initPods": 200, "measurePods": 3000},
                 labels=("performance", "packing")),
    ),
))

_case(TestCase(
    name="SchedulingInTreePVs",
    source="volumes/performance-config.yaml:55 (threshold 290)",
    ops=(
        CreateNodesOp("initNodes"),
        CreatePodsWithPVsOp("initPods"),
        CreatePodsWithPVsOp("measurePods", collect_metrics=True),
    ),
    workloads=(
        Workload("5Nodes", {"initNodes": 5, "initPods": 5, "measurePods": 10}),
        Workload("5000Nodes_2000Pods",
                 {"initNodes": 5000, "initPods": 1000, "measurePods": 2000},
                 threshold=290, labels=("performance",)),
    ),
))

_case(TestCase(
    name="SchedulingCSIPVs",
    source="volumes/performance-config.yaml:142 (threshold 100)",
    ops=(
        CreateNodesOp("initNodes"),
        CreatePodsWithPVsOp("initPods", driver="ebs.csi.aws.com"),
        CreatePodsWithPVsOp("measurePods", driver="ebs.csi.aws.com",
                            collect_metrics=True),
    ),
    workloads=(
        Workload("5Nodes", {"initNodes": 5, "initPods": 5, "measurePods": 10}),
        Workload("5000Nodes_2000Pods",
                 {"initNodes": 5000, "initPods": 1000, "measurePods": 2000},
                 threshold=100, labels=("performance",)),
    ),
))

_case(TestCase(
    name="SchedulingWithResourceClaimTemplate",
    source="dra/performance-config.yaml:58 (threshold 56, 'typically above 70')",
    feature_gates=(("DynamicResourceAllocation", True),),
    ops=(
        CreateNodesOp("nodesWithoutDRA"),
        CreateNodesOp("nodesWithDRA", template=node_with_dra),
        CreateResourceDriverOp(),
        CreateClaimPodsOp("initPods", namespace="init"),
        CreateClaimPodsOp("measurePods", collect_metrics=True,
                          namespace="test"),
    ),
    workloads=(
        Workload("fast", {"nodesWithDRA": 1, "nodesWithoutDRA": 1,
                          "initPods": 0, "measurePods": 10,
                          "maxClaimsPerNode": 10}),
        Workload("5000pods_500nodes",
                 {"nodesWithDRA": 500, "nodesWithoutDRA": 0,
                  "initPods": 2500, "measurePods": 2500,
                  "maxClaimsPerNode": 10},
                 threshold=56, labels=("performance",)),
    ),
))
