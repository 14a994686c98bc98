"""scheduler_perf workload definitions — op lists + object templates.

Port copy of ``kubetpu/perf/workloads.py``, trimmed to the first slice:
the ``SchedulingBasic`` test case (misc/performance-config.yaml:20 in the
reference) with its two direct-mode workloads, the ``node_default`` /
``pod_default`` templates and the two ops it uses. Everything kept is
verbatim apart from the trim: ``node_default`` drops the rack/TPU-slice
label option, which SchedulingBasic never sets.

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
from ..api.wrappers import make_node, make_pod

ZONE_KEY = "topology.kubernetes.io/zone"
HOSTNAME_KEY = "kubernetes.io/hostname"

# ---------------------------------------------------------------------------
# object templates (templates/*.yaml analogs)
# ---------------------------------------------------------------------------


def node_default(i: int, zones: tuple[str, ...] = ()) -> t.Node:
    """templates/node-default.yaml: 4 cpu / 32Gi / 110 pods, plus the
    labelNodePrepareStrategy zone label (round-robin over ``zones``) and
    the kubelet-maintained hostname label."""
    name = f"scheduler-perf-{i}"
    labels = {HOSTNAME_KEY: name}
    if zones:
        labels[ZONE_KEY] = zones[i % len(zones)]
    return make_node(
        name, cpu_milli=4000, memory=32 * 1024**3, pods=110, labels=labels
    )


_POD_REQ = dict(cpu_milli=100, memory=500 * 1024**2)  # 100m / 500Mi


def pod_default(name: str, namespace: str) -> t.Pod:
    """templates/pod-default.yaml."""
    return make_pod(name, namespace=namespace, **_POD_REQ)


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
class CreatePodsOp:
    """operations.go:295 createPodsOp. ``skip_wait`` = the YAML
    skipWaitToCompletion (gated pods never schedule; don't settle)."""

    count_param: str = "initPods"
    template: PodTemplate | None = None     # None → case default
    collect_metrics: bool = False
    namespace: str | None = None            # None → unique per-op namespace
    skip_wait: bool = False


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
