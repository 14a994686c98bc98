# Port copy of kubetpu/framework/config.py, verbatim apart from this note (no JAX in it).
"""Scheduler configuration — the envelope of ``KubeSchedulerConfiguration``.

The reference's config surface (pkg/scheduler/apis/config/types.go:37,
versioned staging/src/k8s.io/kube-scheduler/config/v1/types.go:44) is a list
of *profiles*, each enabling plugins per extension point with weights and
per-plugin args (types_pluginargs.go). This module models the subset that
drives the tensor kernels:

- which Filter predicates are enabled,
- which Score plugins are enabled with what weights,
- per-plugin args (scoring strategy + resource weights for NodeResourcesFit,
  RequestedToCapacityRatio shape, default topology-spread constraints).

Defaults mirror ``getDefaultPlugins``
(pkg/scheduler/apis/config/v1/default_plugins.go:30) and the defaulted plugin
args (apis/config/v1/defaults.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from ..api import types as t

from ..names import (  # noqa: F401  (canonical plugin names, re-exported)
    DEFAULT_BINDER,
    DEFAULT_PREEMPTION,
    DYNAMIC_RESOURCES,
    IMAGE_LOCALITY,
    INTER_POD_AFFINITY,
    NODE_AFFINITY,
    NODE_NAME,
    NODE_PORTS,
    NODE_RESOURCES_BALANCED,
    NODE_RESOURCES_FIT,
    NODE_UNSCHEDULABLE,
    NODE_VOLUME_LIMITS,
    POD_TOPOLOGY_SPREAD,
    PRIORITY_SORT,
    SCHEDULING_GATES,
    TAINT_TOLERATION,
    VOLUME_BINDING,
    VOLUME_RESTRICTIONS,
    VOLUME_ZONE,
)

LEAST_ALLOCATED = "LeastAllocated"
MOST_ALLOCATED = "MostAllocated"
REQUESTED_TO_CAPACITY_RATIO = "RequestedToCapacityRatio"


@dataclass(frozen=True)
class ScoringStrategy:
    """NodeResourcesFitArgs.ScoringStrategy (types_pluginargs.go). ``resources``
    is the scored resource set with weights (default cpu:1, memory:1 —
    apis/config/v1/defaults.go defaultResourceSpec). ``shape`` is the
    RequestedToCapacityRatio bracket, y values in 0..10 (MaxCustomPriorityScore)
    exactly as configured; the runtime scales them ×10."""

    type: str = LEAST_ALLOCATED
    resources: tuple[tuple[str, int], ...] = ((t.CPU, 1), (t.MEMORY, 1))
    shape: tuple[tuple[int, int], ...] = ()  # (utilization 0..100, score 0..10)


@dataclass(frozen=True)
class PluginSet:
    """Enabled plugins for one extension point: (name, weight) pairs.
    Weight is meaningful only for Score."""

    enabled: tuple[tuple[str, int], ...] = ()

    def names(self) -> list[str]:
        return [n for n, _ in self.enabled]

    def weight(self, name: str) -> int:
        for n, w in self.enabled:
            if n == name:
                return w
        return 0


# Default plugin sets (default_plugins.go:30). Weights: TaintToleration 3,
# NodeAffinity 2, PodTopologySpread 2, InterPodAffinity 2, the rest 1.
DEFAULT_FILTERS = PluginSet(enabled=(
    (NODE_UNSCHEDULABLE, 1),
    (NODE_NAME, 1),
    (TAINT_TOLERATION, 1),
    (NODE_AFFINITY, 1),
    (NODE_PORTS, 1),
    (NODE_RESOURCES_FIT, 1),
    (VOLUME_RESTRICTIONS, 1),
    (NODE_VOLUME_LIMITS, 1),
    (VOLUME_BINDING, 1),
    (VOLUME_ZONE, 1),
    (POD_TOPOLOGY_SPREAD, 1),
    (INTER_POD_AFFINITY, 1),
    # DynamicResources joins the default set with DRA GA (resource.k8s.io/v1
    # in the 1.37 snapshot; default_plugins.go:60-73 feature-gated add)
    (DYNAMIC_RESOURCES, 1),
))
DEFAULT_SCORES = PluginSet(enabled=(
    (TAINT_TOLERATION, 3),
    (NODE_AFFINITY, 2),
    (NODE_RESOURCES_FIT, 1),
    (POD_TOPOLOGY_SPREAD, 2),
    (INTER_POD_AFFINITY, 2),
    (NODE_RESOURCES_BALANCED, 1),
    (IMAGE_LOCALITY, 1),
    (DYNAMIC_RESOURCES, 1),
))


@dataclass(frozen=True)
class Profile:
    """One scheduler profile (pkg/scheduler/profile/profile.go:46)."""

    name: str = "default-scheduler"
    filters: PluginSet = DEFAULT_FILTERS
    scores: PluginSet = DEFAULT_SCORES
    # Host-side lifecycle plugins (Reserve/Permit/PreBind/PostBind —
    # interface.go:636-680), resolved by name against the scheduler's
    # lifecycle Registry; one name may serve several extension points, like
    # reference plugins implementing multiple interfaces. VolumeBinding's
    # Reserve/PreBind half is in the default set (default_plugins.go:30).
    lifecycle: PluginSet = PluginSet(
        enabled=((VOLUME_BINDING, 1), (DYNAMIC_RESOURCES, 1))
    )
    scoring_strategy: ScoringStrategy = ScoringStrategy()
    balanced_resources: tuple[tuple[str, int], ...] = ((t.CPU, 1), (t.MEMORY, 1))
    # InterPodAffinityArgs.HardPodAffinityWeight (types_pluginargs.go, default 1)
    hard_pod_affinity_weight: int = 1
    # Cluster-level default spread constraints applied to pods without their
    # own (pkg/scheduler/framework/plugins/podtopologyspread defaults:
    # zone maxSkew 3 ScheduleAnyway + hostname maxSkew 5 ScheduleAnyway,
    # systemDefaulted, plugin.go buildDefaultConstraints).
    default_spread_constraints: tuple[t.TopologySpreadConstraint, ...] = (
        t.TopologySpreadConstraint(
            max_skew=3,
            topology_key="topology.kubernetes.io/zone",
            when_unsatisfiable=t.UnsatisfiableConstraintAction.SCHEDULE_ANYWAY,
            selector=None,
        ),
        t.TopologySpreadConstraint(
            max_skew=5,
            topology_key="kubernetes.io/hostname",
            when_unsatisfiable=t.UnsatisfiableConstraintAction.SCHEDULE_ANYWAY,
            selector=None,
        ),
    )

    def score_weight(self, name: str) -> int:
        return self.scores.weight(name)

    def has_filter(self, name: str) -> bool:
        return name in self.filters.names()

    def has_score(self, name: str) -> bool:
        return name in self.scores.names()


def minimal_profile(
    strategy: str = LEAST_ALLOCATED,
    resources: Sequence[tuple[str, int]] = ((t.CPU, 1), (t.MEMORY, 1)),
    shape: Sequence[tuple[int, int]] = (),
) -> Profile:
    """The BASELINE config #1 profile: NodeResourcesFit only (Filter + Score)."""
    return Profile(
        name="minimal",
        filters=PluginSet(enabled=((NODE_RESOURCES_FIT, 1),)),
        scores=PluginSet(enabled=((NODE_RESOURCES_FIT, 1),)),
        scoring_strategy=ScoringStrategy(
            type=strategy, resources=tuple(resources), shape=tuple(shape)
        ),
        default_spread_constraints=(),
    )


@dataclass(frozen=True)
class ExtenderConfig:
    """apis/config/types.go:267 Extender — the ``extenders:`` block of
    KubeSchedulerConfiguration, consumed by the HTTP extender client
    (sched/extender.py)."""

    url_prefix: str
    filter_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    preempt_verb: str = ""
    weight: int = 1
    node_cache_capable: bool = False
    ignorable: bool = False
    http_timeout_s: float = 30.0
    managed_resources: tuple[str, ...] = ()


@dataclass(frozen=True)
class SchedulerConfiguration:
    """Subset of KubeSchedulerConfiguration (apis/config/types.go:37)."""

    profiles: tuple[Profile, ...] = (Profile(),)
    parallelism: int = 16                 # reference default (scheduler.go:193)
    percentage_of_nodes_to_score: int = 0  # 0 = exhaustive (we never subsample)
    pod_initial_backoff_seconds: float = 1.0
    pod_max_backoff_seconds: float = 10.0
    extenders: tuple[ExtenderConfig, ...] = ()

    def profile(self, name: str | None = None) -> Profile:
        if name is None:
            return self.profiles[0]
        for p in self.profiles:
            if p.name == name:
                return p
        raise KeyError(f"no profile named {name!r}")
