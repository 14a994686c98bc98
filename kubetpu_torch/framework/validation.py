# Port copy of kubetpu/framework/validation.py, verbatim apart from this note (no JAX in it).
"""Configuration validation — the apis/config/validation analog.

Reference: pkg/scheduler/apis/config/validation/validation.go
(ValidateKubeSchedulerConfiguration) + validation_pluginargs.go: malformed
profiles fail LOUDLY at scheduler construction instead of silently
mis-scheduling. Every error found is reported at once (field-path style
messages, like field.ErrorList aggregation).
"""

from __future__ import annotations

from ..api import types as t
from .. import names as N
from . import config as C

FILTER_PLUGINS = frozenset(N.ALL_FILTERS)
SCORE_PLUGINS = frozenset({
    N.NODE_RESOURCES_FIT,
    N.NODE_RESOURCES_BALANCED,
    N.NODE_AFFINITY,
    N.TAINT_TOLERATION,
    N.IMAGE_LOCALITY,
    N.POD_TOPOLOGY_SPREAD,
    N.INTER_POD_AFFINITY,
    N.DYNAMIC_RESOURCES,
})
STRATEGIES = frozenset({
    C.LEAST_ALLOCATED, C.MOST_ALLOCATED, C.REQUESTED_TO_CAPACITY_RATIO,
})
MAX_CUSTOM_PRIORITY_SCORE = 10   # validation_pluginargs.go maxCustomPriorityScore
MAX_WEIGHT = 100                 # validation.go MaxWeight (MaxTotalScore bound)


def validate_profile(profile: C.Profile, lifecycle_registry=None) -> list[str]:
    """Returns every problem found (empty = valid)."""
    errs: list[str] = []
    path = f"profiles[{profile.name!r}]"
    if not profile.name:
        errs.append(f"{path}.name: must not be empty")

    def check_set(field: str, ps: C.PluginSet, known: frozenset, scored: bool):
        seen = set()
        for name, weight in ps.enabled:
            p = f"{path}.{field}[{name!r}]"
            if name in seen:
                errs.append(f"{p}: duplicate plugin")
            seen.add(name)
            if name not in known:
                errs.append(
                    f"{p}: unknown plugin (known: {sorted(known)})"
                )
            if scored and not (1 <= weight <= MAX_WEIGHT):
                errs.append(
                    f"{p}: weight {weight} must be in 1..{MAX_WEIGHT}"
                )

    check_set("filters", profile.filters, FILTER_PLUGINS, scored=False)
    check_set("scores", profile.scores, SCORE_PLUGINS, scored=True)
    if lifecycle_registry is not None:
        known_lc = frozenset(lifecycle_registry.names())
        for name, _ in profile.lifecycle.enabled:
            if name not in known_lc:
                errs.append(
                    f"{path}.lifecycle[{name!r}]: not registered "
                    f"(known: {sorted(known_lc)})"
                )

    ss = profile.scoring_strategy
    if ss.type not in STRATEGIES:
        errs.append(
            f"{path}.scoringStrategy.type: {ss.type!r} not in {sorted(STRATEGIES)}"
        )
    for rname, weight in ss.resources:
        if not (1 <= weight <= MAX_WEIGHT):
            errs.append(
                f"{path}.scoringStrategy.resources[{rname!r}]: weight "
                f"{weight} must be in 1..{MAX_WEIGHT}"
            )
    if ss.type == C.REQUESTED_TO_CAPACITY_RATIO:
        # validation_pluginargs.go validateFunctionShape: non-empty, strictly
        # increasing utilization in 0..100, scores in 0..maxCustomPriorityScore
        if not ss.shape:
            errs.append(f"{path}.scoringStrategy.shape: required for "
                        f"RequestedToCapacityRatio")
        last_x = -1
        for x, y in ss.shape:
            if not (0 <= x <= 100):
                errs.append(f"{path}.scoringStrategy.shape: utilization {x} "
                            f"must be in 0..100")
            if x <= last_x:
                errs.append(f"{path}.scoringStrategy.shape: utilization must "
                            f"be strictly increasing (got {x} after {last_x})")
            last_x = x
            if not (0 <= y <= MAX_CUSTOM_PRIORITY_SCORE):
                errs.append(f"{path}.scoringStrategy.shape: score {y} must "
                            f"be in 0..{MAX_CUSTOM_PRIORITY_SCORE}")
    if not (0 <= profile.hard_pod_affinity_weight <= MAX_WEIGHT):
        errs.append(
            f"{path}.hardPodAffinityWeight: "
            f"{profile.hard_pod_affinity_weight} must be in 0..{MAX_WEIGHT}"
        )
    for i, sc in enumerate(profile.default_spread_constraints):
        p = f"{path}.defaultConstraints[{i}]"
        if sc.max_skew < 1:
            errs.append(f"{p}.maxSkew: {sc.max_skew} must be >= 1")
        if not sc.topology_key:
            errs.append(f"{p}.topologyKey: must not be empty")
        if sc.min_domains is not None and sc.min_domains < 1:
            errs.append(f"{p}.minDomains: {sc.min_domains} must be >= 1")
    return errs


def validate_configuration(cfg: C.SchedulerConfiguration) -> list[str]:
    errs: list[str] = []
    if not cfg.profiles:
        errs.append("profiles: at least one profile is required")
    seen = set()
    for p in cfg.profiles:
        if p.name in seen:
            errs.append(f"profiles[{p.name!r}]: duplicate profile name")
        seen.add(p.name)
        errs.extend(validate_profile(p))
    if not (0 <= cfg.percentage_of_nodes_to_score <= 100):
        errs.append(
            f"percentageOfNodesToScore: {cfg.percentage_of_nodes_to_score} "
            f"must be in 0..100"
        )
    if cfg.parallelism <= 0:
        errs.append(f"parallelism: {cfg.parallelism} must be > 0")
    if cfg.pod_initial_backoff_seconds < 0:
        errs.append("podInitialBackoffSeconds: must be >= 0")
    if cfg.pod_max_backoff_seconds < cfg.pod_initial_backoff_seconds:
        errs.append(
            "podMaxBackoffSeconds: must be >= podInitialBackoffSeconds"
        )
    return errs


def must_validate(obj, lifecycle_registry=None) -> None:
    """Raise ValueError listing EVERY problem (the reference's
    utilerrors.Aggregate → fatal at startup)."""
    if isinstance(obj, C.SchedulerConfiguration):
        errs = validate_configuration(obj)
    else:
        errs = validate_profile(obj, lifecycle_registry)
    if errs:
        raise ValueError(
            "invalid scheduler configuration:\n  " + "\n  ".join(errs)
        )
