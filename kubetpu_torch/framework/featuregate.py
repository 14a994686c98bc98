"""Feature gates — the component-base featuregate analog.

Port copy of ``kubetpu/framework/featuregate.py``, verbatim below this
line: the gang lane reads the GenericWorkload, GangScheduling and
TopologyAwareWorkloadScheduling gates.

Reference: staging/src/k8s.io/component-base/featuregate/feature_gate.go
(:947 ``Enabled``) with the scheduler-relevant registry entries from
pkg/features/kube_features.go (stages as of the 1.37 snapshot):

- GenericWorkload          alpha, default false (kube_features.go:1419)
- GangScheduling           alpha, default false, requires GenericWorkload
  (:1415; dependency map :2348)
- TopologyAwareWorkloadScheduling  alpha, default false, requires
  GenericWorkload (:1966, :2568)
- OpportunisticBatching    beta, default true (:1674)
- SchedulerQueueingHints   GA-ish default true

Unknown names and unmet dependencies fail LOUDLY at construction — the
reference's --feature-gates parsing errors the binary out the same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

ALPHA = "ALPHA"
BETA = "BETA"
GA = "GA"


@dataclass(frozen=True)
class FeatureSpec:
    default: bool
    stage: str = ALPHA
    requires: tuple[str, ...] = ()


KNOWN_FEATURES: dict[str, FeatureSpec] = {
    "GenericWorkload": FeatureSpec(False, ALPHA),
    "GangScheduling": FeatureSpec(False, ALPHA, requires=("GenericWorkload",)),
    "TopologyAwareWorkloadScheduling": FeatureSpec(
        False, ALPHA, requires=("GenericWorkload",)
    ),
    "OpportunisticBatching": FeatureSpec(True, BETA),
    "SchedulerQueueingHints": FeatureSpec(True, BETA),
    # DRA core is GA (resource.k8s.io/v1, kube_features.go DynamicResource-
    # Allocation); the prioritized-list extension is beta default-on
    "DynamicResourceAllocation": FeatureSpec(True, GA),
    "NodeDeclaredFeatures": FeatureSpec(False, ALPHA),
    "DRAPrioritizedList": FeatureSpec(True, BETA),
}


class FeatureGate:
    """Immutable-after-construction gate set (the reference mutates only at
    flag-parse time too)."""

    def __init__(self, overrides: Mapping[str, bool] | None = None) -> None:
        self._enabled = {name: spec.default for name, spec in KNOWN_FEATURES.items()}
        for name, value in (overrides or {}).items():
            if name not in KNOWN_FEATURES:
                raise ValueError(
                    f"unknown feature gate {name!r} "
                    f"(known: {sorted(KNOWN_FEATURES)})"
                )
            self._enabled[name] = bool(value)
        for name, spec in KNOWN_FEATURES.items():
            if self._enabled[name]:
                for dep in spec.requires:
                    if not self._enabled[dep]:
                        raise ValueError(
                            f"feature {name} requires {dep} to be enabled"
                        )

    def enabled(self, name: str) -> bool:
        try:
            return self._enabled[name]
        except KeyError:
            raise ValueError(f"unknown feature gate {name!r}") from None


def default_feature_gates() -> FeatureGate:
    return FeatureGate()
