# Port copy of kubetpu/names.py, verbatim apart from this note (no JAX in it).
"""Canonical plugin names (pkg/scheduler/framework/plugins/names/names.go:19-42).

Shared by the config layer (framework.config) and the tensorization layer
(state.encoder) — the encoder gates its static predicates on the enabled
filter set without importing the framework package.
"""

NODE_RESOURCES_FIT = "NodeResourcesFit"
NODE_RESOURCES_BALANCED = "NodeResourcesBalancedAllocation"
NODE_AFFINITY = "NodeAffinity"
TAINT_TOLERATION = "TaintToleration"
NODE_NAME = "NodeName"
NODE_PORTS = "NodePorts"
NODE_UNSCHEDULABLE = "NodeUnschedulable"
POD_TOPOLOGY_SPREAD = "PodTopologySpread"
INTER_POD_AFFINITY = "InterPodAffinity"
IMAGE_LOCALITY = "ImageLocality"
DEFAULT_PREEMPTION = "DefaultPreemption"
DEFAULT_BINDER = "DefaultBinder"
PRIORITY_SORT = "PrioritySort"
SCHEDULING_GATES = "SchedulingGates"
VOLUME_RESTRICTIONS = "VolumeRestrictions"
VOLUME_ZONE = "VolumeZone"
NODE_VOLUME_LIMITS = "NodeVolumeLimits"
VOLUME_BINDING = "VolumeBinding"
DYNAMIC_RESOURCES = "DynamicResources"
GANG_SCHEDULING = "GangScheduling"
NODE_DECLARED_FEATURES = "NodeDeclaredFeatures"
POD_GROUP_PODS_COUNT = "PodGroupPodsCount"

ALL_FILTERS = frozenset({
    NODE_RESOURCES_FIT,
    NODE_AFFINITY,
    TAINT_TOLERATION,
    NODE_NAME,
    NODE_PORTS,
    NODE_UNSCHEDULABLE,
    POD_TOPOLOGY_SPREAD,
    INTER_POD_AFFINITY,
    VOLUME_RESTRICTIONS,
    VOLUME_ZONE,
    NODE_VOLUME_LIMITS,
    VOLUME_BINDING,
    DYNAMIC_RESOURCES,
    NODE_DECLARED_FEATURES,
})
