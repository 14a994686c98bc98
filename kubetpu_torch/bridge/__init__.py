"""Extender webhook bridge — serve Filter/Prioritize/Bind/Preempt to a real
kube-scheduler over the extender JSON protocol
(staging/src/k8s.io/kube-scheduler/extender/v1/types.go).

Port of ``kubetpu/bridge``: ``quantity`` and ``convert`` are copies of the
reference's; ``server``'s verbs run on the backend's device."""

from .convert import node_from_v1, pod_from_v1
from .quantity import canonical_resource, parse_quantity, quantity_to_int, quantity_to_milli
from .server import ExtenderBackend, ExtenderServer

__all__ = [
    "ExtenderBackend",
    "ExtenderServer",
    "canonical_resource",
    "node_from_v1",
    "parse_quantity",
    "pod_from_v1",
    "quantity_to_int",
    "quantity_to_milli",
]
