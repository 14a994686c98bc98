"""Node context for the static row builders — the one piece of
``kubetpu/state/encode_cache.py`` the slice needs.

The encoder builds a ``NodeCtx`` per batch when no encode cache is in use
(``encoder.encode_pod_batch``). The cross-cycle ``EncodeCache`` itself is
not ported: the port's scheduler encodes every batch afresh.
"""

# Port copy of NodeCtx and build_node_ctx from kubetpu/state/encode_cache.py,
# verbatim.

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class NodeCtx:
    """Node-side facts the static row builders consume, hoisted once per
    node epoch (they only change when a node is added/updated/removed —
    exactly the events that bump the epoch): taint tuples, the
    unschedulable mask, and declared-feature sets."""

    node_taints: list               # per node: tuple of taints
    tainted_nodes: list             # [(node_idx, taints)] for tainted only
    node_unsched: np.ndarray        # (N,) bool
    any_unsched: bool
    node_feature_sets: list | None  # per node set() or None when none declare


def build_node_ctx(nt) -> NodeCtx:
    node_taints = [info.node.taints for info in nt.infos]
    tainted = [(i, tt) for i, tt in enumerate(node_taints) if tt]
    unsched = np.array(
        [info.node.unschedulable for info in nt.infos], dtype=bool
    )
    feature_sets = (
        [set(info.node.declared_features) for info in nt.infos]
        if any(info.node.declared_features for info in nt.infos) else None
    )
    return NodeCtx(
        node_taints=node_taints,
        tainted_nodes=tainted,
        node_unsched=unsched,
        any_unsched=bool(unsched.any()),
        node_feature_sets=feature_sets,
    )
