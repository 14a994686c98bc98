"""The pieces of ``kubetpu/state/encode_cache.py`` the port's encoders need.

The encoder builds a ``NodeCtx`` per batch when no encode cache is in use
(``encoder.encode_pod_batch``); the inter-pod affinity encoder
(``state.podaffinity``) groups the assigned pods by template
(``collect_pod_groups`` and its helpers). The cross-cycle ``EncodeCache``
itself is not ported (ROADMAP Queue A item 5): the port's scheduler encodes
every batch afresh, so every ``cache`` argument here is None.
"""

# Port copy of NodeCtx, build_node_ctx, template_key, groups_for,
# pod_gids_for, collapse_label_groups and collect_pod_groups from
# kubetpu/state/encode_cache.py, verbatim.

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


def template_key(pod) -> tuple:
    """The pod's TEMPLATE identity: every spec fact the per-pod halves of
    the spread/affinity encoders read. Pods stamped from one controller
    template share it, so per-pod work collapses to per-template work.
    Index [0:3] — (labels, namespace, affinity) — is what the existing-pod
    group consumers (base sums, selector counts) key on."""
    return (
        pod.labels, pod.namespace, pod.affinity,
        pod.topology_spread_constraints, pod.tolerations, pod.node_selector,
    )


def groups_for(nt, cache, groups: dict | None = None) -> dict:
    """The template-group view for an encode: the precomputed ``groups``
    when the caller already built them, else the cache's incremental index,
    else a from-scratch pass. The single place that decides."""
    if groups is not None:
        return groups
    if cache is not None:
        return cache.pod_groups(nt)
    return collect_pod_groups(nt)


def pod_gids_for(pods, cache) -> list:
    """Per-pod template ids for a pending batch: the cache's uid-memoized
    global ids, or call-local first-seen ids when no cache is wired."""
    if cache is not None:
        return [cache.group_id_of(p) for p in pods]
    local: dict = {}
    return [
        local.setdefault(template_key(p), len(local)) for p in pods
    ]


def collapse_label_groups(groups: dict) -> dict:
    """Collapse template groups to ``{(labels, ns): [counts, labels
    dict]}`` — the view selector matching consumes (selectors never look
    past the counted pod's labels and namespace)."""
    out: dict = {}
    for key, vec in groups.items():
        got = out.get(key[:2])
        if got is None:
            out[key[:2]] = [vec.copy(), dict(key[0])]
        else:
            got[0] += vec
    return out


def collect_pod_groups(nt) -> dict:
    """One pass over the snapshot's assigned pods, grouped by TEMPLATE:
    ``{template_key(pod): (N,) int64 per-node counts}``.

    Pods stamped from one controller template share the key, so the group
    count is tiny regardless of pod count — the per-(existing pod × row)
    Python loops in ``state.podaffinity`` / ``state.spread`` collapse to
    per-(template × row) numpy segment sums over these vectors. O(total
    assigned pods) dict work, no row logic per pod. (``EncodeCache.
    pod_groups`` is the incremental O(Δ) twin of this function.)"""
    N = nt.num_nodes
    groups: dict = {}
    for n_i, info in enumerate(nt.infos):
        for q in info.pods.values():
            key = template_key(q)
            vec = groups.get(key)
            if vec is None:
                vec = np.zeros(N, dtype=np.int64)
                groups[key] = vec
            vec[n_i] += 1
    return groups
