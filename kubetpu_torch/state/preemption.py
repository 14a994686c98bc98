# Port copy of kubetpu/state/preemption.py, verbatim apart from this note (no JAX in it).
"""Victim-slot tensor encoding for preemption.

The reference's preemption dry run copies one NodeInfo at a time and mutates
its pod list (``SelectVictimsOnNode``, framework/plugins/defaultpreemption/
default_preemption.go:252). The TPU analog needs the *per-pod-on-node*
breakdown as dense tensors: each node gets K victim slots carrying priority,
start time, resource usage, port usage counts, and PDB membership, so the
whole victim search runs as one vmapped program over all nodes at once
(vs. the reference's parallel-for over a sampled candidate subset,
framework/preemption/preemption.go:404 DryRunPreemption).

Port usage is encoded as per-triple *counts* (not the boolean union the
NodePorts filter uses): removing a victim must not free a port another
remaining pod still holds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..api import types as t
from ..api.selectors import label_selector_matches
from . import encoder as enc
from .encoder import NodeTensors, _pod_port_triples
from .snapshot import Snapshot


@dataclass
class VictimTensors:
    """Per-node victim slots, padded to K = max pods on any node.

    ``uids[n][k]`` maps slot k of node n back to the pod uid (host side, for
    actuation); invalid slots are None.
    """

    uids: list[list[str | None]]
    valid: np.ndarray          # (N, K) bool
    priority: np.ndarray       # (N, K) int64
    start: np.ndarray          # (N, K) int64 — creation_index stand-in for
    #                            pod start time (util.GetPodStartTime)
    requests: np.ndarray       # (N, K, R) int64 — exact requests view
    port_counts: np.ndarray    # (N, Kp) int32 — pods-per-triple on the node
    victim_ports: np.ndarray   # (N, K, Kp) int8 — victim's triples (0/1)
    pdb: np.ndarray            # (N, K, D) bool — victim matches PDB d
    pdb_allowed: np.ndarray    # (D,) int64 — status.disruptionsAllowed

    @property
    def num_slots(self) -> int:
        return self.valid.shape[1]


def encode_victims(
    nt: NodeTensors,
    port_vocab_size: int,
    port_vocab,
    pdbs: tuple[t.PodDisruptionBudget, ...] = (),
    pad_slots: int | None = None,
) -> VictimTensors:
    """Build victim tensors from the encoded snapshot's NodeInfos.

    ``port_vocab`` must be the SAME interning used for the batch's
    pod_ports/node_ports/port_conflict tensors (encoder._encode_ports) so the
    preemption kernel's port math composes with the filter's conflict matrix.
    """
    infos = nt.infos
    N = nt.alloc.shape[0]            # padded node capacity
    R = nt.num_resources
    K = max((len(info.pods) for info in infos), default=0)
    K = max(enc.round_up(K, minimum=4) if pad_slots is None else pad_slots, 1)
    Kp = max(port_vocab_size, 1)
    D = max(len(pdbs), 1)

    uids: list[list[str | None]] = [[None] * K for _ in range(N)]
    valid = np.zeros((N, K), dtype=bool)
    priority = np.zeros((N, K), dtype=np.int64)
    start = np.zeros((N, K), dtype=np.int64)
    requests = np.zeros((N, K, R), dtype=np.int64)
    port_counts = np.zeros((N, Kp), dtype=np.int32)
    victim_ports = np.zeros((N, K, Kp), dtype=np.int8)
    pdb = np.zeros((N, K, D), dtype=bool)
    ridx = {r: i for i, r in enumerate(nt.resource_names)}

    for n_i, info in enumerate(infos):
        for k_i, pod in enumerate(info.pods.values()):
            uids[n_i][k_i] = pod.uid
            valid[n_i, k_i] = True
            priority[n_i, k_i] = pod.priority
            start[n_i, k_i] = pod.creation_index
            for rname, v in pod.requests:
                j = ridx.get(rname)
                if j is not None:
                    requests[n_i, k_i, j] = v
            for triple in _pod_port_triples(pod):
                tid = port_vocab.get(triple)
                if tid is not None and tid >= 0:
                    port_counts[n_i, tid] += 1
                    victim_ports[n_i, k_i, tid] = 1
            labels = pod.labels_dict()
            for d_i, b in enumerate(pdbs):
                # default_preemption.go:416-443: namespace match, non-empty
                # selector match, and not already in status.disruptedPods.
                if b.namespace != pod.namespace or not labels:
                    continue
                if b.selector is None:
                    continue
                if (
                    not b.selector.match_labels
                    and not b.selector.match_expressions
                ):
                    continue  # empty selector matches nothing (policy/v1)
                if pod.name in b.disrupted_pods:
                    continue
                if label_selector_matches(b.selector, labels):
                    pdb[n_i, k_i, d_i] = True

    pdb_allowed = np.zeros(D, dtype=np.int64)
    for d_i, b in enumerate(pdbs):
        pdb_allowed[d_i] = b.disruptions_allowed

    return VictimTensors(
        uids=uids,
        valid=valid,
        priority=priority,
        start=start,
        requests=requests,
        port_counts=port_counts,
        victim_ports=victim_ports,
        pdb=pdb,
        pdb_allowed=pdb_allowed,
    )
