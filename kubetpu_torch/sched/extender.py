# Port copy of kubetpu/sched/extender.py, verbatim apart from this note (no JAX in it).
"""Scheduler-side extender CLIENT — JSON/HTTP webhook calls out.

Analog of ``pkg/scheduler/extender.go`` (:44 HTTPExtender, :399 ``send``):
the scheduler POSTs ExtenderArgs to each configured extender's Filter verb
(findNodesThatPassExtenders, schedule_one.go:886) and Prioritize verb
(prioritizeNodes :987), merging results as the reference does —
Filter results only SHRINK the candidate set; Prioritize scores are scaled
``score × weight × MaxNodeScore / MaxExtenderPriority``
(schedule_one.go:1015) and added to the plugin total. ``Ignorable``
extenders that fail are skipped (extender.go IsIgnorable); a non-ignorable
failure marks every pod unschedulable for the cycle.

Batch re-shape (documented deviation): the reference calls extenders
per pod mid-cycle, AFTER earlier pods' assumes. Here the whole batch's
Filter/Prioritize calls run concurrently against the CYCLE snapshot and
feed the assignment program as a (P, N) mask and score addend — a
NodeCacheCapable extender that tracks assumes through its own cache (ours
does, bridge/server.py) sees at most one batch of skew, and capacity-type
decisions remain safe because the in-tree fit coupling still applies
inside the device program.
"""

from __future__ import annotations

import json
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..api import types as t
from ..bridge.convert import pod_to_v1
from ..framework.config import ExtenderConfig  # noqa: F401  (config surface)

MAX_EXTENDER_PRIORITY = 10   # extender/v1/types.go:28
MAX_NODE_SCORE = 100


class ExtenderError(Exception):
    pass


class HTTPExtender:
    """One configured extender; thread-safe (stateless per call)."""

    def __init__(self, cfg: ExtenderConfig) -> None:
        self.cfg = cfg

    def _post(self, verb: str, args: dict) -> dict:
        url = self.cfg.url_prefix.rstrip("/") + "/" + verb
        req = urllib.request.Request(
            url, data=json.dumps(args).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.cfg.http_timeout_s) as r:
            return json.loads(r.read())

    def is_interested(self, pod: t.Pod) -> bool:
        """ManagedResources gate (extender.go IsInterested): with managed
        resources configured, only pods requesting one go through."""
        if not self.cfg.managed_resources:
            return True
        managed = set(self.cfg.managed_resources)
        return any(k in managed for k, v in pod.requests if v > 0)

    def filter(
        self, pod: t.Pod, node_names: list[str]
    ) -> tuple[set[str], set[str]]:
        """→ (passing, failed_and_unresolvable). extender.go Filter."""
        args: dict = {"Pod": pod_to_v1(pod)}
        if self.cfg.node_cache_capable:
            args["NodeNames"] = node_names
        else:
            # non-cache-capable extenders get full objects; the scheduling
            # envelope we hold is name+labels+allocatable — callers needing
            # more should run NodeCacheCapable with the delta stream
            args["Nodes"] = {"Items": [
                {"metadata": {"name": n}} for n in node_names
            ]}
        res = self._post(self.cfg.filter_verb, args)
        if res.get("Error"):
            raise ExtenderError(res["Error"])
        if res.get("NodeNames") is not None:
            passing = set(res["NodeNames"])
        elif res.get("Nodes") is not None:
            passing = {
                (n.get("metadata") or {}).get("name")
                for n in res["Nodes"].get("Items") or ()
            }
        else:
            passing = set(node_names)
        unresolvable = set(res.get("FailedAndUnresolvableNodes") or ())
        return passing, unresolvable

    def is_binder(self) -> bool:
        """extender.go IsBinder: a BindVerb makes the extender own the bind
        API call for its managed pods."""
        return bool(self.cfg.bind_verb)

    def bind(self, pod: t.Pod, node_name: str) -> None:
        """extender.go Bind: POST ExtenderBindingArgs; a non-empty Error in
        ExtenderBindingResult fails the binding cycle
        (extender/v1/types.go:106,:117)."""
        res = self._post(self.cfg.bind_verb, {
            "PodName": pod.name,
            "PodNamespace": pod.namespace,
            "PodUID": pod.uid,
            "Node": node_name,
        })
        if res.get("Error"):
            raise ExtenderError(res["Error"])

    def supports_preemption(self) -> bool:
        return bool(self.cfg.preempt_verb)

    def process_preemption(
        self, pod: t.Pod,
        victims_by_node: dict[str, tuple[list[t.Pod], int]],
    ) -> dict[str, tuple[list[str], int]]:
        """extender.go ProcessPreemption: POST the candidate victim map
        (node → Victims{Pods, NumPDBViolations}); the extender returns the
        (possibly trimmed) map as MetaVictims — nodes it drops become
        ineligible for preemption, victim lists may shrink. The evaluator's
        best-candidate pick runs AFTER this trim
        (framework/preemption.PreemptionEvaluator._pick_with_extenders)."""
        args = {
            "Pod": pod_to_v1(pod),
            "NodeNameToVictims": {
                node: {
                    "Pods": [pod_to_v1(v) for v in victims],
                    "NumPDBViolations": n_pdb,
                }
                for node, (victims, n_pdb) in victims_by_node.items()
            },
        }
        res = self._post(self.cfg.preempt_verb, args)
        out: dict[str, tuple[list[str], int]] = {}
        for node, mv in (res.get("NodeNameToMetaVictims") or {}).items():
            out[node] = (
                [(p or {}).get("UID", "")
                 for p in (mv or {}).get("Pods") or ()],
                int((mv or {}).get("NumPDBViolations") or 0),
            )
        return out

    def prioritize(self, pod: t.Pod, node_names: list[str]) -> dict[str, int]:
        """→ {node: raw score 0..MaxExtenderPriority}."""
        args: dict = {"Pod": pod_to_v1(pod)}
        if self.cfg.node_cache_capable:
            args["NodeNames"] = node_names
        else:
            args["Nodes"] = {"Items": [
                {"metadata": {"name": n}} for n in node_names
            ]}
        res = self._post(self.cfg.prioritize_verb, args)
        return {
            h.get("Host", ""): int(h.get("Score", 0)) for h in res or ()
        }


def run_extenders(
    extenders: Sequence[HTTPExtender],
    pods: Sequence[t.Pod],
    node_names: list[str],
    num_nodes: int,
    pad_pods: int,
    pad_nodes: int,
    parallelism: int = 16,
    executor: ThreadPoolExecutor | None = None,
) -> tuple[np.ndarray | None, np.ndarray | None]:
    """The batch's extender pass: per pod, Filter through every extender in
    order (candidates only shrink), then Prioritize with weight scaling.
    Returns ``(mask (PP, NC) bool | None, score (PP, NC) int64 | None)``;
    a pod whose non-ignorable extender call failed gets an all-False row
    (unschedulable this attempt, like the reference's error status)."""
    active = [e for e in extenders if e.cfg.filter_verb or e.cfg.prioritize_verb]
    if not active or not pods:
        return None, None
    mask = np.zeros((pad_pods, pad_nodes), dtype=bool)
    mask[: len(pods), :num_nodes] = True
    score = np.zeros((pad_pods, pad_nodes), dtype=np.int64)

    def one(i: int) -> None:
        pod = pods[i]
        candidates = list(node_names)
        for e in active:
            if not e.is_interested(pod):
                continue
            try:
                if e.cfg.filter_verb and candidates:
                    passing, _ = e.filter(pod, candidates)
                    candidates = [n for n in candidates if n in passing]
                if e.cfg.prioritize_verb:
                    raw = e.prioritize(pod, node_names)
                    w = e.cfg.weight * MAX_NODE_SCORE // MAX_EXTENDER_PRIORITY
                    for j, name in enumerate(node_names):
                        score[i, j] += raw.get(name, 0) * w
            except Exception:
                if e.cfg.ignorable:
                    continue   # skip a dead ignorable extender
                candidates = []
                break
        allowed = set(candidates)
        for j, name in enumerate(node_names):
            if name not in allowed:
                mask[i, j] = False

    if executor is not None:
        # long-lived pool supplied by the scheduler (the reference reuses
        # its parallelizer's worker set — no per-cycle thread churn)
        list(executor.map(one, range(len(pods))))
    else:
        with ThreadPoolExecutor(max_workers=max(1, parallelism)) as ex:
            list(ex.map(one, range(len(pods))))
    return mask, score
