# Port copy of kubetpu/api/selectors.py, verbatim apart from this note (no JAX in it).
"""Host-side selector evaluation.

Pure-Python (numpy-free) predicate evaluation used by the tensorization layer
to precompute boolean match matrices; the device kernels only ever see the
resulting masks. Semantics mirror the reference helpers:

- metav1 LabelSelector matching: apimachinery ``labels.Requirement.Matches``
  (NotIn/DoesNotExist match when the key is absent).
- NodeSelector matching: ``component-helpers/scheduling/corev1/nodeaffinity``
  (terms are ORed; expressions within a term are ANDed; a term with no
  expressions and no fields matches nothing; Gt/Lt parse integers).
- Taint toleration: ``component-helpers/scheduling/corev1``
  ``Toleration.ToleratesTaint``.
"""

from __future__ import annotations

from typing import Mapping

from .types import (
    LabelSelector,
    NodeSelector,
    NodeSelectorTerm,
    Operator,
    Requirement,
    Taint,
    TaintEffect,
    Toleration,
)


def requirement_matches(req: Requirement, labels: Mapping[str, str]) -> bool:
    has = req.key in labels
    val = labels.get(req.key)
    op = req.operator
    if op == Operator.IN:
        return has and val in req.values
    if op == Operator.NOT_IN:
        return (not has) or val not in req.values
    if op == Operator.EXISTS:
        return has
    if op == Operator.DOES_NOT_EXIST:
        return not has
    if op in (Operator.GT, Operator.LT):
        if not has or len(req.values) != 1:
            return False
        try:
            lhs = int(val)  # type: ignore[arg-type]
            rhs = int(req.values[0])
        except ValueError:
            return False
        return lhs > rhs if op == Operator.GT else lhs < rhs
    raise ValueError(f"unknown operator {op}")


def label_selector_matches(sel: LabelSelector, labels: Mapping[str, str]) -> bool:
    """Empty selector matches everything (metav1 semantics)."""
    for k, v in sel.match_labels:
        if labels.get(k) != v:
            return False
    for req in sel.match_expressions:
        if req.operator in (Operator.GT, Operator.LT):
            # metav1 LabelSelector does not allow Gt/Lt; treat as no match.
            return False
        if not requirement_matches(req, labels):
            return False
    return True


def node_selector_term_matches(
    term: NodeSelectorTerm, labels: Mapping[str, str], node_name: str
) -> bool:
    if not term.match_expressions and not term.match_fields:
        return False  # nil/empty term selects no objects
    for req in term.match_expressions:
        if not requirement_matches(req, labels):
            return False
    for req in term.match_fields:
        if req.key != "metadata.name":
            return False
        if not requirement_matches(req, {"metadata.name": node_name}):
            return False
    return True


def node_selector_matches(
    sel: NodeSelector, labels: Mapping[str, str], node_name: str
) -> bool:
    """OR over terms. An empty term list matches nothing."""
    return any(
        node_selector_term_matches(t, labels, node_name) for t in sel.terms
    )


def tolerates(tol: Toleration, taint: Taint) -> bool:
    """staging/src/k8s.io/api/core/v1/toleration.go ToleratesTaint: the key
    check is skipped entirely for an empty key (so empty-key+Equal compares
    values, and empty-key+Exists tolerates everything)."""
    if tol.effect is not None and tol.effect != taint.effect:
        return False
    if tol.key != "" and tol.key != taint.key:
        return False
    if tol.operator.value == "Exists":
        return True
    return tol.value == taint.value


def find_untolerated_taint(
    taints: tuple[Taint, ...],
    tolerations: tuple[Toleration, ...],
    effects: tuple[TaintEffect, ...] = (TaintEffect.NO_SCHEDULE, TaintEffect.NO_EXECUTE),
) -> Taint | None:
    """First taint with one of ``effects`` that no toleration tolerates
    (v1helper.FindMatchingUntoleratedTaint, as the TaintToleration filter uses)."""
    for taint in taints:
        if taint.effect not in effects:
            continue
        if not any(tolerates(t, taint) for t in tolerations):
            return taint
    return None


def parse_simple_selector(s: str) -> tuple[tuple[str, bool, str], ...]:
    """Parse the ``k=v,k2!=v2`` list/watch selector string (the subset of
    labels.Parse / fields.ParseSelector the reference's list options use:
    ``=``, ``==``, ``!=``) into ``(key, equals, value)`` terms. An empty
    string selects everything. Malformed terms raise ValueError (the
    apiserver's 400 on a bad selector)."""
    terms: list[tuple[str, bool, str]] = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        if "!=" in part:
            k, _, v = part.partition("!=")
            eq = False
        elif "==" in part:
            k, _, v = part.partition("==")
            eq = True
        elif "=" in part:
            k, _, v = part.partition("=")
            eq = True
        else:
            raise ValueError(f"malformed selector term {part!r}")
        k = k.strip()
        if not k:
            raise ValueError(f"malformed selector term {part!r}")
        terms.append((k, eq, v.strip()))
    return tuple(terms)


# fieldSelector paths the server understands (the reference's supported
# fields per resource — registry strategies' GetAttrs; spec.nodeName is the
# kubelet's pod watch, pkg/registry/core/pod/strategy.go NodeNameTriggerFunc)
def object_field(obj, path: str) -> str | None:
    if path == "metadata.name":
        return getattr(obj, "name", None)
    if path == "metadata.namespace":
        return getattr(obj, "namespace", None)
    if path == "spec.nodeName":
        return getattr(obj, "node_name", None)
    if path == "status.phase":
        return getattr(obj, "phase", None)
    if path == "spec.schedulerName":
        return getattr(obj, "scheduler_name", None)
    return None


def simple_selector_matches(
    terms: tuple[tuple[str, bool, str], ...], get
) -> bool:
    """``get(key) -> str | None``; a None field only matches ``!=``."""
    for key, eq, value in terms:
        got = get(key)
        if eq:
            if got != value:
                return False
        elif got == value:
            return False
    return True


def object_matches_selectors(
    obj,
    label_terms: tuple[tuple[str, bool, str], ...] = (),
    field_terms: tuple[tuple[str, bool, str], ...] = (),
) -> bool:
    if label_terms:
        labels = getattr(obj, "labels_dict", dict)()
        if not simple_selector_matches(label_terms, labels.get):
            return False
    if field_terms:
        if not simple_selector_matches(
            field_terms, lambda p: object_field(obj, p)
        ):
            return False
    return True


def count_intolerable_prefer_no_schedule(
    taints: tuple[Taint, ...], tolerations: tuple[Toleration, ...]
) -> int:
    """TaintToleration Score raw value
    (tainttoleration/taint_toleration.go:163): count PreferNoSchedule taints
    not tolerated by the pod's PreferNoSchedule-or-effectless tolerations."""
    prefer_tols = tuple(
        t for t in tolerations
        if t.effect is None or t.effect == TaintEffect.PREFER_NO_SCHEDULE
    )
    n = 0
    for taint in taints:
        if taint.effect != TaintEffect.PREFER_NO_SCHEDULE:
            continue
        if not any(tolerates(t, taint) for t in prefer_tols):
            n += 1
    return n
