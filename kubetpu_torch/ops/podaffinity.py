"""InterPodAffinity kernels — gathers from the carried ``(R, D)`` sums.

Port of ``kubetpu/ops/podaffinity.py``: the plain PyTorch versions. The
reference writes each function for ONE pod and vmaps it over the batch
(``runtime.py:1463``, ``:1559``); here each takes the pod axis written out
(slots ``(P, C)``) and returns ``(P, N)``. On a CUDA device the main path
does not call these: ``kernels/csrc/score_common.cuh`` computes the same
terms per (pod, node) pair inside the ``filter_score``, ``greedy_scan`` and
``batched_round`` kernels, and ``chip_smoke.py`` holds them to these.

Reference checks (pkg/scheduler/framework/plugins/interpodaffinity/):
- Filter (filtering.go:364-419): existing-pods anti-affinity (any node label
  pair with count > 0 → infeasible), incoming anti-affinity (count > 0 at the
  node's domain for any term → infeasible), incoming affinity (every term's
  count > 0 where all term keys exist; self-affinity escape when the global
  map is empty and the pod matches its own terms, filtering.go:414).
- Score (scoring.go:240): Σ over topology maps at the node's values, then
  min-max normalize over filtered nodes (scoring.go:258):
  ``int64(100 · (s − min) / (max − min))``, 0 when max == min, in float64.
"""

from __future__ import annotations

import torch

from .reduce import run_local

MAX_NODE_SCORE = 100
_I64_MAX = torch.iinfo(torch.int64).max


def _slot_counts(pa, sums: torch.Tensor, rid: torch.Tensor) -> torch.Tensor:
    """(P, N) count at each node's domain for one slot's row ids ``rid
    (P,)`` (0 where the key is absent; garbage-safe for rid < 0 — callers
    gate on validity)."""
    r = torch.clamp(rid, min=0).long()
    dom = pa.node_domain[r]                                   # (P, N) int32
    got = torch.gather(sums[r], 1, torch.clamp(dom, min=0).long())
    return torch.where(dom >= 0, got, 0)


def affinity_filter_pod(pa, sums, fa_rows, fa_self, ra_rows, ea_rows):
    """(P, N) bool. ``fa_rows (P, CA)``, ``ra_rows (P, CR)``, ``ea_rows (P,
    CE)`` are the pods' row-id slots (−1 unused), ``fa_self (P,)``."""
    p = fa_rows.shape[0]
    n = pa.node_domain.shape[1]
    dev = sums.device
    row_total = sums.sum(dim=1)                               # (R,)

    # incoming required affinity (satisfyPodAffinity)
    keys_ok = torch.ones((p, n), dtype=torch.bool, device=dev)
    pods_exist = torch.ones((p, n), dtype=torch.bool, device=dev)
    set_total = torch.zeros(p, dtype=torch.int64, device=dev)
    any_fa = torch.any(fa_rows >= 0, dim=1)                   # (P,)
    for c in range(fa_rows.shape[1]):
        rid = fa_rows[:, c]
        valid = (rid >= 0)[:, None]
        r = torch.clamp(rid, min=0).long()
        cnt = _slot_counts(pa, sums, rid)
        keys_ok = keys_ok & torch.where(valid, pa.has_key[r], True)
        pods_exist = pods_exist & torch.where(valid, cnt > 0, True)
        set_total = set_total + torch.where(rid >= 0, row_total[r], 0)
    escape = (set_total == 0) & fa_self                       # (P,)
    fa_ok = torch.where(
        any_fa[:, None], keys_ok & (pods_exist | escape[:, None]), True
    )

    # incoming required anti-affinity (satisfyPodAntiAffinity)
    ra_ok = torch.ones((p, n), dtype=torch.bool, device=dev)
    for c in range(ra_rows.shape[1]):
        rid = ra_rows[:, c]
        valid = (rid >= 0)[:, None]
        r = torch.clamp(rid, min=0).long()
        cnt = _slot_counts(pa, sums, rid)
        ra_ok = ra_ok & torch.where(valid, ~(pa.has_key[r] & (cnt > 0)), True)

    # existing pods' anti-affinity (satisfyExistingPodsAntiAffinity): only
    # rows whose term matches the pod are in its ea slots
    affected = torch.zeros((p, n), dtype=torch.bool, device=dev)
    for c in range(ea_rows.shape[1]):
        rid = ea_rows[:, c]
        valid = (rid >= 0)[:, None]
        cnt = _slot_counts(pa, sums, rid)
        affected = affected | (valid & (cnt > 0))

    return fa_ok & ra_ok & ~affected


def affinity_score_pod(pa, sums, score_rows, score_vals, mask):
    """(P, N) int64 normalized InterPodAffinity score given the pods'
    feasibility rows ``mask (P, N)``. ``score_rows/score_vals (P, CS)`` are
    the pods' weighted row slots."""
    return run_local(affinity_score_steps(pa, sums, score_rows, score_vals, mask))


def affinity_score_steps(pa, sums, score_rows, score_vals, mask):
    """``affinity_score_pod`` in steps form (``ops.reduce``): the feasible
    raw's min and max are its reductions over nodes (``sums`` is the
    replicated (R, D) state)."""
    p = score_rows.shape[0]
    n = pa.node_domain.shape[1]
    raw = torch.zeros((p, n), dtype=torch.int64, device=sums.device)
    for c in range(score_rows.shape[1]):
        rid = score_rows[:, c]
        cnt = _slot_counts(pa, sums, rid)
        raw = raw + torch.where(
            (rid >= 0)[:, None], score_vals[:, c][:, None] * cnt, 0
        )
    mn = yield ("min", torch.min(
        torch.where(mask, raw, _I64_MAX), dim=1, keepdim=True).values)
    mx = yield ("max", torch.max(
        torch.where(mask, raw, -_I64_MAX), dim=1, keepdim=True).values)
    diff = mx - mn
    f = (
        MAX_NODE_SCORE
        * (raw - mn).to(torch.float64)
        / torch.clamp(diff, min=1).to(torch.float64)
    )
    out = torch.where(diff > 0, f.to(torch.int64), 0)
    return torch.where(mask, out, 0)
