"""PodTopologySpread kernels — domain sums, skew filter, log-weighted score.

Port of ``kubetpu/ops/spread.py``: the plain PyTorch versions. The reference
writes each function for ONE pod and vmaps it over the batch
(``runtime.py:1452``, ``:1552``); here each takes the pod axis written out
(slots ``(P, C)``) and returns ``(P, N)``. On a CUDA device the main path
does not call these: ``kernels/csrc/score_common.cuh`` computes the same
terms per (pod, node) pair inside the ``filter_score``, ``greedy_scan`` and
``batched_round`` kernels, and ``chip_smoke.py`` holds them to these.

Reference semantics (pkg/scheduler/framework/plugins/podtopologyspread/):
- Filter (filtering.go:314): per DoNotSchedule constraint,
  ``matchNum + selfMatch − minMatch > maxSkew`` → infeasible; nodes missing
  the topology key are infeasible outright. ``minMatch`` is the minimum
  per-domain match count over counted domains, 0 when
  ``len(domains) < minDomains`` (filtering.go:55 minMatchNum).
- Score (scoring.go:199): per ScheduleAnyway constraint,
  ``cnt·log(size+2) + (maxSkew−1)`` summed over constraints in slot order,
  rounded half to even; then NormalizeScore (scoring.go:229):
  ``MaxNodeScore·(max+min−s)//max`` over scored nodes, ignored → 0,
  max==0 → MaxNodeScore.

``counts`` is the carried (S, N) int32 per-(signature, node) match count;
per-domain sums are segment sums of it over the interned domain ids, and
domain −1 routes to a scratch segment D that reads back as matchNum 0. The
sums and the skew arithmetic are int64 here (the reference's int32 never
overflows at these counts, so the verdicts are the same).
"""

from __future__ import annotations

import torch

from .reduce import run_local

MAX_NODE_SCORE = 100
_BIG = torch.iinfo(torch.int32).max
_I64_MAX = torch.iinfo(torch.int64).max


def _domain_sums(counts, eligible, node_domain, num_domains_total):
    """(S, D+1) int64 per-domain match sums of every signature; slot D is
    the −1 scratch bucket (the reference's ``_domain_sums`` for all S
    signatures at once)."""
    seg = torch.where(node_domain >= 0, node_domain, num_domains_total).long()
    vals = torch.where(eligible, counts, 0).to(torch.int64)
    out = torch.zeros(
        (counts.shape[0], num_domains_total + 1), dtype=torch.int64,
        device=counts.device,
    )
    return out.scatter_add_(1, seg, vals)


def _slot_rows(st, sums, sid):
    """The per-pod rows of one constraint slot: signature ids clamped to 0
    (callers gate on ``sid >= 0``), each pod's (N,) domain row and its
    (N,) matchNum — the domain's sum, 0 where the domain is −1."""
    s = torch.clamp(sid, min=0).long()
    dom = st.node_domain[s]                                   # (P, N)
    d = st.domain_present.shape[1]
    got = torch.gather(sums[s], 1, torch.where(dom >= 0, dom, d).long())
    return s, dom, torch.where(dom >= 0, got, 0)


def spread_filter_steps(st, counts, sig_idx, action, max_skew, min_domains, self_match):
    """``spread_filter_pod`` in steps form (``ops.reduce``): the domain sums
    are its one reduction over nodes."""
    d = st.domain_present.shape[1]
    sums = yield ("sum", _domain_sums(counts, st.eligible, st.node_domain, d))
    return spread_filter_pod(
        st, counts, sig_idx, action, max_skew, min_domains, self_match, sums=sums)


def spread_filter_pod(st, counts, sig_idx, action, max_skew, min_domains, self_match,
                      sums=None):
    """(P, N) bool feasibility under the pods' hard constraints. ``st`` is
    the SpreadDevice; ``counts`` the (S, N) carried state; the remaining
    args are the pods' (P, C) constraint-slot rows. ``sums``: the (S, D+1)
    domain sums when the caller reduced them (derived from ``counts``
    when None)."""
    p = sig_idx.shape[0]
    n = st.eligible.shape[1]
    d = st.domain_present.shape[1]
    if sums is None:
        sums = _domain_sums(counts, st.eligible, st.node_domain, d)   # (S, D+1)
    min_match_sig = torch.min(
        torch.where(st.domain_present, sums[:, :d], _BIG), dim=1
    ).values                                                  # (S,)
    ok = torch.ones((p, n), dtype=torch.bool, device=counts.device)
    for c in range(sig_idx.shape[1]):  # C is a small static bound
        sid = sig_idx[:, c]
        valid = (sid >= 0) & (action[:, c] == 0)
        s, _, match_num = _slot_rows(st, sums, sid)
        min_match = torch.where(
            st.num_domains[s] < min_domains[:, c], 0, min_match_sig[s]
        )                                                     # (P,)
        skew_ok = (
            match_num + self_match[:, c].to(torch.int64)[:, None]
            - min_match[:, None]
        ) <= max_skew[:, c].to(torch.int64)[:, None]
        ok_c = st.has_key[s] & skew_ok
        ok = ok & torch.where(valid[:, None], ok_c, True)
    return ok


def spread_score_pod(st, counts, sig_idx, action, max_skew, ignored, mask):
    """(P, N) int64 normalized spread score. ``mask`` is the pods' final
    feasibility rows (the reference scores only nodes that passed Filter);
    ``ignored`` their soft-ignored rows."""
    return run_local(
        spread_score_steps(st, counts, sig_idx, action, max_skew, ignored, mask))


def spread_score_steps(st, counts, sig_idx, action, max_skew, ignored, mask):
    """``spread_score_pod`` in steps form (``ops.reduce``). Its reductions
    over nodes: the domain sums, the scored-node count, each soft slot's
    domain bitmap, and the scored raw's min and max."""
    p = sig_idx.shape[0]
    n = st.eligible.shape[1]
    d = st.domain_present.shape[1]
    dev = counts.device
    sums = yield ("sum", _domain_sums(counts, st.eligible, st.node_domain, d))
    scored = mask & ~ignored
    n_scored = yield ("sum", torch.sum(scored, dim=1))        # (P,)
    raw = torch.zeros((p, n), dtype=torch.float64, device=dev)
    for c in range(sig_idx.shape[1]):
        sid = sig_idx[:, c]
        valid = (sid >= 0) & (action[:, c] == 1)
        s, dom, dom_count = _slot_rows(st, sums, sid)
        host = st.is_hostname[s]                              # (P,)
        # per-node count: hostname constraints read the node's own count
        # (scoring.go:217), others the node's domain sum
        cnt_node = torch.where(
            host[:, None], counts[s].to(torch.int64), dom_count
        )
        # topology size over *scored* nodes (initPreScoreState topoSize /
        # filteredNodes−ignored for hostname)
        seg = torch.where(dom >= 0, dom, d).long()
        present = torch.zeros((p, d + 1), dtype=torch.int32, device=dev)
        present = yield ("max", present.scatter_reduce_(
            1, seg, scored.to(torch.int32), reduce="amax"
        ))
        size = torch.where(
            host, n_scored, torch.sum(present[:, :d] > 0, dim=1)
        )
        weight = torch.log(size.to(torch.float64) + 2.0)      # (P,)
        contrib = cnt_node.to(torch.float64) * weight[:, None] + (
            max_skew[:, c].to(torch.float64) - 1.0
        )[:, None]
        raw = raw + torch.where(
            valid[:, None] & st.has_key[s], contrib, 0.0
        )
    score = torch.round(raw).to(torch.int64)                  # half to even

    # NormalizeScore (scoring.go:229) over scored nodes
    min_s = yield ("min", torch.min(
        torch.where(scored, score, _I64_MAX), dim=1, keepdim=True).values)
    max_s = yield ("max", torch.max(
        torch.where(scored, score, 0), dim=1, keepdim=True).values)
    # max + min − s only where the node is scored (elsewhere the
    # reference's int64 wraps; the result is masked out either way)
    s_safe = torch.where(scored, score, min_s)
    normalized = torch.where(
        max_s == 0,
        MAX_NODE_SCORE,
        torch.div(
            MAX_NODE_SCORE * (max_s + min_s - s_safe),
            torch.clamp(max_s, min=1), rounding_mode="floor",
        ),
    )
    # a pod with no soft constraints Skips the plugin (scoring.go:149)
    any_soft = torch.any((sig_idx >= 0) & (action == 1), dim=1)
    return torch.where(any_soft[:, None] & scored, normalized, 0)
