"""Constraint-based packing engine — cluster-level objectives on the card.

Port of ``kubetpu/assign/packing.py``. The third engine solves a penalized
LP-relaxation of the bin-pack over the same ``(pods × nodes × resources)``
tensors as the greedy and batched engines, maximizing

    priority-weighted admission  −  α·nodes-opened  −  β·fragmentation

as rounds of a fixed-point projection loop. Each round:

1. ``feasible_and_scores`` gives the exact hard-constraint mask and the
   profile score (B3);
2. the **packing utility** replaces the raw score as the argmax key: the
   row-normalized score (tiebreak weight) minus the node's penalty — α on
   a still-empty node, β times its emptiness, its dual price λ, a
   low-index bias on empty nodes, and, with a topology block, the slice
   terms of ``ops.topology.slice_occupancy``;
3. **banded tie-spread** (``_banded_tie_choice``): nodes within ``tie_band``
   of a pod's best utility form one tie class, and the class's pods fan
   across it by rank;
4. **priority-ordered multi-admission** (``_accept_packed``): every chooser
   whose prefix (in priority order, within its node's chooser set) still
   fits the node is admitted, at most one coupled pod (ports, spread or
   affinity updates) a node;
5. **dual ascent**: λ rises by ``dual_step · log1p(overflow)`` where this
   round's choices collided, clipped to ``[0, α · lam_cap_frac]``.

After the loop the warm-start output is the equalization price over the
start-state node utilities (λ_j = relu(v_j − v_marginal) over the nodes
this solve used), and the objective is recorded.

On a CUDA batch ``packing_assign_device`` launches the hand-written
``packing_round`` kernels (``kernels/csrc/packing_round.cu``): a prologue,
then ``filter_score`` and one ``packing_round`` launch a round from the
host, then an epilogue. ``packing_assign_plain`` is the plain PyTorch
version, the reference's solve op for op, which a CPU batch runs and the
kernels are held to. Over a sharded batch (``parallel.mesh.ShardedBatch``:
a pods x nodes grid, or a node mesh, which is one pod row) the solve runs
on every tile and combines the tiles' partials at each reduction over
nodes and each read of every pod: ``packing_assign_tiled_plain`` on CPU
tiles, kernel K8 (``packing_round.cu``'s tile mode; K5 on one pod row) on
CUDA ones.

The reference's float32 arithmetic runs through XLA on the CPU, which
contracts a multiply feeding an add into one fused multiply-add wherever
the host has FMA. The utility, the penalty, the dual ascent and its
``log1p`` (XLA's own float32 log, a Cephes polynomial) are therefore
rounded here as XLA rounds them: ``fma32`` where XLA fuses, a separately
rounded operation where it does not. The objective is a float32 sum whose
order differs between the reference, this version and the kernel; it
agrees within ``rtol=1e-5``. Every other output is exact.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

import torch

from ..framework import runtime as rt
from .batched import I64_MIN, tie_weights

# fixed-point scale for the float packing utility before it enters the
# int64 banded tie-spread argmax (20 fractional bits; utilities are O(1))
_UTIL_SCALE = float(1 << 20)


@dataclass(frozen=True)
class PackingWeights:
    """Objective weights, host-side view of the ``(10,)`` float32 tensor
    the solver reads, in the reference's index order:

    ``score_weight``    — profile score (row-normalized) as tiebreak pull.
    ``priority_weight`` — per-priority-point admission bonus in the
                          objective (admission order uses raw priority).
    ``alpha_open``      — penalty for placing on a node with zero pods.
    ``beta_frag``       — penalty ∝ target-node emptiness (best-fit pull).
    ``dual_step``       — λ ascent step per ``log1p`` overflow unit.
    ``dual_decay``      — per-cycle multiplicative λ decay (0 disables the
                          warm start).
    ``tie_band``        — utility width within which nodes tie.
    ``lam_cap_frac``    — λ clip ceiling as a fraction of ``alpha_open``.
    ``slice_frag``      — penalty for landing in a fully free slice.
    ``slice_align``     — reward for landing in a slice already in use.
    """

    score_weight: float = 0.25
    priority_weight: float = 0.1
    alpha_open: float = 1.0
    beta_frag: float = 0.5
    dual_step: float = 0.1
    dual_decay: float = 0.9
    tie_band: float = 0.15
    lam_cap_frac: float = 2.0
    slice_frag: float = 0.5
    slice_align: float = 0.25

    def tensor(self, device="cuda") -> torch.Tensor:
        """The ``(10,)`` float32 tensor the solver consumes."""
        return torch.tensor(
            [
                self.score_weight, self.priority_weight, self.alpha_open,
                self.beta_frag, self.dual_step, self.dual_decay,
                self.tie_band, self.lam_cap_frac,
                self.slice_frag, self.slice_align,
            ],
            dtype=torch.float32, device=device,
        )

    def to_json(self) -> dict:
        return {
            "score_weight": self.score_weight,
            "priority_weight": self.priority_weight,
            "alpha_open": self.alpha_open,
            "beta_frag": self.beta_frag,
            "dual_step": self.dual_step,
            "dual_decay": self.dual_decay,
            "tie_band": self.tie_band,
            "lam_cap_frac": self.lam_cap_frac,
            "slice_frag": self.slice_frag,
            "slice_align": self.slice_align,
        }


def fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add. The
    product of two float32 values is exact in float64; the sum is rounded
    to float64 by round-to-odd (the TwoSum error decides the last bit), and
    a round-to-odd result with 29 spare bits rounds to float32 exactly as
    the unrounded sum would."""
    p = a.double() * b.double()
    cd = c.double() if isinstance(c, torch.Tensor) else torch.tensor(
        float(c), dtype=torch.float64, device=p.device)
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _f32(bits: str) -> float:
    """A float32 constant from the hex of its float64 widening."""
    return struct.unpack(">d", bytes.fromhex(bits))[0]


# XLA's CPU float32 log (a Cephes polynomial): its coefficients
_LOG_P = tuple(_f32(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000",
))
_LOG_Q1 = _f32("BF2BD01060000000")
_LOG_Q2 = _f32("3FE6300000000000")
_SQRT_HALF = _f32("3FE6A09E60000000")


def log1p_counts(k: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of a float32 tensor of non-negative whole numbers (the
    dual ascent's overflow counts), bit for bit as XLA computes it on the
    CPU: 0 at 0, else its float32 log of ``k + 1`` — exponent and mantissa
    split at √½, three degree-2 polynomials joined in Horner form, every
    multiply-add fused (``fma32``), and the exponent terms
    ``e·q1`` and ``e·q2`` added around ``x − x²/2``. ``torch.log1p`` rounds
    differently for some counts (6, 46, 48, ...)."""
    f = torch.float32
    y = k + 1.0
    bits = y.view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(f)
    e = ((bits >> 23) - 127).to(f) + 1.0
    small = m < _SQRT_HALF
    e = e - small.to(f)
    x = (m - 1.0) + torch.where(small, m, torch.zeros((), dtype=f, device=k.device))
    x2 = x * x
    x3 = x2 * x

    def const(v):
        return torch.tensor(v, dtype=f, device=k.device)

    p0, p1, p2, p3, p4, p5, p6, p7, p8 = (const(v) for v in _LOG_P)
    y1 = fma32(fma32(x, p0, p1), x, p2)
    y2 = fma32(fma32(x, p3, p4), x, p5)
    y3 = fma32(fma32(x, p6, p7), x, p8)
    poly = fma32(fma32(y1, x3, y2), x3, y3)
    r = fma32(poly, x3, e * const(_LOG_Q1))
    out = ((x - x2 * 0.5) + r) + e * const(_LOG_Q2)
    return torch.where(k == 0, torch.zeros((), dtype=f, device=k.device), out)


def _banded_tie_choice(mask, util, active, band):
    """Per-pod target node: the batched engine's tie-spread argmax with the
    tie predicate widened from ``== best`` to ``>= best − band``. Returns
    (P,) int32, -1 = no feasible node. The reference's uint64 group hash
    is int64 here (wrapping sum, xor with ``best * 2``): only equality of
    hashes is read, so the signed sort order changes no rank."""
    p, n = mask.shape
    dev = mask.device
    feasible = mask & active[:, None]
    any_f = torch.any(feasible, dim=1)
    masked = torch.where(feasible, util, I64_MIN)
    best = torch.max(masked, dim=1).values                  # (P,)
    ties = feasible & (masked >= best[:, None] - band)      # (P, N)

    w = tie_weights(n, dev)
    h = torch.sum(torch.where(ties, w[None, :], 0), dim=1)
    h = h ^ (best * 2)
    h = torch.where(any_f & active, h, 0)

    iota = torch.arange(p, dtype=torch.int32, device=dev)
    sh, si = torch.sort(h, stable=True)
    new_seg = torch.ones(p, dtype=torch.bool, device=dev)
    new_seg[1:] = sh[1:] != sh[:-1]
    seg_start = torch.cummax(torch.where(new_seg, iota, 0), dim=0).values
    rank = torch.zeros(p, dtype=torch.int32, device=dev)
    rank[si] = iota - seg_start

    cnt = torch.sum(ties, dim=1).to(torch.int32)
    r = torch.where(cnt > 0, rank % torch.clamp(cnt, min=1), 0)
    # the (r+1)-th True column of the tie row
    csum = torch.cumsum(ties.to(torch.int32), dim=1)
    choice = torch.argmax((csum == (r[:, None] + 1)).to(torch.int8), dim=1)
    return torch.where(any_f & active, choice.to(torch.int32), -1).to(torch.int32)


def _priority_order(priority, pod_valid):
    """(P,) int32 rank of each pod under (priority desc, queue order asc):
    rank 0 schedules first. Invalid pods sink to the end."""
    p = priority.shape[0]
    dev = priority.device
    iota = torch.arange(p, dtype=torch.int64, device=dev)
    key = torch.where(pod_valid, -priority.to(torch.int64), 2**40) * p + iota
    _, si = torch.sort(key)
    order = torch.zeros(p, dtype=torch.int32, device=dev)
    order[si] = iota.to(torch.int32)
    return order


def _accept_packed(choice, requests, free, count_room, order, coupled,
                   check_capacity=True):
    """Priority-ordered multi-admission: every pod whose prefix (by
    admission ``order``, within its target node's chooser set) still fits
    the node's free capacity and pod-count room is admitted — every chooser
    counts in the prefix, rejected ones too. Without ``check_capacity``
    (NodeResourcesFit filter off) every chooser passes that check. At most
    ONE ``coupled`` pod is admitted per node per round (a rejected coupled
    chooser counts too)."""
    p = requests.shape[0]
    n = free.shape[0]
    dev = choice.device
    iota = torch.arange(p, dtype=torch.int64, device=dev)
    key = torch.where(choice >= 0, choice, n).to(torch.int64)   # inactive last
    # sort by (node, order): order is a permutation, so the key is unique
    _, si = torch.sort(key * p + order.to(torch.int64))
    sk = key[si]
    ok = sk < n
    first = torch.ones(p, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    seg_pos = torch.cummax(torch.where(first, iota, 0), dim=0).values
    if check_capacity:
        node = torch.clamp(sk, max=n - 1)
        s_req = requests[si].to(torch.int64)
        cum = torch.cumsum(s_req, dim=0)
        base = (cum - s_req)[seg_pos]
        within = cum - base                                  # inclusive
        cnt = iota - seg_pos + 1                             # 1-based rank
        ok = (
            ok
            & torch.all(within <= free[node], dim=1)
            & (cnt <= count_room[node])
        )
    s_c = coupled[si].to(torch.int64)
    cum_c = torch.cumsum(s_c, dim=0)
    c_within = cum_c - (cum_c - s_c)[seg_pos]               # inclusive
    ok = ok & ((s_c == 0) | (c_within == 1))
    accepted = torch.zeros(p, dtype=torch.bool, device=dev)
    accepted[si] = ok
    return accepted & (choice >= 0)


def coupled_pods(b: rt.DeviceBatch) -> torch.Tensor:
    """(P,) bool: pods whose landing mutates constraint state other pods'
    round-start masks read (host ports, spread counts, affinity sums)."""
    coupled = torch.any(b.pod_ports, dim=1)
    if b.spread is not None:
        coupled = coupled | torch.any(b.spread.pod_match_sig, dim=1)
    if b.podaffinity is not None:
        coupled = coupled | torch.any(b.podaffinity.update != 0, dim=1)
    return coupled


def emptiness(b: rt.DeviceBatch, requested: torch.Tensor) -> torch.Tensor:
    """(N,) float32 mean free fraction over the capacity-bearing resources
    (the best-fit pull: fuller nodes read lower), summed in resource order
    as the reference's row reduce."""
    has_cap = (b.alloc > 0) & b.node_valid[:, None]
    res_n = torch.clamp(torch.sum(has_cap, dim=1), min=1).to(torch.float32)
    alloc_f = torch.clamp(b.alloc, min=1).to(torch.float32)
    free_frac = torch.where(
        has_cap, (b.alloc - requested).to(torch.float32) / alloc_f, 0.0)
    acc = torch.zeros(b.alloc.shape[0], dtype=torch.float32, device=b.device)
    for r in range(free_frac.shape[1]):
        acc = acc + free_frac[:, r]
    return acc / res_n


def _closed_terms(b, requested, pod_count, weights, offset: int = 0):
    """The penalty's closed-node terms as XLA rounds them: ``base =
    fma(β, emptiness, α·closed)`` and the low-index bias's factors
    ``(closed·n, 2·band)``, whose product the caller fuses into the add
    that takes it (after λ, in the rounds). ``n`` is the GLOBAL node index:
    a node shard's rows start at ``offset`` (with its local index every
    shard would open its own row 0 first)."""
    closed = (pod_count == 0) & b.node_valid
    iota = torch.arange(offset, offset + b.alloc.shape[0],
                        device=b.device).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=b.device)
    base = fma32(weights[3], emptiness(b, requested),
                 torch.where(closed, weights[2], zero))
    return base, torch.where(closed, iota, zero), 2.0 * weights[6]


def node_penalty(b, requested, pod_count, lam, weights) -> torch.Tensor:
    """(N,) float32 penalty of landing on each node this round:
    α·closed + β·emptiness + λ + bias, then the slice terms (through
    ``ops.topology.slice_occupancy``, from the CURRENT requested rows)."""
    from ..ops.reduce import run_local

    return run_local(node_penalty_steps(b, requested, pod_count, lam, weights))


def node_penalty_steps(b, requested, pod_count, lam, weights, offset: int = 0):
    """``node_penalty`` in steps form (``ops.reduce``) over a node shard
    whose rows start at global node ``offset``: the slice occupancy is the
    one reduction over nodes (a slice's nodes may span shards)."""
    base, bias_n, band2 = _closed_terms(b, requested, pod_count, weights, offset)
    pen = fma32(bias_n, band2, base + lam)
    if b.topology is not None:
        from ..ops.topology import slice_occupancy_steps

        sid, n_sl = b.topology.slice_id, b.topology.num_slices
        s_active, _ = yield from slice_occupancy_steps(requested, b.node_valid, sid, n_sl)
        busy = s_active[sid.long()]
        labeled = sid < n_sl
        in_free = (labeled & ~busy).to(torch.float32)
        in_active = (labeled & busy).to(torch.float32)
        pen = pen + (weights[8] * in_free - weights[9] * in_active)
    return pen


def packing_utility(mask, score, pen, w_score, row_max=None) -> torch.Tensor:
    """(P, N) int64 utility: ``round((w_score·norm − pen) · 2^20)`` on the
    mask, ``I64_MIN`` off it; norm is the score over the row's largest
    feasible |score| (at least 1). ``row_max`` (P, 1), when given, is that
    maximum taken over every node shard (``row_abs_max``)."""
    score_f = torch.where(mask, score, 0).to(torch.float32)
    if row_max is None:
        row_max = row_abs_max(mask, score)
    norm = score_f / torch.clamp(row_max, min=1.0)
    util_f = fma32(w_score, norm, -pen[None, :])
    return torch.where(
        mask, torch.round(util_f * _UTIL_SCALE).to(torch.int64), I64_MIN)


def row_abs_max(mask, score) -> torch.Tensor:
    """(P, 1) float32: each row's largest feasible |score| as float32, 0
    without a feasible node. A maximum is exact in any order, so over node
    shards the shards' row maxima combine by max to the same bits."""
    score_f = torch.where(mask, score, 0).to(torch.float32)
    return torch.max(torch.where(mask, torch.abs(score_f), 0.0), dim=1,
                     keepdim=True).values


def packing_prologue_plain(b: rt.DeviceBatch, lam: torch.Tensor,
                           weights: torch.Tensor):
    """The solve's start: ``(order (P,) int32, coupled (P,) bool, λ ·
    decay)``."""
    p = b.requests.shape[0]
    prio = (b.pod_priority if b.pod_priority is not None
            else torch.zeros(p, dtype=torch.int32, device=b.device))
    return _priority_order(prio, b.pod_valid), coupled_pods(b), lam * weights[5]


def packing_round_plain(b, params, state, active, assignments, lam, weights,
                        order, coupled):
    """One round of the solve against ``state`` (requested, nonzero,
    pod_count, node_ports, spread_counts, pa_sums, nom_active). Returns
    ``(state, active, assignments, lam, progress)``, fresh tensors."""
    (requested, nonzero, pod_count, node_ports, spread_counts, pa_sums,
     nom_active) = state
    p = b.requests.shape[0]
    n = b.alloc.shape[0]
    dev = b.device
    step = weights[4]
    lam_cap = weights[2] * weights[7]
    band = torch.round(weights[6] * _UTIL_SCALE).to(torch.int64)
    mask, score = rt.feasible_and_scores(
        b, params,
        requested=requested, nonzero_requested=nonzero,
        pod_count=pod_count, node_ports=node_ports,
        spread_counts=spread_counts, pa_sums=pa_sums,
        nominated_active=nom_active,
    )
    pen = node_penalty(b, requested, pod_count, lam, weights)
    util = packing_utility(mask, score, pen, weights[0])
    choice = _banded_tie_choice(mask, util, active, band)
    accepted = _accept_packed(
        choice, b.requests,
        free=b.alloc - requested,
        count_room=b.allowed_pods - pod_count,
        order=order, coupled=coupled,
        check_capacity=params.filter_fit,
    )
    # dual ascent on the overflow (choosers that did not fit this round)
    seg_all = torch.where(choice >= 0, choice, n).long()
    rej = (active & (choice >= 0) & ~accepted).to(torch.float32)
    over = torch.zeros(n + 1, dtype=torch.float32, device=dev).index_add_(
        0, seg_all, rej)[:n]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lam = torch.minimum(torch.maximum(
        fma32(step, log1p_counts(over), lam), zero), lam_cap)
    # every admitted pod commits; a pod with no feasible node finalizes
    # only if it precedes every rejection in admission order
    rejected = active & (choice >= 0) & ~accepted
    first_rej = torch.min(torch.where(rejected, order, p))
    finalize = active & (choice < 0) & (order < first_rej)
    seg = torch.where(accepted, choice, n).long()           # N = drop bucket
    a64 = accepted.to(torch.int64)

    def seg_sum(vals):
        out = torch.zeros((n + 1,) + vals.shape[1:], dtype=vals.dtype, device=dev)
        return out.index_add_(0, seg, vals)[:n]

    requested = requested + seg_sum(b.requests * a64[:, None])
    nonzero = nonzero + seg_sum(b.nonzero_requests * a64[:, None])
    pod_count = pod_count + seg_sum(accepted.to(pod_count.dtype))
    node_ports = node_ports | (
        seg_sum(b.pod_ports.to(torch.int64) * a64[:, None]) > 0)
    if spread_counts is not None:
        sp = b.spread
        # the reference's int32 einsum of pod_match_sig with the accepted
        # one-hots, as a segment sum over the chosen nodes
        upd = seg_sum(sp.pod_match_sig.to(spread_counts.dtype)).T
        spread_counts = spread_counts + upd * sp.eligible.to(upd.dtype)
    if pa_sums is not None:
        pa = b.podaffinity
        r_rows, d = pa_sums.shape
        safe_choice = torch.clamp(choice, min=0).long()
        dcol = pa.node_domain[:, safe_choice].T           # (P, R)
        valid = (dcol >= 0) & accepted[:, None]
        inc = torch.where(valid, pa.update, 0)
        flat_ids = torch.where(
            valid,
            torch.arange(r_rows, device=dev)[None, :] * d + torch.clamp(dcol, min=0),
            r_rows * d,
        ).long()
        flat = torch.zeros(r_rows * d + 1, dtype=torch.int64, device=dev)
        flat.index_add_(0, flat_ids.reshape(-1), inc.reshape(-1))
        pa_sums = pa_sums + flat[: r_rows * d].reshape(r_rows, d)
    if nom_active is not None:
        idx = b.nominated_pod_idx
        consumed = (idx >= 0) & accepted[torch.clamp(idx, min=0).long()]
        nom_active = nom_active & ~consumed
    assignments = torch.where(accepted, choice, assignments)
    active = active & ~accepted & ~finalize
    progress = torch.any(accepted | finalize)
    state = (requested, nonzero, pod_count, node_ports, spread_counts, pa_sums,
             nom_active)
    return state, active, assignments, lam, progress


def packing_epilogue_plain(b, requested, pod_count, assignments, lam, weights):
    """The solve's end: the equalization prices over the start-state node
    utilities (λ unchanged when the solve used no node), the objective
    (() float32) and nodes used (() int32). Returns ``(lam, objective,
    nodes_used)``."""
    p = b.requests.shape[0]
    dev = b.device
    alpha, beta = weights[2], weights[3]
    lam_cap = alpha * weights[7]
    base, bias_n, band2 = _closed_terms(b, b.requested, b.pod_count, weights)
    v0 = -fma32(bias_n, band2, base)
    used = (pod_count > b.pod_count) & b.node_valid
    v_marg = torch.min(torch.where(used, v0, math.inf))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lam_eq = torch.minimum(torch.maximum(v0 - v_marg, zero), lam_cap)
    lam = torch.where(torch.any(used), lam_eq, lam)
    prio = (b.pod_priority if b.pod_priority is not None
            else torch.zeros(p, dtype=torch.int32, device=dev))
    admitted = (assignments >= 0) & b.pod_valid
    admission = torch.sum(torch.where(
        admitted, 1.0 + weights[1] * prio.to(torch.float32), 0.0))
    open_nodes = (pod_count > 0) & b.node_valid
    nodes_used = torch.sum(open_nodes).to(torch.int32)
    frag = torch.sum(torch.where(open_nodes, emptiness(b, requested), 0.0))
    objective = admission - alpha * nodes_used.to(torch.float32) - beta * frag
    if b.topology is not None:
        # slices this solve opened from fully free
        from ..ops.topology import slice_occupancy

        sid, n_sl = b.topology.slice_id, b.topology.num_slices
        act0, _ = slice_occupancy(b.requested, b.node_valid, sid, n_sl)
        act1, _ = slice_occupancy(requested, b.node_valid, sid, n_sl)
        newly = torch.sum((act1[:n_sl] & ~act0[:n_sl]).to(torch.float32))
        objective = objective - weights[8] * newly
    return lam, objective, nodes_used


def packing_assign_plain(
    b: rt.DeviceBatch, params: rt.ScoreParams, lam: torch.Tensor,
    weights: torch.Tensor, max_iters: int = 0,
):
    """The plain PyTorch solve. ``lam`` is the (N,) float32 warm-start dual
    vector (not written), ``weights`` the (10,) ``PackingWeights`` tensor.
    Returns ``(assignments (P,) int32, final_state, lam (N,) float32,
    objective () float32, iters int, nodes_used () int32)``; the final
    state has the reference's seven slots. The loop condition is read on
    the host once per round; ``max_iters`` 0 means P."""
    p = b.requests.shape[0]
    cap = max_iters or p
    order, coupled, lam = packing_prologue_plain(b, lam, weights)
    state = (
        b.requested, b.nonzero_requested, b.pod_count, b.node_ports,
        None if b.spread is None else b.spread.node_count,
        None if b.podaffinity is None else b.podaffinity.base_sums,
        None if b.nominated_pod_idx is None
        else torch.ones(b.nominated_pod_idx.shape[0], dtype=torch.bool,
                        device=b.device),
    )
    active = b.pod_valid
    assignments = torch.full((p,), -1, dtype=torch.int32, device=b.device)
    progress = True
    iters = 0
    while progress and iters < cap and bool(torch.any(active)):
        state, active, assignments, lam, progress = packing_round_plain(
            b, params, state, active, assignments, lam, weights, order, coupled)
        progress = bool(progress)
        iters += 1
    lam, objective, nodes_used = packing_epilogue_plain(
        b, state[0], state[2], assignments, lam, weights)
    return assignments, state, lam, objective, iters, nodes_used


def packing_assign_tiled_plain(sb, params: rt.ScoreParams, lam_pieces, weights: torch.Tensor,
                               max_iters: int = 0, rows_out: list | None = None):
    """The plain solve over a sharded batch (``parallel.mesh.ShardedBatch``:
    a pods x nodes grid, or a node mesh, which is one pod row), the
    reference's loop body with every reduction over nodes a combine point
    (``ops.reduce.combine``) and every read of all pods a point of the pod
    axis. Each round: every pod row's Filter + Score on its tiles and its
    node penalties (the GLOBAL node index in the closed-node bias, the
    slice occupancy summed over the row's columns), in lockstep over the
    row's columns (``mesh.run_sharded``); each pod row's row maxima of
    |score| (max over its columns); the banded tie choice with the rows'
    per-pod vectors joined in pod order before the rank
    (``batched._tie_spread_choice_tiles``); then every tile admits, over
    the choosers of every pod row, the pods that chose its column's nodes
    (``_accept_packed``, from every pod's leaves, ``ShardedBatch.gathered``;
    combined by any) and raises λ on its own copy of the column's nodes by
    their rejected choosers; the first rejection over all P in admission
    ``order``; every tile commits every admitted pod of its column to its
    own copy of the column's rows, so the pod rows' copies stay equal, and
    each pod row's affinity increments sum over its columns once. At the
    end the combines run over the columns once (pod row 0's tiles: the
    rows are equal copies): the marginal utility (min), whether any node
    was used (max), the nodes used and the fragmentation (sums, the
    float32 one in column order) and the slices newly opened. The start
    (admission order, coupled pods) reads every pod. ``lam_pieces``: a
    (N / NG,) float32 warm-start piece a tile, in tile order (each column's
    repeated down the pod rows). Returns ``packing_assign_plain``'s
    six-tuple, the node slots of the final state from pod row 0's tiles
    and λ, every tile's piece, as ``mesh.ShardedTensor``s; ``rows_out``,
    when given, receives every pod row's (requested, nonzero, pod_count,
    node_ports, spread_counts)."""
    from ..ops.reduce import combine
    from ..ops.topology import slice_occupancy_steps
    from ..parallel.mesh import ShardedTensor, run_sharded
    from .batched import _row_slots, _tie_spread_choice_tiles

    tiles, offsets, mesh = sb.shards, sb.offsets, sb.mesh
    PG, NG = sb.pod_rows, sb.columns
    full = sb.gathered.shards
    home = tiles[0].device
    p = sb.num_pods
    cap = max_iters or p
    ws = [weights.to(s.device) for s in tiles]
    band = torch.round(weights[6] * _UTIL_SCALE).to(torch.int64).to(home)
    f0 = full[0]
    order, coupled, _ = packing_prologue_plain(f0, lam_pieces[0], ws[0])
    lam = [x * w[5] for x, w in zip(lam_pieces, ws)]
    req = [s.requested for s in tiles]
    nz = [s.nonzero_requested for s in tiles]
    pc = [s.pod_count for s in tiles]
    ports = [s.node_ports for s in tiles]
    sp_counts = [None if s.spread is None else s.spread.node_count for s in tiles]
    pa_sums = [None if s.podaffinity is None else s.podaffinity.base_sums for s in tiles]
    nom = [
        None if s.nominated_pod_idx is None
        else torch.ones(s.nominated_pod_idx.shape[0], dtype=torch.bool, device=s.device)
        for s in tiles
    ]
    active = f0.pod_valid.to(home)
    assignments = torch.full((p,), -1, dtype=torch.int32, device=home)
    zero = torch.zeros((), dtype=torch.float32, device=home)
    progress = True
    iters = 0
    while progress and iters < cap and bool(torch.any(active)):
        masks, utils = [], []
        for i in range(PG):
            ts = range(i * NG, (i + 1) * NG)
            outs = run_sharded([
                rt.feasible_and_scores_steps(
                    tiles[t], params, requested=req[t], nonzero_requested=nz[t],
                    pod_count=pc[t], node_ports=ports[t], spread_counts=sp_counts[t],
                    pa_sums=pa_sums[t], nominated_active=nom[t])
                for t in ts
            ], mesh.row(i))
            pens = run_sharded([
                node_penalty_steps(tiles[t], req[t], pc[t], lam[t], ws[t], offsets[t % NG])
                for t in ts
            ], mesh.row(i))
            row_max = combine("max", [row_abs_max(m, x).to(home) for m, x in outs])
            masks.append([m for m, _ in outs])
            utils.append([packing_utility(m, x, pen, ws[t][0], row_max.to(m.device))
                          for (m, x), pen, t in zip(outs, pens, ts)])
        choice = _tie_spread_choice_tiles(masks, utils, active, offsets, band=band)
        local, accepted_t = [], []
        for t, s in enumerate(tiles):
            j, dev = t % NG, s.device
            n = s.alloc.shape[0]
            c = choice.to(dev) - offsets[j]
            mine = (choice.to(dev) >= 0) & (c >= 0) & (c < n)
            c = torch.where(mine, c, -1).to(torch.int32)
            local.append(c)
            accepted_t.append(_accept_packed(
                c, full[j].requests.to(dev), free=s.alloc - req[t],
                count_room=s.allowed_pods - pc[t], order=order.to(dev),
                coupled=coupled.to(dev), check_capacity=params.filter_fit,
            ).to(home))
        accepted = combine("max", accepted_t)
        # each tile's dual ascent on its copy of its column's nodes, by the
        # rejected choosers of every pod row
        rejected = active & (choice >= 0) & ~accepted
        for t, s in enumerate(tiles):
            n, dev, w = s.alloc.shape[0], s.device, ws[t]
            seg_all = torch.where(local[t] >= 0, local[t], n).long()
            over = torch.zeros(n + 1, dtype=torch.float32, device=dev).index_add_(
                0, seg_all, rejected.to(dev).to(torch.float32))[:n]
            lam[t] = torch.minimum(torch.maximum(
                fma32(w[4], log1p_counts(over), lam[t]), zero.to(dev)), w[2] * w[7])
        first_rej = torch.min(torch.where(rejected, order, p))
        finalize = active & (choice < 0) & (order < first_rej)
        flat_rows: list = [[] for _ in range(PG)]
        for t, s in enumerate(tiles):
            i, j = divmod(t, NG)
            f, dev = full[j], s.device
            n = s.alloc.shape[0]
            acc = accepted.to(dev) & (local[t] >= 0)
            seg = torch.where(acc, local[t], n).long()
            a64 = acc.to(torch.int64)

            def seg_sum(vals, n=n, seg=seg, dev=dev):
                out = torch.zeros((n + 1,) + vals.shape[1:], dtype=vals.dtype, device=dev)
                return out.index_add_(0, seg, vals.to(dev))[:n]

            req[t] = req[t] + seg_sum(f.requests.to(dev) * a64[:, None])
            nz[t] = nz[t] + seg_sum(f.nonzero_requests.to(dev) * a64[:, None])
            pc[t] = pc[t] + seg_sum(acc.to(pc[t].dtype))
            ports[t] = ports[t] | (seg_sum(f.pod_ports.to(dev).to(torch.int64) * a64[:, None]) > 0)
            if sp_counts[t] is not None:
                upd = seg_sum(f.spread.pod_match_sig.to(dev).to(sp_counts[t].dtype)).T
                sp_counts[t] = sp_counts[t] + upd * s.spread.eligible.to(upd.dtype)
            if pa_sums[t] is not None:
                r_rows, d = pa_sums[t].shape
                dcol = s.podaffinity.node_domain[:, torch.clamp(local[t], min=0).long()].T
                valid = (dcol >= 0) & acc[:, None]
                inc = torch.where(valid, f.podaffinity.update.to(dev), 0)
                flat_ids = torch.where(
                    valid,
                    torch.arange(r_rows, device=dev)[None, :] * d + torch.clamp(dcol, min=0),
                    r_rows * d,
                ).long()
                flat = torch.zeros(r_rows * d + 1, dtype=torch.int64, device=dev)
                flat.index_add_(0, flat_ids.reshape(-1), inc.reshape(-1))
                flat_rows[i].append(flat[: r_rows * d].reshape(r_rows, d).to(home))
        for i, parts in enumerate(flat_rows):
            if parts:
                inc = combine("sum", parts)
                for t in range(i * NG, (i + 1) * NG):
                    pa_sums[t] = pa_sums[t] + inc.to(pa_sums[t].device)
        if nom[0] is not None:
            for t, s in enumerate(tiles):
                idx = s.nominated_pod_idx
                consumed = (idx >= 0) & accepted.to(s.device)[torch.clamp(idx, min=0).long()]
                nom[t] = nom[t] & ~consumed
        assignments = torch.where(accepted, choice, assignments)
        active = active & ~accepted & ~finalize
        progress = bool(torch.any(accepted | finalize))
        iters += 1
    # the end: the combines over the columns once (pod row 0's tiles), then
    # every tile's equalization prices
    w0 = ws[0]
    alpha, beta = w0[2], w0[3]
    v0, used = [], []
    for t, s in enumerate(tiles):
        base, bias_n, band2 = _closed_terms(s, s.requested, s.pod_count, ws[t], offsets[t % NG])
        v0.append(-fma32(bias_n, band2, base))
        used.append((pc[t] > s.pod_count) & s.node_valid)
    row0 = range(NG)
    v_marg = combine("min", [torch.min(torch.where(used[t], v0[t], math.inf)).reshape(1)
                             .to(home) for t in row0])
    any_used = combine("max", [torch.any(used[t]).reshape(1).to(home) for t in row0])
    for t, s in enumerate(tiles):
        dev, w = s.device, ws[t]
        lam_eq = torch.minimum(torch.maximum(v0[t] - v_marg.to(dev), zero.to(dev)), w[2] * w[7])
        lam[t] = torch.where(any_used.to(dev), lam_eq, lam[t])
    prio = (f0.pod_priority if f0.pod_priority is not None
            else torch.zeros(p, dtype=torch.int32, device=home))
    admitted = (assignments >= 0) & f0.pod_valid
    admission = torch.sum(torch.where(
        admitted, 1.0 + w0[1] * prio.to(torch.float32), 0.0))
    opened = [(pc[t] > 0) & tiles[t].node_valid for t in row0]
    nodes_used = combine("sum", [torch.sum(o).to(torch.int32).reshape(1).to(home)
                                 for o in opened])[0]
    frag = combine("sum", [torch.sum(torch.where(o, emptiness(tiles[t], req[t]), 0.0))
                           .reshape(1).to(home) for t, o in zip(row0, opened)])[0]
    objective = admission - alpha * nodes_used.to(torch.float32) - beta * frag
    if f0.topology is not None:
        n_sl = f0.topology.num_slices
        acts = []
        for rows in ([tiles[t].requested for t in row0], req[:NG]):
            acts.append(run_sharded([
                slice_occupancy_steps(r, tiles[t].node_valid, tiles[t].topology.slice_id, n_sl)
                for r, t in zip(rows, row0)
            ], mesh.row(0))[0][0].to(home))
        act0, act1 = acts
        newly = torch.sum((act1[:n_sl] & ~act0[:n_sl]).to(torch.float32))
        objective = objective - w0[8] * newly
    if rows_out is not None:
        rows_out.extend(_row_slots(req, nz, pc, ports, sp_counts, i, NG) for i in range(PG))
    state = _row_slots(req, nz, pc, ports, sp_counts, 0, NG) + (pa_sums[0], nom[0])
    return assignments, state, ShardedTensor(lam, rows=PG), objective, iters, nodes_used


def packing_assign_device(
    b, params: rt.ScoreParams, lam, weights: torch.Tensor, max_iters: int = 0,
):
    """One packing solve. A CUDA batch launches the ``packing_round``
    kernel, one launch a solve (on copies of the node state: the batch's
    node block, which may be the scheduler's resident block, is never
    written); a CPU batch
    runs ``packing_assign_plain``. A sharded batch
    (``parallel.mesh.ShardedBatch``, a node mesh or a pods x nodes grid;
    ``lam`` a ``mesh.ShardedTensor`` of its tiles' pieces) runs the tiled
    solve: kernel K8 on CUDA tiles (K5 on one pod row),
    ``packing_assign_tiled_plain`` on CPU ones. Same return shape as
    ``packing_assign_plain``."""
    from ..parallel.mesh import ShardedBatch

    if isinstance(b, ShardedBatch):
        pieces = list(lam.pieces)
        if b.device.type == "cpu":
            return packing_assign_tiled_plain(b, params, pieces, weights, max_iters)
        from ..kernels import tiled_packing_assign

        return tiled_packing_assign(b, params, pieces, weights, max_iters)
    if b.device.type == "cpu":
        return packing_assign_plain(b, params, lam, weights, max_iters)
    from ..kernels import packing_assign

    return packing_assign(b, params, lam, weights, max_iters)


class PackingEngine:
    """The registered ``engine="packing"`` callable: the scheduler's
    ``(DeviceBatch, ScoreParams) -> (assignments, final_state)`` contract
    wrapping :func:`packing_assign_device` plus the cross-cycle solver
    state: the ``PackingSolverState`` dual block (warm start), the
    ``PackingWeights`` tensor, and the last solve's diagnostics
    (``last_objective`` / ``last_nodes_used`` — tensors on the batch's
    device, which the scheduler fetches with the assignments — and
    ``last_iters``, an int). ``device``: where the duals live; ``mesh``
    (a node mesh or a pods x nodes grid): the duals live sharded with the
    batch's node rows, a piece a tile, and a ``ShardedBatch`` runs the
    tiled solve. Under a mesh the gang lane's group cycles solve unsharded
    batches, as the reference's do: the duals of a padded capacity pass
    between the layouts with their values (gathered onto the batch's
    device for an unsharded solve, split by tile for a sharded one)."""

    def __init__(self, weights: PackingWeights | None = None, mesh=None,
                 device="cuda"):
        self.weights = weights or PackingWeights()
        self.state = rt.PackingSolverState(mesh=mesh, device=device)
        self._w: torch.Tensor | None = None
        self.last_objective = None
        self.last_iters = None
        self.last_nodes_used = None

    def bind_mesh(self, mesh) -> None:
        self.state.bind_mesh(mesh)

    def __call__(self, b, params: rt.ScoreParams):
        if self._w is None:
            self._w = self.weights.tensor(b.device)
        from ..parallel.mesh import ShardedBatch, ShardedTensor

        sharded = isinstance(b, ShardedBatch)
        n = (sum(int(s.alloc.shape[0]) for s in b.shards[:b.columns]) if sharded
             else b.alloc.shape[0])
        lam = self.state.duals(n)
        if sharded and not isinstance(lam, ShardedTensor):
            lam = ShardedTensor.split(lam, b)
        elif not sharded:
            lam = lam.gather(b.device) if isinstance(lam, ShardedTensor) else lam.to(b.device)
        assignments, final_state, lam_out, objective, iters, nodes_used = (
            packing_assign_device(b, params, lam, self._w)
        )
        self.state.store(n, lam_out)
        self.last_objective = objective
        self.last_iters = iters
        self.last_nodes_used = nodes_used
        return assignments, final_state
