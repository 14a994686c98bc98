"""Batched assignment — capacity-coupled rounds instead of a per-pod scan.

Port of ``kubetpu/assign/batched.py``. The reference solves the whole batch
as a small number of *rounds* under one ``lax.while_loop``, each round:

1. Score all still-unassigned pods against the CURRENT node state (the same
   ``feasible_and_scores`` composition the greedy scan steps through).
2. **Tie-spread argmax** (``_tie_spread_choice``): pods whose (max score,
   tie set) coincide are fanned across their tie set by rank instead of all
   piling onto the first max.
3. **One-per-node queue-order acceptance** (``_accept``): of the pods that
   chose a node, only the first in queue order is admitted this round
   (capacity checked); the queue-order prefix before the first rejection
   commits, and the rest are rescored next round against the updated state.

On a CUDA batch ``batched_assign_device`` launches the hand-written
``batched_round`` solve (``kernels/csrc/batched_round.cu``): one
cooperative launch a batch, the rounds and their stop rule on the device,
read by the host once; ``batched_assign_plain`` is the plain PyTorch
version, the reference's round body op for op, which a CPU batch runs and
the kernel is held to. A sharded batch runs the same rounds over its tiles
(``batched_assign_tiled_plain``; kernel K6, the same solve over the
tiles, one launch a card): a pods x nodes grid, or a node mesh, which is
one pod row.

The reference hashes tie rows in uint64. PyTorch has no uint64 ``<<`` or
comparison, so the hash is int64 here: wrapping multiply, sum, xor and
shift give the same bits, and grouping reads only equality of the hash
(with the queue index as tiebreak), so the signed sort order changes no
rank.
"""

from __future__ import annotations

import torch

from ..framework import runtime as rt

# plain int, as in the reference: the masked score of an infeasible pair
I64_MIN = -(2**62)
_HASH_MUL = 2654435761
_U32 = 0xFFFFFFFF


def tie_weights(n: int, device) -> torch.Tensor:
    """(N,) int64 per-node hash weights: the reference's uint32
    ``iota * 2654435761 + 1`` (wrapping at 2^32), widened."""
    iota = torch.arange(n, dtype=torch.int64, device=device)
    return (iota * _HASH_MUL + 1) & _U32


def _tie_spread_choice(mask, score, active):
    """Per-pod target node: the rank-r pod of each (max score, tie set)
    group takes the (r mod |ties|)-th tie node. Returns (P,) int32, -1 = no
    feasible node."""
    p, n = mask.shape
    dev = mask.device
    feasible = mask & active[:, None]
    any_f = torch.any(feasible, dim=1)
    masked = torch.where(feasible, score, I64_MIN)
    best = torch.max(masked, dim=1).values                  # (P,)
    ties = feasible & (masked == best[:, None])             # (P, N)

    # group hash: a deterministic projection of the tie row and the max
    # score (a collision only merges two groups' rank counters)
    w = tie_weights(n, dev)
    h = torch.sum(torch.where(ties, w[None, :], 0), dim=1)
    h = h ^ (best << 1)
    h = torch.where(any_f & active, h, 0)

    # rank of each pod within its hash group, by pod (queue) order: a
    # stable sort by hash keeps queue order inside a group
    iota = torch.arange(p, dtype=torch.int32, device=dev)
    sh, si = torch.sort(h, stable=True)
    new_seg = torch.ones(p, dtype=torch.bool, device=dev)
    new_seg[1:] = sh[1:] != sh[:-1]
    seg_start = torch.where(new_seg, iota, 0)
    seg_start = torch.cummax(seg_start, dim=0).values
    rank_sorted = iota - seg_start
    rank = torch.zeros(p, dtype=torch.int32, device=dev)
    rank[si] = rank_sorted

    cnt = torch.sum(ties, dim=1).to(torch.int32)            # (P,)
    r = torch.where(cnt > 0, rank % torch.clamp(cnt, min=1), 0)
    # the (r+1)-th True column of the tie row
    csum = torch.cumsum(ties.to(torch.int32), dim=1)        # (P, N)
    choice = torch.argmax((csum == (r[:, None] + 1)).to(torch.int8), dim=1)
    return torch.where(any_f & active, choice.to(torch.int32), -1).to(torch.int32)


def _accept(choice, requests, free, count_room, check_capacity=True):
    """Queue-order admission, at most ONE pod per node per round.

    ``choice`` (P,) target node (-1 = none); ``free`` (N, R) remaining
    resources; ``count_room`` (N,) remaining pod slots. ``check_capacity``
    mirrors the profile's NodeResourcesFit *filter*: without it the greedy
    scan overcommits a node, so the rounds must not re-impose capacity."""
    p = requests.shape[0]
    n = free.shape[0]
    dev = choice.device
    key = torch.where(choice >= 0, choice, n).to(torch.int64)   # inactive last
    # sort by (key, queue index): a stable sort keeps queue order per node
    sk, si = torch.sort(key, stable=True)
    first = torch.ones(p, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    node = torch.clamp(sk, max=n - 1)
    ok = first & (sk < n)
    if check_capacity:
        s_req = requests[si]
        ok = (
            ok
            & torch.all(s_req <= free[node], dim=1)
            & (count_room[node] >= 1)
        )
    accepted = torch.zeros(p, dtype=torch.bool, device=dev)
    accepted[si] = ok
    return accepted & (choice >= 0)


def batched_assign_plain(
    b: rt.DeviceBatch, params: rt.ScoreParams, max_rounds: int = 0,
    rounds_out: list | None = None,
):
    """The plain PyTorch round loop. Same contract as
    ``greedy.greedy_assign_plain``: returns ``(assignments (P,) int32 node
    index or -1, final_state)`` with the 7-slot final-state tuple. The loop
    condition is read on the host once per round. ``rounds_out``, when
    given, receives the number of rounds run."""
    p = b.requests.shape[0]
    n = b.alloc.shape[0]
    dev = b.device
    cap = max_rounds or p
    iota_p = torch.arange(p, dtype=torch.int32, device=dev)
    pa = b.podaffinity

    requested = b.requested
    nonzero = b.nonzero_requested
    pod_count = b.pod_count
    node_ports = b.node_ports
    pa_sums = None if pa is None else pa.base_sums
    sp = b.spread
    spread_counts = None if sp is None else sp.node_count
    nom_active = (
        None if b.nominated_pod_idx is None
        else torch.ones(b.nominated_pod_idx.shape[0], dtype=torch.bool,
                        device=dev)
    )
    active = b.pod_valid
    assignments = torch.full((p,), -1, dtype=torch.int32, device=dev)
    progress = True
    rounds = 0
    while progress and rounds < cap and bool(torch.any(active)):
        mask, score = rt.feasible_and_scores(
            b, params,
            requested=requested, nonzero_requested=nonzero,
            pod_count=pod_count, node_ports=node_ports,
            spread_counts=spread_counts, pa_sums=pa_sums,
            nominated_active=nom_active,
        )
        choice = _tie_spread_choice(mask, score, active)
        accepted = _accept(
            choice, b.requests,
            free=b.alloc - requested,
            count_room=b.allowed_pods - pod_count,
            check_capacity=params.filter_fit,
        )
        # commit only the queue-order prefix before the FIRST rejection;
        # pods with no feasible node inside it finalize as unschedulable
        rejected = active & (choice >= 0) & ~accepted
        first_rej = torch.min(torch.where(rejected, iota_p, p))
        commit = accepted & (iota_p < first_rej)
        finalize = active & (choice < 0) & (iota_p < first_rej)
        accepted = commit
        seg = torch.where(accepted, choice, n).long()       # N = drop bucket
        a64 = accepted.to(torch.int64)

        def seg_sum(vals):
            out = torch.zeros((n + 1,) + vals.shape[1:], dtype=vals.dtype,
                              device=dev)
            return out.index_add_(0, seg, vals)[:n]

        requested = requested + seg_sum(b.requests * a64[:, None])
        nonzero = nonzero + seg_sum(b.nonzero_requests * a64[:, None])
        pod_count = pod_count + seg_sum(accepted.to(pod_count.dtype))
        node_ports = node_ports | (
            seg_sum(b.pod_ports.to(torch.int64) * a64[:, None]) > 0
        )
        if spread_counts is not None:
            # the reference's int32 einsum of pod_match_sig with the
            # accepted one-hots, as a segment sum over the chosen nodes
            # (CUDA has no integer matmul)
            upd = seg_sum(sp.pod_match_sig.to(spread_counts.dtype)).T  # (S, N)
            spread_counts = spread_counts + upd * sp.eligible.to(upd.dtype)
        if pa_sums is not None:
            r_rows, d = pa_sums.shape
            safe_choice = torch.clamp(choice, min=0).long()
            dcol = pa.node_domain[:, safe_choice].T           # (P, R)
            valid = (dcol >= 0) & accepted[:, None]
            inc = torch.where(valid, pa.update, 0)            # (P, R)
            flat_ids = torch.where(
                valid,
                torch.arange(r_rows, device=dev)[None, :] * d
                + torch.clamp(dcol, min=0),
                r_rows * d,                                   # drop bucket
            ).long()
            flat = torch.zeros(r_rows * d + 1, dtype=torch.int64, device=dev)
            flat.index_add_(0, flat_ids.reshape(-1), inc.reshape(-1))
            pa_sums = pa_sums + flat[: r_rows * d].reshape(r_rows, d)
        if nom_active is not None:
            # the round's accepted nominees spend their nominations
            idx = b.nominated_pod_idx
            consumed = (idx >= 0) & accepted[torch.clamp(idx, min=0).long()]
            nom_active = nom_active & ~consumed
        assignments = torch.where(accepted, choice, assignments)
        active = active & ~accepted & ~finalize
        progress = bool(torch.any(accepted | finalize))
        rounds += 1
    if rounds_out is not None:
        rounds_out.append(rounds)
    return assignments, (
        requested, nonzero, pod_count, node_ports, spread_counts, pa_sums,
        nom_active,
    )


def _tie_spread_choice_tiles(masks, scores, active, offsets, band=None):
    """The tie-spread choice over the tiles of a pods x nodes grid:
    ``masks[i][j]`` / ``scores[i][j]`` are pod row i's (P/PG, N/NG) rows of
    node column j, ``offsets`` the columns' first global nodes. With
    ``band`` (int) the tie predicate is the packing engine's ``>= best -
    band`` (``packing._banded_tie_choice``). Inside each
    pod row the columns reduce the per-pod maximum (max), then at it their
    tie counts and the wrapping sums of the tie weights of the GLOBAL node
    indices (sum); the rows' per-pod vectors join in pod order, and the
    hash (xor the best score, once, after the sums) ranks every pod alike
    in queue order; the choice is the (r+1)-th tie column in global order,
    found in the column whose prefix of counts covers it. A node mesh is
    one pod row. Returns (P,) int32 on the first tile's device."""
    from ..ops.reduce import combine

    home = masks[0][0].device
    pb = masks[0][0].shape[0]
    rows = []
    for i, (row_m, row_s) in enumerate(zip(masks, scores)):
        act = active[i * pb:(i + 1) * pb]
        feas = [m & act.to(m.device)[:, None] for m in row_m]
        any_f = combine("max", [torch.any(f, dim=1).to(home) for f in feas])
        masked = [torch.where(f, x, I64_MIN) for f, x in zip(feas, row_s)]
        best = combine("max", [torch.max(x, dim=1).values.to(home) for x in masked])
        if band is None:
            ties = [f & (x == best.to(x.device)[:, None]) for f, x in zip(feas, masked)]
        else:
            ties = [f & (x >= (best - band).to(x.device)[:, None])
                    for f, x in zip(feas, masked)]
        h = combine("sum", [
            torch.sum(torch.where(
                t, tie_weights(t.shape[1] + o, t.device)[o:][None, :], 0), dim=1).to(home)
            for t, o in zip(ties, offsets)
        ])
        counts = [torch.sum(t, dim=1).to(torch.int32).to(home) for t in ties]
        rows.append((any_f, best, h, counts, ties))
    # the pod rows' per-pod vectors, joined in pod order
    any_f = torch.cat([r[0] for r in rows])
    best = torch.cat([r[1] for r in rows])
    h = torch.cat([r[2] for r in rows])
    cnt = torch.cat([combine("sum", r[3]) for r in rows])
    h = h ^ (best << 1)
    h = torch.where(any_f & active, h, 0)
    p = h.shape[0]
    iota = torch.arange(p, dtype=torch.int32, device=home)
    sh, si = torch.sort(h, stable=True)
    new_seg = torch.ones(p, dtype=torch.bool, device=home)
    new_seg[1:] = sh[1:] != sh[:-1]
    seg_start = torch.cummax(torch.where(new_seg, iota, 0), dim=0).values
    rank = torch.zeros(p, dtype=torch.int32, device=home)
    rank[si] = iota - seg_start
    r = torch.where(cnt > 0, rank % torch.clamp(cnt, min=1), 0)
    choice = torch.full((p,), -1, dtype=torch.int32, device=home)
    for i, (_, _, _, counts, ties) in enumerate(rows):
        lo = i * pb
        r_i = r[lo:lo + pb]
        before = torch.zeros(pb, dtype=torch.int32, device=home)
        for t, c, o in zip(ties, counts, offsets):
            here = (r_i >= before) & (r_i < before + c)
            csum = torch.cumsum(t.to(torch.int32), dim=1)
            target = (r_i - before + 1).to(t.device)
            col = torch.argmax((csum == target[:, None]).to(torch.int8), dim=1).to(home)
            choice[lo:lo + pb] = torch.where(here, (col + o).to(torch.int32),
                                             choice[lo:lo + pb])
            before = before + c
    return torch.where(any_f & active, choice, -1).to(torch.int32)


def batched_assign_tiled_plain(tb, params: rt.ScoreParams, max_rounds: int = 0,
                               rounds_out: list | None = None,
                               rows_out: list | None = None):
    """The plain round loop over a sharded batch
    (``parallel.mesh.ShardedBatch``: a pods x nodes grid, or a node mesh,
    which is one pod row). Each round: every pod row's Filter + Score on
    its tiles, its node columns in lockstep (``mesh.run_sharded``);
    the tie-spread choice with the rows' per-pod vectors joined in pod
    order before the rank (``_tie_spread_choice_tiles``); then every tile
    admits, over the choices of every pod row, the pods that chose its
    column's nodes (``_accept``: one a node, queue order, capacity, from
    every pod's leaves, ``ShardedBatch.gathered``); the admissions combine
    (any), the prefix before the first rejection over all P commits, and
    every tile applies every committed pod of its column to its own copy
    of the column's rows, so the pod rows' copies stay equal; each pod
    row's affinity increments sum over its columns into its tiles'
    replicated sums. Same return as ``greedy.greedy_assign_tiled_plain``
    (the node slots from pod row 0's tiles); ``rows_out``, when given, receives
    every pod row's (requested, nonzero, pod_count, node_ports,
    spread_counts) as ``mesh.ShardedTensor``s."""
    from ..ops.reduce import combine
    from ..parallel.mesh import ShardedTensor, run_sharded

    tiles, offsets = tb.shards, tb.offsets
    PG, NG = tb.pod_rows, tb.columns
    full = tb.gathered.shards
    home = tiles[0].device
    p = tb.num_pods
    cap = max_rounds or p
    iota_p = torch.arange(p, dtype=torch.int32, device=home)
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
    active = full[0].pod_valid.to(home)
    assignments = torch.full((p,), -1, dtype=torch.int32, device=home)
    progress = True
    rounds = 0
    while progress and rounds < cap and bool(torch.any(active)):
        masks, scores = [], []
        for i in range(PG):
            ts = range(i * NG, (i + 1) * NG)
            outs = run_sharded([
                rt.feasible_and_scores_steps(
                    tiles[t], params, requested=req[t], nonzero_requested=nz[t],
                    pod_count=pc[t], node_ports=ports[t], spread_counts=sp_counts[t],
                    pa_sums=pa_sums[t], nominated_active=nom[t])
                for t in ts
            ], tb.mesh.row(i))
            masks.append([m for m, _ in outs])
            scores.append([x for _, x in outs])
        choice = _tie_spread_choice_tiles(masks, scores, active, offsets)
        local, accepted_t = [], []
        for t, s in enumerate(tiles):
            j = t % NG
            n = s.alloc.shape[0]
            c = choice.to(s.device) - offsets[j]
            mine = (choice.to(s.device) >= 0) & (c >= 0) & (c < n)
            c = torch.where(mine, c, -1).to(torch.int32)
            local.append(c)
            accepted_t.append(_accept(
                c, full[j].requests.to(s.device), free=s.alloc - req[t],
                count_room=s.allowed_pods - pc[t], check_capacity=params.filter_fit,
            ).to(home))
        accepted = combine("max", accepted_t)
        rejected = active & (choice >= 0) & ~accepted
        first_rej = torch.min(torch.where(rejected, iota_p, p))
        commit = accepted & (iota_p < first_rej)
        finalize = active & (choice < 0) & (iota_p < first_rej)
        flat_rows: list = [[] for _ in range(PG)]
        for t, s in enumerate(tiles):
            i, j = divmod(t, NG)
            f, dev = full[j], s.device
            n = s.alloc.shape[0]
            acc = commit.to(dev) & (local[t] >= 0)
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
                consumed = (idx >= 0) & commit.to(s.device)[torch.clamp(idx, min=0).long()]
                nom[t] = nom[t] & ~consumed
        assignments = torch.where(commit, choice, assignments)
        active = active & ~commit & ~finalize
        progress = bool(torch.any(commit | finalize))
        rounds += 1
    if rounds_out is not None:
        rounds_out.append(rounds)
    if rows_out is not None:
        rows_out.extend(_row_slots(req, nz, pc, ports, sp_counts, i, NG) for i in range(PG))
    return assignments, _row_slots(req, nz, pc, ports, sp_counts, 0, NG) + (
        pa_sums[0], nom[0])


def _row_slots(req, nz, pc, ports, sp_counts, i: int, ng: int) -> tuple:
    """Pod row i's node slots of a grid's per-tile state lists, as
    ``mesh.ShardedTensor``s over its columns."""
    from ..parallel.mesh import ShardedTensor

    cols = slice(i * ng, (i + 1) * ng)
    return (ShardedTensor(req[cols]), ShardedTensor(nz[cols]), ShardedTensor(pc[cols]),
            ShardedTensor(ports[cols]),
            None if sp_counts[0] is None else ShardedTensor(sp_counts[cols], axis=1))


def batched_assign_device(
    b, params: rt.ScoreParams, max_rounds: int = 0,
    rounds_out: list | None = None,
):
    """Run the batched assignment. A CUDA batch launches the
    ``batched_round`` solve (one launch a batch); a CPU batch runs
    ``batched_assign_plain``. A sharded batch (``parallel.mesh.ShardedBatch``,
    a node mesh or a pods x nodes grid) runs the tiled rounds: the solve
    over its tiles on CUDA (kernels K2 and K6, one launch a card),
    ``batched_assign_tiled_plain`` on CPU tiles. Same return shape as
    ``batched_assign_plain``."""
    from ..parallel.mesh import ShardedBatch

    if isinstance(b, ShardedBatch):
        if b.device.type == "cpu":
            return batched_assign_tiled_plain(b, params, max_rounds, rounds_out)
        from ..kernels import tiled_batched_assign

        return tiled_batched_assign(b, params, max_rounds, rounds_out)
    if b.device.type == "cpu":
        return batched_assign_plain(b, params, max_rounds, rounds_out)
    from ..kernels import batched_assign

    return batched_assign(b, params, max_rounds, rounds_out)
