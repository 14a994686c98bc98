"""Preemption evaluator — the host orchestration around the victim search.

Port of ``kubetpu/framework/preemption.py``: the analog of
``pkg/scheduler/framework/preemption/preemption.go`` Evaluator (:65, Preempt
:103) + the DefaultPreemption plugin's policy pieces
(defaultpreemption/default_preemption.go): eligibility (:364
PodEligibleToPreemptOthers), candidate discovery, victim selection, node
choice, and the sequencing of several preemptors in one batch.

The host parts are the reference's numpy code, line for line: the
nomination charging, ``_apply``, and the slot → uid → pod mapping. The
device calls become torch calls on the batch's device: the potential mask
is ``filter_score``'s potential mode on a one-pod view (``kernels.
potential_mask``; ``filter_components`` on the CPU), and the dry run is
kernel B9 (``ops.preemption.dry_run_preemption``). Each ``preempt`` call
ships the host-mutated state (usage, pod counts, port counts, the victims'
validity, the PDB budgets, the live nominations) in one host→device copy;
the victims' immutable tensors (priority, start, requests, ports, PDB
membership) are shipped once per evaluator. ``spans`` accumulates the
seconds of each call's upload, potential mask, dry run and fetch (the two
device spans from CUDA events on a CUDA device).

Differences from the reference scheduler, by design (kept from kubetpu):
- the dry run is exhaustive over ALL resolvable-failure nodes in one device
  program (the reference samples ``calculateNumCandidates`` nodes from a
  random offset, default_preemption.go:219);
- several preemptors in one batch run back-to-back against a host-updated
  victim state, so two preemptors never claim the same victim.

The extender ProcessPreemption seam (``extender_hook``, with
``_pick_with_extenders`` and ``extender_chain_hook``) is the reference's
host code: the dry run's candidate rows are copied to the host and the
pick runs there over the extender chain's survivors.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..api import types as t
from ..ops import preemption as OP
from ..state.preemption import VictimTensors, encode_victims
from . import runtime as rt


def _host(x) -> np.ndarray:
    """A numpy copy of a tensor (any device, or a mesh's ShardedTensor) or
    array."""
    from ..parallel.mesh import ShardedTensor

    if isinstance(x, (torch.Tensor, ShardedTensor)):
        return x.cpu().numpy()
    return np.asarray(x)


# the per-call arrays that hold a row a node (split by shard under a mesh)
_NODE_ROWS = frozenset({
    "requested", "pod_count", "node_ports", "charged_req", "charged_cnt",
    "charged_ports", "valid", "priority", "start", "requests", "victim_ports", "pdb",
})


@dataclass
class PreemptionResult:
    """Mirror of PostFilterResult + Status (preemption.go:87 contract)."""

    status: str                       # "success" | "unschedulable" | "not_eligible"
    node_name: str | None = None      # nominatedNodeName on success
    victim_uids: list[str] = field(default_factory=list)
    victim_pods: list[t.Pod] = field(default_factory=list)
    num_pdb_violations: int = 0
    message: str = ""


class PreemptionEvaluator:
    """Per-batch evaluator. Build once after a failed assignment pass; call
    ``preempt(pod_index)`` for each unschedulable pod, in queue order."""

    def __init__(
        self,
        batch: rt.EncodedBatch,
        params: rt.ScoreParams,
        pdbs: tuple[t.PodDisruptionBudget, ...] = (),
        requested=None,
        pod_count=None,
        node_ports_counts=None,
        spread_counts=None,
        pa_sums=None,
        nominated_active=None,
    ):
        if batch.node_tensors is None:
            raise ValueError("batch was encoded without node_tensors")
        self.batch = batch
        self.params = params
        nt = batch.node_tensors
        kp = int(batch.device.port_conflict.shape[0])
        self.victims: VictimTensors = encode_victims(
            nt, kp, batch.port_vocab, pdbs=pdbs
        )
        # Mutable node usage state (post-assignment view if provided). The
        # victim tensors describe only pods present in the SNAPSHOT; pods the
        # current batch just assumed are part of `requested` but are not
        # preemptable this cycle (their bind is in flight) — same window the
        # reference has between assume and the next informer update.
        self.requested = np.array(_host(
            requested if requested is not None else _node_leaf(batch.device, "requested")
        ))
        self.pod_count = np.array(_host(
            pod_count if pod_count is not None else _node_leaf(batch.device, "pod_count")
        ))
        self.port_counts = np.array(
            _host(node_ports_counts)
            if node_ports_counts is not None
            else self.victims.port_counts
        )
        self.pdb_allowed = self.victims.pdb_allowed.copy()
        # Post-batch spread/affinity state (the engine's final state, on the
        # batch's device): the potential mask must see the batch's OWN
        # assignments, or a node the batch just tipped past max_skew could
        # be nominated.
        self.spread_counts = spread_counts
        self.pa_sums = pa_sums
        # Nomination charging state. ``nominated_active`` (G,) marks
        # nominations NOT consumed by this batch's own assignment pass (a
        # nominee the engine just assigned is already in `requested` —
        # charging its nomination again would double-count). The _nom_node/
        # _nom_req/_nom_gate/_nom_pod_idx/_nom_ports host copies are hoisted
        # once and never change; _nom_active IS mutated by each preempt()
        # call (stale nominations drop as their pods re-preempt).
        b = batch.device
        from ..parallel.mesh import ShardedBatch

        # under a mesh: the sharded batch (each preempt() ships the shards
        # of the pod's pod row their rows, and the dry run reduces over
        # them; a node mesh is one pod row)
        self._sharded = b if isinstance(b, ShardedBatch) else None
        self._pod_requests = _host(b.requests)
        self._pod_ports = _host(b.pod_ports)
        self._port_conflict = _host(b.port_conflict)
        if b.nominated_node is not None:
            self._nom_node = _host(b.nominated_node)
            self._nom_req = _host(b.nominated_req)
            self._nom_gate = _host(b.nominated_gate)
            self._nom_pod_idx = (
                _host(b.nominated_pod_idx)
                if b.nominated_pod_idx is not None
                else np.full(self._nom_node.shape[0], -1, dtype=np.int32)
            )
            self._nom_ports = (
                _host(b.nominated_ports)
                if b.nominated_ports is not None else None
            )
            self._nom_active = (
                np.array(_host(nominated_active))
                if nominated_active is not None
                else np.ones(self._nom_node.shape[0], dtype=bool)
            )
        else:
            self._nom_node = None
        # the victims' immutable tensors on the device, shipped at the
        # first preempt() call
        self._victims_dev: dict[str, torch.Tensor] | None = None
        self.calls = 0
        self.spans = {"upload": 0.0, "potential": 0.0, "dry_run": 0.0, "fetch": 0.0}

    def _upload(self, arrays: dict) -> dict[str, torch.Tensor]:
        dev = self.batch.device.device
        if self._victims_dev is None:
            v = self.victims
            self._victims_dev = rt.upload_packed(dict(
                priority=v.priority, start=v.start, requests=v.requests,
                victim_ports=v.victim_ports, pdb=v.pdb,
            ), dev)
        return rt.upload_packed(arrays, dev)

    def _pod_row(self, i: int):
        """Pod ``i``'s pod row of the sharded batch: ``(its shards, their
        node-axis mesh, i's row within them)``."""
        sb = self._sharded
        r, q = divmod(i, int(sb.shards[0].requests.shape[0]))
        return sb.shards[r * sb.columns:(r + 1) * sb.columns], sb.mesh.row(r), q

    def _upload_shards(self, arrays: dict, shards) -> list[dict[str, torch.Tensor]]:
        """Each of ``shards``' copy of ``arrays`` and of the victims'
        tensors: its rows of the node-axis ones, the rest whole, in one copy
        a shard."""
        sb = self._sharded
        v = self.victims
        arrays = dict(arrays, priority=v.priority, start=v.start, requests=v.requests,
                      victim_ports=v.victim_ports, pdb=v.pdb)
        out = []
        for s, off in zip(shards, sb.offsets):
            n = int(s.alloc.shape[0])
            out.append(rt.upload_packed({
                k: (a[off:off + n] if k in _NODE_ROWS else a) for k, a in arrays.items()
            }, s.device))
        return out

    def _potential_steps(self, shard, g: int, q: int, up: dict):
        """``_potential_mask_plain`` of ``shard`` (node column g, its pod
        row's pod q) in steps form (the spread filter's domain sums reduce
        over the columns)."""
        sp = self.spread_counts
        static, fit, ports_ok, spread_ok, pa_ok, _, _ = yield from rt.filter_components_steps(
            _one_pod_view(shard, q), self.params,
            requested=up["requested"],
            pod_count=up["pod_count"],
            node_ports=up["node_ports"],
            spread_counts=None if sp is None else sp.pieces[g].to(shard.device),
            pa_sums=None if self.pa_sums is None else self.pa_sums.to(shard.device),
            nominated_active=up.get("nom_active"),
        )
        return _potential_of(static, fit, ports_ok, spread_ok, pa_ok)

    def _potential_shards(self, i: int, shards, mesh, q: int, ups) -> list:
        """Pod ``i``'s potential mask over the node columns ``shards`` of its
        pod row (``mesh`` the row's node-axis mesh, ``q`` its row within
        them, ``ups`` each column's uploaded state): a mask a column, the
        spread filter's domain sums reduced over the columns (the plain
        filters in lockstep on CPU shards, kernel B3's sharded potential
        mode on CUDA ones)."""
        from ..parallel.mesh import run_sharded

        if self._sharded.device.type == "cpu":
            return run_sharded(
                [self._potential_steps(s, g, q, up)
                 for g, (s, up) in enumerate(zip(shards, ups))], mesh)
        from ..kernels import sharded_potential_mask

        sp = self.spread_counts
        return sharded_potential_mask(
            [_one_pod_view(s, q) for s in shards], mesh, self.params,
            [(up["requested"], up["pod_count"], up["node_ports"],
              None if sp is None else sp.pieces[g].to(s.device),
              None if self.pa_sums is None else self.pa_sums.to(s.device))
             for g, (s, up) in enumerate(zip(shards, ups))],
            [up.get("nom_active") for up in ups])

    def _dry_run_sharded(self, i: int, pod: t.Pod, arrays: dict):
        """The dry run of pod ``i`` over the node columns of its pod row:
        each column's potential mask (``_potential_shards``), then
        ``ops.preemption.dry_run_preemption_sharded``."""
        sb = self._sharded
        shards, mesh, q = self._pod_row(i)
        ups = self._upload_shards(arrays, shards)
        potential = self._potential_shards(i, shards, mesh, q, ups)
        shard_args = [
            (s.requests[q], int(pod.priority), up["wants_conf"], pot, s.alloc,
             up["charged_req"], up["charged_cnt"], s.allowed_pods, up["charged_ports"],
             up["valid"], up["priority"], up["start"], up["requests"],
             up["victim_ports"], up["pdb"], up["pdb_allowed"])
            for s, up, pot in zip(shards, ups, potential)
        ]
        return OP.dry_run_preemption_sharded(shard_args, sb.offsets)

    def _potential_mask(self, i: int, up: dict | None = None) -> torch.Tensor:
        """(N,) — nodes whose failure is the resolvable kind: all
        victim-independent filters pass, fit/ports fail (preemption.go:180
        NodesForStatusCode(Unschedulable)). ``up``: the call's uploaded
        state (``requested``, ``pod_count``, ``node_ports``, and
        ``nom_active`` with nominations); uploaded here when None."""
        if up is None:
            up = self._upload(self._potential_arrays())
        if self.batch.device.device.type == "cpu":
            return self._potential_mask_plain(i, up)
        from ..kernels import potential_mask

        return potential_mask(
            _one_pod_view(self.batch.device, i), self.params, up["requested"],
            up["pod_count"], up["node_ports"], self.spread_counts, self.pa_sums,
            up.get("nom_active"),
        )

    def _potential_mask_plain(self, i: int, up: dict) -> torch.Tensor:
        """The plain version of ``_potential_mask``, on any device: the
        reference's composition of ``filter_components``."""
        static, fit, ports_ok, spread_ok, pa_ok, _, _ = rt.filter_components(
            _one_pod_view(self.batch.device, i), self.params,
            requested=up["requested"],
            pod_count=up["pod_count"],
            node_ports=up["node_ports"],
            spread_counts=self.spread_counts,
            pa_sums=self.pa_sums,
            nominated_active=up.get("nom_active"),
        )
        return _potential_of(static, fit, ports_ok, spread_ok, pa_ok)

    def _potential_arrays(self) -> dict:
        arrays = dict(
            requested=self.requested,
            pod_count=self.pod_count,
            node_ports=self.port_counts > 0,
        )
        if self._nom_node is not None:
            arrays["nom_active"] = self._nom_active
        return arrays

    def preempt(self, i: int, extender_hook=None) -> PreemptionResult:
        """Run preemption for pending pod ``i`` of the batch.

        ``extender_hook`` (optional) is the ProcessPreemption seam
        (preemption.go callExtenders): called with
        ``(pod, {node_name: (victim_pods, n_pdb_violations)})`` over the FULL
        candidate set, it returns the trimmed
        ``{node_name: (victim_uids, n_pdb_violations)}`` map — nodes it drops
        become ineligible, victim lists may shrink — and the best-candidate
        pick then runs host-side over the survivors. Raising ExtenderError
        fails the preemption attempt (non-ignorable extender failure)."""
        pod = self.batch.pods[i]
        # PodEligibleToPreemptOthers (default_preemption.go:364): policy gate.
        # (Terminating-victims-on-nominated-node check needs pod deletion
        # timestamps — not modeled yet; informer-level requeue covers it.)
        if pod.preemption_policy == "Never":
            return PreemptionResult(
                "not_eligible", message="not eligible due to preemptionPolicy=Never."
            )

        b = self.batch.device
        v = self.victims
        # This preempt() replaces any prior nomination of pod i (on success a
        # new node is charged via _apply; on failure the caller removes the
        # nomination) — stop charging the stale one for the rest of the
        # batch, or pod i would be double-charged on two nodes.
        if self._nom_node is not None:
            self._nom_active = self._nom_active & (self._nom_pod_idx != i)
        # the reference's int32 einsum of the pod's triples with the
        # conflict matrix, tested > 0: a boolean any, on the host copies
        wants_conf = np.any(
            self._pod_ports[i][:, None] & self._port_conflict, axis=0
        )
        # Charge equal/higher-priority nominated pods (resources, count AND
        # host ports) to their nominated nodes before the victim search,
        # mirroring the reference's RunFilterPluginsWithNominatedPods inside
        # SelectVictimsOnNode (default_preemption.go:303,:323): a preemptor
        # must not claim room another nominee has already reserved. The
        # encoded gate row is exactly the >=-priority-and-not-self rule;
        # nominations consumed by this batch's own assignments are inactive.
        req, cnt, ports = self.requested, self.pod_count, self.port_counts
        if self._nom_node is not None:
            sel = self._nom_gate[i] & self._nom_active & (self._nom_node >= 0)
            if sel.any():
                req = req.copy()
                cnt = cnt.copy()
                np.add.at(req, self._nom_node[sel], self._nom_req[sel])
                np.add.at(cnt, self._nom_node[sel], 1)
                if self._nom_ports is not None and self._nom_ports[sel].any():
                    ports = ports.copy()
                    np.add.at(
                        ports, self._nom_node[sel],
                        self._nom_ports[sel].astype(ports.dtype),
                    )
        t0 = time.perf_counter()
        arrays = self._potential_arrays()
        arrays.update(
            charged_req=req, charged_cnt=cnt, charged_ports=ports,
            valid=v.valid, pdb_allowed=self.pdb_allowed, wants_conf=wants_conf,
        )
        if self._sharded is not None:
            node_idx, victims, ok_mask, n_pdb = self._dry_run_sharded(i, pod, arrays)
            n = int(node_idx)
            t1 = time.perf_counter()
            self.calls += 1
            self.spans["dry_run"] += t1 - t0
            if extender_hook is not None:
                okh = ok_mask.cpu().numpy()
                picked = self._pick_with_extenders(
                    pod, victims.cpu().numpy() if okh.any() else None, okh,
                    n_pdb.cpu().numpy(), extender_hook)
                if picked is None:
                    return PreemptionResult(
                        "unschedulable",
                        message="preemption: no candidate survived extenders")
                n, vrow = picked
            elif n >= 0:
                g = max(k for k, off in enumerate(self._sharded.offsets) if off <= n)
                vrow = victims.pieces[g][n - self._sharded.offsets[g]].cpu().numpy()
            return self._result(i, n, vrow if n >= 0 else None)
        up = self._upload(arrays)
        vd = self._victims_dev
        t1 = time.perf_counter()
        cuda = b.device.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
        potential = self._potential_mask(i, up)
        if cuda:
            ev[1].record()
        t2 = time.perf_counter()
        node_idx, victims, ok_mask, n_pdb = OP.dry_run_preemption(
            b.requests[i],
            int(pod.priority),
            up["wants_conf"],
            potential,
            b.alloc,
            up["charged_req"],
            up["charged_cnt"],
            b.allowed_pods,
            up["charged_ports"],
            up["valid"],
            vd["priority"],
            vd["start"],
            vd["requests"],
            vd["victim_ports"],
            vd["pdb"],
            up["pdb_allowed"],
        )
        if cuda:
            ev[2].record()
            ev[2].synchronize()
        t3 = time.perf_counter()
        if extender_hook is not None:
            okh = ok_mask.cpu().numpy()
            vall = victims.cpu().numpy() if okh.any() else None
            pdbh = n_pdb.cpu().numpy()
        else:
            n = int(node_idx)
            vrow = None if n < 0 else victims[n].cpu().numpy()
        t4 = time.perf_counter()
        self.calls += 1
        self.spans["upload"] += t1 - t0
        self.spans["fetch"] += t4 - t3
        if cuda:
            self.spans["potential"] += ev[0].elapsed_time(ev[1]) / 1e3
            self.spans["dry_run"] += ev[1].elapsed_time(ev[2]) / 1e3
        else:
            self.spans["potential"] += t2 - t1
            self.spans["dry_run"] += t3 - t2
        if extender_hook is not None:
            picked = self._pick_with_extenders(
                pod, vall, okh, pdbh, extender_hook
            )
            if picked is None:
                return PreemptionResult(
                    "unschedulable",
                    message="preemption: no candidate survived extenders",
                )
            n, vrow = picked
        return self._result(i, n, vrow)

    def _result(self, i: int, n: int, vrow) -> PreemptionResult:
        """The outcome of pod ``i``'s dry run: node ``n`` (-1 = none) and
        its victims row, committed to the host state."""
        v = self.victims
        if n < 0:
            return PreemptionResult(
                "unschedulable",
                message="preemption: 0/%d nodes are available"
                % self.batch.num_nodes,
            )
        uids = [
            v.uids[n][k] for k in np.flatnonzero(vrow) if v.uids[n][k] is not None
        ]
        info = self.batch.node_tensors.infos[n]
        pods = [info.pods[u] for u in uids if u in info.pods]
        self._apply(n, vrow, preemptor_index=i)
        return PreemptionResult(
            "success",
            node_name=self.batch.node_names[n],
            victim_uids=uids,
            victim_pods=pods,
        )

    def _pick_with_extenders(
        self, pod: t.Pod, vall, okh, pdbh, extender_hook
    ) -> tuple[int, np.ndarray] | None:
        """callExtenders + SelectCandidate on the host: present every dry-run
        candidate to the extender chain, drop vetoed nodes, adopt trimmed
        victim lists, then re-run pickOneNodeForPreemption's lexicographic
        refinement over the survivors (preemption.go:311 — stats recomputed
        from the FINAL victim sets, NumPDBViolations taken from the extender
        response as the reference's MetaVictims carry it). ``vall`` (N, K),
        ``okh`` (N,) and ``pdbh`` (N,) are the dry run's victims, ok mask
        and PDB violation counts, copied to the host (``vall`` None when no
        node is ok)."""
        v = self.victims
        if not okh.any():
            return None
        infos = self.batch.node_tensors.infos
        cand: dict[str, tuple[list[t.Pod], int]] = {}
        slots: dict[str, tuple[int, list[int]]] = {}
        for n in np.flatnonzero(okh):
            name = self.batch.node_names[n]
            ks = [
                int(k) for k in np.flatnonzero(vall[n])
                if v.uids[n][k] is not None
            ]
            pods = [
                infos[n].pods[v.uids[n][k]]
                for k in ks if v.uids[n][k] in infos[n].pods
            ]
            cand[name] = (pods, int(pdbh[n]))
            slots[name] = (int(n), ks)
        trimmed = extender_hook(pod, cand)
        best: tuple | None = None
        for name in cand:                     # ascending node index order
            if name not in trimmed:
                continue                       # extender vetoed the node
            uids, npdb = trimmed[name]
            n, ks = slots[name]
            keep = set(uids)
            uid_slot = {v.uids[n][k]: k for k in ks}
            final = [uid_slot[u] for u in keep if u in uid_slot]
            if not final:
                # victim list trimmed to nothing (or to unknown uids): the
                # node is no longer a preemption candidate — the reference
                # drops empty-victims nodes after callExtenders; keeping it
                # would nominate onto a still-full node with zero deletions
                continue
            prios = v.priority[n, final]
            max_p = int(prios.max())
            sum_p = int((prios + OP.PRIO_OFFSET).sum())
            highest = [k for k in final if v.priority[n, k] == max_p]
            early = int(v.start[n, highest].min())
            key = (-int(npdb), -max_p, -sum_p, -len(final), early)
            if best is None or key > best[0]:
                vrow = np.zeros(vall.shape[1], dtype=bool)
                vrow[final] = True
                best = (key, n, vrow)
        if best is None:
            return None
        return best[1], best[2]

    def _apply(
        self, n: int, victim_row: np.ndarray, preemptor_index: int | None = None
    ) -> None:
        """Commit one preemption to the host state so the NEXT preemptor in
        this batch sees the victims gone (and the PDB budget spent) — AND the
        just-nominated preemptor's reservation charged (preemptors run in
        priority order, so every later pod in this cycle has priority <= this
        one and the >=-priority charging rule applies)."""
        v = self.victims
        ks = np.flatnonzero(victim_row)
        for k in ks:
            self.requested[n] -= v.requests[n, k]
            self.pod_count[n] -= 1
            self.port_counts[n] -= v.victim_ports[n, k]
            self.pdb_allowed -= v.pdb[n, k].astype(np.int64)
            v.valid[n, k] = False
        if preemptor_index is not None:
            self.requested[n] += self._pod_requests[preemptor_index]
            self.pod_count[n] += 1
            # ports too: a later same-batch preemptor with a conflicting
            # hostPort must not also be nominated here
            self.port_counts[n] += self._pod_ports[preemptor_index].astype(
                self.port_counts.dtype
            )


def extender_chain_hook(extenders):
    """Build the ProcessPreemption hook for ``PreemptionEvaluator.preempt``
    from the scheduler's configured extenders, or None when no extender has
    a preempt verb. Extenders run in order, each further trimming the
    candidate map (preemption.go callExtenders); an uninterested extender is
    skipped, an ignorable failing one too, and a non-ignorable failure
    propagates (the attempt fails)."""
    active = [e for e in extenders if e.supports_preemption()]
    if not active:
        return None

    def hook(
        pod: t.Pod, cand: dict[str, tuple[list[t.Pod], int]]
    ) -> dict[str, tuple[list[str], int]]:
        current = cand
        for e in active:
            if not e.is_interested(pod):
                continue
            try:
                res = e.process_preemption(pod, current)
            except Exception:
                if e.cfg.ignorable:
                    continue
                raise
            # re-materialize pods for the next extender in the chain
            nxt: dict[str, tuple[list[t.Pod], int]] = {}
            for node, (uids, npdb) in res.items():
                pods_prev = {p.uid: p for p in current.get(node, ([], 0))[0]}
                nxt[node] = (
                    [pods_prev[u] for u in uids if u in pods_prev], npdb
                )
            current = nxt
        return {
            node: ([p.uid for p in pods], npdb)
            for node, (pods, npdb) in current.items()
        }

    return hook


def _potential_of(static, fit, ports_ok, spread_ok, pa_ok) -> torch.Tensor:
    """The potential mask of a one-pod view's filter components: every
    victim-independent filter passes and a victim-dependent one fails."""
    ok_independent = static[0]
    for part in (spread_ok, pa_ok):
        if part is not None:
            ok_independent = ok_independent & part[0]
    failed_dep = torch.zeros_like(ok_independent)
    for part in (fit, ports_ok):
        if part is not None:
            failed_dep = failed_dep | ~part[0]
    return ok_independent & failed_dep


def _node_leaf(b, name: str):
    """Node leaf ``name`` of a batch: the tensor, or a mesh's ShardedTensor
    of its node columns' rows (pod row 0's tiles)."""
    if hasattr(b, "shards"):
        from ..parallel.mesh import ShardedTensor

        return ShardedTensor([getattr(s, name) for s in b.shards[:b.columns]])
    return getattr(b, name)


def _one_pod_view(b: rt.DeviceBatch, i: int) -> rt.DeviceBatch:
    """P=1 view of pod ``i`` — like assign.greedy._pod_view but for a
    host-chosen pod, so filter_components sees (1, N) shapes."""
    from ..assign.greedy import _pod_view

    return _pod_view(b, i)
