"""DefaultPreemption PostFilter wiring for the batched scheduler loop.

Port of ``kubetpu/sched/preemption.py``. The reference runs preemption
inside the scheduling cycle when a pod gets a FitError (schedule_one.go:288
RunPostFilterPlugins → DefaultPreemption.PostFilter,
defaultpreemption/default_preemption.go:136 → Evaluator.Preempt). Here the
batch cycle first assigns everything it can; each leftover pod then runs the
exhaustive device-side victim search (framework/preemption) against the
post-batch state, and on success:

- the victims are deleted through ``client.delete_pod(victim, reason=...)``;
- the preemptor's nominatedNodeName is recorded in the nominator and on its
  queue entry, and sent through ``client.nominate``;
- the pod returns to the unschedulable set; the victims' delete events fire
  the queueing hints that reactivate it (same event-driven requeue as the
  reference — DefaultPreemption registers no hints of its own and lets the
  resource-side plugins wake the pod, default_preemption.go:211).

The port binds synchronously and has no API dispatcher, so the victims'
deletes and the nomination go straight to the client, in the order kubetpu's
``DeleteVictimCall`` and ``NominateCall`` run them
(kubetpu/sched/api_dispatcher.py:145-189): every victim's delete, then the
nomination. kubetpu's Prometheus mirror has no twin here; the attempts and
victims are counted on ``SchedulerMetrics``.

Evaluator state is shared across all failed pods of ONE cycle so two
preemptors never pick the same victim (host-side sequential commit,
framework/preemption.PreemptionEvaluator._apply). The scheduler's
extenders with a preempt verb trim the candidates through
``extender_chain_hook``; a non-ignorable extender failure fails the
attempt and clears the pod's nomination, as in the reference.
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING

from ..framework.preemption import PreemptionEvaluator, _node_leaf

if TYPE_CHECKING:
    from ..queue.priority_queue import QueuedPodInfo
    from .scheduler import Scheduler


class DefaultPreemptionPostFilter:
    """Callable plugged into ``Scheduler._post_filter``; returns the
    nominated node name or None (the PostFilterResult contract)."""

    def __init__(self) -> None:
        self._ctx_token: object | None = None
        self._evaluator: PreemptionEvaluator | None = None
        # the evaluators' dry runs and their spans (PreemptionEvaluator.
        # spans), summed over the cycles reset so far
        self.calls = 0
        self.spans = {"upload": 0.0, "potential": 0.0, "dry_run": 0.0, "fetch": 0.0}

    def reset(self) -> None:
        """Called by the scheduler when the cycle ends so the cached
        evaluator (device tensors + snapshot encoding) doesn't outlive it;
        its call count and spans are folded into ``calls`` and ``spans``."""
        ev = self._evaluator
        if ev is not None:
            self.calls += ev.calls
            for k, v in ev.spans.items():
                self.spans[k] += v
        self._ctx_token = None
        self._evaluator = None

    def __call__(self, sched: "Scheduler", info: "QueuedPodInfo") -> str | None:
        ctx = sched._cycle_ctx
        if ctx is None:
            return None
        # PodEligibleToPreemptOthers (default_preemption.go:364): while any
        # of this pod's previous victims is still in the cache (informer
        # delete not yet delivered = the victim is terminating), don't
        # preempt more — keep the existing nomination.
        pending = sched._preempting.get(info.key)
        if pending:
            pending = {u for u in pending if sched.cache.has_pod(u)}
            if pending:
                sched._preempting[info.key] = pending
                return info.nominated_node_name
            sched._preempting.pop(info.key, None)
        batch, params, final_state, index_of = ctx
        i = index_of.get(info.key)
        if i is None:
            return None
        sched.metrics.note_preemption_attempt()

        if self._ctx_token is not ctx:
            self._ctx_token = ctx
            self._evaluator = self._build(sched, ctx)
        ev = self._evaluator

        from ..framework.preemption import extender_chain_hook
        from .extender import ExtenderError

        hook = extender_chain_hook(sched.extenders)
        try:
            result = ev.preempt(i, extender_hook=hook)
        except (ExtenderError, OSError) as e:
            # non-ignorable extender failure mid-ProcessPreemption: this
            # attempt fails (preemption.go callExtenders error path);
            # evaluator bugs propagate instead of hiding as "no candidates"
            logging.getLogger("kubetpu_torch.sched.preemption").error(
                "preemption extender failed: pod=%s err=%s", info.key, e
            )
            sched.nominator.remove(info.pod.uid)
            info.nominated_node_name = None
            return None
        if result.status != "success" or result.node_name is None:
            # clear any stale nomination (the reference's
            # NewPostFilterResultWithNominatedNode("") on no-candidates)
            sched.nominator.remove(info.pod.uid)
            info.nominated_node_name = None
            return None

        sched.metrics.note_preemption_victims(len(result.victim_pods))
        sched._preempting[info.key] = set(result.victim_uids)
        sched.nominator.add(info.pod, result.node_name)
        for victim in result.victim_pods:
            sched.client.delete_pod(victim, reason="preempted by " + info.key)
        sched.client.nominate(info.pod, result.node_name)
        return result.node_name

    @staticmethod
    def _build(sched: "Scheduler", ctx: tuple) -> PreemptionEvaluator:
        batch, params, final_state, _ = ctx
        # Post-batch node usage: the engine's final state. Port usage needs
        # counts (removal must not free a triple a survivor holds): snapshot
        # counts come from the victim encoder; triples held only by
        # just-assumed pods (absent from the snapshot union) add a floor of 1.
        requested = final_state[0].cpu().numpy()
        pod_count = final_state[2].cpu().numpy()
        final_ports = final_state[3].cpu().numpy()
        snap_union = _node_leaf(batch.device, "node_ports").cpu().numpy()
        ev = PreemptionEvaluator(
            batch, params,
            pdbs=tuple(sched.pdbs.values()),
            requested=requested,
            pod_count=pod_count,
            spread_counts=final_state[4],
            pa_sums=final_state[5],
            nominated_active=final_state[6],
        )
        ev.port_counts = ev.port_counts + (final_ports & ~snap_union)
        return ev
