"""The preemption evaluator's potential mask with a hard spread constraint
under a mesh equals kubetpu's single-device one.

The preemptor carries a DoNotSchedule zone spread constraint whose zones
span the node columns of ``cpu`` meshes of G in {2, 4} shards and of a
2 x 2 pods x nodes grid, and whose global minimum lies in the last column.
A column that decided the constraint on its own counts would take the
zone with the lowest-priority victims (z-b) for feasible, and nominate
there; the global counts rule it out. The port's preempting scheduler
under the mesh is held to kubetpu's unsharded one: the cycle's result,
the deleted victims, the nomination and, call for call, the (N,) potential
mask itself.
"""

import numpy as np
import pytest
import torch

from kubetpu.api.wrappers import make_node as k_make_node
from kubetpu.api.wrappers import make_pod as k_make_pod
from kubetpu.api.wrappers import spread_constraint as k_spread
from kubetpu.framework import config as KC
from kubetpu.framework import preemption as KPE

from kubetpu_torch.api.wrappers import make_node, make_pod, spread_constraint
from kubetpu_torch.framework import config as PC
from kubetpu_torch.framework import preemption as PPE
from kubetpu_torch.parallel import mesh as M
from kubetpu_torch.sched import Scheduler as PScheduler

from .torch_port_util import FakeClock

ZONE = "topology.kubernetes.io/zone"
# node i's zone: z-a and z-b alternate over the first six nodes, z-c holds
# the last two (the last column of every layout below)
ZONES = ("z-a", "z-b", "z-a", "z-b", "z-a", "z-b", "z-c", "z-c")
# the filler pod on each node: (priority, labeled app=x); z-b's fillers
# have the lowest priority, so a mask that let z-b through would nominate
# there
FILLERS = ((1, True), (0, True), (1, False), (0, False), (1, True), (1, True), (1, True),
           (1, False))
LAYOUTS = {
    "mesh-2": lambda: M.make_mesh(["cpu"] * 2),
    "mesh-4": lambda: M.make_mesh(["cpu"] * 4),
    "grid-2x2": lambda: M.make_mesh_2d(["cpu"] * 4, pods=2),
}


def _cluster(node, pod, spread):
    """Eight 1000m nodes, each nearly full with a 900m filler; app=x pods
    count z-a 2, z-b 3 (a 50m extra on node 5), z-c 1. The preemptor
    (800m, app=x, priority 100) spreads over zones with maxSkew 2: with
    its own match, z-a's 2 + 1 - 1 = 2 and z-c's 1 + 1 - 1 = 1 pass, z-b's
    3 + 1 - 1 = 3 fails. A column's own counts leave out z-c's node
    (minMatch 0 there) and at most two z-b pods, which pass."""
    nodes = [node(f"n{i}", cpu_milli=1000, memory=2**31, labels={ZONE: z})
             for i, z in enumerate(ZONES)]
    pods = [pod(f"low-{i}", cpu_milli=900, priority=prio, node_name=f"n{i}",
                creation_index=i, labels={"app": "x"} if match else {})
            for i, (prio, match) in enumerate(FILLERS)]
    pods.append(pod("extra-5", cpu_milli=50, priority=1, node_name="n5", creation_index=8,
                    labels={"app": "x"}))
    high = pod("high", cpu_milli=800, priority=100, creation_index=10, labels={"app": "x"},
               spread=[spread(2, ZONE, match_labels={"app": "x"})])
    return nodes, pods, high


def _record(cls, name, out, join=None):
    """Wrap ``cls.name`` to append each call's result (through ``join``)
    to ``out``."""
    orig = getattr(cls, name)

    def wrapped(self, *a, **kw):
        got = orig(self, *a, **kw)
        out.append(np.asarray(join(got) if join else got).copy())
        return got

    return orig, wrapped


def _run_reference(monkeypatch):
    from kubetpu.sched import Scheduler as KScheduler

    from .test_scheduler import FakeClient

    deleted, nominated, masks = [], {}, []

    class Client(FakeClient):
        def delete_pod(self, pod, reason=""):
            deleted.append(pod.name)

        def nominate(self, pod, node_name):
            nominated[pod.name] = node_name

    _, wrapped = _record(KPE.PreemptionEvaluator, "_potential_mask", masks)
    monkeypatch.setattr(KPE.PreemptionEvaluator, "_potential_mask", wrapped)
    s = KScheduler(client=Client(), profile=KC.Profile(), dispatcher_workers=0,
                   clock=FakeClock())
    s.enable_preemption()
    nodes, pods, high = _cluster(k_make_node, k_make_pod, k_spread)
    for n in nodes:
        s.on_node_add(n)
    for p in pods:
        s.on_pod_add(p)
    s.on_pod_add(high)
    res = s.schedule_batch()
    s.dispatcher.sync()
    s.close()
    return res, sorted(deleted), nominated, masks


def _run_port(monkeypatch, mesh):
    from kubetpu_torch.perf.runner import _Client

    masks = []
    _, wrapped = _record(PPE.PreemptionEvaluator, "_potential_shards", masks,
                         join=lambda pieces: torch.cat([x.cpu() for x in pieces]).numpy())
    monkeypatch.setattr(PPE.PreemptionEvaluator, "_potential_shards", wrapped)
    client = _Client()
    s = PScheduler(client, profile=PC.Profile(), mesh=mesh, device="cpu", clock=FakeClock())
    client.sched = s
    s.enable_preemption()
    nodes, pods, high = _cluster(make_node, make_pod, spread_constraint)
    for n in nodes:
        s.on_node_add(n)
    for p in pods:
        s.on_pod_add(p)
    s.on_pod_add(high)
    res = s.schedule_batch()
    return (res, sorted(p.name for p, _ in client.deleted),
            {p.name: n for p, n in client.nominated},
            masks)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_hard_spread_potential_mask_under_a_mesh(monkeypatch, layout):
    ref_res, ref_deleted, ref_nominated, ref_masks = _run_reference(monkeypatch)
    res, deleted, nominated, masks = _run_port(monkeypatch, LAYOUTS[layout]())
    assert res == ref_res
    assert deleted == ref_deleted and len(ref_deleted) == 1
    assert list(nominated.values()) == list(ref_nominated.values())
    # the spread verdict decides the mask: z-b's nodes fail it, the full
    # nodes of z-a and z-c are potential
    assert len(masks) == len(ref_masks) == 1
    want = np.asarray(ref_masks[0])
    assert np.array_equal(masks[0], want)
    assert want[:8].tolist() == [z != "z-b" for z in ZONES]
    # the victim is the z-a or z-c filler, not z-b's lower-priority ones
    assert ZONES[int(ref_deleted[0].split("-")[1])] != "z-b"
