"""The port's scheduler cycle binds exactly what kubetpu's binds.

``SchedulingBasic/500Nodes`` (500 nodes, 500 init + 1000 measured pods,
``max_batch=128``) runs through the port's ``run_workload(device="cpu")``
and through kubetpu's ``Scheduler`` (greedy, ``pipeline=False``,
``dispatcher_workers=0``, ``flight_recorder=False``) driven by the same op
sequence; both record binds, and the bound maps must be identical. A
saturated cluster checks the unschedulable path the same way.
"""

import pytest

import kubetpu  # noqa: F401
from kubetpu.api.wrappers import make_node, make_pod
from kubetpu.framework import config as KC
from kubetpu.perf import workloads as KW
from kubetpu.perf.runner import _Client as KClient
from kubetpu.sched.scheduler import Scheduler as KScheduler

from kubetpu_torch.framework import config as PC
from kubetpu_torch.perf import run_workload
from kubetpu_torch.perf.runner import _Client as PClient
from kubetpu_torch.sched import Scheduler as PScheduler

from .torch_port_util import to_port


def _settle(sched, client, namespace, target, max_cycles=200):
    for _ in range(max_cycles):
        if client.bound_by_ns[namespace] >= target:
            return
        res = sched.schedule_batch()
        client.deliver()
        if res["scheduled"] == 0 and res["unschedulable"] == 0:
            return


def _kubetpu_scheduler(max_batch):
    client = KClient()
    sched = KScheduler(
        client, profile=KC.Profile(), max_batch=max_batch, engine="greedy",
        pipeline=False, dispatcher_workers=0, flight_recorder=False,
    )
    client.sched = sched
    return sched, client


def test_scheduling_basic_500_nodes_bound_map_equal():
    case = KW.TEST_CASES["SchedulingBasic"]
    params = next(w for w in case.workloads if w.name == "500Nodes").params
    sched, client = _kubetpu_scheduler(max_batch=128)
    for i in range(params["initNodes"]):
        sched.on_node_add(KW.node_default(i))
    for op_i, prefix, ns, count in (
        (1, "init", "namespace-0", params["initPods"]),
        (2, "measure", "namespace-1", params["measurePods"]),
    ):
        for j in range(count):
            sched.on_pod_add(KW.pod_default(f"{prefix}-{op_i}-{ns}-{j}", ns))
        _settle(sched, client, ns, count)
    sched.close()
    want = dict(client.bound)
    assert len(want) == 1500

    captured = {}
    res = run_workload("SchedulingBasic", "500Nodes", device="cpu",
                       max_batch=128, on_scheduler=lambda s: captured.update(s=s))
    got = dict(captured["s"].client.bound)
    assert res.scheduled == res.measure_pods == 1000
    assert res.bound_total == 1500
    assert res.device == "cpu"
    assert got == want


def _saturated(mod_make_node, mod_make_pod):
    nodes = [mod_make_node(f"n-{i}", cpu_milli=1000, memory=2 * 1024**3, pods=3)
             for i in range(4)]
    pods = [mod_make_pod(f"p-{j}", cpu_milli=400, memory=256 * 1024**2,
                         creation_index=j) for j in range(20)]
    return nodes, pods


def test_saturated_cluster_bound_map_equal():
    nodes, pods = _saturated(make_node, make_pod)
    ks, kc = _kubetpu_scheduler(max_batch=8)
    pc = PClient()
    ps = PScheduler(pc, profile=PC.Profile(), max_batch=8, device="cpu")
    pc.sched = ps
    for n in nodes:
        ks.on_node_add(n)
        ps.on_node_add(to_port(n))
    for p in pods:
        ks.on_pod_add(p)
        ps.on_pod_add(to_port(p))
    for sched, client in ((ks, kc), (ps, pc)):
        for _ in range(10):
            sched.schedule_batch()
            client.deliver()
    ks.close()
    assert dict(pc.bound) == dict(kc.bound)
    assert len(pc.bound) == 8                      # 2 per node fit by cpu
    assert ps.metrics.unschedulable >= 12
    timing = ps.metrics.cycle_timings[0]
    assert timing.pods == 8 and timing.upload_bytes > 0


@pytest.mark.parametrize("kwargs", [
    dict(mesh="on"), dict(mesh="auto"), dict(dispatcher_workers=2),
])
def test_out_of_slice_options_raise(kwargs):
    """On one CPU device the mesh switch keeps kubetpu's meaning: "on"
    asks for a mesh there is no second device for (ValueError), "auto"
    resolves to no mesh. Asynchronous binding is still a later slice's."""
    if kwargs.get("mesh") == "on":
        with pytest.raises(ValueError, match="only 1"):
            PScheduler(PClient(), device="cpu", **kwargs)
    elif kwargs.get("mesh") == "auto":
        s = PScheduler(PClient(), device="cpu", **kwargs)
        assert s.mesh is None and s.mesh_shape == () and s._resident.mesh is None
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PScheduler(PClient(), device="cpu", **kwargs)
