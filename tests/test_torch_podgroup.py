"""The port's gang lane against kubetpu's: the same scenarios through the
port's ``Scheduler(device="cpu", feature_gates=...)`` and kubetpu's
``Scheduler(dispatcher_workers=0)``, each with its own client and stepped
clock, must bind the same pods to the same nodes and delete the same
victims.

The scenarios are those of ``tests/test_podgroup.py`` (quorum gating,
all-or-nothing rollback, partial admission, bind-error retry, topology
placement, placement parity for seeds 0-2, leftovers parking, the waiting
member's update) and of ``tests/test_topology.py:147-330`` (off / auto / on
parity on an unlabeled cluster, labeled auto = on, single-slice
concentration, gang preemption evicting exactly one gang, and no gang
preemption without ``enable_preemption()`` or without topology), plus the
GangScheduling workload at its 10- and 100-node sizes through the port's
``run_workload`` against kubetpu's Scheduler driven through the same ops.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from kubetpu.api import wrappers as KWR
from kubetpu.framework import config as KC
from kubetpu.perf import workloads as KW
from kubetpu.perf.runner import _Client as KClient
from kubetpu.sched.scheduler import Scheduler as KScheduler
from kubetpu.state.topology import SLICE_KEY

from kubetpu_torch.api import wrappers as PWR
from kubetpu_torch.framework import config as PC
from kubetpu_torch.perf import run_workload
from kubetpu_torch.perf import workloads as PW
from kubetpu_torch.sched import Scheduler as PScheduler

from .test_scheduler import FakeClient
from .torch_port_util import FakeClock

GANG_GATES = {
    "GenericWorkload": True,
    "GangScheduling": True,
    "TopologyAwareWorkloadScheduling": True,
}
ZONE = "topology.kubernetes.io/zone"


class PreemptClient(FakeClient):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.deleted = []

    def delete_pod(self, pod, reason=""):
        self.deleted.append((f"{pod.namespace}/{pod.name}", reason, pod))


class Side:
    """One scheduler of the pair: ``W`` is its wrappers module, ``s`` the
    scheduler, ``c`` its client, ``clock`` its stepped clock."""

    def __init__(self, port: bool, client=None, **kw):
        self.port = port
        self.W = PWR if port else KWR
        self.c = client or PreemptClient()
        self.clock = FakeClock()
        kw.setdefault("feature_gates", dict(GANG_GATES))
        if port:
            self.s = PScheduler(self.c, profile=PC.minimal_profile(), device="cpu",
                                clock=self.clock, **kw)
        else:
            self.s = KScheduler(client=self.c, profile=KC.minimal_profile(),
                                dispatcher_workers=0, clock=self.clock, **kw)

    def settle(self, cycles=8):
        total = 0
        for _ in range(cycles):
            total += self.s.schedule_batch()["scheduled"]
        if not self.port:
            self.s.dispatcher.sync()
            self.s._drain_bind_completions()
        return total

    def node(self, name, cpu=8000, **kw):
        self.s.on_node_add(self.W.make_node(name, cpu_milli=cpu, **kw))

    def sliced(self, name, sval, cpu=1000):
        self.node(name, cpu=cpu, labels={SLICE_KEY: sval})

    def group(self, name, min_count=None, topology_keys=()):
        self.s.on_pod_group_add(self.W.make_pod_group(
            name, min_count=min_count, topology_keys=topology_keys))

    def gang_pod(self, name, group, cpu=500, prio=0, idx=0):
        return self.W.make_pod(name, cpu_milli=cpu, memory=128 * 1024**2,
                               scheduling_group=group, priority=prio,
                               creation_index=idx)

    def add(self, name, group, **kw):
        self.s.on_pod_add(self.gang_pod(name, group, **kw))


def both(scenario, client=None, **kw):
    """Run ``scenario(side)`` on kubetpu and on the port; its return values
    and the two clients' bound maps and deletes must be equal. Returns the
    port's side and result."""
    out = []
    for port in (False, True):
        side = Side(port, client=None if client is None else client(), **kw)
        res = scenario(side)
        deleted = [(k, r) for k, r, _ in getattr(side.c, "deleted", [])]
        out.append((side, res, dict(side.c.bound), deleted))
    (_, kres, kbound, kdel), (pside, pres, pbound, pdel) = out
    assert pres == kres
    assert pbound == kbound
    assert pdel == kdel
    return pside, pres


# ---------------------------------------------------------------------------
# tests/test_podgroup.py
# ---------------------------------------------------------------------------

def test_pods_wait_for_pod_group_object():
    def scenario(x):
        x.node("n0")
        for i in range(3):
            x.add(f"g-{i}", "gang-a", idx=i)
        first = x.settle()
        x.group("gang-a", min_count=3)
        return first, x.settle()

    _, res = both(scenario)
    assert res == (0, 3)


def test_pods_wait_for_min_count():
    def scenario(x):
        x.node("n0")
        x.group("gang-a", min_count=3)
        x.add("g-0", "gang-a", idx=0)
        x.add("g-1", "gang-a", idx=1)
        first = x.settle()
        x.add("g-2", "gang-a", idx=2)
        return first, x.settle()

    _, res = both(scenario)
    assert res == (0, 3)


def test_prebound_member_counts_toward_quorum():
    def scenario(x):
        x.node("n0")
        x.group("gang-a", min_count=3)
        x.add("g-0", "gang-a", idx=0)
        x.add("g-1", "gang-a", idx=1)
        x.s.on_pod_add(x.gang_pod("g-2", "gang-a", idx=2).with_node("n0"))
        return x.settle()

    _, res = both(scenario)
    assert res == 2


def test_insufficient_capacity_schedules_nothing():
    def scenario(x):
        for i in range(2):
            x.node(f"n{i}", cpu=600)
        x.group("gang-a", min_count=3)
        for i in range(3):
            x.add(f"g-{i}", "gang-a", idx=i)
        first = x.settle()
        bound_first = dict(x.c.bound)
        empty = all(not info.pods for info in x.s.cache.update_snapshot().node_infos())
        x.node("n2", cpu=600)
        x.clock.tick(30)
        return first, bound_first, empty, x.settle()

    _, res = both(scenario)
    assert res == (0, {}, True, 3)


def test_min_count_below_group_size_partial():
    def scenario(x):
        for i in range(2):
            x.node(f"n{i}", cpu=600)
        x.group("gang-a", min_count=2)
        for i in range(4):
            x.add(f"g-{i}", "gang-a", idx=i)
        n = x.settle()
        e = x.s.podgroups.entries["default/gang-a"]
        return n, len(e.pending), len(e.scheduled)

    _, res = both(scenario)
    assert res == (2, 2, 2)


def test_bind_error_returns_member_to_pending():
    def scenario(x):
        x.node("n0")
        x.group("gang-a", min_count=2)
        for i in range(2):
            x.add(f"g-{i}", "gang-a", idx=i)
        x.settle()
        x.clock.tick(30)
        x.settle()
        return sorted(x.c.bound)

    _, res = both(scenario, client=lambda: PreemptClient(fail_binds_for={"default/g-1"}))
    assert res == ["default/g-0", "default/g-1"]


def _zones(x, free_a, free_b, slot=1000):
    for z, count in (("a", free_a), ("b", free_b)):
        for i in range(count):
            x.node(f"{z}{i}", cpu=slot, labels={ZONE: f"zone-{z}"})


@pytest.mark.parametrize("free_a,free_b,prebound,want", [
    (2, 3, False, 3),     # only zone-b fits all three
    (2, 2, False, 0),     # no domain fits the group
    (3, 5, True, 2),      # a scheduled member pins zone-a
])
def test_topology_placement(free_a, free_b, prebound, want):
    def scenario(x):
        _zones(x, free_a, free_b)
        x.group("gang-t", min_count=3, topology_keys=(ZONE,))
        start = 0
        if prebound:
            x.s.on_pod_add(x.gang_pod("t-0", "gang-t", cpu=800, idx=0).with_node("a0"))
            start = 1
        for i in range(start, 3):
            x.add(f"t-{i}", "gang-t", cpu=800, idx=i)
        return x.settle()

    pside, res = both(scenario)
    assert res == want
    if prebound:
        assert {n[0] for n in pside.c.bound.values()} == {"a"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_placement_parity(seed):
    """tests/test_podgroup.py's oracle case: 12 nodes over three zones,
    five members with seeded requests, minCount 3."""
    def scenario(x):
        rng = np.random.default_rng(seed + 4200)
        for i in range(12):
            x.s.on_node_add(x.W.make_node(
                f"n{i:02d}", cpu_milli=int(rng.integers(800, 2400)),
                memory=8 * 1024**3, labels={ZONE: ["z0", "z1", "z2"][i % 3]}))
        x.group("gang-p", min_count=3, topology_keys=(ZONE,))
        for j in range(5):
            x.add(f"p-{j}", "gang-p", cpu=int(rng.integers(300, 900)), idx=j)
        return x.settle()

    both(scenario)


def test_update_of_waiting_member_does_not_bypass_gating():
    def scenario(x):
        x.node("n0")
        x.group("gang-a", min_count=3)
        p0 = x.gang_pod("g-0", "gang-a", idx=0)
        x.s.on_pod_add(p0)
        x.s.on_pod_update(p0, dataclasses.replace(p0, labels=(("x", "y"),)))
        first = x.settle()
        x.add("g-1", "gang-a", idx=1)
        x.add("g-2", "gang-a", idx=2)
        return first, x.settle()

    _, res = both(scenario)
    assert res == (0, 3)


def test_admitted_group_leftovers_park_with_backoff():
    def scenario(x):
        for i in range(2):
            x.node(f"n{i}", cpu=600)
        x.group("gang-a", min_count=2)
        for i in range(4):
            x.add(f"g-{i}", "gang-a", idx=i)
        first = x.settle()
        e = x.s.podgroups.entries["default/gang-a"]
        parked = e.parked and e.backoff_until > x.clock()
        attempts = x.s.metrics.schedule_attempts
        x.settle(cycles=3)
        burned = x.s.metrics.schedule_attempts - attempts
        x.node("n2", cpu=600)
        x.node("n3", cpu=600)
        x.clock.tick(30)
        return first, parked, burned, x.settle(), len(x.c.bound)

    _, res = both(scenario)
    assert res == (2, True, 0, 2, 4)


# ---------------------------------------------------------------------------
# tests/test_topology.py:147-330
# ---------------------------------------------------------------------------

def _mixed(x, labeled):
    for i in range(4):
        if labeled:
            x.sliced(f"n{i}", f"s{i % 2}")
        else:
            x.node(f"n{i}", cpu=1000)
    x.group("gang-a", min_count=2)
    for i in range(2):
        x.add(f"g-{i}", "gang-a", cpu=300, idx=i)
    for j in range(4):
        x.s.on_pod_add(x.W.make_pod(f"p{j}", cpu_milli=400, creation_index=10 + j))
    x.settle()
    return len(x.c.bound)


@pytest.mark.parametrize("engine", ["greedy", "batched"])
def test_topology_off_auto_on_parity_on_unlabeled_cluster(engine):
    base = {}
    for mode in ("off", "auto", "on"):
        pside, n = both(lambda x: _mixed(x, False), engine=engine, topology=mode)
        assert n == 6
        base[mode] = dict(pside.c.bound)
    assert base["off"] == base["auto"] == base["on"]


@pytest.mark.parametrize("engine", ["greedy", "batched"])
def test_labeled_auto_matches_on(engine):
    on, _ = both(lambda x: _mixed(x, True), engine=engine, topology="on")
    auto, _ = both(lambda x: _mixed(x, True), engine=engine, topology="auto")
    assert dict(on.c.bound) == dict(auto.c.bound) and len(on.c.bound) == 6


def _gang_record(side, key):
    rec = side.s.flight_recorder.lookup(key)
    keep = ("kind", "status", "placement", "members", "need", "alignment_score",
            "slices_considered", "preemption_victims", "victim_group", "engine")
    return {k: rec.get(k) for k in keep}


def test_gang_concentrates_on_single_slice():
    def scenario(x):
        for sval, names in (("s0", ("a0", "a1")), ("s1", ("b0", "b1"))):
            for n in names:
                x.sliced(n, sval)
        x.group("gang-a", min_count=2)
        x.clock.tick(3)
        for i in range(2):
            x.add(f"g-{i}", "gang-a", cpu=800, idx=i)
        return x.settle(), _gang_record(x, "default/gang-a")

    pside, (n, rec) = both(scenario, topology="on")
    assert n == 2 and len({v[0] for v in pside.c.bound.values()}) == 1
    assert rec["status"] == "placed" and rec["placement"].startswith("slice:")
    assert rec["alignment_score"] == 4 and "<all>" in rec["slices_considered"][-1]
    # the admission latency is observed once (the port keeps it on
    # SchedulerMetrics: no Prometheus registry)
    assert pside.s.metrics.gang_admission == [("greedy", 3.0)]


def test_gang_preemption_evicts_one_gang_and_admits_the_train():
    def scenario(x):
        x.s.enable_preemption()
        for sval, names in (("s0", ("a0", "a1")), ("s1", ("b0", "b1"))):
            for n in names:
                x.sliced(n, sval)
        x.group("low", min_count=2)
        for i in range(2):
            x.add(f"low-{i}", "low", cpu=900, prio=0, idx=i)
        steps = [x.settle()]
        for j in range(2):
            x.s.on_pod_add(x.W.make_pod(f"serve-{j}", cpu_milli=900, priority=10,
                                        creation_index=10 + j))
        steps.append(x.settle())
        x.group("train", min_count=2)
        for i in range(2):
            x.add(f"train-{i}", "train", cpu=900, prio=8, idx=20 + i)
        steps.append(x.settle())                 # parked on the evictions
        rec = _gang_record(x, "default/train")
        x.s.podgroups.wake_all()
        steps.append(x.settle())                 # no second eviction
        n_deleted = len(x.c.deleted)
        for _k, _r, p in x.c.deleted:
            x.s.on_pod_delete(p)
        x.clock.tick(30)
        steps.append(x.settle())
        return steps, rec, n_deleted, _gang_record(x, "default/train")

    pside, (steps, rec, n_deleted, after) = both(scenario, topology="on")
    assert steps == [2, 2, 0, 0, 2] and n_deleted == 2
    assert [k for k, _r, _p in pside.c.deleted] == ["default/low-0", "default/low-1"]
    assert all("default/train" in r for _k, r, _p in pside.c.deleted)
    assert rec["status"] == "preempting" and rec["victim_group"] == "default/low"
    assert sorted(rec["preemption_victims"]) == ["default/low-0", "default/low-1"]
    assert after["status"] == "placed"
    low = {pside.c.bound[f"default/low-{i}"][0] for i in range(2)}
    train = {pside.c.bound[f"default/train-{i}"][0] for i in range(2)}
    assert train == low and len(train) == 1
    assert pside.s.metrics.preemption_victims == 2


@pytest.mark.parametrize("preempt,labeled", [(False, True), (True, False)])
def test_no_gang_preemption_without_postfilter_or_topology(preempt, labeled):
    def scenario(x):
        if preempt:
            x.s.enable_preemption()
        for sval, n in (("s0", "a0"), ("s1", "b0")):
            if labeled:
                x.sliced(n, sval)
            else:
                x.node(n, cpu=1000)
        x.group("low", min_count=1)
        x.add("low-0", "low", cpu=900, prio=0)
        x.s.on_pod_add(x.W.make_pod("serve-0", cpu_milli=900, priority=10,
                                    creation_index=5))
        x.settle()
        x.group("train", min_count=1)
        x.add("train-0", "train", cpu=900, prio=8, idx=9)
        x.settle()
        return list(x.c.deleted)

    _, deleted = both(scenario, topology="on")
    assert deleted == []


# ---------------------------------------------------------------------------
# the GangScheduling workload through both runners' op sequences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload", ["10Nodes_3Gangs", "100Nodes_10Gangs"])
@pytest.mark.parametrize("slices,topology", [(0, "off"), (4, "on")])
def test_gang_workload_bound_map_equal(workload, slices, topology):
    """The port's run_workload binds what kubetpu's Scheduler binds driven
    through GangScheduling's ops (the case's two gates, and the placement
    gate with a sliced fleet)."""
    tc = KW.TEST_CASES["GangScheduling"]
    params = next(w for w in tc.workloads if w.name == workload).params
    gates = dict(tc.feature_gates)
    extra = {"TopologyAwareWorkloadScheduling": True} if slices else {}
    client = KClient()
    sched = KScheduler(client, profile=KC.Profile(), dispatcher_workers=0,
                       feature_gates={**gates, **extra}, topology=topology)
    client.sched = sched
    for i in range(params["initNodes"]):
        sched.on_node_add(KW.node_default(i, (), slices))
    groups, per = params["initPodGroups"], params["podsPerGroup"]
    for g in range(groups):
        sched.on_pod_group_add(KWR.make_pod_group(f"gang-{g}", namespace="gang-0",
                                                  min_count=per))
    for j in range(groups * per):
        sched.on_pod_add(KWR.make_pod(
            f"gangpod-{j}", namespace="gang-0", cpu_milli=100, memory=100 * 1024**2,
            scheduling_group=f"gang-{j // per}", creation_index=j))
    for _ in range(20):
        if client.bound_by_ns["gang-0"] >= groups * per:
            break
        sched.schedule_batch()
        sched.dispatcher.sync()
        client.deliver()
    want = dict(client.bound)
    assert len(want) == groups * per

    captured = {}
    res = run_workload("GangScheduling", workload, device="cpu",
                       feature_gates=extra, topology=topology, slices=slices,
                       on_scheduler=lambda s: captured.update(s=s))
    assert res.scheduled == res.measure_pods == groups * per
    assert res.group_cycles == (groups if slices else 1)
    assert dict(captured["s"].client.bound) == want
    if slices:
        # each gang lands on one slice
        labels = {n.name: n.labels_dict().get(SLICE_KEY)
                  for n in (PW.node_default(i, (), slices)
                            for i in range(params["initNodes"]))}
        by_gang = {}
        for pod, node in want.items():
            by_gang.setdefault(int(pod.split("-")[1]) // per, set()).add(labels[node])
        assert all(len(s) == 1 for s in by_gang.values())
