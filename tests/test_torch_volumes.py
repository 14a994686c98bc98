"""The volume plugins in the port against kubetpu, exactly.

The volume scenarios of ``tests/test_volumes.py`` (VolumeZone with GA,
beta and unlabeled nodes; VolumeBinding's Filter for missing, Immediate,
WaitForFirstConsumer, provisioned and too-small claims; ReadWriteOncePod
in use and in one batch; ReadWriteMany sharing; the CSI attach limit) go
through kubetpu's and the port's ``encode_batch`` (every leaf equal) and
greedy engines (assignments and state equal). Its lifecycle scenarios
(``:193-335``: Reserve picks the smallest fitting PV and PreBind writes
the binding; no double booking in one batch; Unreserve after a failed
bind; two claims of one pod get two PVs; a partial Reserve is reverted)
run through both schedulers, serial and pipelined, and must leave the
same bound map, PVC and PV bindings and PreBind writes. The two PV cases
(SchedulingInTreePVs and SchedulingCSIPVs at 5Nodes) run through the
port's ``run_workload`` against kubetpu's Scheduler driven through their
ops.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import kubetpu  # noqa: F401  (x64 on)
from kubetpu.api import types as KT
from kubetpu.api import wrappers as KWR
from kubetpu.assign.greedy import greedy_assign_device as k_greedy
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.perf import workloads as KW
from kubetpu.perf.runner import _Client as KClient
from kubetpu.sched.scheduler import Scheduler as KScheduler
from kubetpu.state.snapshot import Cache

from kubetpu_torch.assign.greedy import greedy_assign_plain
from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.perf import run_workload

from .torch_port_util import both as _both
from .torch_port_util import jax_leaves, port_batch_from_jax, port_cache, port_params, to_port

ZONE = "topology.kubernetes.io/zone"
BETA_ZONE = "failure-domain.beta.kubernetes.io/zone"


def volume_profile(C):
    return C.Profile(
        filters=C.PluginSet(enabled=(
            (C.NODE_RESOURCES_FIT, 1), (C.VOLUME_ZONE, 1),
            (C.VOLUME_BINDING, 1), (C.VOLUME_RESTRICTIONS, 1),
            (C.NODE_VOLUME_LIMITS, 1),
        )),
        scores=C.PluginSet(enabled=((C.NODE_RESOURCES_FIT, 1),)),
        default_spread_constraints=(),
    )


def two_zone_cache():
    cache = Cache()
    for i, z in enumerate(("zone-a", "zone-a", "zone-b")):
        cache.add_node(KWR.make_node(f"n{i}", cpu_milli=4000, labels={ZONE: z}))
    return cache


def _pvc_pod(name, *claims, idx=0, **kw):
    return KWR.make_pod(name, cpu_milli=100, pvcs=claims, creation_index=idx, **kw)


def _wffc(cache, name="local", **kw):
    cache.add_storage_class(KT.StorageClass(
        name=name, binding_mode=KT.BINDING_WAIT_FOR_FIRST_CONSUMER, **kw))


# ------------------------------------------------------------- the filters

def zone_bound():
    cache = two_zone_cache()
    cache.add_pv(KT.PersistentVolume(name="pv-b", labels=((ZONE, "zone-b"),)))
    cache.add_pvc(KT.PersistentVolumeClaim(name="claim", volume_name="pv-b"))
    return cache, [_pvc_pod("p", "claim")], [2]


def zone_beta():
    cache = two_zone_cache()
    cache.add_pv(KT.PersistentVolume(name="pv-b", labels=((BETA_ZONE, "zone-b"),)))
    cache.add_pvc(KT.PersistentVolumeClaim(name="claim", volume_name="pv-b"))
    return cache, [_pvc_pod("p", "claim")], [2]


def zone_unlabeled():
    cache = Cache()
    cache.add_node(KWR.make_node("bare", cpu_milli=4000))
    cache.add_pv(KT.PersistentVolume(name="pv", labels=((ZONE, "zone-x"),)))
    cache.add_pvc(KT.PersistentVolumeClaim(name="claim", volume_name="pv"))
    return cache, [_pvc_pod("p", "claim")], [0]


def missing_pvc():
    return two_zone_cache(), [_pvc_pod("p", "ghost")], [-1]


def immediate_unbound():
    cache = two_zone_cache()
    cache.add_storage_class(KT.StorageClass(name="fast",
                                            binding_mode=KT.BINDING_IMMEDIATE))
    cache.add_pvc(KT.PersistentVolumeClaim(name="claim", storage_class="fast"))
    return cache, [_pvc_pod("p", "claim")], [-1]


def wffc_local_pv():
    cache = two_zone_cache()
    _wffc(cache)
    sel = KT.NodeSelector(terms=(KT.NodeSelectorTerm(match_expressions=(
        KT.Requirement(ZONE, KT.Operator.IN, ("zone-b",)),)),))
    cache.add_pv(KT.PersistentVolume(name="pv-local", storage_class="local",
                                     capacity=100, node_affinity=sel))
    cache.add_pvc(KT.PersistentVolumeClaim(name="claim", storage_class="local",
                                           request=50))
    return cache, [_pvc_pod("p", "claim")], [2]


def wffc_provisioner():
    cache = two_zone_cache()
    _wffc(cache, "csi", provisioner="ebs.csi.example.com")
    cache.add_pvc(KT.PersistentVolumeClaim(name="claim", storage_class="csi",
                                           request=50))
    return cache, [_pvc_pod("p", "claim")], None


def wffc_too_small():
    cache = two_zone_cache()
    _wffc(cache)
    cache.add_pv(KT.PersistentVolume(name="small", storage_class="local", capacity=10))
    cache.add_pvc(KT.PersistentVolumeClaim(name="claim", storage_class="local",
                                           request=50))
    return cache, [_pvc_pod("p", "claim")], [-1]


def rwop_in_use():
    cache = two_zone_cache()
    cache.add_pv(KT.PersistentVolume(name="pv"))
    cache.add_pvc(KT.PersistentVolumeClaim(
        name="claim", volume_name="pv", access_modes=(KT.READ_WRITE_ONCE_POD,)))
    cache.add_pod(_pvc_pod("owner", "claim", node_name="n0"))
    return cache, [_pvc_pod("p", "claim")], [-1]


def rwop_in_batch():
    cache = two_zone_cache()
    cache.add_pv(KT.PersistentVolume(name="pv"))
    cache.add_pvc(KT.PersistentVolumeClaim(
        name="claim", volume_name="pv", access_modes=(KT.READ_WRITE_ONCE_POD,)))
    return cache, [_pvc_pod("p0", "claim", idx=0), _pvc_pod("p1", "claim", idx=1)], None


def rwx_shared():
    cache = two_zone_cache()
    cache.add_pv(KT.PersistentVolume(name="pv"))
    cache.add_pvc(KT.PersistentVolumeClaim(
        name="claim", volume_name="pv", access_modes=("ReadWriteMany",)))
    cache.add_pod(_pvc_pod("owner", "claim", node_name="n0"))
    return cache, [_pvc_pod("p", "claim")], None


def csi_attach_limit():
    cache = Cache()
    for n in ("n0", "n1"):
        cache.add_node(KWR.make_node(n, cpu_milli=4000,
                                     extended={"attachable-volumes-csi-d": 2}))
    for i in range(3):
        cache.add_pv(KT.PersistentVolume(name=f"pv{i}", driver="d"))
        cache.add_pvc(KT.PersistentVolumeClaim(name=f"c{i}", volume_name=f"pv{i}"))
    cache.add_pod(KWR.make_pod("e0", cpu_milli=10, pvcs=("c0",), node_name="n0"))
    cache.add_pod(KWR.make_pod("e1", cpu_milli=10, pvcs=("c1",), node_name="n0"))
    return cache, [KWR.make_pod("p", cpu_milli=10, pvcs=("c2",))], [1]


def many_pv_pods():
    """SchedulingInTreePVs-shaped: each pod its own bound ReadOnlyMany PV,
    in-tree or CSI. Each pod is its own signature, but no PV restricts a
    node, so every row is all-true and the batch has no static mask."""
    cache = Cache()
    for i in range(6):
        cache.add_node(KW.node_default(i))
    pods = []
    for j in range(10):
        cache.add_pv(KT.PersistentVolume(
            name=f"pv-{j}", driver="ebs.csi.aws.com" if j % 2 else "",
            access_modes=("ReadOnlyMany",), capacity=1024**3,
            claim_ref=f"ns/claim-{j}"))
        cache.add_pvc(KT.PersistentVolumeClaim(
            name=f"claim-{j}", namespace="ns", volume_name=f"pv-{j}",
            access_modes=("ReadOnlyMany",), request=1024**3))
        pods.append(KWR.make_pod(f"pv-pod-{j}", namespace="ns", cpu_milli=100,
                                 memory=500 * 1024**2, pvcs=(f"claim-{j}",),
                                 creation_index=j))
    return cache, pods, None


def many_pv_pods_zoned():
    """The same with zoned nodes and each PV in one of their zones: every
    pod's row is its own signature and some are not all-true, so the static
    mask has one row per pod."""
    cache = Cache()
    for i in range(6):
        cache.add_node(KW.node_default(i, ("z0", "z1", "z2")))
    pods = []
    for j in range(10):
        cache.add_pv(KT.PersistentVolume(
            name=f"pv-{j}", access_modes=("ReadOnlyMany",), capacity=1024**3,
            labels=((ZONE, f"z{j % 3}"),), claim_ref=f"ns/claim-{j}"))
        cache.add_pvc(KT.PersistentVolumeClaim(
            name=f"claim-{j}", namespace="ns", volume_name=f"pv-{j}",
            access_modes=("ReadOnlyMany",), request=1024**3))
        pods.append(KWR.make_pod(f"pv-pod-{j}", namespace="ns", cpu_milli=100,
                                 memory=500 * 1024**2, pvcs=(f"claim-{j}",),
                                 creation_index=j))
    return cache, pods, None


SCENARIOS = {f.__name__: f for f in (
    zone_bound, zone_beta, zone_unlabeled, missing_pvc, immediate_unbound,
    wffc_local_pv, wffc_provisioner, wffc_too_small, rwop_in_use,
    rwop_in_batch, rwx_shared, csi_attach_limit, many_pv_pods,
    many_pv_pods_zoned,
)}


@pytest.mark.parametrize("profile", ["volume", "default"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_encode_and_greedy_equal(name, profile):
    cache, pods, want = SCENARIOS[name]()
    prof = volume_profile(KC) if profile == "volume" else KC.Profile()
    kb = krt.encode_batch(cache.update_snapshot(), pods, prof)
    pb = prt.encode_batch(port_cache(cache).update_snapshot(),
                          [to_port(p) for p in pods], to_port(prof), device="cpu")
    kl, pl = jax_leaves(kb.device), prt.batch_leaves(pb.device)
    assert set(pl) == set(kl)
    for leaf, w in kl.items():
        g = pl[leaf]
        assert (g is None) == (w is None), leaf
        if w is None or leaf in prt.NESTED:
            continue
        assert np.array_equal(g.numpy(), np.asarray(w)), leaf
    kp = krt.score_params(prof, kb.resource_names)
    ka, kst = k_greedy(kb.device, kp)
    pa, pst = greedy_assign_plain(port_batch_from_jax(kb.device), port_params(kp))
    assert np.array_equal(pa.numpy(), np.asarray(ka))
    for i in range(4):
        assert np.array_equal(pst[i].numpy(), np.asarray(kst[i])), i
    pa2, _ = greedy_assign_plain(pb.device, port_params(kp))
    assert np.array_equal(pa2.numpy(), np.asarray(ka))
    if want is not None and profile == "volume":
        assert pa[: len(pods)].tolist() == want
    if name == "rwop_in_batch" and profile == "volume":
        assert pa[0] >= 0 and pa[1] == -1
    if name == "many_pv_pods":
        # every row is all-true: no static mask at all
        assert pb.device.static_mask is None
    if name == "many_pv_pods_zoned":
        assert pb.device.static_mask.shape[0] == len(pods)


# ----------------------------------------------------------- the lifecycle

def both(scenario, **kw):
    return _both(scenario, profile=volume_profile(KC), **kw)


PIPE = [pytest.param({}, id="serial"), pytest.param({"pipeline": True}, id="pipelined")]


def _local_class(x):
    x.s.on_storage_class_add(x.T.StorageClass(
        name="local", binding_mode=x.T.BINDING_WAIT_FOR_FIRST_CONSUMER))


@pytest.mark.parametrize("kw", PIPE)
def test_reserve_assumes_and_prebind_binds(kw):
    def scenario(x):
        x.s.on_node_add(x.W.make_node("n0", cpu_milli=4000, labels={ZONE: "a"}))
        _local_class(x)
        x.s.on_pv_add(x.T.PersistentVolume(name="pv-big", storage_class="local",
                                           capacity=500))
        x.s.on_pv_add(x.T.PersistentVolume(name="pv-small", storage_class="local",
                                           capacity=100))
        x.s.on_pvc_add(x.T.PersistentVolumeClaim(name="claim", storage_class="local",
                                                 request=50))
        x.s.on_pod_add(x.W.make_pod("p", cpu_milli=100, pvcs=("claim",)))
        return x.run()

    side, res = both(scenario, **kw)
    assert res == 1
    assert side.c.bound == {"default/p": "n0"}
    assert side.c.pvc_binds == [("default/claim", "pv-small")]
    snap = side.s.cache.update_snapshot()
    assert snap.pvcs["default/claim"].volume_name == "pv-small"
    assert snap.pvs["pv-small"].claim_ref == "default/claim"


@pytest.mark.parametrize("kw", PIPE)
def test_second_pod_cannot_double_book_assumed_pv(kw):
    def scenario(x):
        x.s.on_node_add(x.W.make_node("n0", cpu_milli=4000))
        _local_class(x)
        for i in range(2):
            x.s.on_pv_add(x.T.PersistentVolume(name=f"pv{i}", storage_class="local",
                                               capacity=100))
            x.s.on_pvc_add(x.T.PersistentVolumeClaim(
                name=f"claim{i}", storage_class="local", request=50))
        for i in range(2):
            x.s.on_pod_add(x.W.make_pod(f"p{i}", cpu_milli=100, pvcs=(f"claim{i}",),
                                        creation_index=i))
        return x.run()

    side, res = both(scenario, **kw)
    assert res == 2
    vols = {side.s.cache._pvcs[f"default/claim{i}"].volume_name for i in range(2)}
    assert vols == {"pv0", "pv1"}


def test_unreserve_on_bind_failure_releases_pv():
    def scenario(x):
        x.s.on_node_add(x.W.make_node("n0", cpu_milli=4000))
        _local_class(x)
        x.s.on_pv_add(x.T.PersistentVolume(name="pv0", storage_class="local",
                                           capacity=100))
        x.s.on_pvc_add(x.T.PersistentVolumeClaim(name="claim", storage_class="local",
                                                 request=50))
        x.s.on_pod_add(x.W.make_pod("p", cpu_milli=100, pvcs=("claim",)))
        first = x.step()
        x.clock.tick(30)
        return first, x.run()

    side, res = both(scenario, fail_binds_for={"default/p"})
    assert side.c.bound == {"default/p": "n0"}
    assert side.s.metrics.bind_errors == 1


def test_two_claims_one_pod_distinct_pvs():
    def scenario(x):
        x.s.on_node_add(x.W.make_node("n0", cpu_milli=4000))
        _local_class(x)
        for i in range(2):
            x.s.on_pv_add(x.T.PersistentVolume(name=f"pv{i}", storage_class="local",
                                               capacity=100))
            x.s.on_pvc_add(x.T.PersistentVolumeClaim(
                name=f"claim{i}", storage_class="local", request=50))
        x.s.on_pod_add(x.W.make_pod("p", cpu_milli=100, pvcs=("claim0", "claim1")))
        return x.run()

    side, res = both(scenario)
    assert res == 1
    v0 = side.s.cache._pvcs["default/claim0"].volume_name
    v1 = side.s.cache._pvcs["default/claim1"].volume_name
    assert v0 and v1 and v0 != v1


def test_partial_reserve_failure_reverts_picks():
    def scenario(x):
        x.s.on_node_add(x.W.make_node("n0", cpu_milli=4000))
        _local_class(x)
        x.s.on_pv_add(x.T.PersistentVolume(name="pv0", storage_class="local",
                                           capacity=100))
        for i in range(2):
            x.s.on_pvc_add(x.T.PersistentVolumeClaim(
                name=f"claim{i}", storage_class="local", request=50))
        x.s.on_pod_add(x.W.make_pod("p", cpu_milli=100, pvcs=("claim0", "claim1")))
        return x.s.schedule_batch()

    side, res = both(scenario)
    assert res["scheduled"] == 0
    assert side.s.cache._pvs["pv0"].claim_ref == ""
    assert side.s.cache._pvcs["default/claim0"].volume_name == ""
    assert side.c.bound == {}


@pytest.mark.parametrize("kw", PIPE)
def test_rwop_in_batch_conflict(kw):
    def scenario(x):
        for i in range(2):
            x.s.on_node_add(x.W.make_node(f"n{i}", cpu_milli=4000))
        x.s.on_pv_add(x.T.PersistentVolume(name="pv"))
        x.s.on_pvc_add(x.T.PersistentVolumeClaim(
            name="claim", volume_name="pv", access_modes=(x.T.READ_WRITE_ONCE_POD,)))
        for i in range(2):
            x.s.on_pod_add(x.W.make_pod(f"p{i}", cpu_milli=100, pvcs=("claim",),
                                        creation_index=i))
        return x.run()

    side, res = both(scenario, **kw)
    assert res == 1 and len(side.c.bound) == 1


# --------------------------------------------------------------- the runner

@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("case", ["SchedulingInTreePVs", "SchedulingCSIPVs"])
def test_pv_workload_equal_reference(case, pipeline):
    """The case's 5Nodes workload: the port's run_workload binds what
    kubetpu's Scheduler binds driven through the same ops, and every PVC's
    PV is bound once (to that PVC)."""
    tc = KW.TEST_CASES[case]
    params = next(w for w in tc.workloads if w.name == "5Nodes").params
    client = KClient()
    sched = KScheduler(client, profile=KC.Profile(), dispatcher_workers=0,
                       pipeline=pipeline)
    client.sched = sched
    for i in range(params["initNodes"]):
        sched.on_node_add(KW.node_default(i))
    for op_i, op in enumerate(tc.ops):
        if not isinstance(op, KW.CreatePodsWithPVsOp):
            continue
        ns = f"pv-{op_i}"
        for j in range(params[op.count_param]):
            sched.on_pv_add(KT.PersistentVolume(
                name=f"{ns}-pv-{j}", driver=op.driver,
                access_modes=("ReadOnlyMany",), capacity=1024**3,
                claim_ref=f"{ns}/{ns}-claim-{j}"))
            sched.on_pvc_add(KT.PersistentVolumeClaim(
                name=f"{ns}-claim-{j}", namespace=ns, volume_name=f"{ns}-pv-{j}",
                access_modes=("ReadOnlyMany",), request=1024**3))
            sched.on_pod_add(KWR.make_pod(
                f"pvpod-{op_i}-{j}", namespace=ns, cpu_milli=100,
                memory=500 * 1024**2, creation_index=j, pvcs=(f"{ns}-claim-{j}",)))
        for _ in range(10):
            sched.schedule_batch()
            sched.dispatcher.sync()
            client.deliver()
        sched.run_until_idle()
        client.deliver()
    want = dict(client.bound)
    assert len(want) == params["initPods"] + params["measurePods"]

    captured = {}
    res = run_workload(case, "5Nodes", device="cpu", pipeline=pipeline,
                       on_scheduler=lambda s: captured.update(s=s))
    s = captured["s"]
    assert res.scheduled == res.measure_pods == params["measurePods"]
    assert dict(s.client.bound) == want
    refs = [pv.claim_ref for pv in s.cache._pvs.values()]
    assert len(refs) == len(set(refs)) == len(want)
    for key, pvc in s.cache._pvcs.items():
        assert s.cache._pvs[pvc.volume_name].claim_ref == key
