"""The port's plain batched engine equals kubetpu's, bit for bit.

Modelled on the cases of ``tests/test_batched.py``, at small size (at most
64 nodes and 128 pending pods), with seeded inputs: identical pods,
pods outnumbering nodes, a saturated cluster, overcommit without the fit
filter, host ports across rounds, randomized resource clusters, affinity
clusters, one-zone affinity contention, a hotspot with a round cap. Each
batch is encoded by kubetpu and carried across as numpy leaves;
``batched_assign_plain`` must equal kubetpu's ``batched_assign_device`` in
its assignments and all seven state slots, exactly. The round body's
functions (``_tie_spread_choice`` and ``_accept``, whose tie hash the port
computes in int64 where kubetpu uses uint64) are held to kubetpu's on
seeded score tables. Greedy is held to batched only on resource-monotone
shapes, as kubetpu's own harness does. A shrunken SchedulingPodAffinity
run on the batched engine binds what kubetpu's Scheduler binds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubetpu  # noqa: F401
from kubetpu.api import types as kt
from kubetpu.api.wrappers import make_node, make_pod, pod_affinity_term
from kubetpu.assign import batched as KB
from kubetpu.assign.batched import batched_assign_device as k_batched
from kubetpu.framework import config as KC
from kubetpu.perf import workloads as KW
from kubetpu.perf.runner import _Client as KClient
from kubetpu.sched.scheduler import Scheduler as KScheduler
from kubetpu.state.snapshot import Cache

from kubetpu_torch.assign import batched as PB
from kubetpu_torch.assign.batched import batched_assign_device, batched_assign_plain
from kubetpu_torch.assign.greedy import greedy_assign_plain
from kubetpu_torch.perf import run_workload
from kubetpu_torch.perf import workloads as PW

from .cluster_gen import random_cluster
from .test_podaffinity import add_affinity, affinity_profile
from .torch_port_util import encoded_pair

ZONE = "topology.kubernetes.io/zone"

ONLY_FIT = KC.Profile(
    filters=KC.PluginSet(enabled=((KC.NODE_RESOURCES_FIT, 1),)),
    scores=KC.PluginSet(enabled=((KC.NODE_RESOURCES_FIT, 1),)),
    default_spread_constraints=(),
)


def _assert_same(cache, pending, profile, max_rounds=0):
    """Both engines on one batch; returns the port's assignments (real pods
    only) and its round count."""
    kb, kp, pb, pp = encoded_pair(cache, pending, profile)
    ka, kst = k_batched(kb, kp, max_rounds=max_rounds)
    rounds = []
    pa, pst = batched_assign_plain(pb, pp, max_rounds=max_rounds, rounds_out=rounds)
    assert pa.dtype == torch.int32
    assert np.array_equal(pa.numpy(), np.asarray(ka))
    for i in range(7):
        if kst[i] is None:
            assert pst[i] is None, i
            continue
        want, got = np.asarray(kst[i]), pst[i].numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), i
    return pa[: len(pending)], rounds[0], (pb, pp)


def _uniform(n_nodes, cpu=4000, mem=32 * 1024**3, **kw):
    cache = Cache()
    for i in range(n_nodes):
        cache.add_node(make_node(f"n{i:03d}", cpu_milli=cpu, memory=mem, **kw))
    return cache


def _identical(n, cpu=100, mem=500 * 1024**2, **kw):
    return [make_pod(f"p{j}", cpu_milli=cpu, memory=mem, creation_index=j, **kw)
            for j in range(n)]


def test_identical_pods():
    pa, rounds, (pb, pp) = _assert_same(_uniform(64), _identical(48), KC.minimal_profile())
    assert rounds == 1
    # resource-monotone: greedy's result, pod for pod
    assert torch.equal(pa, greedy_assign_plain(pb, pp)[0][:48])


def test_pods_outnumber_nodes():
    pa, rounds, (pb, pp) = _assert_same(
        _uniform(8), _identical(40, mem=128 * 1024**2), KC.minimal_profile())
    assert (pa >= 0).all() and rounds > 1
    assert torch.equal(pa, greedy_assign_plain(pb, pp)[0][:40])


def test_saturated_cluster():
    cache = _uniform(6, cpu=1000, mem=2 * 1024**3, pods=3)
    pa, _, (pb, pp) = _assert_same(cache, _identical(30, cpu=400, mem=256 * 1024**2),
                                   KC.Profile())
    assert (pa >= 0).sum().item() == 12          # 2 per node fit by cpu


def test_no_fit_filter_overcommits():
    """Without the NodeResourcesFit filter nothing masks a full node out,
    and acceptance does not re-impose capacity either."""
    profile = KC.Profile(
        filters=KC.PluginSet(enabled=()),
        scores=KC.PluginSet(enabled=((KC.NODE_RESOURCES_FIT, 1),)),
        default_spread_constraints=(),
    )
    pa, _, _ = _assert_same(_uniform(2, cpu=1000), _identical(8, cpu=600), profile)
    assert (pa >= 0).all()


def test_host_ports_across_rounds():
    cache = _uniform(2)
    pending = [make_pod(n, cpu_milli=100, host_ports=[80], creation_index=j)
               for j, n in enumerate("abc")]
    profile = KC.Profile(
        filters=KC.PluginSet(enabled=((KC.NODE_RESOURCES_FIT, 1), (KC.NODE_PORTS, 1))),
        scores=KC.PluginSet(enabled=((KC.NODE_RESOURCES_FIT, 1),)),
        default_spread_constraints=(),
    )
    pa, _, _ = _assert_same(cache, pending, profile)
    assert pa[0] != pa[1] and pa[0] >= 0 and pa[1] >= 0 and pa[2] == -1


@pytest.mark.parametrize("seed", range(6))
def test_randomized_resource_clusters(seed):
    cache, pending = random_cluster(np.random.default_rng(seed + 900), num_nodes=48,
                                    num_existing=80, num_pending=64)
    _assert_same(cache, pending, KC.minimal_profile())


@pytest.mark.parametrize("seed", range(3))
def test_randomized_full_profile_with_affinity(seed):
    rng = np.random.default_rng(seed + 950)
    cache, pending = random_cluster(rng, num_nodes=32, num_existing=50, num_pending=32,
                                    with_taints=True, with_extended=True)
    pending = add_affinity(rng, pending)
    _assert_same(cache, pending, KC.Profile())
    _assert_same(cache, pending, affinity_profile())


def test_one_zone_affinity_contention():
    """Zone-affine pods race into one zone: acceptance conflicts every
    round, and topology-coupled scores move mid-round."""
    cache = Cache()
    for i in range(8):
        cache.add_node(make_node(f"n{i}", cpu_milli=1000, labels={
            ZONE: "z0" if i < 3 else "z1", "kubernetes.io/hostname": f"n{i}"}))
    cache.add_pod(make_pod("seed", cpu_milli=100, labels={"app": "web"}, node_name="n0"))
    aff = kt.Affinity(pod_affinity=kt.PodAffinity(
        required=(pod_affinity_term(ZONE, match_labels={"app": "web"}),)))
    pending = [make_pod(f"p{j}", cpu_milli=300, labels={"app": "web"}, affinity=aff,
                        creation_index=j) for j in range(10)]
    for profile in (affinity_profile(), KC.Profile()):
        pa, rounds, _ = _assert_same(cache, pending, profile)
        assert (pa >= 0).sum().item() == 9 and rounds > 1


def test_scheduling_pod_affinity_cycle_shape():
    """One cycle of the SchedulingPodAffinity shape: one zone, the init pods
    bound, a batch of pod_with_pod_affinity pending (more than nodes)."""
    cache = Cache()
    nodes = [KW.node_default(i, ("zone1",)) for i in range(40)]
    for n in nodes:
        cache.add_node(n)
    for j in range(40):
        cache.add_pod(KW.pod_with_pod_affinity(f"init-{j}", "sched-0")
                      .with_node(nodes[j % 40].name))
    pending = [KW.pod_with_pod_affinity(f"m-{j}", "sched-1") for j in range(100)]
    pa, rounds, _ = _assert_same(cache, pending, KC.Profile())
    assert (pa >= 0).all() and rounds > 1


def test_hotspot_round_cap():
    """Every pod fits one node: one pod a round; a cap of 11 rounds leaves
    the twelfth pod unassigned, exactly as kubetpu's loop does."""
    cache = Cache()
    for i in range(4):
        cache.add_node(make_node(f"n{i}", cpu_milli=10000))
    pending = [make_pod(f"p{j}", cpu_milli=100, node_name="n2", creation_index=j)
               for j in range(12)]
    profile = KC.Profile(
        filters=KC.PluginSet(enabled=((KC.NODE_NAME, 1), (KC.NODE_RESOURCES_FIT, 1))),
        scores=KC.PluginSet(enabled=((KC.NODE_RESOURCES_FIT, 1),)),
        default_spread_constraints=(),
    )
    pa, rounds, _ = _assert_same(cache, pending, profile)
    assert set(pa.tolist()) == {2} and rounds == 12
    pa11, rounds11, _ = _assert_same(cache, pending, profile, max_rounds=11)
    assert (pa11 >= 0).sum().item() == 11 and rounds11 == 11


def test_tie_weights_are_the_uint32_hash():
    n = 5000
    want = (np.arange(n, dtype=np.uint32) * np.uint32(2654435761) + np.uint32(1))
    got = PB.tie_weights(n, "cpu").numpy()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", range(4))
def test_round_functions_equal_kubetpu(seed):
    """_tie_spread_choice and _accept on seeded score tables with many ties
    (and every pod of a tie group hashed alike), against kubetpu's."""
    rng = np.random.default_rng(seed)
    P, N, R = 48, 40, 3
    mask = rng.random((P, N)) < 0.6
    mask[rng.random(P) < 0.1] = False
    score = rng.integers(0, 4, size=(P, N)).astype(np.int64)
    score[: P // 2] = score[0]                 # a big identical group
    mask[: P // 2] = mask[0]
    active = rng.random(P) < 0.9
    kc = np.asarray(KB._tie_spread_choice(jnp.asarray(mask), jnp.asarray(score),
                                          jnp.asarray(active)))
    pc = PB._tie_spread_choice(torch.from_numpy(mask), torch.from_numpy(score),
                               torch.from_numpy(active))
    assert np.array_equal(pc.numpy(), kc)
    requests = rng.integers(0, 500, size=(P, R)).astype(np.int64)
    free = rng.integers(-100, 1000, size=(N, R)).astype(np.int64)
    room = rng.integers(0, 3, size=N).astype(np.int32)
    for check in (True, False):
        ka = np.asarray(KB._accept(jnp.asarray(kc), jnp.asarray(requests),
                                   jnp.asarray(free), jnp.asarray(room), check))
        got = PB._accept(pc, torch.from_numpy(requests), torch.from_numpy(free),
                         torch.from_numpy(room), check)
        assert np.array_equal(got.numpy(), ka)


def test_device_dispatch_on_cpu():
    cache, pending = random_cluster(np.random.default_rng(23), num_nodes=20,
                                    num_existing=20, num_pending=10)
    _, _, pb, pp = encoded_pair(cache, pending, KC.Profile())
    a1, _ = batched_assign_device(pb, pp)
    a2, _ = batched_assign_plain(pb, pp)
    assert torch.equal(a1, a2)


SHRUNK = {"initNodes": 48, "initPods": 64, "measurePods": 96}


def test_scheduling_pod_affinity_batched_bound_map_equal():
    """A shrunken SchedulingPodAffinity (48 nodes in zone1, 64 init and 96
    measured pods of pod_with_pod_affinity, batches of 32) on the batched
    engine: the port's run_workload binds exactly what kubetpu's Scheduler
    binds, driven through the same op sequence."""
    client = KClient()
    sched = KScheduler(client, profile=KC.Profile(), max_batch=32, engine="batched",
                       pipeline=False, dispatcher_workers=0, flight_recorder=False)
    client.sched = sched
    for i in range(SHRUNK["initNodes"]):
        sched.on_node_add(KW.node_default(i, ("zone1",)))
    for i in range(2):
        sched.on_namespace_add(kt.Namespace(name=f"sched-{i}"))
    for op_i, prefix, ns, count in (
        (2, "init", "sched-0", SHRUNK["initPods"]),
        (3, "measure", "sched-1", SHRUNK["measurePods"]),
    ):
        for j in range(count):
            sched.on_pod_add(KW.pod_with_pod_affinity(f"{prefix}-{op_i}-{ns}-{j}", ns))
        for _ in range(50):
            if client.bound_by_ns[ns] >= count:
                break
            sched.schedule_batch()
            client.deliver()
    sched.close()
    want = dict(client.bound)
    assert len(want) == 160

    captured = {}
    res = run_workload("SchedulingPodAffinity", PW.Workload("shrunk", SHRUNK),
                       device="cpu", engine="batched", max_batch=32,
                       on_scheduler=lambda s: captured.update(s=s))
    assert res.scheduled == res.measure_pods == 96
    assert res.bound_total == 160 and res.engine == "batched"
    assert res.rounds_per_cycle >= 1
    assert dict(captured["s"].client.bound) == want
