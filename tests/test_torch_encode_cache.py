"""The port's encode cache: cached encodes are bit for bit the fresh ones.

Modelled on ``tests/test_encode_cache.py``. The port keeps its own copy of
kubetpu's ``EncodeCache``; on the same seeded clusters (basic, node
affinity with taints, topology spread, inter-pod affinity, host ports) the
port's cached encode must equal its fresh encode and kubetpu's cached
encode leaf for leaf, across cycles with churn, LRU eviction and template
drift. At the scheduler level: a pod update never reuses a stale row, node
add and delete are scoped (rows extended or compacted) and a node update
flushes, the informer pre-encodes a template's rows once, and the bound
maps are equal with the cache on and off and to kubetpu's.
"""

import pytest

import kubetpu  # noqa: F401
from kubetpu.api import types as kt
from kubetpu.api.wrappers import make_node, make_pod, node_affinity_required, req_in
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.perf import workloads as KW
from kubetpu.state.encode_cache import EncodeCache as KEncodeCache
from kubetpu.state.snapshot import Cache

from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.state.encode_cache import EncodeCache

from .torch_port_util import (
    assert_batches_equal,
    drive,
    port_batch_from_jax,
    port_cache,
    scheduler_pair,
    to_port,
)


# ---------------------------------------------------------------- fixtures

def _basic_cluster():
    cache = Cache()
    for i in range(8):
        cache.add_node(make_node(f"n{i}", cpu_milli=8000, memory=16 * 1024**3))
    pods = [make_pod(f"p{j}", cpu_milli=100 * (1 + j % 3),
                     memory=256 * 1024**2, creation_index=j)
            for j in range(12)]
    return cache, pods


def _node_affinity_cluster():
    cache = Cache()
    for i in range(8):
        cache.add_node(make_node(
            f"n{i}", cpu_milli=8000, memory=16 * 1024**3,
            labels={"zone": f"z{i % 3}"},
            taints=((kt.Taint("dedic", "x", kt.TaintEffect.NO_SCHEDULE),)
                    if i % 4 == 0 else ()),
        ))
    pods = [make_pod(
        f"p{j}", cpu_milli=100, memory=128 * 1024**2,
        affinity=node_affinity_required(
            kt.NodeSelectorTerm(match_expressions=(req_in("zone", "z0", "z1"),))),
        tolerations=((kt.Toleration(key="dedic", operator=kt.TolerationOperator.EXISTS),)
                     if j % 2 else ()),
        creation_index=j,
    ) for j in range(12)]
    return cache, pods


def _spread_cluster():
    cache = Cache()
    for i in range(9):
        cache.add_node(KW.node_default(i, zones=("za", "zb", "zc")))
    for j in range(6):
        cache.add_pod(KW.pod_with_topology_spreading(f"ex{j}", "default")
                      .with_node(f"scheduler-perf-{j % 9}"))
    pods = [KW.pod_with_topology_spreading(f"p{j}", "default") for j in range(12)]
    return cache, pods


def _interpod_cluster():
    cache = Cache()
    cache.add_namespace(kt.Namespace(name="sched-0"))
    cache.add_namespace(kt.Namespace(name="sched-1"))
    for i in range(9):
        cache.add_node(KW.node_default(i, zones=("za", "zb")))
    cache.add_pod(make_pod("seed", namespace="sched-0", labels={"color": "blue"},
                           cpu_milli=100, memory=128 * 1024**2,
                           node_name="scheduler-perf-0"))
    pods = [KW.pod_with_pod_affinity(f"p{j}", "sched-1") for j in range(10)]
    return cache, pods


def _ports_cluster():
    cache = Cache()
    for i in range(6):
        cache.add_node(make_node(f"n{i}", cpu_milli=8000, memory=16 * 1024**3))
    cache.add_pod(make_pod("squatter", cpu_milli=100, memory=64 * 1024**2,
                           host_ports=[8080], node_name="n0"))
    pods = [make_pod(f"p{j}", cpu_milli=100, memory=64 * 1024**2,
                     host_ports=[8080] if j % 2 else [9090], creation_index=j)
            for j in range(8)]
    return cache, pods


FIXTURES = {
    "basic": _basic_cluster,
    "node-affinity": _node_affinity_cluster,
    "spread": _spread_cluster,
    "interpod": _interpod_cluster,
    "ports": _ports_cluster,
}


def _churn(cycle: int, cache: Cache):
    """Between-cycle churn: a bound pod whose labels alternate, so resource
    rows and affinity / spread facts both move."""
    return make_pod(
        f"churn-{cycle}", cpu_milli=50, memory=32 * 1024**2,
        labels={"color": "blue" if cycle % 2 else "red"},
        node_name=cache._node_order[cycle % len(cache._node_order)],
    )


def _run_cycles(cache, pods, port_ec, kube_ec, cycles=3, pods_of=None):
    """Encode ``cycles`` batches with churn between them through kubetpu's
    cached encode and the port's cached and fresh encodes; every pair must
    be equal. ``pods_of(cycle)`` overrides the pending pods per cycle."""
    profile = KC.Profile()
    pcache = port_cache(cache)
    ksnap, psnap = cache.update_snapshot(), pcache.update_snapshot()
    kprev = pprev = None
    for cycle in range(cycles):
        batch = pods_of(cycle) if pods_of else pods
        ported = [to_port(p) for p in batch]
        kb = krt.encode_batch(ksnap, batch, profile, prev_nt=kprev, cache=kube_ec)
        cached = prt.encode_batch(psnap, ported, to_port(profile), prev_nt=pprev,
                                  cache=port_ec, device="cpu")
        fresh = prt.encode_batch(psnap, ported, to_port(profile), device="cpu")
        assert_batches_equal(cached.device, fresh.device)
        assert_batches_equal(cached.device, port_batch_from_jax(kb.device))
        kprev, pprev = kb.node_tensors, cached.node_tensors
        churn = _churn(cycle, cache)
        cache.add_pod(churn)
        pcache.add_pod(to_port(churn))
        ksnap, psnap = cache.update_snapshot(ksnap), pcache.update_snapshot(psnap)
    return cached


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_cached_encode_equals_fresh_and_kubetpu(kind):
    cache, pods = FIXTURES[kind]()
    ec = EncodeCache()
    _run_cycles(cache, pods, ec, KEncodeCache())
    # steady state hit the cache (template sharing across cycles)
    assert sum(ec.hits.values()) > 0


def test_eviction_reencode_parity():
    """A bound of two rows with six templates forces evictions; evicted
    rows rebuild on demand and parity holds."""
    cache, _ = _basic_cluster()
    pods = [make_pod(f"p{j}", cpu_milli=100 + 10 * j, memory=64 * 1024**2,
                     node_selector={"kubernetes.io/os": "linux"} if j % 2 else None,
                     creation_index=j)
            for j in range(6)]
    ec = EncodeCache(max_entries=2)
    _run_cycles(cache, pods, ec, KEncodeCache(max_entries=2))
    assert len(ec._filter_rows) <= 2 and sum(ec.misses.values()) > 6


def test_template_drift_uses_new_rows():
    """The same workload re-stamped with another spec maps to new keys:
    both generations equal the fresh encode, and the drifted selector's
    static row matches no node."""
    cache, _ = _basic_cluster()
    gen1 = [make_pod(f"p{j}", cpu_milli=100, memory=64 * 1024**2) for j in range(6)]
    gen2 = [make_pod(f"p{j}", cpu_milli=200, memory=64 * 1024**2,
                     node_selector={"absent": "x"}) for j in range(6)]
    last = _run_cycles(cache, None, EncodeCache(), KEncodeCache(), cycles=2,
                       pods_of=lambda c: gen1 if c == 0 else gen2)
    b = last.device
    assert b.static_mask is not None
    assert not b.static_mask[b.static_sig[:6].long()].any()


# ----------------------------------------------------- scheduler-level

def test_stale_row_never_survives_pod_update():
    """After ``on_pod_update`` changes a pending pod's node selector, the
    next cycle schedules the NEW spec (the event-time rows of the old
    object are keyed by its old signature)."""
    results = []
    for s, client in scheduler_pair():
        conv = to_port if "torch" in type(s).__module__ else (lambda x: x)
        s.on_node_add(conv(make_node("a", labels={"grp": "a"})))
        s.on_node_add(conv(make_node("b", labels={"grp": "b"})))
        # a first cycle establishes node tensors (event-time pre-encode arms)
        s.on_pod_add(conv(make_pod("warm", cpu_milli=10, memory=16 * 1024**2)))
        drive(s, client)
        old = conv(make_pod("p", cpu_milli=10, memory=16 * 1024**2,
                            node_selector={"grp": "a"}))
        s.on_pod_add(old)
        s.on_pod_update(old, conv(make_pod("p", cpu_milli=10, memory=16 * 1024**2,
                                           node_selector={"grp": "b"})))
        results.append(drive(s, client))
    assert results[1]["p"] == "b"
    assert results[1] == results[0]


def _node_event(kind):
    """A node event for the 12-node cluster below: a genuine add, a delete,
    or an update that relabels a node into another zone."""
    if kind == "add":
        return lambda s, conv: s.on_node_add(conv(KW.node_default(12, ("za", "zb", "zc"))))
    if kind == "delete":
        return lambda s, conv: s.on_node_delete(conv(KW.node_default(5, ("za", "zb", "zc"))))
    old = KW.node_default(4, ("za", "zb", "zc"))
    new = KW.node_default(4, ("zc",))
    return lambda s, conv: s.on_node_update(conv(old), conv(new))


@pytest.mark.parametrize("kind", ["add", "delete", "update"])
def test_node_events_scoped_or_flushed(kind):
    """A node add extends the cached rows in place, a delete compacts them
    (both scoped: no flush), an update flushes; every way the bound map
    equals the cache-off run's and kubetpu's."""
    maps = []
    caches = []
    for encode_cache in (True, False):
        for s, client in scheduler_pair(encode_cache=encode_cache):
            conv = to_port if "torch" in type(s).__module__ else (lambda x: x)
            for i in range(12):
                s.on_node_add(conv(KW.node_default(i, ("za", "zb", "zc"))))
            for j in range(16):
                s.on_pod_add(conv(KW.pod_with_topology_spreading(f"a-{j}", "ns")))
            drive(s, client)
            _node_event(kind)(s, conv)
            for j in range(16):
                s.on_pod_add(conv(KW.pod_with_topology_spreading(f"b-{j}", "ns")))
            maps.append(drive(s, client))
            caches.append(s.encode_cache)
    assert maps[0] == maps[1] == maps[2] == maps[3]
    stats = caches[1].stats()             # the port's, cache on
    assert stats == caches[0].stats()     # kubetpu's, cache on
    if kind == "add":
        assert stats["scoped_extensions"] >= 1 and stats["invalidations"] == 0
    elif kind == "delete":
        assert stats["scoped_removals"] >= 1 and stats["invalidations"] == 0
    else:
        assert stats["invalidations"] >= 1


def test_event_time_precompute_builds_rows_once():
    """A 200-pod burst from one template costs at most one filter-row
    build; the informer deliveries gather from then on."""
    _, (s, client) = scheduler_pair(max_batch=64)
    for i in range(10):
        s.on_node_add(to_port(KW.node_default(i)))
    s.on_pod_add(to_port(KW.pod_default("warm", "ns")))
    drive(s, client)
    ec = s.encode_cache
    m0 = ec.misses["filter"]
    for j in range(200):
        s.on_pod_add(to_port(KW.pod_default(f"p-{j}", "ns")))
    assert ec.misses["filter"] - m0 <= 1
    assert ec.hits["filter"] >= 199
    assert s.run_until_idle() == 200
    assert ec.hit_rate() is not None and ec.hit_rate() > 0.9


@pytest.mark.parametrize("factory", [
    KW.pod_default, KW.pod_with_topology_spreading, KW.pod_with_pod_affinity,
], ids=["basic", "spread", "interpod-affinity"])
def test_scheduler_bound_map_cache_on_equals_off(factory):
    maps = []
    for encode_cache in (False, True):
        for s, client in scheduler_pair(encode_cache=encode_cache):
            conv = to_port if "torch" in type(s).__module__ else (lambda x: x)
            for i in range(12):
                s.on_node_add(conv(KW.node_default(i, zones=("za", "zb", "zc"))))
            s.on_pod_add(conv(make_pod(
                "seed", namespace="sched-0", labels={"color": "blue"},
                cpu_milli=100, memory=100 * 1024**2, node_name="scheduler-perf-0")))
            for j in range(32):
                s.on_pod_add(conv(factory(f"p-{j}", "sched-0")))
            maps.append(drive(s, client))
    assert maps[0] == maps[1] == maps[2] == maps[3]
    assert len(maps[0]) > 1
