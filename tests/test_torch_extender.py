"""The port's extender path equals kubetpu's, bit for bit.

- B3's extender terms: the plain ``feasible_and_scores`` and both plain
  engines (greedy: assignments and the seven state slots; batched:
  assignments, rounds and state) on batches carrying a seeded
  ``extender_mask`` (about 30% of the real pairs false, some rows all
  false) and an ``extender_score`` of ``raw × weight × 10``, against
  kubetpu's on the same leaves. The clusters put node-affinity and taint
  preferences, spread constraints and inter-pod affinity in play, so every
  normalize (the masked maxima, the affinity min/max, the spread ``size``)
  runs over the shrunk feasible set.
- The scripted-extender scenarios of ``tests/test_extender_client.py``
  (filter shrinks, weighted prioritize, ignorable down, non-ignorable
  blocks, a binder extender owns the bind, the ProcessPreemption veto and
  veto-all, the client against the bridge server) through the port's
  ``Scheduler(device="cpu")`` and kubetpu's ``Scheduler(dispatcher_workers=0)``:
  the same bound maps, binder calls, victims and nominations; and
  ``run_extenders`` / ``extender_chain_hook`` on their own.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubetpu  # noqa: F401
from kubetpu.api.wrappers import make_node, make_pod
from kubetpu.assign.batched import batched_assign_device as k_batched
from kubetpu.assign.greedy import greedy_assign_device as k_greedy
from kubetpu.bridge import ExtenderBackend as KBackend
from kubetpu.bridge import ExtenderServer as KServer
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.sched import Scheduler as KScheduler
from kubetpu.sched.extender import HTTPExtender as KHTTPExtender
from kubetpu.sched.extender import run_extenders as k_run_extenders

from kubetpu_torch.assign.batched import batched_assign_plain
from kubetpu_torch.assign.greedy import greedy_assign_plain
from kubetpu_torch.bridge import ExtenderBackend as PBackend
from kubetpu_torch.bridge import ExtenderServer as PServer
from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.framework.preemption import extender_chain_hook
from kubetpu_torch.sched import Scheduler as PScheduler
from kubetpu_torch.sched.extender import HTTPExtender as PHTTPExtender
from kubetpu_torch.sched.extender import run_extenders as p_run_extenders

from .cluster_gen import random_cluster
from .test_extender_client import ScriptedExtender
from .test_podaffinity import add_affinity, affinity_profile
from .test_scheduler import FakeClient
from .test_scheduler import FakeClock as KFakeClock
from .test_spread import add_spread_pods, spread_profile
from .torch_port_util import (
    FakeClock,
    basic_cluster,
    images_cluster,
    jax_leaves,
    port_params,
    to_port,
)

# ------------------------------------------------- B3's extender terms


def extender_leaves(seed, pad_pods, pad_nodes, num_pods, num_nodes, weight=5):
    """A seeded (mask, score) pair shaped as ``run_extenders`` returns it:
    real pairs pass with probability 0.7, an eighth of the real rows (at
    least one) are all false, pads are false; the score is raw (0..10) ×
    weight × MaxNodeScore / MaxExtenderPriority on the real columns."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((pad_pods, pad_nodes), dtype=bool)
    mask[:num_pods, :num_nodes] = rng.random((num_pods, num_nodes)) >= 0.3
    dead = rng.choice(num_pods, size=max(1, num_pods // 8), replace=False)
    mask[dead] = False
    score = np.zeros((pad_pods, pad_nodes), dtype=np.int64)
    raw = rng.integers(0, 11, (num_pods, num_nodes))
    score[:num_pods, :num_nodes] = raw * (weight * 100 // 10)
    return mask, score


def _images(rng):
    return images_cluster(rng), KC.Profile()


def _basic(rng):
    return basic_cluster(num_nodes=40, num_bound=30, num_pending=24), KC.Profile()


def _spread(rng):
    cache, pending = random_cluster(rng, num_nodes=24, num_existing=50, num_pending=20)
    return (cache, add_spread_pods(rng, pending, hard_ratio=0.5)), spread_profile()


def _affinity(rng):
    cache, pending = random_cluster(rng, num_nodes=20, num_existing=40, num_pending=18)
    return (cache, add_affinity(rng, pending)), affinity_profile()


CLUSTERS = {"images": _images, "basic": _basic, "spread": _spread,
            "affinity": _affinity}


def extender_pair(case, seed):
    """kubetpu's device batch and params with the seeded extender leaves,
    and the port's batch (CPU) carrying the same leaves, with its params."""
    rng = np.random.default_rng(seed)
    (cache, pending), profile = CLUSTERS[case](rng)
    kb = krt.encode_batch(cache.update_snapshot(), pending, profile)
    kp = krt.score_params(profile, kb.resource_names)
    P, N = kb.device.requests.shape[0], kb.device.alloc.shape[0]
    mask, score = extender_leaves(seed, P, N, len(pending), kb.num_nodes)
    kdev = dataclasses.replace(
        kb.device, extender_mask=jnp.asarray(mask),
        extender_score=jnp.asarray(score),
    )
    leaves = jax_leaves(kb.device)
    leaves.update(extender_mask=mask, extender_score=score)
    return kdev, kp, prt.device_batch_from_numpy(leaves, "cpu"), port_params(kp)


def _eq(got, want):
    want = np.asarray(want)
    g = got.numpy()
    assert g.dtype == want.dtype and g.shape == want.shape
    assert np.array_equal(g, want)


def _state_eq(kst, pst):
    for i in range(7):
        if kst[i] is None:
            assert pst[i] is None, i
            continue
        _eq(pst[i], kst[i])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", sorted(CLUSTERS))
def test_feasible_and_scores_with_extender(case, seed):
    kdev, kp, pdev, pp = extender_pair(case, seed)
    kmask, ktotal = krt.feasible_and_scores(kdev, kp)
    pmask, ptotal = prt.feasible_and_scores(pdev, pp)
    _eq(pmask, kmask)
    _eq(ptotal, ktotal)
    # the mask really shrank the feasible set, and a dead row is all false
    base_mask, _ = prt.feasible_and_scores(
        dataclasses.replace(pdev, extender_mask=None, extender_score=None), pp)
    assert int(pmask.sum()) < int(base_mask.sum())
    assert not bool(pmask[~pdev.extender_mask.any(dim=1)].any())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", sorted(CLUSTERS))
def test_greedy_with_extender(case, seed):
    kdev, kp, pdev, pp = extender_pair(case, seed)
    ka, kst = k_greedy(kdev, kp)
    pa, pst = greedy_assign_plain(pdev, pp)
    _eq(pa, ka)
    _state_eq(kst, pst)
    # no pod lands on a node its extender rejected
    got = pa.numpy()
    ext = pdev.extender_mask.numpy()
    assert all(ext[i, j] for i, j in enumerate(got) if j >= 0)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("case", sorted(CLUSTERS))
def test_batched_with_extender(case, seed):
    kdev, kp, pdev, pp = extender_pair(case, seed)
    ka, kst = k_batched(kdev, kp)
    rounds = []
    pa, pst = batched_assign_plain(pdev, pp, rounds_out=rounds)
    _eq(pa, ka)
    _state_eq(kst, pst)
    assert rounds and rounds[0] >= 1


def test_score_only_extender_moves_the_choice():
    """An extender score large enough to beat the plugin total decides the
    node on both sides (the score is added after every normalize)."""
    kdev, kp, pdev, pp = extender_pair("basic", 7)
    P, N = pdev.extender_mask.shape
    mask = np.zeros((P, N), dtype=bool)
    mask[:, :40] = True
    score = np.zeros((P, N), dtype=np.int64)
    score[:, 39] = 10 * 100 * 100
    kdev = dataclasses.replace(kdev, extender_mask=jnp.asarray(mask),
                               extender_score=jnp.asarray(score))
    pdev = dataclasses.replace(pdev, extender_mask=torch.from_numpy(mask),
                               extender_score=torch.from_numpy(score))
    ka, _ = k_greedy(kdev, kp)
    pa, _ = greedy_assign_plain(pdev, pp)
    _eq(pa, ka)
    assert int(pa[0]) == 39


# ------------------------------------------- scripted extender scenarios


class _Client(FakeClient):
    """FakeClient that also records victim deletes and nominations."""

    def __init__(self, fail_binds_for=()):
        super().__init__(fail_binds_for)
        self.deleted = []
        self.nominated = []

    def delete_pod(self, pod, reason=""):
        self.deleted.append(pod.name)

    def nominate(self, pod, node_name):
        self.nominated.append((pod.name, node_name))


def _pair(configs, profile=None, preemption=False):
    """kubetpu's and the port's Scheduler over the same extender configs
    (``minimal_profile`` by default), each with its own client and clock."""
    profile = profile or KC.minimal_profile()
    kcfg = KC.SchedulerConfiguration(profiles=(profile,), extenders=tuple(configs))
    kc, pc = _Client(), _Client()
    ks = KScheduler(kc, profile=profile, cfg=kcfg, dispatcher_workers=0,
                    clock=KFakeClock())
    ps = PScheduler(pc, profile=to_port(profile), cfg=to_port(kcfg),
                    device="cpu", clock=FakeClock())
    if preemption:
        ks.enable_preemption()
        ps.enable_preemption()
    return (ks, kc), (ps, pc)


def _run(pair, setup, cycles=1):
    """Apply ``setup(add_node, add_pod)`` to both schedulers, run
    ``cycles`` cycles on each, and return both clients."""
    (ks, kc), (ps, pc) = pair
    for sched, conv in ((ks, lambda x: x), (ps, to_port)):
        setup(lambda n, s=sched, c=conv: s.on_node_add(c(n)),
              lambda p, s=sched, c=conv: s.on_pod_add(c(p)))
        for _ in range(cycles):
            sched.schedule_batch()
    ks.dispatcher.sync()
    ks._drain_bind_completions()
    ks.close()
    ps.close()
    return kc, pc


def _same(kc, pc):
    assert pc.bound == kc.bound
    assert pc.bind_calls == kc.bind_calls
    assert pc.deleted == kc.deleted
    assert pc.nominated == kc.nominated


def _three_nodes(add_node, add_pod):
    for i in range(3):
        add_node(make_node(f"n{i}", cpu_milli=4000))
    add_pod(make_pod("p", cpu_milli=100))


def test_filter_shrinks_candidates():
    ext = ScriptedExtender(reject={"n0", "n1"})
    try:
        cfg = KC.ExtenderConfig(url_prefix=ext.url, filter_verb="filter",
                                node_cache_capable=True)
        kc, pc = _run(_pair([cfg]), _three_nodes)
        _same(kc, pc)
        assert pc.bound == {"default/p": "n2"}
        assert ext.filter_calls == 2
    finally:
        ext.close()


def test_prioritize_weighted():
    ext = ScriptedExtender(prefer="n0")
    try:
        cfg = KC.ExtenderConfig(url_prefix=ext.url, prioritize_verb="prioritize",
                                weight=5, node_cache_capable=True)

        def setup(add_node, add_pod):
            add_node(make_node("n0", cpu_milli=4000))
            add_node(make_node("n1", cpu_milli=8000))
            add_pod(make_pod("seed", cpu_milli=2000, node_name="n0"))
            add_pod(make_pod("p", cpu_milli=100))

        kc, pc = _run(_pair([cfg]), setup)
        _same(kc, pc)
        assert pc.bound == {"default/p": "n0"}
    finally:
        ext.close()


@pytest.mark.parametrize("ignorable", [True, False])
def test_extender_down(ignorable):
    cfg = KC.ExtenderConfig(url_prefix="http://127.0.0.1:1", filter_verb="filter",
                            node_cache_capable=True, ignorable=ignorable,
                            http_timeout_s=0.5)
    kc, pc = _run(_pair([cfg]), _three_nodes)
    _same(kc, pc)
    assert pc.bound == ({"default/p": "n0"} if ignorable else {})


def test_two_extenders_chain_and_non_cache_capable():
    """Two extenders in order (the second sees the first's survivors), one
    of them posting full Nodes items."""
    a = ScriptedExtender(reject={"n0"})
    b = ScriptedExtender(reject={"n1"}, prefer="n3")
    try:
        cfgs = [
            KC.ExtenderConfig(url_prefix=a.url, filter_verb="filter",
                              node_cache_capable=False),
            KC.ExtenderConfig(url_prefix=b.url, filter_verb="filter",
                              prioritize_verb="prioritize", weight=3,
                              node_cache_capable=True),
        ]

        def setup(add_node, add_pod):
            for i in range(5):
                add_node(make_node(f"n{i}", cpu_milli=2000 + 500 * i))
            for j in range(6):
                add_pod(make_pod(f"p{j}", cpu_milli=700, creation_index=j))

        kc, pc = _run(_pair(cfgs), setup, cycles=2)
        _same(kc, pc)
        assert not ({"n0", "n1"} & set(pc.bound.values()))
    finally:
        a.close()
        b.close()


def _own_server_setup(add_node, add_pod):
    for name, cpu in (("n0", 1000), ("n1", 4000), ("n2", 4000)):
        add_node(make_node(name, cpu_milli=cpu))
    add_pod(make_pod("p", cpu_milli=2000))


def test_client_against_own_servers():
    """Each scheduler calls its own package's bridge server, whose cache
    knows n0 and n1 only: the 2-cpu pod must land on n1 on both."""
    kb = KBackend(profile=KC.minimal_profile())
    pb = PBackend(profile=to_port(KC.minimal_profile()), device="cpu")
    ksrv, psrv = KServer(kb).start(), PServer(pb).start()
    try:
        for be, conv in ((kb, lambda x: x), (pb, to_port)):
            be.upsert_nodes([conv(make_node("n0", cpu_milli=1000)),
                             conv(make_node("n1", cpu_milli=4000))])

        def cfg(url):
            return KC.ExtenderConfig(url_prefix=url, filter_verb="filter",
                                     prioritize_verb="prioritize", weight=2,
                                     node_cache_capable=True)

        (ks, kc), _ = _pair([cfg(ksrv.url)])
        _, (ps, pc) = _pair([cfg(psrv.url)])
        kc, pc = _run(((ks, kc), (ps, pc)), _own_server_setup)
        _same(kc, pc)
        assert pc.bound == {"default/p": "n1"}
    finally:
        ksrv.close()
        psrv.close()


def test_binder_extender_owns_the_bind_call():
    kbound, pbound = [], []
    kb = KBackend(profile=KC.minimal_profile(),
                  bind_fn=lambda pod, node: kbound.append((pod.name, node)))
    pb = PBackend(profile=to_port(KC.minimal_profile()), device="cpu",
                  bind_fn=lambda pod, node: pbound.append((pod.name, node)))
    ksrv, psrv = KServer(kb).start(), PServer(pb).start()
    try:
        for be, conv in ((kb, lambda x: x), (pb, to_port)):
            be.upsert_nodes([conv(make_node("n0", cpu_milli=4000))])

        def cfg(url):
            return KC.ExtenderConfig(url_prefix=url, filter_verb="filter",
                                     bind_verb="bind", node_cache_capable=True)

        (ks, kc), _ = _pair([cfg(ksrv.url)])
        _, (ps, pc) = _pair([cfg(psrv.url)])

        def setup(add_node, add_pod):
            add_node(make_node("n0", cpu_milli=4000))
            add_pod(make_pod("p", cpu_milli=100))

        kc, pc = _run(((ks, kc), (ps, pc)), setup)
        _same(kc, pc)
        assert pbound == kbound == [("p", "n0")]
        assert pc.bound == {} and pc.bind_calls == 0
        assert ps.metrics.scheduled == 1 and ps.metrics.bind_errors == 0
    finally:
        ksrv.close()
        psrv.close()


def _full_nodes(add_node, add_pod):
    for i in range(2):
        add_node(make_node(f"n{i}", cpu_milli=1000))
        add_pod(make_pod(f"low-{i}", cpu_milli=900, priority=0,
                         node_name=f"n{i}", creation_index=i))
    add_pod(make_pod("high", cpu_milli=800, priority=100, creation_index=10))


@pytest.mark.parametrize("veto,want_deleted,want_nominated", [
    ((), ["low-1"], [("high", "n1")]),
    (("n0",), ["low-1"], [("high", "n1")]),
    (("n1",), ["low-0"], [("high", "n0")]),
    (("n0", "n1"), [], []),
])
def test_preempt_extender_veto(veto, want_deleted, want_nominated):
    ext = ScriptedExtender(preempt_veto=set(veto))
    try:
        cfg = KC.ExtenderConfig(url_prefix=ext.url, preempt_verb="preempt")
        kc, pc = _run(_pair([cfg], preemption=True), _full_nodes)
        _same(kc, pc)
        assert pc.deleted == want_deleted
        assert pc.nominated == want_nominated
        assert ext.preempt_calls == 2
    finally:
        ext.close()


def test_preempt_extender_down_fails_the_attempt():
    cfg = KC.ExtenderConfig(url_prefix="http://127.0.0.1:1", preempt_verb="preempt",
                            http_timeout_s=0.5)
    kc, pc = _run(_pair([cfg], preemption=True), _full_nodes)
    _same(kc, pc)
    assert pc.deleted == [] and pc.nominated == []


# ------------------------------------------------- the host halves alone


def test_run_extenders_equal():
    """``run_extenders`` gives the same (mask, score) leaves on both sides,
    a failing non-ignorable extender's pods all false."""
    good = ScriptedExtender(reject={"n1", "n4"}, prefer="n2")
    try:
        cfgs = [
            KC.ExtenderConfig(url_prefix=good.url, filter_verb="filter",
                              prioritize_verb="prioritize", weight=4,
                              node_cache_capable=True),
            KC.ExtenderConfig(url_prefix="http://127.0.0.1:1", filter_verb="filter",
                              ignorable=True, http_timeout_s=0.5),
        ]
        pods = [make_pod(f"p{j}", cpu_milli=100) for j in range(5)]
        names = [f"n{i}" for i in range(6)]
        km, ks = k_run_extenders([KHTTPExtender(c) for c in cfgs], pods, names,
                                 6, pad_pods=8, pad_nodes=8)
        pm, ps = p_run_extenders([PHTTPExtender(to_port(c)) for c in cfgs],
                                 [to_port(p) for p in pods], names, 6,
                                 pad_pods=8, pad_nodes=8)
        assert np.array_equal(km, pm) and np.array_equal(ks, ps)
        assert ps.dtype == np.int64 and int(ps[0, 2]) == 10 * 4 * 10
    finally:
        good.close()


def test_extender_chain_hook_trims_in_order():
    a = ScriptedExtender(preempt_veto={"n0"})
    b = ScriptedExtender(preempt_veto={"n2"})
    try:
        cfgs = [KC.ExtenderConfig(url_prefix=e.url, preempt_verb="preempt")
                for e in (a, b)]
        hook = extender_chain_hook([PHTTPExtender(to_port(c)) for c in cfgs])
        pod = to_port(make_pod("high", cpu_milli=100))
        cand = {
            f"n{i}": ([to_port(make_pod(f"v{i}", cpu_milli=100,
                                        node_name=f"n{i}"))], i)
            for i in range(4)
        }
        out = hook(pod, cand)
        assert out == {"n1": (["default/v1"], 1), "n3": (["default/v3"], 3)}
        assert extender_chain_hook([]) is None
    finally:
        a.close()
        b.close()
