"""DynamicResources in the port against kubetpu, exactly.

The same DRA clusters (dense single-device pools, prioritized-list claims
with a fast and a slow alternative, a mix of both with a pinned, a shared
and a missing claim) go through kubetpu and through the port:

- ``encode_batch``: every leaf, the resource axis with its
  ``dra/pool<id>`` columns, and the ``dra_score_raw`` / ``dra_score_sig``
  leaves;
- the plain ``feasible_and_scores`` with the DRA leaf, on those batches and
  on a SchedulingBasic batch given a seeded leaf (S5 = 8 rows of values in
  [0, 8 * FIRST_AVAILABLE_MAX], ties among identical nodes included);
- the greedy, batched, packing and placement plain engines on them;
- the schedulers (kubetpu's with ``dispatcher_workers=0``, the port's on
  the CPU), serial and pipelined, on ``tests/test_dra.py``'s scenarios
  (end to end, release and requeue, a shared claim, Unreserve of a shared
  claim, Unreserve on a bind failure, the PreEnqueue gate, in-batch
  contention on both engines) and on the prioritized-list scenario at 8
  nodes: bound maps, claim allocations and reservations, and the
  claim-status writes PreBind sends;
- SchedulingWithResourceClaimTemplate/fast through the port's
  ``run_workload`` against kubetpu's Scheduler driven through its ops.

It also holds the ctypes mirror of ``ScoreArgs`` to the C struct, field
for field, since the DRA fields extend it.
"""

import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp

import kubetpu  # noqa: F401  (x64 on)
from kubetpu.api import types as KT
from kubetpu.api import wrappers as KWR
from kubetpu.assign import packing as KP
from kubetpu.assign.batched import batched_assign_device as k_batched
from kubetpu.assign.greedy import greedy_assign_device as k_greedy
from kubetpu.assign.placement import placement_assign_device as k_placement
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.perf import workloads as KW
from kubetpu.perf.runner import _Client as KClient
from kubetpu.sched.scheduler import Scheduler as KScheduler
from kubetpu.state.snapshot import Cache

from kubetpu_torch import kernels
from kubetpu_torch.assign import packing as PP
from kubetpu_torch.assign.batched import batched_assign_plain
from kubetpu_torch.assign.greedy import greedy_assign_plain
from kubetpu_torch.assign.placement import placement_assign_plain
from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.perf import run_workload

from .torch_port_util import (
    basic_cluster, jax_leaves, port_batch_from_jax, port_cache, port_params,
    to_port,
)
from .torch_port_util import both as _both

DRIVER = "test-driver.cdi.k8s.io"


# ---------------------------------------------------------------- objects
# Each builder takes the side's types module (kubetpu's or the port's).

def gpu_class(T, name="gpu", kind=None):
    expr = f'device.driver == "{DRIVER}"'
    if kind:
        expr += f' && device.attributes["kind"] == "{kind}"'
    return T.DeviceClass(name, selectors=(T.CELSelector(expr),))


def node_slice(T, node, n, kind=None, suffix=""):
    attrs = (("kind", kind),) if kind else ()
    return T.ResourceSlice(
        name=f"slice-{node}{suffix}", driver=DRIVER, pool=f"{node}{suffix}",
        node_name=node,
        devices=tuple(T.Device(f"dev-{j}", attributes=attrs) for j in range(n)),
    )


def one_device_claim(T, name, class_name="gpu", ns="default", count=1):
    return T.ResourceClaim(
        name=name, namespace=ns, uid=f"{ns}/{name}",
        requests=(T.DeviceRequest(
            name="req-0", device_class_name=class_name, count=count,
        ),),
    )


def prio_claim(T, name, ns="default"):
    """One request whose first alternative is a fast device, the second a
    slow one (``tests/test_dra.py:357``'s claim)."""
    return T.ResourceClaim(
        name=name, namespace=ns, uid=f"{ns}/{name}",
        requests=(T.DeviceRequest(name="req", first_available=(
            T.DeviceSubRequest(name="fast", device_class_name="fast-gpu"),
            T.DeviceSubRequest(name="slow", device_class_name="slow-gpu"),
        )),),
    )


def dra_profile(C):
    return C.Profile(
        filters=C.PluginSet(enabled=(
            (C.NODE_RESOURCES_FIT, 1), (C.DYNAMIC_RESOURCES, 1),
        )),
        scores=C.PluginSet(enabled=(
            (C.NODE_RESOURCES_FIT, 1), (C.DYNAMIC_RESOURCES, 1),
        )),
        default_spread_constraints=(),
    )


def prio_objects(T, W, nodes=8, fast_every=2, slow=2, fast=1, pods=16,
                 slow_on_fast=True):
    """The prioritized-list scenario: ``nodes`` nodes with ``slow`` slow
    devices each, every ``fast_every``-th also with ``fast`` fast ones (and
    then no slow one unless ``slow_on_fast``), and ``pods`` pods each with
    its own first_available=(fast, slow) claim. Returns (node objects,
    classes, slices, claims, pods)."""
    ns = [W.make_node(f"n{i}", cpu_milli=8000, memory=32 * 1024**3)
          for i in range(nodes)]
    classes = [gpu_class(T, "fast-gpu", "fast"), gpu_class(T, "slow-gpu", "slow")]
    slices = []
    for i, n in enumerate(ns):
        has_fast = i % fast_every == 0
        if slow_on_fast or not has_fast:
            slices.append(node_slice(T, n.name, slow, "slow", "-slow"))
        if has_fast:
            slices.append(node_slice(T, n.name, fast, "fast", "-fast"))
    claims = [prio_claim(T, f"c{j}") for j in range(pods)]
    ps = [W.make_pod(f"p{j}", cpu_milli=100, memory=128 * 1024**2,
                     claims=[f"c{j}"], creation_index=j) for j in range(pods)]
    return ns, classes, slices, claims, ps


# ------------------------------------------------------------ encode level

def _cache_dense(seed):
    rng = np.random.default_rng(seed)
    cache = Cache()
    cache.dra.add_class(gpu_class(KT))
    for i in range(6):
        cache.add_node(KWR.make_node(f"n{i}", cpu_milli=4000, memory=8 * 1024**3))
        if i % 3:
            cache.dra.add_slice(node_slice(KT, f"n{i}", int(rng.integers(1, 4))))
    pending = []
    for j in range(8):
        cache.dra.add_claim(one_device_claim(KT, f"c{j}", count=1 + (j == 5)))
        pending.append(KWR.make_pod(f"p{j}", cpu_milli=100, claims=[f"c{j}"],
                                    creation_index=j))
    return cache, pending


def _cache_prio(seed):
    cache = Cache()
    ns, classes, slices, claims, pods = prio_objects(KT, KWR, pods=12 + seed)
    for n in ns:
        cache.add_node(n)
    for c in classes:
        cache.dra.add_class(c)
    for s in slices:
        cache.dra.add_slice(s)
    for c in claims:
        cache.dra.add_claim(c)
    return cache, pods


def _cache_mixed(seed):
    """Prioritized-list pods, dense single-device pods on the slow class, a
    claim pinned by an earlier allocation, a shared claim and a missing
    claim."""
    cache, pods = _cache_prio(seed)
    for j in range(6):
        cache.dra.add_claim(one_device_claim(KT, f"d{j}", class_name="slow-gpu"))
        pods.append(KWR.make_pod(f"q{j}", cpu_milli=200, claims=[f"d{j}"],
                                 creation_index=100 + j))
    pinned = one_device_claim(KT, "pinned", class_name="slow-gpu")
    cache.dra.add_claim(pinned)
    alloc = cache.dra.allocate_on_node([pinned], "n3")
    cache.dra.set_allocation(pinned.key, alloc[0], "someone")
    cache.dra.add_claim(one_device_claim(KT, "shared", class_name="slow-gpu"))
    pods += [
        KWR.make_pod("pinned-pod", cpu_milli=100, claims=["pinned"]),
        KWR.make_pod("share-a", cpu_milli=100, claims=["shared"]),
        KWR.make_pod("share-b", cpu_milli=100, claims=["shared"]),
        KWR.make_pod("missing", cpu_milli=100, claims=["nope"]),
    ]
    return cache, pods


CASES = {"dense": _cache_dense, "prioritized": _cache_prio, "mixed": _cache_mixed}


def _encode_both(cache, pending, profile):
    kb = krt.encode_batch(cache.update_snapshot(), pending, profile)
    pb = prt.encode_batch(
        port_cache(cache).update_snapshot(), [to_port(p) for p in pending],
        to_port(profile), device="cpu",
    )
    return kb, pb


def _assert_leaves_equal(kb, pb):
    want = jax_leaves(kb.device)
    got = prt.batch_leaves(pb.device)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert (g is None) == (w is None), name
        if w is None or name in prt.NESTED:
            continue
        w, g = np.asarray(w), g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name
    assert pb.resource_names == kb.resource_names
    assert pb.node_names == kb.node_names


@pytest.mark.parametrize("profile", ["default", "dra"])
@pytest.mark.parametrize("case,seed", [(c, s) for c in sorted(CASES) for s in (0, 1)])
def test_encode_equal(case, seed, profile):
    cache, pending = CASES[case](seed)
    prof = KC.Profile() if profile == "default" else dra_profile(KC)
    kb, pb = _encode_both(cache, pending, prof)
    _assert_leaves_equal(kb, pb)
    b = pb.device
    if case in ("dense", "mixed"):
        assert any(r.startswith("dra/pool") for r in pb.resource_names)
        assert b.alloc.shape[1] == 4
    if case in ("prioritized", "mixed"):
        assert b.dra_score_raw is not None and b.dra_score_sig is not None
        assert int(b.dra_score_raw.max()) == KT.FIRST_AVAILABLE_MAX
    else:
        assert b.dra_score_raw is None
    # a claim pod's batch is assume-coupled: the pipeline never pre-encodes it
    sb = prt.encode_batch_static(port_cache(cache).update_snapshot(),
                                 [to_port(p) for p in pending], to_port(prof))
    assert sb.assume_coupled


# ---------------------------------------------------------- device leaves

def _seeded_leaf(P, N, seed, rows=8):
    """S5 = ``rows`` rows of values in [0, 8 * FIRST_AVAILABLE_MAX] over the
    first ``N`` nodes (ties within a row are common), and a signature for
    every pod."""
    rng = np.random.default_rng(seed)
    raw = np.zeros((rows, N[1]), dtype=np.int64)
    raw[:, :N[0]] = rng.integers(0, 8 * KT.FIRST_AVAILABLE_MAX + 1, size=(rows, N[0]))
    raw[0, :N[0]] = 0              # one all-zero row: the term is 0 there
    sig = rng.integers(0, rows, size=P).astype(np.int32)
    return raw, sig


def with_dra_leaf(kb, pb, seed):
    """kubetpu's device batch and the port's with the same seeded leaf."""
    raw, sig = _seeded_leaf(pb.requests.shape[0], (kb.num_nodes, pb.alloc.shape[0]), seed)
    kd = dataclasses.replace(kb.device, dra_score_raw=jnp.asarray(raw),
                             dra_score_sig=jnp.asarray(sig))
    pd = dataclasses.replace(pb, dra_score_raw=torch.from_numpy(raw),
                             dra_score_sig=torch.from_numpy(sig))
    return kd, pd


def _batches(kind, seed):
    """(kubetpu device batch, its params, the port's batch, its params)."""
    if kind == "seeded":
        cache, pending = basic_cluster(num_nodes=24, num_bound=20, num_pending=20)
        prof = KC.Profile()
        kb = krt.encode_batch(cache.update_snapshot(), pending, prof)
        kd, pd = with_dra_leaf(kb, port_batch_from_jax(kb.device), seed)
    else:
        cache, pending = CASES[kind](seed)
        prof = KC.Profile()
        kb = krt.encode_batch(cache.update_snapshot(), pending, prof)
        kd, pd = kb.device, port_batch_from_jax(kb.device)
    kp = krt.score_params(prof, kb.resource_names)
    assert kp.w_dra == 1
    return kd, kp, pd, port_params(kp)


BATCHES = [("seeded", 0), ("seeded", 1), ("prioritized", 0), ("mixed", 1)]


@pytest.mark.parametrize("kind,seed", BATCHES)
def test_feasible_and_scores_equal(kind, seed):
    kd, kp, pd, pp = _batches(kind, seed)
    kmask, ktotal = krt.filter_score_batch(kd, kp)
    mask, total = prt.feasible_and_scores(pd, pp)
    assert np.array_equal(mask.numpy(), np.asarray(kmask))
    assert np.array_equal(total.numpy(), np.asarray(ktotal))
    # the term moves the total: without the leaf it differs somewhere
    _, bare = prt.feasible_and_scores(
        dataclasses.replace(pd, dra_score_raw=None, dra_score_sig=None), pp)
    assert not torch.equal(bare, total)
    # and w_dra = 0 drops it
    _, unweighted = prt.feasible_and_scores(pd, dataclasses.replace(pp, w_dra=0))
    assert torch.equal(unweighted, bare)


def _states_equal(kst, pst):
    for i in range(7):
        if kst[i] is None:
            assert pst[i] is None, i
            continue
        want, got = np.asarray(kst[i]), pst[i].numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), i


@pytest.mark.parametrize("kind,seed", BATCHES)
def test_greedy_and_batched_equal(kind, seed):
    kd, kp, pd, pp = _batches(kind, seed)
    ka, kst = k_greedy(kd, kp)
    pa, pst = greedy_assign_plain(pd, pp)
    assert np.array_equal(pa.numpy(), np.asarray(ka))
    _states_equal(kst, pst)
    ka, kst = k_batched(kd, kp)
    pa, pst = batched_assign_plain(pd, pp)
    assert np.array_equal(pa.numpy(), np.asarray(ka))
    _states_equal(kst, pst)


@pytest.mark.parametrize("kind,seed", BATCHES)
def test_packing_equal(kind, seed):
    kd, kp, pd, pp = _batches(kind, seed)
    weights = KP.PackingWeights()
    lam = np.zeros(kd.alloc.shape[0], dtype=np.float32)
    ka, kst, klam, kobj, kit, knu = KP.packing_assign_device(
        kd, kp, jnp.asarray(lam), weights.tensor())
    pa, pst, plam, pobj, pit, pnu = PP.packing_assign_device(
        pd, pp, torch.from_numpy(lam), to_port(weights).tensor("cpu"), 0)
    assert np.array_equal(pa.numpy(), np.asarray(ka))
    _states_equal(kst, pst)
    assert np.array_equal(plam.numpy().view(np.int32), np.asarray(klam).view(np.int32))
    assert pit == int(kit) and int(pnu) == int(knu)
    assert float(pobj) == pytest.approx(float(kobj), rel=1e-5)


@pytest.mark.parametrize("engine", ["greedy", "batched"])
@pytest.mark.parametrize("kind,seed", BATCHES)
def test_placement_equal(kind, seed, engine):
    kd, kp, pd, pp = _batches(kind, seed)
    nc = kd.alloc.shape[0]
    n = int(np.asarray(kd.node_valid).sum())
    rng = np.random.default_rng(seed + 7)
    masks = np.zeros((4, nc), dtype=bool)
    masks[0, :n] = True
    masks[1, : n // 2] = True
    masks[2:, :n] = rng.random((2, n)) < 0.6
    ka, kc, kal = k_placement(kd, kp, jnp.asarray(masks), engine=engine)
    pa, pc, pal = placement_assign_plain(pd, pp, torch.from_numpy(masks), engine)
    assert np.array_equal(pa.numpy(), np.asarray(ka))
    assert np.array_equal(pc.numpy(), np.asarray(kc))
    assert np.array_equal(pal.numpy(), np.asarray(kal))


def test_node_valid_feeds_only_the_static_verdict_with_dra():
    """The hypothesis scan's shared start mask stays exact with the DRA
    leaf: the term reads the step's mask, never ``node_valid``."""
    kd, kp, pd, pp = _batches("mixed", 0)
    base = prt.filter_components(pd, pp)
    m = torch.zeros_like(pd.node_valid)
    m[::2] = True
    bb = dataclasses.replace(
        pd, nodes=dataclasses.replace(pd.nodes, node_valid=pd.node_valid & m))
    got = prt.filter_components(bb, pp)
    assert torch.equal(got[0], base[0] & m[None, :])


def test_kernel_wrappers_refuse_cpu_dra_batches():
    _, _, pd, pp = _batches("seeded", 0)
    for fn in (kernels.filter_score, kernels.greedy_scan, kernels.batched_assign):
        with pytest.raises(ValueError, match="CUDA"):
            fn(pd, pp)


def test_score_args_mirror_matches_the_struct():
    """The ctypes ``ScoreArgs`` lists the C struct's fields in order, each
    8 bytes (the build checks the size on the card; this checks names)."""
    src = (kernels.CSRC / "score_common.cuh").read_text()
    body = re.search(r"struct ScoreArgs \{(.*?)\n\};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        words = re.sub(r"\bconst\b", "", line.rstrip(";")).replace("*", " ").split()
        names += [n.strip() for n in " ".join(words[1:]).split(",")]
    assert [f for f, _ in kernels.ScoreArgs._fields_] == names
    assert ctypes.sizeof(kernels.ScoreArgs) == 8 * len(names)


# ---------------------------------------------------------- the schedulers

def cluster(x, nodes=2, devices=2):
    x.s.on_device_class_add(gpu_class(x.T))
    for i in range(nodes):
        x.s.on_node_add(x.W.make_node(f"n{i}", cpu_milli=8000))
        x.s.on_resource_slice_add(node_slice(x.T, f"n{i}", devices))


def claim_pod(x, j, claim=None, cpu=100):
    claim = claim or f"c{j}"
    if f"default/{claim}" not in x.s.cache.dra.claims:
        x.s.on_resource_claim_add(one_device_claim(x.T, claim))
    pod = x.W.make_pod(f"p{j}", cpu_milli=cpu, claims=[claim], creation_index=j)
    x.s.on_pod_add(pod)
    return pod


def both(scenario, profile=None, **kw):
    return _both(scenario, profile=profile or dra_profile(KC), **kw)


PIPE = [pytest.param({}, id="serial"), pytest.param({"pipeline": True}, id="pipelined")]


@pytest.mark.parametrize("kw", PIPE)
def test_scheduler_allocates_claims_end_to_end(kw):
    def scenario(x):
        cluster(x)
        for j in range(5):
            claim_pod(x, j)
        return x.run()

    side, res = both(scenario, **kw)
    assert res == 4
    assert len(side.c.claim_status) == 4
    assert sum(len(v) for v in side.s.cache.dra.allocated_devices.values()) == 4


@pytest.mark.parametrize("kw", PIPE)
def test_pod_delete_then_claim_release_requeues_waiter(kw):
    def scenario(x):
        cluster(x)
        pods = [claim_pod(x, j) for j in range(5)]
        first = x.run()
        node = x.c.bound["default/p0"]
        x.s.on_pod_delete(pods[0].with_node(node))
        released = x.s.cache.dra.claims["default/c0"]
        x.s.on_resource_claim_update(released, x.T.ResourceClaim(
            name="c0", uid="default/c0", requests=released.requests))
        x.clock.tick(31)
        return first, x.run(), "default/p4" in x.c.bound

    _, res = both(scenario, **kw)
    assert res == (4, 1, True)


def test_shared_claim_reservations():
    """Two pods racing for one shared claim: one allocates it, the other
    joins its reservedFor after its backoff."""
    def scenario(x):
        cluster(x, nodes=1, devices=1)
        claim_pod(x, 0, claim="shared")
        claim_pod(x, 1, claim="shared")
        total = x.run()
        x.clock.tick(2)
        return total + x.run()

    side, res = both(scenario)
    assert res == 2
    assert len(side.s.cache.dra.claims["default/shared"].reserved_for) == 2


def test_unreserve_keeps_shared_claim_alive_for_co_reserver():
    from kubetpu.framework.dynamicresources import DynamicResourcesPlugin as KPlugin
    from kubetpu_torch.framework.dynamicresources import DynamicResourcesPlugin as PPlugin

    def scenario(x):
        cluster(x, nodes=1, devices=1)
        x.s.on_resource_claim_add(one_device_claim(x.T, "shared"))
        plug = (PPlugin if x.port else KPlugin)()
        pa = x.W.make_pod("pa", cpu_milli=100, claims=["shared"])
        pb = x.W.make_pod("pb", cpu_milli=100, claims=["shared"])
        ok = (plug.reserve(x.s, pa, "n0").ok, plug.reserve(x.s, pb, "n0").ok)
        plug.unreserve(x.s, pa, "n0")
        return ok

    side, res = both(scenario)
    assert res == (True, True)
    claim = side.s.cache.dra.claims["default/shared"]
    assert claim.allocation is not None and claim.reserved_for == ("default/pb",)


def test_unreserve_on_bind_failure_releases_devices():
    def scenario(x):
        cluster(x, nodes=1, devices=1)
        claim_pod(x, 0)
        x.step()
        after_fail = (x.s.cache.dra.claims["default/c0"].allocation is None,
                      not x.s.cache.dra.allocated_devices)
        x.clock.tick(11)
        return after_fail, x.run()

    side, res = both(scenario, fail_binds_for=("default/p0",))
    assert res == ((True, True), 1)
    assert side.s.cache.dra.claims["default/c0"].allocation is not None
    assert side.s.metrics.bind_errors == 1


def test_pre_enqueue_gates_until_claim_exists():
    def scenario(x):
        cluster(x)
        x.s.on_pod_add(x.W.make_pod("p0", cpu_milli=100, claims=["later"]))
        gated = x.s.queue.stats()["gated"]
        first = x.run()
        x.s.on_resource_claim_add(one_device_claim(x.T, "later"))
        return gated, first, x.run()

    _, res = both(scenario)
    assert res == (1, 0, 1)


@pytest.mark.parametrize("engine", ["greedy", "batched"])
def test_in_batch_contention(engine):
    def scenario(x):
        cluster(x)
        for j in range(6):
            claim_pod(x, j)
        return x.run()

    side, res = both(scenario, engine=engine)
    assert res == 4
    assert sorted(side.c.bound.values()) == ["n0", "n0", "n1", "n1"]


@pytest.mark.parametrize("slow_on_fast", [True, False])
@pytest.mark.parametrize("engine,kw", [
    ("greedy", {}), ("greedy", {"pipeline": True}), ("batched", {}),
])
def test_prioritized_list_scenario(engine, kw, slow_on_fast):
    """8 nodes, 2 slow devices each and 1 fast one on every second node
    (which, without ``slow_on_fast``, then has no slow one); as many pods
    as devices, each with its own (fast, slow) claim, in batches of 8: the
    fast nodes go first, each fast device once, the rest take slow ones.
    Without ``slow_on_fast`` the scan puts two pods on a one-device fast
    node in a cycle, and Reserve rejects the second, which requeues and
    binds later."""
    pods = 20 if slow_on_fast else 12
    rejected = []

    def scenario(x):
        ns, classes, slices, claims, pods_ = prio_objects(
            x.T, x.W, pods=pods, slow_on_fast=slow_on_fast)
        if x.port:
            reject = x.s._reject_assumed
            x.s._reject_assumed = lambda info, a, st: (
                rejected.append((info.key, st.plugin)), reject(info, a, st))
        for c in classes:
            x.s.on_device_class_add(c)
        for n in ns:
            x.s.on_node_add(n)
        for s in slices:
            x.s.on_resource_slice_add(s)
        for c, p in zip(claims, pods_):
            x.s.on_resource_claim_add(c)
            x.s.on_pod_add(p)
        total = x.run()
        x.clock.tick(31)
        return total + x.run()

    side, res = both(scenario, engine=engine, max_batch=8, **kw)
    assert res == pods
    fast = [r for c in side.s.cache.dra.claims.values() if c.allocation
            for r in c.allocation.results if r.request.endswith("/fast")]
    assert len(fast) == len({(r.pool, r.device) for r in fast}) == 4
    assert bool(rejected) == (not slow_on_fast)
    assert all(plugin == "DynamicResources" for _, plugin in rejected)


# --------------------------------------------------------------- the runner

@pytest.mark.parametrize("engine,pipeline", [
    ("greedy", False), ("greedy", True), ("batched", False),
])
def test_claim_template_workload_equal_reference(engine, pipeline):
    """SchedulingWithResourceClaimTemplate/fast: the port's run_workload
    binds what kubetpu's Scheduler binds driven through the case's ops
    (serial and pipelined), and every claim's status is written once by
    PreBind."""
    tc = KW.TEST_CASES["SchedulingWithResourceClaimTemplate"]
    params = next(w for w in tc.workloads if w.name == "fast").params
    client = KClient()
    sched = KScheduler(client, profile=KC.Profile(), dispatcher_workers=0,
                       engine=engine, pipeline=pipeline,
                       feature_gates=dict(tc.feature_gates))
    client.sched = sched
    for i in range(params["nodesWithoutDRA"]):
        sched.on_node_add(KW.node_default(i))
    names = []
    for i in range(params["nodesWithDRA"]):
        n = KW.node_with_dra(i)
        names.append(n.name)
        sched.on_node_add(n)
    sched.on_device_class_add(KT.DeviceClass(
        name="test-class",
        selectors=(KT.CELSelector(f'device.driver == "{DRIVER}"'),)))
    for name in names:
        sched.on_resource_slice_add(KT.ResourceSlice(
            name=f"slice-{name}", driver=DRIVER, pool=name, node_name=name,
            devices=tuple(KT.Device(name=f"device-{d}")
                          for d in range(params["maxClaimsPerNode"]))))
    for op_i, (count, ns) in ((3, (params["initPods"], "init")),
                              (4, (params["measurePods"], "test"))):
        for j in range(count):
            name = f"drapod-{op_i}-{j}"
            sched.on_resource_claim_add(KT.ResourceClaim(
                name=f"{name}-claim", namespace=ns, uid=f"{ns}/{name}-claim",
                requests=(KT.DeviceRequest(name="req-0",
                                           device_class_name="test-class"),)))
            sched.on_pod_add(KWR.make_pod(name, namespace=ns,
                                          claims=(f"{name}-claim",)))
        for _ in range(10):
            sched.schedule_batch()
            sched.dispatcher.sync()
            client.deliver()
        sched.run_until_idle()
        client.deliver()
    want = dict(client.bound)
    want_claims = {k: to_port(c.allocation) for k, c in sched.cache.dra.claims.items()}

    captured = {}
    res = run_workload("SchedulingWithResourceClaimTemplate", "fast",
                       device="cpu", engine=engine, pipeline=pipeline,
                       on_scheduler=lambda s: captured.update(s=s))
    s = captured["s"]
    assert res.scheduled == res.measure_pods == 10
    assert dict(s.client.bound) == want
    assert {k: c.allocation for k, c in s.cache.dra.claims.items()} == want_claims
    assert sorted(c.key for c in s.client.claim_status) == sorted(want_claims)
    assert "dra/pool0" in s._prev_nt.resource_names
