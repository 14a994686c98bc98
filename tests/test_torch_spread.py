"""The port's PodTopologySpread equals kubetpu's, bit for bit.

Modelled on ``tests/test_spread.py``. Seeded small clusters (at most 40
nodes and 32 pending pods), each built to exercise one part of the plugin —
a random mix of hard and soft zone and hostname constraints, hostname
signatures alone, a zone key missing on some nodes (soft-ignored nodes, and
a key no node carries), ``minDomains`` above the zone count, the Honor
inclusion policies, and pods with no constraints of their own that a
Service selects (the profile's default constraints) — are encoded by kubetpu
and carried across as numpy leaves. On each, the port's ``_domain_sums``,
``spread_filter_pod`` and ``spread_score_pod`` (the pod axis written out)
equal kubetpu's per-signature / per-pod functions vmapped, on the batch's
own counts and on seeded random counts and masks; ``feasible_and_scores``
with the ``spread`` leaf equals kubetpu's ``filter_score_batch`` under three
profiles; the plain greedy engine equals kubetpu's ``greedy_assign_device``
in its assignments and all seven state slots (``spread_counts`` included),
over the share of hard constraints; the plain batched engine equals
kubetpu's ``batched_assign_device`` under round caps of 1, 2 and none; the
port's own encoder gives kubetpu's leaves; and the three topology-spreading
workloads at small size bind what kubetpu's Scheduler binds. Tolerance:
exact (bool masks, int32 counts, int64 sums and scores).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubetpu  # noqa: F401
from kubetpu.api import types as kt
from kubetpu.api.wrappers import make_node, make_pod, spread_constraint
from kubetpu.assign.batched import batched_assign_device as k_batched
from kubetpu.assign.greedy import greedy_assign_device as k_greedy
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.ops import spread as KSP
from kubetpu.perf import workloads as KW
from kubetpu.perf.runner import _Client as KClient
from kubetpu.sched.scheduler import Scheduler as KScheduler
from kubetpu.state.snapshot import Cache

from kubetpu_torch import kernels
from kubetpu_torch.assign.batched import batched_assign_device, batched_assign_plain
from kubetpu_torch.assign.greedy import greedy_assign_device, greedy_assign_plain
from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.ops import spread as PSP
from kubetpu_torch.perf import run_workload
from kubetpu_torch.perf import workloads as PW

from .cluster_gen import random_cluster
from .test_spread import add_spread_pods, spread_profile
from .torch_port_util import encoded_pair, port_cache, to_port

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
HARD = kt.UnsatisfiableConstraintAction.DO_NOT_SCHEDULE
SOFT = kt.UnsatisfiableConstraintAction.SCHEDULE_ANYWAY


def _cluster(rng, n_nodes=24, zones=3, zone_missing=0.0, taint_share=0.0,
             existing=16):
    """Nodes in ``zones`` zones (a share without the zone label, a share
    with a NoSchedule taint), and ``existing`` pods of three apps bound at
    random."""
    cache = Cache()
    nodes = []
    for i in range(n_nodes):
        labels = {HOST: f"n{i}"}
        if rng.random() >= zone_missing:
            labels[ZONE] = f"z{i % zones}"
        if rng.random() < 0.4:
            labels["disktype"] = "ssd"
        taints = ()
        if rng.random() < taint_share:
            taints = (kt.Taint(key="dedicated", value="gpu",
                               effect=kt.TaintEffect.NO_SCHEDULE),)
        node = make_node(f"n{i}", cpu_milli=int(rng.integers(2000, 8001)),
                         memory=int(rng.integers(4, 32)) * 1024**3, pods=20,
                         labels=labels, taints=taints)
        nodes.append(node)
        cache.add_node(node)
    for j in range(existing):
        node = nodes[int(rng.integers(0, n_nodes))]
        cache.add_pod(make_pod(f"e{j}", cpu_milli=100,
                               labels={"app": str(rng.choice(["web", "db", "cache"]))},
                               node_name=node.name))
    return cache


def _pending(rng, n, constraints, **kw):
    """``n`` pending pods; ``constraints(app)`` gives each its tuple."""
    out = []
    for j in range(n):
        app = str(rng.choice(["web", "db", "cache"]))
        out.append(make_pod(f"p{j}", cpu_milli=int(rng.integers(100, 1500)),
                            memory=int(rng.integers(0, 4)) * 512 * 1024**2,
                            labels={"app": app}, spread=constraints(app),
                            creation_index=j, **kw))
    return out


def _c(rng, key, app, hard=None, min_domains=None):
    when = HARD if (rng.random() < 0.5 if hard is None else hard) else SOFT
    return spread_constraint(int(rng.integers(1, 4)), key, when=when,
                             match_labels={"app": app}, min_domains=min_domains)


def case_mixed(rng, hard_ratio=0.5):
    cache, pending = random_cluster(rng, num_nodes=24, num_existing=50, num_pending=20)
    return cache, add_spread_pods(rng, pending, hard_ratio=hard_ratio)


def case_hostname(rng):
    cache = _cluster(rng, n_nodes=20, existing=24)
    return cache, _pending(rng, 24, lambda app: (_c(rng, HOST, app),))


def case_missing_key(rng):
    """The zone label missing on a third of the nodes (hard: infeasible
    there; soft: ignored there), and a key no node carries."""
    cache = _cluster(rng, zone_missing=0.35)

    def cons(app):
        if rng.random() < 0.2:
            return (_c(rng, "example.com/rack", app),)
        return (_c(rng, ZONE, app), _c(rng, HOST, app, hard=False))

    return cache, _pending(rng, 24, cons)


def case_min_domains(rng):
    """minDomains above the three zones (minMatch reads 0) and below."""
    cache = _cluster(rng, existing=30)
    return cache, _pending(rng, 24, lambda app: (
        _c(rng, ZONE, app, hard=True, min_domains=int(rng.choice([1, 2, 4, 5]))),))


def case_policies(rng):
    """Node selectors and tolerations under the Honor inclusion policies."""
    cache = _cluster(rng, taint_share=0.3)

    def cons(app):
        c = _c(rng, ZONE, app)
        return (dataclasses.replace(
            c, node_taints_policy=str(rng.choice(["Honor", "Ignore"])),
            node_affinity_policy=str(rng.choice(["Honor", "Ignore"]))),)

    pending = _pending(rng, 24, cons, node_selector={"disktype": "ssd"})
    tol = kt.Toleration(key="dedicated", operator=kt.TolerationOperator.EQUAL,
                        value="gpu", effect=None)
    return cache, [dataclasses.replace(p, tolerations=(tol,)) if j % 2 else p
                   for j, p in enumerate(pending)]


def case_service(rng):
    """No pod has constraints; a Service selects app=web, so web pods take
    the profile's default zone and hostname constraints."""
    cache = _cluster(rng, existing=30)
    cache.add_service(kt.Service(name="web", namespace="default",
                                 selector=(("app", "web"),)))
    return cache, _pending(rng, 24, lambda app: ())


CASES = {
    "mixed": case_mixed,
    "hostname": case_hostname,
    "missing-key": case_missing_key,
    "min-domains": case_min_domains,
    "policies": case_policies,
    "service": case_service,
}
PROFILES = {
    "default": KC.Profile,
    "spread": spread_profile,
    "filter-only": lambda: spread_profile(with_score=False),
}
# the Service case gets constraints only from the default profile's defaults
CASE_PROFILES = [(c, p) for c in sorted(CASES) for p in sorted(PROFILES)
                 if c != "service" or p == "default"]


def _pair(case, seed, profile="default"):
    cache, pending = CASES[case](np.random.default_rng(seed))
    kb, kp, pb, pp = encoded_pair(cache, pending, PROFILES[profile]())
    assert kb.spread is not None and pb.spread is not None
    return kb, kp, pb, pp


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    g = got.numpy()
    assert g.dtype == want.dtype and g.shape == want.shape
    assert np.array_equal(g, want)


def _k_ops(sp, counts, mask=None):
    """kubetpu's per-pod spread functions vmapped over the pods."""
    ok = jax.vmap(lambda si, ac, ms, md, sm: KSP.spread_filter_pod(
        sp, counts, si, ac, ms, md, sm))(
        sp.sig_idx, sp.action, sp.max_skew, sp.min_domains, sp.self_match)
    m = ok if mask is None else jnp.asarray(mask)
    sc = jax.vmap(lambda si, ac, ms, ig, mm: KSP.spread_score_pod(
        sp, counts, si, ac, ms, ig, mm))(
        sp.sig_idx, sp.action, sp.max_skew, sp.ignored, m)
    return ok, sc


def _p_ops(sp, counts, mask=None):
    ok = PSP.spread_filter_pod(sp, counts, sp.sig_idx, sp.action, sp.max_skew,
                               sp.min_domains, sp.self_match)
    m = ok if mask is None else torch.from_numpy(np.asarray(mask))
    return ok, PSP.spread_score_pod(sp, counts, sp.sig_idx, sp.action,
                                    sp.max_skew, sp.ignored, m)


@pytest.mark.parametrize("case", sorted(CASES))
def test_domain_sums_equal_segment_sums(case):
    kb, _, pb, _ = _pair(case, 51)
    ks, ps = kb.spread, pb.spread
    d = ks.domain_present.shape[1]
    want = jax.vmap(lambda c, e, nd: KSP._domain_sums(c, e, nd, d))(
        ks.node_count, ks.eligible, ks.node_domain)
    got = PSP._domain_sums(ps.node_count, ps.eligible, ps.node_domain, d)
    assert got.dtype == torch.int64 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("case", sorted(CASES))
def test_spread_ops_on_base_counts(case):
    kb, _, pb, _ = _pair(case, 52)
    kok, ksc = _k_ops(kb.spread, kb.spread.node_count)
    pok, psc = _p_ops(pb.spread, pb.spread.node_count)
    _eq(pok, kok)
    _eq(psc, ksc)


@pytest.mark.parametrize("case", sorted(CASES))
def test_spread_ops_on_random_counts_and_mask(case):
    """Seeded counts (on ineligible nodes too: the hostname score reads the
    node's own count ungated) and a seeded feasibility mask (an empty row
    included)."""
    kb, _, pb, _ = _pair(case, 53)
    rng = np.random.default_rng(54)
    shape = kb.spread.node_count.shape
    counts = rng.integers(0, 5, size=shape).astype(np.int32)
    mask = rng.random((kb.requests.shape[0], kb.alloc.shape[0])) < 0.7
    mask[0] = False
    kok, ksc = _k_ops(kb.spread, jnp.asarray(counts), mask)
    pok, psc = _p_ops(pb.spread, torch.from_numpy(counts), mask)
    _eq(pok, kok)
    _eq(psc, ksc)


@pytest.mark.parametrize("case,profile", CASE_PROFILES)
def test_feasible_and_scores_with_spread(case, profile):
    kb, kp, pb, pp = _pair(case, 55, profile)
    km, ks = krt.filter_score_batch(kb, kp)
    pm, ps = prt.feasible_and_scores(pb, pp)
    _eq(pm, km)
    _eq(ps, ks)
    # filter_score_batch is the same function on a CPU batch
    fm, fs = prt.filter_score_batch(pb, pp)
    assert torch.equal(fm, pm) and torch.equal(fs, ps)


def _greedy_same(kb, kp, pb, pp):
    ka, kst = k_greedy(kb, kp)
    pa, pst = greedy_assign_plain(pb, pp)
    _eq(pa, ka)
    for i in (0, 1, 2, 3, 4):
        _eq(pst[i], kst[i])
    assert pst[4].dtype == torch.int32
    assert kst[5] is None and pst[5] is None and kst[6] is None and pst[6] is None
    da, dst = greedy_assign_device(pb, pp)
    assert torch.equal(da, pa) and torch.equal(dst[4], pst[4])
    return pa, pst


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("hard_ratio", [1.0, 0.4, 0.0])
def test_greedy_all_state_slots_over_hard_share(hard_ratio, seed):
    """In-batch assignments move the spread counts exactly as kubetpu's
    scan does, whatever the share of hard constraints."""
    cache, pending = case_mixed(np.random.default_rng(56 + seed), hard_ratio)
    pa, pst = _greedy_same(*encoded_pair(cache, pending, spread_profile()))
    assert (pa[: len(pending)] >= 0).any()


@pytest.mark.parametrize("case,profile", [
    (c, p) for c, p in CASE_PROFILES if c != "mixed" and p != "filter-only"
])
def test_greedy_all_state_slots(case, profile):
    _greedy_same(*_pair(case, 57, profile))


@pytest.mark.parametrize("max_rounds", [1, 2, 0])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_assignments_rounds_and_state(case, max_rounds):
    """The batched engine, round for round: under a cap of one and two
    rounds and uncapped, the port's assignments and seven state slots equal
    kubetpu's."""
    kb, kp, pb, pp = _pair(case, 58)
    ka, kst = k_batched(kb, kp, max_rounds=max_rounds)
    rounds = []
    pa, pst = batched_assign_plain(pb, pp, max_rounds=max_rounds, rounds_out=rounds)
    _eq(pa, ka)
    for i in (0, 1, 2, 3, 4):
        _eq(pst[i], kst[i])
    assert kst[5] is None and pst[5] is None
    assert 1 <= rounds[0] <= (max_rounds or pb.requests.shape[0])
    da, _ = batched_assign_device(pb, pp, max_rounds=max_rounds)
    assert torch.equal(da, pa)


def test_hard_zone_spread_round_robins():
    """maxSkew=1 on zone: after every assignment of the scan the zone
    counts differ by at most one, on the port as on kubetpu."""
    cache = Cache()
    for i in range(6):
        cache.add_node(make_node(f"n{i}", cpu_milli=100000,
                                 labels={HOST: f"n{i}", ZONE: f"z{i % 3}"}))
    pods = [make_pod(f"p{i}", cpu_milli=100, labels={"app": "web"},
                     spread=[spread_constraint(1, ZONE, when=HARD,
                                               match_labels={"app": "web"})])
            for i in range(9)]
    kb, kp, pb, pp = encoded_pair(cache, pods, spread_profile())
    pa, _ = _greedy_same(kb, kp, pb, pp)
    counts = [0, 0, 0]
    for j in pa[:9].tolist():
        assert j >= 0
        counts[j % 3] += 1
        assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_encoder_gives_kubetpu_leaves(case):
    """The port's own encode (its copy of state/spread, the shared template
    groups and the Service feed) gives the spread leaves kubetpu's gives,
    in the one upload."""
    cache, pending = CASES[case](np.random.default_rng(59))
    kb = krt.encode_batch(cache.update_snapshot(), pending, KC.Profile())
    pb = prt.encode_batch(port_cache(cache).update_snapshot(),
                          [to_port(p) for p in pending], to_port(KC.Profile()),
                          device="cpu")
    ksp = jax.device_get(kb.device.spread)
    psp = pb.device.spread
    for f in prt.SP_FIELDS:
        _eq(getattr(psp, f), getattr(ksp, f))
    assert psp.has_hard == ksp.has_hard and psp.has_soft == ksp.has_soft
    leaves = [v for v in prt.batch_leaves(pb.device).values()
              if isinstance(v, torch.Tensor)]
    leaves += [getattr(psp, f) for f in prt.SP_FIELDS]
    assert len({v.untyped_storage().data_ptr() for v in leaves}) == 1
    assert pb.upload_bytes == sum(int(v.nbytes) for v in leaves)


def test_spread_inputs_no_longer_refused():
    """Pods with constraints and Services that select pods encode: no
    NotImplementedError, and no spread leaf without constraints."""
    cache, pending = case_service(np.random.default_rng(60))
    pc = port_cache(cache)
    pods = [to_port(p) for p in pending]
    b = prt.encode_batch(pc.update_snapshot(), pods, to_port(KC.Profile()),
                         device="cpu")
    assert b.device.spread is not None and b.device.spread.has_soft
    assert "spread" in prt.NESTED
    plain = prt.encode_batch(pc.update_snapshot(), pods,
                             to_port(spread_profile()), device="cpu")
    assert plain.device.spread is None


def test_kernel_wrappers_refuse_cpu_spread_batches():
    """The wrappers launch or raise; they never run the plain version."""
    _, _, pb, pp = _pair("mixed", 61)
    for fn in (kernels.filter_score, kernels.greedy_scan, kernels.batched_assign):
        with pytest.raises(ValueError, match="CUDA"):
            fn(pb, pp)


def test_pod_view_narrows_spread_slots():
    from kubetpu_torch.assign.greedy import _pod_view

    _, _, pb, _ = _pair("mixed", 62)
    v = _pod_view(pb, 3)
    sp, vs = pb.spread, v.spread
    for f in ("sig_idx", "action", "max_skew", "min_domains", "self_match",
              "pod_match_sig", "ignored"):
        assert torch.equal(getattr(vs, f), getattr(sp, f)[3:4])
    for f in ("eligible", "node_domain", "node_count", "has_key",
              "domain_present", "num_domains", "is_hostname"):
        assert getattr(vs, f) is getattr(sp, f)


def test_service_delete_stops_default_constraints():
    """Service add and delete events reach the encode: while a Service
    selects foo=bar in service-ns, the default profile gives those pods its
    default zone and hostname constraints (a spread leaf); after the
    Service's delete event they get none. kubetpu's Scheduler and the
    port's, driven through the same events (nodes over three zones, the
    Service, a batch of labelled pods, the delete, a second batch), bind
    the same pods to the same nodes."""
    from kubetpu_torch.framework import config as PC
    from kubetpu_torch.perf.runner import _Client as PClient
    from kubetpu_torch.sched import Scheduler as PScheduler

    ks_client = KClient()
    ks = KScheduler(ks_client, profile=KC.Profile(), max_batch=16, engine="greedy",
                    pipeline=False, dispatcher_workers=0, flight_recorder=False)
    ks_client.sched = ks
    ps_client = PClient()
    ps = PScheduler(ps_client, profile=PC.Profile(), max_batch=16, device="cpu")
    ps_client.sched = ps
    zones = ("moon-1", "moon-2", "moon-3")
    svc = kt.Service(name="svc", namespace="service-ns", selector=(("foo", "bar"),))
    probe = to_port(KW.pod_with_label("probe", "service-ns"))

    def spread_leaf():
        b = prt.encode_batch(ps.cache.update_snapshot(), [probe], PC.Profile(),
                             device="cpu")
        return b.device.spread

    def both(fn):
        fn(ks, lambda x: x)
        fn(ps, to_port)

    for i in range(9):
        both(lambda s, conv: s.on_node_add(conv(KW.node_default(i, zones))))
    for j in range(10):   # uneven load: the first nodes of the first zone
        both(lambda s, conv: s.on_pod_add(conv(
            KW.pod_default(f"init-{j}", "default").with_node(f"scheduler-perf-{j % 2}"))))
    assert spread_leaf() is None
    both(lambda s, conv: s.on_service_add(conv(svc)))
    assert spread_leaf() is not None and spread_leaf().has_soft
    for batch in ("a", "b"):
        for j in range(12):
            both(lambda s, conv: s.on_pod_add(conv(
                KW.pod_with_label(f"{batch}-{j}", "service-ns"))))
        for s, client in ((ks, ks_client), (ps, ps_client)):
            for _ in range(3):
                s.schedule_batch()
                client.deliver()
        if batch == "a":
            both(lambda s, conv: s.on_service_delete(conv(svc)))
            assert spread_leaf() is None
    ks.close()
    assert len(ps_client.bound) == 24
    assert dict(ps_client.bound) == dict(ks_client.bound)


SMALL = {"initNodes": 30, "initPods": 60, "measurePods": 90}


@pytest.mark.parametrize("case,engine", [
    ("TopologySpreading", "batched"),
    ("PreferredTopologySpreading", "greedy"),
    ("DefaultTopologySpreading", "greedy"),
])
def test_spread_workload_bound_map_equal(case, engine):
    """A small run of each topology-spreading case (30 nodes over three
    zones, 60 init and 90 measured pods, batches of 32): the port's
    run_workload binds exactly what kubetpu's Scheduler binds, driven
    through the same op sequence (the Service op included)."""
    client = KClient()
    sched = KScheduler(client, profile=KC.Profile(), max_batch=32, engine=engine,
                       pipeline=False, dispatcher_workers=0, flight_recorder=False)
    client.sched = sched
    tc = KW.TEST_CASES[case]
    ns_counter = 0
    for op_i, op in enumerate(tc.ops):
        if isinstance(op, KW.CreateNodesOp):
            for i in range(SMALL[op.count_param]):
                sched.on_node_add(KW.node_default(i, op.zones))
        elif isinstance(op, KW.CreateServiceOp):
            sched.on_service_add(kt.Service(name=op.name, namespace=op.namespace,
                                            selector=op.selector))
        else:
            count = SMALL[op.count_param]
            template = op.template or tc.default_pod_template
            ns = op.namespace or f"namespace-{ns_counter}"
            ns_counter += 1
            prefix = f"{'measure' if op.collect_metrics else 'init'}-{op_i}"
            for j in range(count):
                sched.on_pod_add(template(f"{prefix}-{ns}-{j}", ns))
            for _ in range(50):
                if client.bound_by_ns[ns] >= count:
                    break
                sched.schedule_batch()
                client.deliver()
    sched.close()
    want = dict(client.bound)
    assert len(want) == 150

    captured = {}
    res = run_workload(case, PW.Workload("small", SMALL), device="cpu",
                       engine=engine, max_batch=32,
                       on_scheduler=lambda s: captured.update(s=s))
    assert res.scheduled == res.measure_pods == 90
    assert res.bound_total == 150 and res.engine == engine
    assert dict(captured["s"].client.bound) == want
