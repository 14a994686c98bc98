"""The port's preemption equals kubetpu's, bit for bit.

- The plain dry run (kernel B9's plain version) against kubetpu's
  ``dry_run_preemption`` on seeded victim tensors: K in {4, 8, 128} slots, D
  in {1, 5} PDBs, host ports, many equal (priority, start) pairs (the sorts
  must keep slot order), an empty potential mask and a case with no
  candidate. Node index, victims, ok and n_pdb must be equal. The same for
  ``dry_run_preemption_ranked_plain``, the mirror of the kernel's
  decomposition, at K in {4, 8, 128, 130}, with ineligible slots between
  eligible ones and blocks of 1, 3 and 8 nodes.
- ``PreemptionEvaluator.preempt`` against kubetpu's on the scenarios of
  ``tests/test_preemption.py`` (each batch encoded by each side's own
  encoder): status, node, victim uids and victim pods, call after call.
- ``Scheduler(device="cpu")`` with preemption on against kubetpu's
  ``Scheduler(dispatcher_workers=0)`` on a preempt-then-schedule cluster
  under a stepped fake clock: bound maps, victims and nominations, serial,
  pipelined and on the batched engine; and ``PreemptionAsync/5Nodes``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubetpu  # noqa: F401
from kubetpu.api import types as kt
from kubetpu.api.wrappers import make_node, make_pod
from kubetpu.assign.greedy import greedy_assign_device as k_greedy
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.framework.preemption import PreemptionEvaluator as KEvaluator
from kubetpu.ops import preemption as KO
from kubetpu.queue.nominator import Nominator
from kubetpu.state.snapshot import Cache

from kubetpu_torch.assign.greedy import greedy_assign_plain
from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.framework.preemption import PreemptionEvaluator as PEvaluator
from kubetpu_torch.framework.preemption import extender_chain_hook
from kubetpu_torch.ops import preemption as PO

from .torch_port_util import FakeClock, port_cache, to_port

PROFILE = KC.Profile(
    filters=KC.PluginSet(enabled=(
        (KC.NODE_UNSCHEDULABLE, 1), (KC.NODE_NAME, 1),
        (KC.TAINT_TOLERATION, 1), (KC.NODE_AFFINITY, 1),
        (KC.NODE_PORTS, 1), (KC.NODE_RESOURCES_FIT, 1),
    )),
    scores=KC.PluginSet(enabled=((KC.NODE_RESOURCES_FIT, 1),)),
    default_spread_constraints=(),
)

# ---------------------------------------------------------------- dry run


def victim_tensors(seed, N, K, D, R=3, Kp=4, pod_prio=25, potential=0.8):
    """Seeded arguments of dry_run_preemption (numpy, kubetpu's dtypes).
    Priorities and start times come from small sets, so equal (priority,
    start) pairs are common."""
    rng = np.random.default_rng(seed)
    v_valid = rng.random((N, K)) < 0.8
    v_prio = (rng.integers(0, 4, (N, K)) * 10).astype(np.int64)
    v_start = rng.integers(0, 3, (N, K)).astype(np.int64)
    v_req = (rng.integers(0, 400, (N, K, R)) * v_valid[:, :, None]).astype(np.int64)
    # about one holder of each triple a node, whatever K: a triple the
    # preemptor wants that a higher-priority pod holds leaves no candidate
    v_ports = ((rng.random((N, K, Kp)) < min(0.15, 1.0 / K))
               & v_valid[:, :, None]).astype(np.int8)
    v_pdb = (rng.random((N, K, D)) < 0.3) & v_valid[:, :, None]
    requested = v_req.sum(1) + rng.integers(0, 100, (N, R))
    alloc = requested + rng.integers(0, 300, (N, R))
    pod_count = (v_valid.sum(1) + rng.integers(0, 2, N)).astype(np.int32)
    allowed = (pod_count + rng.integers(0, 3, N)).astype(np.int32)
    port_counts = (v_ports.sum(1) + (rng.random((N, Kp)) < 0.1)).astype(np.int32)
    pdb_allowed = rng.integers(0, 3, D).astype(np.int64)
    pod_req = rng.integers(0, 700, R).astype(np.int64)
    wants = rng.random(Kp) < 0.3
    pot = rng.random(N) < potential
    return (pod_req, pod_prio, wants, pot, alloc, requested, pod_count,
            allowed, port_counts, v_valid, v_prio, v_start, v_req, v_ports,
            v_pdb, pdb_allowed)


def _dry_run_both(args):
    want = KO.dry_run_preemption(*(
        jnp.asarray(np.int64(a)) if isinstance(a, int) else jnp.asarray(a)
        for a in args
    ))
    got = PO.dry_run_preemption(*(
        a if isinstance(a, int) else torch.from_numpy(a) for a in args
    ))
    for name, w, g in zip(("node", "victims", "ok", "n_pdb"), want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name
    return got


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("D", [1, 5])
@pytest.mark.parametrize("K", [4, 8, 128])
def test_dry_run_matches_kubetpu(K, D, seed):
    N = 48 if K < 128 else 16
    node, victims, ok, _ = _dry_run_both(victim_tensors(seed, N, K, D))
    if int(node) >= 0:
        assert ok[int(node)] and victims[int(node)].any()


@pytest.mark.parametrize("K", [8, 128])
def test_dry_run_finds_candidates(K):
    """The seeded tensors do exercise the search: across seeds most runs
    pick a node, among several candidates, with victims."""
    picked = 0
    for seed in range(4):
        node, victims, ok, n_pdb = _dry_run_both(victim_tensors(seed, 32, K, 5))
        if int(node) >= 0:
            picked += 1
            assert int(ok.sum()) > 1 and victims[int(node)].any()
    assert picked >= 3


def test_dry_run_empty_potential_mask():
    node, _, ok, _ = _dry_run_both(victim_tensors(3, 32, 8, 1, potential=0.0))
    assert int(node) == -1 and not ok.any()


def test_dry_run_no_lower_priority_victim():
    node, victims, ok, _ = _dry_run_both(victim_tensors(4, 32, 8, 5, pod_prio=0))
    assert int(node) == -1 and not ok.any() and not victims.any()


def test_dry_run_equal_keys_keep_slot_order():
    """All victims equal in (priority, start): which one is reprieved, and
    which violates the PDB, follows slot order, as the stable sort does."""
    N, K, D = 4, 8, 1
    args = list(victim_tensors(0, N, K, D))
    args[9] = np.ones((N, K), dtype=bool)                          # valid
    args[10] = np.zeros((N, K), dtype=np.int64)                    # priority
    args[11] = np.zeros((N, K), dtype=np.int64)                    # start
    args[12] = np.full((N, K, 3), 100, dtype=np.int64)             # requests
    args[4] = np.full((N, 3), 1000, dtype=np.int64)                # alloc
    args[5] = args[12].sum(1) + 50                                 # requested
    args[5] = np.minimum(args[5], 1000)
    args[0] = np.array([400, 400, 400], dtype=np.int64)
    args[14] = np.ones((N, K, D), dtype=bool)                      # pdb
    args[15] = np.array([2], dtype=np.int64)
    args[3] = np.ones(N, dtype=bool)
    args[2] = np.zeros(4, dtype=bool)
    args[6] = np.full(N, K, dtype=np.int32)
    args[7] = np.full(N, 110, dtype=np.int32)
    node, victims, ok, n_pdb = _dry_run_both(tuple(args))
    assert int(node) == 0 and victims.any()


def _ranked_both(args, nodes_per_block):
    """kubetpu's dry run against the port's mirror of the kernel's
    decomposition (``dry_run_preemption_ranked_plain``): equal outputs."""
    want = KO.dry_run_preemption(*(
        jnp.asarray(np.int64(a)) if isinstance(a, int) else jnp.asarray(a)
        for a in args
    ))
    got = PO.dry_run_preemption_ranked_plain(
        *(a if isinstance(a, int) else torch.from_numpy(a) for a in args),
        nodes_per_block=nodes_per_block)
    for name, w, g in zip(("node", "victims", "ok", "n_pdb"), want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name
    return got


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("D", [1, 5])
@pytest.mark.parametrize("K", [4, 8, 128, 130])
def test_ranked_dry_run_matches_kubetpu(K, D, seed):
    """The kernel's decomposition (ranks by counting, PDB prefix counts,
    the reprieve order by counting and its walk, a best a block then the
    merge) equals kubetpu, blocks of 1, 3 and 8 nodes."""
    N = 48 if K < 128 else 16
    node, victims, ok, _ = _ranked_both(victim_tensors(seed, N, K, D), (1, 3, 8)[seed])
    if int(node) >= 0:
        assert ok[int(node)] and victims[int(node)].any()


def _equal_keys(K, D):
    """Four nodes whose victims are all equal in (priority, start) and
    requests, every one in every PDB: slot order decides which are
    reprieved and which violate."""
    N = 4
    args = list(victim_tensors(0, N, K, D))
    args[9] = np.ones((N, K), dtype=bool)                          # valid
    args[10] = np.zeros((N, K), dtype=np.int64)                    # priority
    args[11] = np.zeros((N, K), dtype=np.int64)                    # start
    args[12] = np.full((N, K, 3), 100, dtype=np.int64)             # requests
    args[4] = np.full((N, 3), 1000, dtype=np.int64)                # alloc
    args[5] = np.minimum(args[12].sum(1) + 50, 1000)               # requested
    args[0] = np.array([400, 400, 400], dtype=np.int64)
    args[14] = np.ones((N, K, D), dtype=bool)                      # pdb
    args[15] = np.full(D, 2, dtype=np.int64)
    args[3] = np.ones(N, dtype=bool)
    args[2] = np.zeros(4, dtype=bool)
    args[6] = np.full(N, K, dtype=np.int32)
    args[7] = np.full(N, 110 + K, dtype=np.int32)
    return tuple(args)


@pytest.mark.parametrize("K", [8, 130])
def test_ranked_dry_run_equal_keys(K):
    node, victims, _, n_pdb = _ranked_both(_equal_keys(K, 1), 3)
    assert int(node) == 0 and victims.any() and int(n_pdb.max()) > 0


@pytest.mark.parametrize("K", [8, 128])
def test_ranked_dry_run_ineligible_between_eligible(K):
    """Every second slot above the preemptor's priority (never a victim,
    ordered last) or not valid, the others eligible, with equal keys among
    them."""
    args = list(victim_tensors(5, 24, K, 5))
    odd = np.arange(K) % 2 == 1
    args[10] = np.where(odd[None, :] & (np.arange(24) % 2 == 0)[:, None], 40, args[10] % 20)
    args[9] = args[9] | ~odd[None, :]
    args[9][1::2, 1::2] = False
    node, victims, _, _ = _ranked_both(tuple(args), 8)
    assert not victims.numpy()[:, odd].any()
    assert int(node) >= 0


def test_ranked_dry_run_empty_potential_mask():
    args = list(victim_tensors(3, 32, 8, 1))
    args[3] = np.zeros(32, dtype=bool)
    node, _, ok, _ = _ranked_both(tuple(args), 8)
    assert int(node) == -1 and not ok.any()


def test_ranked_dry_run_no_ok_node():
    node, victims, ok, _ = _ranked_both(victim_tensors(4, 32, 8, 5, pod_prio=0), 3)
    assert int(node) == -1 and not ok.any() and not victims.any()


def test_gang_dry_run_is_a_later_slice():
    """The gang dry run (B13) was a later slice; it has landed with the
    gang lane, so on CPU tensors it runs its plain version and equals
    kubetpu's (tests/test_torch_gang_preemption.py holds it on seeded
    sliced clusters)."""
    from .torch_port_util import basic_cluster, encoded_pair

    cache, pending = basic_cluster(num_nodes=12, num_bound=20, num_pending=6)
    kb, kp, pb, pp = encoded_pair(cache, pending, KC.Profile())
    n, r = pb.alloc.shape
    masks = np.zeros((2, n), dtype=bool)
    masks[0, :6] = True
    masks[1, 6:12] = True
    fr = np.zeros((2, n, r), dtype=np.int64)
    fr[1, 6:9] = 10**6                        # more than held: clamps at 0
    fc = np.zeros((2, n), dtype=np.int32)
    fc[1, 6:9] = 3
    want = KO.dry_run_gang_preemption(kb, kp, jnp.asarray(masks), jnp.asarray(fr),
                                      jnp.asarray(fc))
    got = PO.dry_run_gang_preemption(pb, pp, torch.from_numpy(masks),
                                     torch.from_numpy(fr), torch.from_numpy(fc))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


# -------------------------------------------------------------- evaluator


def _nodes(cache, n, cpu=1000, mem=2**30, **kw):
    for i in range(n):
        cache.add_node(make_node(f"n{i}", cpu_milli=cpu, memory=mem, **kw))


def sc_basic():
    cache = Cache()
    _nodes(cache, 4)
    for i in range(4):
        cache.add_pod(make_pod(f"low-{i}", cpu_milli=900, priority=0,
                               node_name=f"n{i}", creation_index=i))
    return cache, [make_pod("high", cpu_milli=800, priority=100)], {}


def sc_reprieve():
    cache = Cache()
    _nodes(cache, 1)
    cache.add_pod(make_pod("a", cpu_milli=400, priority=0, node_name="n0",
                           creation_index=0))
    cache.add_pod(make_pod("b", cpu_milli=400, priority=5, node_name="n0",
                           creation_index=1))
    return cache, [make_pod("high", cpu_milli=500, priority=100)], {}


def sc_lowest_priority():
    cache = Cache()
    _nodes(cache, 2)
    cache.add_pod(make_pod("lo", cpu_milli=900, priority=1, node_name="n0"))
    cache.add_pod(make_pod("mid", cpu_milli=900, priority=50, node_name="n1"))
    return cache, [make_pod("high", cpu_milli=800, priority=100)], {}


def sc_pdb():
    cache = Cache()
    _nodes(cache, 2)
    cache.add_pod(make_pod("guarded", cpu_milli=900, priority=0, node_name="n0",
                           labels={"app": "web"}))
    cache.add_pod(make_pod("free", cpu_milli=900, priority=10, node_name="n1"))
    pdb = kt.PodDisruptionBudget(
        name="web-pdb", selector=kt.LabelSelector.of({"app": "web"}),
        disruptions_allowed=0,
    )
    return cache, [make_pod("high", cpu_milli=800, priority=100)], {"pdbs": [pdb]}


def sc_policy_never():
    cache = Cache()
    _nodes(cache, 1)
    cache.add_pod(make_pod("low", cpu_milli=900, priority=0, node_name="n0"))
    return cache, [make_pod("never", cpu_milli=800, priority=100,
                            preemption_policy="Never")], {}


def sc_no_lower_priority():
    cache = Cache()
    _nodes(cache, 1)
    cache.add_pod(make_pod("peer", cpu_milli=900, priority=100, node_name="n0"))
    return cache, [make_pod("high", cpu_milli=800, priority=100)], {}


def sc_static_failure():
    cache = Cache()
    cache.add_node(make_node("n0", cpu_milli=1000, memory=2**30))
    cache.add_node(make_node("n1", cpu_milli=1000, memory=2**30, labels={"zone": "a"}))
    cache.add_pod(make_pod("v0", cpu_milli=900, priority=0, node_name="n0"))
    cache.add_pod(make_pod("v1", cpu_milli=900, priority=0, node_name="n1"))
    return cache, [make_pod("high", cpu_milli=800, priority=100,
                            node_selector={"zone": "a"})], {}


def sc_host_port():
    cache = Cache()
    _nodes(cache, 1, cpu=4000, mem=2**32)
    cache.add_pod(make_pod("holder", cpu_milli=100, priority=0, node_name="n0",
                           host_ports=[8080]))
    return cache, [make_pod("high", cpu_milli=100, priority=10, host_ports=[8080])], {}


def sc_shared_port():
    cache = Cache()
    _nodes(cache, 1, cpu=4000, mem=2**32)
    cache.add_pod(make_pod("keeper", cpu_milli=100, priority=200, node_name="n0",
                           host_ports=[8080]))
    cache.add_pod(make_pod("victim", cpu_milli=100, priority=0, node_name="n0"))
    return cache, [make_pod("high", cpu_milli=100, priority=10, host_ports=[8080])], {}


def sc_multi_preemptor():
    cache = Cache()
    _nodes(cache, 2)
    for i in range(2):
        cache.add_pod(make_pod(f"low-{i}", cpu_milli=900, priority=0,
                               node_name=f"n{i}"))
    return cache, [make_pod("h0", cpu_milli=800, priority=100),
                   make_pod("h1", cpu_milli=800, priority=100)], {}


def sc_same_cycle_nominee():
    cache = Cache()
    _nodes(cache, 1)
    cache.add_pod(make_pod("v1", cpu_milli=500, priority=0, node_name="n0",
                           creation_index=0))
    cache.add_pod(make_pod("v2", cpu_milli=400, priority=0, node_name="n0",
                           creation_index=1))
    return cache, [make_pod("h0", cpu_milli=550, priority=100, creation_index=2),
                   make_pod("h1", cpu_milli=700, priority=100, creation_index=3)], {}


def sc_cross_cycle_nomination():
    cache = Cache()
    _nodes(cache, 1)
    cache.add_pod(make_pod("v2", cpu_milli=400, priority=0, node_name="n0"))
    nom = Nominator()
    nom.add(make_pod("nominee", cpu_milli=550, priority=100), "n0")
    return cache, [make_pod("h1", cpu_milli=700, priority=100)], {"nom": nom}


def sc_nominee_assigned_in_batch():
    cache = Cache()
    _nodes(cache, 1)
    cache.add_pod(make_pod("v", cpu_milli=300, priority=0, node_name="n0",
                           creation_index=0))
    nominee = make_pod("nom", cpu_milli=600, priority=100, creation_index=1)
    nom = Nominator()
    nom.add(nominee, "n0")
    h2 = make_pod("h2", cpu_milli=300, priority=100, creation_index=2)
    return cache, [nominee, h2], {"nom": nom, "engine": True, "order": [1]}


def sc_same_cycle_port_charge():
    cache = Cache()
    _nodes(cache, 1)
    cache.add_pod(make_pod("v1", cpu_milli=100, priority=0, node_name="n0",
                           host_ports=[80], creation_index=0))
    cache.add_pod(make_pod("v2", cpu_milli=800, priority=0, node_name="n0",
                           creation_index=1))
    return cache, [
        make_pod("h0", cpu_milli=100, priority=100, host_ports=[80], creation_index=2),
        make_pod("h1", cpu_milli=700, priority=100, host_ports=[80], creation_index=3),
    ], {}


def sc_stale_nomination():
    cache = Cache()
    _nodes(cache, 2)
    cache.add_pod(make_pod("v0", cpu_milli=900, priority=40, node_name="n0",
                           creation_index=0))
    cache.add_pod(make_pod("v1", cpu_milli=900, priority=0, node_name="n1",
                           creation_index=1))
    x = make_pod("x", cpu_milli=800, priority=100, creation_index=2)
    y = make_pod("y", cpu_milli=900, priority=50, creation_index=3)
    nom = Nominator()
    nom.add(x, "n0")
    return cache, [x, y], {"nom": nom}


def sc_lower_priority_nomination():
    cache = Cache()
    _nodes(cache, 1)
    cache.add_pod(make_pod("v2", cpu_milli=400, priority=0, node_name="n0"))
    nom = Nominator()
    nom.add(make_pod("nominee", cpu_milli=550, priority=50), "n0")
    return cache, [make_pod("h1", cpu_milli=700, priority=100)], {"nom": nom}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_basic, sc_reprieve, sc_lowest_priority, sc_pdb, sc_policy_never,
    sc_no_lower_priority, sc_static_failure, sc_host_port, sc_shared_port,
    sc_multi_preemptor, sc_same_cycle_nominee, sc_cross_cycle_nomination,
    sc_nominee_assigned_in_batch, sc_same_cycle_port_charge,
    sc_stale_nomination, sc_lower_priority_nomination,
)}


def _key(r):
    return (r.status, r.node_name, list(r.victim_uids),
            [p.name for p in r.victim_pods])


def preempt_both(cache, pods, pdbs=(), nom=None, engine=False, order=None,
                 profile=PROFILE, hook=None):
    """Run kubetpu's and the port's evaluators over ``pods`` (each batch
    encoded by its own side), preempting ``order`` in turn (through the
    extender ``hook`` when given); assert equal results and return the
    port's."""
    kentries = nom.entries() if nom is not None else ()
    kb = krt.encode_batch(cache.update_snapshot(), pods, profile,
                          nominated=kentries)
    kp = krt.score_params(profile, kb.resource_names)
    pb = prt.encode_batch(
        port_cache(cache).update_snapshot(), [to_port(p) for p in pods],
        to_port(profile), nominated=to_port(list(kentries)), device="cpu",
    )
    pp = prt.score_params(to_port(profile), pb.resource_names)
    kkw, pkw = {}, {}
    if engine:
        _, kst = k_greedy(kb.device, kp)
        _, pst = greedy_assign_plain(pb.device, pp)
        for kw, st in ((kkw, kst), (pkw, pst)):
            kw.update(requested=st[0], pod_count=st[2], spread_counts=st[4],
                      pa_sums=st[5], nominated_active=st[6])
        kkw = {k: (np.asarray(v) if k in ("requested", "pod_count",
                                          "nominated_active") else v)
               for k, v in kkw.items()}
    kev = KEvaluator(kb, kp, pdbs=tuple(pdbs), **kkw)
    pev = PEvaluator(pb, pp, pdbs=tuple(to_port(list(pdbs))), **pkw)
    out = []
    for i in (order if order is not None else range(len(pods))):
        want = kev.preempt(i, extender_hook=hook)
        got = pev.preempt(i, extender_hook=hook)
        assert _key(got) == _key(want), i
        out.append(got)
    assert pev.calls == sum(r.status != "not_eligible" for r in out)
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_evaluator_matches_kubetpu(name):
    cache, pods, kw = SCENARIOS[name]()
    out = preempt_both(cache, pods, **kw)
    statuses = [r.status for r in out]
    expect = {
        "basic": ["success"], "policy_never": ["not_eligible"],
        "no_lower_priority": ["unschedulable"], "shared_port": ["unschedulable"],
        "multi_preemptor": ["success", "success"],
        "same_cycle_nominee": ["success", "unschedulable"],
        "cross_cycle_nomination": ["unschedulable"],
        "nominee_assigned_in_batch": ["success"],
        "same_cycle_port_charge": ["success", "unschedulable"],
        "stale_nomination": ["success", "success"],
        "lower_priority_nomination": ["success"],
    }.get(name)
    if expect is not None:
        assert statuses == expect


@pytest.mark.parametrize("seed", range(6))
def test_evaluator_randomized_parity(seed):
    rng = np.random.default_rng(seed)
    cache = Cache()
    n_nodes = int(rng.integers(3, 10))
    for i in range(n_nodes):
        cache.add_node(make_node(f"n{i}", cpu_milli=1000, memory=4 * 2**30, pods=20))
    ci = 0
    for i in range(n_nodes):
        for _ in range(int(rng.integers(1, 5))):
            cache.add_pod(make_pod(
                f"p{ci}", cpu_milli=int(rng.integers(100, 500)),
                memory=int(rng.integers(1, 8)) * 2**28,
                priority=int(rng.integers(0, 4)) * 10, node_name=f"n{i}",
                creation_index=ci, labels={"grp": f"g{ci % 3}"},
            ))
            ci += 1
    pdbs = [kt.PodDisruptionBudget(
        name="pdb0", selector=kt.LabelSelector.of({"grp": "g0"}),
        disruptions_allowed=int(rng.integers(0, 2)),
    )]
    highs = [make_pod(f"high{j}", cpu_milli=int(rng.integers(600, 1000)),
                      memory=2**30, priority=35 - j, creation_index=100 + j)
             for j in range(3)]
    preempt_both(cache, highs, pdbs=pdbs)


def test_extender_preemption_is_a_later_slice():
    """The extender ProcessPreemption hook (item 9, ported since this test
    was named): ``preempt(i, extender_hook=)`` picks over the hook's
    survivors as kubetpu's does — no veto, a veto of the dry run's node,
    trimmed victim lists, every node vetoed — and ``extender_chain_hook``
    of no extender is None."""

    def veto(names, trim=False):
        def hook(pod, cand):
            return {
                node: ([p.uid for p in victims][:1 if trim else None], npdb)
                for node, (victims, npdb) in cand.items() if node not in names
            }
        return hook

    for hook, want in ((veto(()), "success"), (veto(("n0",)), "success"),
                       (veto(("n1", "n2"), trim=True), "success"),
                       (veto(("n0", "n1", "n2", "n3")), "unschedulable")):
        cache, pods, _ = sc_basic()
        (got,) = preempt_both(cache, pods, hook=hook)
        assert got.status == want
    for name in ("multi_preemptor", "same_cycle_port_charge"):
        cache, pods, kw = SCENARIOS[name]()
        preempt_both(cache, pods, hook=veto(("n0",)), **kw)
    assert extender_chain_hook(()) is None


# -------------------------------------------------------------- scheduler


def _scheduler_pair(engine, pipeline):
    """kubetpu's Scheduler (synchronous dispatch) and the port's on the
    CPU, both with preemption on, each with a client that records victims
    and nominations, and a clock each that the test steps."""
    from kubetpu.perf.runner import _Client as KClient
    from kubetpu.sched.scheduler import Scheduler as KScheduler
    from kubetpu_torch.perf.runner import _Client as PClient
    from kubetpu_torch.sched import Scheduler as PScheduler

    class KRecorder(KClient):
        def __init__(self):
            super().__init__()
            self.deleted, self.nominated = [], []

        def delete_pod(self, pod, reason=""):
            self.deleted.append((pod.name, reason))
            super().delete_pod(pod, reason)

        def nominate(self, pod, node_name):
            self.nominated.append((pod.name, node_name))

    kc, pc = KRecorder(), PClient()
    kclock, pclock = FakeClock(), FakeClock()
    profile = KC.Profile()
    ks = KScheduler(kc, profile=profile, max_batch=8, engine=engine,
                    dispatcher_workers=0, flight_recorder=False,
                    clock=kclock, pipeline=pipeline)
    ps = PScheduler(pc, profile=to_port(profile), max_batch=8, engine=engine,
                    device="cpu", clock=pclock, pipeline=pipeline)
    kc.sched, pc.sched = ks, ps
    ks.enable_preemption()
    ps.enable_preemption()
    return (ks, kc, kclock), (ps, pc, pclock)


def _preemption_cluster(sched, to=lambda x: x):
    """10 four-cpu nodes, each filled to 3.6 cpu by four priority-0 pods."""
    from kubetpu.perf import workloads as KW

    for i in range(10):
        sched.on_node_add(to(KW.node_default(i)))
    for j in range(40):
        pod = KW.pod_low_priority(f"low-{j}", "init")
        sched.on_pod_add(to(pod.with_node(f"scheduler-perf-{j % 10}")))


def _arrivals(step):
    """Pods arriving before call ``step``: 3-cpu preemptors (priority 10),
    default pods, and a 2-cpu priority-5 pod that can only preempt."""
    from kubetpu.perf import workloads as KW

    if step == 0:
        return ([KW.pod_high_priority_3cpu(f"high-{j}", "churn") for j in range(5)]
                + [KW.pod_default(f"d-{j}", "m") for j in range(12)])
    if step == 4:
        return ([KW.pod_high_priority_3cpu(f"high-{j}", "churn") for j in range(5, 8)]
                + [make_pod("mid", namespace="m", cpu_milli=2000,
                            memory=2**28, priority=5)]
                + [KW.pod_default(f"d-{j}", "m") for j in range(12, 20)])
    return []


def _drive_stepped(sched, client, clock, to, calls=40):
    for step in range(calls):
        for pod in _arrivals(step):
            sched.on_pod_add(to(pod))
        sched.schedule_batch()
        client.deliver()
        clock.tick(0.75)
    if sched._inflight is not None:
        sched._complete_inflight()
        client.deliver()
    return dict(client.bound)


@pytest.mark.parametrize("engine,pipeline", [
    ("greedy", False), ("greedy", True), ("batched", False), ("batched", True),
])
def test_scheduler_preempt_then_schedule(engine, pipeline):
    (ks, kc, kclock), (ps, pc, pclock) = _scheduler_pair(engine, pipeline)
    _preemption_cluster(ks)
    _preemption_cluster(ps, to_port)
    kbound = _drive_stepped(ks, kc, kclock, lambda p: p)
    pbound = _drive_stepped(ps, pc, pclock, to_port)
    ks.dispatcher.sync()
    assert pbound == kbound
    assert [(p.name, r) for p, r in pc.deleted] == kc.deleted
    assert [(p.name, n) for p, n in pc.nominated] == kc.nominated
    assert sorted(e.uid for e in ps.nominator.entries()) == sorted(
        e.uid for e in ks.nominator.entries())
    assert ps.metrics.preemption_attempts == ks.metrics.preemption_attempts
    assert ps.metrics.preemption_victims == ks.metrics.preemption_victims
    # the path did preempt: victims of lower priority, every preemptor bound
    assert pc.deleted and all(p.priority == 0 for p, _ in pc.deleted)
    assert sum(1 for name in pbound if name.startswith("high-")) == 8
    assert sum(1 for name in pbound if name.startswith("d-")) >= 10
    ks.close()


def test_run_workload_preemption_async_5nodes():
    from kubetpu_torch.perf import run_workload

    r = run_workload("PreemptionAsync", "5Nodes", device="cpu")
    assert r.scheduled == 5 == r.measure_pods
    assert r.preemptions >= 1 and r.preemption_victims >= 3
    assert r.preempt_calls >= 1 and set(r.preempt_ms) == {
        "upload", "potential", "dry_run", "fetch"}
    assert r.cycle_ms["postfilter"] > 0
