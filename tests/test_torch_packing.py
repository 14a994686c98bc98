"""The port's packing engine equals kubetpu's, bit for bit.

kubetpu's ``assign/packing.py`` runs its float32 utility through XLA on the
CPU, which fuses multiply-adds and brings its own ``log1p``; the port's
plain version (``kubetpu_torch.assign.packing``) rounds as XLA does. Held
to kubetpu, with seeded inputs at small size:

- ``log1p_counts`` against ``jnp.log1p`` for every count in [0, 1024] and
  ``fma32`` against XLA's fused ``a * b + c``, bit for bit;
- ``_banded_tie_choice``, ``_priority_order`` and ``_accept_packed``
  (capacity on and off, coupled pods) on seeded tables, exactly;
- ``packing_assign_device`` as a whole on batches with host ports, spread,
  affinity, taints, nominations and a topology block, warm-started and
  truncated by ``max_iters``: assignments, the seven state slots, the duals
  out (their bits), iterations and nodes used exactly, the objective (a
  float32 sum taken in another order) within ``rtol=1e-5``;
- the ``Scheduler(engine="packing")`` scenarios of ``tests/test_packing.py``
  through the port's ``Scheduler(device="cpu")`` and kubetpu's: equal bound
  maps and solver iterations, pipelined and serial, gangs, the recorder;
- ``BinPacking/200Nodes`` through both runners: equal
  ``nodes_used_at_steady_state``, ``priority_slo_hit_rate`` and
  ``solver_iters_per_cycle``.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax
import jax.numpy as jnp

import kubetpu  # noqa: F401  (x64 on before any kernel runs)
from kubetpu.api import types as kt
from kubetpu.api import wrappers as KWR
from kubetpu.assign import packing as KP
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.perf import workloads as KW
from kubetpu.perf.runner import run_workload as k_run_workload
from kubetpu.sched.scheduler import Scheduler as KScheduler
from kubetpu.state.snapshot import Cache

from kubetpu_torch.api import wrappers as PWR
from kubetpu_torch.assign import packing as PP
from kubetpu_torch.framework import config as PC
from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.perf import run_workload
from kubetpu_torch.sched import Scheduler as PScheduler

from .cluster_gen import random_cluster
from .test_podaffinity import add_affinity
from .test_scheduler import FakeClient
from .test_spread import add_spread_pods
from .test_torch_nominations import PORTS_PROFILE, nominated_cluster
from .test_torch_placement import sliced_cluster
from .torch_port_util import FakeClock, port_batch_from_jax, port_params, to_port

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
GANG_GATES = {"GenericWorkload": True, "GangScheduling": True}


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


# --------------------------------------------------------- float32 rounding


def test_log1p_counts_equal_jnp():
    """Every overflow count a solve of up to 1024 pods can produce."""
    k = np.arange(0, 1025, dtype=np.float32)
    want = np.asarray(jnp.log1p(jnp.asarray(k)))
    got = PP.log1p_counts(torch.from_numpy(k)).numpy()
    assert np.array_equal(_bits(got), _bits(want))


def test_fma32_equals_xla_fused_multiply_add():
    """``fma32`` rounds once, as the multiply-add XLA fuses: on seeded
    triples over a wide exponent range it equals jitted ``a * b + c``, and
    that differs from a separately rounded product somewhere (the test can
    tell the two apart)."""
    rng = np.random.default_rng(7)
    n = 20000
    a, b = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(
        np.float32), rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    got = PP.fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    unfused = (torch.from_numpy(a) * torch.from_numpy(b) + torch.from_numpy(c)).numpy()
    assert not np.array_equal(_bits(unfused), _bits(want))


# ------------------------------------------------- the round's functions


@pytest.mark.parametrize("seed", range(4))
def test_banded_tie_choice_equal(seed):
    """Utilities drawn from a narrow range, so many nodes fall inside one
    band; infeasible pairs, all-infeasible rows and inactive pods."""
    rng = np.random.default_rng(seed)
    P, N = 48, 24
    mask = rng.random((P, N)) < 0.6
    mask[rng.random(P) < 0.15] = False
    util = rng.integers(-(1 << 21), 1 << 18, (P, N)).astype(np.int64)
    util = np.where(mask, util, KP.I64_MIN)
    active = rng.random(P) < 0.85
    band = int(rng.choice([0, 1 << 16, 157286, 1 << 20]))
    want = np.asarray(KP._banded_tie_choice(
        jnp.asarray(mask), jnp.asarray(util), jnp.asarray(active), jnp.int64(band)))
    got = PP._banded_tie_choice(torch.from_numpy(mask), torch.from_numpy(util),
                                torch.from_numpy(active), band)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_priority_order_equal(seed):
    rng = np.random.default_rng(seed)
    P = 64
    prio = rng.choice([-5, 0, 0, 5, 10, 1000], P).astype(np.int32)
    valid = rng.random(P) < 0.8
    want = np.asarray(KP._priority_order(jnp.asarray(prio), jnp.asarray(valid)))
    got = PP._priority_order(torch.from_numpy(prio), torch.from_numpy(valid))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("check_capacity", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_accept_packed_equal(seed, check_capacity):
    """Several choosers a node, free rows tight and some negative (an
    overcommitted node), little pod room, coupled pods."""
    rng = np.random.default_rng(seed + 10)
    P, N, R = 64, 12, 3
    choice = rng.integers(-1, N, P).astype(np.int32)
    requests = rng.integers(0, 900, (P, R)).astype(np.int64)
    free = rng.integers(-200, 3000, (N, R)).astype(np.int64)
    count_room = rng.integers(0, 6, N).astype(np.int32)
    order = rng.permutation(P).astype(np.int32)
    coupled = rng.random(P) < 0.3
    want = np.asarray(KP._accept_packed(
        jnp.asarray(choice), jnp.asarray(requests), jnp.asarray(free),
        jnp.asarray(count_room), jnp.asarray(order), jnp.asarray(coupled),
        check_capacity=check_capacity))
    got = PP._accept_packed(
        torch.from_numpy(choice), torch.from_numpy(requests), torch.from_numpy(free),
        torch.from_numpy(count_room), torch.from_numpy(order), torch.from_numpy(coupled),
        check_capacity=check_capacity)
    assert np.array_equal(got.numpy(), want)
    assert want.any() and (~want & (choice >= 0)).any()


# ---------------------------------------------------------- whole solves


def _solve_equal(kb, kp, lam=None, max_iters=0, weights=None):
    """Both solves on kubetpu's encoded batch; returns the port's output."""
    weights = weights or KP.PackingWeights()
    n = kb.alloc.shape[0]
    lam = np.zeros(n, dtype=np.float32) if lam is None else lam
    ka, kst, klam, kobj, kit, knu = jax.device_get(KP.packing_assign_device(
        kb, kp, jnp.asarray(lam), weights.tensor(), max_iters=max_iters))
    pb = port_batch_from_jax(kb)
    out = PP.packing_assign_device(
        pb, port_params(kp), torch.from_numpy(lam.copy()),
        to_port(weights).tensor("cpu"), max_iters)
    pa, pst, plam, pobj, pit, pnu = out
    assert np.array_equal(pa.numpy(), np.asarray(ka))
    for i in range(7):
        if kst[i] is None:
            assert pst[i] is None, i
            continue
        want, got = np.asarray(kst[i]), pst[i].numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), i
    assert np.array_equal(_bits(plam.numpy()), _bits(klam))
    assert pit == int(kit)
    assert int(pnu) == int(knu)
    assert float(pobj) == pytest.approx(float(kobj), rel=1e-5)
    # the batch's own node block is never written
    assert np.array_equal(pb.requested.numpy(), np.asarray(kb.requested))
    return out


def _encode(cache, pending, profile, **kw):
    b = krt.encode_batch(cache.update_snapshot(), pending, profile, **kw)
    return b, krt.score_params(profile, b.resource_names)


def _cases():
    out = {}
    for seed in range(2):
        rng = np.random.default_rng(seed + 1900)
        out[f"resources-{seed}"] = (
            *random_cluster(rng, num_nodes=48, num_existing=80, num_pending=64),
            KC.minimal_profile(), {})
        rng = np.random.default_rng(seed + 1950)
        cache, pending = random_cluster(rng, num_nodes=32, num_existing=50,
                                        num_pending=32, with_taints=True)
        pending = add_affinity(rng, add_spread_pods(rng, pending))
        out[f"spread-affinity-{seed}"] = (cache, pending, KC.Profile(), {})
    for seed in range(2):
        cache, pending, nom = nominated_cluster(seed, n_pending=28)
        out[f"nominations-ports-{seed}"] = (cache, pending, PORTS_PROFILE,
                                            dict(nominated=nom.entries()))
        cache, pending = sliced_cluster(seed, n_nodes=32, slices=4, n_pending=24)
        out[f"topology-{seed}"] = (cache, pending, KC.Profile(), dict(topology="on"))
    cache = Cache()
    for i in range(24):
        cache.add_node(KWR.make_node(f"n{i}", cpu_milli=4000, memory=32 * 1024**3))
    out["binpack"] = (cache, [KW.pod_binpack(f"measure-0-ns-{j}", "ns") for j in range(60)],
                      KC.Profile(), {})
    return out


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_equal_reference(name):
    """Cold, then warm-started from the cold solve's duals (a second cycle
    over the same batch), then truncated after one iteration."""
    cache, pending, profile, kw = CASES[name]
    kb, kp = _encode(cache, pending, profile, **kw)
    if name.startswith("topology"):
        assert kb.device.topology is not None
    _, _, lam, _, iters, _ = _solve_equal(kb.device, kp)
    assert iters >= 1
    _solve_equal(kb.device, kp, lam=lam.numpy())
    _solve_equal(kb.device, kp, max_iters=1)


def test_solve_other_weights_equal():
    """Weights away from the defaults: a wide band, no decay, a slice
    reward larger than the fragmentation price."""
    cache, pending, profile, kw = CASES["topology-1"]
    kb, kp = _encode(cache, pending, profile, **kw)
    w = KP.PackingWeights(score_weight=0.6, alpha_open=2.0, beta_frag=0.3,
                          dual_step=0.4, dual_decay=1.0, tie_band=0.4,
                          slice_frag=0.2, slice_align=0.7)
    _, _, lam, *_ = _solve_equal(kb.device, kp, weights=w)
    _solve_equal(kb.device, kp, lam=lam.numpy(), weights=w)


def test_warm_start_cuts_iterations():
    """The reference's warm-start scenario through the port's engine: the
    second solve of the same batch converges in fewer iterations, with the
    same nodes used, as kubetpu's engine does."""
    cache = Cache()
    for i in range(6):
        cache.add_node(KWR.make_node(f"n{i}", cpu_milli=4000, memory=64 * 1024**3))
    pending = [KWR.make_pod(f"p{j}", cpu_milli=900, memory=128 * 1024**2,
                            creation_index=j) for j in range(20)]
    kb, kp = _encode(cache, pending, KC.minimal_profile())
    keng, peng = KP.PackingEngine(), PP.PackingEngine(device="cpu")
    pb, pp = port_batch_from_jax(kb.device), port_params(kp)
    iters = []
    for _ in range(2):
        ka, _ = keng(kb.device, kp)
        pa, _ = peng(pb, pp)
        assert np.array_equal(pa.numpy(), np.asarray(ka))
        assert peng.last_iters == int(keng.last_iters)
        assert int(peng.last_nodes_used) == int(keng.last_nodes_used) == 5
        iters.append(peng.last_iters)
    assert iters[1] < iters[0]
    assert peng.state.carries == 1 and peng.state.resets == 1


def test_solver_state_resets_on_shape_change():
    st = prt.PackingSolverState(device="cpu")
    st.store(8, torch.full((8,), 0.5))
    assert float(st.duals(8).sum()) == pytest.approx(4.0)
    # consumed by the pop: the next fetch at the same N is cold again
    assert float(st.duals(8).sum()) == 0.0
    st.store(8, torch.ones(8))
    lam16 = st.duals(16)
    assert lam16.shape == (16,) and float(lam16.sum()) == 0.0
    assert st.nbytes == 32
    st.reset()
    assert st.nbytes == 0
    assert (st.resets, st.carries) == (2, 1)
    from kubetpu_torch.parallel import mesh as M

    # on a pods x nodes grid the cold duals come a piece a tile
    grid = prt.PackingSolverState(mesh=M.make_mesh_2d(["cpu"] * 4, pods=2), device="cpu")
    lam = grid.duals(16)
    assert [p.shape[0] for p in lam.pieces] == [8] * 4 and lam.rows == 2
    assert grid.resets == 1


def test_weights_tensor_and_json_equal():
    for w in (KP.PackingWeights(), KP.PackingWeights(alpha_open=2.0, tie_band=0.2)):
        pw = to_port(w)
        assert np.array_equal(_bits(pw.tensor("cpu").numpy()), _bits(w.tensor()))
        assert pw.to_json() == w.to_json()


# ------------------------------------------------------ the scheduler loop


class Side:
    """One packing scheduler of a pair: ``W`` is its wrappers module, ``s``
    the scheduler (kubetpu's with synchronous binds), ``c`` its client."""

    def __init__(self, port: bool, profile=None, **kw):
        self.port = port
        self.W = PWR if port else KWR
        self.c = FakeClient()
        self.clock = FakeClock()
        profile = profile or KC.minimal_profile()
        kw.setdefault("engine", "packing")
        if port:
            self.s = PScheduler(self.c, profile=to_port(profile), device="cpu",
                                clock=self.clock, **kw)
        else:
            self.s = KScheduler(client=self.c, profile=profile, dispatcher_workers=0,
                                clock=self.clock, **kw)

    def settle(self, cycles=6):
        total = 0
        for _ in range(cycles):
            total += self.s.schedule_batch()["scheduled"]
        if self.s.pipeline and self.s._inflight is not None:
            total += self.s._complete_inflight()["scheduled"]
        if not self.port:
            self.s.dispatcher.sync()
            self.s._drain_bind_completions()
        return total

    def solver_iters(self):
        if self.port:
            return [c.solver_iters for c in self.s.metrics.cycle_timings
                    if c.solver_iters is not None]
        return [r.solver_iters for r in self.s.metrics.tpu.records
                if r.solver_iters is not None]

    def objectives(self):
        if self.port:
            return [c.objective_value for c in self.s.metrics.cycle_timings
                    if c.objective_value is not None]
        return [r.objective_value for r in self.s.metrics.tpu.records
                if r.objective_value is not None]


def both(scenario, **kw):
    """``scenario(side)`` on kubetpu and on the port: equal return values,
    bound maps and solver iterations a cycle, objectives within 1e-5.
    Returns the port's side and result."""
    out = []
    for port in (False, True):
        side = Side(port, **kw)
        out.append((side, scenario(side)))
    (kside, kres), (pside, pres) = out
    assert pres == kres
    assert dict(pside.c.bound) == dict(kside.c.bound)
    assert pside.solver_iters() == kside.solver_iters()
    assert pside.objectives() == pytest.approx(kside.objectives(), rel=1e-5)
    for side in (kside, pside):
        if not side.port:
            side.s.close()
    return pside, pres


def _nodes_used(side):
    return len(set(side.c.bound.values()))


def _obj(side, obj):
    """A kubetpu host object as this side's own class."""
    return to_port(obj) if side.port else obj


def _saturated(side):
    for i in range(4):
        side.s.on_node_add(side.W.make_node(f"n{i}", cpu_milli=1000, memory=8 * 1024**3))
    for j in range(20):
        side.s.on_pod_add(side.W.make_pod(f"p{j}", cpu_milli=300, memory=128 * 1024**2,
                                          creation_index=j))
    return side.settle(2)


def _binpack(side):
    for i in range(8):
        side.s.on_node_add(side.W.make_node(f"n{i}", cpu_milli=4000, memory=64 * 1024**3))
    for j in range(20):
        side.s.on_pod_add(side.W.make_pod(f"p{j}", cpu_milli=500, memory=256 * 1024**2,
                                          creation_index=j))
    return side.settle(), _nodes_used(side)


def _overcommit(side):
    for i in range(3):
        side.s.on_node_add(side.W.make_node(f"n{i}", cpu_milli=1000, memory=1024**3))
    for j in range(12):
        side.s.on_pod_add(side.W.make_pod(f"p{j}", cpu_milli=500, memory=128 * 1024**2,
                                          creation_index=j))
    return side.settle()


def _ports(side):
    for i in range(2):
        side.s.on_node_add(side.W.make_node(f"n{i}", cpu_milli=4000, memory=32 * 1024**3))
    for j, name in enumerate("abc"):
        side.s.on_pod_add(side.W.make_pod(name, cpu_milli=100, host_ports=[80],
                                          creation_index=j))
    return side.settle(2), _nodes_used(side)


def _taints(side):
    taint = _obj(side, kt.Taint(key="dedicated", value="gpu"))
    tol = _obj(side, kt.Toleration(key="dedicated", operator=kt.TolerationOperator.EXISTS))
    side.s.on_node_add(side.W.make_node("tainted", cpu_milli=4000, memory=32 * 1024**3,
                                        taints=[taint]))
    side.s.on_node_add(side.W.make_node("open0", cpu_milli=4000, memory=32 * 1024**3))
    side.s.on_pod_add(side.W.make_pod("pre", cpu_milli=3000, memory=1024**3,
                                      tolerations=[tol], node_name="tainted"))
    for j in range(4):
        side.s.on_pod_add(side.W.make_pod(f"p{j}", cpu_milli=200, memory=128 * 1024**2,
                                          creation_index=j))
    n = side.settle()
    assert "tainted" not in side.c.bound.values()
    return n


def _affinity(side):
    for i in range(8):
        side.s.on_node_add(side.W.make_node(
            f"n{i}", cpu_milli=1000, labels={ZONE: "z0" if i < 3 else "z1", HOST: f"n{i}"}))
    side.s.on_pod_add(side.W.make_pod("seed", cpu_milli=100, labels={"app": "web"},
                                      node_name="n0"))
    aff = _obj(side, kt.Affinity(pod_affinity=kt.PodAffinity(
        required=(KWR.pod_affinity_term(ZONE, match_labels={"app": "web"}),))))
    for j in range(10):
        side.s.on_pod_add(side.W.make_pod(f"p{j}", cpu_milli=300, labels={"app": "web"},
                                          affinity=aff, creation_index=j))
    n = side.settle()
    assert set(side.c.bound.values()) <= {"n0", "n1", "n2"}
    return n


def _spread(side):
    for i in range(6):
        side.s.on_node_add(side.W.make_node(
            f"n{i}", cpu_milli=4000, labels={ZONE: f"z{i % 3}", HOST: f"n{i}"}))
    cons = _obj(side, [KWR.spread_constraint(
        1, ZONE, when=kt.UnsatisfiableConstraintAction.DO_NOT_SCHEDULE,
        match_labels={"app": "sp"})])
    for j in range(9):
        side.s.on_pod_add(side.W.make_pod(f"p{j}", cpu_milli=200, labels={"app": "sp"},
                                          spread=cons, creation_index=j))
    return side.settle()


def _scarcity(side):
    side.s.on_node_add(side.W.make_node("n0", cpu_milli=1000, memory=8 * 1024**3))
    for j in range(3):
        side.s.on_pod_add(side.W.make_pod(f"lo{j}", cpu_milli=300, memory=64 * 1024**2,
                                          priority=0, creation_index=j))
    for j in range(3):
        side.s.on_pod_add(side.W.make_pod(f"hi{j}", cpu_milli=300, memory=64 * 1024**2,
                                          priority=10, creation_index=3 + j))
    n = side.s.schedule_batch()["scheduled"]
    if not side.port:
        side.s.dispatcher.sync()
    return n, sorted(k.split("/")[1] for k in side.c.bound)


def _churn(side):
    """A packing run over several cycles with nodes added between them
    (warm duals carried per padded node count, a new count cold)."""
    for i in range(10):
        side.s.on_node_add(side.W.make_node(f"n{i:02d}", cpu_milli=4000, memory=32 * 1024**3))
    for j in range(40):
        side.s.on_pod_add(side.W.make_pod(f"p{j}", cpu_milli=200 + 100 * (j % 4),
                                          memory=256 * 1024**2, creation_index=j))
    n = side.settle(3)
    for i in range(10, 24):
        side.s.on_node_add(side.W.make_node(f"n{i:02d}", cpu_milli=4000, memory=32 * 1024**3))
    for j in range(40, 90):
        side.s.on_pod_add(side.W.make_pod(f"p{j}", cpu_milli=300, memory=256 * 1024**2,
                                          creation_index=j))
    return n + side.settle(4)


NOFIT = KC.Profile(
    filters=KC.PluginSet(enabled=()),
    scores=KC.PluginSet(enabled=((KC.NODE_RESOURCES_FIT, 1),)),
    default_spread_constraints=(),
)


def _profile(*filters):
    return KC.Profile(
        filters=KC.PluginSet(enabled=tuple((f, 1) for f in filters)),
        scores=KC.PluginSet(enabled=((KC.NODE_RESOURCES_FIT, 1),)),
        default_spread_constraints=(),
    )


SCENARIOS = {
    "saturated": (_saturated, KC.minimal_profile(), 12),
    "binpack": (_binpack, KC.minimal_profile(), (20, 3)),
    "overcommit_without_fit_filter": (_overcommit, NOFIT, 12),
    "host_ports": (_ports, _profile(KC.NODE_RESOURCES_FIT, KC.NODE_PORTS), (2, 2)),
    "taints": (_taints, _profile(KC.NODE_RESOURCES_FIT, KC.TAINT_TOLERATION), 4),
    "affinity_contention": (_affinity, _profile(KC.NODE_RESOURCES_FIT,
                                                KC.INTER_POD_AFFINITY), 9),
    "spread_do_not_schedule": (_spread, _profile(KC.NODE_RESOURCES_FIT,
                                                 KC.POD_TOPOLOGY_SPREAD), 9),
    "priority_under_scarcity": (_scarcity, KC.minimal_profile(),
                                (3, ["hi0", "hi1", "hi2"])),
    "churn_default_profile": (_churn, KC.Profile(), 90),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_scenarios_equal_reference(name):
    scenario, profile, expected = SCENARIOS[name]
    _, res = both(scenario, profile=profile)
    assert res == expected


@pytest.mark.parametrize("cycles", [1, 3])
def test_pipelined_equal_serial_and_reference(cycles):
    """The pipelined packing cycle sees the duals in the serial loop's
    order: its bound map and solver iterations a cycle equal the serial
    run's and kubetpu's pipelined run's."""

    def scenario(side):
        for i in range(12):
            side.s.on_node_add(side.W.make_node(f"n{i:02d}", cpu_milli=4000,
                                                memory=32 * 1024**3))
        for j in range(64):
            side.s.on_pod_add(side.W.make_pod(f"p{j}", cpu_milli=100 + 150 * (j % 5),
                                              memory=256 * 1024**2, creation_index=j))
        return side.settle(8)

    pside, n = both(scenario, max_batch=64 // cycles + 1, pipeline=True)
    serial = Side(True, max_batch=64 // cycles + 1)
    assert scenario(serial) == n == 64
    assert dict(serial.c.bound) == dict(pside.c.bound)
    assert serial.solver_iters() == pside.solver_iters()
    assert len(pside.solver_iters()) == cycles


def test_gang_atomicity_on_packing_engine():
    """All-or-nothing gangs ride the engine contract: room for two of
    three members binds nothing; capacity arriving admits all three."""

    def scenario(side):
        for i in range(2):
            side.s.on_node_add(side.W.make_node(f"n{i}", cpu_milli=600))
        side.s.on_pod_group_add(side.W.make_pod_group("gang-a", min_count=3))
        for i in range(3):
            side.s.on_pod_add(side.W.make_pod(f"g-{i}", cpu_milli=500, memory=128 * 1024**2,
                                              scheduling_group="gang-a", creation_index=i))
        first = side.settle(4)
        bound_first = len(side.c.bound)
        side.s.on_node_add(side.W.make_node("n2", cpu_milli=600))
        side.clock.tick(30)
        return first, bound_first, side.settle(4), len(side.c.bound)

    _, res = both(scenario, feature_gates=dict(GANG_GATES))
    assert res == (0, 0, 3, 3)


def test_greedy_unperturbed_by_a_packing_run():
    """``engine="greedy"`` binds the same before and after a packing run in
    the same process."""
    runs = [both(_churn, engine=engine)[0] for engine in ("greedy", "packing", "greedy")]
    assert dict(runs[0].c.bound) == dict(runs[2].c.bound)
    assert runs[0].solver_iters() == [] and runs[1].solver_iters()
    assert all(c.objective_value is None for c in runs[2].s.metrics.cycle_timings)


def test_recorder_records_carry_the_objective():
    """The flight recorder's records of a packing cycle carry the solve's
    objective and iterations, as kubetpu's do."""

    def scenario(side):
        for i in range(4):
            side.s.on_node_add(side.W.make_node(f"n{i}", cpu_milli=4000, memory=32 * 1024**3))
        for j in range(12):
            side.s.on_pod_add(side.W.make_pod(f"p{j}", cpu_milli=200, memory=256 * 1024**2,
                                              creation_index=j))
        side.settle(2)
        rec = side.s.flight_recorder.lookup("default/p0")
        return rec["engine"], rec["solver_iters"], round(rec["objective_value"], 3)

    pside, (engine, iters, _) = both(scenario, flight_recorder=True)
    assert engine == "packing" and iters >= 1
    timing = pside.s.metrics.cycle_timings[0]
    rec = pside.s.flight_recorder.lookup("default/p0")
    assert rec["objective_value"] == timing.objective_value
    assert timing.nodes_used == len(set(pside.c.bound.values()))


def test_scheduler_builds_and_runs_with_packing():
    """``engine="packing"`` is a registered engine of the port (it raised
    before this slice) and unknown engines still refuse."""
    s = PScheduler(FakeClient(), device="cpu", engine="packing")
    assert isinstance(s._assign_device, PP.PackingEngine)
    s.on_node_add(PWR.make_node("n0", cpu_milli=2000, memory=4 * 1024**3))
    s.on_pod_add(PWR.make_pod("p0", cpu_milli=500))
    assert s.schedule_batch()["scheduled"] == 1
    assert s.metrics.cycle_timings[0].solver_iters == 1
    with pytest.raises(ValueError, match="unknown engine"):
        PScheduler(FakeClient(), device="cpu", engine="lp")


# ----------------------------------------------------------- the runner


def test_binpacking_runner_equal_reference():
    """BinPacking/200Nodes through both runners on the packing engine, and
    the port's greedy run for the frontier's other end."""
    want = k_run_workload("BinPacking", "200Nodes", engine="packing", warmup=False)
    got = run_workload("BinPacking", "200Nodes", device="cpu", engine="packing")
    assert got.scheduled == got.measure_pods == 300
    for key in ("nodes_used_at_steady_state", "priority_slo_hit_rate",
                "solver_iters_per_cycle", "packing_weights"):
        assert getattr(got, key) == getattr(want, key), key
    js = got.to_json()
    assert js["nodes_used_at_steady_state"] == want.nodes_used_at_steady_state
    greedy = run_workload("BinPacking", "200Nodes", device="cpu", engine="greedy")
    assert greedy.solver_iters_per_cycle is None and greedy.packing_weights is None
    assert got.nodes_used_at_steady_state < greedy.nodes_used_at_steady_state
    assert dataclasses.asdict(got)["engine"] == "packing"
