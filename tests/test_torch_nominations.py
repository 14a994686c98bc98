"""The port's nominator reservations equal kubetpu's, bit for bit.

A nomination (``queue.nominator``) reserves its pod's requests, a pod slot
and its host ports on the nominated node for every batch pod of lower or
equal priority other than itself. Seeded clusters with host ports, pending
pods of mixed priority and nominations of pods in and out of the batch
(one on a node that no longer exists) are encoded by kubetpu and by the
port: the five nomination leaves must agree leaf for leaf, and on the
carried batch ``resource_fit_mask_nominated``, ``feasible_and_scores``
under a partial ``nominated_active`` and both plain engines (assignments
and all seven state slots, slot 6 the live nominations) must equal
kubetpu's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubetpu  # noqa: F401
from kubetpu.api.wrappers import make_node, make_pod
from kubetpu.assign.batched import batched_assign_device as k_batched
from kubetpu.assign.greedy import greedy_assign_device as k_greedy
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.ops import filters as KF
from kubetpu.queue.nominator import Nominator
from kubetpu.state.snapshot import Cache

from kubetpu_torch.assign.batched import batched_assign_plain
from kubetpu_torch.assign.greedy import greedy_assign_plain
from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.ops import filters as PF

from .torch_port_util import (
    assert_batches_equal,
    port_batch_from_jax,
    port_cache,
    port_params,
    to_port,
)

PORTS_PROFILE = KC.Profile(
    filters=KC.PluginSet(enabled=(
        (KC.NODE_UNSCHEDULABLE, 1), (KC.NODE_NAME, 1),
        (KC.TAINT_TOLERATION, 1), (KC.NODE_AFFINITY, 1),
        (KC.NODE_PORTS, 1), (KC.NODE_RESOURCES_FIT, 1),
    )),
    scores=KC.PluginSet(enabled=((KC.NODE_RESOURCES_FIT, 1),)),
    default_spread_constraints=(),
)


def nominated_cluster(seed, n_nodes=12, n_bound=20, n_pending=24, n_nom=8):
    """A seeded cluster, its pending pods and a Nominator holding
    nominations of pending pods and of pods outside the batch."""
    rng = np.random.default_rng(seed)
    cache = Cache()
    for i in range(n_nodes):
        cache.add_node(make_node(
            f"n{i}", cpu_milli=int(rng.integers(1000, 4000)),
            memory=int(rng.integers(2, 8)) * 2**30,
            pods=int(rng.integers(3, 12)),
        ))
    for j in range(n_bound):
        kw = {"host_ports": [80]} if rng.random() < 0.2 else {}
        cache.add_pod(make_pod(
            f"b{j}", cpu_milli=int(rng.integers(100, 900)),
            memory=int(rng.integers(1, 4)) * 2**28,
            priority=int(rng.integers(0, 3)) * 10,
            node_name=f"n{int(rng.integers(0, n_nodes))}", creation_index=j,
            **kw,
        ))
    pending = []
    for j in range(n_pending):
        kw = {}
        if rng.random() < 0.25:
            kw["host_ports"] = [int(rng.choice([80, 443]))]
        pending.append(make_pod(
            f"p{j}", cpu_milli=int(rng.integers(100, 1500)),
            memory=int(rng.integers(1, 6)) * 2**28,
            priority=int(rng.integers(0, 4)) * 10,
            creation_index=100 + j, **kw,
        ))
    nom = Nominator()
    names = [f"n{i}" for i in range(n_nodes)] + ["gone"]
    in_batch = rng.choice(n_pending, size=n_nom // 2, replace=False)
    for j in in_batch:
        nom.add(pending[int(j)], str(rng.choice(names)))
    for g in range(n_nom - n_nom // 2):
        kw = {"host_ports": [443]} if rng.random() < 0.5 else {}
        nom.add(make_pod(
            f"w{g}", cpu_milli=int(rng.integers(100, 2000)),
            memory=int(rng.integers(1, 6)) * 2**28,
            priority=int(rng.integers(0, 4)) * 10, creation_index=200 + g,
            **kw,
        ), str(rng.choice(names)))
    return cache, pending, nom


def _encoded(seed, profile, **kw):
    cache, pending, nom = nominated_cluster(seed, **kw)
    kb = krt.encode_batch(cache.update_snapshot(), pending, profile,
                          nominated=nom.entries())
    kp = krt.score_params(profile, kb.resource_names)
    return cache, pending, nom, kb, kp


def _assert_state(kst, pst):
    for i in range(7):
        if kst[i] is None:
            assert pst[i] is None, i
            continue
        want, got = np.asarray(kst[i]), pst[i].numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), i


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("profile", [KC.Profile(), PORTS_PROFILE],
                         ids=["default", "ports"])
def test_encode_nomination_leaves(seed, profile):
    cache, pending, nom, kb, _ = _encoded(seed, profile)
    pb = prt.encode_batch(
        port_cache(cache).update_snapshot(), [to_port(p) for p in pending],
        to_port(profile), nominated=to_port(nom.entries()), device="cpu",
    )
    assert pb.device.nominated_gate is not None
    assert_batches_equal(port_batch_from_jax(kb.device), pb.device)
    assert pb.port_vocab is not None


def test_stale_nomination_set_raises():
    cache, pending, nom = nominated_cluster(0)
    pc = port_cache(cache)
    snap = pc.update_snapshot()
    entries = to_port(nom.entries())
    sb = prt.encode_batch_static(snap, [to_port(p) for p in pending],
                                 to_port(KC.Profile()), nominated=entries)
    with pytest.raises(prt.StaleStaticEncode):
        prt.finalize_batch(sb, snap, nominated=entries[1:], device="cpu")
    prt.finalize_batch(sb, snap, nominated=entries, device="cpu")


@pytest.mark.parametrize("seed", range(3))
def test_resource_fit_mask_nominated(seed):
    rng = np.random.default_rng(seed)
    P, N, R, G = 9, 13, 3, 7
    args = (
        rng.integers(0, 900, (P, R)) * (rng.random((P, R)) < 0.8),
        rng.integers(1000, 4000, (N, R)),
        rng.integers(0, 2500, (N, R)),
        rng.integers(0, 6, N).astype(np.int32),
        rng.integers(3, 8, N).astype(np.int32),
        rng.random((P, G)) < 0.6,
        rng.integers(-1, N, G).astype(np.int32),
        rng.integers(0, 1500, (G, R)),
    )
    args = tuple(a.astype(np.int64) if a.dtype == np.int64 else a for a in args)
    want = np.asarray(KF.resource_fit_mask_nominated(*(jnp.asarray(a) for a in args)))
    got = PF.resource_fit_mask_nominated(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    assert not want.all() and want.any()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("profile", [KC.Profile(), PORTS_PROFILE],
                         ids=["default", "ports"])
def test_feasible_and_scores_nominated(seed, profile):
    _, _, nom, kb, kp = _encoded(seed, profile)
    pb, pp = port_batch_from_jax(kb.device), port_params(kp)
    rng = np.random.default_rng(seed + 10)
    active = rng.random(len(nom)) < 0.7
    for act in (None, active):
        km, ks = krt.feasible_and_scores(
            kb.device, kp,
            nominated_active=None if act is None else jnp.asarray(act),
        )
        pm, ps = prt.feasible_and_scores(
            pb, pp, nominated_active=None if act is None else torch.from_numpy(act),
        )
        assert np.array_equal(pm.numpy(), np.asarray(km))
        assert np.array_equal(ps.numpy(), np.asarray(ks))
    # the reservations bite: without the nomination leaves some pair passes
    # that fails with them
    bare = prt.DeviceBatch(**{
        **{f: getattr(pb, f) for f in ("nodes",) + prt.POD_FIELDS},
        **{f: None for f in prt.POD_FIELDS if f.startswith("nominated_")},
    })
    free_mask, _ = prt.feasible_and_scores(bare, pp)
    assert (free_mask & ~pm).any()


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("engine", ["greedy", "batched"])
def test_engines_with_nominations(seed, engine):
    _, pending, nom, kb, kp = _encoded(
        seed, KC.Profile(), n_pending=24 + 4 * seed)
    pb, pp = port_batch_from_jax(kb.device), port_params(kp)
    if engine == "greedy":
        ka, kst = k_greedy(kb.device, kp)
        pa, pst = greedy_assign_plain(pb, pp)
    else:
        ka, kst = k_batched(kb.device, kp)
        pa, pst = batched_assign_plain(pb, pp)
    assert np.array_equal(pa.numpy(), np.asarray(ka))
    _assert_state(kst, pst)
    assert pst[6].shape == (len(nom),)


def test_nominee_spends_its_nomination():
    """The greedy loop stops charging a nomination once its own pod is
    assigned, and a lower-priority pod then fits in the room it leaves."""
    cache = Cache()
    cache.add_node(make_node("n0", cpu_milli=1000, memory=2**30))
    nominee = make_pod("nom", cpu_milli=600, priority=100, creation_index=0)
    nom = Nominator()
    nom.add(nominee, "n0")
    low = make_pod("low", cpu_milli=300, priority=0, creation_index=1)
    kb = krt.encode_batch(cache.update_snapshot(), [nominee, low],
                          PORTS_PROFILE, nominated=nom.entries())
    kp = krt.score_params(PORTS_PROFILE, kb.resource_names)
    pa, pst = greedy_assign_plain(port_batch_from_jax(kb.device), port_params(kp))
    assert pa[:2].tolist() == [0, 0]
    assert pst[6].tolist() == [False]
    ka, kst = k_greedy(kb.device, kp)
    assert np.array_equal(pa.numpy(), np.asarray(ka))
    _assert_state(kst, pst)
