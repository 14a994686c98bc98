"""The port's InterPodAffinity equals kubetpu's, bit for bit.

Seeded small clusters (at most 48 nodes and 40 pending pods), each built to
exercise one part of the plugin — required affinity, the self-affinity
escape, required anti-affinity, existing pods' anti-affinity, preferred
terms of both signs, a topology key missing on some nodes, several zones,
and a random mix — are encoded by kubetpu and carried across as numpy
leaves. On each, the port's ``affinity_filter_pod`` / ``affinity_score_pod``
(the pod axis written out) equal kubetpu's per-pod functions vmapped over
the pods, on the batch's own sums and on seeded random sums;
``feasible_and_scores`` with the ``podaffinity`` leaf equals kubetpu's
``filter_score_batch``; the plain greedy engine equals kubetpu's
``greedy_assign_device`` in its assignments and all seven state slots,
``pa_sums`` included; and the port's own encoder gives the leaves kubetpu's
gives. Tolerance: exact (bool masks, int64 scores and sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubetpu  # noqa: F401
from kubetpu.api import types as kt
from kubetpu.api.wrappers import make_node, make_pod, pod_affinity_term
from kubetpu.assign.greedy import greedy_assign_device as k_greedy
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.ops import podaffinity as KPA
from kubetpu.state.snapshot import Cache

from kubetpu_torch import kernels
from kubetpu_torch.assign.greedy import greedy_assign_device, greedy_assign_plain
from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.ops import podaffinity as PPA

from .cluster_gen import random_cluster
from .test_podaffinity import add_affinity, affinity_profile
from .torch_port_util import encoded_pair, port_cache, to_port

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def _term(key, app):
    return pod_affinity_term(key, match_labels={"app": app})


def _req_aff(key, app):
    return kt.Affinity(pod_affinity=kt.PodAffinity(required=(_term(key, app),)))


def _req_anti(key, app):
    return kt.Affinity(pod_anti_affinity=kt.PodAffinity(required=(_term(key, app),)))


def _pref(key, app, weight, anti=False):
    pa = kt.PodAffinity(preferred=(kt.WeightedPodAffinityTerm(weight, _term(key, app)),))
    return kt.Affinity(pod_anti_affinity=pa) if anti else kt.Affinity(pod_affinity=pa)


def _cluster(rng, n_nodes=24, zones=3, zone_missing=0.0, existing=()):
    """Nodes in ``zones`` zones (a share without the zone label), and the
    ``existing`` (labels, affinity) pods bound at random."""
    cache = Cache()
    nodes = []
    for i in range(n_nodes):
        labels = {HOST: f"n{i}"}
        if rng.random() >= zone_missing:
            labels[ZONE] = f"z{i % zones}"
        node = make_node(f"n{i}", cpu_milli=int(rng.integers(2000, 8001)),
                         memory=int(rng.integers(4, 32)) * 1024**3, pods=20,
                         labels=labels)
        nodes.append(node)
        cache.add_node(node)
    for j, (app, aff) in enumerate(existing):
        node = nodes[int(rng.integers(0, n_nodes))]
        cache.add_pod(make_pod(f"e{j}", cpu_milli=100, labels={"app": app},
                               affinity=aff, node_name=node.name))
    return cache


def _pending(rng, specs):
    return [
        make_pod(f"p{j}", cpu_milli=int(rng.integers(100, 1500)),
                 memory=int(rng.integers(0, 4)) * 512 * 1024**2,
                 labels={"app": app}, affinity=aff, creation_index=j)
        for j, (app, aff) in enumerate(specs)
    ]


def case_required(rng):
    cache = _cluster(rng, existing=[("web", None)] * 3 + [("db", None)] * 5)
    return cache, _pending(rng, [(str(rng.choice(["web", "x"])),
                                  _req_aff(ZONE, str(rng.choice(["web", "db"]))))
                                 for _ in range(20)])


def case_self_escape(rng):
    """No pod runs app=fresh: a fresh pod asking for fresh pods matches its
    own term and escapes; one asking for app=none does not."""
    cache = _cluster(rng, existing=[("web", None)] * 6)
    specs = [("fresh", _req_aff(ZONE, "fresh"))] * 12 + [("web", _req_aff(ZONE, "none"))] * 4
    return cache, _pending(rng, specs)


def case_anti(rng):
    cache = _cluster(rng, n_nodes=16, existing=[("web", None)] * 6 + [("db", None)] * 4)
    specs = [("web", _req_anti(str(rng.choice([ZONE, HOST])), str(rng.choice(["web", "db"]))))
             for _ in range(24)]
    return cache, _pending(rng, specs)


def case_existing_anti(rng):
    cache = _cluster(rng, existing=[("db", _req_anti(HOST, "web"))] * 8
                     + [("cache", _req_anti(ZONE, "db"))] * 2)
    specs = [(str(rng.choice(["web", "db", "x"])), None) for _ in range(24)]
    return cache, _pending(rng, specs)


def case_preferred(rng):
    cache = _cluster(rng, existing=[(str(rng.choice(["web", "db"])),
                                     _pref(ZONE, "web", int(rng.integers(1, 100)),
                                           anti=bool(rng.random() < 0.5)))
                                    for _ in range(12)])
    specs = [(str(rng.choice(["web", "db"])),
              _pref(str(rng.choice([ZONE, HOST])), str(rng.choice(["web", "db"])),
                    int(rng.integers(1, 100)), anti=bool(rng.random() < 0.5)))
             for _ in range(24)]
    return cache, _pending(rng, specs)


def case_missing_key(rng):
    cache = _cluster(rng, zone_missing=0.35, existing=[("web", None)] * 8)
    specs = [(str(rng.choice(["web", "db"])),
              [_req_aff(ZONE, "web"), _req_anti(ZONE, "db"),
               _pref(ZONE, "web", 50)][int(rng.integers(0, 3))])
             for _ in range(20)]
    return cache, _pending(rng, specs)


def case_random(rng):
    cache, pending = random_cluster(rng, num_nodes=32, num_existing=50, num_pending=30)
    pending = add_affinity(rng, pending)
    # assigned pods carrying affinity too
    for j, p in enumerate(add_affinity(rng, [make_pod(f"a{j}", cpu_milli=50,
                                                      labels={"app": "web"})
                                             for j in range(8)])):
        cache.add_pod(p.with_node(f"node-{j}"))
    return cache, pending


CASES = {
    "required": case_required,
    "self-escape": case_self_escape,
    "anti": case_anti,
    "existing-anti": case_existing_anti,
    "preferred": case_preferred,
    "missing-key": case_missing_key,
    "random": case_random,
}
PROFILES = {"default": KC.Profile, "interpod": affinity_profile}


def _pair(case, seed, profile="default"):
    cache, pending = CASES[case](np.random.default_rng(seed))
    kb, kp, pb, pp = encoded_pair(cache, pending, PROFILES[profile]())
    assert kb.podaffinity is not None and pb.podaffinity is not None
    return kb, kp, pb, pp


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    g = got.numpy()
    assert g.dtype == want.dtype and g.shape == want.shape
    assert np.array_equal(g, want)


def _k_ops(pa, sums, mask=None):
    """kubetpu's per-pod affinity functions vmapped over the pods."""
    ok = jax.vmap(lambda fr, fs, rr, er: KPA.affinity_filter_pod(pa, sums, fr, fs, rr, er))(
        pa.fa_rows, pa.fa_self, pa.ra_rows, pa.ea_rows)
    m = ok if mask is None else jnp.asarray(mask)
    sc = jax.vmap(lambda sr, sv, mm: KPA.affinity_score_pod(pa, sums, sr, sv, mm))(
        pa.score_rows, pa.score_vals, m)
    return ok, sc


def _p_ops(pa, sums, mask=None):
    ok = PPA.affinity_filter_pod(pa, sums, pa.fa_rows, pa.fa_self, pa.ra_rows, pa.ea_rows)
    m = ok if mask is None else torch.from_numpy(np.asarray(mask))
    return ok, PPA.affinity_score_pod(pa, sums, pa.score_rows, pa.score_vals, m)


@pytest.mark.parametrize("case", sorted(CASES))
def test_affinity_ops_on_base_sums(case):
    kb, _, pb, _ = _pair(case, 31)
    kok, ksc = _k_ops(kb.podaffinity, kb.podaffinity.base_sums)
    pok, psc = _p_ops(pb.podaffinity, pb.podaffinity.base_sums)
    _eq(pok, kok)
    _eq(psc, ksc)
    assert pb.podaffinity.has_filter_work or pb.podaffinity.has_score_work


@pytest.mark.parametrize("case", sorted(CASES))
def test_affinity_ops_on_random_sums_and_mask(case):
    """Seeded sums (zero rows included, so the escape both fires and not)
    and a seeded feasibility mask (empty rows included)."""
    kb, _, pb, _ = _pair(case, 32)
    rng = np.random.default_rng(33)
    shape = kb.podaffinity.base_sums.shape
    sums = rng.integers(0, 3, size=shape).astype(np.int64)
    sums[rng.random(shape[0]) < 0.3] = 0
    mask = rng.random((kb.requests.shape[0], kb.alloc.shape[0])) < 0.7
    mask[0] = False
    kok, ksc = _k_ops(kb.podaffinity, jnp.asarray(sums), mask)
    pok, psc = _p_ops(pb.podaffinity, torch.from_numpy(sums), mask)
    _eq(pok, kok)
    _eq(psc, ksc)


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_feasible_and_scores_with_affinity(case, profile):
    kb, kp, pb, pp = _pair(case, 34, profile)
    km, ks = krt.filter_score_batch(kb, kp)
    pm, ps = prt.feasible_and_scores(pb, pp)
    _eq(pm, km)
    _eq(ps, ks)
    # filter_score_batch is the same function on a CPU batch
    fm, fs = prt.filter_score_batch(pb, pp)
    assert torch.equal(fm, pm) and torch.equal(fs, ps)


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_with_affinity_all_state_slots(case, profile):
    kb, kp, pb, pp = _pair(case, 35, profile)
    ka, kst = k_greedy(kb, kp)
    pa, pst = greedy_assign_plain(pb, pp)
    _eq(pa, ka)
    for i in (0, 1, 2, 3, 5):
        _eq(pst[i], kst[i])
    assert kst[4] is None and pst[4] is None and kst[6] is None and pst[6] is None
    da, _ = greedy_assign_device(pb, pp)
    assert torch.equal(da, pa)


def test_self_escape_places_then_colocates():
    """The first fresh pod escapes onto the best node; every later one must
    follow it into its zone (the sums moved under it)."""
    kb, kp, pb, pp = _pair("self-escape", 36)
    pa, pst = greedy_assign_plain(pb, pp)
    zone_of = pb.podaffinity.node_domain
    fresh = [int(pa[j]) for j in range(12)]
    assert all(n >= 0 for n in fresh)
    rows = (pb.podaffinity.fa_rows[0] >= 0).nonzero().flatten()
    r = int(pb.podaffinity.fa_rows[0, rows[0]])
    assert len({int(zone_of[r, n]) for n in fresh}) == 1
    assert (pa[12:16] == -1).all()            # app=none: nothing matches
    _eq(pa, k_greedy(kb, kp)[0])


@pytest.mark.parametrize("case", ["random", "missing-key", "existing-anti"])
def test_port_encoder_gives_kubetpu_leaves(case):
    """The port's own encode (its copy of state/podaffinity and the
    template groups) gives the affinity leaves kubetpu's gives."""
    cache, pending = CASES[case](np.random.default_rng(37))
    kb = krt.encode_batch(cache.update_snapshot(), pending, KC.Profile())
    pb = prt.encode_batch(port_cache(cache).update_snapshot(),
                          [to_port(p) for p in pending], to_port(KC.Profile()),
                          device="cpu")
    kpa = jax.device_get(kb.device.podaffinity)
    ppa = pb.device.podaffinity
    for f in prt.PA_FIELDS:
        _eq(getattr(ppa, f), getattr(kpa, f))
    assert ppa.has_filter_work == kpa.has_filter_work
    assert ppa.has_score_work == kpa.has_score_work
    # still one upload, the affinity leaves in the same buffer
    leaves = [v for v in prt.batch_leaves(pb.device).values()
              if isinstance(v, torch.Tensor)]
    leaves += [getattr(ppa, f) for f in prt.PA_FIELDS]
    assert len({v.untyped_storage().data_ptr() for v in leaves}) == 1
    assert pb.upload_bytes == sum(int(v.nbytes) for v in leaves)


def test_affinity_free_batch_has_no_leaf():
    """The affinity-free fast path: no pending or assigned pod carries
    affinity, so no podaffinity leaf is built."""
    cache = _cluster(np.random.default_rng(38), existing=[("web", None)] * 4)
    pending = _pending(np.random.default_rng(39), [("web", None)] * 4)
    pb = prt.encode_batch(port_cache(cache).update_snapshot(),
                          [to_port(p) for p in pending], to_port(KC.Profile()),
                          device="cpu")
    assert pb.device.podaffinity is None


def test_kernel_wrappers_refuse_cpu_affinity_batches():
    """The wrappers launch or raise; they never run the plain version."""
    _, _, pb, pp = _pair("random", 40)
    for fn in (kernels.filter_score, kernels.greedy_scan, kernels.batched_assign):
        with pytest.raises(ValueError, match="CUDA"):
            fn(pb, pp)


def test_pod_view_narrows_affinity_slots():
    from kubetpu_torch.assign.greedy import _pod_view

    _, _, pb, _ = _pair("random", 41)
    v = _pod_view(pb, 3)
    pa, va = pb.podaffinity, v.podaffinity
    for f in ("update", "fa_rows", "fa_self", "ra_rows", "ea_rows",
              "score_rows", "score_vals"):
        assert torch.equal(getattr(va, f), getattr(pa, f)[3:4])
    for f in ("node_domain", "has_key", "base_sums"):
        assert getattr(va, f) is getattr(pa, f)
