"""The port's plain Filter+Score equals kubetpu's, bit for bit.

Seeded small clusters (about 24 pods × 40 nodes) with an extended resource,
host ports, node selectors, taints and tolerations, images, node-affinity
preferences and padding go through kubetpu's ``filter_score_batch`` and the
port's, under each scoring strategy; the inputs cross as numpy leaves
(``device_batch_from_numpy``). The component functions of ``ops`` are held
to kubetpu's on seeded arrays. Tolerance: exact (bool masks, int64 scores).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubetpu  # noqa: F401
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.ops import filters as KF
from kubetpu.ops import scores as KS

from kubetpu_torch import kernels
from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.ops import filters as PF
from kubetpu_torch.ops import scores as PS

from .cluster_gen import random_cluster
from .torch_port_util import encoded_pair, images_cluster

STRATEGIES = {
    "least": KC.ScoringStrategy(type=KC.LEAST_ALLOCATED),
    "most": KC.ScoringStrategy(type=KC.MOST_ALLOCATED),
    # a decreasing segment: Go's truncating division on negative slopes
    "rtcr": KC.ScoringStrategy(
        type=KC.REQUESTED_TO_CAPACITY_RATIO,
        shape=((0, 0), (40, 9), (100, 2))),
}

CLUSTERS = {
    "ports-extended-taints": lambda seed: random_cluster(
        np.random.default_rng(seed), num_nodes=40, num_existing=60,
        num_pending=24, with_extended=True, with_taints=True),
    "images-affinity": lambda seed: images_cluster(
        np.random.default_rng(seed), num_nodes=40, num_pending=24),
}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    g = got.numpy()
    assert g.dtype == want.dtype
    assert g.shape == want.shape
    assert np.array_equal(g, want)


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("seed", [11, 12])
def test_filter_score_batch_equal(cluster, strategy, seed):
    cache, pending = CLUSTERS[cluster](seed)
    prof = KC.Profile(scoring_strategy=STRATEGIES[strategy])
    kb, kp, pb, pp = encoded_pair(cache, pending, prof)
    km, ks = krt.filter_score_batch(kb, kp)
    pm, ps = prt.filter_score_batch(pb, pp)
    _eq(pm, km)
    _eq(ps, ks)
    # the padded pod rows and node columns are infeasible
    assert not pm[~pb.pod_valid].any() and not pm[:, ~pb.node_valid].any()


def test_filter_score_batch_three_balanced_resources():
    """Balanced allocation over three resources (the population-std branch)
    inside the full composition."""
    cache, pending = random_cluster(np.random.default_rng(15), num_nodes=40,
                                    num_pending=24, with_extended=True)
    prof = KC.Profile(balanced_resources=(
        ("cpu", 1), ("memory", 1), ("example.com/foo", 1)))
    kb, kp, pb, pp = encoded_pair(cache, pending, prof)
    km, ks = krt.filter_score_batch(kb, kp)
    pm, ps = prt.filter_score_batch(pb, pp)
    _eq(pm, km)
    _eq(ps, ks)


def test_filter_score_batch_minimal_profile():
    cache, pending = random_cluster(np.random.default_rng(13), with_extended=True)
    prof = KC.minimal_profile()
    kb, kp, pb, pp = encoded_pair(cache, pending, prof)
    km, ks = krt.filter_score_batch(kb, kp)
    pm, ps = prt.filter_score_batch(pb, pp)
    _eq(pm, km)
    _eq(ps, ks)


def test_filter_score_kernel_refuses_cpu_tensors():
    """The kernel wrapper launches or raises; it never runs the plain
    version itself (validation happens before any build)."""
    cache, pending = random_cluster(np.random.default_rng(14))
    _, _, pb, pp = encoded_pair(cache, pending, KC.Profile())
    with pytest.raises(ValueError, match="CUDA"):
        kernels.filter_score(pb, pp)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.greedy_scan(pb, pp)


# --------------------------------------------------- component functions
def _node_pod_arrays(rng, P=12, N=20, R=3):
    alloc = rng.integers(0, 9000, size=(N, R)).astype(np.int64)
    alloc[rng.random((N, R)) < 0.1] = 0
    requested = (alloc * rng.random((N, R))).astype(np.int64)
    nonzero = requested + rng.integers(0, 300, size=(N, R))
    pod_req = rng.integers(0, 3000, size=(P, R)).astype(np.int64)
    pod_req[rng.random((P, R)) < 0.3] = 0
    pod_nz = pod_req + rng.integers(0, 200, size=(P, R))
    pod_count = rng.integers(0, 12, size=N).astype(np.int32)
    allowed = rng.integers(0, 12, size=N).astype(np.int32)
    return alloc, requested, nonzero, pod_req, pod_nz, pod_count, allowed


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resource_fit_masks(seed):
    rng = np.random.default_rng(seed)
    alloc, requested, _, pod_req, _, pc, allowed = _node_pod_arrays(rng)
    want = KF.resource_fit_mask(jnp.asarray(pod_req), jnp.asarray(alloc),
                                jnp.asarray(requested), jnp.asarray(pc),
                                jnp.asarray(allowed))
    got = PF.resource_fit_mask(_t(pod_req), _t(alloc), _t(requested), _t(pc), _t(allowed))
    _eq(got, want)
    want1 = KF.resource_fit_mask_single(jnp.asarray(pod_req[3]), jnp.asarray(alloc),
                                        jnp.asarray(requested), jnp.asarray(pc),
                                        jnp.asarray(allowed))
    got1 = PF.resource_fit_mask_single(_t(pod_req[3]), _t(alloc), _t(requested),
                                       _t(pc), _t(allowed))
    _eq(got1, want1)


def test_resource_fit_mask_nominated_is_a_later_slice():
    """Nominations are ported (the name is kept): the nominated fit equals
    kubetpu's on seeded arrays, and with an all-False gate it is the plain
    fit mask."""
    rng = np.random.default_rng(7)
    P, N, R, G = 6, 11, 4, 5
    pod_req = rng.integers(0, 900, (P, R)) * (rng.random((P, R)) < 0.8)
    alloc = rng.integers(1000, 4000, (N, R))
    requested = rng.integers(0, 2500, (N, R))
    pc = rng.integers(0, 6, N).astype(np.int32)
    allowed = rng.integers(3, 8, N).astype(np.int32)
    gate = rng.random((P, G)) < 0.6
    g_node = rng.integers(-1, N, G).astype(np.int32)
    g_req = rng.integers(0, 1500, (G, R))
    args = (pod_req, alloc, requested, pc, allowed, gate, g_node, g_req)
    want = KF.resource_fit_mask_nominated(*(jnp.asarray(a) for a in args))
    _eq(PF.resource_fit_mask_nominated(*(_t(a) for a in args)), want)
    no_gate = (pod_req, alloc, requested, pc, allowed, np.zeros_like(gate), g_node, g_req)
    _eq(PF.resource_fit_mask_nominated(*(_t(a) for a in no_gate)),
        KF.resource_fit_mask(*(jnp.asarray(a) for a in args[:5])))


@pytest.mark.parametrize("fn", ["least_allocated_score", "most_allocated_score"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fit_strategies(fn, seed):
    rng = np.random.default_rng(seed)
    alloc, _, nonzero, _, pod_nz, _, _ = _node_pod_arrays(rng, R=4)
    w = np.array([1, 2, 0, 3], dtype=np.int64)
    scal = np.array([False, False, False, True])
    want = getattr(KS, fn)(jnp.asarray(pod_nz), jnp.asarray(nonzero),
                           jnp.asarray(alloc), jnp.asarray(w), jnp.asarray(scal))
    got = getattr(PS, fn)(_t(pod_nz), _t(nonzero), _t(alloc), _t(w), _t(scal))
    _eq(got, want)


@pytest.mark.parametrize("shape", [
    ((0, 0), (100, 10)),
    ((0, 10), (50, 3), (100, 0)),
    ((10, 2), (30, 9), (70, 1), (90, 5)),
])
def test_requested_to_capacity_ratio(shape):
    rng = np.random.default_rng(3)
    alloc, _, nonzero, _, pod_nz, _, _ = _node_pod_arrays(rng, R=3)
    w = np.array([1, 1, 2], dtype=np.int64)
    scal = np.array([False, False, True])
    xs = np.array([x for x, _ in shape], dtype=np.int64)
    ys = np.array([y * 10 for _, y in shape], dtype=np.int64)
    want = KS.requested_to_capacity_ratio_score(
        jnp.asarray(pod_nz), jnp.asarray(nonzero), jnp.asarray(alloc),
        jnp.asarray(w), jnp.asarray(scal), jnp.asarray(xs), jnp.asarray(ys))
    got = PS.requested_to_capacity_ratio_score(
        _t(pod_nz), _t(nonzero), _t(alloc), _t(w), _t(scal), _t(xs), _t(ys))
    _eq(got, want)


def test_trunc_div_and_broken_linear():
    rng = np.random.default_rng(4)
    a = rng.integers(-500, 500, size=200).astype(np.int64)
    b = rng.integers(-7, 8, size=200).astype(np.int64)
    _eq(PS._trunc_div(_t(a), _t(b)), KS._trunc_div(jnp.asarray(a), jnp.asarray(b)))
    xs = np.array([0, 20, 60, 100], dtype=np.int64)
    ys = np.array([100, 30, 80, 0], dtype=np.int64)
    p = rng.integers(-10, 120, size=(5, 7)).astype(np.int64)
    _eq(PS.broken_linear(_t(p), _t(xs), _t(ys)),
        KS.broken_linear(jnp.asarray(p), jnp.asarray(xs), jnp.asarray(ys)))


@pytest.mark.parametrize("weights", [
    (1, 1, 0),      # the default: exactly two resources, |f1-f2|/2
    (1, 1, 1),      # three: population std
    (0, 1, 0),      # one: std 0
])
def test_balanced_allocation(weights):
    rng = np.random.default_rng(5)
    alloc, requested, _, pod_req, _, _, _ = _node_pod_arrays(rng, R=3)
    pod_req[0] = 0                      # a best-effort pod
    w = np.array(weights, dtype=np.int64)
    scal = np.array([False, False, True])
    want = KS.balanced_allocation_score(
        jnp.asarray(pod_req), jnp.asarray(requested), jnp.asarray(alloc),
        jnp.asarray(w), jnp.asarray(scal))
    got = PS.balanced_allocation_score(
        _t(pod_req), _t(requested), _t(alloc), _t(w), _t(scal))
    _eq(got, want)


@pytest.mark.parametrize("reverse", [False, True])
def test_default_normalize(reverse):
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 50, size=(6, 9)).astype(np.int64)
    raw[2] = 0                          # an all-zero row
    _eq(PS.default_normalize(_t(raw), reverse=reverse),
        KS.default_normalize(jnp.asarray(raw), reverse=reverse))
    mask = rng.random((6, 9)) < 0.6
    _eq(prt.masked_normalize(_t(raw), _t(mask), reverse=reverse),
        krt.masked_normalize(jnp.asarray(raw), jnp.asarray(mask), reverse=reverse))


def test_image_locality():
    rng = np.random.default_rng(7)
    sums = rng.integers(0, 3000, size=(5, 8)).astype(np.int64) * 1024**2
    counts = np.array([0, 1, 2, 3, 1], dtype=np.int32)
    _eq(PS.image_locality_score(_t(sums), _t(counts)),
        KS.image_locality_score(jnp.asarray(sums), jnp.asarray(counts)))
