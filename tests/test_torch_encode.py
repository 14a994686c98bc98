"""The port's host encode equals kubetpu's, leaf for leaf.

The same cluster (tests/cluster_gen.py, plus a SchedulingBasic cluster and
one with images and node-affinity preferences) is encoded by kubetpu's
``encode_batch`` and by the port's copy; every DeviceBatch leaf must agree
in presence, dtype, shape and value, padding included.
"""

import dataclasses

import numpy as np
import pytest

import kubetpu  # noqa: F401
from kubetpu.api import types as kt
from kubetpu.api.wrappers import make_pod
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt

from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.state.encoder import round_up

from .cluster_gen import random_cluster
from .torch_port_util import basic_cluster, images_cluster, jax_leaves, port_cache, to_port


CLUSTERS = {
    "random-plain": lambda: random_cluster(np.random.default_rng(0)),
    "random-extended": lambda: random_cluster(
        np.random.default_rng(1), with_extended=True),
    "random-taints": lambda: random_cluster(
        np.random.default_rng(2), with_taints=True),
    "random-all": lambda: random_cluster(
        np.random.default_rng(3), with_extended=True, with_taints=True),
    "images-affinity": lambda: images_cluster(np.random.default_rng(4)),
    "scheduling-basic": basic_cluster,
}


def _encode_both(cache, pending, profile):
    kb = krt.encode_batch(cache.update_snapshot(), pending, profile)
    pb = prt.encode_batch(
        port_cache(cache).update_snapshot(), [to_port(p) for p in pending],
        to_port(profile), device="cpu",
    )
    return kb, pb


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
def test_encode_batch_leaves_equal(cluster):
    cache, pending = CLUSTERS[cluster]()
    kb, pb = _encode_both(cache, pending, KC.Profile())
    _assert_encoded_equal(kb, pb)


def _assert_encoded_equal(kb, pb):
    want = jax_leaves(kb.device)
    got = prt.batch_leaves(pb.device)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert (g is None) == (w is None), name
        if w is None:
            continue
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype, name
        assert g.shape == w.shape, name
        assert np.array_equal(g, w), name
    assert pb.node_names == kb.node_names
    assert pb.resource_names == kb.resource_names
    assert (pb.num_nodes, pb.num_pods) == (kb.num_nodes, kb.num_pods)


@pytest.mark.parametrize("strategy", [
    KC.LEAST_ALLOCATED, KC.MOST_ALLOCATED, KC.REQUESTED_TO_CAPACITY_RATIO,
])
def test_score_params_equal(strategy):
    prof = KC.Profile(scoring_strategy=KC.ScoringStrategy(
        type=strategy, shape=((0, 0), (50, 7), (100, 2))))
    names = ["cpu", "memory", "ephemeral-storage", "example.com/foo"]
    want = dataclasses.asdict(krt.score_params(prof, names))
    got = dataclasses.asdict(prt.score_params(to_port(prof), names))
    assert got == want


def test_scheduling_basic_shapes():
    """The headline workload's leaves: which are present, which are None."""
    cache, pending = basic_cluster()
    _, pb = _encode_both(cache, pending, KC.Profile())
    b = pb.device
    assert b.static_mask is None and b.image_sum_scores is None
    assert b.node_affinity_raw is not None and b.taint_prefer_raw is not None
    assert tuple(b.alloc.shape) == (round_up(100), 3)
    assert tuple(b.requests.shape) == (round_up(40), 3)
    assert b.node_valid.sum().item() == 100 and b.pod_valid.sum().item() == 40
    assert b.pod_ports.shape[1] == 1 and b.port_conflict.shape == (1, 1)


def test_device_batch_is_one_upload():
    """Every tensor leaf is a view of one buffer (one host→device copy)."""
    cache, pending = random_cluster(np.random.default_rng(5), with_extended=True)
    _, pb = _encode_both(cache, pending, KC.Profile())
    leaves = [v for v in prt.batch_leaves(pb.device).values() if v is not None]
    bases = {v.untyped_storage().data_ptr() for v in leaves}
    assert len(bases) == 1
    assert all(v.is_contiguous() for v in leaves)
    assert pb.upload_bytes == sum(int(v.nbytes) for v in leaves)


def test_out_of_slice_pods_raise():
    """Pods that earlier slices refused now encode as kubetpu's do: a pod
    whose resource claim and a pod whose PVC do not exist (both rejected on
    every node by their static rows), and a spread pod."""
    cache, pending = basic_cluster(num_nodes=8, num_bound=0, num_pending=2)
    spread = make_pod("s", cpu_milli=100, spread=[kt.TopologySpreadConstraint(
        max_skew=1, topology_key="zone",
        when_unsatisfiable=kt.UnsatisfiableConstraintAction.DO_NOT_SCHEDULE,
        selector=kt.LabelSelector.of({"a": "b"}))])
    claim = make_pod("c", cpu_milli=100, claims=("x",))
    pvc = make_pod("v", cpu_milli=100, pvcs=("x",))
    snap = port_cache(cache).update_snapshot()
    for pod in (claim, pvc):
        kb, pb = _encode_both(cache, [pod], KC.Profile())
        _assert_encoded_equal(kb, pb)
        assert pb.device.static_mask is not None
        assert not pb.device.static_mask[pb.device.static_sig[0].long()].any()
    # topology spread is in the port since its third slice: it encodes
    b = prt.encode_batch(snap, [to_port(spread)], to_port(KC.Profile()), device="cpu")
    assert b.device.spread is not None and b.device.spread.has_hard
