"""The port's plain greedy engine equals kubetpu's ``greedy_assign_device``.

Same inputs as the filter/score parity tests, carried across as numpy
leaves: assignments and the final-state slots 0-3 (requested, nonzero
requested, pod count, node ports) must be equal bit for bit; slots 4-6
are None in both (these clusters carry no spread, affinity or
nominations; ``test_torch_podaffinity.py`` holds slot 5 with affinity).
Includes a saturated batch (more pods than capacity: -1s) and an all-ties
batch (identical nodes: the reference's first max).
"""

import numpy as np
import pytest
import torch

import kubetpu  # noqa: F401
from kubetpu.api.wrappers import make_node, make_pod
from kubetpu.assign.greedy import greedy_assign_device as k_greedy
from kubetpu.framework import config as KC
from kubetpu.state.snapshot import Cache

from kubetpu_torch.assign.greedy import greedy_assign_device, greedy_assign_plain

from .cluster_gen import random_cluster
from .torch_port_util import encoded_pair, images_cluster


def _assert_same(kb, kp, pb, pp):
    ka, kst = k_greedy(kb, kp)
    pa, pst = greedy_assign_plain(pb, pp)
    assert pa.dtype == torch.int32
    assert np.array_equal(pa.numpy(), np.asarray(ka))
    for i in range(4):
        want = np.asarray(kst[i])
        got = pst[i].numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), i
    assert all(kst[i] is None and pst[i] is None for i in range(4, 7))
    return pa


@pytest.mark.parametrize("strategy", [
    KC.LEAST_ALLOCATED, KC.MOST_ALLOCATED, KC.REQUESTED_TO_CAPACITY_RATIO,
])
def test_greedy_random_cluster(strategy):
    cache, pending = random_cluster(
        np.random.default_rng(21), num_nodes=40, num_existing=60,
        num_pending=24, with_extended=True, with_taints=True)
    prof = KC.Profile(scoring_strategy=KC.ScoringStrategy(
        type=strategy, shape=((0, 0), (40, 9), (100, 2))))
    _assert_same(*encoded_pair(cache, pending, prof))


def test_greedy_images_affinity():
    cache, pending = images_cluster(np.random.default_rng(22), num_nodes=40,
                                    num_pending=24)
    _assert_same(*encoded_pair(cache, pending, KC.Profile()))


def test_greedy_saturated():
    """More pods than capacity: the tail of the batch gets -1."""
    cache = Cache()
    for i in range(6):
        cache.add_node(make_node(f"n-{i}", cpu_milli=1000, memory=2 * 1024**3,
                                 pods=3))
    pending = [make_pod(f"p-{j}", cpu_milli=400, memory=256 * 1024**2,
                        creation_index=j) for j in range(30)]
    pa = _assert_same(*encoded_pair(cache, pending, KC.Profile()))
    assert (pa[:30] == -1).sum().item() == 30 - 12   # 2 per node fit by cpu
    assert (pa[30:] == -1).all()                     # padded pods


def test_greedy_all_ties_takes_first_max():
    """Identical empty nodes and identical pods: every step's max is a tie;
    both engines take the first max node in snapshot order."""
    cache = Cache()
    for i in range(16):
        cache.add_node(make_node(f"n-{i}", cpu_milli=4000, memory=8 * 1024**3))
    pending = [make_pod(f"p-{j}", cpu_milli=100, memory=128 * 1024**2,
                        creation_index=j) for j in range(16)]
    pa = _assert_same(*encoded_pair(cache, pending, KC.Profile()))
    # each pod lands on the lowest-index node among the emptiest
    assert pa[:16].tolist() == list(range(16))


def test_greedy_device_dispatch_on_cpu():
    """On a CPU batch the engine entry runs the plain version."""
    cache, pending = random_cluster(np.random.default_rng(23), num_nodes=20,
                                    num_existing=20, num_pending=10)
    _, _, pb, pp = encoded_pair(cache, pending, KC.Profile())
    a1, _ = greedy_assign_device(pb, pp)
    a2, _ = greedy_assign_plain(pb, pp)
    assert torch.equal(a1, a2)
