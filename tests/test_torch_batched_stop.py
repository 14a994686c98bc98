"""The batched engine's stop rule, colliding tie groups and later-row
rejections: the port's plain rounds equal kubetpu's, bit for bit.

These are the batches the batched solve (``kernels/csrc/batched_round.cu``)
is held to on the card (``chip_smoke.py`` phase 3). Here the port's plain
rounds (``batched_assign_plain``; over a sharded batch
``batched_assign_tiled_plain``, through ``batched_assign_device``) meet
kubetpu's ``batched_assign_device`` and ``parallel.sharded_batched``,
unsharded, on two node shards and on a 2 x 2 pods x nodes grid (kubetpu's
virtual CPU devices, ``tests/conftest.py``): the assignments, the seven
state slots and the round count. Three kinds of batch:

- a hotspot that takes one round a pod, stopped at ``max_rounds`` 1, 2 and
  P, and the same batch with no pod valid (no round at all);
- extender rows built so that tie groups collide on one group key: two
  pods whose tie hash equals their best score shifted left by one (key 0,
  the key every inactive pod sorts with), behind an invalid pod, and two
  pods with different tie sets and best scores but one key. kubetpu ranks
  every pod in its stable sort of (key, pod); a rank that counted only
  the active pods of a key would send the two key-0 pods to each other's
  nodes;
- identical pods outnumbering identical nodes, whose first rejection falls
  in the second pod row of the grid.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import kubetpu  # noqa: F401
from kubetpu.api.wrappers import make_node, make_pod
from kubetpu.assign.batched import batched_assign_device as k_batched
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.parallel import make_mesh as k_make_mesh
from kubetpu.parallel import make_mesh_2d as k_make_mesh_2d
from kubetpu.parallel import sharded_batched as k_sharded_batched
from kubetpu.state.snapshot import Cache

from kubetpu_torch.assign.batched import (
    batched_assign_device,
    batched_assign_plain,
    tie_weights,
)
from kubetpu_torch.parallel import mesh as M

from .test_torch_mesh import _assert_result
from .torch_port_util import port_batch_from_jax, port_params

LAYOUTS = ["unsharded", "2 shards", "2x2 grid"]

# the NodeResourcesFit filter and no score plugin: a pod's total is its
# extender score alone
FIT_ONLY = KC.Profile(
    filters=KC.PluginSet(enabled=((KC.NODE_RESOURCES_FIT, 1),)),
    scores=KC.PluginSet(enabled=()),
    default_spread_constraints=(),
)


def _encode(cache, pending, profile):
    kb = krt.encode_batch(cache.update_snapshot(), pending, profile)
    return kb.device, krt.score_params(profile, kb.resource_names)


def _run(layout, kb, kp, max_rounds=0):
    """kubetpu's engine and the port's plain rounds on one layout. Returns
    (kubetpu's result, the port's, the port's rounds)."""
    pb, pp = port_batch_from_jax(kb), port_params(kp)
    rounds: list = []
    if layout == "unsharded":
        want = k_batched(kb, kp, max_rounds=max_rounds)
        got = batched_assign_plain(pb, pp, max_rounds=max_rounds, rounds_out=rounds)
        return want, got, rounds[0]
    if layout == "2 shards":
        kmesh, mesh = k_make_mesh(jax.devices()[:2]), M.make_mesh(["cpu"] * 2)
    else:
        kmesh = k_make_mesh_2d(jax.devices()[:4], pods=2)
        mesh = M.make_mesh_2d(["cpu"] * 4, pods=2)
    want = k_sharded_batched(kb, kp, kmesh, max_rounds=max_rounds)
    sb = M.shard_batch(pb, mesh)
    got = batched_assign_device(sb, pp, max_rounds=max_rounds, rounds_out=rounds)
    # the unsharded plain rounds stop alike
    ref: list = []
    batched_assign_plain(pb, pp, max_rounds=max_rounds, rounds_out=ref)
    assert rounds == ref
    return want, got, rounds[0]


def _hotspot():
    """tests/test_torch_batched.py's hotspot: every pod fits one node only,
    so one pod binds a round."""
    cache = Cache()
    for i in range(4):
        cache.add_node(make_node(f"n{i}", cpu_milli=10000))
    pending = [make_pod(f"p{j}", cpu_milli=100, node_name="n2", creation_index=j)
               for j in range(12)]
    profile = KC.Profile(
        filters=KC.PluginSet(enabled=((KC.NODE_NAME, 1), (KC.NODE_RESOURCES_FIT, 1))),
        scores=KC.PluginSet(enabled=((KC.NODE_RESOURCES_FIT, 1),)),
        default_spread_constraints=(),
    )
    return _encode(cache, pending, profile)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("stop", ["1", "2", "P", "no pod valid"])
def test_stop_rule(layout, stop):
    kb, kp = _hotspot()
    P = kb.requests.shape[0]
    max_rounds = {"1": 1, "2": 2, "P": P, "no pod valid": 0}[stop]
    if stop == "no pod valid":
        kb = dataclasses.replace(kb, pod_valid=jnp.zeros_like(kb.pod_valid))
    want, got, rounds = _run(layout, kb, kp, max_rounds)
    _assert_result(want, got)
    assigned = int((got[0].cpu() >= 0).sum())
    if stop == "no pod valid":
        assert rounds == 0 and assigned == 0
    elif stop == "P":
        assert rounds == 12 and assigned == 12
    else:
        assert rounds == max_rounds and assigned == max_rounds


def _weights(n):
    return tie_weights(n, "cpu").tolist()


def _collision_batch():
    """Eight nodes and eight pods with crafted extender rows (every pod a
    class of its own): pod 0 invalid; pods 1 and 2 tie on nodes 1 and 3 at
    half their tie hash (their group key is 0); pods 3 and 4 tie on node 5
    and on nodes 4 and 6, at best scores chosen to give them one nonzero
    key; pod 5 invalid; pod 6 as pod 1 (it chooses a node pod 2 took and is
    rejected, so pod 7 waits a round); pod 7 ties on nodes 0 and 2."""
    cache = Cache()
    for i in range(8):
        cache.add_node(make_node(f"n{i}", cpu_milli=4000, memory=8 * 1024**3))
    pending = [make_pod(f"p{j}", cpu_milli=100, memory=64 * 1024**2, creation_index=j)
               for j in range(8)]
    kb, kp = _encode(cache, pending, FIT_ONLY)
    P, N = kb.requests.shape[0], kb.alloc.shape[0]
    w = _weights(N)
    mask = np.zeros((P, N), dtype=bool)
    score = np.zeros((P, N), dtype=np.int64)

    def row(p, ties, best):
        mask[p, ties] = True
        score[p, ties] = best

    h13 = w[1] + w[3]
    assert h13 % 2 == 0
    for p in (1, 2, 6):
        row(p, [1, 3], h13 // 2)            # hash ^ (best << 1) == 0
    key = w[5] ^ (100 << 1)
    h46 = w[4] + w[6]
    assert (key ^ h46) % 2 == 0
    row(3, [5], 100)
    row(4, [4, 6], (key ^ h46) >> 1)        # the same key as pod 3's
    row(7, [0, 2], 7)
    valid = np.asarray(kb.pod_valid).copy()
    valid[[0, 5]] = False
    kb = dataclasses.replace(kb, pod_valid=jnp.asarray(valid),
                             extender_mask=jnp.asarray(mask), extender_score=jnp.asarray(score))
    return kb, kp


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tie_groups_collide_on_one_key(layout):
    kb, kp = _collision_batch()
    want, got, rounds = _run(layout, kb, kp)
    _assert_result(want, got)
    a = got[0].cpu().tolist()
    # pods 1 and 2 rank 1 and 2 in key 0's group (invalid pod 0 counts):
    # pod 1 takes the second tie node, pod 2 the first; pod 4 ranks 1 in
    # pod 3's group and takes its second tie node; pod 6 (rank 4) chooses
    # pod 2's node and is rejected, and takes it the round after, with pod 7
    assert a[:8] == [-1, 3, 1, 5, 6, -1, 1, 0]
    assert rounds == 2


def _crowd():
    """Five identical empty nodes and eight identical pods, one a node:
    the first round's ranks 0-4 take the five nodes and pod 5 (rank 5)
    chooses node 0 again, behind pod 0."""
    cache = Cache()
    for i in range(5):
        cache.add_node(make_node(f"n{i}", cpu_milli=1000, memory=8 * 1024**3))
    pending = [make_pod(f"p{j}", cpu_milli=600, memory=128 * 1024**2, creation_index=j)
               for j in range(8)]
    return _encode(cache, pending, KC.Profile())


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("max_rounds", [1, 0])
def test_rejection_in_a_later_pod_row(layout, max_rounds):
    kb, kp = _crowd()
    P = kb.requests.shape[0]
    assert P == 8          # pod row 1 of the 2 x 2 grid holds pods 4-7
    want, got, rounds = _run(layout, kb, kp, max_rounds)
    _assert_result(want, got)
    a = got[0].cpu().tolist()
    # pod 4 (pod row 1) commits before the rejection; pods 5-7 wait, then
    # fit nowhere
    assert sorted(a[:5]) == [0, 1, 2, 3, 4] and a[5:] == [-1, -1, -1]
    assert rounds == (1 if max_rounds == 1 else 2)
