"""The port's topology coordinates and slice-alignment functions (B12)
against kubetpu's.

``state.topology.topology_tensors`` on the same clusters (dense remap,
unlabeled rows, padded capacity, a cluster without slice labels, the memo
dropped when a node object is replaced), the ``topology`` leaf the port's
encode attaches (on, auto and off, on labeled and unlabeled clusters), and
``ops.topology``'s four functions on seeded inputs (unassigned and padded
pods, unlabeled nodes, ``num_slices`` 0, 1 and 5). Exact everywhere.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp

from kubetpu.api.wrappers import make_node, make_pod
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.ops import topology as KT
from kubetpu.perf import workloads as KW
from kubetpu.state import encode_snapshot as k_encode_snapshot
from kubetpu.state.snapshot import Cache
from kubetpu.state.topology import RACK_KEY, SLICE_KEY
from kubetpu.state.topology import topology_tensors as k_topology_tensors

from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.ops import topology as PT
from kubetpu_torch.state import encode_snapshot as p_encode_snapshot
from kubetpu_torch.state.topology import topology_tensors as p_topology_tensors

from .torch_port_util import assert_batches_equal, port_batch_from_jax, port_cache


def _sliced_cache(n_nodes=20, slices=4, unlabeled=(3, 11), racks=True):
    cache = Cache()
    for i in range(n_nodes):
        labels = {"zone": f"z{i % 3}"}
        if i not in unlabeled:
            labels.update(KW.trace_topology_labels(f"node-{i}", slices))
            if not racks:
                labels.pop(RACK_KEY)
        cache.add_node(make_node(f"node-{i}", cpu_milli=4000, labels=labels))
    return cache


def _same_tensors(kt_, pt_):
    assert np.array_equal(kt_.slice_id, pt_.slice_id)
    assert np.array_equal(kt_.rack_id, pt_.rack_id)
    assert kt_.slice_id.dtype == pt_.slice_id.dtype == np.int32
    assert (kt_.num_slices, kt_.num_racks) == (pt_.num_slices, pt_.num_racks)
    assert kt_.slice_names == pt_.slice_names
    assert kt_.rack_names == pt_.rack_names
    assert kt_.labeled == pt_.labeled


@pytest.mark.parametrize("slices,racks", [(4, True), (7, False), (1, True)])
def test_topology_tensors_equal_reference(slices, racks):
    cache = _sliced_cache(slices=slices, racks=racks)
    knt = k_encode_snapshot(cache.update_snapshot(), pad_nodes=32)
    pnt = p_encode_snapshot(port_cache(cache).update_snapshot(), pad_nodes=32)
    kt_, pt_ = k_topology_tensors(knt), p_topology_tensors(pnt)
    _same_tensors(kt_, pt_)
    # unlabeled rows and the padded capacity read as the unlabeled bucket
    assert (pt_.slice_id[[3, 11]] == pt_.num_slices).all()
    assert (pt_.slice_id[20:] == pt_.num_slices).all()
    assert p_topology_tensors(pnt) is pt_            # memo hit


def test_unlabeled_cluster_has_no_slices():
    cache = Cache()
    for i in range(5):
        cache.add_node(make_node(f"n{i}", labels={"zone": "z1"}))
    knt = k_encode_snapshot(cache.update_snapshot())
    pnt = p_encode_snapshot(port_cache(cache).update_snapshot())
    kt_, pt_ = k_topology_tensors(knt), p_topology_tensors(pnt)
    _same_tensors(kt_, pt_)
    assert not pt_.labeled and pt_.num_slices == 0


def test_memo_dropped_when_a_node_object_is_replaced():
    """The port's encoder clears ``topo_memo`` where the reference's
    ``_refresh_tensors`` does: a replaced node object may carry other
    labels."""
    cache = Cache()
    cache.add_node(make_node("a0", labels={SLICE_KEY: "s0"}))
    pc = port_cache(cache)
    snap = pc.update_snapshot()
    nt = p_encode_snapshot(snap)
    tt1 = p_topology_tensors(nt)
    from kubetpu_torch.api.wrappers import make_node as p_make_node

    pc.add_node(p_make_node("a0", labels={SLICE_KEY: "s1"}))
    snap = pc.update_snapshot(snap)
    nt = p_encode_snapshot(snap, prev=nt)
    tt2 = p_topology_tensors(nt)
    assert tt2 is not tt1 and tt2.slice_names == ("s1",)


@pytest.mark.parametrize("labeled", [True, False])
@pytest.mark.parametrize("mode", ["on", "auto", "off"])
def test_encode_attaches_the_topology_leaf(mode, labeled):
    """The port's encode with ``topology=mode`` gives kubetpu's batch leaf
    for leaf, the ``topology`` leaf included (present only when the mode
    is active and some node is labeled)."""
    cache = _sliced_cache(slices=4 if labeled else 0)
    pending = [make_pod(f"p{j}", cpu_milli=300, creation_index=j) for j in range(5)]
    kb = krt.encode_batch(cache.update_snapshot(), pending, KC.Profile(),
                          topology=mode)
    want = port_batch_from_jax(kb.device)
    got = prt.encode_batch(port_cache(cache).update_snapshot(),
                           [_port_pod(p) for p in pending],
                           _port_profile(), device="cpu", topology=mode).device
    assert (got.topology is not None) == (mode != "off" and labeled)
    assert_batches_equal(got, want)


def _port_pod(p):
    from .torch_port_util import to_port

    return to_port(p)


def _port_profile():
    from kubetpu_torch.framework import config as PC

    return PC.Profile()


def _b12_inputs(seed, num_slices, n=24, p=16):
    rng = np.random.default_rng(seed)
    slice_id = rng.integers(0, num_slices + 1, n).astype(np.int32)
    assignments = rng.integers(-1, n, p).astype(np.int32)
    pod_valid = np.ones(p, dtype=bool)
    pod_valid[-3:] = False                          # padded pods
    requested = rng.integers(0, 3, (n, 3)).astype(np.int64) * (
        rng.random((n, 1)) < 0.5)
    node_valid = rng.random(n) < 0.8
    return assignments, pod_valid, slice_id, requested, node_valid


@pytest.mark.parametrize("num_slices", [0, 1, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_b12_functions_equal_reference(seed, num_slices):
    a, pv, sid, req, nv = _b12_inputs(seed, num_slices)
    ka, kpv, ksid = jnp.asarray(a), jnp.asarray(pv), jnp.asarray(sid)
    ta, tpv, tsid = torch.from_numpy(a), torch.from_numpy(pv), torch.from_numpy(sid)

    want = np.asarray(KT.slice_counts(ka, kpv, ksid, num_slices))
    got = PT.slice_counts(ta, tpv, tsid, num_slices)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)

    for w, g in zip(KT.alignment_score(ka, kpv, ksid, num_slices),
                    PT.alignment_score(ta, tpv, tsid, num_slices)):
        assert g.dtype == torch.int32 and int(g) == int(w)

    kr, knv = jnp.asarray(req), jnp.asarray(nv)
    tr, tnv = torch.from_numpy(req), torch.from_numpy(nv)
    for w, g in zip(KT.slice_occupancy(kr, knv, ksid, num_slices),
                    PT.slice_occupancy(tr, tnv, tsid, num_slices)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    got = PT.free_slices(tr, tnv, tsid, num_slices)
    assert got.dtype == torch.int32
    assert int(got) == int(KT.free_slices(kr, knv, ksid, num_slices))


def test_b12_known_values():
    """The reference test's hand-worked cases (tests/test_topology.py
    TestAlignmentKernels) on the port's functions."""
    sid = torch.tensor([0, 0, 1, 2], dtype=torch.int32)
    valid = torch.ones(3, dtype=torch.bool)
    counts = PT.slice_counts(torch.tensor([0, 1, 2, -1]),
                             torch.ones(4, dtype=torch.bool), sid, 2)
    assert counts.tolist() == [2, 1, 0]
    for a, want in (([0, 0, 1], (9, 0, 1)), ([0, 1, 2], (5, 4, 2)),
                    ([3, 3, 3], (0, 0, 0))):
        got = PT.alignment_score(torch.tensor(a), valid, sid, 2)
        assert tuple(int(x) for x in got) == want
    busy = torch.tensor([[100], [0], [0], [0]], dtype=torch.int64)
    nv = torch.ones(4, dtype=torch.bool)
    assert int(PT.free_slices(busy, nv, sid, 2)) == 1
    assert int(PT.free_slices(torch.zeros_like(busy), nv, sid, 2)) == 2


def test_trace_label_grammar_equal_reference():
    from kubetpu_torch.perf import workloads as PW

    for i in range(64):
        name = f"scheduler-perf-{i}"
        assert PW.trace_topology_labels(name, 32) == KW.trace_topology_labels(name, 32)
        assert PW.node_default(i, ("a", "b"), 8).labels == KW.node_default(
            i, ("a", "b"), 8).labels
    assert PW.trace_topology_labels("x", 0) == {}
