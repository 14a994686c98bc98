"""The port's placement search (B11) against kubetpu's
``placement_assign_device``, and the shared start mask it relies on.

Clusters labeled into TPU slices under the shared grammar, with zones,
NoSchedule and PreferNoSchedule taints and existing pods, and pending pods
with hard and soft zone spread, required zone affinity, required hostname
anti-affinity, preferred affinity and tolerations, so that a placement mask
splits spread domains and the normalize's feasible set. Each side encodes
with ``topology="on"`` (and ``"off"``); kubetpu's batch is carried across.
The masks: one a slice, ``<all>``, and seeded random subsets. Exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp

from kubetpu.api import types as kt
from kubetpu.api.wrappers import make_node, make_pod, pod_affinity_term, spread_constraint
from kubetpu.assign.placement import placement_assign_device as k_placement
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.perf import workloads as KW
from kubetpu.state.snapshot import Cache
from kubetpu.state.topology import SLICE_KEY

from kubetpu_torch import kernels
from kubetpu_torch.assign.placement import (
    placement_assign_device,
    placement_assign_plain,
)
from kubetpu_torch.framework import runtime as prt

from .torch_port_util import port_batch_from_jax, port_params

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def _aff(key, app, anti=False, preferred=0):
    term = pod_affinity_term(key, match_labels={"app": app})
    if preferred:
        pa = kt.PodAffinity(preferred=(kt.WeightedPodAffinityTerm(preferred, term),))
    else:
        pa = kt.PodAffinity(required=(term,))
    return (kt.Affinity(pod_anti_affinity=pa) if anti
            else kt.Affinity(pod_affinity=pa))


def sliced_cluster(seed, n_nodes=24, slices=4, n_existing=30, n_pending=14,
                   kinds=("plain", "spread", "affinity", "taint")):
    """A seeded sliced cluster and pending pods of the given kinds."""
    rng = np.random.default_rng(seed)
    cache = Cache()
    nodes = []
    for i in range(n_nodes):
        name = f"node-{i:02d}"
        labels = {HOST: name, ZONE: f"z{i % 3}"}
        labels.update(KW.trace_topology_labels(name, slices))
        taints = ()
        if "taint" in kinds and rng.random() < 0.25:
            effect = rng.choice([kt.TaintEffect.NO_SCHEDULE,
                                 kt.TaintEffect.PREFER_NO_SCHEDULE])
            taints = (kt.Taint(key="dedicated", value="gpu", effect=effect),)
        node = make_node(name, cpu_milli=int(rng.integers(1500, 5000)),
                         memory=8 * 1024**3, pods=int(rng.integers(4, 20)),
                         labels=labels, taints=taints)
        nodes.append(node)
        cache.add_node(node)
    for j in range(n_existing):
        node = nodes[int(rng.integers(0, n_nodes))]
        cache.add_pod(make_pod(
            f"existing-{j}", cpu_milli=int(rng.integers(100, 900)),
            labels={"app": str(rng.choice(["web", "db"]))},
            creation_index=j).with_node(node.name))
    tol = (kt.Toleration(key="dedicated", operator=kt.TolerationOperator.EQUAL,
                         value="gpu", effect=kt.TaintEffect.NO_SCHEDULE),)
    pending = []
    for j in range(n_pending):
        kind = kinds[j % len(kinds)]
        kw = dict(cpu_milli=int(rng.integers(200, 1200)), memory=256 * 1024**2,
                  labels={"app": str(rng.choice(["web", "db"]))},
                  creation_index=100 + j)
        if kind == "spread":
            when = (kt.UnsatisfiableConstraintAction.DO_NOT_SCHEDULE if j % 2
                    else kt.UnsatisfiableConstraintAction.SCHEDULE_ANYWAY)
            kw["spread"] = (spread_constraint(1, ZONE, when=when,
                                              match_labels={"app": "web"}),)
        elif kind == "affinity":
            kw["affinity"] = [
                _aff(ZONE, "db"), _aff(HOST, "web", anti=True),
                _aff(ZONE, "web", preferred=30),
            ][j % 3]
        elif kind == "taint":
            kw["tolerations"] = tol
        pending.append(make_pod(f"pend-{j}", **kw))
    return cache, pending


def masks_for(kb, seed, n_random=3):
    """One mask per slice (sorted slice names, as generate_placements
    builds them), ``<all>``, and seeded random subsets: (D, NC) bool."""
    nt = kb.node_tensors
    nc, n = kb.device.alloc.shape[0], kb.num_nodes
    slices = {}
    for i, name in enumerate(kb.node_names):
        val = nt.infos[i].node.labels_dict().get(SLICE_KEY)
        slices.setdefault(val, []).append(i)
    rows = []
    for val in sorted(v for v in slices if v is not None):
        m = np.zeros(nc, dtype=bool)
        m[slices[val]] = True
        rows.append(m)
    m = np.zeros(nc, dtype=bool)
    m[:n] = True
    rows.append(m)
    rng = np.random.default_rng(seed)
    rows += list(rng.random((n_random, nc)) < 0.5)
    return np.stack(rows)


def _pair(seed, topology, kinds=("plain", "spread", "affinity", "taint"), **kw):
    cache, pending = sliced_cluster(seed, kinds=kinds, **kw)
    kb = krt.encode_batch(cache.update_snapshot(), pending, KC.Profile(),
                          topology=topology)
    kp = krt.score_params(KC.Profile(), kb.resource_names)
    return kb, kp, port_batch_from_jax(kb.device), port_params(kp)


@pytest.mark.parametrize("engine", ["greedy", "batched"])
@pytest.mark.parametrize("topology", ["on", "off"])
@pytest.mark.parametrize("seed", [0, 1])
def test_placement_equal_reference(seed, topology, engine):
    kb, kp, pb, pp = _pair(seed, topology)
    assert (pb.topology is not None) == (topology == "on")
    assert pb.spread is not None and pb.podaffinity is not None
    masks = masks_for(kb, seed)
    assert masks.shape[0] >= 4
    ka, kc, kal = k_placement(kb.device, kp, jnp.asarray(masks), engine=engine)
    pa, pc, pal = placement_assign_plain(pb, pp, torch.from_numpy(masks), engine)
    assert pa.dtype == pc.dtype == pal.dtype == torch.int32
    assert np.array_equal(pa.numpy(), np.asarray(ka))
    assert np.array_equal(pc.numpy(), np.asarray(kc))
    assert np.array_equal(pal.numpy(), np.asarray(kal))
    if topology == "off":
        assert not pal.any()
    # the CPU dispatcher runs the plain version
    da, dc, dal = placement_assign_device(pb, pp, torch.from_numpy(masks), engine)
    assert torch.equal(da, pa) and torch.equal(dc, pc) and torch.equal(dal, pal)


def test_placement_basic_gang_prefers_one_slice():
    """A plain (SchedulingBasic-shaped) batch: every slice mask places the
    whole batch and the alignment of a one-slice proposal is P²."""
    kb, kp, pb, pp = _pair(3, "on", kinds=("plain",), n_pending=6)
    masks = masks_for(kb, 3, n_random=0)
    ka, kc, kal = k_placement(kb.device, kp, jnp.asarray(masks))
    pa, pc, pal = placement_assign_plain(pb, pp, torch.from_numpy(masks))
    assert np.array_equal(pa.numpy(), np.asarray(ka))
    assert np.array_equal(pal.numpy(), np.asarray(kal))
    full = pc == 6
    assert full.any() and (pal[:-1][full[:-1]] == 36).all()


def test_no_placements():
    kb, kp, pb, pp = _pair(0, "on")
    masks = torch.zeros((0, pb.alloc.shape[0]), dtype=torch.bool)
    a, c, al = placement_assign_plain(pb, pp, masks)
    assert a.shape == (0, pb.requests.shape[0]) and c.shape == al.shape == (0,)


def test_kernel_wrapper_refuses_cpu_tensors():
    _, _, pb, pp = _pair(0, "on")
    masks = torch.ones((2, pb.alloc.shape[0]), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.placement_scan(pb, pp, masks)


@pytest.mark.parametrize("seed", [0, 1])
def test_node_valid_feeds_only_the_static_verdict(seed):
    """The hypothesis scan reuses one ``filter_score`` start mask and base
    score for every hypothesis, ANDing the hypothesis's mask on top. That
    is exact only while ``node_valid`` feeds nothing but the static
    verdict: under ``node_valid & mask`` every Filter component but
    ``static`` is unchanged (fit, ports, spread, affinity), ``static`` is
    the old one ANDed with the mask, and the spread and affinity state the
    verdicts read is the same."""
    kb, kp, pb, pp = _pair(seed, "on")
    masks = masks_for(kb, seed)
    base = prt.filter_components(pb, pp)
    for m in torch.from_numpy(masks):
        bb = dataclasses.replace(
            pb, nodes=dataclasses.replace(pb.nodes, node_valid=pb.node_valid & m))
        got = prt.filter_components(bb, pp)
        assert torch.equal(got[0], base[0] & m[None, :])
        for g, w in zip(got[1:], base[1:]):
            assert (g is None) == (w is None)
            assert w is None or torch.equal(g, w)


def test_batched_kernel_wrappers_refuse_cpu_tensors():
    _, _, pb, pp = _pair(0, "on")
    masks = torch.ones((2, pb.alloc.shape[0]), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.hypothesis_rows(pb, masks)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.slice_epilogue(torch.zeros((2, pb.requests.shape[0]), dtype=torch.int32),
                               pb.pod_valid, pb.topology.slice_id, pb.topology.num_slices)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.batched_hypotheses(pb, pp, masks)


def _plain_rows(b, masks, freed_req=None, freed_count=None):
    """What ``kernels.hypothesis_rows`` computes, from the rows
    ``run_hypotheses`` builds."""
    valid = torch.stack([b.node_valid & m for m in masks])
    if freed_req is None:
        return valid, None, None, None
    return (valid, torch.clamp(b.requested[None] - freed_req, min=0),
            torch.clamp(b.nonzero_requested[None] - freed_req, min=0),
            torch.clamp(b.pod_count[None] - freed_count, min=0))


def _plain_epilogue(assignments, pod_valid, slice_id, num_slices):
    """What ``kernels.slice_epilogue`` computes."""
    from kubetpu_torch.ops.topology import alignment_score

    counts = torch.sum((assignments >= 0) & pod_valid[None], dim=1).to(torch.int32)
    if slice_id is None:
        return counts, torch.zeros_like(counts)
    return counts, torch.stack(
        [alignment_score(a, pod_valid, slice_id, num_slices)[0] for a in assignments])


@pytest.mark.parametrize("freed", [False, True])
@pytest.mark.parametrize("topology", ["on", "off"])
def test_batched_hypotheses_glue(monkeypatch, topology, freed):
    """``kernels.batched_hypotheses`` (the batched engine's placement search
    and gang dry run on the card) with its three kernels swapped for what
    they compute: the per-hypothesis rows it hands the engine, the rows it
    writes the assignments into and the epilogue's inputs must give the
    plain search's results."""
    kb, kp, pb, pp = _pair(4, topology)
    masks = torch.from_numpy(masks_for(kb, 4))
    from kubetpu_torch.assign.batched import batched_assign_plain
    from kubetpu_torch.ops.preemption import dry_run_gang_preemption_plain

    monkeypatch.setattr(kernels, "hypothesis_rows", _plain_rows)
    monkeypatch.setattr(kernels, "slice_epilogue", _plain_epilogue)
    monkeypatch.setattr(kernels, "batched_assign", batched_assign_plain)
    if not freed:
        got = kernels.batched_hypotheses(pb, pp, masks)
        want = placement_assign_plain(pb, pp, masks, "batched")
    else:
        rng = np.random.default_rng(4)
        D, (N, R) = masks.shape[0], pb.alloc.shape
        freed_req = torch.from_numpy(
            rng.integers(0, 2, (D, N, R)) * rng.integers(0, 900, (D, N, R)))
        freed_count = torch.from_numpy(rng.integers(0, 3, (D, N)).astype(np.int32))
        got = kernels.batched_hypotheses(pb, pp, masks, freed_req, freed_count)[1:]
        want = dry_run_gang_preemption_plain(pb, pp, masks, freed_req, freed_count,
                                             "batched")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
