"""The port's gang dry run (B13) against kubetpu's
``dry_run_gang_preemption``.

Sliced clusters (``test_torch_placement``'s generator) under C eviction
hypotheses: each a slice mask (and random masks) with seeded freed rows —
freed requests and pod counts on some of the hypothesis's nodes, some
larger than what the node holds, so the reduction clamps at 0. Both
engines, with and without the topology leaf. Exact.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp

from kubetpu.ops.preemption import dry_run_gang_preemption as k_gang

from kubetpu_torch import kernels
from kubetpu_torch.assign.greedy import greedy_assign_plain
from kubetpu_torch.assign.placement import run_hypotheses
from kubetpu_torch.ops.preemption import (
    dry_run_gang_preemption,
    dry_run_gang_preemption_plain,
)

from .test_torch_placement import _pair, masks_for


def freed_rows(pb, masks, seed, big=0.15):
    """Seeded (C, N, R) int64 / (C, N) int32 freed rows on about a third of
    each hypothesis's nodes; a share of them exceed the node's usage (the
    clamp at 0)."""
    rng = np.random.default_rng(seed + 77)
    c = masks.shape[0]
    n, r = pb.alloc.shape
    req = pb.requested.numpy()
    on = masks & (rng.random((c, n)) < 0.35)
    frac = rng.random((c, n, r))
    fr = (req[None] * frac).astype(np.int64)
    over = rng.random((c, n)) < big
    fr[over] = req[None].repeat(c, 0)[over] + rng.integers(1, 5000, (int(over.sum()), r))
    fr[~on] = 0
    fc = np.where(on, rng.integers(0, 4, (c, n)), 0).astype(np.int32)
    fc[over & on] += 50
    return fr, fc


@pytest.mark.parametrize("engine", ["greedy", "batched"])
@pytest.mark.parametrize("topology", ["on", "off"])
@pytest.mark.parametrize("seed", [0, 2])
def test_gang_dry_run_equal_reference(seed, topology, engine):
    kb, kp, pb, pp = _pair(seed, topology, n_existing=60)
    masks = masks_for(kb, seed)
    fr, fc = freed_rows(pb, masks, seed)
    assert (fr.sum(-1) > pb.requested.numpy().sum(-1)[None]).any()   # clamps
    kc, kal = k_gang(kb.device, kp, jnp.asarray(masks), jnp.asarray(fr),
                     jnp.asarray(fc), engine=engine)
    args = (torch.from_numpy(masks), torch.from_numpy(fr), torch.from_numpy(fc))
    pc, pal = dry_run_gang_preemption_plain(pb, pp, *args, engine=engine)
    assert pc.dtype == pal.dtype == torch.int32
    assert np.array_equal(pc.numpy(), np.asarray(kc))
    assert np.array_equal(pal.numpy(), np.asarray(kal))
    dc, dal = dry_run_gang_preemption(pb, pp, *args, engine=engine)
    assert torch.equal(dc, pc) and torch.equal(dal, pal)


def test_freed_rows_change_the_outcome():
    """The eviction hypotheses are not vacuous: freeing a full cluster's
    usage admits pods that the unfreed cluster cannot place."""
    kb, kp, pb, pp = _pair(4, "on", n_existing=160, n_pending=20)
    masks = masks_for(kb, 4, n_random=0)
    fr, fc = freed_rows(pb, masks, 4, big=1.0)
    zero_r, zero_c = np.zeros_like(fr), np.zeros_like(fc)
    t = torch.from_numpy
    freed, _ = dry_run_gang_preemption_plain(pb, pp, t(masks), t(fr), t(fc))
    kept, _ = dry_run_gang_preemption_plain(pb, pp, t(masks), t(zero_r), t(zero_c))
    assert (freed >= kept).all() and (freed > kept).any()
    kc, _ = k_gang(kb.device, kp, jnp.asarray(masks), jnp.asarray(fr), jnp.asarray(fc))
    assert np.array_equal(freed.numpy(), np.asarray(kc))


def test_nonzero_requested_reduced_by_freed_requests():
    """The reference reduces ``nonzero_requested`` by the freed REQUESTS
    (kubetpu/ops/preemption.py:247), not by the victims' nonzero amounts;
    the port copies that quirk: each hypothesis's engine sees
    max(nonzero_requested - freed_req, 0) and max(pod_count - freed_count,
    0)."""
    kb, kp, pb, pp = _pair(0, "on", n_existing=60)
    masks = masks_for(kb, 0, n_random=1)
    fr, fc = freed_rows(pb, masks, 0)
    seen = []

    def spy(b, params):
        seen.append(b.nodes)
        return greedy_assign_plain(b, params)

    run_hypotheses(pb, pp, torch.from_numpy(masks), spy, torch.from_numpy(fr),
                   torch.from_numpy(fc))
    assert len(seen) == masks.shape[0]
    for h, nodes in enumerate(seen):
        f = torch.from_numpy(fr[h])
        assert torch.equal(nodes.nonzero_requested,
                           torch.clamp(pb.nonzero_requested - f, min=0))
        assert torch.equal(nodes.requested, torch.clamp(pb.requested - f, min=0))
        assert torch.equal(nodes.pod_count,
                           torch.clamp(pb.pod_count - torch.from_numpy(fc[h]), min=0))
        assert torch.equal(nodes.node_valid,
                           pb.node_valid & torch.from_numpy(masks[h]))
    # and the result is kubetpu's on the same hypotheses
    kc, kal = k_gang(kb.device, kp, jnp.asarray(masks), jnp.asarray(fr), jnp.asarray(fc))
    pc, pal = dry_run_gang_preemption_plain(
        pb, pp, torch.from_numpy(masks), torch.from_numpy(fr), torch.from_numpy(fc))
    assert np.array_equal(pc.numpy(), np.asarray(kc))


def test_kernel_wrapper_refuses_cpu_tensors():
    _, _, pb, pp = _pair(0, "on")
    n, r = pb.alloc.shape
    masks = torch.ones((2, n), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gang_dry_run_scan(pb, pp, masks, torch.zeros((2, n, r), dtype=torch.int64),
                                  torch.zeros((2, n), dtype=torch.int32))
    with pytest.raises(ValueError, match="come together"):
        kernels.gang_dry_run_scan(pb, pp, masks, torch.zeros((2, n, r), dtype=torch.int64),
                                  None)
