"""The packing solve stops as kubetpu's ``cond``.

kubetpu's solve (``kubetpu/assign/packing.py:259`` ``packing_assign_device``)
runs its rounds in a ``lax.while_loop`` whose condition is ``any(active) &
progress & (iters < cap)``, ``cap = max_iters or P``; the port's kernels
run that loop on the device (one launch a solve), and its plain solves are
what they are held to. Here the plain unsharded solve and the plain tiled
solve on a ``cpu`` node mesh of four shards and on a 2 x 2 pods x nodes
grid, stopped at ``max_iters`` 1, 2 and 0 (that is, P), are held to
kubetpu's unsharded solve and to its ``sharded_packing`` on the same
layout of its virtual devices: iterations, assignments, λ's bits and the
nodes used; and a batch with no pod valid runs no round.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax
import jax.numpy as jnp

import kubetpu  # noqa: F401  (x64 on before any kernel runs)
from kubetpu.assign import packing as KP
from kubetpu.parallel import make_mesh as k_make_mesh
from kubetpu.parallel import make_mesh_2d as k_make_mesh_2d
from kubetpu.parallel import sharded_packing as k_sharded_packing

from kubetpu_torch.assign import packing as PP
from kubetpu_torch.parallel import mesh as M

from .test_torch_packing import CASES, _bits, _encode
from .test_torch_packing_mesh import _assert_solve, _reference
from .torch_port_util import port_batch_from_jax, port_params, to_port

NAMES = ["binpack", "spread-affinity-0", "topology-1"]
CAPS = [1, 2, 0]
# the port's layouts: None unsharded, else (pod rows, node columns)
LAYOUTS = {"unsharded": None, "mesh-4": (1, 4), "grid-2x2": (2, 2)}


def _port(kb, kp, layout, max_iters):
    """The port's plain solve of kubetpu's batch on ``layout``, cold."""
    b = port_batch_from_jax(kb)
    w = to_port(KP.PackingWeights()).tensor("cpu")
    if layout is None:
        return PP.packing_assign_plain(b, port_params(kp), torch.zeros(b.alloc.shape[0]), w,
                                       max_iters)
    pg, ng = layout
    mesh = M.make_mesh_2d(["cpu"] * (pg * ng), pods=pg) if pg > 1 else M.make_mesh(
        ["cpu"] * ng)
    sb = M.shard_batch(b, mesh)
    pieces = [torch.zeros(s.alloc.shape[0]) for s in sb.shards]
    return PP.packing_assign_tiled_plain(sb, port_params(kp), pieces, w, max_iters)


def _kubetpu_sharded(kb, kp, layout, max_iters):
    pg, ng = layout
    devs = jax.devices()[:pg * ng]
    if pg > 1:
        return jax.device_get(k_sharded_packing(kb, kp, k_make_mesh_2d(devs, pods=pg),
                                                max_iters=max_iters, pod_axis="pods"))
    return jax.device_get(k_sharded_packing(kb, kp, k_make_mesh(devs), max_iters=max_iters))


def _same_stop(want, got):
    """Iterations, assignments, λ's bits and nodes used equal."""
    assert int(got[4]) == int(want[4])
    assert np.array_equal(np.asarray(got[0]), np.asarray(want[0]))
    assert np.array_equal(_bits(got[2]), _bits(want[2]))
    assert int(got[5]) == int(want[5])


def _host(x):
    return x.cpu() if isinstance(x, M.ShardedTensor) else x


@pytest.mark.parametrize("cap", CAPS, ids=["max_iters-1", "max_iters-2", "max_iters-P"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", NAMES)
def test_solve_stops_as_the_reference(name, layout, cap):
    cache, pending, profile, kw = CASES[name]
    kb, kp = _encode(cache, pending, profile, **kw)
    want = _reference(kb.device, kp, max_iters=cap)
    got = _port(kb.device, kp, LAYOUTS[layout], cap)
    _assert_solve(want, got)
    if cap:
        assert int(want[4]) <= cap
    if LAYOUTS[layout] is not None:
        _same_stop(want, _kubetpu_sharded(kb.device, kp, LAYOUTS[layout], cap))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_no_pod_valid_runs_no_round(layout):
    """No pod active at the start: the loop's condition fails at once; the
    end still prices λ from the start state (no node used: λ stays at
    its decayed warm start, here 0) and the objective counts nothing."""
    cache, pending, profile, kw = CASES["binpack"]
    kb, kp = _encode(cache, pending, profile, **kw)
    idle = dataclasses.replace(kb.device, pod_valid=jnp.zeros_like(kb.device.pod_valid))
    want = _reference(idle, kp)
    assert int(want[4]) == 0
    got = _port(idle, kp, LAYOUTS[layout], 0)
    _assert_solve(want, tuple(_host(x) if i == 2 else x for i, x in enumerate(got)))
    assert (np.asarray(got[0]) == -1).all()
    if LAYOUTS[layout] is not None:
        _same_stop(want, _kubetpu_sharded(idle, kp, LAYOUTS[layout], 0))
