"""Reductions over the node axis as explicit points of a computation.

A function written in "steps" form is a generator: wherever it reduces over
nodes (a row maximum, a domain sum, a scored-node count) it yields
``(op, partial)``, with ``op`` one of ``"sum"``, ``"max"`` and ``"min"`` and
``partial`` the reduction over the nodes it holds, and goes on with the
value sent back. On one device the partial is already the whole
(``run_local``). Under a node-axis mesh every shard runs the same steps on
its own node rows and ``parallel.mesh.run_sharded`` combines the G partials
of each point before any shard goes on, so the shards reduce at exactly the
points the hand-written kernels exchange at. Integer sums are int64 and
wrap, as the reference's uint64 hash does; float32 partials (the packing
solve's marginal utility and fragmentation sum) reduce in float32, sums
added in shard order; the other partials reduce elementwise.
"""

from __future__ import annotations

import torch


def combine(op: str, parts: list[torch.Tensor]) -> torch.Tensor:
    """The elementwise reduction of ``parts`` (same shape and dtype, on
    one device), in shard order: a float32 sum is rounded after each
    shard's addition, as the kernels' combine adds."""
    out = parts[0]
    for x in parts[1:]:
        if op == "sum":
            out = out + x
        elif op == "max":
            out = torch.maximum(out, x)
        elif op == "min":
            out = torch.minimum(out, x)
        else:
            raise ValueError(f"unknown reduction {op!r}")
    return out


def run_local(steps):
    """Run a steps-form generator on one device: every partial is sent back
    as it is. Returns the generator's value."""
    try:
        request = next(steps)
        while True:
            request = steps.send(request[1])
    except StopIteration as stop:
        return stop.value
