"""Node-topology coordinate tensors (the reference's ROADMAP item 3).

Port copy of ``kubetpu/state/topology.py``, verbatim below this line.

Racks and TPU slices arrive as ordinary node labels; the scoring stack
wants them as SMALL DENSE integers so a gang's slice concentration and a
slice's occupancy are single segment-sums over the node axis — zero
per-pod Python at score time. ``topology_tensors`` reads the encoder's
interned label matrix (``NodeTensors._ensure_label_matrix``), picks the
well-known slice/rack columns, and remaps each to a dense coordinate in
``[0, D)`` with ``D`` itself standing for "no label". The result is
memoized on the NodeTensors object and rides ``encode_snapshot``'s
in-place growth: ``_refresh_tensors`` drops the memo whenever a node
object was replaced or appended (labels may have changed), and every
other cycle reuses the cached coordinates for free.

Arrays are allocated at the PADDED node capacity like every other node
table, so the device block shards under ``parallel.mesh`` without a
resize; rows past ``num_nodes`` read as unlabeled (the ``D`` bucket),
which scores exactly like a node outside every slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Well-known topology label keys. The slice key mirrors the GKE TPU
# placement convention; the rack key is the standard topology prefix.
# Trace generation (perf.workloads) and the tests stamp these same keys,
# so the whole stack shares one label grammar.
SLICE_KEY = "kubetpu.io/tpu-slice"
RACK_KEY = "topology.kubernetes.io/rack"


@dataclasses.dataclass(frozen=True)
class TopologyTensors:
    """Host-side dense topology coordinates at padded node capacity."""

    slice_id: np.ndarray        # (cap,) int32 in [0, num_slices]; == num_slices ⇒ unlabeled
    rack_id: np.ndarray         # (cap,) int32 in [0, num_racks]; == num_racks ⇒ unlabeled
    num_slices: int
    num_racks: int
    slice_names: tuple          # dense slice id → label value (explain rendering)
    rack_names: tuple

    @property
    def labeled(self) -> bool:
        """True when ANY node carries a slice or rack label — the signal
        ``--topology auto`` keys off (an unlabeled cluster stays on the
        bit-identical topology-off path)."""
        return self.num_slices > 0 or self.num_racks > 0


def _dense_column(nt, key: str) -> "tuple[np.ndarray, int, tuple]":
    """Remap one label column to dense ids. Returns ``(ids, D, names)``
    where unlabeled rows (and padded capacity past ``num_nodes``) carry
    ``D``. Dense ids follow val-vocab intern order, so they are stable
    across incremental refreshes that don't touch labels."""
    cap = nt.alloc.shape[0]
    n = nt.num_nodes
    kid = nt.key_vocab.get(key)
    if kid < 0:
        return np.zeros(cap, dtype=np.int32), 0, ()
    col = np.full(cap, -1, dtype=np.int32)
    col[:n] = nt._ensure_label_matrix()[:n, kid]
    present = np.unique(col[col >= 0])
    d = int(present.size)
    if d == 0:
        return np.zeros(cap, dtype=np.int32), 0, ()
    # labeled values are a subset of ``present`` so searchsorted is exact
    idx = np.searchsorted(present, np.clip(col, 0, None))
    ids = np.where(col >= 0, idx, d).astype(np.int32)
    names = tuple(nt.val_vocab.lookup(int(v)) for v in present)
    return ids, d, names


def topology_tensors(nt) -> TopologyTensors:
    """Dense coordinates for ``nt``, memoized until the node set or any
    node object changes (``_refresh_tensors`` clears the memo)."""
    memo = getattr(nt, "topo_memo", None)
    if (
        isinstance(memo, TopologyTensors)
        and memo.slice_id.shape[0] == nt.alloc.shape[0]
    ):
        return memo
    slice_id, n_slices, slice_names = _dense_column(nt, SLICE_KEY)
    rack_id, n_racks, rack_names = _dense_column(nt, RACK_KEY)
    tt = TopologyTensors(
        slice_id=slice_id,
        rack_id=rack_id,
        num_slices=n_slices,
        num_racks=n_racks,
        slice_names=slice_names,
        rack_names=rack_names,
    )
    nt.topo_memo = tt
    return tt
