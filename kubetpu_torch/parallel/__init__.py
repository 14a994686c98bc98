"""The device mesh (``parallel.mesh``): the node axis and the pods x nodes grid."""

from .mesh import (  # noqa: F401
    NodeMesh,
    ShardedBatch,
    ShardedTensor,
    make_mesh,
    make_mesh_2d,
    make_multislice_mesh,
    measure_collective_wall,
    node_axes_of,
    node_pad_multiple,
    node_state_shardings,
    pod_scan_collective_ok,
    resolve_mesh,
    run_sharded,
    shard_batch,
    sharded_batched,
    sharded_greedy,
    sharded_packing,
)
