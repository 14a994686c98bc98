from .encoder import NodeTensors, PodBatch, encode_pod_batch, encode_snapshot, resource_axis, round_up  # noqa: F401
from .snapshot import Cache, NodeInfo, Snapshot  # noqa: F401
from .vocab import Vocab  # noqa: F401
