"""Framework — profiles, configuration and the Filter+Score composition."""

from . import config  # noqa: F401
from .config import Profile, SchedulerConfiguration, minimal_profile  # noqa: F401
from .runtime import (  # noqa: F401
    DeviceBatch,
    DeviceNodeState,
    EncodedBatch,
    ScoreParams,
    device_batch_from_numpy,
    encode_batch,
    encode_batch_static,
    filter_score_batch,
    finalize_batch,
    score_params,
    score_params_from_dict,
)
