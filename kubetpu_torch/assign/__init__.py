"""Assignment engines: greedy, batched and packing."""

from .batched import batched_assign_device, batched_assign_plain  # noqa: F401
from .greedy import greedy_assign_device, greedy_assign_plain  # noqa: F401
from .packing import PackingEngine, packing_assign_device, packing_assign_plain  # noqa: F401
