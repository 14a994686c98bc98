"""Assignment engines: greedy and batched. The packing engine is ROADMAP
Queue A item 11."""

from .batched import batched_assign_device, batched_assign_plain  # noqa: F401
from .greedy import greedy_assign_device, greedy_assign_plain  # noqa: F401
