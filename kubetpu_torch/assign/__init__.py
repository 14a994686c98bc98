"""Assignment engines. The slice ports the greedy engine; the batched and
packing engines are ROADMAP Queue A items 6 and 11."""

from .greedy import greedy_assign_device, greedy_assign_plain  # noqa: F401
