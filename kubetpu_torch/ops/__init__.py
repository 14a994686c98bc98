from . import filters, podaffinity, scores  # noqa: F401
