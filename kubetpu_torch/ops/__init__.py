from . import filters, scores  # noqa: F401
