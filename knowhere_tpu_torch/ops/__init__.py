from . import distances, topk  # noqa: F401
