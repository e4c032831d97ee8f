from . import logging  # noqa: F401
