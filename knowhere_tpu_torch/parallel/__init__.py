"""The sharding layer: one logical index over a list of devices
(parallel/sharding.py)."""

from . import sharding  # noqa: F401
