"""Index families of the port. Importing this package registers them with
the factory: FLAT and IVF_FLAT in this slice."""

from . import flat, ivf  # noqa: F401
