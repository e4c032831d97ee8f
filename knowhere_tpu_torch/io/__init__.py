from .serialize import read_sections, write_sections  # noqa: F401
