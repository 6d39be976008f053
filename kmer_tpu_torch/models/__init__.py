from .pipeline import KmerCounter  # noqa: F401
