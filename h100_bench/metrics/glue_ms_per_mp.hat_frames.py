"""Glue device ms per output megapixel, in HAT-L's frames cell."""

from .glue_ms_per_mp import read  # noqa: F401
