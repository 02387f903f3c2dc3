"""Glue device ms per output megapixel, in SwinIR-M's frames cell."""

from .glue_ms_per_mp import read  # noqa: F401
