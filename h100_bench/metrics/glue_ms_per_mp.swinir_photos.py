"""Glue device ms per output megapixel, in SwinIR-M's photos cell."""

from .glue_ms_per_mp import read  # noqa: F401
