"""Glue device ms per output megapixel, in ESRGAN's photos cell."""

from .glue_ms_per_mp import read  # noqa: F401
