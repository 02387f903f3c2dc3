"""Output megapixels on the host per second, in SwinIR-M's photos cell (the
host loop's pace: a bound of its own)."""

from .out_mp_per_s import read  # noqa: F401
