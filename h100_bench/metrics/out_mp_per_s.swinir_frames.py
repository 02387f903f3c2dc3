"""Output megapixels on the host per second, in SwinIR-M's frames cell (a
bound of its own, from its own spread)."""

from .out_mp_per_s import read  # noqa: F401
