"""Output megapixels on the host per second, in ESRGAN's photos cell (a
bound of its own, from its own spread)."""

from .out_mp_per_s import read  # noqa: F401
