"""The whole step's share of the card's peak, in ESRGAN's photos cell."""

from .mfu_pct import read  # noqa: F401
