"""The whole step's share of the card's peak, in SwinIR-M's photos cell."""

from .mfu_pct import read  # noqa: F401
