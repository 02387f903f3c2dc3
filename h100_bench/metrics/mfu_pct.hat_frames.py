"""The whole step's share of the card's peak, in HAT-L's frames cell."""

from .mfu_pct import read  # noqa: F401
