"""The whole step's share of the card's peak, in DRCT-L's frames cell."""

from .mfu_pct import read  # noqa: F401
