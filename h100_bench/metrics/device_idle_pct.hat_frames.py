"""The card's idle share of the traced window, in HAT-L's frames cell."""

from .device_idle_pct import read  # noqa: F401
