"""The card's idle share of the traced window, in SwinIR-M's photos cell."""

from .device_idle_pct import read  # noqa: F401
