"""Seconds of the loader, in HAT-L's frames cell."""

from .load_s import read  # noqa: F401
