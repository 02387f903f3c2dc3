"""Seconds of the loader, in DRCT-L's frames cell."""

from .load_s import read  # noqa: F401
