"""The tiler's useful share of the computed pixels, in ESRGAN's photos cell."""

from .tile_useful_pct import read  # noqa: F401
