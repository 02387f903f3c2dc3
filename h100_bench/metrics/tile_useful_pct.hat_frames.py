"""The tiler's useful share of the computed pixels, in HAT-L's frames cell."""

from .tile_useful_pct import read  # noqa: F401
