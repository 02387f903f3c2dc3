"""csrc/window_attn.cu's share of its roofline, both pairs of kernels, in DRCT-L's frames cell."""

from .window_attn_roofline import COUNTER, SOURCE, read  # noqa: F401
