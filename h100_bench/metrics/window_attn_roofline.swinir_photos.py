"""csrc/window_attn.cu's share of its roofline, in SwinIR-M's photos cell."""

from .window_attn_roofline import COUNTER, SOURCE, read  # noqa: F401
