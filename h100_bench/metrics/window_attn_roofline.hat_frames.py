"""csrc/window_attn.cu's share of its roofline, HAT-L's block attentions, in HAT-L's frames cell."""

from .window_attn_roofline import COUNTER, SOURCE, read  # noqa: F401
