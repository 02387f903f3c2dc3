"""csrc/conv3x3.cu's share of its roofline, in ESRGAN's photos cell."""

from .conv3x3_roofline import COUNTER, SOURCE, read  # noqa: F401
