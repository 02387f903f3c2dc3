"""Share of its roofline that ``csrc/conv3x3.cu`` reaches in the traced
window: the launches' summed bound over their summed device time, in %."""

from ..roofline import bound_seconds, conv3x3
from ._kernel import roofline_pct

COUNTER = 'resselt_tpu_torch.ops.fused_conv:fused_conv3x3_act'
SOURCE = 'conv3x3.cu'


def read(r):
    return roofline_pct(r, COUNTER, SOURCE, lambda key: bound_seconds(*conv3x3(key, r.dtype), r.dtype))
