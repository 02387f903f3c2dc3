"""Share of its roofline that ``csrc/window_attn.cu`` reaches in the traced
window: the launches' summed bound over their summed device time, in %."""

from ..roofline import bound_seconds, window_attn
from ._kernel import roofline_pct

COUNTER = 'resselt_tpu_torch.ops.window_attention:window_mha'
SOURCE = 'window_attn.cu'


def read(r):
    return roofline_pct(r, COUNTER, SOURCE, lambda key: bound_seconds(*window_attn(key, r.dtype), r.dtype))
