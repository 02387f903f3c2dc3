"""Share of its roofline that ``csrc/window_cross_attn.cu`` (HAT's OCAB)
reaches in the traced window: the launches' summed bound over their summed
device time, in %.  A program without the kernel's wrapper has no counter
to read: then the module names none, and the metric reads None."""

import importlib.util

from ..roofline import bound_seconds
from ..roofline_cross import window_cross_attn
from ._kernel import roofline_pct

_MODULE = 'resselt_tpu_torch.ops.window_cross_attention'
if importlib.util.find_spec(_MODULE) is not None:
    COUNTER = f'{_MODULE}:window_cross_mha'
    SOURCE = 'window_cross_attn.cu'


def read(r):
    if 'COUNTER' not in globals():
        return None
    return roofline_pct(r, COUNTER, SOURCE, lambda key: bound_seconds(*window_cross_attn(key, r.dtype), r.dtype))
