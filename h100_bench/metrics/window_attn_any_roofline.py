"""Share of its roofline that ``csrc/window_attn.cu``'s "any" kernels
(``wattn_f32_any_kernel``, ``wattn_h16_any_kernel``: the shapes past 256
tokens a window or head_dim 64) reach in the traced window: the summed
bound of the launches that the program's route counter
(``window_mha.by_kernel``) puts on them, over those kernels' device time,
in %.  The launches are ``window_attn_roofline``'s, checked against the
trace, kept to the shapes routed to the "any" kernels; a launch's bound
counts the unpadded head_dim.  None where no "any" launch ran, or where the
program keeps no route counter."""

import importlib

from ..roofline import bound_seconds, window_attn
from ..trace import kernel_base_name
from .window_attn_roofline import COUNTER, SOURCE  # noqa: F401 - the harness checks COUNTER's launches in SOURCE

ANY = ('wattn_f32_any_kernel', 'wattn_h16_any_kernel')


def _any_shapes() -> set:
    """The ``by_shape`` keys whose launches took an "any" kernel."""
    module, name = COUNTER.split(':')
    by_kernel = getattr(getattr(importlib.import_module(module), name), 'by_kernel', None)
    return {key[1:6] for key in by_kernel or () if key[0] in ANY}


def read(r):
    if r.trace is None:
        return None
    seconds = r.trace.kernel_seconds(lambda name: kernel_base_name(name) in ANY)
    shapes = _any_shapes()
    launches = {key: n for key, n in r.launches.get(COUNTER, {}).items() if key in shapes}
    if not seconds or not launches:
        return None
    return 100.0 * sum(n * bound_seconds(*window_attn(key, r.dtype), r.dtype) for key, n in launches.items()) / seconds
